"""Precision/device policy seams (fvgp_tpu.config).

The reference is float64 numpy everywhere; this build routes every dtype
decision through config (ref gp_lin_alg.py module docstring).  These tests
pin the override priority chain and the import-time compile-cache wiring.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from fvgp_tpu import config


def test_forced_linalg_dtype_priority_chain():
    """Priority: per-GP args['dtype'] > global set_linalg_dtype > backend
    default (f64 on CPU with x64 on)."""
    assert config.linalg_dtype() == jnp.dtype(jnp.float64)      # CPU suite
    try:
        config.set_linalg_dtype("float32")
        assert config.linalg_dtype() == jnp.dtype(jnp.float32)
        assert config.linalg_dtype({"dtype": "float64"}) == \
            jnp.dtype(jnp.float64)
        # kernel dtype falls back to the (forced) linalg dtype
        assert config.kernel_compute_dtype() == jnp.dtype(jnp.float32)
        assert config.kernel_compute_dtype({"kernel_dtype": "bfloat16"}) \
            == jnp.dtype(jnp.bfloat16)
    finally:
        config.set_linalg_dtype(None)
    assert config.linalg_dtype() == jnp.dtype(jnp.float64)


def test_asarray_int_passthrough_and_to_numpy_upcast():
    """Integer arrays keep their dtype through config.asarray; user-facing
    to_numpy upcasts reduced-precision floats to float64."""
    ints = config.asarray(np.arange(4, dtype=np.int32))
    assert jnp.issubdtype(ints.dtype, jnp.integer)
    out = config.to_numpy(jnp.asarray(np.array([1.5], np.float32)))
    assert out.dtype == np.float64 and out[0] == 1.5


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh_import(env_overrides, tmp_path):
    """Import fvgp_tpu in a fresh process; return (cache dir, min compile
    secs) as JAX's config holds them."""
    env = dict(os.environ, FVGP_TPU_COMPILE_CACHE="1")   # conftest pins 0
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_overrides)
    code = ("import fvgp_tpu, jax; "
            "print(repr(jax.config.jax_compilation_cache_dir)); "
            "print(jax.config.jax_persistent_cache_min_compile_time_secs)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=180,
                       cwd=_ROOT)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    return lines[-2], float(lines[-1])


def test_compile_cache_wiring_in_fresh_process(tmp_path):
    """With a non-CPU-pinned env and no JAX_COMPILATION_CACHE_DIR, importing
    fvgp_tpu points the persistent compile cache at the fixed in-checkout
    path <repo>/.cache/jax and sets the 3 s min-compile-time bar."""
    cache_dir, min_secs = _fresh_import({"JAX_PLATFORMS": ""}, tmp_path)
    expect = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(config.__file__))), ".cache", "jax")
    assert cache_dir == repr(expect)
    assert expect == config.CACHE_DIR
    assert min_secs == 3.0
    assert os.path.isdir(expect)


def test_compile_cache_honours_jax_env_dir(tmp_path):
    """Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache there and
    the package sets no path of its own."""
    cache = tmp_path / "cc"
    cache_dir, min_secs = _fresh_import(
        {"JAX_PLATFORMS": "", "JAX_COMPILATION_CACHE_DIR": str(cache)},
        tmp_path)
    assert cache_dir == repr(str(cache))
    assert min_secs == 3.0


def test_compile_cache_disabled_when_cpu_pinned(tmp_path):
    """A CPU-pinned env must NOT enable the disk cache (XLA:CPU AOT
    entries record the compile machine's features; loading one on another
    host risks SIGILL)."""
    cache_dir, _ = _fresh_import({"JAX_PLATFORMS": "cpu"}, tmp_path)
    assert cache_dir in ("None", "''")
