"""Global precision / device policy for fvgp_tpu.

The reference library (lbl-camera/fvGP) runs float64 numpy/scipy everywhere.
Accelerators compute bf16/f32 natively; float64 runs far slower there.  The
policy here is:

* ``jax_enable_x64`` is switched on at import (opt out with FVGP_TPU_X64=0)
  so that CPU runs — the parity/oracle regime — match the reference to 1e-8.
* Linear algebra runs in :func:`linalg_dtype` (default float64 on CPU,
  float32 on an accelerator).  Kernel *assembly* can additionally run a
  bf16/f32 path controlled per-GP via ``args["dtype"]``.

Everything downstream asks this module instead of hard-coding dtypes.
"""

import os

import jax
import numpy as np

# --- x64: must run before the first array is created ---------------------
if os.environ.get("FVGP_TPU_X64", "1") != "0":
    jax.config.update("jax_enable_x64", True)

# --- persistent compilation cache ----------------------------------------
# The N~1M traced sparse LML compiles in tens of seconds; caching the
# executable on disk makes every process after the first start at full
# speed.  Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and no path
# is set here; otherwise the cache lives at a fixed path inside the
# checkout, <repo>/.cache/jax (a moving path never hits).  Opt out with
# FVGP_TPU_COMPILE_CACHE=0.
# NOT enabled when the env pins a CPU backend: XLA:CPU AOT entries record
# the compile machine's feature set, and loading one on a different host
# risks SIGILL (cpu_aot_loader logs exactly this when a cache written by
# another machine is read) — CPU programs recompile in seconds anyway.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".cache", "jax")
if (os.environ.get("FVGP_TPU_COMPILE_CACHE", "1") != "0"
        and os.environ.get("JAX_PLATFORMS", "").strip().lower() != "cpu"):
    try:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        # only expensive programs (the large-N LML, big posteriors) are
        # worth a disk entry; tiny programs recompile faster than the
        # load-and-feature-check round trip
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 3.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    except OSError:                       # unwritable checkout: in-memory
        pass

import jax.numpy as jnp  # noqa: E402  (after x64 switch)

_FORCED_DTYPE = None


def default_backend() -> str:
    return jax.default_backend()


def set_linalg_dtype(dtype):
    """Force the linear-algebra dtype globally (None restores the default)."""
    global _FORCED_DTYPE
    _FORCED_DTYPE = None if dtype is None else jnp.dtype(dtype)


def linalg_dtype(args=None):
    """The dtype of the factorization/solve path.

    Priority: per-GP ``args['dtype']`` > global override > backend default
    (float64 on CPU when x64 is on, float32 on an accelerator).
    """
    if isinstance(args, dict) and args.get("dtype") is not None:
        return jnp.dtype(args["dtype"])
    if _FORCED_DTYPE is not None:
        return _FORCED_DTYPE
    if default_backend() == "cpu" and jax.config.jax_enable_x64:
        return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


def kernel_compute_dtype(args=None):
    """Dtype in which kernel matrices are assembled (may be lower precision
    than the linalg dtype)."""
    if isinstance(args, dict) and args.get("kernel_dtype") is not None:
        return jnp.dtype(args["kernel_dtype"])
    return linalg_dtype(args)


def asarray(x, args=None):
    """Device array in the linalg dtype (floats only; ints pass through)."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.floating):
        return x.astype(linalg_dtype(args))
    return x


def to_numpy(x):
    """Host numpy view of a device array (float64 for user-facing returns)."""
    out = np.asarray(x)
    if out.dtype in (np.float32, np.float16):
        out = out.astype(np.float64)
    return out
