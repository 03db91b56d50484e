"""Test environment: pure-CPU JAX with x64 and a virtual 8-device mesh.

* ``JAX_PLATFORMS=cpu`` + ``xla_force_host_platform_device_count=8`` gives
  an 8-device CPU mesh — the in-process "cluster fixture" that replaces the
  reference's in-process Dask cluster (SURVEY.md §4).
* ``FVGP_TEST_GPU=1`` leaves the platform alone, for the tests marked
  ``gpu`` (``python -m pytest -m gpu tests``, which ``chip_smoke.py`` runs
  on the card).  Those tests decide inside a fixture whether a card is
  there, and skip otherwise.
"""

import os

_ON_GPU = os.environ.get("FVGP_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
# no persistent compile cache under tests: CPU AOT entries record the
# compile machine's feature set and loading them on a different host can
# SIGILL (XLA logs cpu_aot_loader feature-mismatch errors); every test
# program is cheap to recompile
os.environ.setdefault("FVGP_TPU_COMPILE_CACHE", "0")
# hermetic suite: no shared on-disk structure cache (targeted tests opt in
# per-model via args['gp2Scale_structure_cache_dir'] pointed at a tmp dir)
os.environ.setdefault("FVGP_TPU_STRUCTURE_CACHE", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# optional line-coverage measurement (the image has no coverage.py):
#   FVGP_COV=1 python -m pytest tests -q     (or `make coverage`)
if os.environ.get("FVGP_COV") == "1":
    import sys
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if _root not in sys.path:
        sys.path.insert(0, _root)
    from tools.stdlib_cov import install as _cov_install
    _cov_install()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    import jax
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    return devices


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none (decided
    when the test runs, never at import)."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run on the card: chip_smoke.py)")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_dataset(n=60, d=2, seed=0, noisy=True):
    r = np.random.default_rng(seed)
    x = r.uniform(0.0, 10.0, (n, d))
    y = np.sin(x[:, 0]) + np.cos(0.5 * x[:, min(1, d - 1)])
    if noisy:
        y = y + 0.05 * r.standard_normal(n)
    return x, y


@pytest.fixture
def small_data():
    return make_dataset()
