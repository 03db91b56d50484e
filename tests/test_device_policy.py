"""Device policy of the committed posterior solver: the memory budget never
assumes a device size, and the Pallas SpMM is chosen only where it
compiles."""

import warnings

import numpy as np
import pytest

from fvgp_tpu import GP
from fvgp_tpu.models import gp_kv


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("backend,stats,expect", [
    ("gpu", {"bytes_limit": 10 << 30}, int(0.8 * (10 << 30))),
    ("cpu", {"bytes_limit": 10 << 30}, int(0.8 * (10 << 30))),
    ("cpu", None, 5 << 30),
    ("cpu", {}, 5 << 30),
])
def test_default_posterior_budget(monkeypatch, backend, stats, expect):
    monkeypatch.setattr(gp_kv.jax, "local_devices", lambda: [_Dev(stats)])
    monkeypatch.setattr(gp_kv.jax, "default_backend", lambda: backend)
    assert gp_kv._default_posterior_budget() == expect


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_missing_memory_limit_raises_on_accelerator(monkeypatch, stats):
    """An accelerator that reports no bytes_limit is an error: no device
    size is assumed."""
    monkeypatch.setattr(gp_kv.jax, "local_devices", lambda: [_Dev(stats)])
    monkeypatch.setattr(gp_kv.jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="no memory limit"):
        gp_kv._default_posterior_budget()


def _scale_gp(B, dtype, sdt):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 14, (600, 2))
    y = np.sin(x[:, 0])
    args = {"gp2Scale_block_size": B, "gp2Scale_solver_dtype": sdt}
    if dtype is not None:
        args["dtype"] = dtype
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GP(x, y, init_hyperparameters=np.array([1.0, 1.5, 1.5]),
                  noise_variances=np.full(600, 1e-2), gp2Scale=True,
                  linalg_mode="sparseCGpre", args=args)


@pytest.mark.parametrize("B,dtype,sdt,expect", [
    (32, "float32", "bfloat16", True),   # bf16 tiles, power-of-two B
    (32, "float32", None, True),         # f32 tiles
    (48, "float32", "bfloat16", False),  # Triton: power-of-two blocks
    (32, "float64", None, False),        # f64: kernel accumulates f32
    (32, "float64", "bfloat16", False),  # f64 right-hand side, bf16 tiles
    (32, "float64", "float32", False),   # f64 right-hand side, f32 tiles
])
def test_fused_kernel_selection(B, dtype, sdt, expect):
    """The committed solver runs the kernel (``rows`` = CSR offsets of
    length nb+1) for f32 and bf16 tiles at a power-of-two block size, and
    only when the solve itself is not f64; every choice serves posteriors."""
    gp = _scale_gp(B, dtype, sdt)
    ctx = gp.kv._fast_sparse_solver()
    assert ctx is not None
    nb = int(ctx["xb"].shape[0])
    assert (ctx["rows"].shape == (nb + 1,)) is expect
    xp = np.array([[3.0, 4.0], [7.0, 1.0]])
    pm = gp.posterior_mean(xp)["m(x)"]
    pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    assert np.all(np.isfinite(pm)) and np.all(np.isfinite(pv))


def test_default_dtype_with_bf16_solver_serves_posteriors():
    """The documented ``gp2Scale_solver_dtype='bfloat16'`` with no dtype
    argument: on the CPU the linalg dtype is f64, so the tile scan serves
    the solve, and the posterior mean and variance come back finite."""
    from fvgp_tpu import config
    gp = _scale_gp(32, None, "bfloat16")
    assert np.dtype(config.linalg_dtype(gp.args)) == np.float64
    xp = np.array([[3.0, 4.0], [7.0, 1.0], [10.0, 12.0]])
    pm = gp.posterior_mean(xp)["m(x)"]
    pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    ctx = gp.kv._fast_solver_ctx
    assert ctx["rows"].shape == ctx["cols"].shape      # the scan's rows
    assert np.all(np.isfinite(pm)) and np.all(np.isfinite(pv))
    assert np.all(pv > -1e-3)
