"""GPprior seam coverage (round-5: close the gp_prior.py coverage hole,
round-4 verdict weak #1): construction validation, kernel/mean signature
errors, the host sparse-kernel contract, dense-cross budget rejections,
and the traceable-user-callable derivative paths (exact autodiff vs
central differences)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from fvgp_tpu import GP
from fvgp_tpu.models.gp_prior import GPprior

warnings.simplefilter("ignore")

HPS = np.array([1.2, 1.4])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 8, (40, 2))
    y = np.sin(x[:, 0]) + 0.02 * rng.standard_normal(40)
    return x, y


def _jnp_sqexp(x1, x2, h):
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2 / h[1] ** 2).sum(-1)
    return h[0] * jnp.exp(-0.5 * d2)


def _jnp_sqexp4(x1, x2, h, args):
    return _jnp_sqexp(x1, x2, h) * args.get("scale", 1.0)


# ---------------------------------------------------------------------------
# construction validation (ref gp_prior.py input contracts)
# ---------------------------------------------------------------------------

def test_prior_construction_validation(data):
    x, y = data
    gp = GP(x, y, init_hyperparameters=np.array([1.0, 1.0, 1.0]))
    with pytest.raises(AssertionError, match="kernel must be callable"):
        GPprior(gp.data, gp.trainer, kernel=5)
    with pytest.raises(AssertionError,
                       match="prior_mean_function must be callable"):
        GPprior(gp.data, gp.trainer, prior_mean_function="not-a-fn")

    class BadTrainer:
        hyperparameters = np.ones((2, 2))       # 2-d: must be rejected

    with pytest.raises(AssertionError, match="1-d np.ndarray"):
        GPprior(gp.data, BadTrainer())


def test_invalid_kernel_and_mean_signatures(data):
    """5-arg kernel / 4-arg mean: arity sniffing keeps them, evaluation
    raises the reference's signature error."""
    x, y = data
    # the dense prior is computed eagerly, so construction itself raises
    with pytest.raises(Exception, match="kernel function signature"):
        GP(x, y, init_hyperparameters=HPS,
           kernel_function=lambda a, b, h, extra, more: None)
    with pytest.raises(Exception, match="mean function signature"):
        GP(x, y, init_hyperparameters=HPS,
           prior_mean_function=lambda a, h, extra, more: None)


def test_mean_must_be_1d(data):
    """A user mean returning (n, 1) corrupts every downstream residual —
    construction must reject it (ref gp_prior.py mean contract)."""
    x, y = data
    with pytest.raises(AssertionError, match="non-1-d"):
        GP(x, y, init_hyperparameters=HPS,
           prior_mean_function=lambda a, h: np.zeros((len(a), 1)))


# ---------------------------------------------------------------------------
# host sparse-kernel contract (ref gp2Scale_covariance.py:82-95)
# ---------------------------------------------------------------------------

def test_host_kernel_may_return_scipy_sparse(data):
    """A numpy kernel may return a scipy.sparse block; the dense linalg
    consumes it densified and posteriors match the dense twin."""
    from scipy.sparse import coo_matrix

    x, y = data

    def np_dense(x1, x2, h):
        x1 = np.asarray(x1, np.float64)
        x2 = np.asarray(x2, np.float64)
        d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2 / h[1] ** 2).sum(-1)
        return h[0] * np.exp(-0.5 * d2)

    def np_sparse(x1, x2, h):
        return coo_matrix(np_dense(x1, x2, h))

    gp_sp = GP(x, y, init_hyperparameters=HPS, kernel_function=np_sparse)
    gp_d = GP(x, y, init_hyperparameters=HPS, kernel_function=np_dense)
    assert not gp_sp.prior.kernel_traceable
    xp = np.array([[2.0, 1.0], [5.5, 3.0]])
    np.testing.assert_allclose(gp_sp.posterior_mean(xp)["m(x)"],
                               gp_d.posterior_mean(xp)["m(x)"], atol=1e-10)
    np.testing.assert_allclose(gp_sp.log_likelihood(),
                               gp_d.log_likelihood(), atol=1e-8)


# ---------------------------------------------------------------------------
# gp2Scale dense-cross fast path rejections (_dense_cross_or_none budget)
# ---------------------------------------------------------------------------

def _scale_gp(x, y, **extra):
    args = {"gp2Scale_block_size": 32}
    args.update(extra)
    return GP(x, y, init_hyperparameters=np.array([1.0, 2.0, 2.0]),
              gp2Scale=True, gp2Scale_batch_size=16, args=args)


def test_dense_cross_budget_rejection():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 12, (300, 2))
    y = np.sin(x[:, 0])
    xp = rng.uniform(0, 12, (5, 2))
    gp = _scale_gp(x, y)
    assert gp.prior._dense_cross_or_none(xp, gp.hyperparameters) is not None
    # a 1-byte budget rejects the dense sweep; the posterior must still
    # serve through the tile path with the same answer
    m_fast = gp.posterior_mean(xp)["m(x)"]
    gp.set_args(dict(gp.args, gp2Scale_dense_cross_budget=1))
    assert gp.prior._dense_cross_or_none(xp, gp.hyperparameters) is None
    # the fused product sweep honors the same budget (its per-chunk
    # kernel block scales with the prediction count)
    assert gp.prior.cross_covariance_product_or_none(
        xp, gp.hyperparameters, np.ones(300)) is None
    np.testing.assert_allclose(gp.posterior_mean(xp)["m(x)"], m_fast,
                               rtol=1e-8)


def test_dense_cross_oom_falls_back(monkeypatch):
    """A device RESOURCE_EXHAUSTED inside the dense sweep returns None
    (callers fall back to the memory-bounded tile path) with a warning;
    other runtime errors re-raise.  The static budget cannot see the
    device's actual residents, so the allocator is the final arbiter."""
    import warnings

    import jax

    from fvgp_tpu.models import gp_prior as gpp

    rng = np.random.default_rng(2)
    x = rng.uniform(0, 12, (300, 2))
    y = np.sin(x[:, 0])
    xp = rng.uniform(0, 12, (5, 2))
    gp = _scale_gp(x, y)

    def oom(*a, **k):
        raise jax.errors.JaxRuntimeError(
            "RESOURCE_EXHAUSTED: device backend error (ResourceExhausted).")

    monkeypatch.setattr(gpp, "_dense_cross_scan", oom)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert gp.prior._dense_cross_or_none(xp, gp.hyperparameters) is None
    assert any("exhausted device memory" in str(w.message) for w in rec)
    # the public posterior still serves (tile-structure cross path)
    m = gp.posterior_mean(xp)["m(x)"]
    assert np.all(np.isfinite(m))

    def boom(*a, **k):
        raise jax.errors.JaxRuntimeError("INTERNAL: something else")

    monkeypatch.setattr(gpp, "_dense_cross_scan", boom)
    with pytest.raises(jax.errors.JaxRuntimeError, match="something else"):
        gp.prior._dense_cross_or_none(xp, gp.hyperparameters)


def test_cross_product_none_for_host_kernel():
    """cross_covariance_product_or_none: None for host callables (callers
    materialize k instead), and 1-d vectors are promoted to one column."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 12, (200, 2))
    y = np.sin(x[:, 0])
    xp = rng.uniform(0, 12, (4, 2))

    def np_wend(x1, x2, h):
        x1 = np.asarray(x1, np.float64)
        x2 = np.asarray(x2, np.float64)
        d = np.sqrt(((x1[:, None, :] / h[1:] - x2[None, :, :] / h[1:]) ** 2
                     ).sum(-1))
        return h[0] * np.maximum(1 - d, 0.0) ** 4 * (4 * d + 1)

    gp2 = GP(x, y, init_hyperparameters=np.array([1.0, 2.0, 2.0]),
             gp2Scale=True, gp2Scale_batch_size=16,
             kernel_function=np_wend,
             args={"gp2Scale_block_size": 32,
                   "gp2Scale_lengthscales": lambda h: h[1:]})
    assert not gp2.prior.kernel_traceable
    assert gp2.prior.cross_covariance_product_or_none(
        xp, gp2.hyperparameters, np.ones(200)) is None

    gp = _scale_gp(x, y)
    v1 = gp.prior.cross_covariance_product_or_none(
        xp, gp.hyperparameters, np.ones(len(gp.x_data)))
    k = np.asarray(gp.prior._dense_cross_or_none(xp, gp.hyperparameters))
    np.testing.assert_allclose(np.asarray(v1)[:, 0], k.T @ np.ones(len(k)),
                               rtol=1e-10)


# ---------------------------------------------------------------------------
# append path with a user mean (B/D blocks + mean concatenation)
# ---------------------------------------------------------------------------

def test_append_with_user_mean(data):
    x, y = data

    def jmean(xx, h):
        return h[0] * jnp.sin(xx[:, 0])

    gp = GP(x[:30], y[:30], init_hyperparameters=HPS,
            kernel_function=_jnp_sqexp, prior_mean_function=jmean)
    gp.update_gp_data(x[30:], y[30:], append=True)
    gp_full = GP(x, y, init_hyperparameters=HPS,
                 kernel_function=_jnp_sqexp, prior_mean_function=jmean)
    np.testing.assert_allclose(np.asarray(gp.prior.m),
                               np.asarray(gp_full.prior.m), atol=1e-12)
    np.testing.assert_allclose(np.asarray(gp.prior.K),
                               np.asarray(gp_full.prior.K), atol=1e-10)
    xp = np.array([[2.0, 1.0]])
    np.testing.assert_allclose(gp.posterior_mean(xp)["m(x)"],
                               gp_full.posterior_mean(xp)["m(x)"],
                               atol=1e-9)


# ---------------------------------------------------------------------------
# traceable user-callable derivative paths (exact autodiff)
# ---------------------------------------------------------------------------

def test_dm_dx_traceable_user_mean_exact(data):
    x, y = data

    def jmean(xx, h):
        return h[0] * jnp.sin(xx[:, 0]) + 0.1 * xx[:, 1] ** 2

    gp = GP(x, y, init_hyperparameters=HPS, kernel_function=_jnp_sqexp,
            prior_mean_function=jmean)
    assert gp.prior.mean_traceable
    xq = x[:6]
    for direction in (0, 1):
        g = np.asarray(gp.prior.dm_dx(xq, HPS, direction))
        eps = 1e-6
        xh = np.array(xq)
        xh[:, direction] += eps
        xl = np.array(xq)
        xl[:, direction] -= eps
        fd = (np.asarray(gp.prior.compute_mean(xh, HPS))
              - np.asarray(gp.prior.compute_mean(xl, HPS))) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=1e-5, atol=1e-8)


def test_dm_dx_traceable_3arg_mean(data):
    x, y = data

    def jmean3(xx, h, args):
        return args["slope"] * h[0] * xx[:, 0]

    gp = GP(x, y, init_hyperparameters=HPS, kernel_function=_jnp_sqexp,
            prior_mean_function=jmean3, args={"slope": 0.7})
    assert gp.prior.mean_traceable
    g = np.asarray(gp.prior.dm_dx(x[:5], HPS, 0))
    np.testing.assert_allclose(g, 0.7 * HPS[0], rtol=1e-10)


def test_dk_dh_traceable_autodiff_vs_fd(data):
    """dk_dh on a traceable kernel: jacfwd, full stack and single
    direction, vs central differences."""
    x, y = data
    gp = GP(x, y, init_hyperparameters=HPS, kernel_function=_jnp_sqexp)
    xq = x[:7]
    jac = np.asarray(gp.prior.dk_dh(xq, xq, HPS))
    assert jac.shape == (2, 7, 7)
    eps = 1e-6
    for i in range(2):
        h_hi = np.array(HPS)
        h_lo = np.array(HPS)
        h_hi[i] += eps
        h_lo[i] -= eps
        fd = (np.asarray(gp.prior.compute_covariances(xq, xq, h_hi))
              - np.asarray(gp.prior.compute_covariances(xq, xq, h_lo))
              ) / (2 * eps)
        np.testing.assert_allclose(jac[i], fd, rtol=1e-4, atol=1e-8)
        one = np.asarray(gp.prior.dk_dh(xq, xq, HPS, direction=i))
        np.testing.assert_allclose(one, jac[i], atol=1e-12)


def test_4arg_kernel_derivative_paths(data):
    """_apply_kernel_dev's 4-arg branch: d_kernel_dx and dk_dh on a
    traceable kernel that consumes the args dict."""
    x, y = data
    gp = GP(x, y, init_hyperparameters=HPS, kernel_function=_jnp_sqexp4,
            args={"scale": 1.3})
    assert gp.prior.kernel_traceable and gp.prior.k_n_params == 4
    xq = x[:5]
    dkdx = np.asarray(gp.prior.d_kernel_dx(xq, xq, 0, HPS))
    eps = 1e-6
    xh = np.array(xq)
    xh[:, 0] += eps
    fd = (np.asarray(gp.prior.compute_covariances(xh, xq, HPS))
          - np.asarray(gp.prior.compute_covariances(xq, xq, HPS))) / eps
    # one-sided FD: O(eps) truncation dominates near the diagonal (the
    # exact derivative there is 0)
    np.testing.assert_allclose(dkdx, fd, rtol=1e-4, atol=5e-6)
    jac = np.asarray(gp.prior.dk_dh(xq, xq, HPS, direction=0))
    h_hi = np.array(HPS)
    h_hi[0] += eps
    h_lo = np.array(HPS)
    h_lo[0] -= eps
    fd0 = (np.asarray(gp.prior.compute_covariances(xq, xq, h_hi))
           - np.asarray(gp.prior.compute_covariances(xq, xq, h_lo))
           ) / (2 * eps)
    np.testing.assert_allclose(jac, fd0, rtol=1e-4, atol=1e-8)


def test_dm_dh_traceable_user_mean(data):
    x, y = data

    def jmean(xx, h):
        return h[0] * jnp.sin(xx[:, 0]) + h[1] * xx[:, 1]

    gp = GP(x, y, init_hyperparameters=HPS, kernel_function=_jnp_sqexp,
            prior_mean_function=jmean)
    J = np.asarray(gp.prior.dm_dh(x[:6], HPS))
    assert J.shape == (2, 6)
    np.testing.assert_allclose(J[0], np.sin(x[:6, 0]), atol=1e-12)
    np.testing.assert_allclose(J[1], x[:6, 1], atol=1e-12)


def test_dm_dh_traceable_3arg_mean(data):
    x, y = data

    def jmean3(xx, h, args):
        return args["slope"] * h[1] * xx[:, 0]

    gp = GP(x, y, init_hyperparameters=HPS, kernel_function=_jnp_sqexp,
            prior_mean_function=jmean3, args={"slope": 0.5})
    J = np.asarray(gp.prior.dm_dh(x[:4], HPS))
    np.testing.assert_allclose(J[1], 0.5 * x[:4, 0], atol=1e-12)
    np.testing.assert_allclose(J[0], 0.0, atol=1e-12)
