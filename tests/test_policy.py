"""Policy & caching semantics (ref tests/test_fvgp.py:1829-1955, :2396-2486):
preconditioner reuse counters, drift invalidation, warm-start gating, args
threading, multi-column y, posterior hyperparameter overrides."""

import warnings

import numpy as np
import pytest

from fvgp_tpu import GP

warnings.simplefilter("ignore")

HPS = np.array([1.0, 1.0, 1.0])


def _gp(small_data, **kw):
    x, y = small_data
    return GP(x, y, init_hyperparameters=HPS, **kw)


def test_preconditioner_reuse_and_drift(small_data):
    """Reuse until K+V drifts past the threshold; counter tracks reuses
    (ref gp_kv.py:319-388)."""
    gp = _gp(small_data, linalg_mode="sparseCGpre",
             args={"sparse_preconditioner_refresh_interval": 100,
                   "sparse_krylov_warm_start": True})
    kv = gp.kv
    assert kv.Preconditioner_operator is not None
    base = kv.Preconditioner_reuse_counter
    # tiny hp move: drift below 0.1 -> reuse
    gp.marginal_likelihood.log_likelihood(HPS * 1.0005)
    assert kv.Preconditioner_reuse_counter > base
    # big hp move: drift above threshold -> rebuild (counter resets)
    gp.marginal_likelihood.log_likelihood(HPS * 5.0)
    assert kv.Preconditioner_reuse_counter == 0


def test_preconditioner_refresh_interval_cap(small_data):
    """The optional hard cap forces a rebuild after k reuses
    (ref gp_kv.py:195-207)."""
    gp = _gp(small_data, linalg_mode="sparseCGpre",
             args={"sparse_preconditioner_refresh_interval": 3})
    kv = gp.kv
    # KVinvY is lazy: the first access runs construction's solve, which
    # builds the preconditioner and reuses it once
    kv.KVinvY
    assert kv.Preconditioner_reuse_counter == 1
    gp.marginal_likelihood.log_likelihood(HPS * 1.0001)  # reuse 2
    assert kv.Preconditioner_reuse_counter == 2
    gp.marginal_likelihood.log_likelihood(HPS * 1.0002)  # cap hit -> rebuild
    assert kv.Preconditioner_reuse_counter == 0


def test_set_kv_force_refreshes_preconditioner(small_data):
    """set_hyperparameters -> set_KV must force-refresh regardless of drift
    (ref gp_kv.py:355-364)."""
    gp = _gp(small_data, linalg_mode="sparseCGpre",
             args={"sparse_preconditioner_refresh_interval": 100})
    gp.marginal_likelihood.log_likelihood(HPS * 1.0001)
    counter_before = gp.kv.Preconditioner_reuse_counter
    assert counter_before >= 1
    gp.set_hyperparameters(HPS * 1.0002)
    # set_KV force-rebuilt (counter reset); the refresh's own solve then
    # reused the fresh factor at most once — had reuse continued instead,
    # the counter would exceed counter_before
    assert gp.kv.Preconditioner_reuse_counter <= 1 <= counter_before


def test_warm_start_dropped_on_drift(small_data):
    """A warm start from a materially different K+V must be discarded
    (ref gp_kv.py:287-308)."""
    gp = _gp(small_data, linalg_mode="sparseCG",
             args={"sparse_krylov_warm_start": True})
    kv = gp.kv
    KV1 = kv.addKV(gp.prior.compute_prior_covariance_matrix(gp.x_data, HPS),
                   gp.likelihood.calculate_V(gp.x_data, HPS))
    kv.Warm_start_fingerprint = kv.matrix_fingerprint(KV1)
    x0 = np.ones(len(gp.x_data))
    assert kv._validated_warm_start(KV1, x0) is not None
    KV2 = kv.addKV(gp.prior.compute_prior_covariance_matrix(gp.x_data, HPS * 5),
                   gp.likelihood.calculate_V(gp.x_data, HPS * 5))
    assert kv._validated_warm_start(KV2, x0) is None


def test_mode_alias_resolution(small_data):
    """sparseCGpre_<type> resolves to mode + args key
    (ref gp_lin_alg.py:474-505)."""
    gp = _gp(small_data, linalg_mode="sparseCGpre_block_jacobi")
    assert gp.kv.mode == "sparseCGpre"
    assert gp.args["sparse_preconditioner_type"] == "block_jacobi"
    with pytest.raises(Exception):
        _gp(small_data, linalg_mode="sparseCGpre_bogus")


def test_multi_column_y_independent_gps(small_data):
    """(V, N)-shaped y runs N independent GPs sharing K
    (ref gp.py:49-51, gp_marginal_likelihood.py:175)."""
    x, y = small_data
    Y = np.stack([y, 2.0 * y], axis=1)
    gp = GP(x, Y, init_hyperparameters=HPS)
    assert gp.kv.KVinvY.shape == (len(x), 2)
    res = gp.posterior_mean(x[:5])
    assert res["m(x)"].shape == (5, 2)
    cov = gp.posterior_covariance(x[:5])
    assert cov["v(x)"].shape == (5, 2)   # tiled variance per output


def test_posterior_with_hyperparameter_override(small_data):
    """posterior_mean(hyperparameters=...) rebuilds K, V, m for that call
    without committing state (ref gp_posterior.py:141-146)."""
    x, y = small_data
    gp = GP(x, y, init_hyperparameters=HPS)
    committed = gp.posterior_mean(x[:4])["m(x)"]
    other = gp.posterior_mean(x[:4], hyperparameters=HPS * 3.0)["m(x)"]
    assert not np.allclose(committed, other)
    # state unchanged: committed answer reproducible
    np.testing.assert_allclose(gp.posterior_mean(x[:4])["m(x)"], committed,
                               atol=1e-12)
    gp2 = GP(x, y, init_hyperparameters=HPS * 3.0)
    np.testing.assert_allclose(other, gp2.posterior_mean(x[:4])["m(x)"],
                               atol=1e-8)


def test_args_threaded_to_callables(small_data):
    """4-arg kernels receive the live args dict (ref gp_prior.py:213-220)."""
    x, y = small_data
    seen = {}

    def kernel(x1, x2, hps, args):
        seen["marker"] = args.get("marker")
        import numpy as _np
        dm = _np.zeros((len(x1), len(x2)))
        for i in range(x1.shape[1]):
            dm += _np.subtract.outer(_np.asarray(x1)[:, i],
                                     _np.asarray(x2)[:, i]) ** 2
        return hps[0] * _np.exp(-_np.sqrt(dm) / hps[1])

    gp = GP(x, y, init_hyperparameters=np.array([1.0, 2.0]),
            kernel_function=kernel, args={"marker": 42})
    assert seen["marker"] == 42
    gp.set_args({"marker": 77})
    gp.set_hyperparameters(np.array([1.0, 2.5]))  # flush (ref gp.py:613-632)
    assert seen["marker"] == 77


def test_cholinv_variance_fast_path_matches_full(small_data):
    """variance_only einsum fast path == diag of the full S
    (ref gp_posterior.py:238-246)."""
    x, y = small_data
    gp = GP(x, y, init_hyperparameters=HPS, linalg_mode="CholInv")
    xp = np.random.default_rng(5).uniform(0, 10, (6, 2))
    v_fast = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    full = gp.posterior_covariance(xp, variance_only=False)
    np.testing.assert_allclose(v_fast, full["v(x)"], atol=1e-8)
    assert gp.posterior_covariance(xp, variance_only=True)["S"] is None


def test_add_noise_posterior(small_data):
    """add_noise=True adds the noise model at the prediction points
    (ref gp_posterior.py:554-569)."""
    x, y = small_data

    def noise(xq, hps):
        import numpy as _np
        return _np.full(len(xq), 0.25)

    gp = GP(x, y, init_hyperparameters=HPS, noise_function=noise)
    xp = x[:5]
    v0 = gp.posterior_covariance(xp)["v(x)"]
    v1 = gp.posterior_covariance(xp, add_noise=True)["v(x)"]
    np.testing.assert_allclose(v1 - v0, 0.25, atol=1e-10)


def test_default_hyperparameter_bounds_guarded(small_data):
    """Custom-callable GPs must reject the data-driven default bounds
    (ref gp.py:715-737)."""
    x, y = small_data

    def kernel(x1, x2, hps):
        import numpy as _np
        return hps[0] * _np.eye(len(x1), len(x2))

    gp = GP(x, y, init_hyperparameters=np.array([1.0]), kernel_function=kernel)
    with pytest.raises(Exception):
        gp._get_default_hyperparameter_bounds()


def test_log_likelihood_variance_contract(small_data):
    """None for exact modes; a float after a stochastic logdet
    (ref gp_marginal_likelihood.py:182-204)."""
    x, y = small_data
    gp = GP(x, y, init_hyperparameters=HPS)
    assert gp.marginal_likelihood.log_likelihood_variance() is None
    gp2 = GP(x, y, init_hyperparameters=HPS, linalg_mode="sparseCG",
             args={"random_logdet_min_num_samples": 16,
                   "random_logdet_max_num_samples": 64})
    gp2.log_likelihood()     # logdet is lazy; evaluate the LML first
    v = gp2.marginal_likelihood.log_likelihood_variance()
    assert v is not None and v >= 0.0

@pytest.mark.slow
def test_gp2scale_auto_mode_large_n_is_preconditioned_cg():
    """At large N the auto-selected gp2Scale mode is sparseCGpre — a
    documented deviation from the reference's unpreconditioned
    sparseMINRES (ref gp_kv.py:182-188): K+V is SPD, and at N=1M every
    Krylov matvec reads every stored tile, so the preconditioned solve is
    the difference between minutes and seconds per posterior call."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 25, (600, 2))
    y = np.sin(x[:, 0])
    gp = GP(x, y, init_hyperparameters=np.array([1.0, 3.0, 3.0]),
            gp2Scale=True, args={"gp2Scale_block_size": 64,
                                 "gp2Scale_traced_lml": False})
    kv = gp.kv
    KV = kv.KV          # materialize so nnz is known
    xd_big = np.zeros((1_000_001, 1))
    data = kv.data

    class _BigN:
        def __getattr__(self, attr):
            return getattr(data, attr)

        @property
        def x_data(self):
            return xd_big

    kv.data = _BigN()
    try:
        assert kv._set_gp2Scale_mode(KV) == "sparseCGpre"
    finally:
        kv.data = data
    # small/sparse branches keep reference parity
    assert kv.mode in ("Chol", "sparseLU")


@pytest.mark.slow
def test_cross_covariance_memo_lifecycle():
    """posterior_mean→posterior_covariance at the same points assembles
    k(x_data, x_pred) ONCE; hps moves and data updates invalidate; pickles
    drop the memo (device arrays never enter the blob)."""
    import pickle
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 40, (300, 2))
    y = np.sin(x[:, 0])
    hps = np.array([1.0, 1.5, 1.5])
    gp = _make_gp2scale(x, y, hps)
    xp = rng.uniform(0, 40, (9, 2))
    calls = {"n": 0}
    orig = gp.posterior.prior.compute_data_cross_covariance

    def counted(xq, h):
        calls["n"] += 1
        return orig(xq, h)

    gp.posterior.prior.compute_data_cross_covariance = counted
    pm = gp.posterior_mean(xp)["m(x)"]
    gp.posterior_covariance(xp, variance_only=True)
    assert calls["n"] == 1
    gp.set_hyperparameters(hps * 1.3)
    pm2 = gp.posterior_mean(xp)["m(x)"]
    assert calls["n"] == 2 and not np.allclose(pm2, pm)
    xa = rng.uniform(0, 40, (32, 2))
    gp.update_gp_data(np.vstack([np.asarray(gp.x_data), xa]),
                      np.concatenate([np.asarray(gp.y_data)[:, 0],
                                      np.sin(xa[:, 0])]))
    before = calls["n"]
    gp.posterior_mean(xp)
    assert calls["n"] == before + 1
    gp.posterior.prior.compute_data_cross_covariance = orig
    gp2 = pickle.loads(pickle.dumps(gp))
    assert gp2.posterior._cross_cov_memo is None
    np.testing.assert_allclose(gp2.posterior_mean(xp)["m(x)"],
                               gp.posterior_mean(xp)["m(x)"], atol=1e-10)


def _make_gp2scale(x, y, hps):
    return GP(x, y, init_hyperparameters=hps, gp2Scale=True,
              args={"gp2Scale_block_size": 64, "sparse_cg_tol": 1e-10})


def test_warm_start_buys_cg_iterations(small_data):
    """The measurable payoff of the warm-start gate (ref gp_kv.py:30-60:
    warm starts from a near-by K+V cut the residual budget ~25x): a tiny
    hyperparameter move solved with the previous KVinvY as x0 needs FEWER
    CG iterations than the same move solved cold.  `last_solve_info`
    records the counts."""
    x, y = small_data
    hps2 = HPS * 1.001

    cold = GP(x, y, init_hyperparameters=HPS, linalg_mode="sparseCG",
              args={"sparse_krylov_warm_start": False})
    cold.log_likelihood()                       # commit the state at HPS
    cold.marginal_likelihood.log_likelihood(hps2)
    it_cold = cold.kv.last_solve_info["iterations"]
    assert cold.kv.last_solve_info["warm_start"] is False

    warm = GP(x, y, init_hyperparameters=HPS, linalg_mode="sparseCG",
              args={"sparse_krylov_warm_start": True})
    warm.log_likelihood()
    warm.marginal_likelihood.log_likelihood(hps2)
    it_warm = warm.kv.last_solve_info["iterations"]
    assert warm.kv.last_solve_info["warm_start"] is True

    assert it_warm < it_cold, (it_warm, it_cold)


def test_sequential_linalg_state_gates_warm_start_by_method(small_data):
    """The facade's training gate (ref gp_kv.py:30-85): a user-enabled warm
    start stays live for method='mcmc' (successive evaluations are close)
    but is forced OFF for non-sequential methods for the duration, then
    restored."""
    import warnings as _w

    from fvgp_tpu.models.gp_kv import sequential_linalg_state

    x, y = small_data
    gp = GP(x, y, init_hyperparameters=HPS, linalg_mode="sparseCG",
            args={"sparse_krylov_warm_start": True})
    gp.log_likelihood()
    with sequential_linalg_state(gp.args, "mcmc"):
        gp.marginal_likelihood.log_likelihood(HPS * 1.001)
        gp.marginal_likelihood.log_likelihood(HPS * 1.002)
        assert gp.kv.last_solve_info["warm_start"] is True
    with _w.catch_warnings():
        _w.simplefilter("ignore")       # the gate warns about the override
        with sequential_linalg_state(gp.args, "global"):
            assert gp.args["sparse_krylov_warm_start"] is False
            gp.marginal_likelihood.log_likelihood(HPS * 1.01)
            assert gp.kv.last_solve_info["warm_start"] is False
    assert gp.args["sparse_krylov_warm_start"] is True
