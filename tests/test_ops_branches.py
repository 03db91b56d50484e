"""Numeric-op fallback branches and actor error publication.

Covers: dense inverse/solve fallbacks on non-PD or singular inputs, the
preconditioner shift-retry exhaustion, distance-matrix branch selection,
Krylov x0 shape coercion, and the actor thread's exception publication
contract (ref gp_lin_alg.py:514-531, :1588-1592; ref gp_actor.py:7-211)."""

import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

warnings.simplefilter("ignore")


def test_dense_inverse_and_solve_fallbacks():
    from fvgp_tpu.ops import dense as D
    # non-PD symmetric matrix: Chol fails -> general inverse
    A = np.array([[1.0, 2.0], [2.0, 1.0]])      # eigenvalues 3, -1
    inv = np.asarray(D.calculate_inv(jnp.asarray(A)))
    np.testing.assert_allclose(inv, np.linalg.inv(A), atol=1e-10)
    # singular system: solve falls back to lstsq
    S = np.array([[1.0, 1.0], [1.0, 1.0]])
    b = np.array([2.0, 2.0])
    x = np.asarray(D.solve(jnp.asarray(S), jnp.asarray(b)))
    np.testing.assert_allclose(S @ x, b, atol=1e-8)


def test_precond_shift_retry_exhaustion():
    from fvgp_tpu.ops.precond import _shifted_cholesky
    bad = jnp.asarray(np.array([[[np.nan, 0.0], [0.0, 1.0]]]))
    with pytest.raises(RuntimeError):
        _shifted_cholesky(bad, {"sparse_preconditioner_shift_attempts": 2})
    # a merely non-PD block is rescued by the shift ladder
    nonpd = jnp.asarray(np.array([[[1.0, 2.0], [2.0, 1.0]]]))
    L = _shifted_cholesky(nonpd, {"sparse_preconditioner_shift": 2.0})
    assert np.all(np.isfinite(np.asarray(L)))


def test_distance_matrix_branches():
    from fvgp_tpu import kernels as K
    rng = np.random.default_rng(0)
    # low-D broadcast branch
    x1 = rng.standard_normal((6, 3))
    x2 = rng.standard_normal((5, 3))
    got = np.asarray(K.get_distance_matrix(x1, x2))
    brute = np.sqrt(((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1))
    np.testing.assert_allclose(got, brute, atol=1e-10)
    # high-D matmul-expansion branch (deep-kernel embeddings)
    e1 = rng.standard_normal((7, 64))
    e2 = rng.standard_normal((4, 64))
    got_hd = np.asarray(K.get_distance_matrix(e1, e2))
    brute_hd = np.sqrt(((e1[:, None, :] - e2[None, :, :]) ** 2).sum(-1))
    np.testing.assert_allclose(got_hd, brute_hd, atol=1e-8)
    d = jnp.asarray(np.abs(rng.standard_normal((4, 4))))
    w = np.asarray(K.wendland_kernel(d))
    assert w.shape == (4, 4) and np.all(w >= 0.0)
    g = np.asarray(K.matern_kernel_diff1_grad(d, 0.7 * d))
    assert np.all(np.isfinite(g))
    r = np.asarray(K.matern_kernel_diff2_robust(d, 0.9))
    assert np.all(np.isfinite(r)) and float(r[0, 0]) > 0


def test_krylov_x0_shape_coercion():
    from fvgp_tpu.ops.krylov import cg
    rng = np.random.default_rng(1)
    A = rng.standard_normal((8, 8))
    A = A @ A.T + 8 * np.eye(8)
    B = rng.standard_normal((8, 2))
    want = np.linalg.solve(A, B)
    Aj = jnp.asarray(A)
    # 1-d x0 against a 2-RHS system: zero-padded to shape
    out = np.asarray(cg(lambda X: Aj @ X, jnp.asarray(B),
                        x0=jnp.asarray(want[:, 0]), maxiter=200, tol=1e-12))
    np.testing.assert_allclose(out, want, atol=1e-7)
    # oversized x0: truncated
    big = np.zeros((10, 3))
    big[:8, :2] = want
    out2 = np.asarray(cg(lambda X: Aj @ X, jnp.asarray(B),
                         x0=jnp.asarray(big), maxiter=200, tol=1e-12))
    np.testing.assert_allclose(out2, want, atol=1e-7)


def test_actor_error_publication_and_async_optimizer():
    from fvgp_tpu.models.gp_actor import AsyncOptimizer, _MultistartActor

    def boom(publish, stop_requested):
        raise RuntimeError("worker exploded (synthetic)")

    actor = _MultistartActor(boom).start()
    opt = AsyncOptimizer(actor)
    deadline = time.time() + 10
    while not opt.is_done() and time.time() < deadline:
        time.sleep(0.02)
    assert opt.is_done()
    latest = actor.get_latest()
    assert "error" in latest and "worker exploded" in latest["error"]
    # the full polling surface stays callable after the failure
    opt.stop()
    opt.cancel_tasks()
    opt.kill_client()
    assert opt.get_final() is not None


def test_async_optimizer_happy_path():
    from fvgp_tpu.models.gp_actor import AsyncOptimizer, _MultistartActor

    def run(publish, stop_requested):
        return [{"x": np.array([1.0, 2.0]), "f(x)": -3.0}]

    actor = _MultistartActor(run).start()
    opt = AsyncOptimizer(actor)
    deadline = time.time() + 10
    while not opt.is_done() and time.time() < deadline:
        time.sleep(0.02)
    out = opt.get_final()
    assert out and np.allclose(out[0]["x"], [1.0, 2.0])


# ---------------------------------------------------------------------------
# sparse-LML factory validation + f32-streaming mesh paths (round 5)
# ---------------------------------------------------------------------------

def _tiny_sparse_system(nb=8, B=16, seed=0):
    """Padded inputs + full symmetric tile schedule for a tiny system."""
    from fvgp_tpu.ops.sparse_lml import make_padded_inputs
    rng = np.random.default_rng(seed)
    n = nb * B - 5
    x = rng.uniform(0, 6.0, (n, 2))
    y = np.sin(x[:, 0])
    noise = np.full(n, 1e-2)
    xb, mask, y_pad, ypad_mask, noise_pad = make_padded_inputs(
        x, y, noise, B, dtype=jnp.float64)
    nb_eff = int(xb.shape[0])
    rows, cols = np.meshgrid(np.arange(nb_eff), np.arange(nb_eff),
                             indexing="ij")
    order = np.argsort(rows.ravel(), kind="stable")
    return (xb, mask, y_pad, ypad_mask, noise_pad, nb_eff,
            rows.ravel()[order].astype(np.int32),
            cols.ravel()[order].astype(np.int32))


def test_sparse_lml_factory_validation():
    from fvgp_tpu.kernels import wendland_anisotropic
    from fvgp_tpu.ops.sparse_lml import (make_committed_solver,
                                         make_sparse_lml)
    import jax
    from fvgp_tpu.parallel import mesh as pmesh
    with pytest.raises(ValueError, match="unknown sparse-LML solver"):
        make_sparse_lml(wendland_anisotropic, 8, 16, solver="bogus")
    mesh = pmesh.make_mesh()
    with pytest.raises(ValueError, match="must be a multiple"):
        make_sparse_lml(wendland_anisotropic, 7, 16, mesh=mesh)
    with pytest.raises(ValueError, match="must be a multiple"):
        make_committed_solver(wendland_anisotropic, 7, 16, mesh=mesh)
    with pytest.raises(ValueError, match="cannot combine with a mesh"):
        make_committed_solver(wendland_anisotropic, 8, 16, mesh=mesh,
                              fused_spmm=True)


def test_mesh_paths_with_cast_streaming(eight_devices):
    """solver_dtype=f32 on the 8-device mesh exercises the cast branches
    of the row-partitioned / halo SpMMs and the committed solver; results
    match the f64 meshless run to f32 accuracy."""
    import jax
    from fvgp_tpu.kernels import wendland_anisotropic
    from fvgp_tpu.ops.sparse_lml import (make_committed_solver,
                                         make_sparse_lml)
    from fvgp_tpu.parallel import mesh as pmesh
    from fvgp_tpu.parallel.partition import partition_schedule
    (xb, mask, y_pad, ypad_mask, noise_pad, nb, rows, cols) = \
        _tiny_sparse_system()
    hps = jnp.asarray(np.array([1.0, 2.0, 2.0]))
    Z = jax.random.rademacher(jax.random.PRNGKey(0),
                              (nb * 16, 8), dtype=jnp.float64)
    Z = Z * ypad_mask[:, None]
    args64 = (jnp.asarray(rows), jnp.asarray(cols), xb, mask, y_pad,
              ypad_mask, noise_pad, Z)
    lml64 = make_sparse_lml(wendland_anisotropic, nb, 16, cg_iters=64,
                            solver="mbcg")
    ref = float(jax.jit(lml64)(hps, *args64))

    mesh = pmesh.make_mesh()
    rows_p, cols_p, _, _ = partition_schedule(rows, cols, nb, 8)
    lml32 = make_sparse_lml(wendland_anisotropic, nb, 16, cg_iters=64,
                            solver="mbcg", solver_dtype=jnp.float32,
                            mesh=mesh)
    got = float(jax.jit(lml32)(hps, jnp.asarray(rows_p),
                               jnp.asarray(cols_p), xb, mask, y_pad,
                               ypad_mask, noise_pad, Z))
    assert abs(got - ref) / abs(ref) < 1e-3

    # committed solver, f32 streaming on the mesh
    assemble, solve = make_committed_solver(
        wendland_anisotropic, nb, 16, cg_iters=128, cg_tol=1e-6,
        solver_dtype=jnp.float32, mesh=mesh)
    tiles, pdata = jax.jit(assemble)(hps, jnp.asarray(rows_p),
                                     jnp.asarray(cols_p), xb, mask,
                                     noise_pad)
    rhs = (y_pad * ypad_mask)[:, None]
    X, it = jax.jit(solve)(tiles, pdata, jnp.asarray(rows_p),
                           jnp.asarray(cols_p), noise_pad, rhs)
    assert int(it) > 0
    # residual check against the dense oracle
    xd = np.asarray(xb).reshape(-1, 2)
    K = np.array(wendland_anisotropic(xd, xd, np.asarray(hps)))
    K *= np.asarray(mask).ravel()[:, None] * np.asarray(mask).ravel()[None, :]
    KV = K + np.diag(np.asarray(noise_pad))
    np.testing.assert_allclose(KV @ np.asarray(X)[:, 0],
                               np.asarray(rhs)[:, 0], atol=1e-4)


def test_mesh_precond_width_indivisible_warns(eight_devices):
    """gp2Scale_precond_width that does not divide the PER-DEVICE block
    count warns and falls back to width 1 instead of failing or silently
    changing semantics."""
    import jax
    from fvgp_tpu.kernels import wendland_anisotropic
    from fvgp_tpu.ops.sparse_lml import make_sparse_lml
    from fvgp_tpu.parallel import mesh as pmesh
    from fvgp_tpu.parallel.partition import partition_schedule
    (xb, mask, y_pad, ypad_mask, noise_pad, nb, rows, cols) = \
        _tiny_sparse_system()
    hps = jnp.asarray(np.array([1.0, 2.0, 2.0]))
    Z = jax.random.rademacher(jax.random.PRNGKey(0),
                              (nb * 16, 8), dtype=jnp.float64)
    Z = Z * ypad_mask[:, None]
    mesh = pmesh.make_mesh()
    rows_p, cols_p, _, _ = partition_schedule(rows, cols, nb, 8)
    lml = make_sparse_lml(wendland_anisotropic, nb, 16, cg_iters=32,
                          solver="mbcg", mesh=mesh, precond_width=3)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        val = float(jax.jit(lml)(hps, jnp.asarray(rows_p),
                                 jnp.asarray(cols_p), xb, mask, y_pad,
                                 ypad_mask, noise_pad, Z))
    assert np.isfinite(val)
    msgs = " ".join(str(w.message) for w in rec)
    assert "does not divide the local block count" in msgs


def test_slq_f32_lanczos_breakdown_no_nan():
    """Exact Lanczos breakdown (diagonal operator: w == 0 at step 1) in
    f32 must not NaN the logdet — the old 1e-300 guard underflowed to 0.0
    in f32 (review finding, reproduced)."""
    import jax
    from fvgp_tpu.ops.sparse_lml import _slq_fixed
    n = 64
    Z = jax.random.rademacher(jax.random.PRNGKey(0), (n, 4),
                              dtype=jnp.float32)
    ld, _ = _slq_fixed(lambda X: 2.0 * X, Z, degree=8)
    assert np.isfinite(float(ld))
    np.testing.assert_allclose(float(ld), n * np.log(2.0), rtol=1e-5)


def test_committed_fused_path_rejects_f64():
    """fused_spmm (the f32-accumulating kernel) must refuse f64 solves
    instead of silently truncating the documented full-precision
    semantics."""
    import jax
    from fvgp_tpu.kernels import wendland_anisotropic
    from fvgp_tpu.ops.sparse_lml import (make_committed_solver,
                                         make_padded_inputs)
    rng = np.random.default_rng(0)
    n, B = 59, 16
    x = rng.uniform(0, 6.0, (n, 2))
    xb, mask, y_pad, ypad_mask, noise_pad = make_padded_inputs(
        x, np.zeros(n), np.full(n, 1e-2), B, dtype=jnp.float64)
    nb = int(xb.shape[0])
    rows = np.repeat(np.arange(nb), nb).astype(np.int32)
    cols = np.tile(np.arange(nb), nb).astype(np.int32)
    assemble, solve = make_committed_solver(wendland_anisotropic, nb, B,
                                            fused_spmm=True)
    hps = jnp.asarray(np.array([1.0, 2.0, 2.0]))
    from fvgp_tpu.ops.pallas_kernels import row_offsets
    tiles, pdata = jax.jit(assemble)(hps, jnp.asarray(rows),
                                     jnp.asarray(cols), xb, mask,
                                     noise_pad)
    with pytest.raises(ValueError, match="accumulates in f32"):
        solve(tiles, pdata, jnp.asarray(row_offsets(rows, nb)),
              jnp.asarray(cols), noise_pad, (y_pad * ypad_mask)[:, None])
