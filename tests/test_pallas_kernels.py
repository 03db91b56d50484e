"""The committed-solve SpMM kernel (ops/pallas_kernels) against the XLA
formulation: interpret mode on the CPU, compiled on a GPU (``gpu`` marker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fvgp_tpu.ops import pallas_kernels as pk
from fvgp_tpu.ops.sparse_lml import _spmv_scan


def _system(rng, nb=6, B=16, n_pairs=14, empty_row=2, n_sentinel=3):
    """Row-sorted schedule with an empty row and trailing sentinel tiles
    (row == col == nb, zero tiles), plus the dense operator it encodes."""
    pairs = sorted({(int(rng.integers(0, nb)), int(rng.integers(0, nb)))
                    for _ in range(n_pairs)})
    pairs = [p for p in pairs if p[0] != empty_row]
    rows = np.array([p[0] for p in pairs] + [nb] * n_sentinel, np.int32)
    cols = np.array([p[1] for p in pairs] + [nb] * n_sentinel, np.int32)
    tiles = rng.standard_normal((len(rows), B, B)).astype(np.float32)
    tiles[len(pairs):] = 0.0
    A = np.zeros((nb * B, nb * B), np.float64)
    for t, (r, c) in enumerate(pairs):
        A[r * B:(r + 1) * B, c * B:(c + 1) * B] += tiles[t]
    return rows, cols, tiles, A, nb, B


def _scan_ref(rows, cols, tiles, X, nb, B, dt):
    with jax.default_matmul_precision("highest"):
        return _spmv_scan(jnp.minimum(jnp.asarray(rows), nb - 1),
                          jnp.minimum(jnp.asarray(cols), nb - 1),
                          tiles, X, nb, B, mv_dtype=dt)


@pytest.mark.parametrize("k", [1, 17, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_block_spmm_matches_scan(k, dtype):
    """Interpret-mode kernel vs ``_spmv_scan`` on the same tile and X values
    (X cast to the tile dtype, f32 accumulation), with an empty row block
    and sentinel tiles."""
    rng = np.random.default_rng(k)
    rows, cols, tiles, A, nb, B = _system(rng)
    dt = jnp.dtype(dtype)
    t = jnp.asarray(tiles, dt)
    X = jnp.asarray(rng.standard_normal((nb * B, k)), jnp.float32)
    got = pk.row_block_spmm(pk.row_offsets(rows, nb), cols, t, X, nb, B)
    ref = _scan_ref(rows, cols, t, X, nb, B, dt)
    assert got.shape == (nb * B, k) and got.dtype == X.dtype
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-4)
    # the empty row block comes back exactly zero
    np.testing.assert_array_equal(np.asarray(got)[2 * B:3 * B], 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(np.asarray(got), A @ np.asarray(X),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,itemsize,expect", [
    (1, 2, (16, 16)), (16, 2, (16, 16)), (17, 2, (32, 32)),
    (130, 2, (64, 192)), (512, 2, (64, 512)), (130, 4, (32, 160)),
    (8, 4, (16, 16))])
def test_k_blocking(k, itemsize, expect):
    """kb is a power of two in [16, 64] (32 for f32 tiles); k pads up to a
    multiple of it."""
    assert pk.k_blocking(k, itemsize) == expect


def test_row_block_spmm_padding_does_not_leak():
    """k is padded to the k-block inside the wrapper: the result has the
    caller's width and dtype, and padding columns never reach it."""
    rng = np.random.default_rng(3)
    rows, cols, tiles, A, nb, B = _system(rng)
    X = rng.standard_normal((nb * B, 3))
    for k in (1, 2, 3):
        got = pk.row_block_spmm(pk.row_offsets(rows, nb), cols,
                                jnp.asarray(tiles),
                                jnp.asarray(X[:, :k], jnp.float32), nb, B)
        assert got.shape == (nb * B, k) and got.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(got), A @ X[:, :k],
                                   rtol=1e-4, atol=1e-4)


def test_row_block_spmm_mv_dtype_casts_tiles():
    """``mv_dtype=bfloat16`` streams f32-stored tiles as bf16, like the XLA
    SpMMs' ``mv_dtype``."""
    rng = np.random.default_rng(4)
    rows, cols, tiles, A, nb, B = _system(rng)
    X = jnp.asarray(rng.standard_normal((nb * B, 5)), jnp.float32)
    got = pk.row_block_spmm(pk.row_offsets(rows, nb), cols,
                            jnp.asarray(tiles), X, nb, B,
                            mv_dtype=jnp.bfloat16)
    ref = _scan_ref(rows, cols, jnp.asarray(tiles, jnp.bfloat16), X, nb, B,
                    jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-4)


def test_row_block_sub_blocks_cover_the_tile():
    """Tiles wider than the sub-block (B = 256 on the card) stream as
    (bm, bk) pieces over row halves and contraction steps; a sub-block of
    B/2 at a small B exercises that path."""
    rng = np.random.default_rng(5)
    rows, cols, tiles, A, nb, B = _system(rng, B=32)
    X = rng.standard_normal((nb * B, 16)).astype(np.float32)
    out = pk._row_block_call(jnp.asarray(pk.row_offsets(rows, nb)),
                             jnp.asarray(cols), jnp.asarray(tiles),
                             jnp.asarray(X).reshape(nb, B, 16), nb, B, 16,
                             True, sub=16)
    np.testing.assert_allclose(np.asarray(out).reshape(nb * B, 16), A @ X,
                               rtol=1e-4, atol=1e-4)


def test_row_offsets_contract():
    """CSR offsets of a row-sorted schedule: each row's tiles are
    [rowptr[i], rowptr[i+1]); empty rows have equal offsets; trailing
    sentinels (row == nb) fall outside every row."""
    rows = np.array([0, 0, 1, 3, 3, 4, 5, 5, 5], np.int32)   # nb=5: 5 = pad
    rp = pk.row_offsets(rows, 5)
    assert rp.dtype == np.int32
    np.testing.assert_array_equal(rp, [0, 2, 3, 3, 5, 6])
    for i in range(5):
        assert np.all(rows[rp[i]:rp[i + 1]] == i)


def test_row_offsets_rejects_unsorted_rows():
    with pytest.raises(ValueError, match="row-sorted"):
        pk.row_offsets(np.array([1, 0, 2]), 3)


@pytest.mark.parametrize("B,ok", [(16, True), (64, True), (128, True),
                                  (256, True), (8, False), (100, False),
                                  (48, False)])
def test_supports_block_size(B, ok):
    """Triton block shapes are powers of two and its dot needs >= 16."""
    assert pk.supports(B) is ok


def test_row_block_spmm_rejects_bad_inputs():
    rng = np.random.default_rng(6)
    rows, cols, tiles, A, nb, B = _system(rng)
    rp = pk.row_offsets(rows, nb)
    X = jnp.zeros((nb * B, 2), jnp.float64)
    with pytest.raises(ValueError, match="f32 or bf16"):
        pk.row_block_spmm(rp, cols, jnp.asarray(tiles, jnp.float64), X,
                          nb, B)
    with pytest.raises(ValueError, match="power-of-two"):
        pk.row_block_spmm(rp, cols, jnp.zeros((2, 12, 12), jnp.float32),
                          jnp.zeros((24, 1), jnp.float32), 2, 12)


@pytest.mark.parametrize("backend,expect", [("cpu", True), ("gpu", False),
                                            ("rocm", None), ("metal", None)])
def test_interpret_mode_only_on_cpu(monkeypatch, backend, expect):
    """The kernel interprets only on the CPU backend (tests); compiled on
    the GPU; any other backend raises instead of interpreting."""
    monkeypatch.setattr(pk.jax, "default_backend", lambda: backend)
    if expect is None:
        with pytest.raises(RuntimeError, match="no kernel for backend"):
            pk._interpret()
    else:
        assert pk._interpret() is expect


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 17, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_block_spmm_compiled_on_gpu(gpu, k, dtype):
    """The Triton-compiled kernel (never the interpreter) against the XLA
    scan on the card, B=128 as in the committed N=1M solve."""
    assert pk._interpret() is False
    rng = np.random.default_rng(k)
    rows, cols, tiles, A, nb, B = _system(rng, nb=12, B=128, n_pairs=40,
                                          empty_row=5)
    dt = jnp.dtype(dtype)
    t = jnp.asarray(tiles, dt)
    X = jnp.asarray(rng.standard_normal((nb * B, k)), jnp.float32)
    got = pk.row_block_spmm(pk.row_offsets(rows, nb), cols, t, X, nb, B)
    ref = _scan_ref(rows, cols, t, X, nb, B, dt)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_row_block_spmm_compiled_b256(gpu):
    """B=256 tiles (a supported gp2Scale block size) compile in 128-wide
    sub-blocks inside the card's shared memory."""
    rng = np.random.default_rng(9)
    rows, cols, tiles, A, nb, B = _system(rng, nb=4, B=256, n_pairs=8,
                                          empty_row=1)
    for dt in (jnp.float32, jnp.bfloat16):
        t = jnp.asarray(tiles, dt)
        X = jnp.asarray(rng.standard_normal((nb * B, 40)), jnp.float32)
        got = pk.row_block_spmm(pk.row_offsets(rows, nb), cols, t, X, nb, B)
        ref = _scan_ref(rows, cols, t, X, nb, B, dt)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_spmv_scan_n50k_posterior_shape_on_gpu(gpu):
    """The scan at the N=50k posterior-variance shape (nb=391, B=128,
    11,264 tiles in 1024-tile slices, 512 f32 columns) compiles and runs on
    the card and matches the flat ``_spmv``.  With a sorted-scatter promise
    this shape compiled for minutes and then failed to launch."""
    from fvgp_tpu.ops.sparse_lml import _spmv
    nb, B, c, T = 391, 128, 512, 11264
    rng = np.random.default_rng(11)
    rows = np.sort(rng.integers(0, nb, T)).astype(np.int32)
    cols = rng.integers(0, nb, T).astype(np.int32)
    tiles = jax.random.normal(jax.random.PRNGKey(0), (T, B, B), jnp.float32)
    X = jax.random.normal(jax.random.PRNGKey(1), (nb * B, c), jnp.float32)
    with jax.default_matmul_precision("highest"):
        got = jax.jit(_spmv_scan, static_argnames=("nb", "B"))(
            jnp.asarray(rows), jnp.asarray(cols), tiles, X, nb=nb, B=B)
        ref = jax.jit(_spmv, static_argnames=("nb", "B"))(
            jnp.asarray(rows), jnp.asarray(cols), tiles, X, nb=nb, B=B)
    scale = float(jnp.max(jnp.abs(ref)))
    assert float(jnp.max(jnp.abs(got - ref))) <= 1e-5 * scale


@pytest.mark.slow
def test_fused_committed_solver_matches_scan_bf16(monkeypatch):
    """A bf16 posterior solve engages the kernel path on CPU (interpret
    kernel); its posteriors match the same solve through the tile scan
    (same bf16 tiles, same CG tolerance), reached here by declaring the
    block size unsupported."""
    import warnings

    from fvgp_tpu import GP

    rng = np.random.default_rng(7)
    x = rng.uniform(0, 16, (1200, 3))
    y = np.sin(x[:, 0]) + 0.03 * rng.standard_normal(1200)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    xp = rng.uniform(0, 16, (30, 3))
    out = {}
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(pk, "supports", lambda B: False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp = GP(x, y, init_hyperparameters=hps,
                    noise_variances=np.full(1200, 1e-2),
                    gp2Scale=True, linalg_mode="sparseCGpre",
                    args={"gp2Scale_block_size": 64, "dtype": "float32",
                          "gp2Scale_posterior_solver_dtype": "bfloat16",
                          "gp2Scale_posterior_budget": int(1.6e7)})
        pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
        pm = gp.posterior_mean(xp)["m(x)"]
        ctx = gp.kv._fast_solver_ctx
        nb = int(ctx["xb"].shape[0])
        assert (ctx["rows"].shape == (nb + 1,)) is fused
        out[fused] = (pm, pv)
    np.testing.assert_allclose(out[True][0], out[False][0], atol=1e-3)
    np.testing.assert_allclose(out[True][1], out[False][1], atol=1e-3)
