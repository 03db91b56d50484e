"""Smoke run of the exact-GP main path on the GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the mesh phase only

One process drives the card(s); the only children are ``nvidia-smi`` and the
GPU-marked tests, which run before this process first touches the card.
Phases (one card):

* device    — JAX's devices, and the card's name and power limit from
              ``nvidia-smi``; fails unless the platform is ``gpu``.
* gputests  — ``pytest -m gpu``: the tests that need a card.
* kernel    — the committed-solve SpMM kernel (``row_block_spmm``, compiled
              by Triton) against the XLA ``_spmv_scan`` at the N=1M widths;
              ``_spmv`` timed at the N=50k and N=1M training shapes.
* dense     — ``GP(linalg_mode="Chol")`` at N=10,000: f32 against f64, at
              the default matmul precision and at "highest".
* accuracy  — the gp2Scale posterior and LML at N=50,000 against a dense
              f64 Cholesky oracle built on the card.
* scale     — the gp2Scale N=1M configuration: construction, LML+gradient,
              adam training, posteriors.

Every phase raises on failure; the process then exits non-zero and prints
no result.  The last line of a passing run is one JSON object naming the
device.  Times are host-clock seconds around work that ends in
``block_until_ready`` (or in a host copy of the result).
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
def log(msg):
    print(msg, flush=True)


def _median_time(fn, n=10):
    """Median seconds per call over ``n`` calls after one warm-up call."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _nvidia_smi():
    """The card's name and power limit, read by a child that stays off
    JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def device_phase(n_cards):
    import jax
    devs = jax.devices()
    log(f"jax devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's platform is {devs[0].platform!r}")
    if len(devs) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    from fvgp_tpu.ops import pallas_kernels
    assert pallas_kernels._interpret() is False
    log("kernels compiled for the card (interpret mode off)")


def gputests_phase():
    """The GPU-marked tests, in a child process that runs before this one
    initialises JAX (so one process uses the card at a time)."""
    env = dict(os.environ, FVGP_TEST_GPU="1")
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                        "-p", "no:cacheprovider", "tests"],
                       cwd=HERE, env=env, capture_output=True, text=True,
                       timeout=900)
    tail = "\n".join(r.stdout.strip().splitlines()[-5:])
    log(f"gpu tests (pytest -m gpu): rc={r.returncode}\n{tail}")
    if r.returncode != 0:
        log(r.stderr[-4000:])
        raise SystemExit("GPU-marked tests failed")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def banded_schedule(nb, per_row, seed, empty_row=True, bucket=4096):
    """A row-sorted block schedule like the N=1M committed solve's: about
    ``per_row`` tiles per row block, columns near the diagonal (Morton
    locality), one empty row, sentinel padding (row == col == nb) up to a
    multiple of ``bucket``.  Returns (rows, cols, n_real)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(per_row // 2, per_row * 3 // 2 + 1, nb)
    if empty_row:
        counts[nb // 2] = 0
    rows = np.repeat(np.arange(nb, dtype=np.int64), counts)
    w = max(per_row, 2)
    cols = np.clip(rows + rng.integers(-w, w + 1, len(rows)), 0, nb - 1)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    T = len(rows)
    T_pad = -(-T // bucket) * bucket
    rows_p = np.full(T_pad, nb, np.int32)
    cols_p = np.full(T_pad, nb, np.int32)
    rows_p[:T], cols_p[:T] = rows, cols
    return rows_p, cols_p, T


def kernel_phase(nb=7813, B=128, per_row=28, ks=(1, 17, 128, 512),
                 n_time=10, train_shapes=((4096, 196, 256), (None, 7813, 128)),
                 tol=1e-5):
    """The committed-solve SpMM against ``_spmv_scan`` under "highest"
    precision.  Error: max over outputs of |Y - Y_ref| / (|A| |X|), the
    elementwise scale of an f32-accumulated sum of products — both sides
    read the same tile and X values (X cast to the tile dtype) and
    accumulate in f32, so they differ only by summation order (tolerance
    1e-5, about 100 f32 ulps).  Returns {(dtype, k): (err, t_kernel,
    t_scan)}."""
    import jax
    import jax.numpy as jnp

    from fvgp_tpu.ops.pallas_kernels import row_block_spmm, row_offsets
    from fvgp_tpu.ops.sparse_lml import _spmv, _spmv_scan

    rows_p, cols_p, T = banded_schedule(nb, per_row, seed=0)
    T_pad = len(rows_p)
    log(f"kernel phase: nb={nb} B={B} tiles={T} (padded {T_pad}) "
        f"n_pad={nb * B}")
    rowptr = jnp.asarray(row_offsets(rows_p, nb))
    cols = jnp.asarray(cols_p)
    rows_c = jnp.minimum(jnp.asarray(rows_p), nb - 1)
    cols_c = jnp.minimum(cols, nb - 1)

    @jax.jit
    def make_tiles(key, dtype_probe):
        t = jax.random.normal(key, (T_pad, B, B), jnp.float32)
        live = (jnp.arange(T_pad) < T)[:, None, None]
        return jnp.where(live, t, 0.0).astype(dtype_probe.dtype)

    kern = jax.jit(row_block_spmm, static_argnames=("nb", "B"))
    scan = jax.jit(_spmv_scan, static_argnames=("nb", "B", "mv_dtype"))

    results = {}
    for dt in (jnp.bfloat16, jnp.float32):
        tiles = make_tiles(jax.random.PRNGKey(1), jnp.zeros((), dt))
        for k in ks:
            X = jax.random.normal(jax.random.PRNGKey(k), (nb * B, k),
                                  jnp.float32)
            got = kern(rowptr, cols, tiles, X, nb=nb, B=B)
            with jax.default_matmul_precision("highest"):
                ref = scan(rows_c, cols_c, tiles, X, nb=nb, B=B, mv_dtype=dt)
                den = scan(rows_c, cols_c, jnp.abs(tiles),
                           jnp.abs(X.astype(dt)).astype(jnp.float32),
                           nb=nb, B=B, mv_dtype=dt)
            assert got.shape == ref.shape == (nb * B, k)
            err = float(jnp.max(jnp.where(den > 0, jnp.abs(got - ref)
                                          / jnp.where(den > 0, den, 1.0),
                                          jnp.abs(got - ref))))
            t_k = _median_time(lambda: kern(rowptr, cols, tiles, X,
                                            nb=nb, B=B), n_time)
            t_s = _median_time(lambda: scan(rows_c, cols_c, tiles, X, nb=nb,
                                            B=B, mv_dtype=dt), n_time)
            name = jnp.dtype(dt).name
            log(f"kernel {name} tiles k={k}: max |Y-Y_ref|/(|A||X|) = "
                f"{err:.3e} (tol {tol:g}); median row_block_spmm "
                f"{t_k * 1e3:.3f} ms, _spmv_scan {t_s * 1e3:.3f} ms "
                f"({t_s / t_k:.2f}x)")
            assert np.isfinite(err) and err <= tol, (name, k, err)
            results[(name, k)] = (err, t_k, t_s)
            del got, ref, den, X
        del tiles
        gc.collect()

    # the training-path SpMM (_spmv: gather -> einsum -> segment_sum), bf16
    # tiles, k=17 (16 probes + the solve column)
    for T_req, nb_t, B_t in train_shapes:
        if T_req is None:
            r_p, c_p, _ = banded_schedule(nb_t, per_row, seed=3)
        else:
            # the N=50k training schedule: T_req tiles, sentinels on top
            r_p, c_p, _ = banded_schedule(nb_t, max(T_req // nb_t, 1),
                                          seed=3, bucket=T_req)
            r_p, c_p = r_p[:T_req], c_p[:T_req]
        Tt = len(r_p)
        tl = jax.random.normal(jax.random.PRNGKey(5), (Tt, B_t, B_t),
                               jnp.float32).astype(jnp.bfloat16)
        X = jax.random.normal(jax.random.PRNGKey(6), (nb_t * B_t, 17),
                              jnp.float32)
        rr = jnp.minimum(jnp.asarray(r_p), nb_t - 1)
        cc = jnp.minimum(jnp.asarray(c_p), nb_t - 1)
        sp = jax.jit(_spmv, static_argnames=("nb", "B", "mv_dtype"))
        t = _median_time(lambda: sp(rr, cc, tl, X, nb=nb_t, B=B_t,
                                    mv_dtype=jnp.bfloat16), n_time)
        log(f"_spmv (training SpMM) T={Tt} B={B_t} nb={nb_t} k=17 bf16: "
            f"median {t * 1e3:.3f} ms")
        results[("spmv", Tt, B_t)] = t
        del tl, X
        gc.collect()
    return results


# ---------------------------------------------------------------------------
# dense phase
# ---------------------------------------------------------------------------

DENSE_TOL = {"lml": 5e-5, "grad": 5e-5, "mean": 5e-4, "var": 5e-5}


def dense_phase(N=10_000, n_pred=500, n_evals=5, tol=DENSE_TOL):
    """Dense Cholesky GP (bench.py's dense workload) in f32 against the same
    GP in f64, at the default matmul precision and at "highest".
    Tolerances (f32 against f64, both on the card; data and prior variance
    are O(1)): relative LML 5e-5, relative gradient norm 5e-5, max posterior
    mean error 5e-4, max posterior variance error 5e-5.  An f32 Cholesky of
    this system (noise 1e-2, 1e4 points) keeps about 5e-6 of the LML and
    gradient, 7e-5 of the mean and 3e-6 of the variance when every product
    is full f32; each limit sits about 10x above that.  The variance limit
    also sits below the ~5e-4 a TF32 product gives (the variance is a
    difference of two O(1) terms), so it fails if the variance product
    loses its pinned precision."""
    import contextlib
    import warnings

    import jax

    from fvgp_tpu import GP

    D = 3
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 10.0, (N, D))
    y = np.sin(x[:, 0]) + 0.25 * x[:, 1] + 0.05 * rng.standard_normal(N)
    noise = np.full(N, 1e-2)
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    xp = rng.uniform(0.0, 10.0, (n_pred, D))
    bounds = np.array([[0.1, 10.0]] + [[0.3, 5.0]] * D)

    def run(dtype):
        args = {"dtype": dtype} if dtype else {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp = GP(x, y, init_hyperparameters=hps, noise_variances=noise,
                    linalg_mode="Chol", args=args)
        ml = gp.marginal_likelihood
        t0 = time.perf_counter()
        val, grad = ml.log_likelihood_value_and_gradient(hps)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(n_evals):
            ml.log_likelihood_value_and_gradient(hps * (1.0 + 1e-4 * (i + 1)))
        t_eval = (time.perf_counter() - t0) / n_evals
        pm = gp.posterior_mean(xp)["m(x)"]
        pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
        t0 = time.perf_counter()
        gp.posterior_mean(xp * (1 + 1e-9))
        gp.posterior_covariance(xp * (1 + 1e-9), variance_only=True)
        t_post = time.perf_counter() - t0
        lml0 = val
        t0 = time.perf_counter()
        gp.train(method="local", max_iter=5, hyperparameter_bounds=bounds)
        t_train = time.perf_counter() - t0
        lml1 = gp.log_likelihood(gp.hyperparameters)
        assert np.isfinite(lml1) and lml1 >= lml0 - 1e-6 * abs(lml0), \
            ("local training lowered the LML", lml0, lml1)
        log(f"  dense {dtype or 'float32'}: first LML+grad {t_first:.2f}s, "
            f"warm {t_eval * 1e3:.1f} ms/eval, posterior mean+var(500) "
            f"warm {t_post * 1e3:.1f} ms, train(local, 5) {t_train:.2f}s "
            f"(LML {lml0:.3f} -> {lml1:.3f})")
        return val, grad, pm, pv

    out = {}
    for prec in ("default", "highest"):
        with (contextlib.nullcontext() if prec == "default"
              else jax.default_matmul_precision("highest")):
            log(f"dense phase N={N}, matmul precision {prec}:")
            v32, g32, m32, s32 = run(None)
            v64, g64, m64, s64 = run("float64")
        errs = {"lml": abs(v32 - v64) / abs(v64),
                "grad": float(np.linalg.norm(g32 - g64)
                              / np.linalg.norm(g64)),
                "mean": float(np.max(np.abs(m32 - m64))),
                "var": float(np.max(np.abs(s32 - s64)))}
        log(f"  f32 vs f64 ({prec}): rel LML {errs['lml']:.3e}, rel grad "
            f"{errs['grad']:.3e}, max mean err {errs['mean']:.3e}, max var "
            f"err {errs['var']:.3e} (tol {tol})")
        out[prec] = errs
    for prec, errs in out.items():
        for key, e in errs.items():
            assert np.isfinite(e) and e <= tol[key], (prec, key, e)
    return out


# ---------------------------------------------------------------------------
# accuracy at scale
# ---------------------------------------------------------------------------

def _sparse_data(N, seed, hps_ls):
    """bench.py's gp2Scale data: ~40 support neighbours per point."""
    rng = np.random.default_rng(seed)
    span = (N * 4.19 * hps_ls ** 3 / 40.0) ** (1.0 / 3.0)
    x = rng.uniform(0, span, (N, 3))
    y = np.sin(0.2 * x[:, 0] / hps_ls) + 0.05 * rng.standard_normal(N)
    return rng, span, x, y


def accuracy_phase(N=50_000, n_pred=500, block=128, mv_tol=2e-3,
                   lml_rel=1e-4, lml_sigmas=4.0, oracle_rows=1000):
    """gp2Scale posteriors (committed solver, fused kernel, f32 tiles) and
    the sparse LML against a dense f64 Cholesky oracle on the card.

    Tolerances: posterior mean and variance, max abs error 2e-3 — the
    committed CG stops at relative preconditioned residual 1e-4, and the
    block-Jacobi-preconditioned system's conditioning (noise 1e-2, ~40
    neighbours) carries that to about 1e-3 in outputs of scale 1; the LML
    within 4 standard deviations of its SLQ probe noise plus 1e-4 relative
    (the f32 quadratic term)."""
    import jax
    import jax.numpy as jnp

    from fvgp_tpu import GP
    from fvgp_tpu.kernels import wendland_anisotropic

    hps = np.array([1.0, 1.0, 1.0, 1.0])
    rng, span, x, y = _sparse_data(N, seed=11, hps_ls=1.0)
    xp = rng.uniform(0, span, (n_pred, 3))
    noise = 1e-2
    t0 = time.perf_counter()
    gp = GP(x, y, init_hyperparameters=hps, noise_variances=np.full(N, noise),
            gp2Scale=True, args={"gp2Scale_block_size": block})
    pm = gp.posterior_mean(xp)["m(x)"]
    pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    t_post = time.perf_counter() - t0
    ctx = gp.kv._fast_sparse_solver()
    fused = ctx is not None and ctx["rows"].shape != ctx["cols"].shape
    lml = gp.marginal_likelihood.log_likelihood(hps)
    lml_var = gp.marginal_likelihood.log_likelihood_variance() or 0.0
    del gp, ctx
    gc.collect()

    @jax.jit
    def oracle(xd, yd, xq):
        h = jnp.asarray(hps, jnp.float64)
        n = xd.shape[0]
        col = jnp.arange(n)

        def row_block(i):
            # (oracle_rows, n) rows of K + noise·I; no n×n temporaries
            r = jax.lax.dynamic_slice_in_dim(xd, i * oracle_rows,
                                             oracle_rows)
            diag = col[None, :] == (i * oracle_rows
                                    + jnp.arange(oracle_rows))[:, None]
            return wendland_anisotropic(r, xd, h) + noise * diag

        K = jax.lax.map(row_block, jnp.arange(n // oracle_rows))
        L = jnp.linalg.cholesky(K.reshape(n, n))
        m = jnp.mean(yd)
        alpha = jax.scipy.linalg.cho_solve((L, True), yd - m)
        ks = wendland_anisotropic(xd, xq, h)
        mean = m + ks.T @ alpha
        v = jax.scipy.linalg.solve_triangular(L, ks, lower=True)
        kk = jnp.diagonal(wendland_anisotropic(xq, xq, h))
        var = kk - jnp.sum(v * v, axis=0)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
        lml = -0.5 * (jnp.dot(yd - m, alpha) + logdet
                      + n * jnp.log(2.0 * jnp.pi))
        return mean, var, lml

    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        om, ov, ol = oracle(jnp.asarray(x, jnp.float64),
                            jnp.asarray(y, jnp.float64),
                            jnp.asarray(xp, jnp.float64))
    om, ov, ol = np.asarray(om), np.asarray(ov), float(ol)
    t_oracle = time.perf_counter() - t0
    e_m = float(np.max(np.abs(pm - om)))
    e_v = float(np.max(np.abs(pv - ov)))
    lml_tol = lml_sigmas * np.sqrt(lml_var) + lml_rel * abs(ol)
    log(f"accuracy N={N}: gp2Scale posterior (fused kernel: {fused}) "
        f"{t_post:.1f}s incl. setup, f64 oracle {t_oracle:.1f}s; max mean "
        f"err {e_m:.3e}, max var err {e_v:.3e} (tol {mv_tol:g}); LML "
        f"{lml:.3f} vs oracle {ol:.3f}: |diff| {abs(lml - ol):.3f} "
        f"(tol {lml_tol:.3f} = {lml_sigmas:g} sd of the SLQ noise + "
        f"{lml_rel:g} rel)")
    assert e_m <= mv_tol and e_v <= mv_tol, (e_m, e_v)
    assert abs(lml - ol) <= lml_tol, (lml, ol, lml_tol)
    return {"mean": e_m, "var": e_v, "lml": abs(lml - ol), "fused": fused}


# ---------------------------------------------------------------------------
# N=1M gp2Scale configuration
# ---------------------------------------------------------------------------

SCALE_ARGS = {"gp2Scale_block_size": 128,
              "gp2Scale_solver_dtype": "bfloat16",
              "gp2Scale_storage_dtype": "bfloat16",
              "sparse_cg_maxiter": 32,
              "random_logdet_fixed_probes": 16}


def _timed(label, fn):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    log(f"  {label}: {dt:.2f}s")
    return out, dt


def scale_phase(N=1_000_000, n_pred=500, n_evals=3):
    """bench.py's large-N configuration through the public API; every
    result must be finite."""
    from fvgp_tpu import GP
    from fvgp_tpu.utils import logging as fvlog

    fvlog.enable()
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    rng, span, x, y = _sparse_data(N, seed=1, hps_ls=2.0)
    xp = rng.uniform(0, span, (n_pred, 3))
    log(f"scale phase: N={N}, args {SCALE_ARGS}")
    gp, _ = _timed("GP construction", lambda: GP(
        x, y, init_hyperparameters=hps, noise_variances=np.full(N, 1e-2),
        gp2Scale=True, args=dict(SCALE_ARGS)))
    ml = gp.marginal_likelihood
    (v, g), _ = _timed("first LML+grad (structure + compile)",
                       lambda: ml.log_likelihood_value_and_gradient(hps))
    assert np.isfinite(v) and np.all(np.isfinite(g)), (v, g)
    warm = []
    for i in range(n_evals):
        (v, g), dt = _timed(f"LML+grad {i + 1} (warm)",
                            lambda: ml.log_likelihood_value_and_gradient(
                                hps * (1.0 + 1e-4 * (i + 1))))
        assert np.isfinite(v) and np.all(np.isfinite(g)), (v, g)
        warm.append(dt)
    log(f"  LML {v:.3f}, |grad| {np.linalg.norm(g):.3e}")
    bounds = np.array([[0.5, 2.0], [1.9, 2.1], [1.9, 2.1], [1.9, 2.1]])
    _timed("train(method='adam', max_iter=3)",
           lambda: gp.train(method="adam", max_iter=3,
                            hyperparameter_bounds=bounds))
    assert np.all(np.isfinite(gp.hyperparameters)), gp.hyperparameters
    log(f"  trained hyperparameters {gp.hyperparameters}")
    pm, _ = _timed("posterior_mean(500) (setup + compile)",
                   lambda: gp.posterior_mean(xp)["m(x)"])
    pm, t_m = _timed("posterior_mean(500) (warm)",
                     lambda: gp.posterior_mean(xp * (1 + 1e-6))["m(x)"])
    pv, _ = _timed("posterior_covariance(500, variance_only) (compile)",
                   lambda: gp.posterior_covariance(
                       xp, variance_only=True)["v(x)"])
    pv, t_v = _timed("posterior_covariance(500, variance_only) (warm)",
                     lambda: gp.posterior_covariance(
                         xp * (1 + 1e-6), variance_only=True)["v(x)"])
    assert np.all(np.isfinite(pm)) and np.all(np.isfinite(pv))
    assert np.all(pv > -1e-3), float(np.min(pv))
    ctx = gp.kv._fast_sparse_solver()
    fused = ctx is not None and ctx["rows"].shape != ctx["cols"].shape
    log(f"  committed solver: fused kernel {fused}, "
        f"{gp.kv.last_solve_info}")
    res = {"warm_eval": warm, "mean": t_m, "var": t_v, "fused": fused}
    del gp
    gc.collect()
    return res


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _bytes_in_use(device):
    return device.memory_stats()["bytes_in_use"]


def four_phase(N=1_000_000, n_pred=500, n_cards=4, tol_lml=1e-4,
               tol_grad=1e-2, tol_post=5e-3):
    """The N=1M configuration on a 4-card mesh against the meshless GP on
    card 0, in one process.  Tolerances: the two runs differ only in
    summation order of f32 accumulators over bf16 tiles, which moves the
    early-exit CG trajectories — relative LML 1e-4, relative gradient 1e-2
    (the bf16 training tolerance), posterior mean and variance 5e-3 of
    their max (the bf16 posterior CG stops at relative residual 1e-3)."""
    import jax

    from fvgp_tpu import GP
    from fvgp_tpu.parallel import mesh as pmesh

    hps = np.array([1.0, 2.0, 2.0, 2.0])
    rng, span, x, y = _sparse_data(N, seed=1, hps_ls=2.0)
    xp = rng.uniform(0, span, (n_pred, 3))
    noise = np.full(N, 1e-2)

    def build():
        return GP(x, y, init_hyperparameters=hps, noise_variances=noise,
                  gp2Scale=True, args=dict(SCALE_ARGS))

    def run(gp, label):
        t0 = time.perf_counter()
        v, g = gp.marginal_likelihood.log_likelihood_value_and_gradient(hps)
        pm = gp.posterior_mean(xp)["m(x)"]
        pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
        log(f"  {label}: LML {v:.3f}, LML+grad and posteriors "
            f"{time.perf_counter() - t0:.1f}s incl. setup")
        assert np.isfinite(v) and np.all(np.isfinite(g))
        assert np.all(np.isfinite(pm)) and np.all(np.isfinite(pv))
        return v, g, pm, pv

    devs = jax.devices()[:n_cards]
    log(f"four-card phase: N={N} on {devs}")
    gp1 = build()
    v1, g1, pm1, pv1 = run(gp1, "meshless, card 0")
    del gp1
    gc.collect()
    used0 = [_bytes_in_use(d) for d in devs]
    mesh = pmesh.make_mesh(n_cards)
    assert mesh.axis_names == ("tiles",), mesh.axis_names
    with pmesh.use_mesh(mesh):
        gp = build()
        v, g, pm, pv = run(gp, f"mesh {dict(mesh.shape)}")
        ctx = gp.kv._fast_sparse_solver()
        assert ctx is not None and ctx["tiles"] is not None
        n_dev = len(ctx["tiles"].sharding.device_set)
        used1 = [_bytes_in_use(d) for d in devs]
        entry = next(iter(gp.marginal_likelihood._sparse_cache.values()))
        train_halo = entry["partition_cache"][1][-1] is not None
        post_halo = bool(ctx["halo_args"])
    assert n_dev == n_cards, f"committed tiles on {n_dev} devices"
    grew = [b - a for a, b in zip(used0, used1)]
    log(f"  committed tiles on {n_dev} devices; bytes_in_use grew by "
        f"{grew} per card")
    assert all(d > 0 for d in grew), grew
    log(f"  collective: training step "
        f"{'halo exchange' if train_halo else 'all-gather'}, posterior "
        f"solve {'halo exchange' if post_halo else 'all-gather'}")
    e_l = abs(v - v1) / abs(v1)
    e_g = float(np.linalg.norm(g - g1) / np.linalg.norm(g1))
    e_m = float(np.max(np.abs(pm - pm1)) / np.max(np.abs(pm1)))
    e_v = float(np.max(np.abs(pv - pv1)) / np.max(np.abs(pv1)))
    log(f"  mesh vs meshless: rel LML {e_l:.3e} (tol {tol_lml:g}), rel grad "
        f"{e_g:.3e} (tol {tol_grad:g}), mean {e_m:.3e}, var {e_v:.3e} "
        f"(tol {tol_post:g} of max)")
    assert e_l <= tol_lml and e_g <= tol_grad, (e_l, e_g)
    assert e_m <= tol_post and e_v <= tol_post, (e_m, e_v)
    return {"lml": e_l, "grad": e_g, "mean": e_m, "var": e_v}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase")
    a = ap.parse_args(argv)
    n_cards = 4 if a.four else 1
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    smi = _nvidia_smi()             # fails where there is no NVIDIA card
    if not a.four:
        gputests_phase()
    device_phase(n_cards)
    if a.four:
        four_phase(n_cards=n_cards)
    else:
        for name, phase in (("kernel", kernel_phase), ("dense", dense_phase),
                            ("accuracy", accuracy_phase),
                            ("scale", scale_phase)):
            t0 = time.perf_counter()
            phase()
            log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    import jax
    d = jax.devices()[0]
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
