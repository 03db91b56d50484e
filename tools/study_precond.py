"""Round-5 preconditioner TYPE study on the committed posterior solver
(round-4 verdict, next #8): block-Jacobi vs the two-level Galerkin
correction at the bench scales, on the real chip.

The training step is OUT of scope by structure: the fused mBCG quadrature
needs probes L_M·u and an exact log|M|, both of which require a
block-diagonal M (ops/sparse_lml.make_committed_solver docstring), so the
only preconditioner family available there is the width-grouped
block-Jacobi the round-4 width study already measured (STATUS.md).

Usage:  python tools/study_precond.py            # real backend
        BENCH_N=200000 python tools/study_precond.py
Writes a markdown table to stdout; phases log to stderr.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(f"[study] {msg}", file=sys.stderr, flush=True)


def main():
    import jax

    backend = jax.default_backend()
    on_accel = backend not in ("cpu",)
    N = int(os.environ.get("BENCH_N", 1_000_000 if on_accel else 20_000))
    n_pred = int(os.environ.get("STUDY_NPRED", 500))
    log(f"backend={backend} N={N} n_pred={n_pred}")

    from fvgp_tpu import GP

    rng = np.random.default_rng(1)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    span = (N * 4.19 * 2.0 ** 3 / 40.0) ** (1.0 / 3.0)
    x = rng.uniform(0, span, (N, 3))
    y = np.sin(0.2 * x[:, 0]) + 0.05 * rng.standard_normal(N)
    xp = rng.uniform(0, span, (n_pred, 3))

    base_args = {"gp2Scale_block_size": 128,
                 "gp2Scale_solver_dtype": "bfloat16",
                 "gp2Scale_storage_dtype": "bfloat16",
                 "sparse_cg_maxiter": 32,
                 "random_logdet_fixed_probes": 16}
    if not on_accel:
        base_args = {"gp2Scale_block_size": 128}

    rows = []
    configs = [("block_jacobi", None), ("two_level", None),
               ("two_level", 8)]
    gp = GP(x, y, init_hyperparameters=hps,
            noise_variances=np.full(N, 1e-2), gp2Scale=True,
            linalg_mode="sparseCGpre", args=dict(base_args))
    for ptype, cwidth in configs:
        a = dict(base_args, gp2Scale_posterior_precond=ptype)
        if cwidth is not None:
            a["gp2Scale_posterior_coarse_width"] = cwidth
        gp.set_args(a)
        gp.kv._fast_solver_ctx = None       # force a rebuild under new args
        t0 = time.time()
        gp.posterior_covariance(xp[:4], variance_only=True)
        t_setup = time.time() - t0
        t0 = time.time()
        v = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
        t_cold = time.time() - t0
        t0 = time.time()
        v = gp.posterior_covariance(xp * (1 + 1e-6),
                                    variance_only=True)["v(x)"]
        t_warm = time.time() - t0
        info = gp.kv.last_solve_info or {}
        its = info.get("iterations")
        if isinstance(its, list):
            its = [int(np.asarray(i)) for i in its]
        elif its is not None:
            its = int(np.asarray(its))
        ok = bool(np.all(np.isfinite(v)))
        rows.append((ptype, cwidth, t_setup, t_cold, t_warm, its, ok, v))
        log(f"{ptype} cw={cwidth}: setup {t_setup:.1f}s, "
            f"variance({n_pred}) cold {t_cold:.1f}s warm {t_warm:.2f}s, "
            f"iters {its}, finite={ok}")

    ref = rows[0][7]
    print(f"\n## committed-solver preconditioner study "
          f"(N={N}, variance({n_pred}), {backend})\n")
    print("| type | coarse_width | setup s | cold s | warm s | "
          "PCG iters/chunk | max |dv| vs block-Jacobi |")
    print("|---|---|---|---|---|---|---|")
    for ptype, cwidth, t_setup, t_cold, t_warm, its, ok, v in rows:
        dv = float(np.max(np.abs(np.asarray(v) - np.asarray(ref))))
        print(f"| {ptype} | {cwidth or 'auto'} | {t_setup:.1f} | "
              f"{t_cold:.1f} | {t_warm:.2f} | {its} | {dv:.2e} |")


if __name__ == "__main__":
    main()
