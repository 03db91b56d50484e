"""Stochastic Lanczos quadrature log-determinant.

Device-native replacement for the `imate` C++/CUDA SLQ backend the reference
hard-requires for gp2Scale (/root/reference/fvgp/gp_lin_alg.py:1083-1181).

Estimator: logdet(A) = tr(log A) = E_z[ zᵀ log(A) z ] for Rademacher z.
Each probe runs an m-step Lanczos recursion (a `lax.scan` of matvecs with
full reorthogonalization — m is tiny, ~20, so the reorth GEMMs are cheap on
matmul units), then quadrature through `eigh` of the m×m tridiagonal.  Probes are
vmapped, so one kernel launch carries a whole probe batch.

The estimator's own variance is reported exactly as the reference surfaces
imate's `info` (gp_lin_alg.py:1159-1180): it is the observation noise that
`train(method='bo')` feeds into its surrogate.
"""

import functools

import jax
import jax.numpy as jnp

__all__ = ["slq_logdet", "lanczos_tridiag"]


def _as_fn(matvec, operator):
    """Reduce closure / (stable fn, operator-data) conventions to
    fn(data, v) — see ops.krylov for why closures retrace."""
    if operator is None:
        from .krylov import _ClosureShim
        return _ClosureShim.get(matvec), None
    return matvec, operator


@functools.partial(jax.jit, static_argnames=("matvec_fn", "degree"))
def _lanczos_impl(matvec_fn, data, v0, degree):
    n = v0.shape[0]
    dtype = v0.dtype
    v = v0 / jnp.linalg.norm(v0)
    V = jnp.zeros((degree, n), dtype).at[0].set(v)

    def step(carry, i):
        V, v_prev, v, beta_prev = carry
        w = matvec_fn(data, v[:, None])[:, 0]
        alpha = jnp.dot(w, v)
        w = w - alpha * v - beta_prev * v_prev
        # full reorthogonalization against all previous basis vectors
        w = w - V.T @ (V @ w)
        beta = jnp.linalg.norm(w)
        v_next = jnp.where(beta > 0, w / jnp.where(beta == 0, 1.0, beta), w)
        V = jax.lax.cond(i + 1 < degree,
                         lambda V: V.at[i + 1].set(v_next),
                         lambda V: V, V)
        return (V, v, v_next, beta), (alpha, beta)

    (_, _, _, _), (alphas, betas) = jax.lax.scan(
        step, (V, jnp.zeros_like(v), v, jnp.zeros((), dtype)),
        jnp.arange(degree))
    return alphas, betas[:-1]


def lanczos_tridiag(matvec, v0, degree, operator=None):
    """m-step Lanczos with full reorthogonalization.

    Parameters
    ----------
    matvec : (n, 1)-block matvec — a closure, or stable fn(data, X) with
        ``operator`` (see ops.krylov for the convention)
    v0 : (n,) start vector (need not be normalized)
    degree : number of Lanczos steps m

    Returns
    -------
    alphas (m,), betas (m-1,) of the tridiagonal T.
    """
    fn, data = _as_fn(matvec, operator)
    return _lanczos_impl(fn, data, v0, int(degree))


def _probe_quadrature(matvec_fn, data, z, degree):
    """zᵀ log(A) z estimate for one Rademacher probe z."""
    n = z.shape[0]
    alphas, betas = _lanczos_impl(matvec_fn, data, z, degree)
    T = (jnp.diag(alphas)
         + jnp.diag(betas, 1)
         + jnp.diag(betas, -1))
    theta, U = jnp.linalg.eigh(T)
    theta = jnp.maximum(theta, jnp.finfo(z.dtype).tiny)
    tau = U[0, :] ** 2
    # ||z||² = n for Rademacher probes
    return n * jnp.sum(tau * jnp.log(theta))


@functools.partial(jax.jit,
                   static_argnames=("matvec_fn", "n", "degree", "num", "dtype"))
def _probe_batch(matvec_fn, data, key, n, degree, num, dtype):
    z = jax.random.rademacher(key, (num, n), dtype=dtype)
    return jax.vmap(lambda zz: _probe_quadrature(matvec_fn, data, zz, degree))(z)


def slq_logdet(matvec, n, *, dtype=jnp.float64, degree=20, min_num_samples=10,
               max_num_samples=5000, error_rtol=0.01, batch=None, key=None,
               info_out=None, operator=None):
    """Stochastic Lanczos log-determinant with adaptive probe count.

    Mirrors the reference's imate contract (gp_lin_alg.py:1103-1181):
    draws at least ``min_num_samples`` Hutchinson probes, keeps drawing in
    batches until the relative standard error of the mean falls under
    ``error_rtol`` or ``max_num_samples`` is hit, and reports the achieved
    variance/sample count via ``info_out``.  ``matvec`` operates on (n, k)
    blocks; pass a stable fn + ``operator`` on hot paths (see ops.krylov).
    """
    import numpy as np
    if key is None:
        key = jax.random.PRNGKey(0)
    if batch is None:
        # wide batches: probes are vmapped, so one launch carries the whole
        # batch, and fewer adaptive rounds means fewer host syncs.  Capped
        # by memory: every vmapped probe carries a (degree, n) reorthogonal-
        # ization basis, so an uncapped batch = min_num_samples would scale
        # the footprint with the user's SAMPLE COUNT (e.g. 2000 probes at
        # n=1e5, degree=20, f64 → 32 GB); bound the basis to ~1 GB and let
        # the adaptive loop take more rounds instead
        per_probe = max(int(degree) * int(n) * jnp.dtype(dtype).itemsize, 1)
        batch = max(1, min(max(int(min_num_samples), 32),
                           256, (1 << 30) // per_probe))
    fn, data = _as_fn(matvec, operator)
    samples = []        # host accumulation: device-side stats on a growing
    total = 0           # shape would trigger a fresh compile every round
    while True:
        key, sub = jax.random.split(key)
        vals = _probe_batch(fn, data, sub, n, int(degree), int(batch), dtype)
        samples.append(np.asarray(vals))
        total += int(batch)
        all_vals = np.concatenate(samples)
        mean = float(np.mean(all_vals))
        var_mean = (float(np.var(all_vals, ddof=1)) / total if total > 1
                    else np.inf)
        err = float(np.sqrt(var_mean) / max(abs(mean), 1e-300))
        if (total >= min_num_samples and err <= error_rtol) or total >= max_num_samples:
            break
    result = mean
    if info_out is not None:
        info_out["logdet"] = result
        info_out["variance"] = float(var_mean)
        info_out["num_samples"] = total
        info_out["relative_error"] = err
        info_out["degree"] = int(degree)
    return result
