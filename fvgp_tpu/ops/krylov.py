"""Matrix-free Krylov solvers — CG / MINRES / block-CG as `lax.while_loop`
programs over an abstract matvec.

Device replacement for the reference's scipy.sparse.linalg cg/minres calls
(/root/reference/fvgp/gp_lin_alg.py:1184-1291) and its pure-Python block CG
(:1024-1080).

Two calling conventions:

* ``cg(matvec, b)`` with a plain closure — convenient, but the closure is a
  static jit argument: a NEW closure retraces and bakes its captured arrays
  in as compile-time constants.  Fine for one-off use and tests.
* ``cg(matvec_fn, b, operator=data)`` — ``matvec_fn`` is a STABLE function
  (module-level or lru-cached factory) called as ``matvec_fn(data, X)``;
  the operator data is a traced pytree argument.  This is the library's
  hot-path convention: one compile serves every K+V of the same shape.
  Same for the preconditioner: ``M``/``m_operator``.

All solvers are multi-RHS: they iterate on an (n, k) block and track
per-column convergence with masks, so k posterior solves cost one pipeline.
"""

import functools

import jax
import jax.numpy as jnp

__all__ = ["cg", "minres", "make_dense_matvec", "dense_matvec"]


def make_dense_matvec(A):
    """Closure convention (tests / one-off); prefer
    ``cg(dense_matvec, b, operator=A)`` on hot paths."""
    return lambda X: A @ X


def dense_matvec(A, X):
    """Stable matvec for the operator convention."""
    return A @ X


def _identity_m(data, X):
    return X


def _normalize(matvec, operator, M, m_operator):
    """Reduce both conventions to (stable_fn(data, X), data)."""
    if operator is None:
        fn = _ClosureShim.get(matvec)
        data = None
    else:
        fn, data = matvec, operator
    if M is None:
        m_fn, m_data = _identity_m, None
    elif m_operator is None:
        m_fn, m_data = _ClosureShim.get(M), None
    else:
        m_fn, m_data = M, m_operator
    return fn, data, m_fn, m_data


class _ClosureShim:
    """Wrap a plain closure as fn(data, X), cached per closure identity so
    repeated calls with the SAME closure reuse one compiled program.

    The wrapper holds the closure STRONGLY (it is baked into the jitted
    program), so the cache is a small bounded LRU: evicting the oldest
    entry only costs that closure a retrace if it comes back, while an
    unbounded map would pin every captured operator matrix for the
    process lifetime."""
    from collections import OrderedDict as _OD
    _cache = _OD()
    _limit = 64

    @classmethod
    def get(cls, closure):
        key = id(closure)
        hit = cls._cache.get(key)
        if hit is not None and hit[0] is closure:
            cls._cache.move_to_end(key)
            return hit[1]

        def fn(data, X, _c=closure):
            return _c(X)

        while len(cls._cache) >= cls._limit:
            cls._cache.popitem(last=False)
        cls._cache[key] = (closure, fn)
        return fn


@functools.partial(jax.jit, static_argnames=("matvec_fn", "m_fn", "maxiter"))
def _cg_impl(matvec_fn, m_fn, data, m_data, B, X0, tol, maxiter):
    """Preconditioned CG on a block of RHS columns with per-column masking."""
    bnorm = jnp.sqrt(jnp.sum(B * B, axis=0))
    # a zero RHS column has solution 0 exactly; a warm start there would
    # otherwise leave rnorm = |A x0| > atol ~ 0 forever and drag the whole
    # block to maxiter (scipy cg special-cases b = 0 the same way)
    X = jnp.where((bnorm == 0.0)[None, :], 0.0, X0)
    R = B - matvec_fn(data, X)
    Z = m_fn(m_data, R)
    P = Z
    rz = jnp.sum(R * Z, axis=0)                       # (k,)
    atol = tol * jnp.maximum(bnorm, 1e-300)

    def cond(state):
        i, X, R, Z, P, rz = state
        rnorm = jnp.sqrt(jnp.sum(R * R, axis=0))
        return jnp.logical_and(i < maxiter, jnp.any(rnorm > atol))

    def body(state):
        i, X, R, Z, P, rz = state
        active = jnp.sqrt(jnp.sum(R * R, axis=0)) > atol   # (k,)
        Ap = matvec_fn(data, P)
        pAp = jnp.sum(P * Ap, axis=0)
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        alpha = jnp.where(active, alpha, 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * Ap
        Z = m_fn(m_data, R)
        rz_new = jnp.sum(R * Z, axis=0)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        beta = jnp.where(active, beta, 0.0)
        P = Z + beta[None, :] * P
        return i + 1, X, R, Z, P, rz_new

    i, X, R, _, _, _ = jax.lax.while_loop(cond, body, (0, X, R, Z, P, rz))
    return X, i


def _prep_rhs(b, x0):
    b = jnp.asarray(b)
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    if x0 is None:
        X0 = jnp.zeros_like(B)
    else:
        X0 = jnp.asarray(x0, dtype=B.dtype)
        if X0.ndim == 1:
            X0 = X0[:, None]
        if X0.shape != B.shape:        # zero-pad / truncate like the reference
            Z = jnp.zeros_like(B)
            r = min(X0.shape[0], B.shape[0])
            c = min(X0.shape[1], B.shape[1])
            Z = Z.at[:r, :c].set(X0[:r, :c])
            X0 = Z
    return B, X0, squeeze


def cg(matvec, b, x0=None, M=None, tol=1e-5, maxiter=None, operator=None,
       m_operator=None, with_info=False):
    """Conjugate gradients for SPD systems (ref gp_lin_alg.py:1213).

    Parameters
    ----------
    matvec : closure (n, k)->(n, k), or stable fn(data, X) with ``operator``
    b : (n,) or (n, k) right-hand side(s)
    x0 : warm start (ref warm-start contract, gp_lin_alg.py:973-1003)
    M : preconditioner — closure or stable fn(data, X) with ``m_operator``
    with_info : also return ``{"iterations": n}`` (the measurable payoff of
        the warm-start/preconditioner-reuse policy, ref gp_kv.py:30-60)
    """
    B, X0, squeeze = _prep_rhs(b, x0)
    if maxiter is None:
        maxiter = 10 * B.shape[0]
    fn, data, m_fn, m_data = _normalize(matvec, operator, M, m_operator)
    X, iters = _cg_impl(fn, m_fn, data, m_data, B, X0,
                        jnp.asarray(tol, B.dtype), int(maxiter))
    X = X[:, 0] if squeeze else X
    if with_info:
        return X, {"iterations": int(iters)}
    return X


@functools.partial(jax.jit, static_argnames=("matvec_fn", "m_fn", "maxiter"))
def _minres_impl(matvec_fn, m_fn, data, m_data, B, X0, tol, maxiter):
    """MINRES on a block of RHS columns (symmetric, possibly indefinite).

    Standard Lanczos + Givens formulation, vectorized over columns.
    """
    n, k = B.shape
    bnorm = jnp.sqrt(jnp.sum(B * B, axis=0))
    # zero RHS columns have solution 0 exactly (see _cg_impl)
    X = jnp.where((bnorm == 0.0)[None, :], 0.0, X0)
    R1 = B - matvec_fn(data, X)
    Y = m_fn(m_data, R1)
    eps = jnp.asarray(jnp.finfo(B.dtype).eps, B.dtype)
    ry = jnp.sum(R1 * Y, axis=0)
    # a genuinely negative r·M⁻¹r means the preconditioner is indefinite —
    # MINRES's Lanczos breaks down (scipy raises here).  Clamping it to 0
    # would SILENTLY return the warm start as "converged"; poison the
    # column with NaN instead so the failure is loud downstream.
    neg_scale = jnp.sum(jnp.abs(R1) * jnp.abs(Y), axis=0)
    bad = ry < -1e3 * eps * neg_scale
    beta1 = jnp.where(bad, jnp.nan,
                      jnp.sqrt(jnp.maximum(ry, 0.0)))             # (k,)
    X = jnp.where(bad[None, :], jnp.nan, X)
    atol = tol * jnp.maximum(bnorm, 1e-300)

    state = dict(
        i=0, X=X, R1=R1, R2=R1, Y=Y, beta=beta1, beta1=beta1,
        oldb=jnp.zeros(k, B.dtype), dbar=jnp.zeros(k, B.dtype),
        epsln=jnp.zeros(k, B.dtype), phibar=beta1,
        cs=-jnp.ones(k, B.dtype), sn=jnp.zeros(k, B.dtype),
        W=jnp.zeros((n, k), B.dtype), W2=jnp.zeros((n, k), B.dtype),
    )

    def cond(s):
        return jnp.logical_and(s["i"] < maxiter,
                               jnp.any(jnp.abs(s["phibar"]) > atol))

    def body(s):
        i = s["i"]
        beta = s["beta"]
        safe_beta = jnp.where(beta == 0, 1.0, beta)
        V = s["Y"] / safe_beta[None, :]
        Yv = matvec_fn(data, V)
        Yv = jnp.where(i >= 1,
                       Yv - (beta / jnp.where(s["oldb"] == 0, 1.0,
                                              s["oldb"]))[None, :] * s["R1"],
                       Yv)
        alfa = jnp.sum(V * Yv, axis=0)
        Yv = Yv - (alfa / safe_beta)[None, :] * s["R2"]
        R1n = s["R2"]
        R2n = Yv
        Yn = m_fn(m_data, Yv)
        oldb = beta
        beta_n = jnp.sqrt(jnp.maximum(jnp.sum(R2n * Yn, axis=0), 0.0))

        oldeps = s["epsln"]
        delta = s["cs"] * s["dbar"] + s["sn"] * alfa
        gbar = s["sn"] * s["dbar"] - s["cs"] * alfa
        epsln = s["sn"] * beta_n
        dbar = -s["cs"] * beta_n
        gamma = jnp.maximum(jnp.sqrt(gbar ** 2 + beta_n ** 2), eps)
        cs = gbar / gamma
        sn = beta_n / gamma
        phi = cs * s["phibar"]
        phibar = sn * s["phibar"]

        denom = 1.0 / gamma
        W1 = s["W2"]
        W2 = s["W"]
        Wn = (V - oldeps[None, :] * W1 - delta[None, :] * W2) * denom[None, :]
        active = (jnp.abs(s["phibar"]) > atol).astype(B.dtype)
        Xn = s["X"] + (phi * active)[None, :] * Wn

        return dict(i=i + 1, X=Xn, R1=R1n, R2=R2n, Y=Yn,
                    beta=beta_n, beta1=s["beta1"], oldb=oldb, dbar=dbar,
                    epsln=epsln, phibar=phibar, cs=cs, sn=sn, W=Wn, W2=W2)

    out = jax.lax.while_loop(cond, body, state)
    return out["X"]


def minres(matvec, b, x0=None, M=None, tol=1e-5, maxiter=None, operator=None,
           m_operator=None):
    """MINRES for symmetric systems (ref gp_lin_alg.py:1184).  Calling
    conventions as :func:`cg`."""
    B, X0, squeeze = _prep_rhs(b, x0)
    if maxiter is None:
        maxiter = 10 * B.shape[0]
    fn, data, m_fn, m_data = _normalize(matvec, operator, M, m_operator)
    X = _minres_impl(fn, m_fn, data, m_data, B, X0, jnp.asarray(tol, B.dtype),
                     int(maxiter))
    return X[:, 0] if squeeze else X
