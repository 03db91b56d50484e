"""Dense linear algebra on device — the GPU replacement for the reference's
scipy/LAPACK layer (/root/reference/fvgp/gp_lin_alg.py:237-360, :1310-1477,
:1484-1700).

Everything here is a jitted pure function of device arrays.  The compute
dtype is whatever the caller hands in (config.linalg_dtype decides upstream).
Rank-n updates are formulated as *blocked trailing updates* — two triangular
solves and one Cholesky of the new block, all matmul-shaped — instead of the
reference's sequential rank-1 loop (gp_lin_alg.py:1466-1477), which is
latency-bound and hostile to the matrix units.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular

__all__ = [
    "NonPositiveDefiniteError", "cholesky_factor", "cholesky_solve",
    "cholesky_logdet", "inv_from_chol", "calculate_inv", "calculate_logdet",
    "solve", "update_chol_factor", "update_inv", "update_logdet",
    "add_diagonal", "check_factor",
]


class NonPositiveDefiniteError(np.linalg.LinAlgError):
    """Raised when a Cholesky factorization meets a non-PD matrix
    (ref gp_lin_alg.py:27-58 keeps the same diagnostic contract)."""


_NON_PD_GUIDANCE = (
    "Cholesky factorization failed: K + V is not positive definite. "
    "Common causes and remedies: (1) duplicate or near-duplicate data points "
    "-> add measurement noise / jitter; (2) hyperparameters at extreme values "
    "-> tighten the training bounds; (3) a user kernel that is not positive "
    "semi-definite -> verify the kernel; (4) too little noise -> increase "
    "noise_variances or use a noise function."
)


@jax.jit
def _chol(KV):
    return jnp.linalg.cholesky(KV)


def check_factor(L):
    """Host-side NaN check converting a failed factorization into the typed
    diagnostic error the reference raises (gp_lin_alg.py:27)."""
    # one scalar transfer; cheap relative to the O(N^3) factorization
    if not bool(jnp.isfinite(L[-1, -1])) or not bool(jnp.all(jnp.isfinite(jnp.diagonal(L)))):
        raise NonPositiveDefiniteError(_NON_PD_GUIDANCE)
    return L


def cholesky_factor(KV, check=True):
    """Lower-triangular Cholesky factor of KV (ref gp_lin_alg.py:237)."""
    L = _chol(jnp.asarray(KV))
    if check:
        check_factor(L)
    return L


@jax.jit
def cholesky_solve(L, b):
    """Solve (L Lᵀ) x = b given the factor (ref gp_lin_alg.py:289)."""
    b = jnp.asarray(b)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    y = solve_triangular(L, b, lower=True)
    x = solve_triangular(L.T, y, lower=False)
    return x[:, 0] if squeeze else x


@jax.jit
def cholesky_logdet(L):
    """log|KV| = 2 Σ log diag(L) (ref gp_lin_alg.py:331)."""
    return 2.0 * jnp.sum(jnp.log(jnp.abs(jnp.diagonal(L))))


@jax.jit
def inv_from_chol(L):
    """Explicit inverse from a Cholesky factor (ref gp_lin_alg.py:1558)."""
    eye = jnp.eye(L.shape[0], dtype=L.dtype)
    Linv = solve_triangular(L, eye, lower=True)
    return Linv.T @ Linv


def calculate_inv(A):
    """Explicit inverse (ref gp_lin_alg.py:1534). Tries Cholesky (SPD fast
    path) and falls back to LU."""
    A = jnp.asarray(A)
    L = _chol(A)
    if bool(jnp.all(jnp.isfinite(jnp.diagonal(L)))):
        return inv_from_chol(L)
    return jnp.linalg.inv(A)


@jax.jit
def _slogdet(A):
    sign, ld = jnp.linalg.slogdet(A)
    return ld


def calculate_logdet(A):
    """log|A| via slogdet (ref gp_lin_alg.py:1484)."""
    return _slogdet(jnp.asarray(A))


def solve(A, b):
    """General solve with least-squares fallback for singular systems
    (ref gp_lin_alg.py:1581-1592)."""
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    x = jnp.linalg.solve(A, b)
    if bool(jnp.all(jnp.isfinite(x))):
        return x
    return jnp.linalg.lstsq(A, b)[0]


@jax.jit
def add_diagonal(K, v):
    """K + diag(v) without materializing the diagonal matrix
    (ref gp_kv.py:664-667)."""
    n = K.shape[0]
    return K.at[jnp.arange(n), jnp.arange(n)].add(v)


# ---------------------------------------------------------------------------
# blocked rank-n updates (append path)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=())
def _chol_append(L11, B, C):
    """Extend the factor of A to the factor of [[A, B], [Bᵀ, C]].

    L21 = (L11⁻¹ B)ᵀ, L22 = chol(C - L21 L21ᵀ): two triangular solves and a
    small Cholesky — all matmul work, no sequential rank-1 sweeps
    (replaces ref gp_lin_alg.py:1310-1477).
    """
    S = solve_triangular(L11, B, lower=True)           # (n_old, n_new)
    L21 = S.T
    L22 = jnp.linalg.cholesky(C - L21 @ L21.T)
    n_old, n_new = B.shape
    top = jnp.concatenate([L11, jnp.zeros((n_old, n_new), L11.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def update_chol_factor(old_factor, new_matrix):
    """Rank-n update of a Cholesky factor after appending data
    (ref gp_lin_alg.py:272, :1466)."""
    new_matrix = jnp.asarray(new_matrix)
    n_old = old_factor.shape[0]
    B = new_matrix[:n_old, n_old:]
    C = new_matrix[n_old:, n_old:]
    L = _chol_append(old_factor, B, C)
    check_factor(L)
    return L


@jax.jit
def _inv_append(Ainv, B, C):
    """Block inverse of [[A, B],[Bᵀ, C]] given A⁻¹ (Schur complement)."""
    AinvB = Ainv @ B
    S = C - B.T @ AinvB                       # Schur complement (SPD)
    Sl = jnp.linalg.cholesky(S)
    eye = jnp.eye(S.shape[0], dtype=S.dtype)
    Sli = solve_triangular(Sl, eye, lower=True)
    Sinv = Sli.T @ Sli
    top_left = Ainv + AinvB @ Sinv @ AinvB.T
    top_right = -AinvB @ Sinv
    top = jnp.concatenate([top_left, top_right], axis=1)
    bot = jnp.concatenate([top_right.T, Sinv], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def update_inv(old_inv, new_matrix):
    """Extend an explicit inverse after appending data
    (ref gp_lin_alg.py:1567)."""
    new_matrix = jnp.asarray(new_matrix)
    n_old = old_inv.shape[0]
    B = new_matrix[:n_old, n_old:]
    C = new_matrix[n_old:, n_old:]
    return _inv_append(old_inv, B, C)


def update_logdet(old_logdet, old_inv, new_matrix):
    """log|[[A,B],[Bᵀ,C]]| = log|A| + log|C - Bᵀ A⁻¹ B|
    (ref gp_lin_alg.py:1522)."""
    new_matrix = jnp.asarray(new_matrix)
    n_old = old_inv.shape[0]
    B = new_matrix[:n_old, n_old:]
    C = new_matrix[n_old:, n_old:]
    S = C - B.T @ (old_inv @ B)
    return old_logdet + calculate_logdet(S)
