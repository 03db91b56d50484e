"""Reference-name linear-algebra layer (parity target:
/root/reference/fvgp/gp_lin_alg.py).

The reference exposes its L0 numerics as free functions
(``calculate_Chol_factor``, ``calculate_sparse_conj_grad``,
``calculate_random_logdet``, ...) that power users import directly.  This
module provides the same names with the same call signatures and numpy
in/out conventions, delegating to the device implementations in
``fvgp_tpu.ops`` (where the actual algorithms — and their tests — live).

Conventions preserved from the reference:

* inputs/outputs are numpy (device arrays are materialized on return);
* 1-d right-hand sides are accepted everywhere and returned 2-d ``(n, 1)``
  by the solve family, matching the reference's reshape behavior;
* ``compute_device`` is accepted and ignored (JAX owns placement);
* ``args`` honors the reference's key families (``sparse_cg_*``,
  ``sparse_minres_*``, ``random_logdet_*``,
  ``sparse_preconditioner_type``).

Documented deviation: the sparse *direct* family (``calculate_sparse_LU_*``,
``calculate_sparse_solve``) is served by dense Cholesky below
``args['sparse_direct_dense_cutoff']`` and tightly-converged preconditioned
CG above it — sparse LU factorization does not map onto an accelerator.
"""

import numpy as np
from scipy import sparse as _sp

from . import config
from .ops import dense as _dense
from .ops import krylov as _krylov
from .ops import slq as _slq
from .ops.precond import build_preconditioner_op
from .parallel.block_sparse import (BlockSparseMatrix, bsm_matvec_factory,
                                    from_scipy, is_block_sparse)

from .ops.dense import NonPositiveDefiniteError  # noqa: F401  (ref :27)

__all__ = [
    "NonPositiveDefiniteError",
    "calculate_Chol_factor", "update_Chol_factor", "calculate_Chol_solve",
    "calculate_Chol_logdet", "cholesky_update_rank_n",
    "cholesky_update_rank_1", "cholesky_update_rank_1_numpy",
    "cholesky_update_rank_1_torch", "cholesky_update_rank_1_cupy",
    "calculate_inv_from_chol", "calculate_logdet", "update_logdet",
    "calculate_inv", "update_inv", "solve", "matmul", "matmul3",
    "is_sparse", "how_sparse_is",
    "calculate_sparse_conj_grad", "calculate_sparse_minres",
    "calculate_sparse_solve", "calculate_random_logdet",
    "calculate_sparse_preconditioner", "normalize_sparse_preconditioner_type",
    "calculate_sparse_LU_factor", "calculate_LU_solve", "calculate_LU_logdet",
    "get_gpu_engine", "gpu_engine_unavailable_reason", "spai",
    "sparse_preconditioner_failure_guidance", "resolve_gp2scale_linalg_mode",
]


def _np(x):
    return np.asarray(x)


def _rhs_2d(vec):
    vec = np.asarray(vec)
    return vec.reshape(len(vec), 1) if vec.ndim == 1 else vec


# ---------------------------------------------------------------------------
# dense Cholesky family
# ---------------------------------------------------------------------------

def calculate_Chol_factor(M, compute_device="cpu", args=None):
    """Lower-triangular Cholesky factor of the SPD matrix ``M``
    (ref gp_lin_alg.py:237)."""
    return _np(_dense.cholesky_factor(np.asarray(M)))


def update_Chol_factor(old_chol_factor, new_matrix, compute_device="cpu",
                       args=None):
    """Extend a factor to cover appended rows/columns (ref gp_lin_alg.py:272)
    — here one blocked trailing update on the device, not sequential rank-1
    sweeps."""
    return _np(_dense.update_chol_factor(np.asarray(old_chol_factor),
                                         np.asarray(new_matrix)))


def calculate_Chol_solve(factor, vec, compute_device="cpu", args=None):
    """Solve ``A x = vec`` from the Cholesky factor (ref gp_lin_alg.py:289)."""
    return _np(_dense.cholesky_solve(np.asarray(factor), _rhs_2d(vec)))


def calculate_Chol_logdet(factor, compute_device="cpu", args=None):
    """log|A| = 2 Σ log diag(L) (ref gp_lin_alg.py:331)."""
    return float(_dense.cholesky_logdet(np.asarray(factor)))


def cholesky_update_rank_n(L, b, c, compute_device="cpu", args=None):
    """Extend ``L`` (factor of A) to the factor of ``[[A, b], [bᵀ, c]]``
    (ref gp_lin_alg.py:1466) — one blocked update instead of n rank-1
    passes."""
    return _np(_dense._chol_append(config.asarray(np.asarray(L)),
                                   config.asarray(np.asarray(b)),
                                   config.asarray(np.asarray(c))))


def calculate_inv_from_chol(L, compute_device="cpu", args=None):
    """A⁻¹ from the Cholesky factor (ref gp_lin_alg.py:1558)."""
    return _np(_dense.inv_from_chol(np.asarray(L)))


# ---------------------------------------------------------------------------
# dense general family
# ---------------------------------------------------------------------------

def calculate_logdet(A, compute_device="cpu", args=None):
    """log|A| via slogdet (ref gp_lin_alg.py:1484)."""
    return float(_dense.calculate_logdet(np.asarray(A)))


def update_logdet(old_logdet, old_inv, new_matrix, compute_device="cpu",
                  args=None):
    """Appended-block logdet update via the Schur complement
    (ref gp_lin_alg.py:1522)."""
    return float(_dense.update_logdet(float(old_logdet), np.asarray(old_inv),
                                      np.asarray(new_matrix)))


def calculate_inv(A, compute_device="cpu", args=None):
    """Explicit inverse (ref gp_lin_alg.py:1534)."""
    return _np(_dense.calculate_inv(np.asarray(A)))


def update_inv(old_inv, new_matrix, compute_device="cpu", args=None):
    """Appended-block inverse update (ref gp_lin_alg.py:1567)."""
    return _np(_dense.update_inv(np.asarray(old_inv), np.asarray(new_matrix)))


def solve(A, b, compute_device="cpu", args=None):
    """General solve with least-squares fallback for singular systems
    (ref gp_lin_alg.py:1581)."""
    return _np(_dense.solve(np.asarray(A), _rhs_2d(b)))


def matmul(A, B, compute_device="cpu", args=None):
    """A @ B; sparse operands stay sparse (ref gp_lin_alg.py:1629)."""
    return A @ B


def matmul3(A, B, C, compute_device="cpu", args=None):
    """A @ B @ C (ref gp_lin_alg.py:1662)."""
    return (A @ B) @ C


def is_sparse(A):
    """True when <1% of the entries are non-zero (ref gp_lin_alg.py:1702)."""
    return how_sparse_is(A) < 0.01


def how_sparse_is(A):
    """Non-zero fraction of ``A`` (ref gp_lin_alg.py:1711)."""
    if _sp.issparse(A):
        return float(A.nnz) / float(A.shape[0] * A.shape[1])
    if is_block_sparse(A):
        return A.sparsity()
    A = np.asarray(A)
    return float(np.count_nonzero(A)) / float(A.shape[0] * A.shape[1])


# ---------------------------------------------------------------------------
# sparse family
# ---------------------------------------------------------------------------

def _sparse_operator(KV, args):
    """(stable_fn, data, n) for the solvers' operator convention, from a
    scipy.sparse matrix, a BlockSparseMatrix, or a dense array."""
    if _sp.issparse(KV):
        block = int((args or {}).get("gp2Scale_block_size",
                                     min(256, KV.shape[0])))
        KV = from_scipy(KV.tocsr(), block)
    if is_block_sparse(KV):
        if KV.diag is not None:
            fn = bsm_matvec_factory(KV.nb, KV.block_size, KV.n, True)
            return fn, (KV.rows, KV.cols, KV.tiles, KV.diag), KV.shape[0]
        fn = bsm_matvec_factory(KV.nb, KV.block_size, KV.n, False)
        return fn, (KV.rows, KV.cols, KV.tiles), KV.shape[0]
    A = config.asarray(np.asarray(KV))
    return _krylov.dense_matvec, A, A.shape[0]


def _precond_pair(M):
    """Accept the reference's ``M=`` slot as either our
    ``calculate_sparse_preconditioner`` result, an (fn, data) pair, or a
    plain callable X -> M X."""
    if M is None:
        return None, None
    if isinstance(M, tuple) and len(M) == 2 and callable(M[0]) \
            and not callable(M[1]):
        return M
    if callable(M):
        return M, None
    raise Exception("Unrecognized preconditioner object for M=; pass the "
                    "result of calculate_sparse_preconditioner or a callable.")


def calculate_sparse_conj_grad(KV, vec, x0=None, M=None, args=None):
    """CG solve of the sparse SPD system (ref gp_lin_alg.py:1213).
    Honors ``sparse_cg_tol`` / ``sparse_cg_maxiter``."""
    args = args or {}
    fn, data, _n = _sparse_operator(KV, args)
    m_fn, m_data = _precond_pair(M)
    b = _rhs_2d(vec)
    x = _krylov.cg(fn, config.asarray(b),
                   x0=None if x0 is None else config.asarray(_rhs_2d(x0)),
                   M=m_fn, m_operator=m_data,
                   tol=float(args.get("sparse_cg_tol",
                                      args.get("cg_minres_tol", 1e-8))),
                   maxiter=int(args.get(
                       "sparse_cg_maxiter",
                       args.get("sparse_krylov_maxiter", 10 * b.shape[0]))),
                   operator=data)
    return _np(x).reshape(b.shape)


def calculate_sparse_minres(KV, vec, x0=None, M=None, args=None):
    """MINRES solve of the sparse symmetric system (ref gp_lin_alg.py:1184).
    Honors ``sparse_minres_tol`` / ``sparse_minres_maxiter``."""
    args = args or {}
    fn, data, _n = _sparse_operator(KV, args)
    m_fn, m_data = _precond_pair(M)
    b = _rhs_2d(vec)
    x = _krylov.minres(fn, config.asarray(b),
                       x0=None if x0 is None else
                       config.asarray(_rhs_2d(x0)),
                       M=m_fn, m_operator=m_data,
                       tol=float(args.get("sparse_minres_tol",
                                          args.get("cg_minres_tol", 1e-8))),
                       maxiter=int(args.get(
                           "sparse_minres_maxiter",
                           args.get("sparse_krylov_maxiter",
                                    10 * b.shape[0]))),
                       operator=data)
    return _np(x).reshape(b.shape)


def calculate_sparse_solve(KV, vec, args=None):
    """Direct-solve semantics for a sparse system (ref gp_lin_alg.py:1294).
    Deviation: dense Cholesky below ``sparse_direct_dense_cutoff``, tight
    preconditioned CG above it (module docstring)."""
    args = args or {}
    cutoff = int(args.get("sparse_direct_dense_cutoff", 20000))
    b = _rhs_2d(vec)
    if KV.shape[0] <= cutoff:
        A = KV.toarray() if (_sp.issparse(KV) or is_block_sparse(KV)) \
            else np.asarray(KV)
        return _np(_dense.cholesky_solve(_dense.cholesky_factor(A), b))
    tight = dict(args)
    tight.setdefault("sparse_cg_tol", 1e-10)
    M = calculate_sparse_preconditioner(KV, tight)[1]
    return calculate_sparse_conj_grad(KV, b, M=M, args=tight)


calculate_sparse_LU_factor = None     # assigned below (keeps __all__ honest)


def _lu_factor(KV, args=None):
    """Direct-factor semantics (ref gp_lin_alg.py:203): the densified
    Cholesky factor (deviation documented in the module docstring)."""
    A = KV.toarray() if (_sp.issparse(KV) or is_block_sparse(KV)) \
        else np.asarray(KV)
    return _np(_dense.cholesky_factor(A))


def calculate_LU_solve(LU, vec, args=None):
    """Solve from the factor returned by ``calculate_sparse_LU_factor``
    (ref gp_lin_alg.py:211)."""
    return _np(_dense.cholesky_solve(np.asarray(LU), _rhs_2d(vec)))


def calculate_LU_logdet(LU, args=None):
    """logdet from the factor returned by ``calculate_sparse_LU_factor``
    (ref gp_lin_alg.py:224)."""
    return float(_dense.cholesky_logdet(np.asarray(LU)))


calculate_sparse_LU_factor = _lu_factor


def calculate_random_logdet(KV, compute_device="cpu", args=None,
                            info_out=None):
    """Stochastic Lanczos log-determinant (ref gp_lin_alg.py:1103) with the
    reference's arg keys (``random_logdet_lanczos_degree``,
    ``random_logdet_error_rtol``, ``random_logdet_min/max_num_samples``) and
    ``info_out`` precision-reporting contract (variance, num_samples_used,
    absolute/relative error)."""
    args = args or {}
    fn, data, n = _sparse_operator(KV, args)
    raw = {}
    ld = float(_slq.slq_logdet(
        fn, n, dtype=config.linalg_dtype(args), operator=data,
        degree=int(args.get("random_logdet_lanczos_degree", 20)),
        min_num_samples=int(args.get("random_logdet_min_num_samples", 10)),
        max_num_samples=int(args.get("random_logdet_max_num_samples", 5000)),
        error_rtol=float(args.get("random_logdet_error_rtol", 0.01)),
        info_out=raw))
    if info_out is not None:
        var = raw.get("variance")
        info_out.update(raw)
        # the reference's imate-shaped key names (ref gp_lin_alg.py:1159-1180)
        info_out["num_samples_used"] = raw.get("num_samples")
        info_out["absolute_error"] = (float(np.sqrt(var))
                                      if var is not None else None)
        info_out.setdefault("relative_error", None)
    return ld


def normalize_sparse_preconditioner_type(name):
    """Canonicalize the reference's preconditioner aliases onto the three
    operators that exist here (ref gp_lin_alg.py:397): every IC/ILU-family
    name -> 'schwarz' (overlapping additive Schwarz), AMG names -> 'amg'
    (two-level), jacobi names -> 'block_jacobi'.  One table: delegates to
    ``ops.precond.normalize_type`` (also used by the operator dispatch
    itself, so a typo raises everywhere instead of silently falling back)."""
    from .ops.precond import normalize_type
    return normalize_type(name)


def calculate_sparse_preconditioner(KV, args=None):
    """Build the preconditioner selected by
    ``args['sparse_preconditioner_type']`` (ref gp_lin_alg.py:890).

    Returns ``(factor_data, operator)`` where ``operator`` is ready to pass
    as the ``M=`` argument of :func:`calculate_sparse_conj_grad` /
    :func:`calculate_sparse_minres` (here an ``(apply_fn, data)`` pair in
    the ops operator convention rather than a scipy LinearOperator).
    """
    args = dict(args or {})
    ptype = normalize_sparse_preconditioner_type(
        args.get("sparse_preconditioner_type", "block_jacobi"))
    args["sparse_preconditioner_type"] = ptype
    if _sp.issparse(KV):
        block = int(args.get("gp2Scale_block_size", min(256, KV.shape[0])))
        KV = from_scipy(KV.tocsr(), block)
    m_fn, m_data = build_preconditioner_op(KV, args=args)
    return m_data, (m_fn, m_data)


# ---------------------------------------------------------------------------
# remaining reference-name surface (ref gp_lin_alg.py:27, :124-201, :363-471,
# :474-505, :1310-1463)
# ---------------------------------------------------------------------------

def cholesky_update_rank_1(L, b, c, compute_device="cpu", args=None):
    """Extend ``L`` (factor of A) to the factor of ``[[A, b], [bᵀ, c]]`` for
    ONE new point (ref gp_lin_alg.py:1310).  Same blocked device update as
    :func:`cholesky_update_rank_n` with a single column."""
    b = np.asarray(b, dtype=float).reshape(-1, 1)
    c = np.asarray(c, dtype=float).reshape(1, 1)
    return cholesky_update_rank_n(L, b, c, compute_device, args)


# the reference splits this per GPU engine (ref gp_lin_alg.py:1385-1463);
# here every device path is the same XLA program, so the engine-named
# variants are aliases kept for import compatibility
cholesky_update_rank_1_numpy = cholesky_update_rank_1
cholesky_update_rank_1_torch = cholesky_update_rank_1
cholesky_update_rank_1_cupy = cholesky_update_rank_1


def get_gpu_engine(args):
    """The reference returns a torch/cupy module for its GPU branches
    (ref gp_lin_alg.py:148); this build has no separate GPU engine — every
    array op is one JAX/XLA program that runs on whatever backend jax
    initialized (the accelerator here).  Returns ``None`` always."""
    return None


def gpu_engine_unavailable_reason(engine, args=None):
    """Why a requested GPU engine is not in play (ref gp_lin_alg.py:124).
    Always a fixed explanation here: there are no per-engine branches to
    enable — compute already runs on the accelerator via XLA."""
    return (f"GPU engine {engine!r} is not used by fvgp_tpu: all linear "
            "algebra compiles through JAX/XLA onto the active backend "
            "(GPU/CPU); torch/cupy device branches do not exist. "
            "Remove 'Chol_*_compute_device'/'GPU_engine' args or leave "
            "them — they are accepted and ignored.")


def spai(A, m, args=None):
    """Sparse Approximate Inverse preconditioner, ``m`` refinement steps
    (ref gp_lin_alg.py:363).  Re-derived minimal-residual SPAI: starting
    from the 1-norm-scaled ``M0 = 2 A / ||A A^T||_1``, each step adds the
    optimally-scaled residual direction

        ``M <- M + alpha G``,  ``G = I - A M``,
        ``alpha = tr(G^T A G) / ||A G||_F^2``

    which monotonically reduces ``||I - A M||_F`` for SPD ``A``.  Host
    scipy computation — this is a setup-time operation; the device solvers
    take preconditioners as batched operators (ops/precond.py), and a CSR
    ``M`` can be wrapped as ``M=(lambda X, d: d @ X, M_dense)`` for the
    host path or used with scipy's own cg."""
    from scipy import sparse as sp
    from scipy.sparse.linalg import onenormest
    if not sp.issparse(A):
        raise AssertionError("A must be sparse for SPAI")
    steps = int(m)
    M = (2.0 / onenormest(A @ A.T)) * A
    eye = sp.identity(A.shape[0], format="csr")
    for _ in range(max(steps, 0)):
        G = eye - A @ M
        AG = A @ G
        denom = float(np.sum(AG.data ** 2))
        if denom == 0.0:
            break
        # tr(Gᵀ A G) is the Frobenius inner product <G, AG> — O(nnz),
        # no need for the full sparse-sparse product G.T @ AG
        alpha = float(G.multiply(AG).sum()) / denom
        M = M + alpha * G
    if not sp.issparse(M):
        raise AssertionError("SPAI result must remain sparse")
    return M


def sparse_preconditioner_failure_guidance(args=None):
    """Actionable text attached to preconditioner-build failures
    (ref gp_lin_alg.py:440).  Reflects the operators that exist HERE."""
    raw = (args.get("sparse_preconditioner_type", "block_jacobi")
           if isinstance(args, dict) else args)
    try:
        ptype = normalize_sparse_preconditioner_type(raw)
    except Exception:
        ptype = str(raw)
    lines = [
        "A failed preconditioner build usually means the covariance is too "
        "dense for its block structure: check the compact-support kernel's "
        "length scales / support radius before tuning solver knobs.",
        "All preconditioners here are batched device operators "
        "(block-Jacobi, overlapping additive Schwarz behind every IC/ILU "
        "alias, two-level 'amg'); there is no optional package to install.",
    ]
    if ptype == "schwarz":
        lines.append("For Schwarz, the windows are exact 2B-size "
                     "factorizations: reduce 'gp2Scale_block_size' if the "
                     "batched Cholesky does not fit device memory.")
    elif ptype == "amg":
        lines.append("The two-level operator adds a tile-sum coarse solve "
                     "on top of block-Jacobi; if the coarse factor fails, "
                     "fall back to 'schwarz' or 'block_jacobi'.")
    else:
        lines.append("block-Jacobi always builds if the diagonal blocks are "
                     "positive definite; a failure there indicates a non-PD "
                     "K+V — grow the noise floor.")
    lines.append("The built operator is cached and reused until K+V drifts "
                 "past args['sparse_preconditioner_max_matrix_drift'] "
                 "(default 0.1).")
    return " ".join(lines)


def resolve_gp2scale_linalg_mode(mode, args=None):
    """``'sparseCGpre_amg'`` → ``('sparseCGpre', args-with-type)``
    (ref gp_lin_alg.py:474) — the alias resolver the GP facade applies to
    ``linalg_mode`` strings.  Reference contract: case-insensitive mode
    matching; an explicit ``args['sparse_preconditioner_type']`` that
    conflicts with the mode suffix raises ``ValueError``."""
    args = dict(args or {})
    if not isinstance(mode, str):
        return mode, args
    low = mode.lower()
    for prefix, canonical in (("sparsecgpre_", "sparseCGpre"),
                              ("sparseminrespre_", "sparseMINRESpre")):
        if not low.startswith(prefix):
            continue
        inferred = normalize_sparse_preconditioner_type(low[len(prefix):])
        explicit = args.get("sparse_preconditioner_type")
        if explicit is not None:
            explicit = normalize_sparse_preconditioner_type(explicit)
            if explicit != inferred:
                raise ValueError(
                    f"Conflicting sparse preconditioner specifications: "
                    f"mode {mode!r} implies {inferred!r}, but "
                    f"args['sparse_preconditioner_type'] is {explicit!r}.")
        args["sparse_preconditioner_type"] = inferred
        return canonical, args
    return mode, args
