"""Differentiable block-sparse marginal likelihood — the scale-path
training step.

The reference cannot differentiate its sparse LML at all: gp2Scale training
is restricted to MCMC/BO because imate's SLQ logdet and scipy's CG have no
gradient (ref gp.py:947-949, gp_marginal_likelihood.py:240).  Here the whole
sparse LML is ONE jittable, `jax.grad`-able program:

* covariance tiles are assembled in-trace from the (static) block structure,
  so the gradient flows through the kernel into the hyperparameters;
* the solve is conjugate gradients with a *static* iteration count
  (`lax.scan`, reverse-mode differentiable — the GPyTorch/BBMM recipe);
* log|K+V| is stochastic Lanczos quadrature with static probes and degree,
  differentiated through the Lanczos recursion and the m×m `eigh`.

Sharding: the tile arrays carry a NamedSharding over the device mesh; XLA
partitions the batched tile matmuls and inserts the all-reduce, so the same
program is the single-chip and the pod-scale training step.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

__all__ = ["make_sparse_lml", "make_committed_solver", "assemble_tiles",
           "tile_maxabs"]


def _assembly_chunk(T_pad, target=2048):
    """Largest divisor of T_pad that is <= target (assembly chunk size)."""
    best = 1
    d = 1
    while d * d <= T_pad:
        if T_pad % d == 0:
            if d <= target:
                best = max(best, d)
            q = T_pad // d
            if q <= target:
                best = max(best, q)
        d += 1
    return best


def assemble_tiles(kernel_fn, xb, mask, rows, cols, hps, out_dtype=None):
    """tiles[t] = k(x block rows[t], x block cols[t]) with padding masked.

    xb: (nb, B, D) padded point blocks; mask: (nb, B) validity;
    rows/cols: (T,) int32.  Sentinel contract: pass UNCLAMPED indices
    (sentinel == nb) — the gather clamps to the last block, producing a
    garbage tile, and the downstream segment_sum DROPS it because the
    unclamped row lands outside [0, nb).  If a caller clamps the indices
    BEFORE the SpMM instead (the traced lml does, so occupancy stays a
    runtime argument), the sentinel tiles land inside the last real row
    block and MUST be zeroed explicitly — that caller's assembler takes a
    ``live`` mask for exactly this (``_assemble_chunked``).  ``out_dtype``
    casts per tile inside the vmap, so a bf16 tile set never materializes
    in f32 (the memory ceiling at N~1M on one chip).
    """
    def one(i, j):
        Kt = kernel_fn(xb[i], xb[j], hps)
        Kt = Kt * (mask[i][:, None] * mask[j][None, :])
        return Kt if out_dtype is None else Kt.astype(out_dtype)

    return jax.vmap(one)(rows, cols)


@functools.partial(jax.jit, static_argnames=("kernel_fn",))
def _tile_maxabs_chunk(kernel_fn, xb, mask, rows, cols, hps):
    t = assemble_tiles(kernel_fn, xb, mask, rows, cols, hps)
    return jnp.max(jnp.abs(t), axis=(1, 2))


def tile_maxabs(kernel_fn, xb, mask, rows, cols, hps):
    """Per-tile max|k| for the zero-tile filter: the bounding-box prune is
    loose (boxes overlap even when no point pair is inside the support), so
    one cheap assembly pass drops the exact zeros before the many matvec
    passes of CG/SLQ touch them.  Evaluated in ``_assembly_chunk``-sized
    slices so the full (T, B, B) tile set never materializes — at N~1M
    that set is tens of GB, the module's documented memory ceiling.
    ``kernel_fn`` is a static (identity-cached) closure; ``xb``/``mask``
    are traced arguments so large point sets are never baked into the
    compiled program as constants."""
    T = int(rows.shape[0])
    chunk = _assembly_chunk(T)
    if T <= chunk:
        return _tile_maxabs_chunk(kernel_fn, xb, mask, rows, cols, hps)
    parts = [_tile_maxabs_chunk(kernel_fn, xb, mask, rows[s:s + chunk],
                                cols[s:s + chunk], hps)
             for s in range(0, T, chunk)]
    return jnp.concatenate(parts)


def _spmv(rows, cols, tiles, X, nb, B, mv_dtype=None):
    """Batched-tile SpMM.  ``mv_dtype=bfloat16`` streams the tiles at half
    the HBM traffic with f32 accumulation — the solve is
    bandwidth-bound, so this is ~2x on the matvec path at a ~1e-3 relative
    residual floor (fine for the stochastic MCMC/BO training regime)."""
    n_pad = nb * B
    acc = X.dtype if X.dtype == jnp.float64 else jnp.float32
    if mv_dtype is not None:
        tiles = tiles.astype(mv_dtype)
        Xc = X.astype(mv_dtype)
    else:
        Xc = X
    Xb = Xc.reshape(nb, B, -1)
    prod = jnp.einsum("tij,tjk->tik", tiles, Xb[cols],
                      preferred_element_type=acc)
    out = jax.ops.segment_sum(prod, rows, num_segments=nb)
    return out.reshape(n_pad, -1).astype(X.dtype)


def _local_spmm_tail(mesh, W, B, tiles, Xcat, cols, rows, mv_dtype,
                     out_dtype):
    """Shared per-device tail of the three shard_map SpMM bodies
    (row-partitioned / flat halo / hierarchical halo): optional streaming
    cast of the tiles, the tiled einsum against the gathered X blocks, the
    row-ownership guard (foreign rows cannot occur under a correct
    partition; clamped sentinels route to the dropped segment), and the
    local segment-sum.  One copy so the accumulator and guard semantics
    cannot diverge between the collectives."""
    from ..parallel.mesh import flat_tile_index
    acc = out_dtype if out_dtype == jnp.float64 else jnp.float32
    if mv_dtype is not None:
        tiles = tiles.astype(mv_dtype)
    prod = jnp.einsum("tij,tjk->tik", tiles, Xcat[cols],
                      preferred_element_type=acc)
    row0 = flat_tile_index(mesh) * W
    r_loc = jnp.where((rows >= row0) & (rows < row0 + W), rows - row0, W)
    out = jax.ops.segment_sum(prod, r_loc, num_segments=W)
    return out.reshape(W * B, -1).astype(out_dtype)


def _rowpart_spmv_factory(nb, B, mesh, mv_dtype=None):
    """Row-ownership SpMM over a device mesh (the scale path's collective
    design; see parallel/partition.py for the comm model).

    Tiles live on their output row block's owner (contiguous row ranges), so
    each device computes its own output rows COMPLETELY — no cross-device
    reduction exists.  The only collective is the all-gather of X that
    ``in_specs=P(None)`` inserts when X arrives row-sharded:
    ``(n-1)/n · nb·B·k`` words, HALF the all-reduce GSPMD needs for
    position-sharded tiles, and the output lands row-sharded for the next
    (local) vector op of CG.
    """
    from ..parallel.mesh import tile_device_count, tile_spec
    n_dev = tile_device_count(mesh)
    if nb % n_dev:
        raise ValueError(f"row-partitioned SpMM needs nb ({nb}) divisible by "
                         f"the mesh size ({n_dev}); pad the point blocking")
    nb_local = nb // n_dev

    def local_spmv(rows, cols, tiles, X):
        Xc = X.astype(mv_dtype) if mv_dtype is not None else X
        Xb = Xc.reshape(nb, B, -1)
        return _local_spmm_tail(mesh, nb_local, B, tiles, Xb, cols, rows,
                                mv_dtype, X.dtype)

    return jax.shard_map(local_spmv, mesh=mesh,
                         in_specs=(tile_spec(mesh), tile_spec(mesh),
                                   tile_spec(mesh, 2), P(None)),
                         out_specs=tile_spec(mesh, 1))


def _halo_spmv_factory(nb, B, mesh, halo_S, mv_dtype=None):
    """Row-ownership SpMM with HALO EXCHANGE instead of the X all-gather.

    The static gather plan (parallel/partition.halo_plan) ships only the
    distinct non-local column blocks each device's tiles reference, via one
    ``lax.all_to_all`` of ``halo_S`` padded slots per (src, dst) pair —
    ``n·(n-1)·S`` blocks on the wire per matvec vs the all-gather's
    ``n·(n-1)·W``.  X stays row-sharded end to end; cols arrive REMAPPED to
    positions in ``concat([local blocks, received blocks])``.
    """
    from ..parallel.mesh import tile_axes, tile_device_count, tile_spec
    n_dev = tile_device_count(mesh)
    axes = tile_axes(mesh)
    a2a_axis = axes[0] if len(axes) == 1 else axes
    if nb % n_dev:
        raise ValueError(f"halo SpMM needs nb ({nb}) divisible by the mesh "
                         f"size ({n_dev}); pad the point blocking")
    W = nb // n_dev

    def local_spmv(rows, cols_remap, tiles, X, send_sel, send_mask):
        Xc = X.astype(mv_dtype) if mv_dtype is not None else X
        k = Xc.shape[1]
        Xb = Xc.reshape(W, B, k)
        send = Xb[send_sel[0]] * send_mask[0][..., None, None].astype(Xc.dtype)
        recv = jax.lax.all_to_all(send, a2a_axis, 0, 0, tiled=True)
        Xcat = jnp.concatenate([Xb, recv.reshape(n_dev * halo_S, B, k)],
                               axis=0)
        return _local_spmm_tail(mesh, W, B, tiles, Xcat, cols_remap, rows,
                                mv_dtype, X.dtype)

    return jax.shard_map(local_spmv, mesh=mesh,
                         in_specs=(tile_spec(mesh), tile_spec(mesh),
                                   tile_spec(mesh, 2),
                                   tile_spec(mesh, 1),
                                   tile_spec(mesh, 2),
                                   tile_spec(mesh, 2)),
                         out_specs=tile_spec(mesh, 1))


def _halo_hier_spmv_factory(nb, B, mesh, halo_spec, mv_dtype=None):
    """Row-ownership SpMM with the HIERARCHICAL two-stage halo exchange
    (parallel/partition.halo_plan_hier) on a 2-D ``(slice, tiles)`` mesh.

    Three collectives per matvec instead of one uniformly-padded
    all-to-all: same-slice blocks ride a ``tiles``-axis all-to-all (ICI,
    pad ``S_ici``); cross-slice blocks are first FORWARDED over ICI to the
    device whose tiles-coordinate matches the destination's (pad
    ``S_fwd``), then exchanged over the ``slice`` axis (DCN, pad
    ``S_dcn``) — so DCN carries only the slice-boundary band instead of
    the global pad (docs/source/comm_model.md).
    """
    from ..parallel.mesh import (SLICE_AXIS, TILE_AXIS,
                                 tile_device_count, tile_spec)
    _, S_ici, S_fwd, S_dcn = halo_spec
    n_dev = tile_device_count(mesh)
    if SLICE_AXIS not in mesh.shape:
        raise ValueError("hierarchical halo SpMM needs a 2-D (slice, "
                         "tiles) mesh")
    ns = int(mesh.shape[SLICE_AXIS])
    ps = int(mesh.shape[TILE_AXIS])
    if nb % n_dev:
        raise ValueError(f"halo SpMM needs nb ({nb}) divisible by the mesh "
                         f"size ({n_dev}); pad the point blocking")
    W = nb // n_dev

    def local_spmv(rows, cols_remap, tiles, X,
                   sel_ici, m_ici, sel_fwd, m_fwd, fwd_sel, m_dcn):
        Xc = X.astype(mv_dtype) if mv_dtype is not None else X
        k = Xc.shape[1]
        Xb = Xc.reshape(W, B, k)
        # stage 1: same-slice remote blocks, direct over ICI
        send1 = Xb[sel_ici[0]] * m_ici[0][..., None, None].astype(Xc.dtype)
        recv1 = jax.lax.all_to_all(send1, TILE_AXIS, 0, 0, tiled=True)
        # stage 2a: cross-slice blocks onto their forwarder (ICI)
        send2 = Xb[sel_fwd[0]] * m_fwd[0][..., None, None].astype(Xc.dtype)
        recv2 = jax.lax.all_to_all(send2, TILE_AXIS, 0, 0, tiled=True)
        # stage 2b: forwarders exchange over the slice axis (DCN)
        flat2 = recv2.reshape(ps * S_fwd, B, k)
        send3 = flat2[fwd_sel[0]] * m_dcn[0][..., None, None].astype(Xc.dtype)
        recv3 = jax.lax.all_to_all(send3, SLICE_AXIS, 0, 0, tiled=True)
        Xcat = jnp.concatenate(
            [Xb, recv1.reshape(ps * S_ici, B, k),
             recv3.reshape(ns * S_dcn, B, k)], axis=0)
        return _local_spmm_tail(mesh, W, B, tiles, Xcat, cols_remap, rows,
                                mv_dtype, X.dtype)

    return jax.shard_map(local_spmv, mesh=mesh,
                         in_specs=(tile_spec(mesh), tile_spec(mesh),
                                   tile_spec(mesh, 2),
                                   tile_spec(mesh, 1))
                                  + (tile_spec(mesh, 2),) * 6,
                         out_specs=tile_spec(mesh, 1))


def _spmv_scan(rows, cols, tiles, X, nb, B, mv_dtype=None):
    """Tile-CHUNKED SpMM for wide right-hand sides (lax.scan over tile
    slices).  The flat ``_spmv`` materializes a (T, B, c) per-tile product —
    ~34 GB at N=1M with c=500 — so wide committed-state solves (posterior
    cross-covariances) stream the tiles in chunks instead: peak extra memory
    is one (chunk, B, c) slice plus the (nb, B, c) accumulator, which XLA
    updates in place through the scan carry.  Sentinel contract matches
    ``_spmv``: rows/cols may arrive clamped with zeroed sentinel tiles, or
    unclamped (row == nb) — the ``mode='drop'`` scatter ignores those."""
    acc_dt = X.dtype if X.dtype == jnp.float64 else jnp.float32
    Xc = X.astype(mv_dtype) if mv_dtype is not None else X
    c = X.shape[1]
    Xb = Xc.reshape(nb, B, c)
    T = int(tiles.shape[0])
    # chunk sized so the per-slice product stays ~256 MB
    target = max(64, (256 << 20) // max(B * c * jnp.dtype(acc_dt).itemsize, 1))
    chunk = _assembly_chunk(T, target=min(target, 8192))

    def body(acc, rct):
        r, cc, t = rct
        if mv_dtype is not None:
            t = t.astype(mv_dtype)
        prod = jnp.einsum("tij,tjk->tik", t, Xb[jnp.minimum(cc, nb - 1)],
                          preferred_element_type=acc_dt)
        # no indices_are_sorted promise, although the rows are sorted: on
        # an H100, XLA's sorted-scatter lowering of (1024, 128, 512) f32
        # slices into a (391, 128, 512) accumulator compiled for ~6 min and
        # then failed to launch (CUDA_ERROR_INVALID_VALUE); the general
        # scatter compiles in ~1 s and runs (tests/test_pallas_kernels.py)
        return acc.at[r].add(prod, mode="drop"), None

    acc, _ = jax.lax.scan(
        body, jnp.zeros((nb, B, c), acc_dt),
        (rows.reshape(-1, chunk), cols.reshape(-1, chunk),
         tiles.reshape(-1, chunk, B, B)))
    return acc.reshape(nb * B, c).astype(X.dtype)


def _spmv_for(nb, B, mesh, mv_dtype=None, halo_S=None):
    """The SpMM for this mesh: row-partitioned shard_map when a (>1 device)
    mesh is given (with halo exchange when a ``halo_S`` plan is supplied);
    the XLA segment-sum otherwise."""
    if mesh is not None:
        from ..parallel.mesh import tile_device_count
        if tile_device_count(mesh) > 1:
            if halo_S is not None:
                if isinstance(halo_S, tuple):   # ("hier", S_ici, S_fwd, S_dcn)
                    return _halo_hier_spmv_factory(nb, B, mesh, halo_S,
                                                   mv_dtype=mv_dtype)
                return _halo_spmv_factory(nb, B, mesh, halo_S,
                                          mv_dtype=mv_dtype)
            return _rowpart_spmv_factory(nb, B, mesh, mv_dtype=mv_dtype)

    def spmv(rows, cols, tiles, X):
        return _spmv(rows, cols, tiles, X, nb, B, mv_dtype=mv_dtype)

    return spmv


def _assemble_chunked_tiles(kernel_fn, B, solver_dtype, hps, rows_c, cols_c,
                            live, xb, mask):
    """Chunked, remat'd in-trace tile assembly (shared by the traced LML and
    the committed-state solver).  Chunking bounds the assembly-VJP's
    temporaries to one chunk (an unchunked vjp materializes a full f32
    (T, B, B) reduce temp — 12.5 GB at N=500k); remat keeps the per-tile
    kernel intermediates out of the residuals.  The sentinel mask (`live`)
    is folded into the per-tile computation so no full-size elementwise
    pass exists outside the chunks."""
    T = rows_c.shape[0]
    chunk = _assembly_chunk(T)
    Rc = rows_c.reshape(-1, chunk)
    Cc = cols_c.reshape(-1, chunk)
    Lv = live.reshape(-1, chunk)

    @jax.checkpoint
    def one_chunk(carry, rcl):
        r, c, lv = rcl

        def one(i, j, alive):
            Kt = kernel_fn(xb[i], xb[j], hps)
            Kt = Kt * (mask[i][:, None] * mask[j][None, :])
            Kt = jnp.where(alive, Kt, 0.0)
            return Kt if solver_dtype is None else Kt.astype(solver_dtype)

        return carry, jax.vmap(one)(r, c, lv)

    _, tiles = jax.lax.scan(one_chunk, 0, (Rc, Cc, Lv))
    return tiles.reshape(T, B, B)


def _diag_precond_blocks(kernel_fn, B, precond_width, hps, xb, mask,
                         noise_local, i0):
    """Block-diagonal preconditioner from exact kernel blocks of
    ``precond_width`` point blocks each: one batched Cholesky + an
    explicit block inverse so every CG iteration is one batched matmul
    — all matmul work (no gradient through the preconditioner: it only
    changes the iteration path, not the solution, so stop_gradient
    keeps the backward pass lean).

    ``precond_width`` > 1 groups ADJACENT point blocks (a pure reshape
    — blocks are index-consecutive, and Morton ordering makes adjacent
    blocks spatial neighbors), capturing the inter-block coupling that
    stalls plain block-Jacobi on long length scales, while M stays
    block-diagonal so the mBCG quadrature's exact log|M| correction
    still holds.  ``i0``/``noise_local`` let the same code run
    per-device under shard_map."""
    nb_loc = noise_local.shape[0] // B
    if nb_loc % precond_width == 0:
        w = precond_width
    else:
        # under a mesh nb_loc is the PER-DEVICE block count, so the same
        # args can be viable single-device yet indivisible on the mesh —
        # falling back silently would change convergence without a trace
        import warnings
        warnings.warn(
            f"gp2Scale_precond_width={precond_width} does not divide the "
            f"local block count {nb_loc}; falling back to width-1 "
            "block-Jacobi (choose a width dividing n_blocks/n_devices)",
            stacklevel=2)
        w = 1
    P = w * B
    ng = nb_loc // w
    idxB = i0 + jnp.arange(nb_loc)
    xg = xb[idxB].reshape(ng, P, xb.shape[-1])
    mg = mask[idxB].reshape(ng, P)
    diag_blocks = jax.vmap(
        lambda xx, mm: kernel_fn(xx, xx, hps)
        * (mm[:, None] * mm[None, :]))(xg, mg)
    nvb = noise_local.reshape(ng, P)
    eye = jnp.arange(P)
    diag_blocks = diag_blocks.at[:, eye, eye].add(nvb)
    Lb = jnp.linalg.cholesky(jax.lax.stop_gradient(diag_blocks))
    eyeP = jnp.eye(P, dtype=Lb.dtype)
    Linv = jax.scipy.linalg.solve_triangular(
        Lb, jnp.broadcast_to(eyeP, Lb.shape), lower=True)
    Minv = jnp.einsum("rji,rjk->rik", Linv, Linv,
                      preferred_element_type=Lb.dtype)
    return Minv, Lb


def _freeze_tol_sq(tol, mv_dtype, res_dtype):
    """Squared relative freeze tolerance on rz = Rᵀ M⁻¹ R.

    ``tol`` is the user's relative preconditioned-residual tolerance
    (``sparse_cg_tol``); when None the floor is matched to where extra
    iterations stop improving the LML (measured at the N=50k bench,
    block-Jacobi + Wendland, vs a 128-iteration f32 reference):

    * bf16 tile streaming: rz/rz0 = 2.5e-3 (relative residual 5e-2).
      Measured against tightly-converged references at BOTH bench scales
      (round 4): N=50k vs a 64-iteration f32 run — |dlml| 1.8e-4 rel,
      |dgrad| 0.97e-2 rel, IDENTICAL to the old 4e-4 floor's own bf16
      noise (1.1e-4 / 1.0e-2); N=1M vs a 64-iteration bf16 run —
      |dlml| 2.3e-5, |dgrad| 3.5e-3 vs the old floor's 5.1e-5 / 1.9e-3,
      while the step drops 1.27 -> 1.04 s/eval (−18%; ~4 fewer of ~16
      early-exit iterations).  Loosening further to 1e-2 rz costs real
      gradient accuracy (1.2e-2 rel at N=1M) for only 6% more speed —
      rejected.  The posterior path is NOT governed by this default: the
      committed solver passes its own tighter tolerance explicitly
      (models/gp_kv.py), so user-facing variances keep their floor;
    * f32: rz/rz0 = 1e-8 (relative residual 1e-4) puts the quadratic-term
      error orders below the 16-probe SLQ noise;
    * f64 keeps the near-machine floor (this path feeds oracle tests).
    """
    if tol is not None:
        return float(tol) ** 2
    if mv_dtype is not None and jnp.dtype(mv_dtype).itemsize < 4:
        return 2.5e-3                    # bf16/f16 matvec
    if jnp.dtype(res_dtype) == jnp.float64:
        return 1e-14
    return 1e-8


def _tight_floor_sq(res_dtype):
    """Per-column FREEZE floor (numerical safety only: keeps 1/rz finite
    once a column has fully collapsed).  Distinct from the loop-EXIT
    tolerance: freezing a probe column truncates its Lanczos quadrature
    degree, so individual columns must NOT freeze at the loose exit
    tolerance — measured at the N=50k bench, per-column freezing at the
    bf16 exit floor cost 50x in logdet accuracy (dlml 2.8e-6 -> 1.2e-4)
    because the earliest probes froze at degree ~5."""
    return 1e-14 if jnp.dtype(res_dtype) == jnp.float64 else 1e-10


def _cg_fixed(matvec, Bmat, iters, M=None, tol=None, mv_dtype=None,
              with_iters=False):
    """(Preconditioned) CG, at most ``iters`` trips with EARLY EXIT.

    Only ever called inside a ``custom_vjp`` forward/backward (reverse
    never traces through it), so the loop is a ``lax.while_loop``: it stops
    as soon as every column's preconditioned residual has collapsed below
    the freeze floor, instead of idling through the static safety margin
    (callers size ``iters`` ~2x the observed convergence count).
    ``with_iters=True`` also returns the executed trip count (an int32
    device scalar) — the committed posterior path surfaces it through
    ``kv.last_solve_info`` for preconditioner payoff accounting."""
    if M is None:
        M = lambda X: X                       # noqa: E731
    X = jnp.zeros_like(Bmat)
    R = Bmat
    Zp = M(R)
    P = Zp
    rz = jnp.sum(R * Zp, axis=0)
    # once the residual has collapsed, further updates must be EXACT no-ops:
    # an unguarded 1/rz overflows, and frozen columns must stay frozen
    rz0 = jnp.maximum(rz, jnp.finfo(Bmat.dtype).tiny)
    floor = rz0 * jnp.asarray(_tight_floor_sq(Bmat.dtype), Bmat.dtype)
    exit_floor = rz0 * jnp.asarray(
        _freeze_tol_sq(tol, mv_dtype, Bmat.dtype), Bmat.dtype)

    def cond(carry):
        _, _, _, rz, i = carry
        return jnp.logical_and(i < iters, jnp.any(rz > exit_floor))

    def body(carry):
        X, R, P, rz, i = carry
        active = rz > floor
        Ap = matvec(P)
        pAp = jnp.sum(P * Ap, axis=0)
        alpha = jnp.where(active, rz / jnp.where(active, pAp, 1.0), 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * Ap
        Zn = M(R)
        rz_new = jnp.sum(R * Zn, axis=0)
        beta = jnp.where(active, rz_new / jnp.where(active, rz, 1.0), 0.0)
        P = jnp.where(active[None, :], Zn + beta[None, :] * P, P)
        return (X, R, P, rz_new, i + 1)

    X, _, _, _, it = jax.lax.while_loop(
        cond, body, (X, R, P, rz, jnp.int32(0)))
    return (X, it) if with_iters else X


def _block_apply(mats, X):
    """Batched block-diagonal apply: (nb', w, w) operator blocks on a flat
    (nb'*w, k) X — the preconditioner/Cholesky application shared by the
    mBCG, implicit-CG, and width-grouped paths (one batched matmul;
    triangular solves here were an 11 ms/step hot-loop bottleneck)."""
    Xb = X.reshape(mats.shape[0], mats.shape[1], -1)
    z = jnp.einsum("rij,rjk->rik", mats, Xb,
                   preferred_element_type=X.dtype)
    return z.reshape(mats.shape[0] * mats.shape[1], -1)


def _slq_fixed(matvec, Z, degree):
    """SLQ logdet with static probes Z (n_pad, P) and degree; Rademacher
    probes are zero on padded rows so the estimate covers the logical
    matrix."""
    n_pad, n_probe = Z.shape

    def lanczos(z):
        v = z / jnp.linalg.norm(z)

        # remat: the backward otherwise saves each step's gathered tile
        # blocks ((T, B, k) per Lanczos step — ~17 GB at N=500k), which is
        # THE memory ceiling of the differentiable SLQ.  Recomputing the
        # matvec in the backward costs ~2x SLQ FLOPs and nothing in memory.
        @jax.checkpoint
        def step(carry, _):
            v_prev, v, beta_prev = carry
            w = matvec(v[:, None])[:, 0]
            alpha = jnp.dot(w, v)
            w = w - alpha * v - beta_prev * v_prev
            beta = jnp.linalg.norm(w)
            # breakdown guard in the WORKING dtype: the literal 1e-300
            # underflows to 0.0 in f32, turning an exact Lanczos breakdown
            # (diagonal K+V: w == 0 at step 1) into 0/0 = NaN logdet
            v_next = w / jnp.maximum(beta, jnp.finfo(v.dtype).tiny)
            return (v, v_next, beta), (alpha, beta)

        _, (alphas, betas) = jax.lax.scan(
            step, (jnp.zeros_like(v), v, jnp.zeros((), v.dtype)), None,
            length=degree)
        T = (jnp.diag(alphas) + jnp.diag(betas[:-1], 1)
             + jnp.diag(betas[:-1], -1))
        theta, U = jnp.linalg.eigh(T)
        theta = jnp.maximum(theta, 1e-30)
        tau = U[0, :] ** 2
        return jnp.dot(z, z) * jnp.sum(tau * jnp.log(theta))

    vals = jax.vmap(lanczos, in_axes=1)(Z)
    return jnp.mean(vals), jnp.var(vals) / n_probe


@functools.lru_cache(maxsize=32)
def _mbcg_factory(nb, B, iters, mv_dtype=None, mesh=None, halo_S=None,
                  tol=None):
    """Fused quadratic-term + logdet solver (the BBMM/mBCG recipe,
    Gardner et al. 2018 — the reference has no equivalent: its sparse path
    runs scipy CG and imate SLQ as separate, non-differentiable passes).

    ONE preconditioned CG over the concatenated right-hand sides
    [y-m | L_M·u_1 … L_M·u_P] yields

    * the solve (K+V)⁻¹(y-m) for the quadratic term (column 0), and
    * per-probe Lanczos tridiagonals RECONSTRUCTED FROM THE CG
      COEFFICIENTS (T(i,i) = 1/α_i + β_{i-1}/α_{i-1},
      T(i,i+1) = √β_i/α_i), giving a degree-``iters`` stochastic
      Lanczos quadrature of log|M⁻¹(K+V)| with probes z = L_M u
      (E[zzᵀ] = M makes the estimator unbiased); log|M| is exact from
      the block Cholesky diagonals.

    The tile SpMM is HBM-bandwidth bound, so the extra probe columns ride
    almost free — total tile passes per value+gradient drop from
    ~(cg + slq_fwd + slq_remat + implicit_bwd) to (iters + 2).

    Backward (custom VJP, ZERO extra solves):
      d quad  = -xᵀ d(K+V) x                      (x is already computed)
      d logdet = tr((K+V)⁻¹ d(K+V))
               ≈ (1/P) Σ_j s_jᵀ d(K+V) (M⁻¹z_j)   (s_j = (K+V)⁻¹z_j —
                                                    the probe solves)
    both expressed as one matvec-VJP over the stacked primal/cotangent.
    """

    spmv = _spmv_for(nb, B, mesh, mv_dtype=mv_dtype, halo_S=halo_S)

    def mv(od, X):
        # od = (rows, cols, tiles, noise[, send_sel, send_mask])
        rows_c, cols_c, tiles, noise = od[:4]
        return spmv(rows_c, cols_c, tiles, X, *od[4:]) + noise[:, None] * X

    minv_apply = _block_apply
    lm_apply = _block_apply

    def _pcg_coeffs(od, Minv, RHS):
        """PCG over all RHS columns, recording the CG coefficients.

        EARLY EXIT: this only ever runs inside the custom_vjp forward
        (reverse never traces through it), so the loop is a while_loop that
        stops once EVERY column's preconditioned residual is below the exit
        tolerance — callers size ``iters`` with a ~2x safety margin, and
        the margin iterations cost nothing.  Two distinct thresholds:
        the global EXIT floor (loose, quality-matched to the matvec dtype)
        and the per-column FREEZE floor (tight, numerical safety only) —
        columns must keep iterating until the global exit so their
        Lanczos quadrature degree equals the exit iteration, exactly as in
        a static-length run of that many trips (see ``_tight_floor_sq``).
        The coefficient buffers are pre-filled with the frozen-identity
        values (alpha=1, beta=0: a disconnected identity block appended to
        T, zero e1 weight), so an early exit yields bit-identical
        quadrature inputs to a static run of the same length."""
        X = jnp.zeros_like(RHS)
        R = RHS
        Zp = minv_apply(Minv, R)
        D = Zp
        rz = jnp.sum(R * Zp, axis=0)
        floor = rz * jnp.asarray(_tight_floor_sq(RHS.dtype), RHS.dtype)
        exit_floor = rz * jnp.asarray(
            _freeze_tol_sq(tol, mv_dtype, RHS.dtype), RHS.dtype)
        P_cols = RHS.shape[1]
        alphas0 = jnp.ones((iters, P_cols), RHS.dtype)
        betas0 = jnp.zeros((iters, P_cols), RHS.dtype)

        def cond(carry):
            _, _, _, rz, _, _, i = carry
            return jnp.logical_and(i < iters, jnp.any(rz > exit_floor))

        def body(carry):
            X, R, D, rz, A, Bb, i = carry
            active = rz > floor
            AD = mv(od, D)
            dAd = jnp.sum(D * AD, axis=0)
            alpha = jnp.where(active, rz / jnp.where(active, dAd, 1.0), 0.0)
            X2 = X + D * alpha
            R2 = R - AD * alpha
            Z2 = minv_apply(Minv, R2)
            rz2 = jnp.sum(R2 * Z2, axis=0)
            beta = jnp.where(active, rz2 / jnp.where(active, rz, 1.0), 0.0)
            D2 = Z2 + D * beta
            A = jax.lax.dynamic_update_index_in_dim(
                A, jnp.where(active, alpha, 1.0), i, 0)
            Bb = jax.lax.dynamic_update_index_in_dim(
                Bb, jnp.where(active, beta, 0.0), i, 0)
            return (X2, R2, D2, rz2, A, Bb, i + 1)

        X, _, _, _, alphas, betas, _ = jax.lax.while_loop(
            cond, body, (X, R, D, rz, alphas0, betas0, jnp.int32(0)))
        return X, alphas, betas

    def _t_quadrature(alphas, betas, u_norm2):
        """Per-probe e1-quadrature of log on the CG-coefficient
        tridiagonals.  alphas/betas: (iters, P)."""
        a = alphas.T
        b = betas.T
        P = a.shape[0]
        prev = jnp.concatenate(
            [jnp.zeros((P, 1), a.dtype), b[:, :-1] / a[:, :-1]], axis=1)
        diag = 1.0 / a + prev
        off = jnp.sqrt(jnp.maximum(b[:, :-1], 0.0)) / a[:, :-1]

        def one(d, o, w):
            T = jnp.diag(d) + jnp.diag(o, 1) + jnp.diag(o, -1)
            theta, Uq = jnp.linalg.eigh(T)
            theta = jnp.maximum(theta, 1e-30)
            return w * jnp.sum(Uq[0, :] ** 2 * jnp.log(theta))

        vals = jax.vmap(one)(diag, off, u_norm2)
        return jnp.mean(vals), jnp.var(vals) / P

    @jax.custom_vjp
    def quad_logdet(od, Minv, Lm, ym, U):
        out, _ = _fwd(od, Minv, Lm, ym, U)
        return out

    def _fwd(od, Minv, Lm, ym, U):
        assert Lm.shape == Minv.shape, \
            "mBCG backward substitutes zeros_like(Minv) for Lm's cotangent"
        Z = lm_apply(Lm, U)
        RHS = jnp.concatenate([ym[:, None], Z], axis=1)
        X, alphas, betas = _pcg_coeffs(od, Minv, RHS)
        x = X[:, 0]
        S = X[:, 1:]
        quad = jnp.dot(ym, x)
        u2 = jnp.sum(U * U, axis=0)
        ld_C, ld_var = _t_quadrature(alphas[:, 1:], betas[:, 1:], u2)
        eyeB = jnp.arange(Lm.shape[1])
        ld_M = 2.0 * jnp.sum(jnp.log(Lm[:, eyeB, eyeB]))
        logdet = ld_M + ld_C
        return (quad, logdet, ld_var), (od, Minv, x, S, Z)

    def _bwd_clean(res, cots):
        od, Minv, x, S, Z = res
        qb, lb, _ = cots
        P = S.shape[1]
        MinvZ = minv_apply(Minv, Z)
        Xp = jnp.concatenate([x[:, None], MinvZ], axis=1)
        Cot = jnp.concatenate([(-qb) * x[:, None], (lb / P) * S], axis=1)
        _, vjp_fn = jax.vjp(lambda o: mv(o, Xp), od)
        od_bar, = vjp_fn(Cot)
        ym_bar = (2.0 * qb) * x
        # the second zeros_like(Minv) is the Lm cotangent: Lm is not kept
        # in the residuals (it would pin another (nb, P, P) buffer), and
        # _diag_precond_blocks guarantees Lm.shape == Minv.shape — the
        # forward asserts that so a future shape divergence fails loudly
        # here, not as a custom_vjp structure error
        return (od_bar, jnp.zeros_like(Minv), jnp.zeros_like(Minv),
                ym_bar, jnp.zeros_like(S))

    quad_logdet.defvjp(lambda od, Minv, Lm, ym, U: _fwd(od, Minv, Lm, ym, U),
                       _bwd_clean)
    return quad_logdet


@functools.lru_cache(maxsize=32)
def _implicit_cg_factory(nb, B, iters, precond, mv_dtype=None, mesh=None,
                         halo_S=None, tol=None):
    """CG solve with IMPLICIT differentiation (custom VJP).

    Differentiating through the CG scan stores and replays all ``iters``
    iterations and accumulates a tile-cotangent every step — ~2x iters full
    passes over the tile array in the backward.  The implicit-function
    theorem needs only:  for x = KV⁻¹ b,  x̄_b = KV⁻¹ x̄ (ONE more CG solve)
    and  KV̄ = -x̄_b xᵀ  (one matvec-VJP).  This is the GPyTorch/BBMM
    gradient identity, here as a jax.custom_vjp so the rest of the LML
    stays plain autodiff.

    op_data = (rows, cols, tiles, noise_diag[, Minv][, send_sel, send_mask])
    — Minv (the batched block inverse) only steers the iteration, never the
    solution, so it gets a zero cotangent; the halo-plan arrays are static
    gather indices.
    """

    spmv = _spmv_for(nb, B, mesh, mv_dtype=mv_dtype, halo_S=halo_S)
    n_head = 5 if precond else 4

    def mv(data, X):
        rows, cols, tiles, noise = data[0], data[1], data[2], data[3]
        return spmv(rows, cols, tiles, X, *data[n_head:]) \
            + noise[:, None] * X

    def m_apply(data, X):
        if not precond:
            return X
        # data[4] is the batched explicit block INVERSE: applying it is one
        # batched matmul.  Triangular solves here were the hot-loop
        # bottleneck — sequential over B rows, ~11 ms per CG step vs ~2 ms
        # for the tile matvec itself.
        return _block_apply(data[4], X)

    @jax.custom_vjp
    def solve(op_data, Bv):
        return _cg_fixed(lambda X: mv(op_data, X), Bv, iters,
                         M=lambda X: m_apply(op_data, X), tol=tol,
                         mv_dtype=mv_dtype)

    def solve_fwd(op_data, Bv):
        X = solve(op_data, Bv)
        return X, (op_data, X)

    def solve_bwd(res, Xbar):
        op_data, X = res
        W = _cg_fixed(lambda V: mv(op_data, V), Xbar, iters,
                      M=lambda V: m_apply(op_data, V), tol=tol,
                      mv_dtype=mv_dtype)
        _, vjp_fn = jax.vjp(lambda od: mv(od, X), op_data)
        od_bar = vjp_fn(W)[0]
        od_bar = jax.tree_util.tree_map(
            lambda t: t if t.dtype == jax.dtypes.float0 else -t, od_bar)
        return od_bar, W

    solve.defvjp(solve_fwd, solve_bwd)
    return solve


def make_sparse_lml(kernel_fn, nb, B, *, cg_iters=64, slq_degree=20,
                    with_variance=False, mean_mode="data", prior_mean_fn=None,
                    precondition=True, solver_dtype=None, solver="mbcg",
                    mesh=None, precond_width=1, halo_S=None, cg_tol=None):
    """Build the sparse LML as a pure jittable, differentiable function

        lml(hps, rows, cols, xb, mask, y_pad, ypad_mask, noise_diag_pad, Z
            [, send_sel, send_mask, cols_remap])

    With ``halo_S`` set (mesh path), the ``cols`` positional keeps the
    ORIGINAL block indices (tile ASSEMBLY reads it — a remapped list there
    would silently build kernel tiles for the wrong point-block pairs);
    the REMAPPED column list rides as the LAST trailing halo argument, and
    only the solve-side gather reads it.  An int
    ``halo_S`` takes ``(send_sel, send_mask, cols_remap)``
    (parallel/partition.halo_plan); a ``("hier", S_ici, S_fwd, S_dcn)``
    tuple takes the six ``halo_plan_hier`` plan arrays + cols_remap.  The
    SpMM then ships only referenced non-local column blocks instead of
    all-gathering X (two-stage, DCN-minimal, in the hierarchical case).

    The tile occupancy (rows/cols) is a RUNTIME argument: hyperparameter
    moves that change the support pattern re-run the same compiled program
    as long as the bucket-padded tile count is unchanged — the resolution of
    "dynamic sparsity under jit" (SURVEY.md §7 hard part 1).  Sentinel
    entries (index == nb) contribute nothing: the assembler zeroes their
    tiles via the live mask before the (clamped) scatter.

    y/noise arrive padded to nb*B with a validity mask; padded noise is 1.0
    so K+V stays PD on padded rows, and Rademacher probes are zeroed there,
    so padding contributes log(1) = 0 to the quadrature.

    ``cg_iters`` is a MAXIMUM: the solves run inside custom-VJP bodies, so
    they use ``lax.while_loop`` and EXIT as soon as every column's relative
    preconditioned residual drops below ``cg_tol`` (defaults per dtype in
    ``_freeze_tol_sq``: 1e-4 f32, 1e-7 f64, 5e-2 for bf16 tile streaming —
    each measured to leave LML error at that dtype's own noise floor).
    Size ``cg_iters`` as a safety margin; the margin iterations cost
    nothing.  The mBCG quadrature degree follows the exit point, which ties
    the logdet accuracy to the spectrum's actual difficulty.
    """
    if solver not in ("slq", "mbcg"):
        raise ValueError(f"unknown sparse-LML solver {solver!r}; "
                         "use 'mbcg' (fused, the default — also what the GP "
                         "facade and bench use) or 'slq'")
    n_dev = 1
    if mesh is not None:
        from ..parallel.mesh import tile_device_count
        n_dev = tile_device_count(mesh)
        if n_dev > 1 and nb % n_dev:
            raise ValueError(
                f"make_sparse_lml(mesh=...): nb ({nb}) must be a multiple of "
                f"the mesh size ({n_dev}); pad the point blocking "
                "(make_padded_inputs(..., row_multiple=n_dev))")
    if n_dev <= 1:
        mesh = None
    if mesh is None:
        halo_S = None

    spmv = _spmv_for(nb, B, mesh, mv_dtype=solver_dtype, halo_S=halo_S)

    def _assemble_chunked(hps, rows_c, cols_c, live, xb, mask):
        """Chunked, remat'd assembly (see _assemble_chunked_tiles)."""
        return _assemble_chunked_tiles(kernel_fn, B, solver_dtype, hps,
                                       rows_c, cols_c, live, xb, mask)

    def _diag_precond(hps, xb, mask, noise_local, i0):
        """Block-diagonal preconditioner (see _diag_precond_blocks)."""
        return _diag_precond_blocks(kernel_fn, B, precond_width, hps, xb,
                                    mask, noise_local, i0)

    if mesh is not None:
        from ..parallel.mesh import flat_tile_index, tile_spec
        _ts = lambda k=0: tile_spec(mesh, k)                 # noqa: E731

        # each device assembles its own (row-partitioned) tile shard and
        # factors its own diagonal blocks — zero communication: xb/mask/hps
        # are replicated, the outputs land already row/tile-sharded
        def _local_assemble(hps, rows_c, cols_c, live, xb, mask):
            return _assemble_chunked(hps, rows_c, cols_c, live, xb, mask)

        _assemble = jax.shard_map(
            _local_assemble, mesh=mesh,
            in_specs=(P(None), _ts(), _ts(), _ts(),
                      P(None, None, None), P(None, None)),
            out_specs=_ts(2))

        def _local_precond(hps, xb, mask, noise_local):
            i0 = flat_tile_index(mesh) * (nb // n_dev)
            return _diag_precond(hps, xb, mask, noise_local, i0)

        _precond = jax.shard_map(
            _local_precond, mesh=mesh,
            in_specs=(P(None), P(None, None, None), P(None, None), _ts()),
            out_specs=(_ts(2), _ts(2)))
    else:
        def _assemble(hps, rows_c, cols_c, live, xb, mask):
            return _assemble_chunked(hps, rows_c, cols_c, live, xb, mask)

        def _precond(hps, xb, mask, noise_pad):
            return _diag_precond(hps, xb, mask, noise_pad, 0)

    def lml(hps, rows, cols, xb, mask, y_pad, ypad_mask, noise_diag_pad, Z,
            *halo_args):
        rows_c = jnp.minimum(rows, nb - 1)
        cols_c = jnp.minimum(cols, nb - 1)
        tiles = _assemble(hps, rows_c, cols_c, rows < nb, xb, mask)
        if halo_S is not None:
            # the SpMM reads X through the halo-gather layout; the kernel
            # assembly above keeps the ORIGINAL block indices.  halo_args =
            # plan arrays + cols_remap LAST: (send_sel, send_mask) flat,
            # (sel_ici, m_ici, sel_fwd, m_fwd, fwd_sel, m_dcn) hierarchical
            mv_cols = halo_args[-1]
            halo = halo_args[:-1]
        else:
            mv_cols = cols_c
            halo = ()

        def matvec(X):
            out = spmv(rows_c, mv_cols, tiles, X, *halo)
            return out + noise_diag_pad[:, None] * X

        if solver == "mbcg" or precondition:
            Minv, Lb = _precond(hps, xb, mask, noise_diag_pad)

        n = jnp.sum(ypad_mask)
        if mean_mode == "data":
            m = jnp.sum(y_pad) / n
        else:
            m = prior_mean_fn(hps)
        ym = (y_pad - m) * ypad_mask

        if solver == "mbcg":
            # fused quadratic + logdet: one PCG over [ym | L_M·probes],
            # backward reuses the probe solves (see _mbcg_factory)
            ql = _mbcg_factory(nb, B, cg_iters, mv_dtype=solver_dtype,
                               mesh=mesh, halo_S=halo_S, tol=cg_tol)
            od = (rows_c, mv_cols, tiles, noise_diag_pad) + halo
            quad, logdet, logdet_var = ql(od, Minv, Lb, ym, Z)
            value = -0.5 * (quad + logdet + n * jnp.log(2.0 * jnp.pi))
            if with_variance:
                return value, logdet_var
            return value

        # implicit-VJP CG: the quadratic term's backward is one extra solve
        # + one matvec-VJP instead of 2·cg_iters tile passes
        solve = _implicit_cg_factory(nb, B, cg_iters, precondition,
                                     mv_dtype=solver_dtype, mesh=mesh,
                                     halo_S=halo_S, tol=cg_tol)
        if precondition:
            op_data = (rows_c, mv_cols, tiles, noise_diag_pad, Minv) + halo
        else:
            op_data = (rows_c, mv_cols, tiles, noise_diag_pad) + halo
        alpha = solve(op_data, ym[:, None])[:, 0]
        l1 = jnp.dot(ym, alpha)
        logdet, logdet_var = _slq_fixed(matvec, Z, slq_degree)
        value = -0.5 * (l1 + logdet + n * jnp.log(2.0 * jnp.pi))
        if with_variance:
            return value, logdet_var
        return value

    return lml


def _coarse_inverse(tiles, rows, cols, noise_diag_pad, nb, B, cw):
    """Replicated inverse of the Galerkin coarse matrix A_c = Pᵀ(K+V)P for
    block-constant prolongation P over groups of ``cw`` point blocks
    (ops/precond.build_two_level_op's AMG-class correction, rebuilt
    in-trace from the committed tile set): per-tile sums scatter-added
    into (nbg, nbg), noise group sums on the diagonal, one dense Cholesky
    + explicit inverse.  f32 throughout — the coarse grid only steers the
    CG iteration, never the solution.  Sentinel tiles are zero, so their
    clamped scatter targets contribute nothing."""
    nbg = -(-nb // cw)
    ts = jnp.sum(tiles.astype(jnp.float32), axis=(1, 2))
    gr = jnp.minimum(rows // cw, nbg - 1)
    gc = jnp.minimum(cols // cw, nbg - 1)
    Ac = jnp.zeros((nbg, nbg), jnp.float32).at[gr, gc].add(ts)
    ns = jnp.sum(noise_diag_pad.astype(jnp.float32).reshape(nb, B), axis=1)
    gb = jnp.minimum(jnp.arange(nb) // cw, nbg - 1)
    Ac = Ac.at[gb, gb].add(ns)
    # mirrored tiles make A_c symmetric up to scatter rounding; the tiny
    # relative jitter covers f32 summation loss (PᵀAP of an SPD A is SPD)
    Ac = 0.5 * (Ac + Ac.T)
    eye = jnp.eye(nbg, dtype=jnp.float32)
    L = jnp.linalg.cholesky(Ac + (1e-6 * jnp.mean(jnp.diagonal(Ac))) * eye)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return Linv.T @ Linv


def _two_level_apply(pdata, X, B, cw):
    """M⁻¹X = block-Jacobi smoother + additive coarse correction
    P A_c⁻¹ Pᵀ X (block-constant P over ``cw``-block groups)."""
    Minv, Acinv = pdata
    z = _block_apply(Minv, X)
    nbg = Acinv.shape[0]
    gsz = cw * B
    k = X.shape[1]
    Xp = jnp.pad(X, ((0, nbg * gsz - X.shape[0]), (0, 0)))
    r_c = jnp.sum(Xp.reshape(nbg, gsz, k), axis=1)
    y = (Acinv @ r_c.astype(Acinv.dtype)).astype(X.dtype)
    corr = jnp.broadcast_to(y[:, None, :], (nbg, gsz, k))
    return z + corr.reshape(nbg * gsz, k)[: X.shape[0]]


def _normalize_committed_precond(name):
    n = str(name).lower()
    if n in ("two_level", "twolevel", "two-level") or "amg" in n:
        return "two_level"
    if n in ("block_jacobi", "jacobi", "bj", "diag", "diagonal"):
        return "block_jacobi"
    raise Exception(f"Unknown committed-solver preconditioner: {name!r}. "
                    f"Known: block_jacobi, two_level/amg.")


def make_committed_solver(kernel_fn, nb, B, *, cg_iters=96, solver_dtype=None,
                          precond_width=1, cg_tol=None, fused_spmm=False,
                          mesh=None, halo_S=None,
                          precond_type="block_jacobi", coarse_width=None):
    """Committed-state WIDE solve (K+V)⁻¹ RHS — two jittable programs:

        assemble(hps, rows, cols, xb, mask, noise_diag_pad)
            -> (tiles, pdata)                      # once per committed state
        solve(tiles, pdata, rows, cols, noise_diag_pad, RHS[, *halo])
            -> (X (nb*B, c), iters)                # once per column chunk

    ``precond_type`` selects the CG preconditioner: ``"block_jacobi"``
    (default; pdata = the batched block inverses) or ``"two_level"`` /
    ``"amg"`` (pdata = (block inverses, replicated Galerkin coarse
    inverse) — the AMG-class additive correction of ops/precond, rebuilt
    in-trace; ``coarse_width`` blocks per coarse aggregate, default sized
    so the coarse grid stays ≤ ~4096).  The training step's fused mBCG
    CANNOT use the two-level operator — its quadrature needs probes
    z = L_M·u and an exact log|M|, both of which require a block-diagonal
    M — so this knob exists only where the solve is pure PCG.

    This is the prediction-path analogue of the traced training step: the
    covariance tiles come from the same chunked in-trace assembly at the
    committed hyperparameters, the preconditioner is the same batched
    block-Jacobi/width-grouped factorization, and the solve is the
    early-exit preconditioned CG — no stored K+V object ever materializes
    (the reference keeps a CSR copy and runs scipy CG per right-hand side,
    ref gp_posterior.py:120-136 / gp_lin_alg.py:1184-1291).  The split
    matters for WIDE solves: a 500-column posterior runs as ~9 budgeted
    chunks, and assembling per chunk cost ~7 s of the ~14 s total at N=1M
    — the caller holds (tiles, Minv) device-resident for the committed
    state instead (their bytes are charged to the column budget as fixed
    residents, gp_kv._fast_sparse_solver).

    ``rows``/``cols`` arrive UNCLAMPED (sentinel == nb, bucket padding)
    and ROW-SORTED (the scan-SpMM promises sorted scatter indices).
    Right-hand sides with many columns stream the tiles through
    ``_spmv_scan`` (the flat per-tile product would be tens of GB); narrow
    ones keep the flat path.  ``fused_spmm=True`` runs every matvec through
    the Pallas ``row_block_spmm`` kernel instead; ``solve``'s ``rows`` is
    then the (nb+1,) CSR row offsets (ops/pallas_kernels.row_offsets) of
    the row-sorted schedule.  Padded rows carry unit noise and zero RHS, so
    their solution is exactly zero.

    MESH PATH (``mesh`` with > 1 device): the same collective design as the
    traced training step (the reference's pod-scale serving shape, ref
    jobscript_perlmutter.sl:1-31).  ``rows``/``cols`` must arrive as a
    PARTITIONED schedule (parallel/partition.partition_schedule: device d's
    tiles at positions [d·per, (d+1)·per), row-sorted within each segment).
    Assembly and the preconditioner factor run per-device under shard_map
    (zero communication — xb/mask/hps replicated, outputs land
    tile-sharded); the CG matvec is the row-ownership SpMM of
    ``_spmv_for(nb, B, mesh, halo_S)`` — each device computes its own
    output rows completely, the only collective is the X all-gather (or the
    halo exchange when a ``halo_S`` plan is supplied, in which case
    ``solve``'s ``cols`` is the REMAPPED column list and the plan arrays
    follow RHS).  CG vector updates and the preconditioner apply stay
    row-local; the dot products reduce with one psum each.
    ``fused_spmm`` (the single-device kernel) is mutually exclusive with a
    mesh.
    """
    n_dev = 1
    if mesh is not None:
        from ..parallel.mesh import tile_device_count
        n_dev = tile_device_count(mesh)
    if n_dev <= 1:
        mesh = None
        halo_S = None
    ptype = _normalize_committed_precond(precond_type)
    cw = None
    if ptype == "two_level":
        cw = int(coarse_width) if coarse_width else max(1, -(-nb // 4096))

    def _M_for(pdata):
        if ptype == "two_level":
            return lambda X: _two_level_apply(pdata, X, B, cw)
        return lambda X: _block_apply(pdata, X)

    if mesh is not None:
        if fused_spmm:
            raise ValueError("make_committed_solver: fused_spmm (single-"
                             "device kernel) cannot combine with a mesh")
        if nb % n_dev:
            raise ValueError(
                f"make_committed_solver(mesh=...): nb ({nb}) must be a "
                f"multiple of the mesh size ({n_dev}); pad the point "
                "blocking (make_padded_inputs(..., row_multiple=n_dev))")
        from jax.sharding import PartitionSpec
        from ..parallel.mesh import flat_tile_index, tile_spec
        _ts = lambda k=0: tile_spec(mesh, k)                 # noqa: E731

        def _local_assemble(hps, rows, cols, xb, mask, noise_local):
            rows_c = jnp.minimum(rows, nb - 1)
            cols_c = jnp.minimum(cols, nb - 1)
            live = jnp.logical_and(rows < nb, cols < nb)
            tiles = _assemble_chunked_tiles(kernel_fn, B, solver_dtype, hps,
                                            rows_c, cols_c, live, xb, mask)
            i0 = flat_tile_index(mesh) * (nb // n_dev)
            Minv, _ = _diag_precond_blocks(kernel_fn, B, precond_width, hps,
                                           xb, mask, noise_local, i0)
            return tiles, Minv

        assemble_mesh = jax.shard_map(
            _local_assemble, mesh=mesh,
            in_specs=(PartitionSpec(None), _ts(), _ts(),
                      PartitionSpec(None, None, None),
                      PartitionSpec(None, None), _ts()),
            out_specs=(_ts(2), _ts(2)))

        if ptype == "two_level":
            # the coarse Galerkin inverse is GLOBAL (tile sums reduce over
            # every device's segment) and tiny — build it at the jit level
            # from the sharded tile set; XLA inserts the reduction and
            # replicates the (nbg, nbg) inverse
            _assemble_inner = assemble_mesh

            def assemble_mesh(hps, rows, cols, xb, mask, noise):
                tiles, Minv = _assemble_inner(hps, rows, cols, xb, mask,
                                              noise)
                Acinv = _coarse_inverse(tiles, rows, cols, noise, nb, B, cw)
                return tiles, (Minv, Acinv)

        mesh_spmv = _spmv_for(nb, B, mesh, mv_dtype=solver_dtype,
                              halo_S=halo_S)

        def solve(tiles, pdata, rows, cols, noise_diag_pad, RHS, *halo):
            # no-halo: cols are ORIGINAL block indices (clamp the sentinels
            # — their tiles are zero); halo: cols arrive REMAPPED into the
            # local [W | received] layout, and the plan arrays trail RHS
            mv_cols = cols if halo_S is not None else jnp.minimum(cols,
                                                                  nb - 1)

            def matvec(X):
                out = mesh_spmv(rows, mv_cols, tiles, X, *halo)
                return out + noise_diag_pad[:, None] * X

            return _cg_fixed(matvec, RHS, cg_iters, M=_M_for(pdata),
                             tol=cg_tol, mv_dtype=solver_dtype,
                             with_iters=True)

        return assemble_mesh, solve

    flat_spmv = _spmv_for(nb, B, None, mv_dtype=solver_dtype)

    def assemble(hps, rows, cols, xb, mask, noise_diag_pad):
        rows_c = jnp.minimum(rows, nb - 1)
        cols_c = jnp.minimum(cols, nb - 1)
        # a sentinel in either index marks a padding tile — zero it
        live = jnp.logical_and(rows < nb, cols < nb)
        tiles = _assemble_chunked_tiles(kernel_fn, B, solver_dtype, hps,
                                        rows_c, cols_c, live, xb, mask)
        Minv, _ = _diag_precond_blocks(kernel_fn, B, precond_width, hps,
                                       xb, mask, noise_diag_pad, 0)
        if ptype == "two_level":
            Acinv = _coarse_inverse(tiles, rows, cols, noise_diag_pad,
                                    nb, B, cw)
            return tiles, (Minv, Acinv)
        return tiles, Minv

    def solve(tiles, pdata, rows, cols, noise_diag_pad, RHS):
        # fused_spmm: ``rows`` is the (nb+1,) CSR row offsets of the
        # row-sorted schedule; otherwise the per-tile row list
        if fused_spmm and RHS.dtype == jnp.float64:
            raise ValueError(
                "make_committed_solver(fused_spmm=True): the kernel "
                "accumulates in f32 — f64 (direct-semantics) solves must "
                "keep fused_spmm=False so the scan path preserves full "
                "precision")
        cols_c = jnp.minimum(cols, nb - 1)
        c = RHS.shape[1]
        T = int(cols.shape[0])
        acc_bytes = 8 if RHS.dtype == jnp.float64 else 4
        wide = T * B * c * acc_bytes * 2 > _SPMV_FLAT_BUDGET

        def matvec(X):
            if fused_spmm:
                from .pallas_kernels import row_block_spmm
                out = row_block_spmm(rows, cols, tiles, X, nb, B,
                                     mv_dtype=solver_dtype)
            elif wide:
                rows_c = jnp.minimum(rows, nb - 1)
                out = _spmv_scan(rows_c, cols_c, tiles, X, nb, B,
                                 mv_dtype=solver_dtype)
            else:
                rows_c = jnp.minimum(rows, nb - 1)
                out = flat_spmv(rows_c, cols_c, tiles, X)
            return out + noise_diag_pad[:, None] * X

        return _cg_fixed(matvec, RHS, cg_iters, M=_M_for(pdata),
                         tol=cg_tol, mv_dtype=solver_dtype,
                         with_iters=True)

    return assemble, solve


# flat-SpMM budget for the committed solver's per-tile product (bytes)
_SPMV_FLAT_BUDGET = 2 << 30


def make_padded_inputs(x, y, noise_diag, block_size, dtype=jnp.float32,
                       row_multiple=1):
    """Host helper: pad (x, y, noise) to full blocks and build masks.
    Padded noise diagonal is 1.0 (keeps K+V PD on padded rows).
    ``row_multiple`` rounds the block count up (empty trailing blocks) so a
    row-partitioned mesh divides the blocking evenly."""
    import numpy as np
    n, d = x.shape
    nb = -(-n // block_size)
    nb = -(-nb // row_multiple) * row_multiple
    n_pad = nb * block_size
    xb = np.zeros((n_pad, d))
    xb[:n] = x
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    y_pad = np.zeros(n_pad)
    y_pad[:n] = y
    noise_pad = np.ones(n_pad)
    noise_pad[:n] = noise_diag
    return (jnp.asarray(xb.reshape(nb, block_size, d), dtype),
            jnp.asarray(mask.reshape(nb, block_size), dtype),
            jnp.asarray(y_pad, dtype),
            jnp.asarray(mask, dtype),
            jnp.asarray(noise_pad, dtype))
