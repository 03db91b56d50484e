"""Distributed block-sparse covariance assembly — the gp2Scale engine.

Reference behavior replaced: /root/reference/fvgp/gp2Scale_covariance.py
(Dask blockwise/rowwise task fan-out, host COO assembly, int32 downcast,
upper-triangle scheduling with host mirroring).

Accelerator-first pipeline:

1. *Structure* (host, numpy, cheap): points are tiled into fixed blocks of
   ``block_size`` consecutive indices.  Candidate tile pairs are pruned by
   bounding-box distance in whitened coordinates — the reference's
   support-aware early-out (kernels.py:649-655) lifted from point level to
   tile level so device shapes stay static.  The pair count is padded to a
   bucket size so jit caches survive hyperparameter moves that change the
   occupancy ("dynamic sparsity under jit", SURVEY.md §7 hard part 1).
2. *Tiles* (device, batched): one vmapped kernel evaluation computes a chunk
   of tiles at a time — each tile a (B, B) kernel block on the device.  For the
   symmetric prior covariance only the upper triangle is scheduled (half the
   kernel FLOPs, like ref gp2Scale_covariance.py:278-287) and the mirror is
   a device transpose, not a host pass.
3. *Sharding*: the tile list is placed over the device mesh; the SpMM in
   BlockSparseMatrix then runs as a distributed batched matmul with an XLA
   all-reduce over ICI.

Host (non-traceable) kernels take the same path with the tile loop on the
host — the contract the reference supports for arbitrary user kernels.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..kernels import wendland_anisotropic
from .block_sparse import BlockSparseMatrix
from .mesh import current_mesh, shard_tiles

# deduplicate THIS package's repeated warnings without rewriting the
# process-global filter (a bare simplefilter('once', UserWarning) at
# import time silently suppressed the user's own repeated UserWarnings)
warnings.filterwarnings("once", category=UserWarning,
                        module=r"fvgp_tpu(\..*)?")


# ---------------------------------------------------------------------------
# structure discovery (host)
# ---------------------------------------------------------------------------

def _candidate_pairs(x1, x2, lengthscales, radius, block_size, symmetric):
    """Tile pairs whose whitened bounding boxes are within the support
    radius.  Bounds and the symmetric prune come from ``fvgp_tpu.native``
    (C++ when built, its own numpy fallback otherwise — ONE implementation
    to fix); only the rectangular cross-covariance scan lives here, since
    the native pruner is symmetric/upper-triangle-only."""
    from ..native import block_bounds, candidate_pairs
    if lengthscales is not None:
        x1 = x1 / lengthscales
        x2 = x2 if x2 is None else x2 / lengthscales
    if symmetric and np.isfinite(radius):
        lo1, hi1 = block_bounds(x1, block_size)
        return candidate_pairs(lo1, hi1, radius)
    lo1, hi1 = block_bounds(x1, block_size)
    if symmetric:
        lo2, hi2 = lo1, hi1
    else:
        lo2, hi2 = block_bounds(x2, block_size)
    # box-to-box gap per dimension: max(lo2-hi1, lo1-hi2, 0)
    gap = np.maximum(lo2[None, :, :] - hi1[:, None, :],
                     lo1[:, None, :] - hi2[None, :, :])
    gap = np.maximum(gap, 0.0)
    dist2 = np.sum(gap ** 2, axis=-1)
    keep = dist2 <= radius ** 2
    if symmetric:
        keep = np.triu(keep)            # upper triangle only
    rows, cols = np.nonzero(keep)
    return rows.astype(np.int32), cols.astype(np.int32)


def _bucket(n, multiple=64):
    """Round a tile count up so jit caches survive occupancy changes:
    next multiple of max(64, n/8)."""
    if n <= multiple:
        return multiple
    step = max(multiple, 1 << (int(n - 1).bit_length() - 3))
    return -(-n // step) * step


def support_geometry(prior, hyperparameters, args):
    """(lengthscales, radius) for the bounding-box prune, or (None, inf).

    Known compact-support kernels (the Wendland family) imply radius 1 in
    coordinates whitened by hps[1:].  User kernels declare their support via
    ``args['gp2Scale_lengthscales']`` (callable hps -> per-dim scales) and
    ``args['gp2Scale_support_radius']`` (whitened radius, default 1.0).
    Without a declaration all tiles are computed (dense blocks) — correct but
    unpruned, with a one-time warning.
    """
    hps = np.asarray(hyperparameters, dtype=np.float64)
    ls_fn = args.get("gp2Scale_lengthscales", None)
    if callable(ls_fn):
        return np.asarray(ls_fn(hps)), float(args.get("gp2Scale_support_radius", 1.0))
    kern = getattr(prior, "kernel", None)
    if kern is wendland_anisotropic or getattr(kern, "__name__", "") in (
            "wendland_anisotropic", "wendland_anisotropic_gp2Scale_cpu",
            "wendland_anisotropic_gp2Scale_gpu"):
        return hps[1:], 1.0
    warnings.warn(
        "gp2Scale: the kernel's support is unknown, so no tile pruning is "
        "possible and every covariance tile will be computed. Declare the "
        "support via args['gp2Scale_lengthscales'] (callable hps -> scales) "
        "and args['gp2Scale_support_radius'] to enable sparsity.")
    return None, np.inf


# ---------------------------------------------------------------------------
# tile evaluation (device)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("kernel_fn", "block_size"))
def _compute_tiles(kernel_fn, x1b, x2b, mask1, mask2, rows, cols, hps,
                   block_size):
    """Batched tile evaluation: tiles[t] = k(x1 block rows[t], x2 block
    cols[t]) with padded points masked to zero."""

    def one(i, j):
        a = x1b[i]
        b = x2b[j]
        K = kernel_fn(a, b, hps)
        return K * (mask1[i][:, None] * mask2[j][None, :])

    return jax.vmap(one)(rows, cols)


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_tile_chunk(buf, part, start):
    """In-place (donated) write of an assembled tile chunk into the final
    buffer — keeps construction peak memory at one tile set + one chunk."""
    return jax.lax.dynamic_update_slice(buf, part.astype(buf.dtype),
                                        (start, 0, 0))


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_tile_chunk(buf, part, dest):
    """Scattered (donated) chunk write for the row-partitioned layout —
    destination positions are arbitrary; out-of-range entries (sentinel
    padding lanes) are dropped."""
    return buf.at[dest].set(part.astype(buf.dtype), mode="drop")


@functools.partial(jax.jit, donate_argnums=(0,))
def _mirror_tile_chunk(buf, src, dest):
    """Gather already-written tiles at ``src``, transpose, scatter at
    ``dest`` (the mirror of the upper triangle).  SSA semantics make the
    gather read pre-scatter values even with buffer donation."""
    g = jnp.swapaxes(buf[src], 1, 2)
    return buf.at[dest].set(g, mode="drop")


@functools.partial(jax.jit, static_argnames=("kernel_fn", "block_size"))
def _tile_live(kernel_fn, x1b, x2b, mask1, mask2, rows, cols, hps,
               block_size):
    """Per-tile liveness (max|k| > 0) without retaining the tiles — the
    zero-tile filter's cheap first pass."""

    def one(i, j):
        K = kernel_fn(x1b[i], x2b[j], hps)
        K = K * (mask1[i][:, None] * mask2[j][None, :])
        return jnp.max(jnp.abs(K)) > 0

    return jax.vmap(one)(rows, cols)


def _blocks_device(x, block_size, dtype):
    n, d = np.asarray(x).shape
    nb = -(-n // block_size)
    n_pad = nb * block_size
    xp = np.zeros((n_pad, d))
    xp[:n] = x
    mask = np.zeros((n_pad,), dtype=bool)
    mask[:n] = True
    xb = jnp.asarray(xp.reshape(nb, block_size, d), dtype=dtype)
    mb = jnp.asarray(mask.reshape(nb, block_size), dtype=dtype)
    return xb, mb


def _stable_kernel_closure(prior):
    """A per-prior cached 3-arg kernel closure — a fresh lambda per call
    would defeat the jit cache keyed on the (static) kernel argument.

    4-arg kernels close over the prior's CURRENT args dict; the cache is
    keyed on that dict's identity so ``set_args()`` (which rebinds
    ``data.args`` to a new dict, gp.py) takes effect on the next assembly
    instead of the closure silently serving the stale dict forever."""
    cached = getattr(prior, "_gp2_kernel_closure", None)
    if prior.k_n_params == 4:
        a_dict = prior.args
        if cached is not None and cached[0] is a_dict:
            return cached[1]
        kernel = prior.kernel

        def kern_fn(a, b, h):
            return kernel(a, b, h, a_dict)

        prior._gp2_kernel_closure = (a_dict, kern_fn)
        return kern_fn
    if cached is not None and cached[0] is None:
        return cached[1]
    prior._gp2_kernel_closure = (None, prior.kernel)
    return prior.kernel


def distributed_covariance(prior, x1, x2, hyperparameters, *, batch_size=10000,
                           symmetric=False, distribution="blockwise",
                           args=None):
    """Assemble k(x1, x2) as a sharded BlockSparseMatrix
    (replaces ref gp2Scale_covariance.py:230).

    ``distribution`` exists for reference parity: the reference's
    blockwise (host-mirrored upper triangle) and rowwise (CSR strips)
    schedules are two host-memory workarounds for the same product, and
    both map onto the ONE device engine here (tiles mirrored on device;
    test_rowwise_matches_blockwise).  Unknown values are rejected rather
    than silently ignored."""
    if distribution not in ("blockwise", "rowwise"):
        raise ValueError(f"unknown gp2Scale distribution {distribution!r}; "
                         "'blockwise' and 'rowwise' map to the same device "
                         "engine")
    args = args or {}
    non_euclidean = isinstance(x1, list) or isinstance(x2, list)
    if non_euclidean:
        # arbitrary-object points (the reference's contract, ref
        # tests/test_fvgp.py:5462-5566): the kernel is a host callable, so
        # tiles are evaluated in the host tile loop below.  No geometric
        # prune exists for opaque objects — every tile pair is scheduled
        # and the exact zero-tile filter drops the dead ones afterwards.
        x2 = x1 if symmetric else x2
    else:
        x1 = np.asarray(x1, dtype=np.float64)
        x2 = x1 if symmetric else np.asarray(x2, dtype=np.float64)
    block_size = int(args.get("gp2Scale_block_size",
                               min(int(batch_size), 256)))
    dtype = config.linalg_dtype(args)

    if non_euclidean:
        lengthscales, radius = None, np.inf
        nb1_s = -(-len(x1) // block_size)
        nb2_s = nb1_s if symmetric else -(-len(x2) // block_size)
        ii, jj = np.meshgrid(np.arange(nb1_s), np.arange(nb2_s),
                             indexing="ij")
        keep = ii <= jj if symmetric else np.ones_like(ii, dtype=bool)
        rows = ii[keep].astype(np.int32)
        cols = jj[keep].astype(np.int32)
    else:
        lengthscales, radius = support_geometry(prior, hyperparameters, args)
        rows, cols = _candidate_pairs(x1, None if symmetric else x2,
                                      lengthscales, radius, block_size,
                                      symmetric)

    nb1 = -(-len(x1) // block_size)
    nb2 = -(-len(x2) // block_size)
    n_sched = len(rows)

    # the box prune is loose (boxes overlap even when no point pair is
    # inside the support): one maxabs pass per chunk drops the exact-zero
    # tiles BEFORE they are retained, so they never occupy HBM and never
    # ride along in downstream solves/posteriors
    do_filter = (bool(args.get("gp2Scale_tile_filter", True))
                 and np.isfinite(radius))
    # storage dtype (e.g. "bfloat16"): halves tile HBM at assembly time —
    # the construction memory ceiling at N~1M on one chip.  Opt-in; meant
    # for the stochastic MCMC/BO training regime like the solver dtype.
    storage_dtype = args.get("gp2Scale_storage_dtype", None)
    if isinstance(storage_dtype, str):
        storage_dtype = jnp.dtype(storage_dtype)

    # evaluate scheduled tiles
    if prior.kernel_traceable:
        x1b, m1 = _blocks_device(x1, block_size, dtype)
        if symmetric:
            x2b, m2 = x1b, m1
        else:
            x2b, m2 = _blocks_device(x2, block_size, dtype)
        hps = jnp.asarray(np.asarray(hyperparameters), dtype=dtype)
        kern_fn = _stable_kernel_closure(prior)
        # fixed-size chunks, sentinel-padded: every call compiles the same
        # program regardless of how the occupancy moved with the
        # hyperparameters ("dynamic sparsity under jit", SURVEY.md §7)
        chunk = int(args.get("gp2Scale_tile_chunk", 512))
        chunk = min(chunk, _bucket(max(n_sched, 1)))

        def _sched_chunks(r_arr, c_arr, count):
            n_chunks = max(-(-count // chunk), 1)
            rp = np.full(n_chunks * chunk, nb1, np.int32)
            cp = np.full(n_chunks * chunk, nb2, np.int32)
            rp[:count] = r_arr
            cp[:count] = c_arr
            return rp, cp, n_chunks

        if do_filter and n_sched:
            # pass 1: per-tile liveness only, so zero tiles never occupy
            # HBM.  Symmetric priors use the exact geometric test in the
            # native C++ runtime (a tile is live iff some point pair sits
            # inside the support radius — equivalent to max|k| > 0 for
            # compactly supported kernels, and the device stays free);
            # rectangular blocks fall back to a device assembly pass with
            # fixed shapes (no varying-shape gather -> no per-chunk
            # recompile).
            if symmetric and lengthscales is not None:
                from ..native import tile_live
                keep = tile_live(x1 / lengthscales, rows, cols, block_size,
                                 radius)
            else:
                rp, cp, nch = _sched_chunks(rows, cols, n_sched)
                live_parts = []
                for s in range(0, nch * chunk, chunk):
                    r_c = jnp.asarray(np.minimum(rp[s:s + chunk], nb1 - 1))
                    c_c = jnp.asarray(np.minimum(cp[s:s + chunk], nb2 - 1))
                    live_parts.append(_tile_live(kern_fn, x1b, x2b, m1, m2,
                                                 r_c, c_c, hps, block_size))
                keep = np.concatenate(
                    [np.asarray(p) for p in live_parts])[:n_sched]
            rows = rows[keep]
            cols = cols[keep]
            n_sched = len(rows)

        # pass 2 (or the only pass): assemble the scheduled tiles in
        # fixed-size sentinel-padded chunks — every call compiles the same
        # program regardless of how the occupancy moved ("dynamic sparsity
        # under jit", SURVEY.md §7).  Chunks are written STRAIGHT into the
        # final bucket-padded tile buffer with buffer donation — the old
        # concatenate-then-mirror-then-pad pipeline held 2x the tile set
        # live at its peak, which is the whole HBM budget at N ~ 1M.
        if symmetric:
            off_idx = np.nonzero(rows < cols)[0]
        else:
            off_idx = np.empty(0, dtype=np.int64)
        total = n_sched + len(off_idx)
        mesh = current_mesh()
        n_dev = 1
        if mesh is not None:
            n_dev = int(np.prod(list(mesh.shape.values())))
        if n_dev > 1:
            # row-affinity layout: device d's (position-sharded) segment
            # holds exactly the tiles whose row block lies in its contiguous
            # range (parallel/partition.py) — the SpMM output then needs no
            # cross-device reduction and per-device work is balanced by
            # construction.  Tiles are written straight to their final
            # (scattered) positions with buffer donation, so peak memory
            # stays one tile set + one chunk.
            from .partition import partition_schedule, schedule_stats
            rows_all = np.concatenate([rows, cols[off_idx]]).astype(np.int32)
            cols_all = np.concatenate([cols, rows[off_idx]]).astype(np.int32)
            nb_local = -(-nb1 // n_dev)
            if total:
                cnt = np.bincount(
                    np.minimum(rows_all // nb_local, n_dev - 1),
                    minlength=n_dev)
                pad_to = _bucket(int(cnt.max()))
            else:
                pad_to = _bucket(1)
            rows_final, cols_final, perm, per_dev = partition_schedule(
                rows_all, cols_all, nb1, n_dev, pad_to=pad_to)
            cols_final[perm < 0] = nb2
            padded = per_dev * n_dev
            dest = np.empty(total, np.int64)
            live_out = np.nonzero(perm >= 0)[0]
            dest[perm[live_out]] = live_out

            buf = jnp.zeros((padded, block_size, block_size),
                            storage_dtype or dtype)
            rp, cp, nch = _sched_chunks(rows, cols, n_sched)
            dest_sched = np.full(nch * chunk, padded, np.int64)
            dest_sched[:n_sched] = dest[:n_sched]
            for st in range(0, nch * chunk, chunk):
                c = jnp.asarray(np.minimum(cp[st:st + chunk], nb2 - 1))
                r_c = jnp.asarray(np.minimum(rp[st:st + chunk], nb1 - 1))
                part = _compute_tiles(kern_fn, x1b, x2b, m1, m2,
                                      r_c, c, hps, block_size)
                if st + chunk > n_sched:
                    alive = np.arange(st, st + chunk) < n_sched
                    part = part * jnp.asarray(alive, part.dtype)[:, None, None]
                buf = _scatter_tile_chunk(
                    buf, part, jnp.asarray(dest_sched[st:st + chunk]))
            for st in range(0, len(off_idx), chunk):
                sel = off_idx[st:st + chunk]
                src = dest[sel]
                dst = dest[n_sched + st:n_sched + st + len(sel)]
                if len(sel) < chunk:
                    pad_n = chunk - len(sel)
                    src = np.concatenate([src, np.zeros(pad_n, src.dtype)])
                    dst = np.concatenate([dst, np.full(pad_n, padded,
                                                       dst.dtype)])
                buf = _mirror_tile_chunk(buf, jnp.asarray(src),
                                         jnp.asarray(dst))
            result = BlockSparseMatrix(
                len(x1), len(x2), block_size, rows_final, cols_final, buf,
                live_tiles=int(np.sum(np.asarray(rows_final) < nb1)))
            shard_tiles(result, mesh)
            import logging

            from ..utils.logging import logger
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug("covariance assembled: %d/%d tiles scheduled, "
                             "block %d, fill %.4f, row-partitioned over %d "
                             "devices: %s", total, nb1 * nb2, block_size,
                             result.sparsity(),
                             n_dev, schedule_stats(rows_final, cols_final,
                                                   nb1, n_dev, block_size))
            return result
        padded = _bucket(max(total, 1))
        # every chunk write must FIT: dynamic_update_slice clamps start
        # indices, so an out-of-range write would silently land at the
        # wrong offset and corrupt earlier tiles
        n_mirror_chunks = -(-len(off_idx) // chunk) if len(off_idx) else 0
        nch_main = max(-(-n_sched // chunk), 1)
        padded = max(padded, nch_main * chunk,
                     n_sched + n_mirror_chunks * chunk)
        padded = -(-padded // n_dev) * n_dev
        rows_final = np.full(padded, nb1, np.int32)
        cols_final = np.full(padded, nb2, np.int32)
        rows_final[:n_sched] = rows
        cols_final[:n_sched] = cols
        rows_final[n_sched:total] = cols[off_idx]
        cols_final[n_sched:total] = rows[off_idx]

        buf = jnp.zeros((padded, block_size, block_size),
                        storage_dtype or dtype)
        rp, cp, nch = _sched_chunks(rows, cols, n_sched)
        for st in range(0, nch * chunk, chunk):
            # sentinel indices clamp in the gather; the clamped block's
            # garbage values are masked to zero before the write so the
            # padding region stays exactly zero (fingerprints read it)
            c = jnp.asarray(np.minimum(cp[st:st + chunk], nb2 - 1))
            r_c = jnp.asarray(np.minimum(rp[st:st + chunk], nb1 - 1))
            part = _compute_tiles(kern_fn, x1b, x2b, m1, m2,
                                  r_c, c, hps, block_size)
            if st + chunk > n_sched:
                live = np.arange(st, st + chunk) < n_sched
                part = part * jnp.asarray(live, part.dtype)[:, None, None]
            buf = _write_tile_chunk(buf, part, st)
        # mirror the off-diagonal tiles by a chunked device transpose
        for st in range(0, len(off_idx), chunk):
            idx = off_idx[st:st + chunk]
            real = len(idx)
            if real < chunk:
                idx = np.concatenate([idx, np.zeros(chunk - real, idx.dtype)])
            g = jnp.swapaxes(buf[jnp.asarray(idx)], 1, 2)
            if real < chunk:
                live = np.arange(chunk) < real
                g = g * jnp.asarray(live, g.dtype)[:, None, None]
            buf = _write_tile_chunk(buf, g, n_sched + st)
        result = BlockSparseMatrix(
            len(x1), len(x2), block_size, rows_final, cols_final, buf,
            live_tiles=int(np.sum(np.asarray(rows_final) < nb1)))
        shard_tiles(result, mesh)
        from ..utils.logging import logger
        logger.debug("covariance assembled: %d/%d tiles scheduled, block %d, "
                     "fill %.4f, %s", total, nb1 * nb2, block_size,
                     result.sparsity(),
                     "sharded" if n_dev > 1 else "single-device")
        return result
    else:
        # host kernel: the reference's arbitrary-kernel contract
        tiles_np = np.zeros((n_sched, block_size, block_size))
        hps_np = np.asarray(hyperparameters)
        for t in range(n_sched):
            i, j = int(rows[t]), int(cols[t])
            a = x1[i * block_size:(i + 1) * block_size]
            b = x2[j * block_size:(j + 1) * block_size]
            blk = prior.compute_covariances(a, b, hps_np)
            tiles_np[t, :blk.shape[0], :blk.shape[1]] = np.asarray(blk)
        # the tiles are already materialized here, so the exact zero-tile
        # filter costs one host reduction even without a known support radius
        if bool(args.get("gp2Scale_tile_filter", True)) and n_sched:
            keep = np.abs(tiles_np).max(axis=(1, 2)) > 0
            rows = rows[keep]
            cols = cols[keep]
            tiles_np = tiles_np[keep]
            n_sched = len(rows)
        tiles = jnp.asarray(tiles_np, dtype=storage_dtype or dtype)

    # ---- host-kernel tail: mirror + pad (small-N regime) -----------------
    if symmetric:
        # upper triangle scheduled; mirror below via a device transpose
        off_diag = rows < cols
        total = n_sched + int(np.sum(off_diag))
    else:
        total = n_sched

    if symmetric and np.any(off_diag):
        rows_m = cols[off_diag]
        cols_m = rows[off_diag]
        tiles_m = jnp.swapaxes(tiles[jnp.asarray(np.nonzero(off_diag)[0])], 1, 2)
        rows = np.concatenate([rows, rows_m])
        cols = np.concatenate([cols, cols_m])
        tiles = jnp.concatenate([tiles, tiles_m])

    # bucket-pad with sentinel tiles (rows == cols == nb -> dropped by
    # segment_sum, clamped-but-zero in gathers)
    mesh = current_mesh()
    n_dev = 1
    if mesh is not None:
        n_dev = int(np.prod(list(mesh.shape.values())))
    if n_dev > 1 and total:
        # row-affinity layout (see the device path above): position-sharded
        # segments coincide with contiguous row-block ownership.  The
        # per-device count is bucket-padded INSIDE the partition so segment
        # boundaries stay aligned with ownership.
        from .partition import partition_schedule
        nb_local = -(-nb1 // n_dev)
        cnt = np.bincount(np.minimum(np.asarray(rows) // nb_local, n_dev - 1),
                          minlength=n_dev)
        rows_p, cols_p, perm, _ = partition_schedule(
            np.asarray(rows), np.asarray(cols), nb1, n_dev,
            pad_to=_bucket(int(cnt.max())))
        cols_p[perm < 0] = nb2
        safe = np.where(perm >= 0, perm, 0)
        tiles = tiles[jnp.asarray(safe)] * jnp.asarray(
            perm >= 0, tiles.dtype)[:, None, None]
        rows, cols = rows_p, cols_p
    else:
        padded = _bucket(max(total, 1))
        if padded > total:
            pad = padded - total
            rows = np.concatenate([rows, np.full(pad, nb1, np.int32)])
            cols = np.concatenate([cols, np.full(pad, nb2, np.int32)])
            tiles = jnp.concatenate(
                [tiles, jnp.zeros((pad, block_size, block_size), tiles.dtype)])

    result = BlockSparseMatrix(len(x1), len(x2), block_size, rows, cols,
                               tiles,
                               live_tiles=int(np.sum(np.asarray(rows) < nb1)))
    shard_tiles(result, mesh)
    # assembly report (the reference's timer + sparsity line,
    # gp2Scale_covariance.py:295-307)
    from ..utils.logging import logger
    logger.debug("covariance assembled: %d/%d tiles scheduled, block %d, "
                 "fill %.4f, %s", total, nb1 * nb2, block_size,
                 result.sparsity(), "sharded" if n_dev > 1 else "single-device")
    return result


# ---------------------------------------------------------------------------
# Host-side worker equivalents (power-user surface of the reference's Dask
# engine, ref gp2Scale_covariance.py:41-224).  The device engine above never
# calls these — tiles are assembled on device — but the reference unit-tests
# and exposes them (ref tests/test_fvgp.py:3148-3265), and they remain the
# right tool when a user wants a scipy CSR covariance on the host (e.g. to
# feed an external solver).  numpy/scipy in, numpy/scipy out.
# ---------------------------------------------------------------------------

def ranges(N, nb):
    """``nb`` near-equal ``(start, end)`` index windows covering ``range(N)``
    (ref gp2Scale_covariance.py:41)."""
    nb = max(int(nb), 1)
    cuts = [round(N * i / nb) for i in range(nb + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def num_blocks(n, batch_size):
    """Chunk count at ``batch_size`` points per chunk
    (ref gp2Scale_covariance.py:48)."""
    return max(1, int(n) // int(batch_size))


def index_dtype_for(n1, n2):
    """int32 COO indices whenever they fit — half the index bytes
    (ref gp2Scale_covariance.py:53)."""
    return np.int32 if max(int(n1), int(n2)) < 2 ** 31 else np.int64


def evaluate_kernel(kernel, x1, x2, hyperparameters, k_n_params, args):
    """Arity-dispatching kernel call — 3-arg ``k(x1,x2,hps)`` or 4-arg
    ``k(x1,x2,hps,args)`` (ref gp2Scale_covariance.py:66)."""
    if k_n_params == 3:
        return kernel(x1, x2, hyperparameters)
    if k_n_params == 4:
        return kernel(x1, x2, hyperparameters, args)
    raise Exception("No valid kernel function signature")


def block_to_coo(k, index_dtype=np.int32):
    """One kernel block as ``(data, rows, cols)`` in block-local coordinates
    (ref gp2Scale_covariance.py:82).  Support-aware kernels that already
    return a scipy.sparse block pass through without densifying."""
    from scipy import sparse as _sp
    if _sp.issparse(k):
        coo = k.tocoo()
        return (coo.data, coo.row.astype(index_dtype, copy=False),
                coo.col.astype(index_dtype, copy=False))
    k = np.asarray(k)
    nz = np.nonzero(k)
    return (k[nz], nz[0].astype(index_dtype, copy=False),
            nz[1].astype(index_dtype, copy=False))


def block_triplets(range_ij, x1, x2, hyperparameters, kernel,
                   k_n_params, args, symmetric, index_dtype=np.int32):
    """Global-coordinate COO triplets for one (row-window, col-window) block
    (ref gp2Scale_covariance.py:97).  Diagonal-straddling blocks of a
    symmetric matrix report only their upper triangle — the assembler
    mirrors (half the kernel FLOPs, same contract as the device engine)."""
    (i0, i1), (j0, j1) = range_ij
    block = evaluate_kernel(kernel, x1[i0:i1], x2[j0:j1],
                            hyperparameters, k_n_params, args)
    data, r, c = block_to_coo(block, index_dtype)
    if symmetric and i0 == j0 and data.size:
        upper = r <= c
        data, r, c = data[upper], r[upper], c[upper]
    return data, r + index_dtype(i0), c + index_dtype(j0)


def row_strip_csr(range_i, x1, x2, hyperparameters, kernel,
                  k_n_params, args, n2, col_batch_size,
                  index_dtype=np.int32):
    """``(first_row, csr_strip)`` for one row window, evaluated in column
    chunks so peak memory is one dense block (ref gp2Scale_covariance.py:119,
    the ``rowwise`` distribution mode)."""
    from scipy import sparse as _sp
    i0, i1 = range_i
    xi = x1[i0:i1]
    triplets = []
    for j0, j1 in ranges(n2, num_blocks(n2, col_batch_size)):
        block = evaluate_kernel(kernel, xi, x2[j0:j1],
                                hyperparameters, k_n_params, args)
        data, r, c = block_to_coo(block, index_dtype)
        if data.size:
            triplets.append((data, r, c + index_dtype(j0)))
    shape = (i1 - i0, int(n2))
    if not triplets:
        return i0, _sp.csr_matrix(shape)
    strip = _sp.coo_matrix(
        (np.concatenate([t[0] for t in triplets]),
         (np.concatenate([t[1] for t in triplets]),
          np.concatenate([t[2] for t in triplets]))), shape=shape)
    return i0, strip.tocsr()


def assemble_triplets(harvest, n1, n2, symmetric, index_dtype=np.int32):
    """Global CSR from harvested triplet parts, single allocation, mirroring
    the off-diagonal entries of a symmetric matrix in the same pass
    (ref gp2Scale_covariance.py:169 — avoids the 3-4x peak of stacked
    hstacks)."""
    from scipy import sparse as _sp
    parts = [(d, r, c) for d, r, c in harvest if d.size]
    if not parts:
        return _sp.csr_matrix((int(n1), int(n2)))
    sizes = []
    for d, r, c in parts:
        extra = int(np.count_nonzero(r != c)) if symmetric else 0
        sizes.append(d.size + extra)
    total = int(np.sum(sizes))
    val = np.empty(total, dtype=np.result_type(*[d.dtype for d, _, _ in parts]))
    ri = np.empty(total, dtype=index_dtype)
    ci = np.empty(total, dtype=index_dtype)
    at = 0
    while parts:
        d, r, c = parts.pop()
        val[at:at + d.size], ri[at:at + d.size], ci[at:at + d.size] = d, r, c
        at += d.size
        if symmetric:
            m = r != c
            nm = int(np.count_nonzero(m))
            if nm:
                val[at:at + nm] = d[m]
                ri[at:at + nm] = c[m]
                ci[at:at + nm] = r[m]
                at += nm
    K = _sp.coo_matrix((val, (ri, ci)), shape=(int(n1), int(n2)))
    return K.tocsr()


def assemble_row_strips(harvest, n1, n2):
    """Row-ordered vstack of harvested ``(first_row, csr_strip)`` pairs
    (ref gp2Scale_covariance.py:219)."""
    from scipy import sparse as _sp
    strips = dict(harvest)
    if not strips:
        return _sp.csr_matrix((int(n1), int(n2)))
    return _sp.vstack([strips[i] for i in sorted(strips)], format="csr")


def covariance_csr(kernel, x1, x2, hyperparameters, *, batch_size=10000,
                   args=None, symmetric=None, distribution="blockwise",
                   k_n_params=None):
    """Host scipy CSR covariance through the worker helpers — the
    reference's full Dask pipeline run in-process (blockwise: upper-triangle
    block schedule + mirrored single-alloc assembly; rowwise: finished CSR
    strips).  For external host solvers; the device engine is
    :func:`distributed_covariance`."""
    if k_n_params is None:          # sniff the kernel arity like GPprior
        import inspect
        try:
            k_n_params = len(inspect.signature(kernel).parameters)
        except (TypeError, ValueError):
            k_n_params = 3
    n1, n2 = len(x1), len(x2)
    if symmetric is None:
        if x2 is x1:
            symmetric = True
        else:
            try:                      # ragged object inputs may not compare
                symmetric = n1 == n2 and bool(np.array_equal(
                    np.asarray(x1, dtype=object),
                    np.asarray(x2, dtype=object)))
            except Exception:
                symmetric = False
    idt = index_dtype_for(n1, n2)
    if distribution == "rowwise":
        harvest = [row_strip_csr(w, x1, x2, hyperparameters, kernel,
                                 k_n_params, args, n2, batch_size, idt)
                   for w in ranges(n1, num_blocks(n1, batch_size))]
        return assemble_row_strips(harvest, n1, n2)
    rw = ranges(n1, num_blocks(n1, batch_size))
    cw = ranges(n2, num_blocks(n2, batch_size))
    pairs = [(a, b) for ai, a in enumerate(rw) for bi, b in enumerate(cw)
             if not (symmetric and bi < ai)]
    harvest = [block_triplets(p, x1, x2, hyperparameters, kernel,
                              k_n_params, args, symmetric, idt)
               for p in pairs]
    return assemble_triplets(harvest, n1, n2, symmetric, idt)
