"""Block-sparse (tile) covariance matrices for the gp2Scale-equivalent path.

Reference behavior being replaced: fvGP's Dask-distributed COO/CSR assembly
(/root/reference/fvgp/gp2Scale_covariance.py) and scipy.sparse matvec-based
Krylov (/root/reference/fvgp/gp_lin_alg.py:1184-1291).

Accelerator-first design: instead of an element-wise COO matrix, the
covariance is a set of dense B×B *tiles* on a fixed block grid
("BCOO-of-tiles").  Tiles are
what the matrix units want: the SpMM is a batched (nnzb, B, B) x (nnzb, B, k)
einsum plus a segment-sum — two ops XLA fuses and partitions well — and the
block-Jacobi preconditioner is a batched Cholesky of the diagonal tiles.
Sparsity lives at tile granularity, decided by bounding-box distance of the
whitened point blocks (the same early-out idea as the reference's
support-aware kernels, kernels.py:649-655, lifted from point level to tile
level so shapes stay static under jit).

The tile array is the natural sharding axis: placing ``tiles`` (and the
gathered x-blocks) on a device mesh turns the same einsum into a distributed
SpMM with an all-reduce — see parallel/sharded_cov.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BlockSparseMatrix", "is_block_sparse", "stack_augmented_covariance",
           "from_scipy", "merge"]


def is_block_sparse(obj):
    return isinstance(obj, BlockSparseMatrix)


@functools.lru_cache(maxsize=64)
def bsm_matvec_factory(nb, block_size, n, with_diag):
    """A STABLE matvec function for (nb, block_size)-shaped operators.

    Solvers jit with the matvec as a static argument; a per-matrix closure
    (e.g. a bound method) would retrace on every new K+V and bake the tile
    array in as a compile-time constant — at scale, a gigabyte constant
    through the compiler.  This factory returns one cached function per
    static shape; the matrix data (rows, cols, tiles[, diag]) flows through
    as a traced pytree argument.
    """

    def mv(data, X):
        if with_diag:
            rows, cols, tiles, diag = data
        else:
            rows, cols, tiles = data
        out = _bsm_matmat(rows, cols, tiles, X, nb, block_size)[:n]
        if with_diag:
            out = out + diag[:, None] * X
        return out

    return mv


# per-pass bytes allowed for the (T, B, c) rectangular-product temporary
_MATMAT_BUDGET = 2 << 30


@functools.partial(jax.jit, static_argnames=("nb", "block_size"))
def _bsm_matmat(rows, cols, tiles, X, nb, block_size):
    """(n, k) = sum over tiles of tile @ X[col-block] scattered to row-block
    (gather → batched einsum → segment-sum)."""
    n_pad = nb * block_size
    k = X.shape[1]
    Xp = jnp.zeros((n_pad, k), X.dtype).at[:X.shape[0]].set(X)
    Xb = Xp.reshape(nb, block_size, k)
    gathered = Xb[cols]                                   # (nnzb, B, k)
    prod = jnp.einsum("nij,njk->nik", tiles, gathered,
                      preferred_element_type=X.dtype)     # batched matmul
    out = jax.ops.segment_sum(prod, rows, num_segments=nb)
    return out.reshape(n_pad, k)[:X.shape[0]]


@jax.jit
def _fro2_one(t):
    """Fused convert+square+reduce of one tile slice — never materializes
    the f32 copy of sub-f32 tile storage."""
    return jnp.sum(jnp.square(t.astype(jnp.float32)))


def _fro2_chunked(tiles, chunk=16384):
    """Σ tiles² in f32, jitted per chunk so peak memory is one chunk
    (16384 B=128 bf16 tiles = 0.5 GB read per pass)."""
    T = int(tiles.shape[0])
    total = jnp.zeros((), jnp.float32)
    for s in range(0, T, chunk):
        total = total + _fro2_one(tiles[s:s + chunk])
    return total


@functools.partial(jax.jit, static_argnames=("nb", "block_size", "n"))
def _bsm_diagonal_sel(rows_sel, tiles_sel, nb, block_size, n):
    """Diagonal from the PRE-SELECTED diagonal-block tiles only."""
    idx = jnp.arange(block_size)
    tile_diags = tiles_sel[:, idx, idx]                   # (n_sel, B)
    out = jax.ops.segment_sum(tile_diags, rows_sel, num_segments=nb)
    return out.reshape(nb * block_size)[:n]


def _bsm_diagonal(rows, cols, tiles, nb, block_size, n):
    """diag(A) for tile storage.  The diagonal-block tiles are selected by
    HOST-side index before anything touches the tile array: the old jitted
    ``tiles[:, idx, idx]`` gather over all T tiles forced XLA to copy the
    ENTIRE array into a transposed layout (7×1 GB HLO temps at N=1M —
    the committed-state OOM, seen in the allocator report as
    ``jit(_bsm_diagonal)/gather``)."""
    sel = np.nonzero((np.asarray(rows) == np.asarray(cols))
                     & (np.asarray(rows) < nb))[0]
    sel = jnp.asarray(sel)
    return _bsm_diagonal_sel(jnp.asarray(rows)[sel],
                             jnp.asarray(tiles)[sel], nb, block_size, n)


class BlockSparseMatrix:
    """Symmetric block-sparse matrix stored as dense tiles on a block grid.

    Both triangles are stored (the assembler computes only the upper triangle
    and mirrors on device — half the kernel FLOPs, like the reference's
    blockwise scheduling, gp2Scale_covariance.py:278-287).
    """

    def __init__(self, n, n_cols, block_size, rows, cols, tiles, diag=None,
                 live_tiles=None):
        self.n = int(n)                  # logical rows
        self.n_cols = int(n_cols)        # logical cols
        self.block_size = int(block_size)
        self.nb = -(-self.n // self.block_size)
        self.nb_cols = -(-self.n_cols // self.block_size)
        self.rows = jnp.asarray(rows, dtype=jnp.int32)
        self.cols = jnp.asarray(cols, dtype=jnp.int32)
        self.tiles = jnp.asarray(tiles)
        # live (non-sentinel) tile count, passed by assemblers that pad to
        # a jit bucket; computed lazily (one host pull of rows) otherwise
        self._live_tiles = None if live_tiles is None else int(live_tiles)
        # optional extra diagonal, stored SEPARATELY from the tiles:
        # K+V shares K's tile buffer instead of copying ~the whole matrix
        # (at N ~ 1M that copy alone is half the HBM), and the noise keeps
        # full precision even under bf16 tile storage
        self.diag = None if diag is None else jnp.asarray(diag)

    # -- basic facts -----------------------------------------------------
    @property
    def shape(self):
        return (self.n, self.n_cols)

    @property
    def nnz(self):
        """Stored values (tile granularity) — the policy layer's sparsity
        measure (ref gp_kv.py:183).  Counts LIVE tiles only: bucket-padded
        sentinel tiles (row == nb) would otherwise inflate the sparsity
        that gp_kv's auto mode selection thresholds on."""
        if self._live_tiles is None:
            self._live_tiles = int(np.sum(np.asarray(self.rows) < self.nb))
        return self._live_tiles * self.block_size * self.block_size

    @property
    def dtype(self):
        return self.tiles.dtype

    def sparsity(self):
        return self.nnz / float(max(self.n * self.n_cols, 1))

    # -- linear operator ---------------------------------------------------
    def matmat(self, X):
        X = jnp.asarray(X)
        squeeze = X.ndim == 1
        if squeeze:
            X = X[:, None]
        if self.n != self.n_cols:
            out = self._rect_matmat(X)
        else:
            kc = self._col_chunk(X.shape[1], X.dtype.itemsize)
            if kc < X.shape[1]:
                # same memory bound as _rect_matmat: the (T, B, c) per-tile
                # product must not exceed the budget (host-driven callers
                # may pass hundreds of columns)
                out = jnp.concatenate(
                    [_bsm_matmat(self.rows, self.cols, self.tiles,
                                 X[:, s:s + kc], self.nb, self.block_size)
                     for s in range(0, X.shape[1], kc)], axis=1)
            else:
                out = _bsm_matmat(self.rows, self.cols, self.tiles, X,
                                  self.nb, self.block_size)
            if self.diag is not None:
                out = out + self.diag[:, None] * X
        return out[:, 0] if squeeze else out

    __matmul__ = matmat

    def _col_chunk(self, k, itemsize=4):
        """Columns per pass so the TWO live (T, B, c) per-tile buffers
        (``gathered`` and ``prod``) together stay under ``_MATMAT_BUDGET``
        — at N=1M a 500-column product is ~30 GB, an instant HBM OOM
        without this bound (these products run on the host-driven
        posterior path, so a python loop over chunks costs nothing).
        ``itemsize`` is the RHS element size: 8 on the float64/CPU-parity
        path, 4 on the accelerator's f32."""
        per_col = (2 * int(self.tiles.shape[0]) * int(self.block_size)
                   * int(itemsize))
        return max(1, min(int(k), _MATMAT_BUDGET // max(per_col, 1)))

    def _rect_matmat(self, X):
        n_pad_c = self.nb_cols * self.block_size
        k = X.shape[1]
        kc = self._col_chunk(k, X.dtype.itemsize)
        if kc < k:
            return jnp.concatenate(
                [self._rect_matmat(X[:, s:s + kc])
                 for s in range(0, k, kc)], axis=1)
        Xp = jnp.zeros((n_pad_c, k), X.dtype).at[: X.shape[0]].set(X)
        Xb = Xp.reshape(self.nb_cols, self.block_size, k)
        gathered = Xb[self.cols]
        prod = jnp.einsum("nij,njk->nik", self.tiles, gathered,
                          preferred_element_type=X.dtype)
        out = jax.ops.segment_sum(prod, self.rows, num_segments=self.nb)
        return out.reshape(self.nb * self.block_size, k)[: self.n]

    def rmatmat(self, X):
        """Xᵀ-side product: (n_cols, k) = Aᵀ @ X for rectangular A."""
        X = jnp.asarray(X)
        squeeze = X.ndim == 1
        if squeeze:
            X = X[:, None]
        n_pad_r = self.nb * self.block_size
        k = X.shape[1]
        kc = self._col_chunk(k, X.dtype.itemsize)
        if kc < k:
            out = jnp.concatenate([self.rmatmat(X[:, s:s + kc])
                                   for s in range(0, k, kc)], axis=1)
            return out[:, 0] if squeeze else out
        Xp = jnp.zeros((n_pad_r, k), X.dtype).at[: X.shape[0]].set(X)
        Xb = Xp.reshape(self.nb, self.block_size, k)
        gathered = Xb[self.rows]
        prod = jnp.einsum("nji,njk->nik", self.tiles, gathered,
                          preferred_element_type=X.dtype)
        out = jax.ops.segment_sum(prod, self.cols, num_segments=self.nb_cols)
        out = out.reshape(self.nb_cols * self.block_size, k)[: self.n_cols]
        if self.diag is not None:
            out = out + self.diag[:, None] * X
        return out[:, 0] if squeeze else out

    @property
    def T(self):
        """Transposed view (swaps the block grid)."""
        t = BlockSparseMatrix(self.n_cols, self.n, self.block_size,
                              self.cols, self.rows,
                              jnp.swapaxes(self.tiles, 1, 2),
                              diag=self.diag)
        return t

    # -- diagonal ops --------------------------------------------------
    def diagonal(self):
        d = _bsm_diagonal(self.rows, self.cols, self.tiles,
                          self.nb, self.block_size, self.n)
        if self.diag is not None:
            d = d + self.diag
        return d

    def add_diagonal(self, v):
        """Return K + diag(v) as a VIEW sharing this matrix's tile buffer
        (K+V, ref gp_kv.py:650-655) — no tile copy, and the diagonal keeps
        its own (full) precision under reduced-precision tile storage."""
        if self.n != self.n_cols:
            raise AssertionError("add_diagonal requires a square matrix")
        v = jnp.broadcast_to(jnp.asarray(v), (self.n,))
        d = v if self.diag is None else self.diag + v
        return BlockSparseMatrix(self.n, self.n_cols, self.block_size,
                                 self.rows, self.cols, self.tiles, diag=d)

    def trace_and_fro(self):
        """One pass over stored tiles: (trace, frobenius norm) for the
        drift fingerprint (ref gp_kv.py:216-239).  The extra diagonal is
        folded in exactly: ||K+D||_F^2 = ||K||_F^2 + 2<diag K, d> + ||d||^2.

        Called eagerly (the fingerprint floats immediately), so the
        reduction runs as jitted chunks: an eager ``tiles.astype(f32)``
        MATERIALIZES a full-precision copy of the tile array — 15 GB at
        N=1M bf16 storage, which OOM'd every committed-state solve's
        drift check on one chip (the preconditioner-build path caught its
        own failure and fell back; the warm-start check then hit the same
        allocation uncaught).  The chunked jit fuses convert+square+reduce
        per slice, so peak memory is one chunk.

        merge() produces duplicate (row, col) tiles whose sum is the
        represented matrix: ||Σ_g t_g||² = Σ||t||² + 2Σ_{i<j in g}<t_i,t_j>
        — the cross terms are added from the (few) duplicate groups only,
        never by coalescing the whole array."""
        base = _bsm_diagonal(self.rows, self.cols, self.tiles,
                             self.nb, self.block_size, self.n)
        tr = jnp.sum(base) + (0.0 if self.diag is None
                              else jnp.sum(self.diag))
        fro2 = _fro2_chunked(self.tiles)
        # duplicate detection over LIVE tiles only: every bucket-padded
        # matrix carries many sentinel entries sharing the key
        # (nb, nb_cols), which would otherwise form one giant fake
        # "duplicate group" and eagerly gather all padding tiles as f32
        # on every fingerprint — the OOM class this function was
        # rewritten to avoid (sentinel tiles are zeroed, so they add
        # nothing to fro2 either way)
        rows_h = np.asarray(self.rows)
        live_m = rows_h < self.nb
        live_idx = np.nonzero(live_m)[0]
        key = (rows_h[live_m].astype(np.int64) * self.nb_cols
               + np.asarray(self.cols)[live_m])
        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        if len(uniq) != len(key):
            dup_groups = np.nonzero(counts > 1)[0]
            for g in dup_groups:
                idx = live_idx[np.nonzero(inv == g)[0]]
                tg = self.tiles[jnp.asarray(idx)].astype(jnp.float32)
                s = jnp.sum(tg, axis=0)
                fro2 = fro2 + (jnp.sum(s * s) - jnp.sum(tg * tg))
        if self.diag is not None:
            fro2 = fro2 + 2.0 * jnp.sum(base * self.diag) \
                + jnp.sum(self.diag * self.diag)
        return tr, jnp.sqrt(fro2)

    # -- conversions ---------------------------------------------------
    def to_dense(self):
        # sub-f32 storage (args['gp2Scale_storage_dtype']) is a tile FORMAT;
        # dense materializations feed LAPACK/linalg and upcast to f32
        out_dtype = self.tiles.dtype
        if jnp.finfo(out_dtype).bits < 32:
            out_dtype = jnp.float32
        B = self.block_size
        n_pad_r = self.nb * B
        n_pad_c = self.nb_cols * B
        dense = jnp.zeros((self.nb, self.nb_cols, B, B), out_dtype)
        dense = dense.at[self.rows, self.cols].add(self.tiles)
        dense = dense.transpose(0, 2, 1, 3).reshape(n_pad_r, n_pad_c)
        dense = dense[: self.n, : self.n_cols]
        if self.diag is not None:
            i = jnp.arange(self.n)
            dense = dense.at[i, i].add(self.diag.astype(dense.dtype))
        return dense

    def toarray(self):
        return np.asarray(self.to_dense())

    def dense_columns(self, start, end):
        """Dense (n, end-start) slice of columns [start, end) without
        materializing the full matrix — scatters only the tiles whose
        column block overlaps the range (the reference's chunked-posterior
        memory contract, gp_posterior.py:120-136)."""
        B = self.block_size
        cb0 = int(start) // B
        cb1 = (int(end) - 1) // B + 1
        sel = np.nonzero((np.asarray(self.cols) >= cb0)
                         & (np.asarray(self.cols) < cb1))[0]
        width = (cb1 - cb0) * B
        out_dtype = self.tiles.dtype
        if jnp.finfo(out_dtype).bits < 32:
            out_dtype = jnp.float32
        dense = jnp.zeros((self.nb, cb1 - cb0, B, B), out_dtype)
        if len(sel):
            dense = dense.at[self.rows[sel], self.cols[sel] - cb0].add(
                self.tiles[jnp.asarray(sel)])
        dense = dense.transpose(0, 2, 1, 3).reshape(self.nb * B, width)
        lo = int(start) - cb0 * B
        dense = dense[: self.n, lo:lo + (int(end) - int(start))]
        if self.diag is not None:
            i = jnp.arange(int(start), int(end))
            dense = dense.at[i, i - int(start)].add(
                self.diag[int(start):int(end)].astype(dense.dtype))
        return dense

    def diagonal_tiles(self):
        """(nb, B, B) stack of the diagonal tiles (block-Jacobi input).
        Missing diagonal tiles come back as zero blocks.

        The selection happens by host-side index, NOT an in-place
        ``jnp.where`` over the tile array: the eager where materialized a
        full zeroed copy of the tiles (7.5 GB at N=1M) before the
        segment_sum dropped all but ~nb of them — the committed-state
        preconditioner build OOM'd on exactly that at the bench scale."""
        sel = np.nonzero((np.asarray(self.rows) == np.asarray(self.cols))
                         & (np.asarray(self.rows) < self.nb))[0]
        out = jax.ops.segment_sum(self.tiles[jnp.asarray(sel)],
                                  self.rows[jnp.asarray(sel)],
                                  num_segments=self.nb)
        if self.diag is not None:
            out = out.astype(jnp.promote_types(out.dtype, self.diag.dtype))
            dp = jnp.zeros((self.nb * self.block_size,), self.diag.dtype)
            dp = dp.at[: self.n].set(self.diag)
            idx = jnp.arange(self.block_size)
            out = out.at[:, idx, idx].add(
                dp.reshape(self.nb, self.block_size))
        return out

    def off_diagonal_tiles(self, offset=1):
        """(nb, B, B) stack of the k-th block superdiagonal tiles
        (rows + offset == cols); missing tiles are zero blocks.  Input to
        the overlapping-Schwarz preconditioner's coupled windows.  Selected
        by host-side index for the same reason as ``diagonal_tiles``."""
        r = np.asarray(self.rows)
        c = np.asarray(self.cols)
        sel = np.nonzero((r + offset == c) & (r < self.nb)
                         & (c < self.nb_cols))[0]
        return jax.ops.segment_sum(self.tiles[jnp.asarray(sel)],
                                   self.rows[jnp.asarray(sel)],
                                   num_segments=self.nb)

    def coarse_matrix(self):
        """(nb, nb) Galerkin coarse operator PᵀAP for the block-constant
        prolongation P (each coarse dof = one point block): entry (i, j) is
        the sum of tile (i, j)'s entries.  Input to the two-level
        (AMG-class) preconditioner's coarse solve."""
        sums = jnp.sum(self.tiles, axis=(1, 2))
        live = (self.rows < self.nb) & (self.cols < self.nb_cols)
        sums = jnp.where(live, sums, 0.0)
        Ac = jnp.zeros((self.nb, self.nb_cols), sums.dtype)
        Ac = Ac.at[self.rows, self.cols].add(sums, mode="drop")
        if self.diag is not None:
            Ac = Ac.astype(jnp.promote_types(Ac.dtype, self.diag.dtype))
            dp = jnp.zeros((self.nb * self.block_size,), self.diag.dtype)
            dp = dp.at[: self.n].set(self.diag)
            i = jnp.arange(self.nb)
            Ac = Ac.at[i, i].add(
                jnp.sum(dp.reshape(self.nb, self.block_size), axis=1))
        return Ac

    def __getstate__(self):
        return dict(n=self.n, n_cols=self.n_cols, block_size=self.block_size,
                    rows=np.asarray(self.rows), cols=np.asarray(self.cols),
                    tiles=np.asarray(self.tiles),
                    diag=None if self.diag is None else np.asarray(self.diag))

    def __setstate__(self, state):
        self.__init__(state["n"], state["n_cols"], state["block_size"],
                      state["rows"], state["cols"], state["tiles"],
                      diag=state.get("diag"))


def from_scipy(sp_mat, block_size):
    """Tile-ify a scipy.sparse matrix onto the fixed block grid.

    The structured-noise path (ref gp_likelihood.py:89-110 accepts a noise
    callable returning a scipy.sparse matrix; ref gp_kv.py:640-647 adds it
    sparse-aware): the host matrix is grouped by (row-block, col-block) and
    scattered into dense B×B tiles, so K+V stays one batched-tile operator.
    """
    coo = sp_mat.tocoo()
    n, n_cols = coo.shape
    B = int(block_size)
    nb_cols = -(-n_cols // B)
    br = coo.row // B
    bc = coo.col // B
    key = br.astype(np.int64) * nb_cols + bc
    uniq, tile_of = np.unique(key, return_inverse=True)
    tiles = np.zeros((len(uniq), B, B), dtype=np.float64)
    np.add.at(tiles, (tile_of, coo.row % B, coo.col % B), coo.data)
    rows = (uniq // nb_cols).astype(np.int32)
    cols = (uniq % nb_cols).astype(np.int32)
    return BlockSparseMatrix(n, n_cols, B, rows, cols, tiles)


def merge(A, B_mat):
    """A + B for two BlockSparseMatrix on the SAME block grid: the tile
    lists concatenate (duplicate (row, col) entries are summed by every
    consumer's segment-sum/scatter-add).  Extra diagonals add.

    Dtype: tiles promote to the wider of the two, capped at f32 when
    either side is a sub-f32 STORAGE format — silently downcasting the
    second operand to A's dtype quantized structured noise to bf16's 8
    mantissa bits (K + V via merge under gp2Scale_storage_dtype=bf16),
    breaking the 'noise keeps full precision' contract.  f32 holds the
    noise to ~1e-7 relative at 2x (not 4x) the bf16 tile memory."""
    if (A.shape != B_mat.shape) or (A.block_size != B_mat.block_size):
        raise ValueError("merge requires matching shapes and block grids")
    d = A.diag
    if B_mat.diag is not None:
        d = B_mat.diag if d is None else d + B_mat.diag
    out_dt = jnp.promote_types(A.tiles.dtype, B_mat.tiles.dtype)
    if (jnp.finfo(A.tiles.dtype).bits < 32
            or jnp.finfo(B_mat.tiles.dtype).bits < 32):
        out_dt = min(out_dt, jnp.dtype(jnp.float32),
                     key=lambda t: jnp.finfo(t).bits)
    return BlockSparseMatrix(
        A.n, A.n_cols, A.block_size,
        jnp.concatenate([A.rows, B_mat.rows]),
        jnp.concatenate([A.cols, B_mat.cols]),
        jnp.concatenate([jnp.asarray(A.tiles, dtype=out_dt),
                         jnp.asarray(B_mat.tiles, dtype=out_dt)]), diag=d)


def stack_augmented_covariance(K, B, D):
    """[[K, B], [Bᵀ, D]] for block-sparse parts on compatible grids
    (ref gp2Scale_covariance.py:311-324).

    Requires K's point count to be a multiple of the block size so the
    appended blocks land on the same grid; callers fall back to a full
    recompute otherwise.
    """
    if K.n % K.block_size != 0:
        raise ValueError("append grid misaligned; recompute the full covariance")
    off = K.nb
    rows = jnp.concatenate([K.rows, B.rows, B.cols + off, D.rows + off])
    cols = jnp.concatenate([K.cols, B.cols + off, B.rows, D.cols + off])
    tiles = jnp.concatenate([K.tiles, B.tiles,
                             jnp.swapaxes(B.tiles, 1, 2), D.tiles])
    return BlockSparseMatrix(K.n + D.n, K.n + D.n, K.block_size, rows, cols, tiles)
