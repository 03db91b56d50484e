"""Pallas kernel for the committed-state block-sparse SpMM (Triton route).

``row_block_spmm`` computes ``Y = A @ X`` for a block-sparse ``A`` held as a
ROW-SORTED tile list (CSR over point blocks).  One program owns one
(row block, k-block) pair (and one 128-row half of it where B = 256): it
walks that row's tiles through the CSR row offsets, loads each tile and the
X block it multiplies by column index, accumulates in f32 registers and
writes its output block once.  So
no gathered copy of X, no per-tile product and no scatter-add ever touches
device memory: the traffic is the tile stream plus the X blocks the tiles
reference.  The XLA formulation (``sparse_lml._spmv_scan``) materialises the
gathered X and the f32 per-tile product per scan slice and scatter-adds it.

The kernel runs compiled for the GPU, and in interpret mode on the CPU
backend (the test suite).  Any other backend raises: a kernel never silently
falls back to the interpreter on an accelerator.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["row_offsets", "row_block_spmm", "k_blocking", "supports"]


def _interpret():
    """Interpret mode on the CPU backend only (tests); compiled on the GPU;
    anything else is an error rather than a hidden interpreter run."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"row_block_spmm has no kernel for backend {backend!r} "
                       "(compiled on gpu, interpret mode on cpu)")


def row_offsets(rows, nb):
    """Host helper: CSR row offsets ``(nb + 1,)`` int32 of a row-sorted tile
    schedule.  Sentinel entries (``row == nb``, bucket padding) trail the
    real tiles and fall outside every row's range."""
    rows = np.asarray(rows)
    if len(rows) > 1 and np.any(np.diff(rows) < 0):
        raise ValueError("row_offsets needs a row-sorted tile schedule")
    return np.searchsorted(rows, np.arange(nb + 1), side="left") \
        .astype(np.int32)


def supports(B):
    """True when the kernel can take block size ``B``: a power of two of at
    least 16 (Triton block shapes are powers of two, and its dot needs
    every operand dimension >= 16)."""
    B = int(B)
    return B >= 16 and B & (B - 1) == 0


def k_blocking(k, itemsize):
    """(kb, k_pad): the k-block width (a power of two in [16, 64]; the
    Triton dot needs >= 16) and k padded up to a multiple of it.  f32 tiles
    cap kb at 32 so the pipeline stages of tile and X operands stay well
    inside a block's shared memory."""
    cap = 64 if itemsize <= 2 else 32
    kb = min(cap, max(16, 1 << (max(int(k), 1) - 1).bit_length()))
    return kb, -(-int(k) // kb) * kb


def _row_block_kernel(rowptr_ref, cols_ref, tiles_ref, x_ref, out_ref, *,
                      nb, bm, bk, nk, precision):
    r = pl.program_id(1)                      # row sub-block of the tile
    i = pl.program_id(2)                      # row block
    start = rowptr_ref[i]
    end = rowptr_ref[i + 1]

    def body(s, acc):
        # one step = one (tile, contraction sub-block) pair, so B > 128
        # tiles stream in (bm, bk) pieces instead of whole
        t = s // nk
        kk = s % nk
        c = jnp.minimum(cols_ref[t], nb - 1)  # sentinel cols: zero tiles
        a = tiles_ref[t, pl.ds(r * bm, bm), pl.ds(kk * bk, bk)]
        x = x_ref[c, pl.ds(kk * bk, bk), :]   # (bk, kb) of this k-block
        return acc + jnp.dot(a, x, preferred_element_type=jnp.float32,
                             precision=precision)

    kb = out_ref.shape[-1]
    acc = jax.lax.fori_loop(start * nk, end * nk, body,
                            jnp.zeros((bm, kb), jnp.float32))
    out_ref[...] = acc


@functools.partial(jax.jit,
                   static_argnames=("nb", "B", "kb", "interpret", "sub"))
def _row_block_call(rowptr, cols, tiles, Xb, nb, B, kb, interpret, sub=128):
    T = tiles.shape[0]
    k_pad = Xb.shape[2]
    bm = bk = min(B, sub)
    f32 = tiles.dtype.itemsize >= 4
    # f32 tiles compiled: three TF32 tensor-core passes (f32-level
    # accuracy); a plain f32 dot runs without the tensor cores.  The
    # interpreter and bf16 tiles take the exact product.
    precision = (jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3
                 if f32 and not interpret else jax.lax.Precision.HIGHEST)
    # grid: k-block fastest, so the programs that share a row's tiles run
    # side by side and read them through L2 once
    return pl.pallas_call(
        functools.partial(_row_block_kernel, nb=nb, bm=bm, bk=bk,
                          nk=B // bk, precision=precision),
        grid=(k_pad // kb, B // bm, nb),
        in_specs=[
            pl.BlockSpec((nb + 1,), lambda j, r, i: (0,)),
            pl.BlockSpec((T,), lambda j, r, i: (0,)),
            pl.BlockSpec((T, B, B), lambda j, r, i: (0, 0, 0)),
            pl.BlockSpec((nb, B, kb), lambda j, r, i: (0, 0, j)),
        ],
        out_specs=pl.BlockSpec((None, bm, kb), lambda j, r, i: (i, r, j)),
        out_shape=jax.ShapeDtypeStruct((nb, B, k_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4,
                                             num_stages=2 if f32 else 3),
        interpret=interpret,
        name="row_block_spmm",
    )(rowptr, cols, tiles, Xb)


def row_block_spmm(rowptr, cols, tiles, X, nb, B, mv_dtype=None):
    """``Y = A @ X`` (``(nb*B, k)``, X's dtype) for a row-sorted tile list.

    ``rowptr`` (nb+1,) int32 CSR offsets (:func:`row_offsets`); ``cols``
    (T,) column blocks, sentinel ``nb`` allowed where the tile is zero;
    ``tiles`` (T, B, B) in f32 or bf16 (``mv_dtype`` casts them, as in the
    XLA SpMMs).  X is cast to the tile dtype, so bf16 tiles multiply bf16
    operands; accumulation is f32.  Not differentiable: it serves the
    committed-state posterior solve only."""
    if mv_dtype is not None:
        tiles = tiles.astype(mv_dtype)
    if tiles.dtype not in (jnp.float32, jnp.bfloat16):
        raise ValueError("row_block_spmm takes f32 or bf16 tiles, got "
                         f"{tiles.dtype}")
    if not supports(B):
        raise ValueError(f"row_block_spmm needs a power-of-two block size "
                         f">= 16, got {B}")
    n_pad, k = X.shape
    kb, k_pad = k_blocking(k, tiles.dtype.itemsize)
    Xc = X.astype(tiles.dtype)
    if k_pad != k:
        Xc = jnp.pad(Xc, ((0, 0), (0, k_pad - k)))
    out = _row_block_call(jnp.asarray(rowptr, jnp.int32),
                          jnp.asarray(cols, jnp.int32), tiles,
                          Xc.reshape(nb, B, k_pad), nb, B, kb, _interpret())
    return out.reshape(n_pad, k_pad)[:, :k].astype(X.dtype)
