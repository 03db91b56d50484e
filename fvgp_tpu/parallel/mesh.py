"""Device-mesh helpers — the communication backend of the scale path.

Replaces the reference's Dask distributed client (SURVEY.md §2d): there is no
scatter/future lifetime management because sharded arrays are SPMD-resident.
A 1-D mesh over axis ``"tiles"`` shards the block-sparse covariance; XLA's
GSPMD partitions the batched-tile SpMM and inserts the collectives over ICI.

Multi-slice: a 2-D ``("slice", "tiles")`` mesh (``make_mesh_2d``) nests the
row ownership — slices own contiguous Morton ranges (outer, DCN boundary),
chips within a slice own contiguous sub-ranges (inner, ICI).  Row-sharded
arrays shard over BOTH axes flattened (``tile_spec``); the shard_map SpMM
uses the flattened device index (``flat_tile_index``), so the same program
runs on either mesh shape.  See docs/source/comm_model.md for the DCN
traffic analysis.
"""

import contextlib

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_ACTIVE_MESH = None

TILE_AXIS = "tiles"
SLICE_AXIS = "slice"


def _slice_groups(devices, process_fallback=False):
    """Partition ``devices`` into hardware slices, outer-mesh first.

    Multi-slice platforms expose ``slice_index`` per device — the
    only signal ``layout='auto'`` trusts.  ``process_fallback=True``
    (explicit ``layout='2d'`` only) additionally treats each host process
    as a DCN domain; that is NOT safe to infer automatically, because a
    single-slice multi-host pod (and any multi-process CPU/GPU backend)
    has distinct ``process_index`` values on fabric that is not DCN.
    ``FVGP_TPU_ASSUME_SLICES=k`` overrides both — the documented way to
    exercise the 2-D layout on a virtual single-process mesh."""
    import os
    k = int(os.environ.get("FVGP_TPU_ASSUME_SLICES", "0") or 0)
    if k > 1:
        if len(devices) % k:
            raise ValueError(
                f"FVGP_TPU_ASSUME_SLICES={k} does not divide "
                f"{len(devices)} devices")
        per = len(devices) // k
        return [list(devices[i * per:(i + 1) * per]) for i in range(k)]

    attrs = ("slice_index", "process_index") if process_fallback \
        else ("slice_index",)

    def key(d):
        for attr in attrs:
            v = getattr(d, attr, None)
            if v is not None:
                return int(v)
        return 0

    groups = {}
    for d in devices:
        groups.setdefault(key(d), []).append(d)
    return [groups[g] for g in sorted(groups)]


def make_mesh(n_devices=None, devices=None, layout="auto"):
    """A mesh over ``n_devices`` (default: all local devices).

    ``layout='auto'`` (default) derives the shape from the device
    topology: when the devices span more than one hardware slice
    (``slice_index``, or the ``FVGP_TPU_ASSUME_SLICES`` override for
    virtual meshes) of equal size, the mesh comes back 2-D
    ``(slice, tiles)`` — inter-slice traffic rides DCN on the outer axis,
    intra-slice ICI on the inner — and every row-sharded consumer
    (``tile_spec``/``flat_tile_index``) handles both shapes
    transparently.  ``layout='1d'`` forces the flat mesh; ``layout='2d'``
    additionally accepts per-process grouping (one DCN domain per host)
    and raises when no slice structure is visible."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    if layout in ("auto", "2d"):
        groups = _slice_groups(devices, process_fallback=(layout == "2d"))
        sizes = {len(g) for g in groups}
        if len(groups) > 1 and len(sizes) == 1:
            return Mesh(np.array(groups), (SLICE_AXIS, TILE_AXIS))
        if layout == "2d":
            raise ValueError(
                "layout='2d' but the devices expose no (equal-sized) slice "
                "structure; pass explicit groups via make_mesh_2d or set "
                "FVGP_TPU_ASSUME_SLICES")
    return Mesh(np.array(devices), (TILE_AXIS,))


def make_mesh_2d(n_slices, per_slice, devices=None):
    """A 2-D ``(slice, tiles)`` mesh: ``n_slices`` groups of ``per_slice``
    devices.  On hardware, order ``devices`` so each group is one pod slice
    (intra-group traffic rides ICI, inter-group DCN)."""
    if devices is None:
        devices = jax.devices()[:n_slices * per_slice]
    if len(devices) != n_slices * per_slice:
        raise ValueError(f"need {n_slices * per_slice} devices, "
                         f"got {len(devices)}")
    return Mesh(np.asarray(devices).reshape(n_slices, per_slice),
                (SLICE_AXIS, TILE_AXIS))


def tile_axes(mesh):
    """The mesh axes a row/tile-sharded array spans, outer first."""
    return tuple(n for n in (SLICE_AXIS, TILE_AXIS) if n in mesh.shape)


def tile_device_count(mesh):
    """Number of devices in the (flattened) tile sharding."""
    n = 1
    for a in tile_axes(mesh):
        n *= int(mesh.shape[a])
    return n


def tile_spec(mesh, extra_dims=0):
    """PartitionSpec sharding the leading axis over the flattened tile
    axes, with ``extra_dims`` unsharded trailing dims."""
    axes = tile_axes(mesh)
    lead = axes[0] if len(axes) == 1 else axes
    return P(lead, *([None] * extra_dims))


def flat_tile_index(mesh):
    """Inside shard_map: this device's index in the flattened tile order
    (slice-major), matching ``tile_spec``'s shard layout."""
    axes = tile_axes(mesh)
    idx = jax.lax.axis_index(axes[-1])
    if len(axes) == 2:
        idx = idx + jax.lax.axis_index(axes[0]) * mesh.shape[axes[1]]
    return idx


def set_mesh(mesh):
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def current_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def shard_tiles(bsm, mesh=None):
    """Shard a BlockSparseMatrix's tile list over the mesh (rows/cols/tiles
    along the leading axis; the tile count is already bucket-padded to a
    multiple of the device count by the assembler)."""
    mesh = mesh or current_mesh()
    if mesh is None or np.prod(list(mesh.shape.values())) == 1:
        return bsm
    s1 = NamedSharding(mesh, tile_spec(mesh))
    s3 = NamedSharding(mesh, tile_spec(mesh, 2))
    bsm.rows = jax.device_put(bsm.rows, s1)
    bsm.cols = jax.device_put(bsm.cols, s1)
    bsm.tiles = jax.device_put(bsm.tiles, s3)
    return bsm
