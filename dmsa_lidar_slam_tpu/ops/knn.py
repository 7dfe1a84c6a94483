"""Fixed-radius neighbor queries and kNN on a hash grid — no trees.

Tree-free replacement for the reference's PCL KdTreeFLANN usage: static
point matching (DmsaSlam.h:285-345), overlap computation (DmsaSlam.h:377-414)
and the k=6 normal-estimation search (DmsaSlam.h:557-568).

Design: reference points are binned at cell size = radius; a query point
only needs the 27 adjacent voxels, each truncated to `cap` members (the
clouds are voxel-downsampled upstream, so true occupancy is small; callers
log `max_occupancy` vs cap — no silent-truncation policy).  Cell lookup is
a batched binary search over the sorted int64 voxel keys; candidate
gathering is fully vectorized over (27 x cap) with queries chunked through
lax.map to bound the [chunk, 27, cap, 3] gather footprint.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_QUERY_CHUNK = 4096

# 30-bit spatial hash (int32 keys sort faster than int64; collisions
# over the 2^30 space are ~n^2/2^31 — a fraction of a cell for our sizes —
# and harmless anyway because every candidate passes a real distance check)
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_HASH_MASK = (1 << 30) - 1
_INVALID = jnp.iinfo(jnp.int32).max


class HashGrid(NamedTuple):
    """Searchable grid over a reference cloud (capacity = n points)."""

    sorted_pts: jnp.ndarray  # [N, 3] points in key-sorted order
    sorted_valid: jnp.ndarray  # [N] bool
    cell_keys: jnp.ndarray  # [N] int64 key of each cell (pad: max)
    cell_start: jnp.ndarray  # [N] start offset of each cell in sorted order
    cell_count: jnp.ndarray  # [N] member count of each cell
    num_cells: jnp.ndarray  # []
    cell_size: jnp.ndarray  # []
    max_occupancy: jnp.ndarray  # [] for overflow logging


def _hash_coords(c):
    """Murmur-finalized spatial hash (the plain XOR-of-prime-multiples hash
    has structural collisions between ADJACENT cells in its low bits)."""
    c = c.astype(jnp.uint32)
    h = c[..., 0] * jnp.uint32(_P1) + c[..., 1] * jnp.uint32(_P2) + c[..., 2] * jnp.uint32(_P3)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & jnp.uint32(_HASH_MASK)).astype(jnp.int32)


def _keys32(points, mask, cell_size):
    c = jnp.floor(points / cell_size).astype(jnp.int32)
    return jnp.where(mask, _hash_coords(c), _INVALID)


def build_grid(points, mask, cell_size) -> HashGrid:
    n = points.shape[0]
    keys = _keys32(points, mask, cell_size)
    order = jnp.argsort(keys)
    keys_s = keys[order]
    pts_s = points[order]
    valid_s = mask[order]

    new_cell = jnp.concatenate(
        [jnp.ones((1,), jnp.int32), (keys_s[1:] != keys_s[:-1]).astype(jnp.int32)]
    )
    seg_ids = jnp.minimum(jnp.cumsum(new_cell) - 1, n - 1)
    num_cells = jnp.where(jnp.any(valid_s), jnp.max(jnp.where(valid_s, seg_ids, -1)) + 1, 0)

    idx = jnp.arange(n)
    cell_start = jax.ops.segment_min(idx, seg_ids, num_segments=n, indices_are_sorted=True)
    cell_count = jax.ops.segment_sum(
        valid_s.astype(jnp.int32), seg_ids, num_segments=n, indices_are_sorted=True
    )
    cell_keys = jax.ops.segment_min(keys_s, seg_ids, num_segments=n, indices_are_sorted=True)
    return HashGrid(
        sorted_pts=pts_s,
        sorted_valid=valid_s,
        cell_keys=cell_keys,
        cell_start=cell_start,
        cell_count=cell_count,
        num_cells=num_cells,
        cell_size=jnp.asarray(cell_size),
        max_occupancy=jnp.max(jnp.where(jnp.arange(n) < num_cells, cell_count, 0)),
    )


def _neighbor_offsets(dtype=jnp.int32):
    o = jnp.asarray(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        dtype=dtype,
    )
    return o  # [27, 3]


def _candidates(grid: HashGrid, q_chunk, cap: int):
    """Candidate neighbor info for one query chunk.

    Returns (idx [C, 27*cap] into sorted_pts, ok [C, 27*cap]).
    """
    n = grid.sorted_pts.shape[0]
    c = jnp.floor(q_chunk / grid.cell_size).astype(jnp.int32)  # [C,3]
    off = _neighbor_offsets()  # [27,3]
    cc = c[:, None, :] + off[None, :, :]  # [C,27,3]
    nk = _hash_coords(cc)  # [C,27]
    pos = jnp.searchsorted(grid.cell_keys, nk)  # [C,27]
    pos = jnp.minimum(pos, n - 1)
    hit = grid.cell_keys[pos] == nk
    start = grid.cell_start[pos]  # [C,27]
    count = grid.cell_count[pos]
    j = jnp.arange(cap)  # [cap]
    idx = jnp.minimum(start[..., None] + j, n - 1)  # [C,27,cap]
    ok = hit[..., None] & (j < count[..., None])
    return idx.reshape(idx.shape[0], -1), ok.reshape(ok.shape[0], -1)


def _chunked_query(fn, queries, chunk=_QUERY_CHUNK):
    """Apply fn to query chunks via lax.map (bounds the gather footprint).

    Pads to a multiple of the chunk size; callers mask invalid queries.
    Supports pytree outputs with leading query axis.
    """
    q = queries
    n = q.shape[0]
    if n <= chunk:
        return fn(q)
    n_pad = (-n) % chunk
    q_pad = jnp.pad(q, ((0, n_pad), (0, 0)))
    out = jax.lax.map(fn, q_pad.reshape(-1, chunk, q.shape[1]))
    return jax.tree.map(lambda x: x.reshape(-1, *x.shape[2:])[:n], out)


def min_sq_dist(grid: HashGrid, queries, query_mask, cap: int = 16):
    """Squared distance from each query to its nearest grid point among the
    27 adjacent voxels (exact for radii <= cell_size given sufficient cap).

    Returns [Q] f32, +inf where no candidate / query invalid.
    """

    def one_chunk(qc):
        idx, ok = _candidates(grid, qc, cap)  # [C, M]
        cand = grid.sorted_pts[idx]  # [C, M, 3]
        d2 = jnp.sum((qc[:, None, :] - cand) ** 2, axis=-1)
        d2 = jnp.where(ok, d2, jnp.inf)
        return jnp.min(d2, axis=1)

    best = _chunked_query(one_chunk, queries)
    return jnp.where(query_mask, best, jnp.inf)


def has_neighbor_within(grid: HashGrid, queries, query_mask, radius, cap: int = 16):
    """Boolean [Q]: nearest-neighbor distance <= radius (needs cell_size >=
    radius for exactness)."""
    return min_sq_dist(grid, queries, query_mask, cap=cap) <= radius * radius


def overlap_fraction(ref_pts, ref_mask, query_pts, query_mask, max_dist, cap: int = 16):
    """Fraction of valid query points with a ref neighbor within max_dist
    (getOverlap, DmsaSlam.h:377-414)."""
    grid = build_grid(ref_pts, ref_mask, max_dist)
    near = has_neighbor_within(grid, query_pts, query_mask, max_dist, cap=cap) & query_mask
    denom = jnp.maximum(jnp.sum(query_mask), 1)
    return jnp.sum(near) / denom


def knn_indices(grid: HashGrid, queries, query_mask, k: int, cap: int = 8):
    """Indices (into grid.sorted_pts) of the k nearest grid points per query.

    Candidates come from the 27 adjacent voxels (cap per voxel).  Returns
    (idx [Q, k], dist2 [Q, k], valid [Q, k]).
    """

    def one_chunk(qc):
        idx, ok = _candidates(grid, qc, cap)
        cand = grid.sorted_pts[idx]
        d2 = jnp.sum((qc[:, None, :] - cand) ** 2, axis=-1)
        d2 = jnp.where(ok, d2, jnp.inf)
        neg_d2, sel = jax.lax.top_k(-d2, k)
        out_idx = jnp.take_along_axis(idx, sel, axis=1)
        return out_idx.astype(jnp.int32), -neg_d2

    idx, d2 = _chunked_query(one_chunk, queries)
    valid = jnp.isfinite(d2) & query_mask[:, None]
    return idx, d2, valid
