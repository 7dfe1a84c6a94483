"""Voxel-grid binning and random-grid downsampling on device.

Tree-free replacement for the reference's PCL octree usage: the octree
build per optimizer iteration (DmsaOptimizer.h:275-350) and the
random-point-per-voxel downsampling (helpers.h:67-182) both become
sort + segment reductions over packed voxel keys — fixed shapes, no trees.

Voxel identity is a pair of int32 keys (no int64 keys):
key_hi = (ix << 16) | iy, key_lo = iz, with grid coordinates offset into
[0, 2^15).  Points are lexsorted by (hi, lo); contiguous runs of equal keys
are the voxel cells.  Invalid (masked) points get the maximal key so they
sort to the end and never merge with a real cell.

Determinism: the reference seeds rand() with time(0) (helpers.h:85); here
random voxel sampling uses counter-based jax PRNG keys supplied by the
caller.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

_COORD_OFFSET = 1 << 14  # grid coords shifted into [0, 2^15)
_INVALID_HI = jnp.iinfo(jnp.int32).max


class VoxelBinning(NamedTuple):
    """Result of binning N points into voxel cells (fixed shapes, size N).

    order      [N] permutation sorting points by voxel key (invalid last)
    seg_ids    [N] cell index per *sorted* point, in [0, N); invalid -> N - 1
               area shared with valid tail cells is avoided via valid mask
    point_cell [N] cell index per *original* point (N-1 sentinel if invalid)
    num_cells  [] int32, number of occupied cells (valid points only)
    """

    order: jnp.ndarray
    seg_ids: jnp.ndarray
    point_cell: jnp.ndarray
    num_cells: jnp.ndarray


def voxel_coords(points, grid_size):
    """Integer voxel coordinates [N, 3] (floor of p / grid)."""
    return jnp.floor(points / grid_size).astype(jnp.int32) + _COORD_OFFSET


def voxel_keys(points, mask, grid_size, channel=None):
    """Packed (hi, lo) int32 voxel keys; invalid points get the max key.

    `channel` [N] (small non-negative ints < 8) optionally subdivides each
    voxel — used for normal-based cell splitting (Gaussians.h:27-85).
    """
    c = voxel_coords(points, grid_size)
    hi = (c[:, 0] << 16) | (c[:, 1] & 0xFFFF)
    lo = c[:, 2]
    if channel is not None:
        lo = (lo << 3) | (channel & 0x7)
    hi = jnp.where(mask, hi, _INVALID_HI)
    lo = jnp.where(mask, lo, _INVALID_HI)
    return hi, lo


def bin_points(points, mask, grid_size, channel=None) -> VoxelBinning:
    """Bin masked points [N, 3] into voxel cells of size grid_size."""
    n = points.shape[0]
    hi, lo = voxel_keys(points, mask, grid_size, channel)
    order = jnp.lexsort((lo, hi))
    hi_s = hi[order]
    lo_s = lo[order]
    valid_s = mask[order]

    new_cell = jnp.concatenate(
        [
            jnp.ones((1,), dtype=jnp.int32),
            ((hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])).astype(jnp.int32),
        ]
    )
    seg_ids = jnp.cumsum(new_cell) - 1  # [N], 0-based cell ids in sorted order
    num_cells = jnp.where(jnp.any(valid_s), jnp.max(jnp.where(valid_s, seg_ids, -1)) + 1, 0)
    seg_ids = jnp.minimum(seg_ids, n - 1)

    inv_order = jnp.argsort(order)
    point_cell = seg_ids[inv_order]
    point_cell = jnp.where(mask, point_cell, n - 1)
    return VoxelBinning(order=order, seg_ids=seg_ids, point_cell=point_cell, num_cells=num_cells)


class RunBinning(NamedTuple):
    """Scatter-free voxel binning: cells as contiguous runs of the sort.

    Cells are identified by the *sorted position of their first member*
    ("run-start slots"), so no compact cell-id relabeling — and therefore no
    scatter / inverse permutation — is ever needed.  All arrays are length N
    over sorted positions.

    order       [N] permutation sorting points by voxel key (invalid last)
    new_cell    [N] bool, True where a new run (cell) starts
    start       [N] int32, run-start position of each point's cell
    end         [N] int32, one-past-last position of each point's run
    num_cells   []  int32, occupied cells among valid points
    """

    order: jnp.ndarray
    new_cell: jnp.ndarray
    start: jnp.ndarray
    end: jnp.ndarray
    num_cells: jnp.ndarray


def bin_runs(points, mask, grid_size, channel=None, payload=None):
    """Bin points into voxel runs (sort + cummax/cummin only).

    Replaces the segment-id formulation for the optimizer's per-iteration
    cell builds: run boundaries come from one forward cummax and one reverse
    cummin over the sorted keys — no scatters, no argsort inverse.

    `payload` (optional [N, W] f32) rides THROUGH the sort as extra
    operands of lax.sort, so callers get their per-point data already in
    sorted order without separate per-row permutation gathers.
    Returns RunBinning, or (RunBinning, payload_sorted) when payload given.
    """
    n = points.shape[0]
    hi, lo = voxel_keys(points, mask, grid_size, channel)
    iota = jnp.arange(n, dtype=jnp.int32)
    operands = [hi, lo, iota, mask]
    if payload is not None:
        operands += [payload[:, i] for i in range(payload.shape[1])]
    sorted_ops = jax.lax.sort(tuple(operands), num_keys=2, is_stable=True)
    hi_s, lo_s, order, valid_s = sorted_ops[:4]

    new_cell = jnp.concatenate(
        [
            jnp.ones((1,), dtype=bool),
            (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1]),
        ]
    )
    start = jax.lax.cummax(jnp.where(new_cell, iota, 0))
    # end of each point's run = first boundary strictly after it
    bpos = jnp.where(new_cell, iota, n)
    suffix_min = jax.lax.cummin(bpos, reverse=True)
    end = jnp.concatenate([suffix_min[1:], jnp.full((1,), n, jnp.int32)])
    num_cells = jnp.sum((new_cell & valid_s).astype(jnp.int32))
    rb = RunBinning(order=order, new_cell=new_cell, start=start, end=end, num_cells=num_cells)
    if payload is None:
        return rb
    return rb, jnp.stack(sorted_ops[4:], axis=1)


def run_sums(values, start, end):
    """Per-run sums of contiguous sorted runs, broadcast to every member.

    values [N, W] in sorted order; start/end [N] per-point run boundaries
    (bin_runs).  One log-depth cumsum + two [N, W] gathers; rows at
    run-start positions hold the full run sum (as do all other members).
    """
    n = values.shape[0]
    p_incl = jnp.cumsum(values, axis=0)  # [N, W]
    p_excl = p_incl - values
    last = jnp.minimum(end - 1, n - 1)
    return p_incl[last] - p_excl[start]


def random_downsample_mask(points, mask, grid_size, key):
    """Random-grid downsampling: keep one uniformly random point per voxel.

    Functional equivalent of randomGridDownsampling (helpers.h:67-106) with
    counter-based PRNG instead of srand(time(0)).  Returns a boolean keep
    mask [N] (true for exactly one valid point per occupied voxel).

    One lax.sort by (voxel key, random priority): the first member of each
    run is a uniformly random member of its voxel, so keep = run-start flag
    scattered back through the sort permutation — no segment_min scatter,
    no inverse-permutation argsort, no priority gathers (those dominated
    the preprocessing device profile).
    """
    n = points.shape[0]
    hi, lo = voxel_keys(points, mask, grid_size)
    prio = jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)
    iota = jnp.arange(n, dtype=jnp.int32)
    hi_s, lo_s, _, order, valid_s = jax.lax.sort(
        (hi, lo, prio, iota, mask), num_keys=3, is_stable=False
    )
    new_cell = jnp.concatenate(
        [
            jnp.ones((1,), dtype=bool),
            (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1]),
        ]
    )
    keep_sorted = new_cell & valid_s
    keep = jnp.zeros(n, dtype=bool).at[order].set(keep_sorted)
    return keep & mask


def compact(mask, cap: int):
    """Pack the True entries of `mask` [N] to the front, capped at `cap`.

    Returns (indices [cap], out_mask [cap]).  Stable order.  Overflow beyond
    `cap` is dropped (callers should log `mask.sum()` vs cap — no silent
    truncation policy).
    """
    order = jnp.argsort(~mask, stable=True)
    idx = order[:cap]
    count = jnp.sum(mask)
    out_mask = jnp.arange(cap) < count
    return idx, out_mask


def count_voxels(points, mask, grid_size):
    """Number of occupied voxels (exact; sorts the points)."""
    return bin_points(points, mask, grid_size).num_cells


_DC_CACHE = {}


def downsample_compact(points, mask, rings, grid_size, key, cap: int):
    """Random-grid downsample + pack to `cap` slots, one fused jit call.

    Returns (points [cap,3], rings [cap], out_mask [cap], total_kept []).
    """
    if cap not in _DC_CACHE:

        def f(points, mask, rings, grid_size, key):
            keep = random_downsample_mask(points, mask, grid_size, key)
            idx, out_mask = compact(keep, cap)
            return points[idx], rings[idx], out_mask, jnp.sum(keep)

        _DC_CACHE[cap] = jax.jit(f)
    return _DC_CACHE[cap](points, mask, rings, grid_size, key)


def count_voxels_ladder(points, mask, grids):
    """Occupied-voxel counts at ALL ladder grid sizes in ONE key-only sort.

    Returns [len(grids)] i32.  One sort of the concatenated
    (ladder_id << 28 | voxel_hash) keys replaces a scatter-based occupancy
    count per grid, and counts distinct keys by run boundaries.  28-bit hashes collide
    less than the scatter table's 18 bits, so counts sit CLOSER to the
    exact octree counts of the reference ladder (DmsaSlam.h:570-591).
    """
    n = points.shape[0]
    keys = []
    sentinel = jnp.uint32(0x0FFFFFFF)
    for li, g in enumerate(grids):
        c = voxel_coords(points, g).astype(jnp.uint32)
        h = (c[:, 0] * jnp.uint32(73856093)) ^ (c[:, 1] * jnp.uint32(19349663)) ^ (
            c[:, 2] * jnp.uint32(83492791)
        )
        h = h ^ (h >> 15)  # mix before truncation to 28 bits
        h = h & sentinel
        h = jnp.where(h == sentinel, jnp.uint32(0), h)  # keep sentinel unique
        h = jnp.where(mask, h, sentinel)
        keys.append((jnp.uint32(li << 28) | h).astype(jnp.int32))
    k = jnp.concatenate(keys)
    ks = jax.lax.sort((k,), num_keys=1, is_stable=False)[0]
    newc = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    valid = (ks & jnp.int32(0x0FFFFFFF)) != jnp.int32(0x0FFFFFFF)
    lid = jax.lax.shift_right_logical(ks, jnp.asarray(28, ks.dtype))
    counts = []
    for li in range(len(grids)):
        counts.append(jnp.sum(newc & valid & (lid == li), dtype=jnp.int32))
    return jnp.stack(counts)
