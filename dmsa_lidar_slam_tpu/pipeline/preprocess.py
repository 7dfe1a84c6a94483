"""Scan preprocessing on device: adaptive random-grid downsampling, range
window, transform to the IMU frame.

Equivalent of DmsaSlam::preProcess (reference: include/DMSA/DmsaSlam.h:570-634):
try grids 0.4 / 0.3 / 0.2 / 0.15 m coarse-to-fine, keep the first whose
voxel count reaches max_num_points_per_scan (else the finest); then keep
points with range in (min_dist, max(range_sorted[max_num], minDistDS)).

Device version: all four voxel counts come from one pass each over the
padded raw scan; the chosen grid is a traced scalar so there's exactly one
jit cache entry per raw-capacity shape.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

GRID_LADDER = (0.4, 0.3, 0.2, 0.15)  # DmsaSlam.h:573-591


class PreprocessResult(NamedTuple):
    indices: jnp.ndarray  # [cap] indices into the raw scan
    mask: jnp.ndarray  # [cap] validity
    grid_size: jnp.ndarray  # [] chosen grid
    num_kept: jnp.ndarray  # [] may exceed cap -> caller logs overflow


@partial(jax.jit, static_argnames=("max_num_points", "cap"))
def preprocess_scan(
    raw_pts,  # [NR, 3] f32 lidar frame
    raw_mask,  # [NR]
    key,
    R_l2i,  # [3, 3] f32 lidar->imu rotation
    t_l2i,  # [3] f32
    max_num_points: int,
    min_dist_ds,  # minDistDS: ranges below always kept (Config.h:25)
    min_dist,
    cap: int,
) -> PreprocessResult:
    from dmsa_lidar_slam_tpu.ops import voxel

    # approximate (hashed) counts for the grid decision, all four ladder
    # levels in ONE key-only sort instead of a scatter occupancy count per
    # level; the actual downsampling below does the one real payload sort
    counts = voxel.count_voxels_ladder(raw_pts, raw_mask, GRID_LADDER)
    ladder = jnp.asarray(GRID_LADDER, dtype=raw_pts.dtype)
    # first grid (coarse->fine) with count >= max_num, else the finest
    reaches = counts >= max_num_points
    first = jnp.argmax(reaches)
    grid = jnp.where(jnp.any(reaches), ladder[first], ladder[-1])

    keep = voxel.random_downsample_mask(raw_pts, raw_mask, grid, key)

    ranges = jnp.linalg.norm(raw_pts, axis=1)
    ranges_sel = jnp.where(keep, ranges, jnp.inf)
    n_sel = jnp.sum(keep)
    sorted_r = jnp.sort(ranges_sel)
    pick = jnp.minimum(max_num_points, jnp.maximum(n_sel - 1, 0))
    thres = jnp.maximum(sorted_r[pick], min_dist_ds)

    final = keep & (ranges < thres) & (ranges > min_dist)
    num_kept = jnp.sum(final)

    idx, mask = voxel.compact(final, cap)
    return PreprocessResult(indices=idx, mask=mask, grid_size=grid, num_kept=num_kept)


def transform_to_imu(points, R_l2i, t_l2i):
    """p_imu = R p_lidar + t (pcl::transformPointCloud, DmsaSlam.h:626)."""
    return points @ R_l2i.T + t_l2i
