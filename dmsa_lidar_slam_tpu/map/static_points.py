"""Static-point selection, visibility, and overlap for the sliding window.

Equivalent of DmsaSlam::addStaticPoints / isVisible / getOverlap
(reference: include/DMSA/DmsaSlam.h:264-414): the per-point kd-tree loops
become batched exact nearest-neighbour sweeps (ops.nn_bruteforce) over the
candidate keyframes' global clouds.

All shapes are static: S candidate keyframes x P points each; the caller
gathers the candidate keyframes host-side (closest-k + distance gate).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.ops import nn_bruteforce, voxel


class StaticSelection(NamedTuple):
    static_pts: jnp.ndarray  # [cap, 3] world frame
    static_mask: jnp.ndarray  # [cap]
    static_ring: jnp.ndarray  # [cap]
    overlap_counts: jnp.ndarray  # [S] selected points per candidate keyframe
    overlap_fraction: jnp.ndarray  # [] window-vs-static overlap ratio
    num_selected: jnp.ndarray  # [] before downsampling
    num_active: jnp.ndarray  # [] after downsampling (may exceed cap -> log)


def visibility(curr_pos, points, normals):
    """Plane-based visibility test (isVisible, DmsaSlam.h:360-375)."""
    d = jnp.sum(points * normals, axis=-1)
    r = jnp.sum(normals * curr_pos, axis=-1)
    return (r - d) >= -1e-5


@partial(jax.jit, static_argnames=("cap",))
def select_static_points(
    window_pts,  # [NW, 3] current global window points
    window_mask,  # [NW]
    kf_pts,  # [S, P, 3] candidate keyframes' global clouds
    kf_normals,  # [S, P, 3] world-frame normals
    kf_rings,  # [S, P]
    kf_pt_mask,  # [S, P]
    curr_pos,  # [3] f32 current position (window start)
    min_grid,  # [] f32
    key,  # PRNG key for the random downsampling
    cap: int,  # static-point capacity
) -> StaticSelection:
    S, P, _ = kf_pts.shape

    q = kf_pts.reshape(-1, 3)
    qm = kf_pt_mask.reshape(-1)
    near = nn_bruteforce.has_neighbor_within(window_pts, window_mask, q, qm, min_grid)

    vis = visibility(curr_pos, kf_pts, kf_normals).reshape(-1)
    selected = near & vis & qm  # [S*P]

    overlap_counts = jnp.sum(selected.reshape(S, P), axis=1)
    num_selected = jnp.sum(selected)

    # random-grid downsample the selected set at min_grid / 2
    # (DmsaSlam.h:347-349)
    keep = voxel.random_downsample_mask(q, selected, min_grid / 2.0, key)
    num_active = jnp.sum(keep)
    idx, out_mask = voxel.compact(keep, cap)
    static_pts = q[idx]
    static_ring = kf_rings.reshape(-1)[idx]

    # overlap of the window cloud against the active static points
    # (getOverlap, DmsaSlam.h:354,377-414)
    near_w = (
        nn_bruteforce.has_neighbor_within(static_pts, out_mask, window_pts, window_mask, min_grid)
        & window_mask
    )
    overlap_fraction = jnp.where(
        num_active > 0,
        jnp.sum(near_w) / jnp.maximum(jnp.sum(window_mask), 1),
        0.0,
    )

    return StaticSelection(
        static_pts=static_pts,
        static_mask=out_mask,
        static_ring=static_ring,
        overlap_counts=overlap_counts,
        overlap_fraction=overlap_fraction,
        num_selected=num_selected,
        num_active=num_active,
    )
