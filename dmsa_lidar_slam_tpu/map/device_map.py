"""Device-resident keyframe map: pure-function mutators, zero host syncs.

The host-side KeyframeMap (map.management) mirrors the reference's C++
mutation style; this module re-expresses the same semantics as pure
functions over a device pytree so the whole keyframe lifecycle — add with
shift-out-oldest (MapManagement.h:311-389), closest-k candidate query
(:88-118), submap extraction (:254-276) and write-back (:278-288) — runs
inside the fused per-scan jit step with traced control flow.
"""

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.core import poses as cp
from dmsa_lidar_slam_tpu.core import rotations as rot
from dmsa_lidar_slam_tpu.map import keyframes as kfm


class DeviceMapState(NamedTuple):
    local_pts: jnp.ndarray  # [K, P, 3] f32, keyframe-local
    local_normals: jnp.ndarray  # [K, P, 3] f32
    pt_mask: jnp.ndarray  # [K, P]
    pt_ring: jnp.ndarray  # [K, P] i32
    grid_size: jnp.ndarray  # [K] f32
    orient_w: jnp.ndarray  # [K, 3] pose dtype
    transl_w: jnp.ndarray  # [K, 3]
    stamps: jnp.ndarray  # [K] f64, relative to the run's stamp base
    grav_meas: jnp.ndarray  # [K, 3]
    grav_plausible: jnp.ndarray  # [K]
    odom_rel_orient: jnp.ndarray  # [K, 3]
    odom_rel_transl: jnp.ndarray  # [K, 3]
    count: jnp.ndarray  # [] i32
    num_updates: jnp.ndarray  # [] i32


def empty_state(shapes: kfm.MapShapes, pose_dtype) -> DeviceMapState:
    K, P = shapes.n_keyframes, shapes.n_pts_per_kf
    return DeviceMapState(
        local_pts=jnp.zeros((K, P, 3), jnp.float32),
        local_normals=jnp.zeros((K, P, 3), jnp.float32),
        pt_mask=jnp.zeros((K, P), bool),
        pt_ring=jnp.zeros((K, P), jnp.int32),
        grid_size=jnp.full((K,), jnp.inf, jnp.float32),
        orient_w=jnp.zeros((K, 3), pose_dtype),
        transl_w=jnp.zeros((K, 3), pose_dtype),
        stamps=jnp.zeros((K,), jnp.float64),
        grav_meas=jnp.zeros((K, 3), pose_dtype),
        grav_plausible=jnp.zeros((K,), bool),
        odom_rel_orient=jnp.zeros((K, 3), pose_dtype),
        odom_rel_transl=jnp.zeros((K, 3), pose_dtype),
        count=jnp.asarray(0, jnp.int32),
        num_updates=jnp.asarray(0, jnp.int32),
    )


def _rel_pose(o_prev, t_prev, o_curr, t_curr):
    R_prev = rot.axang2rotm(o_prev)
    R_curr = rot.axang2rotm(o_curr)
    rel_o = rot.rotm2axang(R_prev.T @ R_curr)
    rel_t = R_prev.T @ (t_curr - t_prev)
    return rel_o, rel_t


def add_keyframe(
    state: DeviceMapState,
    position_w,
    orient_w,
    stamp,
    pts_local,  # [P, 3]
    normals,  # [P, 3]
    rings,  # [P]
    pt_mask,  # [P]
    grid_size,
    grav_meas,
    grav_plausible,
):
    """Pure add-with-shift (MapManagement.h:311-389).

    Returns (new_state, retired_orient, retired_transl, retired_stamp,
    retired_valid) — the oldest keyframe's pose when the buffer was full
    (for the output ledger; DmsaSlam.h:549-553).
    """
    K = state.orient_w.shape[0]
    full = state.count >= K

    retired_o = state.orient_w[0]
    retired_t = state.transl_w[0]
    retired_stamp = state.stamps[0]

    def maybe_shift(x):
        return jnp.where(full, jnp.roll(x, -1, axis=0), x)

    shifted = jax.tree.map(maybe_shift, state._replace(count=None, num_updates=None)._asdict())
    idx = jnp.where(full, K - 1, state.count)

    def set_row(arr, value):
        return arr.at[idx].set(value)

    prev_idx = jnp.maximum(idx - 1, 0)
    prev_o = jnp.where(idx > 0, shifted["orient_w"][prev_idx], jnp.zeros_like(retired_o))
    prev_t = jnp.where(idx > 0, shifted["transl_w"][prev_idx], jnp.zeros_like(retired_t))
    rel_o, rel_t = _rel_pose(prev_o, prev_t, orient_w, position_w)
    rel_o = jnp.where(idx > 0, rel_o, orient_w)
    rel_t = jnp.where(idx > 0, rel_t, position_w)

    new_state = DeviceMapState(
        local_pts=set_row(shifted["local_pts"], pts_local),
        local_normals=set_row(shifted["local_normals"], normals),
        pt_mask=set_row(shifted["pt_mask"], pt_mask),
        pt_ring=set_row(shifted["pt_ring"], rings),
        grid_size=set_row(shifted["grid_size"], grid_size),
        orient_w=set_row(shifted["orient_w"], orient_w),
        transl_w=set_row(shifted["transl_w"], position_w),
        stamps=set_row(shifted["stamps"], stamp),
        grav_meas=set_row(shifted["grav_meas"], grav_meas),
        grav_plausible=set_row(shifted["grav_plausible"], grav_plausible),
        odom_rel_orient=set_row(shifted["odom_rel_orient"], rel_o),
        odom_rel_transl=set_row(shifted["odom_rel_transl"], rel_t),
        count=jnp.minimum(state.count + 1, K),
        num_updates=state.num_updates + 1,
    )
    return new_state, retired_o, retired_t, retired_stamp, full


def closest_candidates(state: DeviceMapState, pos_w, n_candidates: int, max_dist):
    """Top-n closest active keyframes within max_dist (getClosestNIds +
    distance gate, MapManagement.h:88-118 / DmsaSlam.h:296-303).

    Returns (ids [S], valid [S])."""
    K = state.orient_w.shape[0]
    active = jnp.arange(K) < state.count
    d = jnp.linalg.norm(state.transl_w - pos_w[None, :], axis=1)
    d = jnp.where(active, d, jnp.inf)
    neg_d, ids = jax.lax.top_k(-d, n_candidates)
    dist = -neg_d
    valid = jnp.isfinite(dist) & (dist < max_dist)
    return ids, valid


def candidate_clouds(state: DeviceMapState, ids, valid):
    """World-frame clouds+normals of the candidate keyframes [S, P, 3]."""
    R = rot.axang2rotm(state.orient_w[ids]).astype(jnp.float32)  # [S,3,3]
    t = state.transl_w[ids].astype(jnp.float32)
    pts = jnp.einsum("sij,spj->spi", R, state.local_pts[ids]) + t[:, None, :]
    nrm = jnp.einsum("sij,spj->spi", R, state.local_normals[ids])
    mask = state.pt_mask[ids] & valid[:, None]
    rings = state.pt_ring[ids]
    return pts, nrm, rings, mask


def submap_view(state: DeviceMapState, from_id, balancing_grav, balancing_odom, cov_grav_inv, odom_t_cov_inv, odom_r_cov_inv, gravity):
    """Keyframe-problem data for the suffix [from_id..count-1], rolled so
    from_id lands in slot 0 (getSubmap, MapManagement.h:254-276).

    Returns (KeyframeMapData, params0 [6 (K-1)]).
    """
    K = state.orient_w.shape[0]
    m = state.count - from_id

    def roll(x):
        return jnp.roll(x, -from_id, axis=0)

    orient_r = roll(state.orient_w)
    transl_r = roll(state.transl_w)
    gp = cp.GlobalPoses(orient=orient_r, transl=transl_r)
    chain = cp.global2relative(gp)
    params0 = cp.params_from_chain(chain)

    kf_mask = jnp.arange(K) < m
    data = kfm.KeyframeMapData(
        local_pts=roll(state.local_pts),
        local_normals=roll(state.local_normals),
        pt_mask=roll(state.pt_mask),
        pt_ring=roll(state.pt_ring),
        grid_size=jnp.where(kf_mask, roll(state.grid_size), jnp.inf),
        kf_mask=kf_mask,
        anchor_orient=chain.orient[0],
        anchor_transl=chain.transl[0],
        stamps=roll(state.stamps),
        grav_meas=roll(state.grav_meas),
        grav_plausible=roll(state.grav_plausible),
        odom_rel_transl=roll(state.odom_rel_transl),
        odom_rel_orient=roll(state.odom_rel_orient),
        gravity=gravity,
        cov_grav_inv=cov_grav_inv,
        odom_transl_cov_inv=odom_t_cov_inv,
        odom_orient_cov_inv=odom_r_cov_inv,
        balancing_grav=balancing_grav,
        balancing_odom=balancing_odom,
    )
    return data, params0


def submap_view_capped(
    state: DeviceMapState,
    from_id,
    n_submap: int,
    balancing_grav,
    balancing_odom,
    cov_grav_inv,
    odom_t_cov_inv,
    odom_r_cov_inv,
    gravity,
):
    """Compact submap: the suffix [from_id..count-1] materialized at a FIXED
    small shape [n_submap, P] instead of the full padded map.

    The caller must guarantee count - from_id <= n_submap (clamp from_id up
    to count - n_submap first). This bounds the submap optimization cost by
    n_submap regardless of map capacity — the fixed-shape analogue of the
    reference's variable-size getSubmap (MapManagement.h:254-276), which in
    practice also spans only the few most recent keyframes (minRelatedKeyId
    comes from the closest-k static-point candidates, DmsaSlam.h:212-238).

    Returns (KeyframeMapData with K=n_submap, params0 [6 (n_submap-1)]).
    """
    S = n_submap
    m = state.count - from_id

    def take(x):
        return jnp.roll(x, -from_id, axis=0)[:S]

    orient_r = take(state.orient_w)
    transl_r = take(state.transl_w)
    gp = cp.GlobalPoses(orient=orient_r, transl=transl_r)
    chain = cp.global2relative(gp)
    params0 = cp.params_from_chain(chain)

    kf_mask = jnp.arange(S) < m
    data = kfm.KeyframeMapData(
        local_pts=take(state.local_pts),
        local_normals=take(state.local_normals),
        pt_mask=take(state.pt_mask),
        pt_ring=take(state.pt_ring),
        grid_size=jnp.where(kf_mask, take(state.grid_size), jnp.inf),
        kf_mask=kf_mask,
        anchor_orient=chain.orient[0],
        anchor_transl=chain.transl[0],
        stamps=take(state.stamps),
        grav_meas=take(state.grav_meas),
        grav_plausible=take(state.grav_plausible),
        odom_rel_transl=take(state.odom_rel_transl),
        odom_rel_orient=take(state.odom_rel_orient),
        gravity=gravity,
        cov_grav_inv=cov_grav_inv,
        odom_transl_cov_inv=odom_t_cov_inv,
        odom_orient_cov_inv=odom_r_cov_inv,
        balancing_grav=balancing_grav,
        balancing_odom=balancing_odom,
    )
    return data, params0


def write_back_capped(state: DeviceMapState, from_id, params):
    """updatePosesFromSubmap for a capped submap: params [6 (S-1)] from
    submap_view_capped, recompose globals of keyframes (from_id..count-1],
    keyframe from_id anchored (MapManagement.h:278-288)."""
    K = state.orient_w.shape[0]
    S = params.shape[0] // 6 + 1
    anchor = cp.PoseChain(
        orient=jnp.concatenate(
            [state.orient_w[from_id][None], jnp.zeros((S - 1, 3), state.orient_w.dtype)]
        ),
        transl=jnp.concatenate(
            [state.transl_w[from_id][None], jnp.zeros((S - 1, 3), state.transl_w.dtype)]
        ),
    )
    chain = cp.chain_from_params(params, anchor)
    gp = cp.relative2global(chain)
    # pad the S-slot result to K rows, then roll so slot j -> keyframe
    # from_id + j
    pad = [(0, K - S), (0, 0)]
    new_orient = jnp.roll(jnp.pad(gp.orient, pad), from_id, axis=0)
    new_transl = jnp.roll(jnp.pad(gp.transl, pad), from_id, axis=0)
    k_idx = jnp.arange(K)
    write = (k_idx > from_id) & (k_idx < state.count) & (k_idx < from_id + S)
    return state._replace(
        orient_w=jnp.where(write[:, None], new_orient, state.orient_w),
        transl_w=jnp.where(write[:, None], new_transl, state.transl_w),
    )


def write_back(state: DeviceMapState, from_id, params):
    """updatePosesFromSubmap (MapManagement.h:278-288): recompose globals of
    keyframes > from_id from the optimized relative chain (keyframe from_id
    anchored), leaving others untouched."""
    K = state.orient_w.shape[0]
    anchor = cp.PoseChain(
        orient=jnp.concatenate(
            [state.orient_w[from_id][None], jnp.zeros((K - 1, 3), state.orient_w.dtype)]
        ),
        transl=jnp.concatenate(
            [state.transl_w[from_id][None], jnp.zeros((K - 1, 3), state.transl_w.dtype)]
        ),
    )
    chain = cp.chain_from_params(params, anchor)
    gp = cp.relative2global(chain)
    # slot j of the rolled frame corresponds to keyframe from_id + j
    new_orient = jnp.roll(gp.orient, from_id, axis=0)
    new_transl = jnp.roll(gp.transl, from_id, axis=0)
    k_idx = jnp.arange(K)
    write = (k_idx > from_id) & (k_idx < state.count)
    return state._replace(
        orient_w=jnp.where(write[:, None], new_orient, state.orient_w),
        transl_w=jnp.where(write[:, None], new_transl, state.transl_w),
    )


def min_grid_from(state: DeviceMapState, from_id):
    k_idx = jnp.arange(state.grid_size.shape[0])
    sel = (k_idx >= from_id) & (k_idx < state.count)
    return jnp.min(jnp.where(sel, state.grid_size, jnp.inf))
