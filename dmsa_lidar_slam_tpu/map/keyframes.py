"""Keyframe ring-buffer map — the keyframe problem adapter.

Fixed-shape equivalent of the reference's MapManagement + KeyframeData
(reference: include/DMSA/MapManagement.h, KeyframeData.h): a fixed-capacity
buffer of keyframes, each a local PointNormal cloud + ring ids + grid size
+ measured gravity (+ plausibility) + captured relative-odometry prior;
keyframe poses as a consecutive relative chain; global map assembly;
gravity / odometry error terms; submap extraction and write-back; and the
shift-out-oldest add semantics.

Everything is padded to (n_keyframes, n_pts_per_kf); active keyframes are a
prefix mask, so submap optimization is a roll + mask instead of a copy.
"""

import dataclasses
from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.core import poses as cp
from dmsa_lidar_slam_tpu.core import rotations as rot
from dmsa_lidar_slam_tpu.dmsa.optimizer import ForwardOut

GRAVITY_W = (0.0, 0.0, -9.805)  # MapManagement.h:64
STD_DEV_ACC = 0.3  # MapManagement.h:48
ODOM_STD = 0.01  # MapManagement.h:69-70


@dataclasses.dataclass(frozen=True)
class MapShapes:
    n_keyframes: int  # last_n_keyframes_for_optim capacity
    n_pts_per_kf: int  # per-keyframe local cloud capacity


class KeyframeMapData(NamedTuple):
    """Pytree of the keyframe map state (fixed shapes)."""

    local_pts: jnp.ndarray  # [K, P, 3] f32, keyframe-local frame
    local_normals: jnp.ndarray  # [K, P, 3] f32
    pt_mask: jnp.ndarray  # [K, P] bool
    pt_ring: jnp.ndarray  # [K, P] i32
    grid_size: jnp.ndarray  # [K] f32
    kf_mask: jnp.ndarray  # [K] bool, active prefix
    # pose chain: anchor (pose 0) + relative poses (the optimizable part)
    anchor_orient: jnp.ndarray  # [3] pose dtype
    anchor_transl: jnp.ndarray  # [3]
    stamps: jnp.ndarray  # [K] f64 host epoch stamps
    # gravity factor inputs (MapManagement.h:210-232)
    grav_meas: jnp.ndarray  # [K, 3]
    grav_plausible: jnp.ndarray  # [K] bool
    # odometry prior captured at addKeyframe (MapManagement.h:339-355)
    odom_rel_transl: jnp.ndarray  # [K, 3]
    odom_rel_orient: jnp.ndarray  # [K, 3]
    gravity: jnp.ndarray  # [3]
    cov_grav_inv: jnp.ndarray  # [3, 3]
    odom_transl_cov_inv: jnp.ndarray  # [3, 3]
    odom_orient_cov_inv: jnp.ndarray  # [3, 3]
    balancing_grav: jnp.ndarray  # []
    balancing_odom: jnp.ndarray  # []


def normal_split_ids(normals_w):
    """Bucket world normals into 6 direction classes (dominant axis x sign).

    Fixed-shape stand-in for the reference's per-leaf opposed-normal-pair
    splitting (Gaussians.h:27-85): cells containing two opposing surfaces
    get split because their members land in different buckets.
    """
    ax = jnp.argmax(jnp.abs(normals_w), axis=-1)  # [..., ]
    # branch-free component pick: take_along_axis is a gather, and this
    # runs on every submap GN iteration over [S*P, 3] normals
    comp = jnp.where(
        ax == 0,
        normals_w[..., 0],
        jnp.where(ax == 1, normals_w[..., 1], normals_w[..., 2]),
    )
    return (ax * 2 + (comp > 0.0)).astype(jnp.int32)


def global_chain(params, data: KeyframeMapData, shapes: MapShapes):
    anchor = cp.PoseChain(
        orient=jnp.concatenate(
            [data.anchor_orient[None, :], jnp.zeros((shapes.n_keyframes - 1, 3), data.anchor_orient.dtype)]
        ),
        transl=jnp.concatenate(
            [data.anchor_transl[None, :], jnp.zeros((shapes.n_keyframes - 1, 3), data.anchor_transl.dtype)]
        ),
    )
    chain = cp.chain_from_params(params, anchor)
    gp = cp.relative2global(chain)
    return chain, gp


@lru_cache(maxsize=None)
def make_forward(shapes: MapShapes, use_gravity: bool, use_odometry: bool, use_split: bool):
    """ForwardOut function for keyframe/submap optimization."""

    def forward(params, data: KeyframeMapData) -> ForwardOut:
        chain, gp = global_chain(params, data, shapes)
        # quaternion rotate (VPU elementwise) instead of [K,3,3] batched
        # tiny-contraction matmuls — lowers much better under the
        # optimizer's vmapped line-search / Jacobian-tangent evaluations
        q = rot.axang2quat(gp.orient).astype(jnp.float32)[:, None, :]  # [K,1,4]
        t = gp.transl.astype(jnp.float32)

        pts_w = rot.quat_rotate(q, data.local_pts) + t[:, None, :]
        nrm_w = rot.quat_rotate(q, data.local_normals)

        mask = data.pt_mask & data.kf_mask[:, None]
        points = pts_w.reshape(-1, 3)
        normals = nrm_w.reshape(-1, 3)
        flat_mask = mask.reshape(-1)
        rings = data.pt_ring.reshape(-1)

        extras = []
        if use_gravity:
            extras.append(gravity_residuals(gp, data))
        if use_odometry:
            extras.append(odometry_residuals(chain, data))
        extra = (
            jnp.concatenate(extras)
            if extras
            else jnp.zeros((0,), dtype=params.dtype)
        )
        split = normal_split_ids(normals) if use_split else None
        return ForwardOut(
            points=points,
            mask=flat_mask,
            ring_ids=rings,
            obs_weight=None,
            extra=extra,
            split_ids=split,
        )

    return forward


@lru_cache(maxsize=None)
def make_structured(shapes: MapShapes, use_gravity: bool, use_odometry: bool, use_split: bool):
    """Structured-Jacobian forward for submap optimization (dmsa.optimizer).

    Each point depends only on its keyframe's global pose (q_k, t_k); the
    global poses depend on the P = 6(K-1) parameters through the tiny
    relative chain.  The pose-table Jacobian (Dq [K,4,P], Dt [K,3,P]) costs
    P tangents over the chain only, and the per-point contraction is a
    batched [P_pts,4]x[4,P] matmul per keyframe — no gathers
    (points are already laid out [K, P_pts, 3]).
    """

    def structured(params, data: KeyframeMapData):
        def tables(p):
            chain, gp = global_chain(p, data, shapes)
            q = rot.axang2quat(gp.orient)  # [K,4]
            extras = []
            if use_gravity:
                extras.append(gravity_residuals(gp, data))
            if use_odometry:
                extras.append(odometry_residuals(chain, data))
            extra = (
                jnp.concatenate(extras) if extras else jnp.zeros((0,), dtype=p.dtype)
            )
            return q, gp.transl, extra

        (q, t, extra), lin = jax.linearize(tables, params)
        p_dim = params.shape[0]
        eye = jnp.eye(p_dim, dtype=params.dtype)
        dq, dt_, j_extra = jax.vmap(lin)(eye)  # [P,K,4], [P,K,3], [P,M]

        q32 = q.astype(jnp.float32)[:, None, :]  # [K,1,4]
        t32 = t.astype(jnp.float32)
        pts_w = rot.quat_rotate(q32, data.local_pts) + t32[:, None, :]
        nrm_w = rot.quat_rotate(q32, data.local_normals)

        mask = data.pt_mask & data.kf_mask[:, None]
        points = pts_w.reshape(-1, 3)
        normals = nrm_w.reshape(-1, 3)
        flat_mask = mask.reshape(-1)
        rings = data.pt_ring.reshape(-1)
        split = normal_split_ids(normals) if use_split else None
        out = ForwardOut(
            points=points,
            mask=flat_mask,
            ring_ids=rings,
            obs_weight=None,
            extra=extra,
            split_ids=split,
        )

        gq = dq.astype(jnp.float32).transpose(1, 2, 0)  # [K,4,P]
        gt = dt_.astype(jnp.float32).transpose(1, 2, 0)  # [K,3,P]
        k, ppk = shapes.n_keyframes, shapes.n_pts_per_kf

        def contract(grad3_orig):
            g = grad3_orig.reshape(k, ppk, 3)
            aq = rot.quat_rotate_vjp_q(q32, data.local_pts, g)  # [K,Pp,4]
            jp = jnp.einsum("kpc,kcq->kpq", aq, gq) + jnp.einsum("kpc,kcq->kpq", g, gt)
            return jp.reshape(k * ppk, p_dim)

        return out, contract, j_extra.T

    return structured


@lru_cache(maxsize=None)
def make_tabular(shapes: MapShapes, use_gravity: bool, use_odometry: bool):
    """Tabular-problem adapter (ops.fused_residuals; consumed by
    dmsa.optimizer's tabular path and by parallel.spatial).

    The keyframe problem in table form: world point (k, j) =
    quat_rotate(q_k, x_kj) + t_k (MapManagement.h:120-149) — one table row
    per keyframe pose, point index = keyframe id, plus the trailing
    identity row that the TabularProblem contract requires.
    """
    from dmsa_lidar_slam_tpu.dmsa.optimizer import TabularProblem

    s = shapes.n_keyframes

    def tables(params, data: KeyframeMapData):
        chain, gp = global_chain(params, data, shapes)
        q = rot.axang2quat(gp.orient)  # [S,4]
        extras = []
        if use_gravity:
            extras.append(gravity_residuals(gp, data))
        if use_odometry:
            extras.append(odometry_residuals(chain, data))
        extra = jnp.concatenate(extras) if extras else jnp.zeros((0,), dtype=params.dtype)
        tab = jnp.concatenate(
            [q, gp.transl, jnp.zeros((s, 1), q.dtype)], axis=1
        ).astype(jnp.float32)
        ident = jnp.zeros((1, 8), jnp.float32).at[0, 0].set(1.0)
        return jnp.concatenate([tab, ident], axis=0), extra

    def point_arrays(data: KeyframeMapData):
        xs = data.local_pts.reshape(-1, 3).astype(jnp.float32)
        tidx = jnp.repeat(
            jnp.arange(s, dtype=jnp.int32), shapes.n_pts_per_kf, total_repeat_length=s * shapes.n_pts_per_kf
        )
        return xs, tidx

    return TabularProblem(n_table=s + 1, tables=tables, point_arrays=point_arrays)


def gravity_residuals(gp: cp.GlobalPoses, data: KeyframeMapData):
    """Gravity error terms (updateGravityErrors, MapManagement.h:210-232).

    Entry 0 is always zero, implausible / inactive keyframes contribute 0.
    Returns [K]."""
    R = rot.axang2rotm(gp.orient)  # [K,3,3]
    diff = jnp.einsum("kij,kj->ki", R, data.grav_meas.astype(gp.orient.dtype)) - data.gravity[None, :]
    quad = jnp.einsum("ki,ij,kj->k", diff, data.cov_grav_inv, diff) * data.balancing_grav
    k_idx = jnp.arange(gp.orient.shape[0])
    active = (k_idx > 0) & data.grav_plausible & data.kf_mask
    return jnp.where(active, jnp.sqrt(jnp.abs(quad) + 1e-30), 0.0)


def odometry_residuals(chain: cp.PoseChain, data: KeyframeMapData):
    """Odometry error terms (updateOdometryErrors, MapManagement.h:234-252).

    Returns [K-1] (k = 1..K-1), inactive entries 0."""
    pdt = chain.orient.dtype
    transl_diff = data.odom_rel_transl[1:].astype(pdt) - chain.transl[1:]
    R_cur = rot.axang2rotm(chain.orient[1:])
    R_prior = rot.axang2rotm(data.odom_rel_orient[1:].astype(pdt))
    orient_diff = rot.rotm2axang(jnp.einsum("kji,kjl->kil", R_cur, R_prior))
    quad = jnp.einsum("ki,ij,kj->k", transl_diff, data.odom_transl_cov_inv, transl_diff)
    quad = quad + jnp.einsum("ki,ij,kj->k", orient_diff, data.odom_orient_cov_inv, orient_diff)
    quad = quad * data.balancing_odom
    active = data.kf_mask[1:]
    return jnp.where(active, jnp.sqrt(jnp.abs(quad) + 1e-30), 0.0)


def min_grid_size(data: KeyframeMapData):
    """Minimum grid size over active keyframes (MapManagement.h:126-131)."""
    return jnp.min(jnp.where(data.kf_mask, data.grid_size, jnp.inf))


def global_points(params, data: KeyframeMapData, shapes: MapShapes):
    """Assembled global map with normals (updateGlobalPoints,
    MapManagement.h:120-149).  Returns (points [K*P,3], normals, mask, rings)."""
    out = make_forward(shapes, False, False, False)(params, data)
    chain, gp = global_chain(params, data, shapes)
    R = rot.axang2rotm(gp.orient).astype(jnp.float32)
    nrm_w = jnp.einsum("kij,kpj->kpi", R, data.local_normals).reshape(-1, 3)
    return out.points, nrm_w, out.mask, out.ring_ids
