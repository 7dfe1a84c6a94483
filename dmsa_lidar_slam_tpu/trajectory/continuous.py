"""Continuous-time sliding-window trajectory — the window problem adapter.

Fixed-shape equivalent of the reference's ContinuousTrajectory (reference:
include/DMSA/ContinuousTrajectory.h): a handful of control poses over the
window, a dense pose table at ~dt_res, barycentric-rational interpolation of
translations + slerp of orientations onto the dense grid, per-point
transform indices, deskew, IMU preintegration factors between control
poses, IMU error terms, gravity initialization, and the window initial
guess (interpolation of the previous window + IMU dead-reckoning).

Shape discipline: the dense grid has a FIXED length `n_dense`; the grid
step dt = horizon / (n_dense - 1) varies slightly per window instead of the
reference's fixed dt_res with varying n_total (ContinuousTrajectory.h:310).
Control stamps sit exactly on dense samples: (n_dense - 1) must be
divisible by (n_ctrl - 1), so control-interval boundaries are static
indices and all IMU intervals have equal static length (vmap-able).

Pose math runs in the pose dtype (f64 on CPU / f32 on GPU — see
utils.dtypes); the per-point deskew runs in f32 like the reference's
Matrix4f dense transforms (ContinuousTrajectory.h:31).
"""

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.core import interpolation as interp
from dmsa_lidar_slam_tpu.core import poses as cp
from dmsa_lidar_slam_tpu.core import rotations as rot
from dmsa_lidar_slam_tpu.dmsa.optimizer import ForwardOut
from dmsa_lidar_slam_tpu.imu import preintegration as preint_mod

GRAVITY_W = (0.0, 0.0, -9.805)  # ContinuousTrajectory.h:345


@dataclasses.dataclass(frozen=True)
class WindowShapes:
    n_window_pts: int  # capacity for deskewed scan points
    n_static: int  # capacity for fixed map points
    n_ctrl: int = 6  # num_control_poses (Config.h:20)
    n_dense: int = 501  # dense pose table length

    def __post_init__(self):
        assert (self.n_dense - 1) % (self.n_ctrl - 1) == 0, (
            "control stamps must land on dense samples"
        )

    @property
    def interval_len(self) -> int:
        return (self.n_dense - 1) // (self.n_ctrl - 1)

    @property
    def param_indices(self):
        return tuple(k * self.interval_len for k in range(self.n_ctrl))


class WindowData(NamedTuple):
    """Pytree of one sliding window's state (fixed shapes)."""

    # scan points in the IMU/body frame (deskew sources)
    local_pts: jnp.ndarray  # [NW, 3] f32
    pt_mask: jnp.ndarray  # [NW] bool
    pt_ring: jnp.ndarray  # [NW] i32
    pt_tform_idx: jnp.ndarray  # [NW] i32, dense-table index per point
    # static map points, world frame (DmsaSlam.h:264-358)
    static_pts: jnp.ndarray  # [NS, 3] f32
    static_mask: jnp.ndarray  # [NS] bool
    static_ring: jnp.ndarray  # [NS] i32
    # gauge anchor = pose 0 of the relative chain (excluded from params)
    anchor_orient: jnp.ndarray  # [3] pose dtype
    anchor_transl: jnp.ndarray  # [3]
    # timing
    ctrl_stamps: jnp.ndarray  # [C] seconds, relative to window t0
    dt: jnp.ndarray  # [] dense grid step
    horizon: jnp.ndarray  # []
    # dense-resampled IMU
    acc_dense: jnp.ndarray  # [D, 3]
    gyr_dense: jnp.ndarray  # [D, 3]
    gravity: jnp.ndarray  # [3]
    # preintegrated factors per control interval (i <-> reference k=i+1)
    preint_rot: jnp.ndarray  # [C-1, 3, 3]
    preint_vel: jnp.ndarray  # [C-1, 3]
    preint_pos: jnp.ndarray  # [C-1, 3]
    cov_inv: jnp.ndarray  # [C-1, 9, 9]
    preint_pos_full: jnp.ndarray  # [3] full-horizon preint position
    balancing_imu: jnp.ndarray  # []


def dense_times(data: WindowData, shapes: WindowShapes):
    return jnp.arange(shapes.n_dense, dtype=data.dt.dtype) * data.dt


def ctrl_stamps_from_dt(dt, shapes: WindowShapes):
    idx = jnp.array(shapes.param_indices, dtype=dt.dtype)
    return idx * dt


@lru_cache(maxsize=None)
def _dense_poses_jit(shapes: WindowShapes):
    import jax

    return jax.jit(lambda p, d: dense_poses(p, d, shapes))


def dense_poses_jit(params, data, shapes: WindowShapes):
    """jit-compiled dense_poses (the per-scan host path must not run
    eagerly: op-by-op dispatch costs one launch per op)."""
    return _dense_poses_jit(shapes)(params, data)


@lru_cache(maxsize=None)
def _uniform_consts(shapes: WindowShapes):
    return interp.uniform_grid_consts(shapes.n_dense, shapes.n_ctrl, shapes.interval_len, d=2)


def dense_pose_tables(params, data: WindowData, shapes: WindowShapes):
    """Control chain -> dense pose table (updateTrajDenseTforms,
    ContinuousTrajectory.h:189-226), as (chain, gp, q_dense [D,4],
    d_transl [D,3]).

    Control stamps ALWAYS sit on the uniform dense grid (WindowShapes
    asserts it; ctrl_stamps come from ctrl_stamps_from_dt), so the
    barycentric matrix and slerp brackets are dt-invariant compile-time
    constants: translations are one [D, C] matmul and orientations one
    constant gather + batched slerp — instead of the ~200-op generic
    interpolation chain, on the hot path of every residual evaluation.
    """
    anchor = cp.PoseChain(
        orient=data.anchor_orient[None, :], transl=data.anchor_transl[None, :]
    )
    full_anchor = cp.PoseChain(
        orient=jnp.concatenate([anchor.orient, jnp.zeros((shapes.n_ctrl - 1, 3), anchor.orient.dtype)]),
        transl=jnp.concatenate([anchor.transl, jnp.zeros((shapes.n_ctrl - 1, 3), anchor.transl.dtype)]),
    )
    chain = cp.chain_from_params(params, full_anchor)
    gp = cp.relative2global(chain)
    A_np, left, right, u = _uniform_consts(shapes)
    pdt = gp.transl.dtype
    d_transl = jnp.asarray(A_np, dtype=pdt) @ gp.transl  # [D, 3]
    q = rot.axang2quat(gp.orient)  # [C, 4]
    q_dense = rot.quat_slerp(q[left], q[right], jnp.asarray(u, dtype=pdt))
    return chain, gp, q_dense, d_transl


def dense_poses(params, data: WindowData, shapes: WindowShapes):
    """As dense_pose_tables but with dense orientations as axis-angle [D,3]
    (compatibility form for consumers that want rotvecs)."""
    chain, gp, q_dense, d_transl = dense_pose_tables(params, data, shapes)
    return chain, gp, rot.quat2axang(q_dense), d_transl


@lru_cache(maxsize=None)
def make_forward(shapes: WindowShapes, use_imu: bool):
    """Build the ForwardOut function for the optimizer (static per shapes)."""

    def forward(params, data: WindowData) -> ForwardOut:
        chain, gp, q_raw, d_transl = dense_pose_tables(params, data, shapes)

        # deskew: one gather + batched rotate (updateGlobalPoints,
        # ContinuousTrajectory.h:129-156), in f32 like the reference.
        # Quaternion form: gathers a [D,4] table instead of [D,3,3] rotation
        # matrices — 9x -> 4x less memory for the optimizer's batched
        # line-search / Jacobian-tangent evaluations.
        q_dense = q_raw.astype(jnp.float32)  # [D,4]
        t_dense = d_transl.astype(jnp.float32)
        qp = q_dense[data.pt_tform_idx]  # [NW,4]
        tp = t_dense[data.pt_tform_idx]
        pts_w = rot.quat_rotate(qp, data.local_pts) + tp

        points = jnp.concatenate([pts_w, data.static_pts], axis=0)
        mask = jnp.concatenate([data.pt_mask, data.static_mask])
        rings = jnp.concatenate([data.pt_ring, data.static_ring])

        if use_imu:
            extra = imu_residuals(chain, gp, d_transl, data, shapes)
        else:
            extra = jnp.zeros((0,), dtype=params.dtype)
        return ForwardOut(points=points, mask=mask, ring_ids=rings, obs_weight=None, extra=extra)

    import jax

    # jitted so direct per-scan host calls don't run eagerly; inlines
    # cleanly when traced inside the optimizer's jit
    return jax.jit(forward)


@lru_cache(maxsize=None)
def make_structured(shapes: WindowShapes, use_imu: bool):
    """Structured-Jacobian forward for the optimizer (see dmsa.optimizer).

    Exploits the window problem's sparsity: a point's world position
    depends ONLY on its dense-table entry (q_dense[idx], t_dense[idx]),
    and the dense tables depend on the P parameters through a tiny graph
    (control chain -> interp).  So the parameter Jacobian of the dense
    tables (Dq [D,4,P], Dt [D,3,P]) is computed with P tangents over the
    SMALL graph — no per-point work — and the per-point chain rule is one
    closed-form VJP (quat_rotate_vjp_q) plus one gathered contraction.
    Compare: autodiff value_and_jacfwd pushes P tangents through the FULL
    per-point pipeline (P x deskew+residual memory traffic).

    Static map points do not depend on the parameters: their rows are
    exactly zero and never computed.
    """

    def structured(params, data: WindowData):
        def tables(p):
            chain, gp, q_dense, d_transl = dense_pose_tables(p, data, shapes)
            if use_imu:
                extra = imu_residuals(chain, gp, d_transl, data, shapes)
            else:
                extra = jnp.zeros((0,), dtype=p.dtype)
            return q_dense, d_transl, extra

        (q_d, t_d, extra), lin = jax.linearize(tables, params)
        p_dim = params.shape[0]
        eye = jnp.eye(p_dim, dtype=params.dtype)
        dq, dt_, j_extra = jax.vmap(lin)(eye)  # [P,D,4], [P,D,3], [P,M]

        q32 = q_d.astype(jnp.float32)
        t32 = t_d.astype(jnp.float32)
        qp = q32[data.pt_tform_idx]  # [NW,4]
        tp = t32[data.pt_tform_idx]
        pts_w = rot.quat_rotate(qp, data.local_pts) + tp

        points = jnp.concatenate([pts_w, data.static_pts], axis=0)
        mask = jnp.concatenate([data.pt_mask, data.static_mask])
        rings = jnp.concatenate([data.pt_ring, data.static_ring])
        out = ForwardOut(
            points=points, mask=mask, ring_ids=rings, obs_weight=None, extra=extra
        )

        # per-point slices of the dense-table Jacobians, f32 like the points
        gq = dq.astype(jnp.float32).transpose(1, 2, 0)[data.pt_tform_idx]  # [NW,4,P]
        gt = dt_.astype(jnp.float32).transpose(1, 2, 0)[data.pt_tform_idx]  # [NW,3,P]
        nw = shapes.n_window_pts

        def contract(grad3_orig):
            g = grad3_orig[:nw]
            aq = rot.quat_rotate_vjp_q(qp, data.local_pts, g)  # [NW,4]
            jp = jnp.einsum("nc,ncp->np", aq, gq) + jnp.einsum("nc,ncp->np", g, gt)
            zeros = jnp.zeros((shapes.n_static, p_dim), dtype=jp.dtype)
            return jnp.concatenate([jp, zeros], axis=0)

        return out, contract, j_extra.T  # J_extra [M,P]

    return structured


def imu_residuals(chain, gp, d_transl, data: WindowData, shapes: WindowShapes):
    """IMU factor errors between consecutive control poses
    (updateImuError, ContinuousTrajectory.h:603-663).  Returns [C-1]."""
    pi = jnp.array(shapes.param_indices, dtype=jnp.int32)
    one_div = 1.0 / data.dt

    R_start = rot.axang2rotm(gp.orient[:-1])  # [C-1,3,3]
    delta_t = data.ctrl_stamps[1:] - data.ctrl_stamps[:-1]  # [C-1]

    v_start = one_div * (d_transl[pi[:-1] + 1] - d_transl[pi[:-1]])  # [C-1,3]
    v_end = one_div * (d_transl[pi[1:]] - d_transl[pi[1:] - 1])

    dp_world = (
        gp.transl[1:]
        - gp.transl[:-1]
        - v_start * delta_t[:, None]
        - 0.5 * delta_t[:, None] ** 2 * data.gravity[None, :]
    )
    delta_p_model = jnp.einsum("kji,kj->ki", R_start, dp_world)
    pos_error = delta_p_model - data.preint_pos

    # rotation error: log(preintRot^T * R_rel)  (ContinuousTrajectory.h:645-648)
    R_rel = rot.axang2rotm(chain.orient[1:])  # relative control rotations
    R_tmp = jnp.einsum("kji,kjl->kil", data.preint_rot, R_rel)
    rot_error = rot.rotm2axang(R_tmp)

    dv_world = v_end - v_start - data.gravity[None, :] * delta_t[:, None]
    delta_v_model = jnp.einsum("kji,kj->ki", R_start, dv_world)
    vel_error = delta_v_model - data.preint_vel

    combined = jnp.concatenate([rot_error, vel_error, pos_error], axis=1)  # [C-1, 9]
    quad = jnp.einsum("ki,kij,kj->k", combined, data.cov_inv, combined)
    return jnp.sqrt(jnp.abs(quad * data.balancing_imu) + 1e-30)


@lru_cache(maxsize=None)
def _preint_factors_jit(shapes: WindowShapes):
    import jax

    return jax.jit(lambda g, a, dt, cg, ca: compute_preint_factors(g, a, dt, cg, ca, shapes))


def compute_preint_factors_jit(gyr_dense, acc_dense, dt, cov_gyr, cov_acc, shapes: WindowShapes):
    return _preint_factors_jit(shapes)(gyr_dense, acc_dense, dt, cov_gyr, cov_acc)


def compute_preint_factors(gyr_dense, acc_dense, dt, cov_gyr, cov_acc, shapes: WindowShapes):
    """Preintegrate every control interval + the full horizon
    (updatePreintFactors, ContinuousTrajectory.h:520-568).

    Reference integrates t in [fromId, toId) per interval; intervals here
    all have static equal length so one vmap covers them.
    """
    L = shapes.interval_len
    K = shapes.n_ctrl - 1
    gyr_iv = gyr_dense[: K * L].reshape(K, L, 3)
    acc_iv = acc_dense[: K * L].reshape(K, L, 3)
    st = preint_mod.preintegrate_intervals(gyr_iv, acc_iv, dt, cov_gyr, cov_acc)
    cov_inv = jnp.linalg.inv(st.cov)
    full = preint_mod.preintegrate(gyr_dense, acc_dense, dt, cov_gyr, cov_acc)
    return st.delta_rot, st.delta_vel, st.delta_pos, cov_inv, full.delta_pos


def init_gravity_anchor_orientation(acc_first, gravity):
    """Gravity-direction init from the first accel sample
    (initGravityDir, ContinuousTrajectory.h:263-299).  Returns the anchor
    orientation axis-angle [3]."""
    R_to_grav = rot.rodrigues_between(gravity, -acc_first)
    return rot.rotm2axang(R_to_grav.T)


def submap_gravity_estimate(gp, d_transl, data: WindowData, shapes: WindowShapes):
    """Gravity in the IMU frame of the window start, from the full-horizon
    preintegration (getSubmapGravityEstimate, ContinuousTrajectory.h:593-601)."""
    v_start_w = (d_transl[1] - d_transl[0]) / data.dt
    R_start = rot.axang2rotm(gp.orient[0])
    num = R_start.T @ (gp.transl[-1] - gp.transl[0] - v_start_w * data.horizon) - data.preint_pos_full
    return num / (0.5 * data.horizon**2)


def register_tform_indices(rel_stamps, dt, n_dense):
    """Per-point dense-table index (registerPcBuffer,
    ContinuousTrajectory.h:245-261): lower_bound of (stamp - t0) over the
    uniform dense grid, clamped."""
    idx = jnp.ceil(rel_stamps / dt - 1e-9).astype(jnp.int32)
    return jnp.clip(idx, 0, n_dense - 1)


@lru_cache(maxsize=None)
def _initial_guess_jit(use_imu: bool, last_known: int, n_ctrl: int):
    import jax
    from functools import partial

    return jax.jit(
        partial(
            _initial_guess_impl,
            use_imu=use_imu,
            last_known=last_known,
            n_ctrl=n_ctrl,
        )
    )


def initial_guess(
    old_gp,
    old_stamps,
    old_t0: float,
    new_t0: float,
    new_ctrl_stamps,
    preint_factors,
    delta_t_ctrl,
    gravity,
    use_imu: bool,
    last_known: int,
    n_ctrl: int,
):
    """jit-dispatching wrapper of the window initial guess (see
    _initial_guess_impl)."""
    import jax.numpy as _jnp

    shift = _jnp.asarray(new_t0 - old_t0, dtype=old_stamps.dtype)
    return _initial_guess_jit(use_imu, last_known, n_ctrl)(
        old_gp, old_stamps, shift, new_ctrl_stamps, preint_factors, delta_t_ctrl, gravity
    )


def _initial_guess_impl(
    old_gp: cp.GlobalPoses,
    old_stamps,
    shift,
    new_ctrl_stamps,
    preint_factors,
    delta_t_ctrl,
    gravity,
    use_imu: bool,
    last_known: int,
    n_ctrl: int,
):
    """Window initial guess (updateInitialGuess, ContinuousTrajectory.h:367-469).

    Prefix poses (ctrl stamps still covered by the old window) come from
    slerp + barycentric interpolation of the old control poses; the terminal
    velocity from the barycentric derivative; remaining poses from IMU
    dead-reckoning (closed form over preint factors) or constant-velocity
    extrapolation.  `last_known` is computed by the caller on host;
    `shift` = new_t0 - old_t0.

    Returns the full PoseChain (anchor row 0 + relative poses).
    """
    t_query = new_ctrl_stamps[: last_known + 1] + shift
    pref_orient = interp.interp_rotations(t_query, old_stamps, old_gp.orient)
    pref_transl = interp.barycentric_interp(t_query, old_stamps, old_gp.transl, d=2)
    v0 = interp.barycentric_derivative(
        new_ctrl_stamps[last_known : last_known + 1] + shift, old_stamps, old_gp.transl, d=2
    )[0]

    if use_imu:
        pr_rot, pr_vel, pr_pos = preint_factors
        aa_suffix, p_suffix = preint_mod.dead_reckon_controls(
            pref_orient[last_known],
            pref_transl[last_known],
            v0,
            preint_mod.PreintState(
                delta_rot=pr_rot[last_known:],
                delta_vel=pr_vel[last_known:],
                delta_pos=pr_pos[last_known:],
                cov=jnp.zeros((n_ctrl - 1 - last_known, 9, 9), pref_transl.dtype),
            ),
            delta_t_ctrl[last_known:],
            gravity,
        )
        g_orient = jnp.concatenate([pref_orient[:last_known], aa_suffix], axis=0)
        g_transl = jnp.concatenate([pref_transl[:last_known], p_suffix], axis=0)
        chain = cp.global2relative(cp.GlobalPoses(orient=g_orient, transl=g_transl))
    else:
        # constant velocity: repeat the last known *relative* pose
        # (ContinuousTrajectory.h:458-468)
        g_orient = jnp.concatenate(
            [pref_orient, jnp.zeros((n_ctrl - 1 - last_known, 3), pref_orient.dtype)], axis=0
        )
        g_transl = jnp.concatenate(
            [pref_transl, jnp.zeros((n_ctrl - 1 - last_known, 3), pref_transl.dtype)], axis=0
        )
        chain = cp.global2relative(cp.GlobalPoses(orient=g_orient, transl=g_transl))
        rep_o = chain.orient[last_known]
        rep_t = chain.transl[last_known]
        tail = jnp.arange(chain.n)[:, None] > last_known
        chain = cp.PoseChain(
            orient=jnp.where(tail, rep_o[None, :], chain.orient),
            transl=jnp.where(tail, rep_t[None, :], chain.transl),
        )
    return chain


def centralize(data: WindowData):
    """Move the anchor translation to the origin and shift static points
    (ContinuousTrajectory.h:75-88)."""
    origin = data.anchor_transl
    data = data._replace(
        anchor_transl=jnp.zeros_like(origin),
        static_pts=data.static_pts - origin.astype(data.static_pts.dtype)[None, :],
    )
    return data, origin


def decentralize(data: WindowData, origin):
    """Inverse of centralize (ContinuousTrajectory.h:89-100)."""
    return data._replace(
        anchor_transl=origin,
        static_pts=data.static_pts + origin.astype(data.static_pts.dtype)[None, :],
    )
