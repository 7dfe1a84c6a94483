"""On-manifold IMU preintegration (Forster et al., RSS'15), bias-free.

Functional equivalent of the reference's ImuPreintegration (reference:
include/DMSA/ImuPreintegration.h:53-123): per-sample update of
(deltaRot, deltaVel, deltaPos) and 9x9 covariance propagation
cov <- A cov A^T + B N B^T with the right-Jacobian of SO(3), expressed as a
lax.scan so whole control-pose intervals integrate in one fused kernel and
vmap batches the per-interval integrations of a window.

State ordering matches the reference: [rot, vel, pos] blocks of 3.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.core import rotations as rot


class PreintState(NamedTuple):
    delta_rot: jnp.ndarray  # [3, 3]
    delta_vel: jnp.ndarray  # [3]
    delta_pos: jnp.ndarray  # [3]
    cov: jnp.ndarray  # [9, 9] over (rot, vel, pos)


def right_jacobian(aa):
    """Right Jacobian of SO(3) (ImuPreintegration.h:35-45), series-safe."""
    theta2 = jnp.sum(aa * aa, axis=-1)
    theta = jnp.sqrt(theta2 + 1e-30)
    K = rot.skew(aa)
    KK = K @ K
    small = theta2 < 1e-10
    c1 = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-30))
    c2 = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, 1e-30)
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=aa.dtype), K.shape)
    return eye - c1[..., None, None] * K + c2[..., None, None] * KK


def init_state(dtype=jnp.float64) -> PreintState:
    return PreintState(
        delta_rot=jnp.eye(3, dtype=dtype),
        delta_vel=jnp.zeros(3, dtype=dtype),
        delta_pos=jnp.zeros(3, dtype=dtype),
        cov=jnp.zeros((9, 9), dtype=dtype),
    )


def step(state: PreintState, omega, acc, dt, cov_gyr, cov_acc) -> PreintState:
    """One measurement update (ImuPreintegration.h:53-94)."""
    dt2 = dt * dt
    rot_incr = rot.axang2rotm(dt * omega)
    dR = state.delta_rot

    skew_acc = rot.skew(acc)
    A = jnp.eye(9, dtype=dR.dtype)
    A = A.at[0:3, 0:3].set(rot_incr.T)
    A = A.at[3:6, 0:3].set(-dR @ skew_acc * dt)
    A = A.at[6:9, 0:3].set(-0.5 * dR @ skew_acc * dt2)
    A = A.at[6:9, 3:6].set(dt * jnp.eye(3, dtype=dR.dtype))

    B = jnp.zeros((9, 6), dtype=dR.dtype)
    B = B.at[0:3, 0:3].set(right_jacobian(rot.rotm2axang(dR)) * dt)
    B = B.at[3:6, 3:6].set(dR * dt)
    B = B.at[6:9, 3:6].set(0.5 * dR * dt2)

    noise = jnp.zeros((6, 6), dtype=dR.dtype)
    noise = noise.at[0:3, 0:3].set(cov_gyr)
    noise = noise.at[3:6, 3:6].set(cov_acc)

    cov = A @ state.cov @ A.T + B @ noise @ B.T
    delta_pos = state.delta_pos + state.delta_vel * dt + 0.5 * dR @ acc * dt2
    delta_vel = state.delta_vel + dR @ acc * dt
    delta_rot = dR @ rot_incr
    return PreintState(delta_rot=delta_rot, delta_vel=delta_vel, delta_pos=delta_pos, cov=cov)


def preintegrate_sequential(omega, acc, dt, cov_gyr, cov_acc) -> PreintState:
    """Reference-shaped sequential integration (golden oracle for tests)."""

    def body(state, meas):
        w, a = meas
        return step(state, w, a, dt, cov_gyr, cov_acc), None

    state0 = init_state(dtype=omega.dtype)
    state, _ = jax.lax.scan(body, state0, (omega, acc))
    return state


def preintegrate(omega, acc, dt, cov_gyr, cov_acc) -> PreintState:
    """Integrate a [T, 3] gyro/accel sample run with constant step dt.

    Log-depth formulation: preintegrated deltas form a semidirect-product
    monoid —
        (dR, dv, dp, T1) * (dR2, dv2, dp2, T2)
          = (dR dR2, dv + dR dv2, dp + dv T2 + dR dp2, T1 + T2)
    — so the whole run reduces in log2(T) batched rounds instead of a
    T-step while loop (the reference's per-sample loop,
    ImuPreintegration.h:53-94, would cost T sequential steps on device).  The
    covariance recursion cov <- A cov A^T + B N B^T is likewise composed
    associatively over (A, Q) pairs: (A2 A1, A2 Q1 A2^T + Q2), with each
    sample's A/B built from the exclusive-prefix rotation.  Bitwise math
    matches preintegrate_sequential up to f.p. reassociation.
    """
    dtype = omega.dtype
    T = omega.shape[0]
    dt = jnp.asarray(dt, dtype)
    rot_incr = rot.axang2rotm(dt * omega)  # [T, 3, 3]
    dv_loc = acc * dt
    dp_loc = 0.5 * acc * dt * dt
    seg_t = jnp.broadcast_to(dt, (T,))

    def combine(s1, s2):
        R1, v1, p1, t1 = s1
        R2, v2, p2, t2 = s2
        R = jnp.einsum("...ij,...jk->...ik", R1, R2)
        v = v1 + jnp.einsum("...ij,...j->...i", R1, v2)
        p = p1 + v1 * t2[..., None] + jnp.einsum("...ij,...j->...i", R1, p2)
        return R, v, p, t1 + t2

    Rp, vp, pp, _ = jax.lax.associative_scan(combine, (rot_incr, dv_loc, dp_loc, seg_t), axis=0)

    # state rotation BEFORE each sample (exclusive prefix)
    eye3 = jnp.eye(3, dtype=dtype)
    dR_before = jnp.concatenate([eye3[None], Rp[:-1]], axis=0)  # [T, 3, 3]

    # per-sample transition A_k and noise Q_k = B_k N B_k^T (batched)
    dt2 = dt * dt
    skew_acc = rot.skew(acc)  # [T, 3, 3]
    dRsa = jnp.einsum("tij,tjk->tik", dR_before, skew_acc)
    Z = jnp.zeros((T, 3, 3), dtype)
    I = jnp.broadcast_to(eye3, (T, 3, 3))
    A = jnp.concatenate(
        [
            jnp.concatenate([jnp.swapaxes(rot_incr, -1, -2), Z, Z], axis=2),
            jnp.concatenate([-dRsa * dt, I, Z], axis=2),
            jnp.concatenate([-0.5 * dRsa * dt2, I * dt, I], axis=2),
        ],
        axis=1,
    )  # [T, 9, 9]

    Jr = right_jacobian(rot.rotm2axang(dR_before)) * dt  # [T, 3, 3]
    B = jnp.concatenate(
        [
            jnp.concatenate([Jr, Z], axis=2),
            jnp.concatenate([Z, dR_before * dt], axis=2),
            jnp.concatenate([Z, 0.5 * dR_before * dt2], axis=2),
        ],
        axis=1,
    )  # [T, 9, 6]
    noise = jnp.zeros((6, 6), dtype).at[0:3, 0:3].set(cov_gyr).at[3:6, 3:6].set(cov_acc)
    Q = jnp.einsum("tij,jk,tlk->til", B, noise, B)  # [T, 9, 9]

    def combine_cov(a, b):
        A1, Q1 = a
        A2, Q2 = b
        A12 = jnp.einsum("...ij,...jk->...ik", A2, A1)
        Q12 = jnp.einsum("...ij,...jk,...lk->...il", A2, Q1, A2) + Q2
        return A12, Q12

    _, Q_all = jax.lax.associative_scan(combine_cov, (A, Q), axis=0)
    return PreintState(delta_rot=Rp[-1], delta_vel=vp[-1], delta_pos=pp[-1], cov=Q_all[-1])


def preintegrate_intervals(omega, acc, dt, cov_gyr, cov_acc) -> PreintState:
    """Batch-preintegrate [K, T, 3] interval runs -> PreintState with leading
    dim K.  Used for the control-pose intervals of a window
    (ContinuousTrajectory.h:520-553), which all have equal length because
    control stamps and the dense grid are both uniform."""
    return jax.vmap(lambda w, a: preintegrate(w, a, dt, cov_gyr, cov_acc))(omega, acc)


def dead_reckon_controls(
    axang0, pos0, vel0, preint: PreintState, delta_t, gravity
):
    """Forward dead-reckoning across control intervals from preint factors.

    Closed-form equivalent of getImuIntegratedParams's Euler loop
    (ContinuousTrajectory.h:471-518): because the dense-rate integration is
    exactly what the preintegration accumulates,
        R_{k+1} = R_k dR_k
        v_{k+1} = v_k + g dt_k + R_k dv_k
        p_{k+1} = p_k + v_k dt_k + 0.5 g dt_k^2 + R_k dp_k.

    preint has leading dim K (intervals), delta_t [K].  Returns global
    axis-angles [K+1, 3] and positions [K+1, 3] including the start state.
    """
    R0 = rot.axang2rotm(axang0)

    def body(carry, inp):
        R, p, v = carry
        dR, dv, dp, dtk = inp
        p_new = p + v * dtk + 0.5 * gravity * dtk**2 + R @ dp
        v_new = v + gravity * dtk + R @ dv
        R_new = R @ dR
        return (R_new, p_new, v_new), (rot.rotm2axang(R_new), p_new)

    (_, _, _), (aa_seq, p_seq) = jax.lax.scan(
        body,
        (R0, pos0, vel0),
        (preint.delta_rot, preint.delta_vel, preint.delta_pos, delta_t),
    )
    aa_all = jnp.concatenate([axang0[None], aa_seq], axis=0)
    p_all = jnp.concatenate([pos0[None], p_seq], axis=0)
    return aa_all, p_all
