"""Tabular form of the DMSA Gauss-Newton loop.

Both DMSA problems share one structure:

    world point j = quat_rotate(q_table[idx_j], x_j) + t_table[idx_j]

an affine transform indexed into a SMALL pose table (window problem: the
dense interpolated trajectory table, D ~ 501 rows, reference
ContinuousTrajectory.h:129-156; keyframe problem: one row per keyframe
pose, MapManagement.h:120-149).  Static map points ride as table row D,
pinned to the identity transform.

With the cells frozen at the linearization point, everything one
Gauss-Newton iteration needs comes from the sorted per-point layout and the
table alone:

  - cand_errors_ref: the total squared DMSA residual
    sum_cells |q1_r - n_r * mean^T wL mean| for K candidate tables at once
    (DmsaOptimizer.h:234-273 semantics; candidate 0 = the un-stepped
    params, so the no-improvement comparison uses one evaluation path);
  - gn_system_ref: H = J^T J, g = J^T e and e^T e over the cell residuals
    in one pass, via the run identity
    J_r = scale_r * (u_r - (wL s_bar_r)^T B_r) with
    u_r = sum_j (wL d0_j)^T dp_j/dtheta and B_r = sum_j dp_j/dtheta —
    replacing the reference's numeric forward differences
    (DmsaOptimizer.h:199-232: one full pipeline pass per parameter);
  - build_packed_ref: one-resolution cell build straight to the packed
    layout (gaussians.build_cells + pack_rows).

Data layout: all per-point inputs are packed into ONE [16, M] f32 array:

    rows 0-2   x_j (local point; static points: world coords)
    rows 3-5   mu0 (cell mean at build time)
    rows 6-11  lamw6 (weight * Lambda, packed sym: 00,01,02,11,12,22)
    row  12    w (validity 0/1 in sorted order)
    row  13    table index as f32 (static -> identity row)
    row  14    run-start flag (1.0 where a new cell begins)
    row  15    1/count at VALID run-END rows, else 0 (mask + inverse count)

Tables are [K, Dtab, 8] (quat wxyz, transl xyz, pad).  Run sums are
segment sums, which XLA lowers to scatter-adds: on the GPU these are
atomic, so H and the candidate errors change in the last bits from run to
run.
"""

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.core.rotations import quat_rotate, quat_rotate_vjp_q
from dmsa_lidar_slam_tpu.ops.eig3 import sym6_matvec


def pack_rows(cells, xs_sorted, tidx_sorted):
    """Build the [16, M] packed per-point input from a (merged) CellSet plus
    the sorted local points / table indices (ridden through the cell-build
    sort as aux payload, see gaussians.build_cells)."""
    m = cells.order.shape[0]
    i = jnp.arange(m, dtype=jnp.int32)
    newc = (cells.start == i).astype(jnp.float32)
    is_end = cells.end == i + 1
    valid_mem = cells.valid_mem
    if valid_mem is None:  # fallback: broadcast start-row validity
        valid_mem = cells.valid[cells.start]
    invn_end = jnp.where(
        is_end & valid_mem, 1.0 / jnp.maximum(cells.count, 1.0), 0.0
    ).astype(jnp.float32)
    return jnp.concatenate(
        [
            xs_sorted.T.astype(jnp.float32),  # 0:3
            cells.mu0.T.astype(jnp.float32),  # 3:6
            cells.lamw6.T.astype(jnp.float32),  # 6:12
            cells.w_sorted[None, :].astype(jnp.float32),  # 12
            tidx_sorted[None, :].astype(jnp.float32),  # 13
            newc[None, :],  # 14
            invn_end[None, :],  # 15
        ],
        axis=0,
    )


def _seg_ids(newc):
    return jnp.cumsum(newc.astype(jnp.int32)) - 1


def cand_errors_ref(tabs, packed):
    """Total squared DMSA cell residual per candidate pose table.

    tabs [K, Dtab, 8] (quat wxyz + transl + pad; row Dtab-1 should be the
    identity for static points), packed [16, M] (pack_rows).  Returns
    err [K] — sum over valid cells of |q1 - n * mean^T wL mean|, equal to
    sum(cell_residuals^2) up to the 1e-30 sqrt epsilon."""
    m = packed.shape[1]
    xs = packed[0:3].T
    mu0 = packed[3:6].T
    lam6 = packed[6:12].T
    w = packed[12]
    tidx = packed[13].astype(jnp.int32)
    invn_end = packed[15]
    seg = _seg_ids(packed[14])

    def one(tab):
        q = tab[:, 0:4][tidx].astype(jnp.float32)
        t3 = tab[:, 4:7][tidx].astype(jnp.float32)
        p = quat_rotate(q, xs) + t3
        d0 = (p - mu0) * w[:, None]
        quad = jnp.sum(sym6_matvec(lam6, d0) * d0, axis=1)
        svec = jax.ops.segment_sum(d0, seg, num_segments=m)[seg]
        q1 = jax.ops.segment_sum(quad, seg, num_segments=m)[seg]
        corr = invn_end * jnp.sum(sym6_matvec(lam6, svec) * svec, axis=1)
        val = q1 - corr
        return jnp.sum(jnp.where(invn_end > 0.0, jnp.abs(val), 0.0))

    return jax.vmap(one)(tabs)


def gn_system_ref(tab, dtabs, packed):
    """One-pass Gauss-Newton normal equations over the cell residuals.

    tab [Dtab, 8] current-params pose table, dtabs [P, Dtab, 8] its
    parameter Jacobian (from jax.linearize of the table builder), packed
    [16, M] (pack_rows).  Returns Hext [P+1, P+1] where
    Hext[:P, :P] = J^T J, Hext[:P, P] = J^T e, Hext[P, P] = e^T e — over
    the CELL residuals only (extra residual terms are combined by the
    caller).  The (wL s_bar)^T B_r row correction stays: at the
    linearization point s_bar is only the f32 error of the stored cell
    mean, and keeping it makes H match autodiff exactly."""
    m = packed.shape[1]
    xs = packed[0:3].T
    mu0 = packed[3:6].T
    lam6 = packed[6:12].T
    w = packed[12]
    tidx = packed[13].astype(jnp.int32)
    invn_end = packed[15]
    seg = _seg_ids(packed[14])

    q = tab[:, 0:4][tidx].astype(jnp.float32)
    t3 = tab[:, 4:7][tidx].astype(jnp.float32)
    p = quat_rotate(q, xs) + t3
    d0 = (p - mu0) * w[:, None]
    wld0 = sym6_matvec(lam6, d0)
    quad = jnp.sum(wld0 * d0, axis=1)

    mt = dtabs.astype(jnp.float32)[:, :, :7].transpose(1, 2, 0)[tidx]  # [M,7,P]
    aq = quat_rotate_vjp_q(q, xs, wld0)  # [M,4]
    cot_u = jnp.concatenate([aq, wld0], axis=1)  # [M,7]
    u = jnp.einsum("mc,mcp->mp", cot_u, mt)
    b_rows = []
    eye3 = jnp.eye(3, dtype=jnp.float32)
    for ax in range(3):
        g = jnp.broadcast_to(eye3[ax], (m, 3)) * w[:, None]
        aqm = quat_rotate_vjp_q(q, xs, g)
        cot = jnp.concatenate([aqm, g], axis=1)
        b_rows.append(jnp.einsum("mc,mcp->mp", cot, mt))

    svec = jax.ops.segment_sum(d0, seg, num_segments=m)[seg]
    q1 = jax.ops.segment_sum(quad, seg, num_segments=m)[seg]
    ur = jax.ops.segment_sum(u, seg, num_segments=m)[seg]
    br = [jax.ops.segment_sum(b, seg, num_segments=m)[seg] for b in b_rows]

    wls = sym6_matvec(lam6, svec) * invn_end[:, None]
    val = q1 - invn_end * jnp.sum(sym6_matvec(lam6, svec) * svec, axis=1)
    mask = invn_end > 0.0
    r = jnp.sqrt(jnp.abs(val) + 1e-30)
    scale = jnp.where(mask, jnp.sign(val) / r, 0.0)
    j_rows = scale[:, None] * (
        ur - (wls[:, 0:1] * br[0] + wls[:, 1:2] * br[1] + wls[:, 2:3] * br[2])
    )
    e_row = jnp.where(mask, r, 0.0)
    jext = jnp.concatenate([j_rows, e_row[:, None]], axis=1)  # [M, P+1]
    return jext.T @ jext


def build_packed_ref(points_w, mask, ring_ids, xs, tidx, grid_size, min_points, obs_weight=None, split_ids=None):
    """One-resolution cell build straight to the packed layout:
    gaussians.build_cells + pack_rows.  Returns (packed [16, N],
    num_valid [], num_raw [])."""
    from dmsa_lidar_slam_tpu.ops import gaussians

    aux = jnp.concatenate([xs, tidx.astype(jnp.float32)[:, None]], axis=1)
    cells, aux_s = gaussians.build_cells(
        points_w, mask, ring_ids, grid_size, min_points,
        obs_weight=obs_weight, split_ids=split_ids, aux=aux,
    )
    packed = pack_rows(cells, aux_s[:, :3], aux_s[:, 3])
    return packed, cells.num_valid, cells.num_raw
