"""Gaussian cell statistics: per-voxel mean / covariance / information matrix.

Fixed-shape replacement for the reference's Gaussians container + octree leaf
iteration (reference: include/DMSA/Gaussians.h:87-202,
DmsaOptimizer.h:275-350).  A "cell set" here is a fixed-capacity padded array
of candidate cells; validity is a mask combining the reference's acceptance
rules:

  - at least `min_points` members (DmsaOptimizer.h:307),
  - at least two distinct ring ids in the cell (same line),
  - eigenvalue floor 1e-4 on the covariance before inversion
    (Gaussians.h:181-201) — via the closed-form spectral polynomial
    (ops.eig3), no iterative eigensolver,
  - rebalancing weights w_k ∝ obs_weight_k / n_k, normalized to mean 1 over
    valid cells (Gaussians.h:170-179).

Performance shape (scatter-free): binning sorts points by voxel key
once per cell build; cells are identified by the *sorted position of their
first member* (run-start slots, ops.voxel.bin_runs), so per-cell and
per-point quantities share one [N]-indexed layout.  Every reduction is a
log-depth cumsum plus at most one [N, W] gather — no segment_sum scatters,
no argsort inverse, and every residual evaluation (line search, Jacobian
tangents) re-uses the frozen run structure with a single boundary gather.
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.ops import voxel

COV_EIG_FLOOR = 1e-4  # Gaussians.h:193


class CellSet(NamedTuple):
    """Padded Gaussian cells over N points (capacity N, run-start slots).

    Per *sorted point* arrays (length N):
      order    [N]      permutation sorting points by cell (invalid last)
      start    [N]      run-start position of the point's cell
      end      [N]      one-past-last position of the point's run
      mu0      [N,3]    cell mean at build time (the linearization point)
      w_sorted [N]      point validity in sorted order (as points dtype)

    Per *sorted point*, frozen per build (candidate-independent, so the
    optimizer's vmapped line search reads them UNBATCHED — one gather per
    cell build, not one per candidate):
      lamw6    [N,6]    weight_r * Lambda_r of the point's cell, packed
                        symmetric (00,01,02,11,12,22; 0 for invalid cells).
                        Packed columns instead of [N,3,3]: gathers and
                        layout copies of tiny-matrix tensors cost more
                        than six flat columns.

    Per *cell* arrays, meaningful only at run-start rows (slot = run start):
      info6    [N,6]    packed information matrix of the cell (no weight)
      weight   [N]      rebalancing weight (0 at non-starts / invalid)
      count    [N]      member count (valid members; same for all members)
      valid    [N]      cell validity mask (False at non-start rows)

    point_cell [N] maps each *original* point to its cell slot (sentinel
    N-1 when masked); only needed by host-side consumers — inside jit it is
    dead code unless used and costs nothing.
    """

    order: jnp.ndarray
    start: jnp.ndarray
    end: jnp.ndarray
    info6: jnp.ndarray
    lamw6: jnp.ndarray
    mu0: jnp.ndarray
    w_sorted: jnp.ndarray
    weight: jnp.ndarray
    count: jnp.ndarray
    valid: jnp.ndarray
    num_valid: jnp.ndarray
    num_raw: jnp.ndarray
    point_cell: jnp.ndarray
    # member-aligned cell validity (True at EVERY member row of an accepted
    # cell, not just the run start) — the tabular Gauss-Newton form
    # reads validity at run-END rows, and a member-aligned form avoids a
    # [N]-row bool gather per build (ops.fused_residuals)
    valid_mem: Optional[jnp.ndarray] = None


def segment_mean_cov(points, point_cell, point_weight, num_segments, indices_are_sorted=False):
    """Two-pass per-segment mean and covariance (numerically safe in f32).

    point_weight [N] is a 0/1 mask weight.  Returns (count [S], mean [S,3],
    cov [S,3,3]) with cov normalized by (n - 1) to match Eigen's sample
    covariance in Gaussians.h:146-147.  (Generic segment-id path, used by
    callers that already have compact ids; the optimizer hot path uses the
    run-slot formulation in build_cells instead.)
    """
    w = point_weight
    count = jax.ops.segment_sum(
        w, point_cell, num_segments=num_segments, indices_are_sorted=indices_are_sorted
    )
    psum = jax.ops.segment_sum(
        points * w[:, None], point_cell, num_segments=num_segments, indices_are_sorted=indices_are_sorted
    )
    safe_n = jnp.maximum(count, 1.0)
    mean = psum / safe_n[:, None]
    centered = (points - mean[point_cell]) * w[:, None]
    outer = centered[:, :, None] * centered[:, None, :]
    m2 = jax.ops.segment_sum(
        outer.reshape(-1, 9), point_cell, num_segments=num_segments, indices_are_sorted=indices_are_sorted
    )
    cov = m2.reshape(-1, 3, 3) / jnp.maximum(count - 1.0, 1.0)[:, None, None]
    return count, mean, cov


def _outer6(v):
    """Packed symmetric outer product [..., 3] -> [..., 6] (00,01,02,11,12,22)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([x * x, x * y, x * z, y * y, y * z, z * z], axis=-1)


def info_from_cov(cov):
    """Eigenvalue-floored inverse covariance (Gaussians.h:181-201), via the
    closed-form spectral polynomial (ops.eig3)."""
    from dmsa_lidar_slam_tpu.ops.eig3 import floored_inverse_sym3

    return floored_inverse_sym3(cov, COV_EIG_FLOOR)


def build_cells(
    points,
    mask,
    ring_ids,
    grid_size,
    min_points: int,
    obs_weight=None,
    split_ids=None,
    aux=None,
) -> CellSet:
    """Bin points and compute accepted Gaussian cells at one resolution.

    points [N, 3] f32, mask [N] bool, ring_ids [N] int32 (the per-point id
    used for the ring-diversity test; DmsaOptimizer.h:304-307), obs_weight
    optional [N] per-point observation weight whose per-cell mean feeds the
    rebalancing weight (getWeightOfPointSet; OptimizablePointSet.h:52).
    split_ids optional [N] small ints subdividing voxels by surface
    orientation — the fixed-shape analogue of the reference's normal-based
    set splitting (Gaussians.h:27-85).  aux optional [N, A] f32 extra
    per-point payload to ride through the sort; when given, returns
    (CellSet, aux_sorted [N, A]) — used by the tabular Gauss-Newton form
    (ops.fused_residuals) to obtain sorted local points / table indices
    without separate post-sort gathers.

    Two cumsum rounds (member counts/means, then centered second moments),
    one [N,6] + one [N,3x3] boundary gather, zero scatters.
    """
    n = points.shape[0]
    # per-point inputs ride THROUGH the sort as payload operands (no
    # separate post-sort [N]-row gathers); ring ids and mask ride as f32
    # columns.
    # CONTRACT: ring_ids must fit in 24 bits (f32 mantissa) to stay exact in
    # the payload — real lidar ring counts are <= 128 (OS-128) and the
    # pipeline's synthesized ids are k % 1000 (dmsa_slam_ros.cpp:478), so
    # the bound only matters if a caller invents giant ids.
    payload = jnp.concatenate(
        [
            points,
            mask.astype(points.dtype)[:, None],
            ring_ids.astype(points.dtype)[:, None],
        ]
        + ([] if obs_weight is None else [obs_weight[:, None]])
        + ([] if aux is None else [aux.astype(points.dtype)]),
        axis=1,
    )
    rb, packed = voxel.bin_runs(points, mask, grid_size, channel=split_ids, payload=payload)
    order, new_cell, start, end = rb.order, rb.new_cell, rb.start, rb.end

    pts_s = packed[:, :3]
    w_s = packed[:, 3]
    rings_s = packed[:, 4]
    n_base = 5 if obs_weight is None else 6
    if obs_weight is None:
        obs_s = w_s
    else:
        obs_s = packed[:, 5] * w_s
    aux_sorted = packed[:, n_base:] if aux is not None else None

    # ring diversity without segment_min/max: any consecutive in-run ring
    # change implies >= 2 distinct ids; all-equal runs have none.
    ring_prev = jnp.concatenate([rings_s[:1], rings_s[:-1]])
    ringdiff = ((~new_cell) & (rings_s != ring_prev)).astype(points.dtype)

    # round 1: count | sum(p) | ring-changes | obs  -> broadcast to members
    vals1 = jnp.concatenate(
        [w_s[:, None], pts_s * w_s[:, None], ringdiff[:, None], obs_s[:, None]], axis=1
    )
    sums1 = voxel.run_sums(vals1, start, end)  # [N, 6], per point
    count_pp = sums1[:, 0]
    safe_n = jnp.maximum(count_pp, 1.0)
    mean_pp = sums1[:, 1:4] / safe_n[:, None]
    diverse_pp = sums1[:, 4] > 0.5
    obs_cell_pp = sums1[:, 5] / safe_n

    # round 2: centered second moments, packed symmetric [N,6]; only
    # run-start rows are read, where the exclusive prefix is aligned.
    centered = (pts_s - mean_pp) * w_s[:, None]
    outer = _outer6(centered)
    p_incl = jnp.cumsum(outer, axis=0)
    p_excl = p_incl - outer
    last = jnp.minimum(end - 1, n - 1)
    m2 = p_incl[last] - p_excl  # valid at run-start rows
    cov6 = m2 / jnp.maximum(count_pp - 1.0, 1.0)[:, None]

    valid_mem = (count_pp > 0.5) & (count_pp >= min_points) & diverse_pp
    valid = new_cell & valid_mem

    from dmsa_lidar_slam_tpu.ops.eig3 import floored_inverse_sym6

    info6 = floored_inverse_sym6(cov6, COV_EIG_FLOOR)
    # zero invalid cells' info: keeps junk/NaN out of the residual path.
    # Stored at run-start rows ONLY — residual evaluation contracts run
    # second moments against it there; no member broadcast, no [N,3,3]
    # layouts (the r2-era per-member info gather dominated the profile).
    info6 = jnp.where(valid[:, None], info6, 0.0)

    # rebalancing: w_k = obs_k / n_k, normalized by mean over valid cells
    raw_w = jnp.where(valid, obs_cell_pp / safe_n, 0.0)
    num_valid = jnp.sum(valid)
    mean_w = jnp.sum(raw_w) / jnp.maximum(num_valid, 1)
    weight = jnp.where(valid, raw_w / jnp.maximum(mean_w, 1e-30), 0.0)

    # member-aligned weight * info (ONE [N,6] gather per build; every
    # residual evaluation — 15+ per iteration with the line search — then
    # runs gather-free on the member rows)
    lamw6 = (info6 * weight[:, None])[start]

    # original-order cell slot (host/test consumers; DCE'd inside jit when
    # unused — the residual path never touches it)
    inv = jnp.zeros(n, dtype=start.dtype).at[order].set(start)
    point_cell = jnp.where(mask, inv, n - 1)

    cs = CellSet(
        order=order,
        start=start,
        end=end,
        info6=info6,
        lamw6=lamw6,
        mu0=mean_pp,
        w_sorted=w_s,
        weight=weight,
        count=count_pp,
        valid=valid,
        num_valid=num_valid,
        num_raw=rb.num_cells,
        point_cell=point_cell,
        valid_mem=valid_mem,
    )
    return cs if aux is None else (cs, aux_sorted)


def concat_cells(cells_list, n_points: int) -> CellSet:
    """Merge per-resolution CellSets into ONE CellSet over the concatenated
    sorted layout (orders still index the SAME [n_points] point array).

    Every downstream pass — residuals, gradients, the vmapped line search,
    the Jacobian run-sums — then launches once over [R*N] instead of R
    times over [N]: at these sizes the ops are latency-bound, so halving
    the op count is ~halving the cost.  Run boundaries stay valid because
    each member set's offsets are shifted by its slab start (every slab
    begins with a run start).
    """
    if len(cells_list) == 1:
        return cells_list[0]
    offs = [i * n_points for i in range(len(cells_list))]

    def cat(field, shift=False):
        parts = [getattr(c, field) for c in cells_list]
        if shift:
            parts = [p + o for p, o in zip(parts, offs)]
        return jnp.concatenate(parts, axis=0)

    return CellSet(
        order=cat("order"),
        start=cat("start", shift=True),
        end=cat("end", shift=True),
        info6=cat("info6"),
        lamw6=cat("lamw6"),
        mu0=cat("mu0"),
        w_sorted=cat("w_sorted"),
        weight=cat("weight"),
        count=cat("count"),
        valid=cat("valid"),
        num_valid=sum(c.num_valid for c in cells_list),
        num_raw=sum(c.num_raw for c in cells_list),
        point_cell=cells_list[0].point_cell,  # host consumers use res-0
        valid_mem=(
            cat("valid_mem") if all(c.valid_mem is not None for c in cells_list) else None
        ),
    )


def cell_residuals_and_grad(points, mask, cells: CellSet):
    """cell_residuals plus the closed-form per-point residual gradient.

    Returns (res [N], grad3_sorted [N, 3]) where res matches
    cell_residuals exactly and grad3_sorted[j] = d res[slot(j)] / d p_j for
    the SORTED point j (zero for masked points / invalid cells):

        res_r = sqrt(|w_r (sum_j d0^T L d0 - n s^T L s)| + eps)
        d res_r / d p_j = sign(val) * w_r * L (p_j - mu_r) / res_r

    The mean-centering term vanishes because sum_j (p_j - mu) = 0, so the
    gradient is one extra elementwise pass over the already-gathered sorted
    points — no autodiff, no extra cumsums beyond broadcasting the run sums
    to members (run_sums instead of the start-aligned exclusive prefix).

    This is the kernel of the structured Jacobian path (dmsa.optimizer):
    the reference's numeric forward differences (DmsaOptimizer.h:199-232)
    re-evaluate ALL residuals once per parameter; autodiff jacfwd pushes P
    tangents through the full point pipeline; this form exploits the
    sparsity that each point belongs to exactly one cell and one pose.
    """
    from dmsa_lidar_slam_tpu.ops.eig3 import sym6_matvec

    pts_s = points[cells.order]
    d0 = (pts_s - cells.mu0) * cells.w_sorted[:, None]
    quad = jnp.sum(sym6_matvec(cells.lamw6, d0) * d0, axis=1)  # [N]

    stacked = jnp.concatenate([d0, quad[:, None]], axis=1)  # [N, 4]
    sums = voxel.run_sums(stacked, cells.start, cells.end)  # per member
    count = jnp.maximum(cells.count, 1.0)
    s_mean = sums[:, :3] / count[:, None]
    q1 = sums[:, 3]
    corr = cells.count * jnp.sum(sym6_matvec(cells.lamw6, s_mean) * s_mean, axis=1)
    val = q1 - corr
    r = jnp.sqrt(jnp.abs(val) + 1e-30)
    res = jnp.where(cells.valid, r, 0.0)

    # gradient: sign(val) * wL (p_j - mu_current) / r, masked
    diff = d0 - s_mean  # = p_j - mu_current for valid members (w=1)
    ldiff = sym6_matvec(cells.lamw6, diff)  # [N,3]
    scale = jnp.sign(val) / r
    valid_m = cells.valid[cells.start]
    g = jnp.where(valid_m[:, None], scale[:, None] * ldiff, 0.0) * cells.w_sorted[:, None]
    return res, g


def cell_residuals(points, mask, cells: CellSet):
    """Per-cell DMSA residuals r_k = sqrt(w_k * sum_j d_j^T Info_k d_j).

    Matches DmsaOptimizer::updateErrorTerms (DmsaOptimizer.h:234-273): the
    mean is recomputed from the *current* points while Info and membership
    stay frozen (captured in `cells` at the linearization point).

    Formulated around the frozen build-time mean mu0 for f32 safety and
    speed:  with d0_j = p_j - mu0, s = mean(d0) over the cell, and the
    member-aligned wL = weight * Lambda (cells.lamw6, frozen per build):
        w * sum_j (p_j - mean)^T L (p_j - mean)
          = sum_j d0^T wL d0  -  n * s^T wL s.
    Per-point work is one order gather + one packed quadratic form — the
    wL read is candidate-independent, so under the optimizer's vmapped
    line search it is NOT replicated per candidate.  The run reduction is
    a width-4 cumsum + ONE boundary gather (the exclusive prefix is
    aligned at run starts).  Returns [N], nonzero at run-start slots of
    valid cells.
    """
    from dmsa_lidar_slam_tpu.ops.eig3 import sym6_matvec

    m = cells.order.shape[0]  # sorted-layout length (R*N for merged sets)
    pts_s = points[cells.order]
    d0 = (pts_s - cells.mu0) * cells.w_sorted[:, None]
    quad = jnp.sum(sym6_matvec(cells.lamw6, d0) * d0, axis=1)  # [M]

    stacked = jnp.concatenate([d0, quad[:, None]], axis=1)  # [M, 4]
    p_incl = jnp.cumsum(stacked, axis=0)
    p_excl = p_incl - stacked
    last = jnp.minimum(cells.end - 1, m - 1)
    sums = p_incl[last] - p_excl  # valid at run-start rows

    s_mean = sums[:, :3] / jnp.maximum(cells.count, 1.0)[:, None]
    q1 = sums[:, 3]
    corr = cells.count * jnp.sum(sym6_matvec(cells.lamw6, s_mean) * s_mean, axis=1)
    val = q1 - corr
    return jnp.where(cells.valid, jnp.sqrt(jnp.abs(val) + 1e-30), 0.0)
