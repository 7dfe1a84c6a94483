"""The generic DMSA Gauss-Newton optimizer.

A re-design of DmsaOptimizer::optimizeSet for XLA (reference:
include/DMSA/DmsaOptimizer.h:54-150).  Same outer-loop semantics — per
iteration: rebuild Gaussian cells at two grid resolutions from the current
global points, freeze cell membership + information matrices, evaluate the
residual vector, take a damped Gauss-Newton step, clip it, then a
9-candidate line search — but:

  - the numeric forward-difference Jacobian (DmsaOptimizer.h:199-232, one
    full deskew+error pass per parameter) becomes jacfwd over the residual
    function (vectorized JVPs, chunked to bound memory),
  - the 9 line-search evaluations (DmsaOptimizer.h:152-182) are one vmap,
  - the whole optimization is a single jit-compiled lax.fori_loop; stop
    criteria set a `done` flag that freezes the carried state (shapes never
    change, so the jit cache holds across scans).

A "problem" is one pure function over a data pytree (see dmsa.problems),
mirroring the reference's OptimizablePointSet virtual interface
(OptimizablePointSet.h:18-56) without virtual dispatch:

    forward_fn(params, data) -> ForwardOut(points, mask, ring_ids,
                                           obs_weight, extra)

where `points` are the problem's current global points (updateGlobalPoints)
and `extra` the additional residual vector (updateAdditionalErrors — IMU /
gravity / odometry terms; may have length 0).
"""

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.ops import gaussians, voxel

# stop reason codes (diagnostics)
STOP_NONE = 0
STOP_TOO_FEW_GAUSSIANS = 1  # DmsaOptimizer.h:89-93
STOP_NAN = 2  # DmsaOptimizer.h:116-122
STOP_NO_IMPROVEMENT = 3  # DmsaOptimizer.h:130-134
STOP_EPSILON = 4  # DmsaOptimizer.h:138-143


class ForwardOut(NamedTuple):
    points: jnp.ndarray  # [N, 3] current global points
    mask: jnp.ndarray  # [N] bool validity
    ring_ids: jnp.ndarray  # [N] int32 ids for the ring-diversity test
    obs_weight: Optional[jnp.ndarray]  # [N] or None (getWeightOfPointSet)
    extra: jnp.ndarray  # [M] additional residuals (M may be 0)
    split_ids: Optional[jnp.ndarray] = None  # [N] int32 cell-split channel


class TabularProblem(NamedTuple):
    """A problem in indexed-affine-table form for the tabular Gauss-Newton
    path (ops.fused_residuals): world point j = quat_rotate(q[idx_j], x_j) +
    t[idx_j] with (q, t) rows of a small parameter-dependent pose table.

    n_table       table rows INCLUDING the trailing identity row
    tables        (params, data) -> (tab [n_table, 8] f32, extra [E])
                  (quat wxyz + transl + pad; differentiable in params)
    point_arrays  data -> (xs [N, 3] f32, tidx [N] i32) — parameter-free
                  local points and table indices (static -> identity row)
    """

    n_table: int
    tables: Callable
    point_arrays: Callable


@dataclasses.dataclass(frozen=True)
class OptimSettings:
    """Mirror of DmsaOptimSettings (DmsaOptimizer.h:25-39). Static under jit."""

    num_iter: int = 15
    epsilon: float = 1e-5
    step_length_optim: float = 0.05
    max_step: float = 0.01
    grid_size_1_factor: float = 2.0
    grid_size_2_factor: float = 5.0
    min_num_points_per_set: int = 6
    min_num_gaussians: int = 30
    lambda_diag: float = 1e-5
    use_centralization: bool = True
    jacobian_chunk: int = 128  # params per jacfwd block (memory bound)
    # line-search step fractions (adaptiveStepSize probes 0.1..0.9,
    # DmsaOptimizer.h:152-182); the extra geometric fractions extend the
    # grid downward because the frozen-cell landscape can have a much
    # smaller descent region than 0.1*step — a strict superset of the
    # reference's candidates, same argmin when the reference's grid suffices
    line_search_fracs: tuple = (
        0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.05, 0.02, 0.01, 0.005, 0.002,
    )


class OptimResult(NamedTuple):
    params: jnp.ndarray
    num_iters: jnp.ndarray  # [] iterations actually run
    stop_reason: jnp.ndarray  # [] code
    final_error: jnp.ndarray  # [] sum of squared residuals
    initial_error: jnp.ndarray
    num_gaussians: jnp.ndarray  # [] valid cells at last build


def chunked_jacfwd(fn: Callable, params: jnp.ndarray, chunk: int) -> jnp.ndarray:
    """J[i, j] = d fn(params)_i / d params_j.

    Linearizes once (one primal pass) and pushes `chunk` tangents at a time
    through the linearized function — unlike naive jacfwd/jvp-per-column,
    the nonlinear primal is not recomputed per tangent block.
    """
    return value_and_jacfwd(fn, params, chunk)[1]


def value_and_jacfwd(fn: Callable, params: jnp.ndarray, chunk: int):
    """(fn(params), J) with one linearize: the primal pass that jax.linearize
    performs doubles as the residual evaluation, saving a full forward pass
    per optimizer iteration."""
    p = params.shape[0]
    eye = jnp.eye(p, dtype=params.dtype)
    e0, lin = jax.linearize(fn, params)

    cols = []
    for start in range(0, p, chunk):
        block = eye[start : start + chunk]
        cols.append(jax.vmap(lin)(block))  # [chunk, R]
    return e0, jnp.concatenate(cols, axis=0).T  # [R], [R, P]


@partial(jax.jit, static_argnums=(0, 3), static_argnames=("structured_fn", "tabular_fn"))
def optimize(
    forward_fn: Callable[[jnp.ndarray, Any], ForwardOut],
    params0: jnp.ndarray,
    data: Any,
    settings: OptimSettings,
    min_grid_size=0.3,
    step_length=None,
    max_step=None,
    structured_fn=None,
    tabular_fn: Optional[TabularProblem] = None,
) -> OptimResult:
    """Run the DMSA optimization (jit; forward_fn and settings are static).

    step_length / max_step optionally override the static settings with
    TRACED scalars (one compiled graph serves e.g. the IMU / no-IMU gain
    pairs, DmsaSlam.h:455-466).  Centralization
    (ContinuousTrajectory.h:75-100) is handled by the caller around this
    function — it rewrites the data pytree, not the params.

    structured_fn, when given, replaces the autodiff Jacobian
    (value_and_jacfwd: P tangent passes through the full point pipeline)
    with the problem's STRUCTURED Jacobian: it returns
    (ForwardOut, contract, J_extra) where contract(grad3 [N,3]) -> [N,P]
    maps per-point residual cotangents to parameter rows using the
    problem's pose sparsity (each point depends on exactly one pose-table
    entry), and J_extra [M,P] is the extra-residual Jacobian.  One
    elementwise pass + one run-sum per resolution instead of P full
    tangent passes — exact to floating point (tests/test_structured_jac).
    """
    num_params = params0.shape[0]
    step_length = settings.step_length_optim if step_length is None else step_length
    max_step_v = settings.max_step if max_step is None else max_step

    def residuals(params, merged_cells, data):
        """Residual vector over the MERGED per-resolution cell layout (one
        launch chain instead of one per resolution — the line search calls
        this 14x per iteration).  The squared total equals the per-
        resolution layout's, so it interchanges freely with the structured
        path's e0 in every dot product."""
        out = forward_fn(params, data)
        parts = [gaussians.cell_residuals(out.points, out.mask, merged_cells)]
        parts.append(out.extra)
        return jnp.concatenate(parts)

    def build_all_cells_from(out):
        cells = []
        for factor in (settings.grid_size_1_factor, settings.grid_size_2_factor):
            if factor > 1e-30:
                cells.append(
                    gaussians.build_cells(
                        out.points,
                        out.mask,
                        out.ring_ids,
                        factor * min_grid_size,
                        settings.min_num_points_per_set,
                        obs_weight=out.obs_weight,
                        split_ids=out.split_ids,
                    )
                )
        return tuple(cells)

    def iteration_tabular(params):
        """Tabular iteration (ops.fused_residuals): the Gauss-Newton normal
        equations and the ENTIRE line search each run as one pass over the
        merged sorted cell layout; candidate 0 of the line search is the
        un-stepped params, so the no-improvement comparison uses a single
        evaluation path."""
        from dmsa_lidar_slam_tpu.ops import fused_residuals as fr

        pdt = params.dtype
        out = forward_fn(params, data)
        xs, tidx = tabular_fn.point_arrays(data)
        tab_fn = lambda p: tabular_fn.tables(p, data)
        (tab, extra0), lin = jax.linearize(tab_fn, params)
        eye = jnp.eye(num_params, dtype=pdt)
        dtab, j_extra = jax.vmap(lin)(eye)  # [P, Dtab, 8], [P, E]

        packs, nvs = [], []
        for factor in (settings.grid_size_1_factor, settings.grid_size_2_factor):
            if factor > 1e-30:
                pk, nv, _ = fr.build_packed_ref(
                    out.points,
                    out.mask,
                    out.ring_ids,
                    xs,
                    tidx,
                    factor * min_grid_size,
                    settings.min_num_points_per_set,
                    obs_weight=out.obs_weight,
                    split_ids=out.split_ids,
                )
                packs.append(pk)
                nvs.append(nv)
        packed = packs[0] if len(packs) == 1 else jnp.concatenate(packs, axis=1)
        n_gauss = sum(nvs, jnp.array(0))

        hext = fr.gn_system_ref(tab, dtab, packed)
        H = hext[:num_params, :num_params].astype(pdt)
        g = hext[:num_params, num_params].astype(pdt)
        je = j_extra.astype(pdt)  # [P, E]
        H = H + je @ je.T + settings.lambda_diag * jnp.eye(num_params, dtype=pdt)
        g = g + je @ extra0.astype(pdt)
        step = -step_length * jnp.linalg.solve(H, g)

        nan_step = jnp.any(jnp.isnan(step))
        step = jnp.where(nan_step, jnp.zeros_like(step), step)
        max_elem = jnp.max(jnp.abs(step))
        step = jnp.where(
            max_elem > max_step_v,
            (max_step_v / jnp.maximum(max_elem, 1e-30)) * step,
            step,
        )

        ks = jnp.asarray(settings.line_search_fracs, dtype=pdt)
        cand_params = jnp.concatenate(
            [params[None, :], params[None, :] + ks[:, None] * step[None, :]], axis=0
        )
        tabs, extras = jax.vmap(tab_fn)(cand_params)
        errs = fr.cand_errors_ref(tabs, packed)
        errs = errs.astype(pdt) + jnp.sum(extras.astype(pdt) ** 2, axis=1)
        best = jnp.argmin(errs)
        new_params = jnp.where(best > 0, cand_params[best], params)
        new_error = errs[best]

        too_few = n_gauss < settings.min_num_gaussians
        no_improve = best == 0
        eps_stop = jnp.linalg.norm(step) < settings.epsilon
        stop_reason = jnp.where(
            too_few,
            STOP_TOO_FEW_GAUSSIANS,
            jnp.where(
                nan_step,
                STOP_NAN,
                jnp.where(
                    no_improve,
                    STOP_NO_IMPROVEMENT,
                    jnp.where(eps_stop, STOP_EPSILON, STOP_NONE),
                ),
            ),
        )
        accept = ~(too_few | nan_step | no_improve)
        params_out = jnp.where(accept, new_params, params)
        done = too_few | nan_step | no_improve | eps_stop
        return (
            params_out,
            done,
            stop_reason.astype(jnp.int32),
            new_error,
            n_gauss.astype(jnp.int32),
        )

    def iteration(params):
        if tabular_fn is not None:
            return iteration_tabular(params)
        if structured_fn is None:
            out = forward_fn(params, data)
            cells = build_all_cells_from(out)
            merged = gaussians.concat_cells(list(cells), out.points.shape[0])
            res_fn = lambda p: residuals(p, merged, data)
            # ONE linearize: its primal pass doubles as the e0 evaluation
            e0, J = value_and_jacfwd(res_fn, params, settings.jacobian_chunk)
        else:
            # structured Jacobian: per-point cotangents -> parameter rows
            # via the problem's pose sparsity; see the docstring above
            out, contract, J_extra = structured_fn(params, data)
            cells = build_all_cells_from(out)
            merged = gaussians.concat_cells(list(cells), out.points.shape[0])
            res_fn = lambda p: residuals(p, merged, data)
            e_parts, j_parts = [], []
            for c in cells:
                res, g_sorted = gaussians.cell_residuals_and_grad(out.points, out.mask, c)
                g_orig = jnp.zeros_like(out.points).at[c.order].set(g_sorted)
                jp = contract(g_orig)  # [N, P] per-point rows, original order
                jc = voxel.run_sums(jp[c.order], c.start, c.end)
                e_parts.append(res)
                j_parts.append(jnp.where(c.valid[:, None], jc, 0.0))
            e0 = jnp.concatenate(e_parts + [out.extra])
            rdt = e0.dtype  # concat promotes like the autodiff path
            J = jnp.concatenate([j.astype(rdt) for j in j_parts + [J_extra]], axis=0)
        n_gauss = sum((c.num_valid for c in cells), jnp.array(0))
        error0 = jnp.dot(e0, e0)

        H = J.T @ J
        H = H + settings.lambda_diag * jnp.eye(num_params, dtype=H.dtype)
        g = J.T @ e0
        step = -step_length * jnp.linalg.solve(H, g)

        nan_step = jnp.any(jnp.isnan(step))
        step = jnp.where(nan_step, jnp.zeros_like(step), step)

        # infinity-norm clip (DmsaOptimizer.h:125-128)
        max_elem = jnp.max(jnp.abs(step))
        step = jnp.where(
            max_elem > max_step_v,
            (max_step_v / jnp.maximum(max_elem, 1e-30)) * step,
            step,
        )

        # line search, one vmap (DmsaOptimizer.h:152-182); candidate grid
        # from settings.line_search_fracs (reference grid or a superset)
        ks = jnp.asarray(settings.line_search_fracs, dtype=params.dtype)
        cand_params = params[None, :] + ks[:, None] * step[None, :]
        cand_err = jax.vmap(lambda p: (lambda e: jnp.dot(e, e))(res_fn(p)))(cand_params)
        all_err = jnp.concatenate([error0[None], cand_err])
        best = jnp.argmin(all_err)
        new_params = jnp.where(best > 0, cand_params[jnp.maximum(best - 1, 0)], params)
        new_error = all_err[best]

        too_few = n_gauss < settings.min_num_gaussians
        no_improve = best == 0
        eps_stop = jnp.linalg.norm(step) < settings.epsilon

        stop_reason = jnp.where(
            too_few,
            STOP_TOO_FEW_GAUSSIANS,
            jnp.where(
                nan_step,
                STOP_NAN,
                jnp.where(
                    no_improve,
                    STOP_NO_IMPROVEMENT,
                    jnp.where(eps_stop, STOP_EPSILON, STOP_NONE),
                ),
            ),
        )
        # aborts keep the pre-step params (DmsaOptimizer.h:118,136)
        accept = ~(too_few | nan_step | no_improve)
        params_out = jnp.where(accept, new_params, params)
        done = too_few | nan_step | no_improve | eps_stop
        return (
            params_out,
            done,
            stop_reason.astype(jnp.int32),
            new_error,
            n_gauss.astype(jnp.int32),
        )

    def body(i, carry):
        params, done, reason, err, ng, iters, err0_first = carry

        def run(_):
            p, dn, rs, e, g = iteration(params)
            first = iters == 0
            return (p, dn, rs, e, g, iters + 1, jnp.where(first, e, err0_first))

        def skip(_):
            return carry

        return jax.lax.cond(done, skip, run, None)

    big = jnp.array(jnp.inf, dtype=params0.dtype)
    init = (
        params0,
        jnp.array(False),
        jnp.array(STOP_NONE, dtype=jnp.int32),
        big,
        jnp.array(0, dtype=jnp.int32),
        jnp.array(0, dtype=jnp.int32),
        big,
    )
    params, done, reason, err, ng, iters, err0 = jax.lax.fori_loop(0, settings.num_iter, body, init)
    return OptimResult(
        params=params,
        num_iters=iters,
        stop_reason=reason,
        final_error=err,
        initial_error=err0,
        num_gaussians=ng,
    )
