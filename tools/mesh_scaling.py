"""Virtual-mesh scaling / work-balance record for the flagship distributed
keyframe adjustment (BASELINE config 5 shape).

Runs the sharded keyframe optimization at 1/2/4/8 virtual CPU devices on
the SAME problem and reports, per mesh size:
  - wall time per full optimization (all mesh sizes share one host's cores,
    so wall time here is an overhead record, NOT a scaling-efficiency
    claim — one real chip in this environment),
  - per-device work balance: valid points and owned cells per shard (the
    quantity that WOULD determine scaling efficiency on real hardware),
  - parity of the result across mesh sizes (device-count invariance).

Usage: python tools/mesh_scaling.py   (forces CPU + 8 virtual devices)
Writes SCALING.md at the repo root.
"""

import json
import os
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
from jax.sharding import Mesh


def main():
    import __graft_entry__ as ge
    from dmsa_lidar_slam_tpu.parallel import keyframe_dist
    from dmsa_lidar_slam_tpu.utils.dtypes import pose_dtype

    pdt = pose_dtype()
    shapes, kf_map, rng = ge._flagship_keyframe_map()
    data, params_true = kf_map.to_problem_data(0, 1.0, 100.0)
    noise = rng.normal(scale=0.01, size=params_true.shape)
    noise[: 3 * (shapes.n_keyframes - 1)] *= 0.3
    params0 = jnp.asarray(params_true + noise, dtype=pdt)
    num_iter, min_grid = 6, 0.2
    grids = jnp.asarray([2.0 * min_grid, 5.0 * min_grid], dtype=pdt)

    flat_pts, flat_mask, flat_rings, aux = keyframe_dist.flatten_problem(data)
    n_total = flat_pts.shape[0]

    rows = []
    results = {}
    for n_dev in (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
        opt_fn = keyframe_dist.make_keyframe_dist_optimize(
            mesh, shapes, num_iter=num_iter, min_points=6,
            step_length=0.3, max_step=0.1, use_gravity=True, use_odometry=True,
        )
        # warmup/compile
        out = opt_fn(params0, flat_pts, flat_mask, flat_rings, aux, grids)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = opt_fn(params0, flat_pts, flat_mask, flat_rings, aux, grids)
        jax.block_until_ready(out)
        wall = time.perf_counter() - t0
        results[n_dev] = np.asarray(out[0])

        # work balance: valid points per shard (equal split of the flat axis)
        per = n_total // n_dev
        valid_per_shard = [int(np.asarray(flat_mask[i * per : (i + 1) * per]).sum()) for i in range(n_dev)]
        balance = min(valid_per_shard) / max(valid_per_shard)
        rows.append(
            dict(
                devices=n_dev,
                wall_s=round(wall, 3),
                points_per_shard=per,
                valid_points_per_shard=valid_per_shard,
                balance_min_over_max=round(balance, 4),
                cells=int(out[3]),
                iters=int(out[1]),
            )
        )
        print(rows[-1])

    # device-count invariance of the result
    base = results[1]
    for n_dev in (2, 4, 8):
        dev = float(np.max(np.abs(results[n_dev] - base)))
        rows_i = next(r for r in rows if r["devices"] == n_dev)
        rows_i["max_param_dev_vs_1dev"] = dev
        print(f"devices={n_dev}: max param deviation vs 1-device run = {dev:.2e}")

    with open("SCALING.md", "w") as f:
        f.write(
            "# Virtual-mesh scaling record (flagship distributed keyframe adjustment)\n\n"
            "One host, 8 virtual CPU devices (`--xla_force_host_platform_device_count=8`)\n"
            "— all mesh sizes share the same physical cores, so wall time is an\n"
            "orchestration-overhead record, NOT a scaling-efficiency claim.\n"
            "The load-balance column is the\n"
            "quantity that determines efficiency on real hardware: valid points per\n"
            f"shard of the K={shapes.n_keyframes} x P={shapes.n_pts_per_kf} keyframe problem "
            f"({n_total} flat slots,\n{params0.shape[0]} pose params, "
            f"{num_iter} GN iterations, gravity+odometry terms).\n\n"
        )
        f.write("| devices | wall s | valid pts/shard (min..max) | balance | max param dev vs 1-dev |\n")
        f.write("|---|---|---|---|---|\n")
        for r in rows:
            v = r["valid_points_per_shard"]
            devcol = f"{r.get('max_param_dev_vs_1dev', 0.0):.2e}" if r["devices"] > 1 else "—"
            f.write(
                f"| {r['devices']} | {r['wall_s']} | {min(v)}..{max(v)} | "
                f"{r['balance_min_over_max']} | {devcol} |\n"
            )
        f.write("\nRaw rows:\n\n```json\n")
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write("```\n")
    print("wrote SCALING.md")


if __name__ == "__main__":
    main()
