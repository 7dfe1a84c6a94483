"""Benchmark: realtime ratio of the full SLAM pipeline on synthetic data.

Runs the complete per-scan pipeline (preprocess -> window build -> static
points -> sliding-window DMSA -> keyframes -> submap DMSA) on a synthetic
LiDAR-inertial sequence at reference-like settings (see
io.synthetic.bench_config) and reports data-seconds processed per
wall-second, excluding jit warmup.

Measurement definitions (VERDICT r3 asked for one shared vocabulary):
  - value / realtime_ratio: data seconds per wall second over the timed
    scans.  The timed region covers everything the SLAM system itself does
    (IMU buffering, preprocessing dispatch, packing, upload, device step,
    event flush) but NOT synthetic data generation — the sensor-simulator
    cost is not a cost of the framework (a real sensor delivers data for
    free in real time; the reference reads pre-decoded bag messages).  Data
    generation is measured separately and reported as data_gen_s.
  - compile_s: wall time of the warmup scans (dominated by jit compilation;
    with a warm persistent compile cache it collapses to a few seconds).
  - device_ms_per_scan: steady-state device-busy time per scan from a
    jax.profiler trace of extra scans after the timed region, parsed with
    the same machinery as tools/profile.py (pipeline.traceutil).

The accuracy gate (trajectory ATE vs the analytic truth) is checked over
MULTIPLE seeds; the JSON line is ALWAYS printed — a failed gate sets
"gate": "failed" and exits nonzero AFTER printing, so a red round still
records its throughput (VERDICT r2 finding #3).

Baseline: the reference C++ runs at 0.33-0.5x realtime
(/root/reference/README.md:54); vs_baseline uses 0.5x (its best case).
"""

import json
import os
import sys
import time

import numpy as np

ATE_GATE_M = 0.03  # tightened from 0.10 (VERDICT r3: 8x margin hid regressions)
SEEDS = (3, 4, 7)  # multi-seed gate (VERDICT r2: single-seed is a coin flip)

# realistic long-run gates (VERDICT r3 #2): >= 30 s closed-loop circuit at
# OS-128 raw scale (131072 pts/rev), noisy+biased IMU, keyframe retirement
# AND revisit-driven deep submap spans; drift compounds here, so this is
# the regime the short bench cannot police
LONG_ATE_GATE_M = 0.05
LONG_MIN_SPAN = 17  # the uncapped suffix must demonstrably exceed 16
LONG_MIN_RATIO = 1.0  # BASELINE flagship target: >1x realtime AT SCALE
# (VERDICT r4 weak #1: the r4 gate checked only ATE/span, so "passed"
# coexisted with long.ratio = 0.64 — the flagship perf number being red)
LONG_SCANS = 310


def pregenerate(seq, n_scans: int, pts_per_scan: int = 20000, n_rings: int = 16):
    """Materialize the sensor stream up front (like a bag already decoded in
    RAM): per scan a (points, stamps, rings, imu_ts, imu_acc, imu_gyr)."""
    out = []
    t_imu = seq.t_start - 0.2
    for i in range(n_scans):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(t_imu, t_end)
        pts, stamps, rings = seq.scan(i, pts_per_scan, n_rings=n_rings)
        out.append((pts, stamps, rings, ts, acc, gyr))
        t_imu = t_end
    return out


def feed(slam, rec):
    pts, stamps, rings, ts, acc, gyr = rec
    slam.process_imu_batch(acc, gyr, ts)
    slam.process_scan(pts, stamps, rings)


def run_sequence(cfg, seq, data, timed_range, traced: int = 0):
    """Feed `data` into a fresh pipeline; time scans in timed_range.

    Returns (slam, wall_s over timed_range, warm_s over scans before it,
    device_ms_per_scan or nan)."""
    from dmsa_lidar_slam_tpu.pipeline.fused import FusedDmsaSlam

    lo, hi = timed_range
    slam = FusedDmsaSlam(cfg, flush_every=20)

    t_w0 = time.perf_counter()
    for i in range(lo):
        feed(slam, data[i])
    _ = slam.kf_count  # sync: compile + warmup fully done
    warm = time.perf_counter() - t_w0
    slam.metrics.reset_stages()  # stage_times = timed region only

    t0 = time.perf_counter()
    for i in range(lo, hi):
        feed(slam, data[i])
    _ = slam.kf_count  # drain the async dispatch queue
    wall = time.perf_counter() - t0

    dev_ms = float("nan")
    if traced > 0 and hi + traced <= len(data):
        from dmsa_lidar_slam_tpu.pipeline import traceutil

        with traceutil.capture() as d:
            for i in range(hi, hi + traced):
                feed(slam, data[i])
            _ = slam.kf_count
        dev_ms = traceutil.device_busy_ms(d) / traced
    return slam, wall, warm, dev_ms


# mid-run stressors applied to the pregenerated long-bench stream
# (VERDICT r4 #6: the proxy for real sensor data must include the failure
# modes real logs have).  The trajectory itself additionally carries a
# rotation-dominant yaw wobble (io.synthetic.long_sequence yaw_wobble).
IMU_DROPOUT_SCANS = range(150, 170)  # 2 s without any IMU mid-run:
# exercises the no-IMU gain fallback at scale (DmsaSlam.h:426,455-466)
SHORT_SCAN_EVERY = 37  # every 37th scan arrives truncated to 25% of its
# points (sensor hiccup / partial revolution)
SHORT_SCAN_KEEP = 0.25


def apply_long_stressors(data):
    """Mangle the pregenerated stream in place: IMU dropout window +
    periodically truncated scans.  Ground truth is unchanged (the platform
    still moves; only the SENSOR stream degrades), so the ATE gate still
    judges the result against the analytic trajectory."""
    out = []
    for i, (pts, stamps, rings, ts, acc, gyr) in enumerate(data):
        if i in IMU_DROPOUT_SCANS:
            ts, acc, gyr = ts[:0], acc[:0], gyr[:0]
        if i > 20 and i % SHORT_SCAN_EVERY == 0:
            n = max(1, int(len(pts) * SHORT_SCAN_KEEP))
            pts, stamps, rings = pts[:n], stamps[:n], rings[:n]
        out.append((pts, stamps, rings, ts, acc, gyr))
    return out


def run_long(seed: int = 3, n_scans: int = LONG_SCANS, n_warm: int = 10):
    """The realistic long benchmark, pre-generated into RAM like the short
    one (~1 GB at 131072 points/scan) so the timed region contains only
    what the SLAM system does."""
    from dmsa_lidar_slam_tpu.io.synthetic import ate_rmse, long_config, long_sequence
    from dmsa_lidar_slam_tpu.pipeline.fused import FusedDmsaSlam

    seq = long_sequence(seed)
    t_g0 = time.perf_counter()
    data = apply_long_stressors(
        pregenerate(seq, n_scans, pts_per_scan=131072, n_rings=128)
    )
    gen_s = time.perf_counter() - t_g0

    slam = FusedDmsaSlam(long_config(), flush_every=20)
    t_c0 = time.perf_counter()
    for i in range(n_warm):
        feed(slam, data[i])
    _ = slam.kf_count
    compile_s = time.perf_counter() - t_c0

    t0 = time.perf_counter()
    for i in range(n_warm, n_scans):
        feed(slam, data[i])
    _ = slam.kf_count
    wall = time.perf_counter() - t0

    st, tr, _ = slam.all_poses()
    ate = ate_rmse(st, tr, seq) if len(st) >= 3 else float("nan")
    data_s = (n_scans - n_warm) * seq.sweep
    return {
        "ratio": round(data_s / wall, 4),
        "ate_m": round(float(ate), 4),
        "ate_gate_m": LONG_ATE_GATE_M,
        "data_seconds": round(data_s, 1),
        "raw_points_per_scan": 131072,
        "keyframes_live": int(slam.kf_count),
        "trajectory_poses": int(len(st)),
        "max_submap_span": int(slam.max_submap_span),
        "compile_s": round(compile_s, 1),
        "gen_s": round(gen_s, 1),
    }


def main():
    from dmsa_lidar_slam_tpu.io.synthetic import ate_rmse, bench_config, bench_sequence

    cfg_fn = bench_config
    n_warm = 10  # scans for jit warmup (excluded from timing)
    n_bench = 40
    n_trace = 10

    # --- primary (timed) run, seed 3 ------------------------------------
    seq = bench_sequence(SEEDS[0])
    t_g0 = time.perf_counter()
    data = pregenerate(seq, n_warm + n_bench + n_trace)
    data_gen_s = time.perf_counter() - t_g0
    slam, wall, warm, dev_ms = run_sequence(
        cfg_fn(), seq, data, (n_warm, n_warm + n_bench), traced=n_trace
    )
    sweep = seq.sweep
    ratio = (n_bench * sweep) / wall

    ates = {}
    stamps, transl, _ = slam.all_poses()
    ates[SEEDS[0]] = ate_rmse(stamps, transl, seq) if len(stamps) >= 3 else float("nan")
    n_kf = slam.kf_count
    n_traj = len(stamps)
    stage_times = {k: round(v["total_s"], 3) for k, v in slam.metrics.summary().items()}

    # --- extra accuracy-only seeds (untimed) ----------------------------
    for seed in SEEDS[1:]:
        q2 = bench_sequence(seed)
        d2 = pregenerate(q2, n_warm + n_bench)
        s2, _, _, _ = run_sequence(cfg_fn(), q2, d2, (0, n_warm + n_bench))
        st2, tr2, _ = s2.all_poses()
        ates[seed] = ate_rmse(st2, tr2, q2) if len(st2) >= 3 else float("nan")

    worst = max(ates.values())
    short_ok = np.isfinite(worst) and worst <= ATE_GATE_M

    # --- realistic long run (retirement + revisits + OS-128 raw) --------
    long_d = run_long()
    # accuracy-only extra seeds (160 scans each: covers the dropout window
    # and a 26-deep submap span; VERDICT r2's multi-seed principle applied
    # to the long gate as well)
    long_ates = {SEEDS[0]: long_d["ate_m"]}
    for seed in SEEDS[1:]:
        long_ates[seed] = run_long(seed=seed, n_scans=160)["ate_m"]
    long_d["ate_per_seed_m"] = {str(k): v for k, v in long_ates.items()}
    # np.max propagates NaN (builtin max silently skips it, so a diverged
    # seed could pass); all seeds must also be finite
    worst_long = float(np.max(list(long_ates.values())))
    long_ok = (
        bool(np.all(np.isfinite(list(long_ates.values()))))
        and worst_long <= LONG_ATE_GATE_M
        and long_d["max_submap_span"] >= LONG_MIN_SPAN
        and long_d["ratio"] >= LONG_MIN_RATIO
    )
    gate_ok = short_ok and long_ok

    result = {
        "metric": "realtime_ratio",
        "value": round(ratio, 4),
        "unit": "x_realtime",
        "vs_baseline": round(ratio / 0.5, 4),
        "gate": "passed" if gate_ok else "failed",
        "detail": {
            "scans_per_sec": round(n_bench / wall, 3),
            "n_bench_scans": n_bench,
            "keyframes": int(n_kf),
            "trajectory_poses": int(n_traj),
            "synthetic_ate_rmse_m": round(float(ates[SEEDS[0]]), 4),
            "ate_per_seed_m": {str(k): round(float(v), 4) for k, v in ates.items()},
            "ate_gate_m": ATE_GATE_M,
            "device_ms_per_scan": round(dev_ms, 2) if np.isfinite(dev_ms) else None,
            "wall_ms_per_scan": round(1e3 * wall / n_bench, 2),
            "compile_s": round(warm, 2),
            "data_gen_s": round(data_gen_s, 2),
            "stage_times": stage_times,
            "long": long_d,
        },
    }
    print(json.dumps(result))
    if not gate_ok:
        print(
            f"bench gate FAILED: short worst ATE {worst:.4f} m (gate {ATE_GATE_M}), "
            f"long worst ATE {np.max(list(long_d['ate_per_seed_m'].values()))} m "
            f"(gate {LONG_ATE_GATE_M}), "
            f"max span {long_d['max_submap_span']} (min {LONG_MIN_SPAN}), "
            f"long ratio {long_d['ratio']} (min {LONG_MIN_RATIO})",
            file=sys.stderr,
        )
        sys.exit(1)


if __name__ == "__main__":
    main()
