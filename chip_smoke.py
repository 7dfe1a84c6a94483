"""Smoke run of the SLAM system on one NVIDIA GPU: the quickest proof that
the production pipeline still starts, runs and is right on the card.

    python chip_smoke.py                # one card, phases 1-5
    python chip_smoke.py --four-cards   # distributed submap path on 4 cards

One process drives the card(s); nothing falls back to the CPU.  Without a
GPU the script exits non-zero before any phase.  Every phase failure ends
the run with a non-zero exit and no result line.

Phases (one card):
  1. CLI runner on a synthetic Ouster rosbag (native decoder, fused
     pipeline, Poses.txt + PointCloud.pcd);
  2. short deployment: io.synthetic.bench_config / bench_sequence(3),
     20k-point raw scans, 60 scans, ATE <= 0.03 m;
  3. full-width deployment: long_config / long_sequence(3), OS-128-scale
     131072-point raw scans, 48-keyframe ring with uncapped submap spans,
     bench.apply_long_stressors, 160 scans, ATE <= 0.05 m, span >= 17,
     plus the compiled step's memory analysis and the keyframe normals'
     time per keyframe event;
  4. kernels and numerics against references at real widths;
  5. a profiler trace of 5 short-deployment scans: device-busy ms > 0.

--four-cards runs only the spatial distributed submap adjustment
(parallel.spatial) over 4 cards on the long deployment, the same sequence
on one card, and __graft_entry__.dryrun_multichip(4).

The last line of stdout is {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import dmsa_lidar_slam_tpu  # noqa: E402,F401  (x64, matmul precision, compile cache)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from dmsa_lidar_slam_tpu.io import synthetic as syn  # noqa: E402
from dmsa_lidar_slam_tpu.pipeline.fused import FusedDmsaSlam  # noqa: E402

SHORT_SCANS = 60
SHORT_WARM = 10
LONG_SCANS = 160
LONG_WARM = 10
TRACE_SCANS = 5
PARITY_M = 0.02  # keyframe-position bound of __graft_entry__.dryrun_multichip


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def run_stream(slam, data, lo, hi):
    """Feed scans [lo, hi) and wait for the device; returns wall seconds."""
    t0 = time.perf_counter()
    for i in range(lo, hi):
        bench.feed(slam, data[i])
    _ = slam.kf_count
    return time.perf_counter() - t0


def cards_bytes_in_use(n):
    return [int(d.memory_stats()["bytes_in_use"]) for d in jax.devices()[:n]]


def trajectory_ate(slam, seq):
    stamps, transl, _ = slam.all_poses()
    transl = np.asarray(transl, float)
    if len(stamps) < 3 or not np.all(np.isfinite(transl)):
        return float("nan"), stamps, transl
    return syn.ate_rmse(stamps, transl, seq), stamps, transl


def trajectory_at(slam, stamps):
    """Positions [n, 3] of the run's full trajectory at `stamps`
    (interpolated linearly between its poses)."""
    st, tr, _ = slam.all_poses()
    order = np.argsort(st)
    st, tr = np.asarray(st, float)[order], np.asarray(tr, float)[order]
    return np.stack([np.interp(stamps, st, tr[:, k]) for k in range(3)], axis=1)


def step_memory(slam):
    """memory_analysis() of the compiled per-scan step at this shape."""
    sh = slam.shapes
    pack = jax.ShapeDtypeStruct((sh.raw_cap, 5), jnp.int16)
    aux = jax.ShapeDtypeStruct((sh.aux_rows, 6), jnp.float32)
    ma = slam.step.lower(slam.state, pack, aux).compile().memory_analysis()
    return {
        k: int(getattr(ma, k))
        for k in (
            "argument_size_in_bytes",
            "output_size_in_bytes",
            "temp_size_in_bytes",
            "generated_code_size_in_bytes",
        )
    }


def deployment(name, cfg, seq, data, n_warm):
    """Run one deployment: warm-up (compile) scans, then timed scans."""
    slam = FusedDmsaSlam(cfg, flush_every=20)
    compile_s = run_stream(slam, data, 0, n_warm)
    wall = run_stream(slam, data, n_warm, len(data))
    ate, _, transl = trajectory_ate(slam, seq)
    log(
        f"[{name}] compile_s={compile_s:.1f} wall_ms_per_scan="
        f"{1e3 * wall / (len(data) - n_warm):.2f} ate_m={ate:.4f} "
        f"keyframes={slam.kf_count} max_submap_span={slam.max_submap_span} "
        f"scans={len(data)}"
    )
    assert np.all(np.isfinite(transl)), f"{name}: non-finite poses"
    return slam, ate


# ---------------------------------------------------------------- phases


def phase_runner():
    from dmsa_lidar_slam_tpu.io import native
    from dmsa_lidar_slam_tpu.io.synthetic_bag import read_outputs, runner_overrides, write_synthetic_bag
    from dmsa_lidar_slam_tpu.pipeline import runner

    assert native.available(), "native IO library did not build or load"
    with tempfile.TemporaryDirectory(prefix="dmsa_smoke_") as d:
        bag = os.path.join(d, "synthetic.bag")
        seq = write_synthetic_bag(bag)
        t0 = time.perf_counter()
        slam = runner.run([], overrides=runner_overrides(bag, d, use_imu=True), pipeline="fused")
        wall = time.perf_counter() - t0
        out = read_outputs(d, seq)
    log(
        f"[runner] wall_s={wall:.1f} (compile included) ate_m={out['ate_m']:.4f} "
        f"poses={out['n_poses']} map_points={out['n_map_points']} "
        f"keyframes={slam.kf_count} max_submap_span={slam.max_submap_span}"
    )
    assert slam.kf_count >= 2
    assert out["n_poses"] >= 3 and out["rows_well_formed"] and out["stamps_ordered"]
    assert out["ate_m"] < 0.15, out
    assert out["n_map_points"] > 500, out


def short_data():
    seq = syn.bench_sequence(3)
    return seq, bench.pregenerate(seq, SHORT_SCANS + TRACE_SCANS)


def phase_short(seq, data):
    slam, ate = deployment("short", syn.bench_config(), seq, data[:SHORT_SCANS], SHORT_WARM)
    assert ate <= bench.ATE_GATE_M, f"short ATE {ate} > {bench.ATE_GATE_M}"
    assert slam.kf_count >= 2
    return slam


def long_data(n_scans):
    seq = syn.long_sequence(3)
    t0 = time.perf_counter()
    data = bench.apply_long_stressors(
        bench.pregenerate(seq, n_scans, pts_per_scan=131072, n_rings=128)
    )
    log(f"[long] generated {n_scans} scans in {time.perf_counter() - t0:.1f} s")
    return seq, data


def keyframe_normals_time(slam, reps=20):
    """Hash-grid normals of one stored keyframe cloud, timed alone on the
    card: the work a keyframe event adds for its new keyframe."""
    from dmsa_lidar_slam_tpu.map import normals as nrm

    kf = slam.state.kf
    args = (kf.local_pts[0], kf.pt_mask[0], kf.grid_size[0])
    fn = jax.jit(nrm.estimate_normals)
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    ms = 1e3 * (time.perf_counter() - t0) / reps
    log(f"[long] keyframe normals ({args[0].shape[0]} points): {ms:.3f} ms per keyframe event")
    assert np.all(np.isfinite(np.asarray(out)))


def phase_long(seq, data):
    slam, ate = deployment("long", syn.long_config(), seq, data, LONG_WARM)
    log(f"[long] step memory_analysis: {json.dumps(step_memory(slam))}")
    keyframe_normals_time(slam)
    assert ate <= bench.LONG_ATE_GATE_M, f"long ATE {ate} > {bench.LONG_ATE_GATE_M}"
    assert slam.max_submap_span >= bench.LONG_MIN_SPAN, slam.max_submap_span


def check_min_dist(name, refs, queries, radius):
    """The min-distance sweep on the card vs an f64 cKDTree."""
    from scipy.spatial import cKDTree

    from dmsa_lidar_slam_tpu.ops import nn_bruteforce as nb

    d, _ = cKDTree(refs.astype(np.float64)).query(queries.astype(np.float64))
    d2_64 = d * d
    r, q = nb._operands(jnp.asarray(refs), jnp.ones(len(refs), bool), jnp.asarray(queries))
    band = np.abs(d - radius) < 1e-4
    got = np.asarray(jax.jit(nb._sweep)(r, q), np.float64)
    err = np.abs(got - d2_64)
    worst = float(np.max(err - (1e-4 + 1e-3 * d2_64)))
    within = got <= radius * radius
    mism = int(np.sum(within[~band] != (d <= radius)[~band]))
    log(
        f"[kernels] min_sq_dist {name}: max_abs_err={err.max():.3e} m^2 "
        f"bound_margin={-worst:.3e} has_neighbor_mismatch={mism} (band {int(band.sum())})"
    )
    assert worst <= 0.0, f"{name}: |d2 - d2_f64| over 1e-4 + 1e-3 d2"
    assert mism == 0, f"{name}: has_neighbor_within differs outside the band"


def check_gn_refs():
    """gn_system_ref / cand_errors_ref on the card vs the CPU in f64."""
    from dmsa_lidar_slam_tpu.ops import fused_residuals as fr
    from tests.test_fused_residuals import _problem

    rng, xs, mask, rings, tidx, tab0, cells, packed, rand_tab = _problem(seed=1, n=20480)
    tabs = np.stack([tab0] + [rand_tab(rng, 0.1) for _ in range(14)])
    p_dim = 30
    dtabs = (0.1 * rng.standard_normal((p_dim, tab0.shape[0], 8))).astype(np.float32)
    dtabs[:, -1, :] = 0.0
    pk = np.asarray(packed)

    gpu_err = np.asarray(jax.jit(fr.cand_errors_ref)(jnp.asarray(tabs), jnp.asarray(pk)))
    gpu_h = np.asarray(jax.jit(fr.gn_system_ref)(jnp.asarray(tab0), jnp.asarray(dtabs), jnp.asarray(pk)))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        c64 = lambda a: jax.device_put(np.asarray(a, np.float64), cpu)
        cpu_err = np.asarray(fr.cand_errors_ref(c64(tabs), c64(pk)))
        cpu_h = np.asarray(fr.gn_system_ref(c64(tab0), c64(dtabs), c64(pk)))
    err_rel = float(np.max(np.abs(gpu_err - cpu_err) / np.abs(cpu_err)))
    scale = float(np.max(np.abs(cpu_h)))
    h_rel = float(np.max(np.abs(gpu_h - cpu_h)) / scale)
    log(f"[kernels] cand_errors_ref max_rel_err={err_rel:.3e} (bound 2e-4); "
        f"gn_system_ref max_err/scale={h_rel:.3e} (bound 3e-3)")
    assert err_rel <= 2e-4 and h_rel <= 3e-3


def phase_kernels(long_scans):
    # real widths from the bench shapes: window (20480) vs candidate
    # keyframes (3 x 4096), and active static points (8192) vs window
    pts = [np.asarray(s[0], np.float32) for s in long_scans[:4]]
    rng = np.random.default_rng(0)

    def take(a, n):
        return a[rng.choice(len(a), n, replace=False)]

    check_min_dist("refs20480xq12288", take(pts[0], 20480), take(pts[1], 12288), 0.2)
    check_min_dist("refs8192xq20480", take(pts[2], 8192), take(pts[3], 20480), 0.2)
    check_gn_refs()


def phase_trace(slam, data):
    from dmsa_lidar_slam_tpu.pipeline import traceutil

    with traceutil.capture() as d:
        wall = run_stream(slam, data, SHORT_SCANS, SHORT_SCANS + TRACE_SCANS)
    busy = traceutil.busy_ms(traceutil.device_lines(d))
    total = sum(busy.values())
    log(
        f"[trace] device_busy_ms_per_scan={total / TRACE_SCANS:.3f} "
        f"wall_ms_per_scan={1e3 * wall / TRACE_SCANS:.3f} "
        f"idle_share={1.0 - total / (1e3 * wall):.3f} cards={sorted(busy)}"
    )
    assert total > 0.0


# ------------------------------------------------------------ four cards


def four_cards():
    """4-card spatial submap path vs the same stream on one card, plus
    __graft_entry__.dryrun_multichip(4).

    The 1-card run and the dry run go in worker threads while the 4-card
    run goes on the main thread, so their compilations (minutes of host
    work each) overlap; the ms/scan of that part is therefore no speed
    measurement.  Afterwards each pipeline runs the same 10 further scans
    alone (timed), and the 4-card one 10 more under the profiler, so the
    card-activity trace shows the 4-card pipeline alone."""
    from concurrent.futures import ThreadPoolExecutor

    from __graft_entry__ import dryrun_multichip
    from dmsa_lidar_slam_tpu.pipeline import traceutil

    assert len(jax.devices()) >= 4, f"--four-cards needs 4 GPUs, JAX sees {len(jax.devices())}"
    seq, data = long_data(LONG_SCANS + 20)
    data, extra = data[:LONG_SCANS], data
    with ThreadPoolExecutor(2) as pool:
        one = pool.submit(deployment, "long-1card", syn.long_config(), seq, data, LONG_WARM)
        dry = pool.submit(dryrun_multichip, 4)
        slam4, ate4 = deployment(
            "long-4cards", syn.long_config(distributed_keyframe_opt=True), seq, data, LONG_WARM
        )
        slam1, ate1 = one.result()
        dry.result()
    assert slam4.mesh is not None and slam4.mesh.devices.size == 4, "mesh is not 4 cards"
    assert slam4.shuffle_overflow == 0, f"spatial shuffle overflow {slam4.shuffle_overflow}"
    s4, t4, _ = slam4.keyframe_poses()
    s1, t1, _ = slam1.keyframe_poses()
    common = np.intersect1d(s4, s1)
    # each run's keyframes against the other run's trajectory at the same
    # stamps, so a keyframe decided one scan earlier in one run still
    # counts (keyframe stamps are scan stamps of both trajectories)
    parity = max(
        float(np.max(np.linalg.norm(t4 - trajectory_at(slam1, s4), axis=1))),
        float(np.max(np.linalg.norm(t1 - trajectory_at(slam4, s1), axis=1))),
    )
    log(
        f"[4cards] live keyframes 4-card={len(s4)} 1-card={len(s1)} common={len(common)} "
        f"parity_m={parity:.4f} (bound {PARITY_M}) ate 4-card={ate4:.4f} 1-card={ate1:.4f}"
    )
    assert len(s4) >= 2 and len(s1) >= 2
    assert parity <= PARITY_M

    # the same 10 further scans through each pipeline alone, then 10 traced
    lo, mid, hi = LONG_SCANS, LONG_SCANS + 10, LONG_SCANS + 20
    wall1 = run_stream(slam1, extra, lo, mid)
    wall4 = run_stream(slam4, extra, lo, mid)
    log(
        f"[4cards] 10 scans alone: wall_ms_per_scan 1-card={100.0 * wall1:.2f} "
        f"4-card={100.0 * wall4:.2f} (keyframes 1-card={slam1.kf_count} 4-card={slam4.kf_count})"
    )
    with traceutil.capture() as d:
        wall = run_stream(slam4, extra, mid, hi)
    busy = traceutil.busy_ms(traceutil.device_lines(d))
    in_use = cards_bytes_in_use(4)
    log(
        f"[4cards] 10 traced scans: wall_ms_per_scan={100.0 * wall:.2f} "
        f"device_busy_ms per card={busy} bytes_in_use per card={in_use}"
    )
    assert all(busy.get(i, 0.0) > 0.0 for i in range(4)), "a card ran nothing"
    assert all(b > 0 for b in in_use), "a card holds no memory"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true", help="run the 4-card distributed path")
    args = ap.parse_args()

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX finds no GPU (platform {devs[0].platform!r})")
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")

    if args.four_cards:
        four_cards()
    else:
        phase_runner()
        sseq, sdata = short_data()
        short = phase_short(sseq, sdata)
        lseq, ldata = long_data(LONG_SCANS)
        phase_long(lseq, ldata)
        phase_kernels(ldata)
        phase_trace(short, sdata)
    print(json.dumps({"ok": True, "device": {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    main()
