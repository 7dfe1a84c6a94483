"""Trace the fused per-scan step on the GPU and print where the device time goes.

Runs one deployment through FusedDmsaSlam — `short` (io.synthetic
bench_config / bench_sequence) or `long` (long_config / long_sequence with
bench.apply_long_stressors: OS-128-scale raw scans, uncapped submap spans)
— warms up past compilation, traces a window of steady-state scans with
jax.profiler, and prints device-busy ms per scan, the idle share, and the
top kernels by device time.  The reduction is pipeline.traceutil, the same
one bench.py and chip_smoke.py use.

Usage: python tools/profile.py [--cell short|long] [--warm N] [--traced N]
"""

import argparse
import collections
import os
import re
import sys
import time

# the repo root REPLACES this script's directory on the path, so that this
# file never shadows the standard library's `profile` module
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_and_trace(cell: str, n_warm: int, n_traced: int):
    import bench
    from dmsa_lidar_slam_tpu.io import synthetic as syn
    from dmsa_lidar_slam_tpu.pipeline import traceutil
    from dmsa_lidar_slam_tpu.pipeline.fused import FusedDmsaSlam

    n = n_warm + n_traced
    if cell == "long":
        seq, cfg = syn.long_sequence(3), syn.long_config()
        data = bench.apply_long_stressors(
            bench.pregenerate(seq, n, pts_per_scan=131072, n_rings=128)
        )
    else:
        seq, cfg = syn.bench_sequence(3), syn.bench_config()
        data = bench.pregenerate(seq, n)

    slam = FusedDmsaSlam(cfg, flush_every=20)
    for i in range(n_warm):
        bench.feed(slam, data[i])
    _ = slam.kf_count  # sync: compilation and warm-up done

    t0 = time.perf_counter()
    with traceutil.capture() as trace_dir:
        for i in range(n_warm, n):
            bench.feed(slam, data[i])
        _ = slam.kf_count
    wall_ms = 1e3 * (time.perf_counter() - t0)
    return traceutil.device_lines(trace_dir), wall_ms


def summarize(lines, wall_ms: float, n_traced: int, top: int = 30):
    from dmsa_lidar_slam_tpu.pipeline import traceutil

    busy = sum(traceutil.busy_ms(lines).values())
    print(
        f"device busy {busy / n_traced:.3f} ms/scan, traced wall "
        f"{wall_ms / n_traced:.3f} ms/scan, idle share {1.0 - busy / wall_ms:.3f}\n"
    )
    ms, n = traceutil.op_totals(lines)
    print("top kernels (total over the traced scans):")
    for k, v in sorted(ms.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {v:9.3f} ms  x{n[k]:6d}  {k[:110]}")
    cat, catn = collections.Counter(), collections.Counter()
    for k, v in ms.items():
        base = re.sub(r"[._]?\d+$", "", k)
        cat[base] += v
        catn[base] += n[k]
    print("\nby kernel family:")
    for k, v in sorted(cat.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {v:9.3f} ms  x{catn[k]:7d}  {k[:110]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", choices=["short", "long"], default="short")
    ap.add_argument("--warm", type=int, default=None, help="warm-up scans (default 12 short, 40 long)")
    ap.add_argument("--traced", type=int, default=8)
    args = ap.parse_args()
    n_warm = args.warm if args.warm is not None else (40 if args.cell == "long" else 12)
    lines, wall_ms = run_and_trace(args.cell, n_warm, args.traced)
    summarize(lines, wall_ms, args.traced)


if __name__ == "__main__":
    main()
