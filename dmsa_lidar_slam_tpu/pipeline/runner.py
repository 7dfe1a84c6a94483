"""CLI runner: rosbag(s) -> DMSA SLAM -> Poses.txt + PointCloud.pcd.

Equivalent of the reference's main()/dmsa_slam_ros::spin (reference:
src/main.cpp:19-29, src/dmsa_slam_ros.cpp:240-307): iterate the bag(s) over
the lidar + imu topics in bag order, dispatch to the SLAM pipeline, write
cyclic outputs every 20 clouds and final outputs at the end.

Usage:
    python -m dmsa_lidar_slam_tpu.pipeline.runner config/slam_settings.yaml \
        config/newer_college_ouster_64.yaml [--max-scans N]
"""

import argparse
import contextlib
import logging
import sys
import time

import numpy as np

from dmsa_lidar_slam_tpu.config import load_config
from dmsa_lidar_slam_tpu.io import pointcloud2 as pc2
from dmsa_lidar_slam_tpu.io import rosbag
from dmsa_lidar_slam_tpu.io.pcd import save_pcd
from dmsa_lidar_slam_tpu.pipeline.slam import DmsaSlam

log = logging.getLogger("dmsa_runner")

CYCLIC_SAVE_EVERY = 20  # clouds (dmsa_slam_ros.cpp:495-506)


def save_outputs(slam, result_dir: str, with_viz: bool = False):
    path = slam.save_poses(result_dir)
    pts = slam.map_points()
    if pts is not None and len(pts):
        save_pcd(f"{result_dir}/PointCloud.pcd", pts)
    if with_viz:
        from dmsa_lidar_slam_tpu.pipeline import viz

        viz.export_all(slam, result_dir)
    return path


def run(
    config_paths,
    overrides=None,
    max_scans=None,
    result_dir=None,
    pipeline="fused",
    viz_every=0,
    profile_dir=None,
    live_port=None,
    live_host="127.0.0.1",
):
    cfg = load_config(*config_paths, overrides=overrides)
    if result_dir:
        cfg.result_dir = result_dir
    if cfg.live_view and not viz_every:
        viz_every = CYCLIC_SAVE_EVERY
    live = None
    if live_port is not None:
        from dmsa_lidar_slam_tpu.pipeline.live_view import LiveViewServer

        live = LiveViewServer(port=live_port, host=live_host).start()
        log.warning("live view at http://localhost:%d/", live.port)
    if pipeline == "fused":
        from dmsa_lidar_slam_tpu.pipeline.fused import FusedDmsaSlam

        slam = FusedDmsaSlam(cfg)
    else:
        slam = DmsaSlam(cfg)

    topics = [t for t in (cfg.lidar_topic, cfg.imu_topic) if t]
    t_start = time.perf_counter()
    prof = contextlib.nullcontext()
    if profile_dir:
        import jax

        prof = jax.profiler.trace(profile_dir)
        log.info("capturing jax profiler trace -> %s", profile_dir)
    with prof:
        n_scans = _process_bags(slam, cfg, topics, max_scans, viz_every, live)

    wall = time.perf_counter() - t_start
    path = save_outputs(slam, cfg.result_dir, with_viz=bool(viz_every))
    log.info("processed %d scans in %.1fs -> %s", n_scans, wall, path)
    log.info("stage timings: %s", slam.metrics.summary())
    if live is not None:
        live.publish(slam, n_scans)  # final frame stays served until exit
    return slam


LIVE_PUBLISH_EVERY = 5  # scans between live-view snapshots (one transfer each)


def _process_bags(slam, cfg, topics, max_scans, viz_every, live=None):
    n_scans = 0
    last_pc_stamp = None
    for msg in rosbag.read_messages_multi(cfg.bag_dirs, topics):
        if msg.topic == cfg.lidar_topic:
            cloud = pc2.parse_pointcloud2(msg.raw)
            if cfg.sensor == "unknown" and last_pc_stamp is None:
                last_pc_stamp = cloud.stamp
                continue
            pts, stamps, rings = pc2.decode_points(cloud, cfg.sensor, last_pc_stamp)
            last_pc_stamp = cloud.stamp
            slam.process_scan(pts, stamps, rings)
            n_scans += 1
            if live is not None and n_scans % LIVE_PUBLISH_EVERY == 0:
                live.publish(slam, n_scans)
            if n_scans % CYCLIC_SAVE_EVERY == 0:
                save_outputs(slam, cfg.result_dir, with_viz=viz_every and n_scans % viz_every == 0)
            if max_scans and n_scans >= max_scans:
                break
        elif msg.topic == cfg.imu_topic:
            imu = pc2.parse_imu(msg.raw)
            slam.process_imu(imu.linear_acceleration, imu.angular_velocity, imu.stamp)
    return n_scans


def main(argv=None):
    parser = argparse.ArgumentParser(description="DMSA LiDAR SLAM")
    parser.add_argument("configs", nargs="+", help="YAML config overlay paths (in order)")
    parser.add_argument("--max-scans", type=int, default=None)
    parser.add_argument("--result-dir", default=None)
    parser.add_argument(
        "--pipeline",
        choices=["fused", "host"],
        default="fused",
        help="fused: device-resident one-dispatch-per-scan; host: reference-style orchestration",
    )
    parser.add_argument("--viz-every", type=int, default=0, help="export PLY/HTML viz every N scans")
    parser.add_argument(
        "--live-view-port",
        type=int,
        default=None,
        help="serve a live map/trajectory view (RViz equivalent, "
        "dmsa_slam_ros.cpp:322-372) at http://localhost:PORT/ while running "
        "(0 = pick a free port)",
    )
    parser.add_argument(
        "--live-view-host",
        default="127.0.0.1",
        help="bind address for the live view (default loopback; use "
        "0.0.0.0 to expose it to the network)",
    )
    parser.add_argument(
        "--profile-dir",
        default=None,
        help="capture a jax profiler trace of the whole run into this "
        "directory (open with xprof/tensorboard); host stages are named "
        "via TraceAnnotation",
    )
    parser.add_argument(
        "--distributed-keyframe-opt",
        action="store_true",
        help="shard the keyframe submap adjustment over jax.devices() "
        "(BASELINE config 5; works in BOTH pipelines — the fused pipeline "
        "runs it inside the per-scan jit step over its own mesh)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    overrides = {"distributed_keyframe_opt": True} if args.distributed_keyframe_opt else None
    run(
        args.configs,
        overrides=overrides,
        max_scans=args.max_scans,
        result_dir=args.result_dir,
        pipeline=args.pipeline,
        viz_every=args.viz_every,
        profile_dir=args.profile_dir,
        live_port=args.live_view_port,
        live_host=args.live_view_host,
    )


if __name__ == "__main__":
    main()
