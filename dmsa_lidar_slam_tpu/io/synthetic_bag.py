"""Synthetic rosbag1 recordings for end-to-end runs of the CLI runner.

Writes IMU + Ouster-layout PointCloud2 messages from an io.synthetic
sequence into a bag, so a run covers the same seam a real recording does:
bag reader -> PointCloud2 decoder (native or numpy) -> pipeline ->
Poses.txt / PointCloud.pcd (reference: src/dmsa_slam_ros.cpp:240-307).
"""

import struct

import numpy as np

from dmsa_lidar_slam_tpu.io import rosbag
from dmsa_lidar_slam_tpu.io.synthetic import SyntheticSequence, ate_rmse

# ouster point layout (dmsa_slam_ros.cpp ouster branch): name, offset,
# PointField datatype, count
OUSTER_FIELDS = [
    ("x", 0, 7, 1),
    ("y", 4, 7, 1),
    ("z", 8, 7, 1),
    ("intensity", 12, 7, 1),
    ("t", 16, 6, 1),
    ("reflectivity", 20, 4, 1),
    ("ring", 22, 2, 1),
]
OUSTER_POINT_STEP = 24


def serialize_header(stamp: float, frame_id=b"map") -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    return struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", len(frame_id)) + frame_id


def serialize_imu(stamp, ang, acc) -> bytes:
    """sensor_msgs/Imu bytes (identity orientation, zero covariances)."""
    raw = serialize_header(stamp, b"imu")
    raw += struct.pack("<4d", 0, 0, 0, 1)
    raw += struct.pack("<9d", *([0.0] * 9))
    raw += struct.pack("<3d", *ang)
    raw += struct.pack("<9d", *([0.0] * 9))
    raw += struct.pack("<3d", *acc)
    raw += struct.pack("<9d", *([0.0] * 9))
    return raw


def serialize_ouster_scan(pts, stamps, rings) -> bytes:
    """PointCloud2 bytes in the ouster layout: header stamp = scan start,
    per-point t = ns offset."""
    t0 = float(stamps.min())
    n = len(pts)
    rec = np.zeros(
        n,
        dtype=np.dtype(
            {
                "names": ["xyz", "t", "ring"],
                "formats": [("<f4", 3), "<u4", "u1"],
                "offsets": [0, 16, 22],
                "itemsize": OUSTER_POINT_STEP,
            }
        ),
    )
    rec["xyz"] = pts
    rec["t"] = np.round((stamps - t0) * 1e9).astype(np.uint32)
    rec["ring"] = np.asarray(rings) & 0xFF
    buf = rec.tobytes()
    raw = serialize_header(t0)
    raw += struct.pack("<II", 1, n)
    raw += struct.pack("<I", len(OUSTER_FIELDS))
    for name, off, dt, cnt in OUSTER_FIELDS:
        nb = name.encode()
        raw += struct.pack("<I", len(nb)) + nb + struct.pack("<IBI", off, dt, cnt)
    raw += struct.pack("<B", 0)
    raw += struct.pack("<II", OUSTER_POINT_STEP, n * OUSTER_POINT_STEP)
    raw += struct.pack("<I", len(buf)) + buf
    raw += struct.pack("<B", 1)
    return raw


def write_synthetic_bag(path, n_scans=12, pts_per_scan=900, seed=7) -> SyntheticSequence:
    """Bag with interleaved IMU + ouster scans from a synthetic sequence;
    returns the sequence (its analytic trajectory is the ground truth)."""
    seq = SyntheticSequence(rng=np.random.default_rng(seed), noise_std=0.01, room_scale=0.45)
    msgs = []
    imu_cursor = seq.t_start - 0.2
    for i in range(n_scans):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(imu_cursor, t_end)
        for j in range(len(ts)):
            msgs.append(("/imu", float(ts[j]), serialize_imu(float(ts[j]), gyr[j], acc[j])))
        imu_cursor = t_end
        pts, stamps, rings = seq.scan(i, pts_per_scan)
        msgs.append(("/points", float(stamps.min()), serialize_ouster_scan(pts, stamps, rings)))
    msgs.sort(key=lambda m: m[1])
    rosbag.write_bag(
        path, msgs, {"/points": "sensor_msgs/PointCloud2", "/imu": "sensor_msgs/Imu"}
    )
    return seq


def runner_overrides(bag_path, result_dir, use_imu):
    """Config overrides that run the CLI runner on a write_synthetic_bag
    recording at a small scale."""
    return {
        "bag_dirs": [bag_path],
        "lidar_topic": "/points",
        "imu_topic": "/imu",
        "sensor": "ouster",
        "result_dir": result_dir,
        "use_imu": use_imu,
        "n_clouds": 3,
        "max_num_points_per_scan": 700,
        "min_distance_ds": 3.0,
        "min_dist": 0.05,
        "num_iter_sliding_window_optim": 8,
        "num_iter_keyframe_optim": 5,
        "min_num_points_gauss": 5,
        "min_num_points_gauss_key": 5,
        "closest_k_keyframes_as_static_points": 3,
        "last_n_keyframes_for_optim": 10,
        "dist_new_keyframe": 0.3,
        "n_dense": 251,
        "static_points_cap": 4096,
        "keyframe_points_cap": 2048,
        "raw_scan_cap": 1024,
    }


def read_outputs(result_dir, seq: SyntheticSequence) -> dict:
    """What a run left in result_dir: the Poses.txt rows (all 8 columns?
    stamps ordered?), their ATE against the sequence, and the map size."""
    from dmsa_lidar_slam_tpu.io.pcd import load_pcd

    with open(f"{result_dir}/Poses.txt") as f:
        rows = [ln.split() for ln in f.read().strip().splitlines()]
    stamps = np.array([float(r[0]) for r in rows])
    positions = np.array([[float(v) for v in r[1:4]] for r in rows])
    pts, _ = load_pcd(f"{result_dir}/PointCloud.pcd")
    return {
        "n_poses": len(rows),
        "rows_well_formed": all(len(r) == 8 for r in rows),
        "stamps_ordered": bool(np.all(np.diff(stamps) >= 0)),
        "ate_m": ate_rmse(stamps, positions, seq) if len(rows) else float("nan"),
        "n_map_points": len(pts),
    }
