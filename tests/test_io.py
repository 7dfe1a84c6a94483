"""IO tests: PointCloud2 decode (numpy + native), rosbag round-trip, PCD."""

import struct

import numpy as np
import pytest

from dmsa_lidar_slam_tpu.io import native as io_native
from dmsa_lidar_slam_tpu.io import pointcloud2 as pc2
from dmsa_lidar_slam_tpu.io import rosbag
from dmsa_lidar_slam_tpu.io.pcd import load_pcd, save_pcd
from dmsa_lidar_slam_tpu.io.synthetic_bag import serialize_header, serialize_imu


def make_ouster_cloud(rng, n=64, stamp=1234.5):
    """sensor_msgs/PointCloud2 with the ouster field layout:
    x,y,z,intensity,t(uint32 ns),reflectivity,ring(uint8)..."""
    fields = [
        ("x", 0, 7, 1),
        ("y", 4, 7, 1),
        ("z", 8, 7, 1),
        ("intensity", 12, 7, 1),
        ("t", 16, 6, 1),
        ("reflectivity", 20, 4, 1),
        ("ring", 22, 2, 1),
    ]
    point_step = 24
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    t_ns = (rng.uniform(0, 0.1, size=n) * 1e9).astype(np.uint32)
    rings = rng.integers(0, 64, size=n).astype(np.uint8)
    buf = bytearray(n * point_step)
    for i in range(n):
        struct.pack_into("<fff", buf, i * point_step, *pts[i])
        struct.pack_into("<I", buf, i * point_step + 16, t_ns[i])
        struct.pack_into("<B", buf, i * point_step + 22, rings[i])

    raw = serialize_header(stamp)
    raw += struct.pack("<II", 1, n)  # height, width
    raw += struct.pack("<I", len(fields))
    for name, off, dt, cnt in fields:
        nb = name.encode()
        raw += struct.pack("<I", len(nb)) + nb + struct.pack("<IBI", off, dt, cnt)
    raw += struct.pack("<B", 0)  # is_bigendian
    raw += struct.pack("<II", point_step, n * point_step)
    raw += struct.pack("<I", len(buf)) + bytes(buf)
    raw += struct.pack("<B", 1)  # is_dense
    return raw, pts, t_ns, rings


def test_parse_pointcloud2_ouster(rng):
    raw, pts, t_ns, rings = make_ouster_cloud(rng)
    msg = pc2.parse_pointcloud2(raw)
    assert msg.width == 64 and msg.height == 1
    assert abs(msg.stamp - 1234.5) < 1e-6
    p, s, r = pc2.decode_points(msg, "ouster")
    np.testing.assert_allclose(p, pts, atol=0)
    np.testing.assert_allclose(s, msg.stamp + 1e-9 * t_ns.astype(np.float64), atol=1e-9)
    np.testing.assert_array_equal(r, rings.astype(np.int32))


def test_native_decode_matches_numpy(rng):
    if not io_native.available():
        pytest.skip("native IO unavailable")
    raw, pts, t_ns, rings = make_ouster_cloud(rng, n=128)
    msg = pc2.parse_pointcloud2(raw)
    p1, s1, r1 = pc2.decode_points(msg, "ouster")
    out = io_native.decode_points(msg, "ouster")
    assert out is not None
    p2, s2, r2 = out
    np.testing.assert_allclose(p1, p2, atol=0)
    np.testing.assert_allclose(s1, s2, atol=0)
    np.testing.assert_array_equal(r1, r2)


def test_parse_imu(rng):
    ang = rng.normal(size=3)
    acc = rng.normal(size=3)
    raw = serialize_imu(77.25, ang, acc)
    msg = pc2.parse_imu(raw)
    assert abs(msg.stamp - 77.25) < 1e-6
    np.testing.assert_allclose(msg.angular_velocity, ang, atol=0)
    np.testing.assert_allclose(msg.linear_acceleration, acc, atol=0)


def test_rosbag_roundtrip(rng, tmp_path):
    raw_pc, _, _, _ = make_ouster_cloud(rng)
    raw_imu = serialize_imu(1.5, [0.1, 0.2, 0.3], [0, 0, 9.8])
    path = str(tmp_path / "test.bag")
    msgs = [
        ("/imu", 1.5, raw_imu),
        ("/points", 2.0, raw_pc),
        ("/imu", 2.5, raw_imu),
    ]
    rosbag.write_bag(
        path, msgs, {"/points": "sensor_msgs/PointCloud2", "/imu": "sensor_msgs/Imu"}
    )
    got = list(rosbag.read_messages(path))
    assert [(m.topic, m.stamp) for m in got] == [(t, s) for t, s, _ in msgs]
    assert got[1].msg_type == "sensor_msgs/PointCloud2"
    # filtering
    only_imu = list(rosbag.read_messages(path, topics=["/imu"]))
    assert len(only_imu) == 2
    # decode the cloud from the bag
    msg = pc2.parse_pointcloud2(got[1].raw)
    p, s, r = pc2.decode_points(msg, "ouster")
    assert p.shape == (64, 3)


def test_pcd_roundtrip(rng, tmp_path):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    nrm = rng.normal(size=(100, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.pcd")
    save_pcd(path, pts, nrm, binary=True)
    got, fields = load_pcd(path)
    np.testing.assert_allclose(got, pts, atol=0)
    np.testing.assert_allclose(fields["normal_z"], nrm[:, 2], atol=0)

    save_pcd(path, pts, binary=False)
    got2, _ = load_pcd(path)
    np.testing.assert_allclose(got2, pts, atol=1e-5)
