"""Runner end-to-end: crafted Ouster-layout rosbag -> CLI pipeline -> outputs.

Closes the CLI -> bag decode -> pipeline -> Poses.txt/PointCloud.pcd seam
(the reference's main()/spin path, src/dmsa_slam_ros.cpp:240-307), for both
the host-orchestrated and the fused device-resident pipelines.
"""

import pytest

from dmsa_lidar_slam_tpu.io.synthetic_bag import read_outputs, runner_overrides, write_synthetic_bag
from dmsa_lidar_slam_tpu.pipeline import runner


def check_outputs(tmp_path, seq, slam):
    out = read_outputs(str(tmp_path), seq)
    assert out["n_poses"] >= 3
    assert out["rows_well_formed"]
    assert out["stamps_ordered"], "TUM stamps must be ordered"
    assert out["ate_m"] < 0.15, f"runner trajectory ATE {out['ate_m']}"
    assert out["n_map_points"] > 500


@pytest.mark.slow
def test_runner_host_pipeline_on_bag(tmp_path):
    bag = str(tmp_path / "synthetic.bag")
    seq = write_synthetic_bag(bag)
    slam = runner.run(
        [], overrides=runner_overrides(bag, str(tmp_path), use_imu=False), pipeline="host"
    )
    assert slam.kf_map.count >= 2
    check_outputs(tmp_path, seq, slam)


@pytest.mark.slow
def test_runner_fused_pipeline_on_bag(tmp_path):
    bag = str(tmp_path / "synthetic.bag")
    seq = write_synthetic_bag(bag)
    slam = runner.run(
        [], overrides=runner_overrides(bag, str(tmp_path), use_imu=True), pipeline="fused"
    )
    assert slam.kf_count >= 2
    check_outputs(tmp_path, seq, slam)
