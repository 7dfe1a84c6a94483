"""dmsa_lidar_slam_tpu — a LiDAR-inertial SLAM engine on JAX/XLA.

A from-scratch JAX/XLA implementation of Dense Multi Scan Adjustment
(DMSA) LiDAR-inertial odometry and global optimization, with the same
capabilities as the reference C++/ROS implementation
(davidskdds/DMSA_LiDAR_SLAM, ICRA 2024), built for an accelerator:

- state lives in fixed-shape padded arrays (SoA) so jit caches hold,
- voxel binning / Gaussian-cell statistics run as sort + segment_sum on device,
- Gauss-Newton uses autodiff (jacfwd) instead of numeric forward differences,
- the 9-candidate line search is one vmapped evaluation,
- multi-chip scaling shards points / keyframes over a `jax.sharding.Mesh`
  with `psum` reductions of the small (P x P) Gauss-Newton system.

Subpackages
-----------
core        rotations, pose chains, barycentric-rational + slerp interpolation
ops         voxel hashing, downsampling, Gaussian cell statistics, kNN
imu         IMU buffer and on-manifold preintegration (Forster RSS'15)
trajectory  continuous-time sliding-window trajectory (dense pose table)
dmsa        the generic DMSA Gauss-Newton optimizer + problem adapters
map         keyframe ring-buffer map, normals, static-point selection
pipeline    the SLAM orchestrator, output ledger, metrics, checkpointing
io          sensor decoding (rosbag1 / PCD), C++ fast path via ctypes
parallel    device meshes, sharded Gauss-Newton, distributed keyframe adjust
"""

import os

# Pose / IMU math follows the reference's use of double precision
# (reference: include/DMSA/Poses.h, ImuPreintegration.h use Eigen doubles).
# Points stay float32.  x64 must be enabled before any jax import downstream.
if os.environ.get("DMSA_DISABLE_X64", "0") != "1":
    import jax

    jax.config.update("jax_enable_x64", True)

# On the GPU an f32 matmul may run in TF32 (about three decimal digits)
# unless the precision says otherwise; pose math (axis-angle chains,
# preintegration, barycentric weights) and the squared distances compared
# against centimetre radii need true f32.  "highest" keeps every f32
# contraction in full f32; the hot matmuls here are 3x3-batched, so the
# full-precision passes cost little.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the pipeline compiles several large graphs,
# and a later process (benchmark, restart) with the cache skips the
# multi-minute cold start.  JAX_COMPILATION_CACHE_DIR, when set, is the
# cache (JAX reads it itself); otherwise the cache sits at one fixed path
# in the checkout, so every process of this checkout finds it again.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
    )
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from dmsa_lidar_slam_tpu.config import Config, load_config  # noqa: E402,F401


def __getattr__(name):
    """Lazy top-level API (avoids importing jax-heavy modules eagerly)."""
    if name == "DmsaSlam":
        from dmsa_lidar_slam_tpu.pipeline.slam import DmsaSlam

        return DmsaSlam
    if name == "FusedDmsaSlam":
        from dmsa_lidar_slam_tpu.pipeline.fused import FusedDmsaSlam

        return FusedDmsaSlam
    raise AttributeError(name)


__version__ = "0.1.0"
