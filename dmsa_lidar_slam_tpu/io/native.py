"""ctypes loader for the native IO fast path (libdmsa_io.so).

The library is not shipped: it is built from native/src with
`make -C dmsa_lidar_slam_tpu/native` at first use (the build needs a C++17
compiler).  When the build or the load fails, the failure is logged and
the pure-numpy decoders in io.pointcloud2 take over.
"""

import ctypes
import logging
import os
import subprocess
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("dmsa_io_native")

_SENSOR_CODES = {
    "hesai": 0,
    "ouster": 1,
    "robosense": 2,
    "velodyne": 3,
    "livoxXYZRTLT_s": 4,
    "livoxXYZRTLT_ns": 5,
    "sick": 6,
    "unknown": 7,
}

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libdmsa_io.so")


@lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SO_PATH):
        # build under a private name, then rename into place: concurrent
        # first uses (test workers) never load a half-written library
        tmp = f"libdmsa_io.{os.getpid()}.so.tmp"
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s", f"TARGET={tmp}"],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(os.path.join(_NATIVE_DIR, tmp), _SO_PATH)
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native IO build failed (%s); using numpy fallback", e)
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:  # pragma: no cover
        log.warning("native IO load failed (%s); using numpy fallback", e)
        return None
    lib.decode_pointcloud2.restype = ctypes.c_int
    lib.decode_pointcloud2.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.range_mask.restype = ctypes.c_int64
    lib.range_mask.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_char_p,
    ]
    return lib


def available() -> bool:
    return _load() is not None


# (stamp_field_index, ring_field_index or None) per sensor — must mirror
# io.pointcloud2.decode_points / dmsa_slam_ros.cpp:399-486
_FIELD_IDX = {
    "hesai": (4, 5),
    "ouster": (4, 6),
    "robosense": (5, 4),
    "velodyne": (5, 4),
    "livoxXYZRTLT_s": (6, None),
    "livoxXYZRTLT_ns": (6, None),
    "sick": (8, 11),
    "unknown": (None, None),
}


def decode_points(msg, sensor: str, last_msg_stamp: Optional[float] = None):
    """Native-path equivalent of io.pointcloud2.decode_points; returns None
    if the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None or sensor not in _FIELD_IDX:
        return None
    n = msg.height * msg.width
    f = msg.fields
    stamp_i, ring_i = _FIELD_IDX[sensor]
    off_stamp = f[stamp_i].offset if stamp_i is not None else -1
    off_ring = f[ring_i].offset if ring_i is not None else -1
    delta = 0.1 if last_msg_stamp is None else max(msg.stamp - last_msg_stamp, 1e-6)

    xyz = np.empty((n, 3), dtype=np.float32)
    stamps = np.empty(n, dtype=np.float64)
    rings = np.empty(n, dtype=np.int32)
    rc = lib.decode_pointcloud2(
        msg.data,
        n,
        msg.point_step,
        f[0].offset,
        f[1].offset,
        f[2].offset,
        off_stamp,
        off_ring,
        _SENSOR_CODES[sensor],
        msg.stamp,
        delta,
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rings.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        return None
    return xyz, stamps, rings
