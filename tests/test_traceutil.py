"""Device-time reductions over profiler traces (pipeline.traceutil)."""

import os

import jax
import jax.numpy as jnp
import pytest

from dmsa_lidar_slam_tpu.pipeline import traceutil


def test_busy_is_the_union_of_stream_intervals():
    planes = [
        ("/host:CPU", [("python", [(0, 1000, "host")])]),
        (
            "/device:GPU:0",
            [
                ("Stream #7(Compute)", [(0, 100, "a"), (50, 100, "b"), (400, 100, "c")]),
                ("Stream #9(MemcpyH2D)", [(120, 30, "copy")]),
                ("XLA Modules", [(0, 1000, "jit_step")]),  # derived line: not activity
            ],
        ),
        ("/device:GPU:1", [("Stream #7(Compute)", [(10, 5, "a")])]),
    ]
    lines = traceutil.select_device_lines(planes)
    assert sorted(lines) == [0, 1]
    busy = traceutil.busy_ms(lines)
    assert busy[0] == pytest.approx(250 / 1e6)  # [0,150) + [400,500)
    assert busy[1] == pytest.approx(5 / 1e6)
    assert traceutil.span_ms(lines) == pytest.approx(500 / 1e6)
    ms, n = traceutil.op_totals(lines)
    assert n["a"] == 2 and ms["copy"] == pytest.approx(30 / 1e6)


def test_no_device_line_raises(tmp_path):
    """A CPU trace has no GPU plane: the reduction refuses, never reads 0."""
    with traceutil.capture(str(tmp_path)) as d:
        jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(64)))
    with pytest.raises(traceutil.NoDeviceActivity):
        traceutil.device_lines(d)
    with pytest.raises(traceutil.NoDeviceActivity):
        traceutil.select_device_lines([("/device:GPU:0", [("XLA Ops", [(0, 5, "x")])])])


def test_card_trace_fixture():
    """A trace recorded on an H100 (3 x sin + f64 matmul + reduce, one H2D
    copy): the card's plane, its compute and copy stream lines, and the
    busy time as the union of their activity."""
    d = os.path.join(os.path.dirname(__file__), "data")
    lines = traceutil.device_lines(d)
    assert sorted(lines) == [0]
    assert sorted(lines[0]) == ["Stream #13(Compute)", "Stream #14(MemcpyH2D)"]
    assert len(lines[0]["Stream #13(Compute)"]) == 9
    assert traceutil.busy_ms(lines)[0] == pytest.approx(0.060021)
    assert traceutil.device_busy_ms(d) == pytest.approx(0.060021)
    ms, n = traceutil.op_totals(lines)
    assert n["wrapped_sine"] == 3 and n["MemcpyH2D"] == 1
