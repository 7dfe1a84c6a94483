"""jax.profiler trace capture and the device-time reductions over it.

One definition of device time, shared by every instrument (bench.py,
chip_smoke.py, tools/profile.py):

  - the trace is the XSpace (`*.xplane.pb`) that jax.profiler writes, read
    with jax.profiler.ProfileData;
  - a GPU shows up as one plane per card, named "/device:GPU:<n>"; the
    activity the card ran (kernels, copies, memsets) sits on its
    "Stream #<id>(...)" lines, one line per CUDA stream;
  - device-busy time is the UNION of those activity intervals per card, so
    concurrent streams are not counted twice and host gaps are not counted
    at all.  The idle share of a window is 1 - busy / window.

A trace without any GPU activity line raises: a device number is never
silently 0.
"""

import collections
import glob
import os
import re
import tempfile
from contextlib import contextmanager
from typing import Dict, Iterable, List, Tuple

_GPU_PLANE = re.compile(r"^/device:GPU:(\d+)$")
_ACTIVITY_LINE = "Stream"

# {card index: {line name: [(start_ns, duration_ns, op name), ...]}}
DeviceLines = Dict[int, Dict[str, List[Tuple[float, float, str]]]]


class NoDeviceActivity(RuntimeError):
    """The trace holds no GPU activity line."""


@contextmanager
def capture(trace_dir: str = None):
    """Capture a jax.profiler trace into `trace_dir` (a fresh private temp
    dir when None).  Yields the directory path."""
    import jax

    d = trace_dir or tempfile.mkdtemp(prefix="dmsa_trace_")
    with jax.profiler.trace(d):
        yield d


def newest_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def select_device_lines(planes: Iterable) -> DeviceLines:
    """GPU activity lines out of (plane name, [(line name, events)]) pairs,
    events being (start_ns, duration_ns, name) triples.  Raises
    NoDeviceActivity when no GPU plane has an activity line."""
    out: DeviceLines = {}
    seen = []
    for pname, lines in planes:
        m = _GPU_PLANE.match(pname)
        if not m:
            continue
        for lname, events in lines:
            seen.append(f"{pname}/{lname}")
            if lname.startswith(_ACTIVITY_LINE) and events:
                out.setdefault(int(m.group(1)), {})[lname] = list(events)
    if not out:
        raise NoDeviceActivity(
            "no GPU activity line in the trace (GPU lines seen: %s)" % (seen or "none")
        )
    return out


def device_lines(trace_dir: str) -> DeviceLines:
    """GPU activity lines of the newest trace under trace_dir."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(newest_xplane(trace_dir))
    planes = (
        (
            p.name,
            [
                (ln.name, [(e.start_ns, e.duration_ns, e.name) for e in ln.events])
                for ln in p.lines
            ],
        )
        for p in pd.planes
    )
    return select_device_lines(planes)


def _union_ns(intervals: List[Tuple[float, float]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_ms(lines: DeviceLines) -> Dict[int, float]:
    """Per card: union of its activity intervals, in ms."""
    return {
        dev: _union_ns([(s, s + d) for evs in by_line.values() for s, d, _ in evs]) / 1e6
        for dev, by_line in lines.items()
    }


def span_ms(lines: DeviceLines) -> float:
    """First activity start to last activity end over all cards, in ms."""
    evs = [(s, s + d) for by_line in lines.values() for evs in by_line.values() for s, d, _ in evs]
    return (max(e for _, e in evs) - min(s for s, _ in evs)) / 1e6


def device_busy_ms(trace_dir: str) -> float:
    """Device-busy ms of the newest trace, summed over cards."""
    return sum(busy_ms(device_lines(trace_dir)).values())


def op_totals(lines: DeviceLines) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(per-op total ms, per-op count) over every card's activity."""
    ms: Dict[str, float] = collections.Counter()
    n: Dict[str, int] = collections.Counter()
    for by_line in lines.values():
        for evs in by_line.values():
            for _, d, name in evs:
                ms[name] += d / 1e6
                n[name] += 1
    return ms, n
