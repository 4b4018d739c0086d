"""The traced stretch: a ``torch.profiler`` trace of a few calls of the
window, and its reduction to what the per-layer readers read.

The reduction follows the program's chip_smoke.py (``_busy_ms``,
``_stage_split``) and is kept here so that a change to the program cannot
move it: device events are kernels, copies and memsets, and the device is
busy in the union of their intervals; the host time of an ``ft8.<stage>``
range (the program's ``record_function`` spans) excludes the ranges nested
in it; launches are the runtime's and driver's launch records.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from typing import NamedTuple

import torch

__all__ = ["CALL_RANGE", "Trace", "record", "reduce_events", "kernel_name"]

# the benchmark's range around each traced call
CALL_RANGE = "port_bench.call"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cuda_runtime", "cuda_driver")


class Trace(NamedTuple):
    """A traced stretch of ``calls`` calls, reduced."""

    calls: int
    window_s: float                 # the host span of the traced calls
    busy_s: float                   # union of device intervals
    launches: int                   # kernel launch records
    stage_host_s: dict              # ft8 stage -> own host seconds
    outside_host_s: float           # host time of the calls outside ft8.*
    kernel_s: dict                  # kernel name (120 chars) -> device s
    kernel_launches: dict           # kernel name -> device records
    idle_by_range: dict             # host range -> device idle seconds


def kernel_name(raw: str) -> str:
    """A hand kernel's name from its mangled entry (waterfall_kernel<true>,
    sync_kernel<false,4,4>, osd_eliminate_kernel); others as they are."""
    m = re.search(r"(waterfall_pack_kernel|osd_eliminate_kernel|"
                  r"waterfall_kernel|sync_kernel)(?:ILb([01])E((?:Li\d+E)*))?",
                  raw)
    if not m:
        return raw
    name, flag, ints = m.groups()
    if flag is None:
        return name
    args = ["true" if flag == "1" else "false"] + re.findall(r"Li(\d+)E", ints)
    return f"{name}<{','.join(args)}>"


def record(call, indices) -> list[dict]:
    """Run ``call(i)`` for each i under the profiler, each in a CALL_RANGE
    range, up to a synchronize; returns the chrome-trace events.  The trace
    file lives in a temporary directory under TMPDIR and is removed."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in indices:
            with torch.profiler.record_function(CALL_RANGE):
                call(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


def _own_time(spans: list[tuple[float, float, str]]) -> dict[str, float]:
    """Each span's duration less the spans nested in it (outermost nested
    ones only), summed by name; microseconds."""
    own: dict[str, float] = defaultdict(float)
    for lo, hi, name in spans:
        inner = [(a, b) for a, b, _ in spans
                 if lo <= a and b <= hi and (a, b) != (lo, hi)]
        nested = sum(b - a for a, b in inner
                     if not any(c <= a and b <= d and (c, d) != (a, b)
                                for c, d in inner))
        own[name] += hi - lo - nested
    return own


def reduce_events(events: list[dict]) -> Trace:
    """The chrome-trace events of :func:`record` -> :class:`Trace`."""
    x = [e for e in events if e.get("ph") == "X"]
    calls = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in x if e.get("cat") == "user_annotation"
             and e.get("name") == CALL_RANGE]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
               e["name"][4:]) for e in x
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("ft8.")]
    device = [e for e in x if e.get("cat") in _DEVICE_CATS]
    launches = sum(1 for e in x if e.get("cat") in _HOST_CATS
                   and "Launch" in e.get("name", ""))
    kernel_s: dict[str, float] = defaultdict(float)
    kernel_n: dict[str, int] = defaultdict(int)
    for e in device:
        if e["cat"] == "kernel":
            name = kernel_name(e.get("name", ""))[:120]
            kernel_s[name] += float(e.get("dur", 0.0)) / 1e6
            kernel_n[name] += 1
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                  for e in device)
    own = _own_time(ranges)
    top = _union((lo, hi) for lo, hi, _ in ranges)
    call_s = sum(hi - lo for lo, hi in calls)
    in_ranges = sum(min(hi, c1) - max(lo, c0) for lo, hi in top
                    for c0, c1 in calls if lo < c1 and hi > c0)

    # device idle between busy intervals inside the traced calls, named by
    # the innermost ft8 range the host was in when the gap opened
    idle: dict[str, float] = defaultdict(float)
    span = (min(c[0] for c in calls), max(c[1] for c in calls)) if calls \
        else (0.0, 0.0)
    edges = [span[0]] + [t for iv in busy for t in iv] + [span[1]]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        lo, hi = max(lo, span[0]), min(hi, span[1])
        if hi <= lo:
            continue
        inside = [r for r in ranges if r[0] <= lo <= r[1]]
        idle["ft8." + max(inside)[2] if inside else "outside ft8 ranges"] += \
            (hi - lo) / 1e6
    return Trace(
        calls=len(calls), window_s=(span[1] - span[0]) / 1e6,
        busy_s=sum(hi - lo for lo, hi in busy) / 1e6, launches=launches,
        stage_host_s={k: v / 1e6 for k, v in own.items()},
        outside_host_s=(call_s - in_ranges) / 1e6,
        kernel_s=dict(kernel_s), kernel_launches=dict(kernel_n),
        idle_by_range=dict(idle))


def roofline_pct(t: Trace, kernels: tuple[str, ...], bound,
                 counted: str) -> float | None:
    """A hand kernel's share of its roofline over the traced stretch (%):
    the ``counted`` kernel's launches times the least time of one launch
    (``bound``), over the device time of every kernel whose name starts
    with one of ``kernels`` (a launch's pre-pass included).  None where
    the stretch has no such launch."""
    n = sum(v for k, v in t.kernel_launches.items() if k.startswith(counted))
    busy = sum(v for k, v in t.kernel_s.items() if k.startswith(kernels))
    if bound is None or n == 0 or busy <= 0:
        return None
    return 100.0 * n * bound.seconds / busy


def stage_ms(t: Trace, stage: str) -> float | None:
    """An ft8.<stage> range's own host ms per traced call; None where the
    stretch has no such range."""
    if stage not in t.stage_host_s or t.calls == 0:
        return None
    return 1e3 * t.stage_host_s[stage] / t.calls
