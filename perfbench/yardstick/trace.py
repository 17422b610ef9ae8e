"""Reading a ``torch.profiler`` Chrome trace of one stretch of the window.

The stretch is the host span ``STRETCH`` that the harness opens around the
chunks it profiles (or, in a trace of the device's activity alone, all the
trace holds).  From the device's kernel, copy and set events inside it:
the busy seconds (the union of their intervals, so overlapping streams are
not counted twice), the kernels launched, the device seconds of the kernels
launched from inside a named host span (matched by the launch's correlation
id, not by a kernel's name), the device operations that took most time, and
the idle gaps labelled by the innermost host event that covers each gap's
middle."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Tuple

STRETCH = "perfbench.trace_stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class TraceSummary(NamedTuple):
    window_s: float                  # length of the profiled stretch
    busy_s: float                    # union of device intervals inside it
    kernels: int                     # kernels that started inside it
    span_device_s: Dict[str, float]  # device seconds of kernels launched under each span
    span_calls: Dict[str, int]       # host spans of each name inside the stretch
    unattributed: int                # kernels whose launch the trace does not show
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(path: str, spans: Iterable[str] = (), top: int = 10,
              stretch: bool = True) -> TraceSummary:
    """``stretch=False``: a trace of the device's activity alone (no host
    spans); the stretch is then from its first launch to its last device or
    launch event's end."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if stretch:
        stretches = [e for e in events if e.get("name") == STRETCH]
    else:
        stretches = [e for e in events if e.get("cat") in DEVICE_CATS + LAUNCH_CATS]
    if not stretches:
        raise ValueError(f"the trace holds no {STRETCH if stretch else 'device'} events")
    s0 = min(float(e["ts"]) for e in stretches)
    s1 = max(float(e["ts"]) + float(e["dur"]) for e in stretches)

    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b > s0 and a < s1:
                device.append((max(a, s0), min(b, s1), e))
    busy = _union([(a, b) for a, b, _ in device])
    busy_us = sum(b - a for a, b in busy)

    kernels = [e for a, b, e in device if e["cat"] == "kernel" and float(e["ts"]) >= s0]
    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])

    span_device_s, span_calls, unattributed = {}, {}, 0
    spans = tuple(spans)
    windows = {name: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                            for e in events if e.get("name") == name
                            and e.get("cat") == "user_annotation"
                            and s0 <= float(e["ts"]) < s1) for name in spans}
    for name in spans:
        span_calls[name] = len(windows[name])
        span_device_s[name] = 0.0
    for e in kernels:
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            unattributed += 1
            continue
        for name in spans:
            w = windows[name]
            i = bisect.bisect_right(w, (t, float("inf"))) - 1
            if i >= 0 and w[i][0] <= t <= w[i][1]:
                span_device_s[name] += float(e["dur"]) * 1e-6
                break

    by_op = defaultdict(float)
    for a, b, e in device:
        by_op[e.get("name", "?")] += (b - a) * 1e-6
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
                  for e in events if e.get("cat") in HOST_CATS and e.get("name") != STRETCH)
    starts = [h[0] for h in host]
    gaps = []
    edge = s0
    for a, b in busy + [(s1, s1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    by_host = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "(no host event)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 500, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        by_host[label] += (b - a) * 1e-6
    idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]

    return TraceSummary(window_s=(s1 - s0) * 1e-6, busy_s=busy_us * 1e-6,
                        kernels=len(kernels), span_device_s=span_device_s,
                        span_calls=span_calls, unattributed=unattributed,
                        device_ops=[[k, v] for k, v in device_ops],
                        idle_gaps=[[k, v] for k, v in idle_gaps])
