"""One run of one cell: set-up, the measured window, the metrics, the check.

``run_cell`` is what ``perfbench/run.py`` calls.  The window calls the
cell's sampler loop in chunks, with a ``cuda.synchronize`` after each, until
``seconds`` have passed; every rate is the window's whole work over its whole
time.  A traced run (``trace=True``) profiles a short steady stretch of the
window with ``torch.profiler`` and reads its per-layer metrics from that
trace after the window has closed."""

from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import torch

from ..yardstick import seeds
from ..yardstick import trace as trace_reader
from . import spec


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host spans the harness opens around its calls into the program:
    ``torch.profiler.record_function`` in a traced run, nothing otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __call__(self, name: str):
        if self.enabled:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def capture_plan(seed: int, traffic: dict) -> frozenset:
    """Iterations of the window whose inputs and outputs the loop keeps for
    the check: ``capture_draws`` of the first ``capture_span``, drawn from
    the seed.  The loop also keeps the first iteration of the window's last
    chunk."""
    gen = torch.Generator()
    gen.manual_seed(seeds.derive(seed, seeds.CAPTURE))
    span = int(traffic["capture_span"])
    picks = torch.randperm(span, generator=gen)[:int(traffic["capture_draws"])]
    return frozenset(int(i) for i in picks)


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _profiler(device: torch.device, host: bool):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host else []
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _read_trace(prof, span_names, stretch: bool) -> trace_reader.TraceSummary:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_reader.summarize(path, span_names, stretch=stretch)
    finally:
        os.unlink(path)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", control: bool = False,
             overrides: Optional[Dict[str, dict]] = None,
             t_start: Optional[float] = None, bench: Optional[dict] = None) -> dict:
    """Run the cell once and return its result: the contract's line
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``breakdown`` when traced, ``checks`` last).

    ``device`` other than cuda, ``overrides`` ({"config": {...}, "traffic":
    {...}} merged over the files) and ``control`` are for the harness's own
    tests and the control runs; the benchmark's command passes none of them.
    ``control`` runs the program's own lower-precision path: TF32 matmuls
    and, where the loop has one, its plain value+grad in place of the kernel.
    ``t_start``: the host clock at process start (set-up is counted from
    it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench if bench is not None else spec.benchmark()
    entry = spec.cell(cell_name, bench)
    overrides = overrides or {}
    cfg = dict(spec.config(entry["config"], bench), **overrides.get("config", {}))
    tr = dict(spec.traffic(entry["traffic"]), **overrides.get("traffic", {}))
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mix = spec.load_module("mixes", tr["loop"])
    reference = spec.load_module("reference", entry["config"])
    ctx = SimpleNamespace(seed=int(seed), device=dev, config=cfg,
                          traffic=tr, spans=Spans(trace), control=control,
                          capture_at=capture_plan(seed, tr))

    session = mix.prepare(ctx)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s: {session.timings}")

    # a traced run profiles two stretches of the window: ``trace_chunks``
    # chunks from chunk ``first`` with the host's events and the device's
    # (the spans, the launches, the idle gaps' host events), then one chunk
    # with the device's activity alone (the busy seconds and the device's
    # operations, without the host-side recording, whose cost slows a
    # host-paced loop).  Each trace is read as soon as it stops: a later
    # profiling session drops an earlier one's device events.
    first = int(tr.get("trace_skip_chunks", 2))
    last = first + int(tr.get("trace_chunks", 2))
    device_only = trace and dev.type == "cuda"
    prof_dev, prof, stretch, busy, summary, chunks = None, None, None, None, None, []
    t0 = time.perf_counter()
    i = 0
    while True:
        if trace and i == first:
            prof = _profiler(dev, host=True)
            prof.start()
            stretch = torch.profiler.record_function(trace_reader.STRETCH)
            stretch.__enter__()
        if device_only and i == last:
            prof_dev = _profiler(dev, host=False)
            prof_dev.start()
        w0 = session.work_flop()
        c0 = time.perf_counter()
        n = session.chunk()
        sync(dev)
        c1 = time.perf_counter()
        chunks.append((c1 - c0, n, session.work_flop() - w0))
        i += 1
        if trace and i == last:
            stretch.__exit__(None, None, None)
            sync(dev)
            prof.stop()
            summary = _read_trace(prof, session.span_names, stretch=True)
        if prof_dev is not None and i == last + 1:
            prof_dev.stop()
            try:
                busy = _read_trace(prof_dev, (), stretch=False)
            except ValueError as err:
                busy = None
                log(f"trace: the device-only stretch gave nothing ({err}); the busy share "
                    f"comes from the stretch with host events")
        if c1 - t0 >= seconds and (not trace or i > last):
            break
    window_s = c1 - t0
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    out = session.close()
    if summary is not None:
        if summary.unattributed:
            log(f"trace: {summary.unattributed} kernels without a launch in the trace")
        if busy is not None:
            summary = summary._replace(window_s=busy.window_s, busy_s=busy.busy_s,
                                       device_ops=busy.device_ops)
    readings = session.check(reference)
    info = readings.pop("info", {})
    session = None
    gc.collect()                    # the session's callables refer to each other
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the chunks before the first profiled one: after a profiling session the
    # profiler's callbacks go on costing each launch, which slows a
    # host-paced loop for the rest of the window
    untraced = chunks[:first] if trace else chunks
    run = SimpleNamespace(
        cell=cell_name, config=cfg, traffic=tr, setup_s=setup_s, window_s=window_s,
        iterations=sum(c[1] for c in chunks), chains=out["chains"],
        draws=out["draws_per_chain"], ess=out.get("ess"), timings=out["timings"],
        counters=out.get("counters", {}), vag_bound_s=out.get("vag_bound_s"),
        untraced_s=sum(c[0] for c in untraced), untraced_flop=sum(c[2] for c in untraced),
        untraced_iterations=sum(c[1] for c in untraced),
        busy_iterations=chunks[last][1] if busy is not None else 0, trace=summary)
    field = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(cell_name, field, bench):
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    limits = spec.limits(cell_name)
    captured = readings.pop("captured", 0)
    checks, correct = {}, out["failed"] == 0 and captured > 0
    for name, value in readings.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        correct = correct and limit is not None and value <= limit

    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    dev_info = {"platform": platform, "kind": kind, "count": int(entry["chips"]),
                "memory_peak_bytes": int(memory_peak)}
    if dev.type == "cuda":
        dev_info["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": int(run.iterations),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["readings"] = info                   # printed beside the checks, not compared
    result["checks"] = checks
    log(f"window {window_s:.3f} s, {run.iterations} chain-iterations in {len(chunks)} chunks; "
        f"failed {out['failed']}; memory peak {memory_peak}; {captured} iterations checked")
    for name, value in info.items():
        log(f"reading {name} {value!r} (not compared)")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result
