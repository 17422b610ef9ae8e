"""The program's own spans (``utils/profiling.py``) on a cell's sampler loop:
their host seconds with no profiler attached, the device seconds of the
kernels launched under each from a profiled stretch, what the spans cost,
and five readings made from them.

    python3 perfbench/tools/spans.py --workload <cell> --seed <n> [--pairs 8] \\
        [--out readings.jsonl]

The loop is set up as the benchmark's window sets it up (``mixes/<loop>.py``).
Then ``--pairs`` pairs of chunks run with the spans off and on, in the order
off on on off, a synchronize after each, with no profiler and the harness's
own spans off: the spans' cost is the rate of the chunks with spans on
against the rate with them off, and the spans' host seconds are those of
the chunks with spans on.  Then the traffic's ``trace_chunks`` chunks run
under ``torch.profiler`` with the host's events and the device's, both the
harness's spans and the program's on; a kernel counts for every span whose
interval holds its launch, and an idle gap for every span that holds its
middle.  Last, the check of the benchmark decides ``correct``.

The readings, each None where there is nothing to read (no such span, or no
device events, as on the CPU):

- ``nuts.host_ms_per_leaf``: ms of ``nuts.leaf`` a call (host, spans on);
- ``nuts.flag_wait_share``: % of the chunks' wall time in ``nuts.flag_wait``,
  the host blocked on the card;
- ``vag.kernel_roofline``: calls of ``vag.kernel`` times the fused kernel's
  bound (``kernel_bound_s``) over the device seconds under ``vag.kernel``, %;
- ``vag.whiten_share``: device seconds under ``vag.unwhiten`` and
  ``vag.unwhiten_t`` over those under all three ``vag.*`` spans, %;
- ``sghmc.overhead_ms_per_step``: device ms under ``sghmc.batch``,
  ``sghmc.draw`` and ``sghmc.update`` per ``sghmc.batch`` call.

Prints one JSON line a run."""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Iterable, Optional

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench.harness import cell, spec  # noqa: E402
from perfbench.yardstick import peaks  # noqa: E402
from perfbench.yardstick import trace as trace_reader  # noqa: E402

NUTS = ("nuts.begin", "nuts.flag_wait", "nuts.leaf", "nuts.merge")
VAG = ("vag.unwhiten", "vag.kernel", "vag.unwhiten_t")
SGHMC = ("sghmc.batch", "sghmc.draw", "sghmc.grad", "sghmc.update", "sghmc.value")
HARNESS = ("perfbench.vag", "perfbench.grad", "perfbench.gibbs", "perfbench.sghmc_step")
PROGRAM = NUTS + VAG + SGHMC


def kernel_bound_s(n: int, dim: int, n_classes: int, chains: int) -> float:
    """The least time one call of the fused softmax-GLM kernel can take: its
    two GEMMs of 2 N (D+1) C K flop at the dense bf16 peak against its bytes
    (X in bf16, Y, W, b and the gradients in float32, a value a chain) at the
    HBM bandwidth (chip_smoke.py phase 3's bound; the whitening maps around
    the kernel are not in it)."""
    flop = 2 * 2 * n * (dim + 1) * n_classes * chains
    moved = (2 * n * dim + 4 * (n * n_classes + 2 * dim * n_classes * chains
                                + 2 * n_classes * chains + chains))
    return max(flop / peaks.PEAK_BF16_FLOPS, moved / peaks.PEAK_BYTES_PER_S)


def read_spans(path: str, names: Iterable[str]) -> dict:
    """Over the stretch of a Chrome trace (the ``STRETCH`` span): each named
    span's calls, the device seconds of the kernels launched inside it, and
    the idle seconds whose gap's middle lies inside it; a kernel or a gap
    counts for every span that holds it, nested ones too.  Also the seconds
    of every kernel that started in the stretch and of every idle gap."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    stretch = [e for e in events if e.get("name") == trace_reader.STRETCH]
    if not stretch:
        raise ValueError(f"the trace holds no {trace_reader.STRETCH} span")
    s0 = min(float(e["ts"]) for e in stretch)
    s1 = max(float(e["ts"]) + float(e["dur"]) for e in stretch)
    names = tuple(names)
    windows = {n: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                         if e.get("name") == n and e.get("cat") == "user_annotation"
                         and s0 <= float(e["ts"]) < s1) for n in names}

    def holds(name, t):
        w = windows[name]
        i = bisect.bisect_right(w, (t, float("inf"))) - 1
        return i >= 0 and w[i][0] <= t <= w[i][1]

    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in trace_reader.LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    out = {n: {"calls": len(windows[n]), "device_s": 0.0, "idle_s": 0.0} for n in names}
    intervals, kernel_s = [], 0.0
    for e in events:
        if e.get("cat") not in trace_reader.DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if b > s0 and a < s1:
            intervals.append((max(a, s0), min(b, s1)))
        if e["cat"] != "kernel" or not s0 <= a < s1:
            continue
        kernel_s += float(e["dur"]) * 1e-6
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        for n in names:
            if t is not None and holds(n, t):
                out[n]["device_s"] += float(e["dur"]) * 1e-6
    idle_s, edge = 0.0, s0
    for a, b in trace_reader._union(intervals) + [(s1, s1)]:
        if a > edge:
            idle_s += (a - edge) * 1e-6
            for n in names:
                if holds(n, 0.5 * (a + edge)):
                    out[n]["idle_s"] += (a - edge) * 1e-6
        edge = max(edge, b)
    return {"spans": out, "kernel_s": kernel_s, "idle_s": idle_s,
            "window_s": (s1 - s0) * 1e-6}


def readings(host: Dict[str, tuple], wall_s: float, stretch: dict,
             bound_s: Optional[float]) -> dict:
    """The five readings (see the module docstring) from the host table of
    the chunks with spans on, their wall seconds and ``read_spans``'s
    result."""
    spans = stretch["spans"]

    def dev(*names):
        return sum(spans[n]["device_s"] for n in names if n in spans)

    def calls(name):
        return spans[name]["calls"] if name in spans else 0

    out = dict.fromkeys(("nuts.host_ms_per_leaf", "nuts.flag_wait_share",
                         "vag.kernel_roofline", "vag.whiten_share",
                         "sghmc.overhead_ms_per_step"))
    leaf = host.get("nuts.leaf")
    if leaf and leaf[0]:
        out["nuts.host_ms_per_leaf"] = 1e3 * leaf[1] / leaf[0]
    wait = host.get("nuts.flag_wait")
    if wait and wait[0] and wall_s > 0.0:
        out["nuts.flag_wait_share"] = 100.0 * wait[1] / wall_s
    if bound_s is not None and calls("vag.kernel") and dev("vag.kernel") > 0.0:
        out["vag.kernel_roofline"] = 100.0 * calls("vag.kernel") * bound_s / dev("vag.kernel")
    if dev(*VAG) > 0.0:
        out["vag.whiten_share"] = 100.0 * dev("vag.unwhiten", "vag.unwhiten_t") / dev(*VAG)
    if calls("sghmc.batch") and dev(*SGHMC) > 0.0:
        out["sghmc.overhead_ms_per_step"] = (
            1e3 * dev("sghmc.batch", "sghmc.draw", "sghmc.update") / calls("sghmc.batch"))
    return out


def _delta(before: dict, after: dict) -> Dict[str, tuple]:
    out = {}
    for name, (calls, seconds) in after.items():
        c0, s0 = before.get(name, (0, 0.0))
        if calls != c0:
            out[name] = (calls - c0, seconds - s0)
    return out


def measure(cell_name: str, seed: int, *, pairs: int = 8, device: str = "cuda",
            overrides: Optional[dict] = None, bench: Optional[dict] = None) -> dict:
    """One run of the procedure in the module docstring; returns its line."""
    from dropout_hamiltonian_montecarlo_tpu_torch.utils import profiling

    bench = bench if bench is not None else spec.benchmark()
    entry = spec.cell(cell_name, bench)
    overrides = overrides or {}
    cfg = dict(spec.config(entry["config"], bench), **overrides.get("config", {}))
    tr = dict(spec.traffic(entry["traffic"]), **overrides.get("traffic", {}))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    mix = spec.load_module("mixes", tr["loop"])
    reference = spec.load_module("reference", entry["config"])
    ctx = SimpleNamespace(seed=int(seed), device=dev, config=cfg, traffic=tr,
                          spans=cell.Spans(False), control=False,
                          capture_at=cell.capture_plan(seed, tr))
    was = profiling.enable(False)
    try:
        session = mix.prepare(ctx)
        kernel = getattr(session, "kernel", None)
        cell.sync(dev)

        def chunk(on: bool):
            profiling.enable(on)
            t0, leaves0 = profiling.totals(), getattr(kernel, "leaves_executed", 0)
            c0 = time.perf_counter()
            n = session.chunk()
            cell.sync(dev)
            c1 = time.perf_counter()
            return (c1 - c0, n, _delta(t0, profiling.totals()),
                    getattr(kernel, "leaves_executed", 0) - leaves0)

        timed = {False: [], True: []}
        for i in range(pairs):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                timed[on].append(chunk(on))

        profiling.enable(True)
        ctx.spans.enabled = True
        prof = cell._profiler(dev, host=True)
        prof.start()
        with torch.profiler.record_function(trace_reader.STRETCH):
            for _ in range(int(tr.get("trace_chunks", 2))):
                session.chunk()
            cell.sync(dev)
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-spans-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            stretch = read_spans(path, PROGRAM + HARNESS)
            summary = trace_reader.summarize(path, (), stretch=True)
        finally:
            os.unlink(path)
        profiling.enable(False)
        ctx.spans.enabled = False

        out = session.close()
        checks = session.check(reference)
    finally:
        profiling.enable(was)
    limits = spec.limits(cell_name)
    checks.pop("info", None)
    captured = checks.pop("captured", 0)
    correct = out["failed"] == 0 and captured > 0 and all(
        limits.get(k) is not None and v <= limits[k] for k, v in checks.items())

    host: Dict[str, list] = {}
    for _, _, table, _ in timed[True]:
        for name, (calls, seconds) in table.items():
            h = host.setdefault(name, [0, 0.0])
            h[0] += calls
            h[1] += seconds
    wall_on = sum(c[0] for c in timed[True])
    rate = {on: sum(c[1] for c in timed[on]) / sum(c[0] for c in timed[on]) for on in timed}
    bound_s = None
    if tr["loop"] in ("hmc", "nuts"):
        bound_s = kernel_bound_s(int(cfg["n_train"]), int(cfg["dim"]),
                                 int(cfg["n_classes"]), int(tr["chains"]))
    spans = stretch["spans"]
    idle = sum(v for _, v in summary.idle_gaps)
    no_host = sum(v for k, v in summary.idle_gaps if k == "(no host event)")
    harness_vag = spans["perfbench.vag"]["device_s"] + spans["perfbench.grad"]["device_s"]
    program_vag = sum(spans[n]["device_s"] for n in VAG)
    line = {
        "workload": cell_name, "seed": int(seed), "correct": bool(correct),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "power_limit": cell.power_limit() if dev.type == "cuda" else None,
        "iters_per_s_spans_off": rate[False], "iters_per_s_spans_on": rate[True],
        "spans_cost_pct": 100.0 * (rate[False] / rate[True] - 1.0),
        "chunks_per_side": pairs,
        "host": {k: {"calls": c, "seconds": s} for k, (c, s) in sorted(host.items())},
        "leaves_rise": sum(c[3] for c in timed[True]),
        "readings": readings({k: tuple(v) for k, v in host.items()}, wall_on, stretch,
                             bound_s),
        "kernel_bound_ms": None if bound_s is None else bound_s * 1e3,
        "stretch": {"window_s": stretch["window_s"], "kernel_s": stretch["kernel_s"],
                    "idle_s": stretch["idle_s"],
                    "spans": {k: v for k, v in spans.items() if v["calls"]}},
        "vag_spans_over_harness_spans": (program_vag / harness_vag if harness_vag > 0.0
                                         else None),
        "sghmc_spans_kernel_share": (
            sum(spans[n]["device_s"] for n in SGHMC) / stretch["kernel_s"]
            if tr["loop"] == "sghmc" and stretch["kernel_s"] > 0.0 else None),
        "no_host_event_share_of_listed_idle": no_host / idle if idle > 0.0 else None,
        "idle_gaps": summary.idle_gaps,
    }
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, action="append", required=True,
                        help="a run seed; repeat for more runs in this process")
    parser.add_argument("--pairs", type=int, default=8)
    parser.add_argument("--out", default=None, help="also append the lines to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seed:
        line = json.dumps(measure(args.workload, seed, pairs=args.pairs))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
