"""The program's named spans, a profiler span, throughput counters and a
CUDA-event kernel timer.

Spans.  The samplers mark their host phases with ``span(name)``.  Off (the
default) a span is one shared no-op: it reads no clock and opens no
``record_function``.  ``enable(True)`` turns them on: each span then adds its
host seconds (``time.perf_counter``) and one call to an in-memory table that
``totals()`` copies out, and, while a ``torch.profiler`` session records,
also opens ``torch.profiler.record_function(name)``, so that the span lands
in the session's Chrome trace on the profiler's clock beside the kernels
launched inside it.  The names, each documented where it is opened:

- ``nuts.begin``, ``nuts.flag_wait``, ``nuts.leaf``, ``nuts.merge``:
  ``inference/nuts_batched.py``;
- ``vag.unwhiten``, ``vag.kernel``, ``vag.unwhiten_t``:
  ``ops/kron_metric.py::make_whitened_fused_vag``, once a call; on CUDA
  with the kernel route each opens around its stage's CUDA graph replay
  (``_WhitenedGraph``);
- ``vag.graph``: ``ops/kron_metric.py::_WhitenedGraph``, once a replayed
  call (the copies in, the three replays, the clones out), so its calls are
  the replays;
- ``sghmc.batch``, ``sghmc.draw``, ``sghmc.grad``, ``sghmc.update``,
  ``sghmc.value``: ``inference/sgmcmc.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

_enabled = False
_table: Dict[str, list] = {}        # name -> [calls, host seconds]


_OFF = contextlib.nullcontext()        # every span while the facility is off


class _Span:
    __slots__ = ("name", "t0", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        entry = _table.setdefault(self.name, [0, 0.0])
        entry[0] += 1
        entry[1] += seconds
        return False


def enable(on: bool) -> bool:
    """Turns the spans on or off; returns whether they were on."""
    global _enabled
    was, _enabled = _enabled, bool(on)
    return was


def span(name: str):
    """A context manager over one phase called ``name``; see the module
    docstring."""
    return _Span(name) if _enabled else _OFF


def totals() -> Dict[str, Tuple[int, float]]:
    """A copy of the table: name -> (calls, host seconds) of every span
    closed while the facility was on, over the whole process."""
    return {name: (int(calls), float(seconds)) for name, (calls, seconds) in _table.items()}


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` span over the ``with`` body: host and (on a CUDA
    machine) device activity, written as a Chrome trace
    ``<logdir>/trace.json`` (Perfetto and chrome://tracing read it), with
    the program's spans on for the body.  Yields the profiler, whose
    ``key_averages()`` holds the per-op times after the body."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = enable(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        enable(was)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class SamplerStats:
    """Accumulates wall-clock seconds and draw / gradient counts.  The caller
    ends each timed phase after the device work is done (a synchronize)."""

    num_chains: int = 1
    draws: int = 0
    grad_evals: int = 0
    seconds: float = 0.0
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, draws: int = 0, grad_evals: int = 0):
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        self.seconds += time.perf_counter() - self._t0
        self.draws += draws
        self.grad_evals += grad_evals
        self._t0 = None
        return self

    @property
    def draws_per_sec(self) -> float:
        return self.draws / self.seconds if self.seconds else 0.0

    @property
    def grads_per_sec(self) -> float:
        return self.grad_evals / self.seconds if self.seconds else 0.0


def cuda_time_ms(fn: Callable[[], Any], iters: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA stream, from CUDA
    events around ``iters`` calls after ``warmup`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
