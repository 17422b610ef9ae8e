"""A profiler span, throughput counters and a CUDA-event kernel timer."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` span over the ``with`` body: host and (on a CUDA
    machine) device activity, written as a Chrome trace
    ``<logdir>/trace.json`` (Perfetto and chrome://tracing read it).  Yields
    the profiler, whose ``key_averages()`` holds the per-op times after the
    body."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_seconds(prof) -> float:
    """The device's kernel and copy seconds in a finished ``torch.profiler``
    span (``device_trace``): each event's own device time, so an operator's
    row does not count its kernels twice."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6


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
