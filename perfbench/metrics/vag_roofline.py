"""vag_roofline: the least time the card needs for the whitened value+grad
calls of the traced stretch (their work counted from the cell's shapes,
``yardstick/flops.py``), over the device seconds of every kernel launched
from inside the harness's ``perfbench.vag`` / ``perfbench.grad`` spans, in %.
Stated against the H100 SXM's published peaks, the card's power limit
beside it in the run's ``device``."""

SPANS = ("perfbench.vag", "perfbench.grad")


def read(run):
    t = run.trace
    if t is None or run.vag_bound_s is None:
        return None
    calls = sum(t.span_calls.get(s, 0) for s in SPANS)
    device_s = sum(t.span_device_s.get(s, 0.0) for s in SPANS)
    if calls == 0 or device_s <= 0.0:
        return None
    return 100.0 * calls * run.vag_bound_s / device_s
