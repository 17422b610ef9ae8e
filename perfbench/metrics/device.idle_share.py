"""device.idle_share: 1 - (the device's busy seconds an iteration, the union of
its kernel, copy and set intervals in the chunk traced with the device's
activity alone) / (the host-clock seconds an iteration of the chunks before
the first traced one), in %.  Those give the time of an iteration as the
window runs it: even device-only tracing adds a few microseconds a launch,
which slows a host-paced loop (the traced chunk's own wall time is the
``busy_s`` / ``window_s`` of the run's ``device``)."""


def read(run):
    t = run.trace
    if t is None or not run.busy_iterations or t.busy_s <= 0.0 or run.untraced_s <= 0.0:
        return None
    busy = t.busy_s / run.busy_iterations
    wall = run.untraced_s / run.untraced_iterations
    return 100.0 * (1.0 - busy / wall)
