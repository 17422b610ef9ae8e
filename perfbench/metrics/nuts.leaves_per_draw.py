"""nuts.leaves_per_draw: lockstep leaves the NUTS kernel executed in the window
(its ``leaves_executed`` counter, masked leaves included) per draw."""


def read(run):
    leaves = run.counters.get("leaves")
    if leaves is None or not run.draws:
        return None
    return leaves / run.draws
