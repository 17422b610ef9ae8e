"""mlp.launches_per_step: device kernels that started in the traced stretch
over the SGHMC steps (``perfbench.sghmc_step`` spans) in it."""


def read(run):
    t = run.trace
    if t is None:
        return None
    steps = t.span_calls.get("perfbench.sghmc_step", 0)
    if steps == 0 or t.kernels == 0:
        return None
    return t.kernels / steps
