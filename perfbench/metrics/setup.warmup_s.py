"""setup.warmup_s: seconds of the sampler's warmup (dual averaging for HMC and
NUTS, the SGD warm start for SGHMC) and the short chunk that warms the
window's calls, host clock around a synchronize."""


def read(run):
    return run.timings.get("warmup_s")
