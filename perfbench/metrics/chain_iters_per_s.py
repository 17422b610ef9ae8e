"""chain_iters_per_s: chains x sampler iterations (an HMC or NUTS draw, an
SGHMC minibatch step) completed in the window, over the window's seconds."""


def read(run):
    return run.iterations / run.window_s
