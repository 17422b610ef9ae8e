"""sampler.ess_per_draw: median ESS over the coordinates over chains x draws
of the window: useful work per attempt, which tells a speed change from a
mixing change."""

import numpy as np


def read(run):
    if run.ess is None:
        return None
    return float(np.median(run.ess)) / (run.chains * run.draws)
