"""ess_min_per_s: the smallest ESS over every parameter coordinate, over every
chain and draw of the window, divided by the window's seconds."""

import numpy as np


def read(run):
    if run.ess is None:
        return None
    return float(np.min(run.ess)) / run.window_s
