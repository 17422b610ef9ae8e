"""ess_per_s: median ESS over every parameter coordinate, over every chain and
draw of the window, divided by the window's seconds."""

import numpy as np


def read(run):
    if run.ess is None:
        return None
    return float(np.median(run.ess)) / run.window_s
