"""mfu: the model flop of the window's chunks before the first traced one (the
whitened value+grad calls made, or the MLP's forward and backward GEMMs of
every step, ``yardstick/flops.py``) over their host-clock seconds times the
dense bf16 peak of 989 TFLOP/s, in %; the same peak for every cell."""

from perfbench.yardstick.peaks import PEAK_BF16_FLOPS


def read(run):
    if run.untraced_s <= 0.0 or run.untraced_flop <= 0.0:
        return None
    return 100.0 * run.untraced_flop / (run.untraced_s * PEAK_BF16_FLOPS)
