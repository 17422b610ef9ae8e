"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).  Every roofline and MFU share of the
benchmark is stated against these, with the card's power limit beside it."""

PEAK_BF16_FLOPS = 989e12      # dense bf16 / fp16 tensor-core rate, flop/s
PEAK_BYTES_PER_S = 3.35e12    # HBM3 bandwidth, bytes/s
