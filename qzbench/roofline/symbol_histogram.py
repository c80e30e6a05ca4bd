"""k4 ``symbol_histogram`` (``csrc/symbol_histogram.cu``): args (sym,
dsym, hist, b, n, stream). Bytes: the two int32 symbol planes read, the
(b, 316) int32 counts written; two operations a position."""

from qzbench.roofline import matcher

SYMBOL = "hist_kernel"
matches = matcher(SYMBOL)
NBINS = 316


def count(args):
    b, n = args[3:5]
    return b * n * 8 + b * NBINS * 4, b * n * 2
