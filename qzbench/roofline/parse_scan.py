"""``parse_scan`` (``csrc/parse_scan.cu``): args (is_match, ml, taken,
lit, lanes, seg, stream). Bytes: is_match (1) and ml (4) read, taken and
lit (1 each) written, a position; four operations a position."""

from qzbench.roofline import matcher

SYMBOL = "parse_scan_kernel"
matches = matcher(SYMBOL)


def count(args):
    lanes, seg = args[4:6]
    pos = lanes * seg
    return pos * (1 + 4 + 2), pos * 4
