"""``crc32_rows`` (``csrc/crc32_rows.cu``): args (data, out, frag, tails,
b, n, zero_crc, stream). Bytes: the (b, n) rows read once, a 4-byte crc
a row written; two operations a byte (a table step and an xor)."""

from qzbench.roofline import matcher

SYMBOL = "crc_kernel"
matches = matcher(SYMBOL)


def count(args):
    b, n = args[4:6]
    return b * n + b * 4, b * n * 2
