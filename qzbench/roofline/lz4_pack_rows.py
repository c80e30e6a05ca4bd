"""``lz4_pack_rows`` (``csrc/lz4_pack_rows.cu``): args (data, ml, dist,
taken, lit, words, nbytes, ok, b, n, max_words, stream). Bytes: data, ml,
dist, taken and lit read once (11 a position), the words, nbytes and ok
written once. Operations: 12 a position."""

from qzbench.roofline import matcher

SYMBOL = "lz4_pack_rows_kernel"
matches = matcher(SYMBOL)


def count(args):
    b, n, max_words = args[8:11]
    return b * n * 11 + b * (max_words * 4 + 5), b * n * 12
