"""k3 ``huffman_lookup`` (``csrc/huffman_lookup.cu``): args (lit_pack,
dist_pack, sym, dsym, lout, dout, b, n, stream). Bytes: two int32 planes
read and two written a position, the (b, 286) and (b, 30) tables read;
two operations a position."""

from qzbench.roofline import matcher

SYMBOL = "lookup_kernel"
matches = matcher(SYMBOL)


def count(args):
    b, n = args[6:8]
    return b * n * 16 + b * 316 * 4, b * n * 2
