"""k2 ``candidate_search`` (``csrc/candidate_search.cu``): args (key, ctx,
out, rows, w, pbits, ctx_words, probes, min_match, stream). Bytes: the
key, ``ctx_words`` context words and the output, 4 bytes a position.
Operations: one hash compare a position, the first probe; chip_smoke.py
counts the probes these inputs reach from the planes themselves, which a
launch's arguments do not hold, so this is a lower count (the kernel is
bound by its bytes either way)."""

from qzbench.roofline import matcher

SYMBOL = "candsearch_kernel"
matches = matcher(SYMBOL)


def count(args):
    rows, w, _pbits, ctx_words = args[3:7]
    return rows * w * 4 * (2 + ctx_words), rows * (w - 1)
