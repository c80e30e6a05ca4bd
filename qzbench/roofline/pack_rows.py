"""k1 ``pack_rows`` (``csrc/pack_rows.cu``): args (data, ml, dist, taken,
lit, lpack, dpack, base, words, end, b, n, max_words, stream); ``data``
is 0 on the dynamic mode, ``lpack`` / ``dpack`` on the static one. Bytes:
every plane read once (ml, dist int32, taken, lit bool, the static
mode's bytes, the dynamic mode's two int32 code planes), the words, end
and base once. Operations: 14 a position (the emission's code
arithmetic, its offset, two word parts)."""

from qzbench.roofline import matcher

SYMBOL = "pack_rows_kernel"
matches = matcher(SYMBOL)


def count(args):
    data, lpack, dpack = args[0], args[5], args[6]
    b, n, max_words = args[10:13]
    per_pos = 4 + 4 + 1 + 1 + (1 if data else 0) + (4 if lpack else 0) \
        + (4 if dpack else 0)
    return b * n * per_pos + b * (max_words + 2) * 4, b * n * 14
