"""A pure-Python LZ4 block decoder.

Counterpart of the decoder in ``qatzip_tpu/sw/lz4_py.py``: slow by
design, and written apart from the native codec, so the tests and
``chip_smoke.py`` decode the port's LZ4 blocks with it as an independent
check. Nothing on the compress or decompress path calls it.
"""

from __future__ import annotations

MINMATCH = 4


def lz4_decompress_block_py(src: bytes, out_cap: int) -> bytes:
    """Decode one LZ4 block; raises ValueError on a malformed block or
    one that gives more than ``out_cap`` bytes."""
    out = bytearray()
    ip = 0
    n = len(src)
    try:
        while ip < n:
            token = src[ip]
            ip += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    s = src[ip]
                    ip += 1
                    lit += s
                    if s != 255:
                        break
            if ip + lit > n:
                raise ValueError("LZ4 literals past the block's end")
            out += src[ip:ip + lit]
            ip += lit
            if ip >= n:
                break                       # the last sequence: no match
            offset = src[ip] | (src[ip + 1] << 8)
            ip += 2
            if offset == 0 or offset > len(out):
                raise ValueError("bad LZ4 offset")
            mlen = token & 15
            if mlen == 15:
                while True:
                    s = src[ip]
                    ip += 1
                    mlen += s
                    if s != 255:
                        break
            mlen += MINMATCH
            start = len(out) - offset
            if offset >= mlen:
                out += out[start:start + mlen]
            else:
                for k in range(mlen):
                    out.append(out[start + k])
            if len(out) > out_cap:
                break
    except IndexError:
        raise ValueError("LZ4 block cut short") from None
    if len(out) > out_cap:
        raise ValueError("LZ4 output overflow")
    return bytes(out)
