"""XXH32, one-shot and streaming: the LZ4 frame checksums.

Counterpart of ``qatzip_tpu/ops/xxhash.py``. :func:`xxh32` runs the
native library's; ``_xxh32_py`` is a pure-Python version of the same
function, the tests' oracle, and :class:`XXH32State` hashes a stream in
pieces.
"""

from __future__ import annotations

import struct

import numpy as np

_P1 = 0x9E3779B1
_P2 = 0x85EBCA77
_P3 = 0xC2B2AE3D
_P4 = 0x27D4EB2F
_P5 = 0x165667B1
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M, 13) * _P1) & _M


def _stripes(accs, buf: bytes):
    """The four accumulators after every whole 16-byte stripe of buf."""
    a1, a2, a3, a4 = accs
    n = len(buf) // 16
    for l1, l2, l3, l4 in np.frombuffer(buf[:n * 16], "<u4").reshape(
            -1, 4).tolist():
        a1, a2, a3, a4 = (_round(a1, l1), _round(a2, l2), _round(a3, l3),
                          _round(a4, l4))
    return [a1, a2, a3, a4]


def _finish(h: int, tail: bytes) -> int:
    """Fold the < 16 trailing bytes into h and avalanche."""
    pos = 0
    while len(tail) - pos >= 4:
        (lane,) = struct.unpack_from("<I", tail, pos)
        h = (_rotl((h + lane * _P3) & _M, 17) * _P4) & _M
        pos += 4
    for b in tail[pos:]:
        h = (_rotl((h + b * _P5) & _M, 11) * _P1) & _M
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    return h ^ (h >> 16)


def _init(seed: int):
    return [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed & _M,
            (seed - _P1) & _M]


def _converge(accs) -> int:
    a1, a2, a3, a4 = accs
    return (_rotl(a1, 1) + _rotl(a2, 7) + _rotl(a3, 12) + _rotl(a4, 18)) & _M


def _xxh32_py(data: bytes, seed: int = 0) -> int:
    """XXH32 in pure Python (slow; the oracle the native one is held to)."""
    data = bytes(data)
    n = len(data)
    if n >= 16:
        h = _converge(_stripes(_init(seed), data))
    else:
        h = (seed + _P5) & _M
    return _finish((h + n) & _M, data[n // 16 * 16:])


def xxh32(data, seed: int = 0) -> int:
    """One-shot XXH32 through the native library."""
    from .. import native
    return native.get_lib().xxh32(data, seed)


class XXH32State:
    """Streaming XXH32: ``update`` with pieces of any size, then
    ``digest``; equal to :func:`xxh32` of the pieces joined."""

    def __init__(self, seed: int = 0):
        self.seed = seed & _M
        self.total = 0
        self._acc = _init(self.seed)
        self._buf = b""

    def update(self, data) -> "XXH32State":
        data = bytes(data)
        self.total += len(data)
        buf = self._buf + data
        whole = len(buf) // 16 * 16
        self._acc = _stripes(self._acc, buf[:whole])
        self._buf = buf[whole:]
        return self

    def digest(self) -> int:
        if self.total >= 16:
            h = _converge(self._acc)
        else:
            h = (self.seed + _P5) & _M
        return _finish((h + self.total) & _M, self._buf)
