"""Full-device LZ4 block packing: final block bytes on the device.

Counterpart of ``qatzip_tpu/ops/lz4_pack.py``: the same parse (the
full-row search, matches capped at 273, the LZ4 end rules), the same
words, byte counts and ``ok`` flags. The LZ4 format lets only the last
sequence of a block be literal-only, so a literal run cannot be split and
its length bytes ride one emission. Emissions stay within one u32 by

  * capping matches at 273 (the stored length's overflow byte is then at
    most 254, exactly one byte; a longer match goes on as back-to-back
    sequences with no literals, which the format allows), and
  * packing only rows whose literal runs hold at most 270 literals
    (token + at most 2 length bytes + the run's first literal = 4 bytes).
    A row with a longer run is not ``ok``: the caller repacks it with the
    host coder (such runs mean data that barely compresses).

Per position:
  run start p:   the token (the run's length nibble, and the length
                 nibble of the match that ends the run), the run's length
                 bytes, p's own byte;
  literal p:     its byte;
  match start m: its own token when no literal run precedes it, the
                 2-byte offset, the stored length's overflow byte.

The JAX package ran this stage as XLA ops (run lengths and next matches
by doubling, emission planes, a cumsum and a 256-position group pack).
Here it is one CUDA kernel, ``lz4_pack_rows`` (``csrc/lz4_pack_rows.cu``),
with :func:`lz4_pack_rows_ref` its plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_pack as cp
from .cuda_pack import _as_i32, _device, _require, count_launch
from .lz77 import _analyze

LZ4_MAX_MATCH = 273     # stored length overflow <= 254: one byte
LZ4_MAX_RUN = 270       # token + <= 2 length bytes + the first literal
LZ4_GROUP_W = 112       # the JAX route's words for 256 positions
NM_ROUNDS = 10          # the JAX route's next-match doubling: 1024 >= 543
LZ4_RING_WORDS = 8192   # the kernel's staged output words (32 KB)
LZ4_SMEM_EXTRA = 3200   # the kernel's static shared memory (totals, nibbles)
LZ4_SMEM_LIMIT = 49152  # a CTA's shared memory without opting in


def lz4_max_words(n: int) -> int:
    """Words of an output row: 2 bytes a position and 16 more."""
    return (2 * n) // 4 + 4


def lz4_planes(data: torch.Tensor, lengths: torch.Tensor, *, n: int):
    """(ml, dist, taken, lit) of the LZ4 device pack's parse."""
    _iota, ml, dist, taken, lit, _valid = _analyze(
        data, lengths, n=n, min_match=4, max_match=LZ4_MAX_MATCH,
        window=32768, parse_seg=8192, ctx_words=4, probes=6, lz4_rules=True)
    return ml, dist, taken, lit


def run_planes(ml: torch.Tensor, taken: torch.Tensor, lit: torch.Tensor):
    """The JAX route's run planes, int64: ``lr`` the forward literal run
    from each position (exact to n), ``nm`` the first taken match length
    in [p, p + 1024)."""
    b, n = lit.shape
    iota = torch.arange(n, device=lit.device)
    lr = lit.to(torch.int64)
    for k in range((n - 1).bit_length()):
        span = 1 << k
        nlr = torch.where(iota + span < n, torch.roll(lr, -span, 1), 0)
        lr = torch.where(lr == span, lr + nlr, lr)
    nm = torch.where(taken, ml.to(torch.int64), 0)
    for k in range(NM_ROUNDS):
        span = 1 << k
        right = torch.where(iota + span < n, torch.roll(nm, -span, 1), 0)
        nm = torch.where(nm == 0, right, nm)
    return lr, nm


def lz4_emissions(data, ml, dist, taken, lit, lr, nm):
    """Every position's emission: (value, bytes), int64 planes, the value
    little-endian in its low 32 bits."""
    b = lit.shape[0]
    prev_lit = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                      device=lit.device), lit[:, :-1]], 1)
    runstart = lit & ~prev_lit
    L = lr
    mnib = torch.where(nm > 0, torch.clamp(nm - 4, min=0, max=15), 0)
    lit_byte = data.to(torch.int64)
    rs_val = (torch.clamp(L, max=15) << 4) | mnib
    rs_val = torch.where(L >= 15, rs_val | (torch.clamp(L - 15, max=255)
                                            << 8), rs_val)
    rs_val = torch.where(L >= 270, rs_val | ((L - 270) << 16), rs_val)
    rs_nb = 1 + (L >= 15).to(torch.int64) + (L >= 270).to(torch.int64)
    rs_val = rs_val | (lit_byte << (rs_nb * 8))

    stored = torch.clamp(ml.to(torch.int64) - 4, min=0)
    ext = stored >= 15
    d = dist.to(torch.int64)
    own = taken & ~prev_lit                  # a sequence with no literals
    m_val = torch.where(own, torch.clamp(stored, max=15) | (d << 8), d)
    m_val = torch.where(ext, m_val | ((stored - 15) << torch.where(own, 24,
                                                                   16)),
                        m_val)
    m_nb = 2 + own.to(torch.int64) + ext.to(torch.int64)

    vals = torch.where(taken, m_val, torch.where(
        runstart, rs_val, torch.where(lit, lit_byte, 0))) & 0xFFFFFFFF
    nbs = torch.where(taken, m_nb, torch.where(
        runstart, rs_nb + 1, lit.to(torch.int64)))
    return vals, nbs


def lz4_pack_rows_ref(data, ml, dist, taken, lit, *, max_words: int):
    """Plain version of :func:`lz4_pack_rows` (same arguments): the JAX
    route's run planes and emission planes, their exclusive byte offsets,
    and one int64 ``scatter_add_`` of every emission's two word parts
    straight into the row (the bytes of two emissions are disjoint, so
    add equals OR); words at or past ``max_words`` are dropped, and rows
    that are not ok come out as zeros."""
    lr, nm = run_planes(ml, taken, lit)
    vals, nbs = lz4_emissions(data, ml, dist, taken, lit, lr, nm)
    csum = torch.cumsum(nbs, dim=1)
    off = csum - nbs
    s = (off & 3) * 8
    lo = (vals << s) & 0xFFFFFFFF
    hi = vals >> (32 - s)                    # vals < 2^32: 0 when s == 0
    word = off >> 2
    out = torch.zeros((ml.shape[0], max_words + 1), dtype=torch.int64,
                      device=ml.device)
    out.scatter_add_(1, torch.cat([word, word + 1], 1).clamp_(max=max_words),
                     torch.cat([lo, hi], 1))
    ok = lr.max(dim=1).values <= LZ4_MAX_RUN
    words = torch.where(ok[:, None], out[:, :max_words], 0)
    return _as_i32(words), csum[:, -1].to(torch.int32), ok


def lz4_pack_rows(data, ml, dist, taken, lit, *, max_words: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every position's LZ4 emission, packed into its row's block bytes.

    Args:
      data: (B, n) uint8 row bytes.
      ml, dist: (B, n) int32 match length and distance.
      taken, lit: (B, n) bool: a match starts at p / p is a literal.
      max_words: words per output row; words at or past it are dropped.
    Returns:
      words (B, max_words) int32 (little-endian block bytes as uint32 bit
      patterns, zero past the block, all zero on a row that is not ok),
      nbytes (B,) int32 block bytes of each row, ok (B,) bool: every
      literal run of the row holds at most LZ4_MAX_RUN literals.

    The planes are ones an LZ4 parse gives (:func:`lz4_planes`): ``taken``
    and ``lit`` are disjoint, a literal run ends at a taken match or at
    the row's last literal, ``ml`` is 4-273 and ``dist`` 1-32768 where
    taken. On an ok row every emission then fits 4 bytes, and no
    256-position group of the JAX route outgrows its ``LZ4_GROUP_W``
    words: a literal emits 1 byte, a run's start at most 3 more (the
    second length byte only with 270 literals, the first with 15), a
    match at most 4 over at least 4 positions and only 2 + its overflow
    byte after a run, so 256 positions emit at most ~285 bytes, 72 words
    with the offset. So the result equals that route's.

    On the card a CTA holds the row's literal bitmap and a ring of
    ``LZ4_RING_WORDS`` output words in the shared memory a CTA gets
    without opting in (``LZ4_SMEM_LIMIT``), so ``n`` is at most 105,472;
    ``max_words`` is free.
    """
    shape = ml.shape
    b, n = shape
    dev = _device(ml)
    for t, what, dtype in ((data, "data", torch.uint8),
                           (ml, "ml", torch.int32),
                           (dist, "dist", torch.int32),
                           (taken, "taken", torch.bool),
                           (lit, "lit", torch.bool)):
        if t.shape != shape:
            raise ValueError(f"{what} shape {tuple(t.shape)} != {(b, n)}")
        _require(t, what, dtype, dev)
    if max_words < 1:
        raise ValueError(f"max_words {max_words} must be positive")
    if dev < 0:
        return lz4_pack_rows_ref(data, ml, dist, taken, lit,
                                 max_words=max_words)
    smem = 4 * LZ4_RING_WORDS + (n + 31) // 32 * 4 + LZ4_SMEM_EXTRA
    if smem > LZ4_SMEM_LIMIT:
        raise ValueError(f"the literal bitmap of a row of {n} positions "
                         f"does not fit the {LZ4_SMEM_LIMIT} bytes of "
                         "shared memory of one CTA")
    words = ml.new_empty((b, max_words))    # int32 on ml's device
    nbytes = ml.new_empty((b,))
    ok = taken.new_empty((b,))               # bool
    if b == 0:
        return words, nbytes, ok
    k = cp._ext or cp.kernels()
    k.lz4_pack_rows(data.data_ptr(), ml.data_ptr(), dist.data_ptr(),
                    taken.data_ptr(), lit.data_ptr(), words.data_ptr(),
                    nbytes.data_ptr(), ok.data_ptr(), b, n, max_words,
                    k.stream(dev))
    count_launch("lz4_pack_rows")
    return words, nbytes, ok


def lz4_pack_device(data: torch.Tensor, lengths: torch.Tensor, *, n: int):
    """Pack a chunk batch into LZ4 block bytes on ``data.device``.

    Args:
      data: (B, n) uint8, zero-padded beyond per-row ``lengths``.
      lengths: (B,) int32 valid bytes per row.
    Returns (words (B, lz4_max_words(n)) int32 little-endian block bytes,
    nbytes (B,) int32, ok (B,) bool). Rows that are not ok hold a literal
    run longer than LZ4_MAX_RUN and must be packed by the host coder."""
    ml, dist, taken, lit = lz4_planes(data, lengths, n=n)
    return lz4_pack_rows(data, ml.to(torch.int32).contiguous(),
                         dist.to(torch.int32).contiguous(), taken, lit,
                         max_words=lz4_max_words(n))
