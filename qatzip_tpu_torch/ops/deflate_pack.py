"""Full-device DEFLATE entropy packing, static and dynamic Huffman.

Counterpart of ``qatzip_tpu/ops/deflate_pack.py``: the device emits the
final deflate bitstream words of each chunk, so the fetch carries
compressed words instead of tokens and the host only frames members.
Words and bit counts are bit-identical to the JAX package's.

  1. emissions — every position p emits its bits: a taken match its
     length and distance codes with their extra bits, a literal its code,
     a covered position nothing;
  2. bit offsets — the exclusive prefix of the per-position bit counts;
  3. placement — every emission ORed into its row's words at its offset.

All three are one CUDA kernel, ``pack_rows`` (``csrc/pack_rows.cu``),
which reads the parse planes once and writes only the final words. It
replaces TPU kernel k1 and the stages that fed it on the TPU (int64
emission planes, a cumsum, and a 256-position group pack into fixed-width
windows that k1 placed). Its plain version builds the emission planes
(:func:`static_emissions`, :func:`dynamic_emissions`), their offsets,
and scatter-adds every emission's two word parts straight into the row.

The static packer's stream starts with the 3-bit block header (BFINAL=0,
BTYPE=01); its end-of-block code is seven zero bits, already there. The
dynamic packer runs in two passes around a host step: pass 1
(:func:`deflate_analyze_hist`) counts each chunk's symbols with the CUDA
kernel ``symbol_histogram`` (TPU kernel k4); the host builds both
length-limited trees and the block header (``native.dyn_plan``); pass 2
(:func:`deflate_pack_dynamic`) resolves every position's codes with the
CUDA kernel ``huffman_lookup`` (TPU kernel k3) and packs. Both passes'
symbol planes come from the CUDA kernel ``symbol_planes`` (XLA ops in
the JAX package; plain versions :func:`hist_symbols` and
:func:`lookup_symbols`). A match emits its length part at p and its
distance part at p + 1 (a match covers at least 4 positions), so every
emission fits 32 bits.

Dtypes: emissions and words are carried in int64 below 2^32 (torch on
the CPU has no uint32 shifts), and cross the kernels as int32 bit
patterns. An emission can use all 32 bits (dist >= 16385 with a long
length code), so its high part must be shifted as unsigned.

Left out: the multi-tile scan variant ``deflate_pack_scan`` and the
``QZTPU_PALLAS`` kernel selection (the port always runs its kernels).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import cuda_pack as cp
from .cuda_pack import (_as_i32, _device, _require, count_launch,
                        huffman_lookup, symbol_histogram)
from .lz77 import _analyze

HDR_BITS = 3         # BFINAL + BTYPE(01), emitted as 0b010 (BFINAL=0)
EOB_BITS = 7         # static end-of-block code is seven 0 bits
DYN_LIMIT = 12       # code-length limit of both dynamic trees


def _rev16(x: torch.Tensor, nbits) -> torch.Tensor:
    """Bit-reverse the low ``nbits`` (<= 16) of int64 x."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> (16 - nbits)


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) + 1 for x >= 1, else 0; exact for x < 2^24 (callers
    pass x <= 32768): the exponent of x as a float32."""
    e = torch.frexp(x.to(torch.float32)).exponent.to(torch.int64)
    return torch.where(x >= 1, e, 0)


def _len_symbol(ml: torch.Tensor):
    """Match length -> (length symbol 257..285, extra bits, extra value),
    int64 planes."""
    lc = ml.to(torch.int64) - 3
    e_len = torch.clamp(_bitlen(torch.clamp(lc, min=1)) - 3, min=0)
    sym_hi = 257 + 4 * (e_len + 1) + ((lc >> e_len) & 3)
    lsym = torch.where(lc < 8, 257 + lc, torch.where(ml == 258, 285, sym_hi))
    e_len = torch.where((lc < 8) | (ml == 258), 0, e_len)
    lextra = lc & ((1 << e_len) - 1)
    return lsym, e_len, lextra


def _dist_symbol(dist: torch.Tensor):
    """Distance -> (distance symbol 0..29, extra bits, extra value), int64
    planes."""
    d1 = dist.to(torch.int64) - 1
    e_d = torch.clamp(_bitlen(torch.clamp(d1, min=1)) - 2, min=0)
    dsym_hi = 2 * (e_d + 1) + ((d1 >> e_d) & 1)
    dsym = torch.where(d1 < 4, d1, dsym_hi)
    e_d = torch.where(d1 < 4, 0, e_d)
    dextra = d1 & ((1 << e_d) - 1)
    return dsym, e_d, dextra


def _match_emission(ml: torch.Tensor, dist: torch.Tensor):
    """Static-Huffman bits of a match: (value LSB-first, nbits), int64.

    Length codes (RFC 1951 3.2.6): symbols 256-279 are 7 bits (sym-256),
    280-287 are 8 bits (0xC0 + sym-280); distance codes are 5 bits."""
    lsym, e_len, lextra = _len_symbol(ml)
    lbits = torch.where(lsym < 280, 7, 8)
    lcode = torch.where(lsym < 280, _rev16(lsym - 256, 7),
                        _rev16(0xC0 + lsym - 280, 8))
    dsym, e_d, dextra = _dist_symbol(dist)
    v = lcode | (lextra << lbits)
    sh = lbits + e_len
    v = v | (_rev16(dsym, 5) << sh)
    sh = sh + 5
    v = v | (dextra << sh)
    return v, sh + e_d


def _lit_emission(byte: torch.Tensor):
    """Static literal code: 0-143 -> 8 bits 0x30+b; 144-255 -> 9 bits
    0x190+(b-144). Returns (value, nbits), int64."""
    b = byte.to(torch.int64)
    hi = b >= 144
    v = torch.where(hi, _rev16(0x190 + b - 144, 9), _rev16(0x30 + b, 8))
    return v, torch.where(hi, 9, 8)


def _offsets(nbits: torch.Tensor, base):
    """Exclusive prefix of the bit counts from ``base``: (off, the row's
    end bit)."""
    incl = base + torch.cumsum(nbits, dim=1)
    return incl - nbits, incl[:, -1]


def _analyze_planes(data, lengths, *, n, parse_seg, ctx_words, probes,
                    search_seg, search_overlap):
    """(ml, dist, taken, lit) of the level-1 parse, as both packers
    take them."""
    _iota, ml, dist, taken, lit, _valid = _analyze(
        data, lengths, n=n, min_match=4, max_match=258, window=32768,
        parse_seg=parse_seg, ctx_words=ctx_words, probes=probes,
        search_seg=search_seg, search_overlap=search_overlap)
    return ml, dist, taken, lit


def static_emissions(data, ml, dist, taken, lit):
    """Static-Huffman emission planes (bits, nbits), int64."""
    mv, mn = _match_emission(ml, dist)
    lv, ln = _lit_emission(data)
    bits = torch.where(taken, mv, torch.where(lit, lv, 0))
    nbits = torch.where(taken, mn, torch.where(lit, ln, 0))
    return bits, nbits


def deflate_pack_device(data: torch.Tensor, lengths: torch.Tensor, *, n: int,
                        parse_seg: int = 8192, ctx_words: int = 4,
                        probes: int = 6, max_words: int = 0,
                        search_seg: int = 0, search_overlap: int = 1024,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress a chunk batch to final static-Huffman deflate bitstreams.

    Args:
      data: (B, n) uint8, zero-padded beyond per-row ``lengths``.
      lengths: (B,) int32 valid bytes per row.
    Returns:
      words: (B, max_words) int32 little-endian bitstream words (uint32
             bit patterns); header bit 0 (BFINAL) is left 0, the EOB's 7
             zero bits and the byte padding are implicit zeros.
      nbits: (B,) int32 total bits per row, header and EOB included.
    """
    if max_words == 0:
        max_words = (n * 9 + HDR_BITS + EOB_BITS + 31) // 32 + 2
    ml, dist, taken, lit = _analyze_planes(
        data, lengths, n=n, parse_seg=parse_seg, ctx_words=ctx_words,
        probes=probes, search_seg=search_seg, search_overlap=search_overlap)
    base = torch.full((data.shape[0],), HDR_BITS, dtype=torch.int32,
                      device=data.device)
    out, end = pack_rows(ml, dist, taken, lit, base, max_words=max_words,
                         data=data)
    # block header bits [0, 3): BFINAL=0, BTYPE=01 -> LSB-first 0b010;
    # emissions start at bit 3, so the OR touches no emitted bit
    out[:, 0] |= 0b010
    return out, (end + EOB_BITS).to(torch.int32)


def hist_symbols(data, ml, dist, taken, lit):
    """Pass-1 symbol planes (sym, dsym + 286), int32, as
    ``symbol_histogram`` takes them: 320 where nothing is counted."""
    lsym, _e, _x = _len_symbol(ml)
    dsym, _ed, _dx = _dist_symbol(dist)
    sym = torch.where(taken, lsym, torch.where(lit, data.to(torch.int64), 320))
    dsym_m = torch.where(taken, 286 + dsym, 320)
    return (sym.to(torch.int32).contiguous(),
            dsym_m.to(torch.int32).contiguous())


def deflate_analyze_hist(data: torch.Tensor, lengths: torch.Tensor, *,
                         n: int, parse_seg: int = 8192, ctx_words: int = 4,
                         probes: int = 6, search_seg: int = 0,
                         search_overlap: int = 1024):
    """Pass 1: parse + per-chunk symbol histogram (B, 316) int32: lit/len
    symbols 0..285, then distance symbols 286..315. Returns (hist, ml,
    dist, taken, lit); the planes feed pass 2."""
    ml, dist, taken, lit = _analyze_planes(
        data, lengths, n=n, parse_seg=parse_seg, ctx_words=ctx_words,
        probes=probes, search_seg=search_seg, search_overlap=search_overlap)
    sym, dsym_m = symbol_planes(data, ml, dist, taken, lit, mode=1)
    return symbol_histogram(sym, dsym_m), ml, dist, taken, lit


def lookup_symbols(data, ml, dist, taken, lit):
    """Pass-2 symbol planes (sym, dsym), int32, as ``huffman_lookup``
    takes them: sym 286 where nothing is emitted."""
    lsym, _e, _x = _len_symbol(ml)
    sym = torch.where(taken, lsym, torch.where(lit, data.to(torch.int64), 286))
    dsym, _ed, _dx = _dist_symbol(dist)
    return (sym.to(torch.int32).contiguous(),
            dsym.to(torch.int32).contiguous())


def symbol_planes_ref(data, ml, dist, taken, lit, *, mode: int):
    """Plain version of :func:`symbol_planes` (same arguments):
    :func:`hist_symbols` (mode 1) or :func:`lookup_symbols` (mode 2)."""
    return (hist_symbols if mode == 1 else lookup_symbols)(
        data, ml, dist, taken, lit)


def symbol_planes(data, ml, dist, taken, lit, *, mode: int):
    """The dynamic pack's (sym, dsym) planes, (B, n) int32, in one pass.

    Mode 1, pass 1's form (:func:`hist_symbols`, as ``symbol_histogram``
    counts them): sym the length symbol where taken, the byte where lit,
    else 320; dsym 286 + the distance symbol where taken, else 320. Mode
    2, pass 2's form (:func:`lookup_symbols`, as ``huffman_lookup`` reads
    them): sym as in mode 1 with 286 where nothing is emitted; dsym the
    distance symbol everywhere.

    Args:
      data: (B, n) uint8; ml, dist: (B, n) int32; taken, lit: (B, n) bool.
    """
    if mode not in (1, 2):
        raise ValueError(f"mode {mode} is 1 (pass 1) or 2 (pass 2)")
    shape = ml.shape
    if len(shape) != 2:
        raise ValueError(f"ml must be (B, n), got {tuple(shape)}")
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
    if dev < 0:
        return symbol_planes_ref(data, ml, dist, taken, lit, mode=mode)
    sym = torch.empty_like(ml)
    dsym = torch.empty_like(ml)
    if b == 0 or n == 0:
        return sym, dsym
    k = cp._ext or cp.kernels()
    k.symbol_planes(data.data_ptr(), ml.data_ptr(), dist.data_ptr(),
                    taken.data_ptr(), lit.data_ptr(), sym.data_ptr(),
                    dsym.data_ptr(), b, n, mode, k.stream(dev))
    count_launch("symbol_planes")
    return sym, dsym


def _shift1(x: torch.Tensor) -> torch.Tensor:
    """x moved one position right along axis 1, zero (False) first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def dynamic_emissions(ml, dist, taken, lit, lpack, dpack):
    """Dynamic emission planes (bits, nbits), int64, from the per-position
    table entries: the length part of a match at p, its distance part at
    p + 1, a literal's code at its own position."""
    _lsym, e_len, lextra = _len_symbol(ml)
    _dsym, e_d, dextra = _dist_symbol(dist)
    lpack = lpack.to(torch.int64)
    dpack = dpack.to(torch.int64)
    code, clen = lpack & 0xFFF, lpack >> 12
    dcode, dclen = dpack & 0xFFF, dpack >> 12
    len_bits = code | (lextra << clen)
    len_nbits = clen + e_len
    # the distance part moves to p + 1 (always covered: min match is 4)
    dist_bits = _shift1(dcode | (dextra << dclen))
    dist_nbits = _shift1(dclen + e_d)
    dp_mask = _shift1(taken)
    bits = torch.where(taken, len_bits, torch.where(
        dp_mask, dist_bits, torch.where(lit, code, 0)))
    nbits = torch.where(taken, len_nbits, torch.where(
        dp_mask, dist_nbits, torch.where(lit, clen, 0)))
    return bits, nbits


# ---------------------------------------------------------------------------
# The row bit-packer: TPU kernel k1 and the stages that fed it
# ---------------------------------------------------------------------------

#: shared memory one CTA may opt in to on the H100 (227 KB)
MAX_SMEM = 232448
#: what ``pack_rows`` keeps in shared memory beside its row image: up to
#: three words of alignment shift and the per-warp bit counts
PACK_ROWS_SMEM_EXTRA = 3 * 4 + 2 * 16 * 4


def _mode_planes(data, lpack, dpack):
    """The planes that select the mode: static when ``data`` is given,
    dynamic when ``lpack`` and ``dpack`` are."""
    if (data is None) == (lpack is None) or (lpack is None) != (dpack is None):
        raise ValueError("pack_rows takes data (static) or lpack and dpack "
                         "(dynamic)")
    if data is not None:
        return [(data, "data", torch.uint8)]
    return [(lpack, "lpack", torch.int32), (dpack, "dpack", torch.int32)]


def pack_rows_ref(ml, dist, taken, lit, base, *, max_words: int, data=None,
                  lpack=None, dpack=None):
    """Plain version of :func:`pack_rows` (same arguments): the emission
    planes, their exclusive offsets, and one int64 ``scatter_add_`` of
    every emission's low and high word parts straight into the row (the
    bits two emissions give one word are disjoint, so add equals OR);
    words at or past ``max_words`` go to a spare column that is dropped."""
    _mode_planes(data, lpack, dpack)
    if data is not None:
        bits, nbits = static_emissions(data, ml, dist, taken, lit)
    else:
        bits, nbits = dynamic_emissions(ml, dist, taken, lit, lpack, dpack)
    off, end = _offsets(nbits, base.to(torch.int64)[:, None])
    s = off & 31
    lo = (bits << s) & 0xFFFFFFFF
    hi = (bits >> 1) >> (31 - s)             # unsigned; safe for s == 0
    word = off >> 5
    out = torch.zeros((ml.shape[0], max_words + 1), dtype=torch.int64,
                      device=ml.device)
    out.scatter_add_(1, torch.cat([word, word + 1], 1).clamp_(max=max_words),
                     torch.cat([lo, hi], 1))
    return _as_i32(out[:, :max_words]), end.to(torch.int32)


def pack_rows(ml, dist, taken, lit, base, *, max_words: int, data=None,
              lpack=None, dpack=None):
    """Every position's emission, packed into its row's deflate words.

    Static Huffman when ``data`` is given (as :func:`static_emissions`
    emits), dynamic when ``lpack`` and ``dpack`` are (as
    :func:`dynamic_emissions` emits: a match's distance part at p + 1).
    Each emission is ORed into the row at its exclusive bit offset from
    the row's ``base``.

    Args:
      ml, dist: (B, n) int32 match length and distance.
      taken, lit: (B, n) bool — a match token starts at p / p emits a
            literal.
      base: (B,) int32 bit at which each row's first emission starts.
      max_words: words per output row; words at or past it are dropped.
      data: (B, n) uint8 bytes (static).
      lpack, dpack: (B, n) int32 lit/len and distance table entries
            ``code | len << 12`` per position, as ``huffman_lookup``
            gives them (dynamic).
    Returns:
      (words (B, max_words) int32 bit patterns, zero past the stream; end
      (B,) int32 bit where each row's stream ends).

    The planes are ones a parse gives: ``taken`` and ``lit`` are
    disjoint, no ``taken`` or ``lit`` lies inside a taken match, ``ml`` is
    4-258 and ``dist`` 1-32768 where taken, and each table entry's code
    fits its length (<= 15). Every emission then fits 32 bits (static at
    most 9 bits a literal and 31 a match; dynamic at most 12 a literal,
    17 a length part and 25 a distance part), and no 256-position group
    of the TPU's route ever outgrows its window (``GROUP_W`` 74 /
    ``DYN_GROUP_W`` 99 words), so the result equals that route's.

    On the card the kernel holds a row in shared memory, so
    ``max_words`` is at most ``(MAX_SMEM - PACK_ROWS_SMEM_EXTRA) // 4``.
    """
    shape = ml.shape
    b, n = shape
    dev = _device(ml)
    planes = [(ml, "ml", torch.int32), (dist, "dist", torch.int32),
              (taken, "taken", torch.bool), (lit, "lit", torch.bool)]
    for t, what, dtype in planes + _mode_planes(data, lpack, dpack):
        if t.shape != shape:
            raise ValueError(f"{what} shape {tuple(t.shape)} != {(b, n)}")
        _require(t, what, dtype, dev)
    if base.shape != (b,):
        raise ValueError(f"base shape {tuple(base.shape)} != {(b,)}")
    _require(base, "base", torch.int32, dev)
    if max_words < 1:
        raise ValueError(f"max_words {max_words} must be positive")
    if dev < 0:
        return pack_rows_ref(ml, dist, taken, lit, base, max_words=max_words,
                             data=data, lpack=lpack, dpack=dpack)
    if max_words * 4 + PACK_ROWS_SMEM_EXTRA > MAX_SMEM:
        raise ValueError(f"a row of {max_words} words does not fit the "
                         f"{MAX_SMEM} bytes of shared memory of one CTA")
    words = ml.new_empty((b, max_words))    # int32 on ml's device
    end = ml.new_empty((b,))
    if b == 0:
        return words, end

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    k = cp._ext or cp.kernels()
    k.pack_rows(ptr(data), ml.data_ptr(), dist.data_ptr(), taken.data_ptr(),
                lit.data_ptr(), ptr(lpack), ptr(dpack), base.data_ptr(),
                words.data_ptr(), end.data_ptr(), b, n, max_words,
                k.stream(dev))
    count_launch("pack_rows")
    return words, end


def deflate_pack_dynamic(data: torch.Tensor, ml, dist, taken, lit,
                         lit_pack: torch.Tensor, dist_pack: torch.Tensor,
                         hdr_bits: torch.Tensor, *, n: int,
                         max_words: int = 0):
    """Pass 2: per-position code lookup + bit pack with per-chunk trees.

    lit_pack (B, 286) and dist_pack (B, 30): int32 ``revcode | len << 12``
    (``native.dyn_plan``); hdr_bits (B,) int32: each chunk's header bit
    length. Emissions start there; the host ORs the header bytes into the
    zero prefix. Returns (words (B, max_words) int32 bit patterns, nbits
    (B,) int32 WITHOUT the EOB, which the host appends)."""
    if max_words == 0:
        max_words = (n * DYN_LIMIT + 4096 + 31) // 32 + 2
    sym, dsym = symbol_planes(data, ml, dist, taken, lit, mode=2)
    lpack, dpack = huffman_lookup(lit_pack, dist_pack, sym, dsym)
    return pack_rows(ml, dist, taken, lit, hdr_bits.to(torch.int32),
                     max_words=max_words, lpack=lpack, dpack=dpack)


# ---------------------------------------------------------------------------
# Host-side framing
# ---------------------------------------------------------------------------

def finish_stream_dynamic(words_row: np.ndarray, nbits: int,
                          hdr_bytes: bytes, eob_pack: int,
                          final: bool) -> bytes:
    """Dynamic-path framing: OR the host-built header into the reserved
    zero prefix, append the chunk's EOB code at bit ``nbits``, then end
    the stream as :func:`finish_stream` does."""
    eob_code = eob_pack & 0xFFF
    eob_len = eob_pack >> 12
    total = nbits + eob_len
    nbytes = (total + 7) // 8
    buf = bytearray(words_row[:(nbytes + 3) // 4].tobytes()[:nbytes])
    if len(buf) < nbytes:
        buf.extend(b"\0" * (nbytes - len(buf)))
    for i, hb in enumerate(hdr_bytes):
        buf[i] |= hb
    v = eob_code << (nbits & 7)
    pos = nbits >> 3
    while v:
        if pos >= len(buf):
            buf.append(0)
        buf[pos] |= v & 0xFF
        v >>= 8
        pos += 1
    if final:
        buf[0] |= 0x01
        return bytes(buf)
    nb2 = (total + 3 + 7) // 8       # 3-bit stored header, pad to byte
    while len(buf) < nb2:
        buf.append(0)
    return bytes(buf) + b"\x00\x00\xff\xff"


def finish_stream(words_row: np.ndarray, nbits: int, final: bool) -> bytes:
    """One row's static device words as a raw deflate byte stream.

    final=True: set BFINAL (the stream ends, zero-padded to a byte).
    final=False: append zlib's Z_FULL_FLUSH, an empty stored block (3
    zero header bits, pad to byte, then 00 00 FF FF), so the next chunk's
    stream can be concatenated byte-wise.
    """
    nbytes = (nbits + 7) // 8
    buf = bytearray(words_row[:(nbytes + 3) // 4].tobytes()[:nbytes])
    if not buf:
        buf = bytearray(1)
    if final:
        buf[0] |= 0x01
        return bytes(buf)
    nb2 = (nbits + 3 + 7) // 8
    while len(buf) < nb2:
        buf.append(0)
    return bytes(buf) + b"\x00\x00\xff\xff"
