"""Batched LZ77 match finding, greedy parse and token compaction.

Counterpart of ``qatzip_tpu/ops/lz77.py``: the same stages, the same
knobs and bit-identical tokens, for every level and for LZ4 (the block
end rules before the parse).

  1. context words — little-endian uint32 of bytes p..p+3, p+4.., ...
  2. hash          — (w4 * 2654435761) mod 2^32 >> (32 - hb); positions
                     too close to the row end go to the overflow bucket
                     1 << hb
  3. candidates    — the CUDA kernel ``candidate_search`` (the port of
                     TPU kernel k2) over overlapped power-of-two windows,
                     or over the whole row when n <= 8192; the full-row
                     search over longer rows (levels >= 6, the LZ4 device
                     pack) is one sort of the row's keys, the probes over
                     the sorted planes and a scatter back to row order, in
                     plain torch, as the JAX package runs it in plain XLA
  4. extension     — saturation doubling of saturated matches
  5. lazy demotion, parse-segment trimming, the LZ4 end rules
  6. parse         — the CUDA kernel ``parse_scan``
  7. literal runs and compaction — plain torch ops, as they were plain
     XLA ops in the JAX package

Output tokens are packed uint32 (carried as int32 bit patterns):
  match:        bit31=1, match length in bits [16,31), (dist-1) in [0,16)
  literal run:  bit31=0, bit30=1, run length in bits [0,14)

Dtypes: torch on the CPU has no uint32 shifts or compares, so 32-bit
words are carried in int64 until they reach a kernel. The hash multiply
is split into 16-bit halves so no product leaves int64's range (a full
32 x 32-bit product can exceed 2^63). The full-row search's keys reach
2^31 | pos (the overflow bucket 1 << 15 at n = 65536, shifted by 16), so
they are sorted as int64.

Left out: the stride-2 search (measured and rejected in the JAX
package) and the multi-tile scan variant.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .cuda_pack import _as_i32, candidate_search, parse_scan

HASH_MUL = 2654435761
TOK_MATCH_BIT = -(1 << 31)          # bit 31 as an int32 bit pattern
TOK_LITRUN_BIT = 1 << 30
# Runs are split at absolute RUN_SPLIT boundaries; this bounds the
# doubling rounds of the run-length plane without changing the bitstream.
RUN_SPLIT = 2048
# The candidate kernel packs (relpos 13, ml 5, dist-1 13) bits.
MAX_WINDOW = 8192


def _shl(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x shifted left by k along axis 1 (x[i] <- x[i+k]), padded with fill."""
    b, n = x.shape
    if k >= n:
        return torch.full_like(x, fill)
    return torch.cat([x[:, k:], torch.full((b, k), fill, dtype=x.dtype,
                                           device=x.device)], dim=1)


def _hash(w4: torch.Tensor, hb: int) -> torch.Tensor:
    """(w4 * HASH_MUL) mod 2^32 >> (32 - hb) for int64 w4 in [0, 2^32)."""
    lo = w4 & 0xFFFF
    hi = w4 >> 16
    prod = (lo * HASH_MUL + (((hi * HASH_MUL) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return prod >> (32 - hb)


def _hashed_context(data: torch.Tensor, lengths: torch.Tensor, *, n: int,
                    min_match: int, ctx_words: int, width: int):
    """The context words (ctx_words, B, n) int64 and the hash plane (B, n)
    int64 of a search over ``width`` positions: (hash, pbits, hb), where
    the sort key is (hash << pbits) | relpos with the overflow bucket at
    1 << hb, so hb + pbits <= 31 (the adaptive hash width)."""
    if n > 65536:
        raise ValueError(f"row length {n} > 65536 (16-bit position field)")
    dev = data.device
    b = data.shape[0]
    dp = torch.cat([data, torch.zeros((b, ctx_words * 4 + 8),
                                      dtype=torch.uint8, device=dev)],
                   dim=1).to(torch.int64)

    def word4(off):
        return (dp[:, off:off + n]
                | (dp[:, off + 1:off + 1 + n] << 8)
                | (dp[:, off + 2:off + 2 + n] << 16)
                | (dp[:, off + 3:off + 3 + n] << 24))

    ctx = torch.stack([word4(4 * k) for k in range(ctx_words)])
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    hashable = (iota + min_match) <= lengths[:, None]
    pbits = max((width - 1).bit_length(), 1)
    hb = min(18, 31 - pbits)
    h = torch.where(hashable, _hash(ctx[0], hb), 1 << hb)
    return ctx, h, pbits, hb


def _search_inputs(data: torch.Tensor, lengths: torch.Tensor, *, n: int,
                   min_match: int, window: int, ctx_words: int,
                   search_seg: int = 0, search_overlap: int = 1024):
    """The candidate search's window rows for a (B, n) batch: overlapped
    windows of ``search_seg``, or the whole row when it is not below n
    (n <= MAX_WINDOW).

    Returns (key, ctx, pbits, unwindow): key (B*nwin, W) and ctx
    (ctx_words, B*nwin, W) as the kernel takes them, and a function that
    maps the kernel's (B*nwin, W) output back to (B, n) row order."""
    dev = data.device
    b = data.shape[0]
    segmented = 0 < search_seg < n
    if not segmented and n > MAX_WINDOW:
        raise ValueError(f"a row of {n} is searched whole by "
                         "_full_row_search, not in kernel windows")
    W, ov = (search_seg, min(search_overlap, search_seg - 1)) if segmented \
        else (n, 0)
    if window < W:
        raise ValueError(f"window {window} must cover the search width {W}")
    ctx, h, pbits, hb = _hashed_context(data, lengths, n=n,
                                        min_match=min_match,
                                        ctx_words=ctx_words, width=W)

    # overlapped power-of-two windows: padded layout [ov synthetic] + row +
    # [right pad]; window k covers padded [k*own, k*own + W) and owns its
    # last `own` slots. Synthetic pads go to the overflow bucket.
    own = W - ov
    nwin = -(-n // own)
    pad_r = (nwin - 1) * own + W - ov - n

    def windows(x, fill):
        lead = x.shape[:-1]
        xp = torch.cat([torch.full((*lead, ov), fill, dtype=x.dtype,
                                   device=dev), x,
                        torch.full((*lead, pad_r), fill, dtype=x.dtype,
                                   device=dev)], dim=-1)
        return xp.unfold(-1, W, own).reshape(*lead[:-1], b * nwin, W)

    def unwindow(kv):
        # trim each window's overlap, then the row's right pad
        return kv.reshape(b, nwin, W)[:, :, ov:].reshape(b, nwin * own)[:, :n]

    relpos = torch.arange(W, dtype=torch.int64, device=dev)
    key = _as_i32((windows(h, 1 << hb) << pbits) | relpos).contiguous()
    return key, _as_i32(windows(ctx, 0)).contiguous(), pbits, unwindow


def _full_row_search(data: torch.Tensor, lengths: torch.Tensor, *, n: int,
                     min_match: int, window: int, ctx_words: int,
                     probes: int):
    """The candidate search over whole rows longer than MAX_WINDOW: the
    JAX package's lax.sort route (``qatzip_tpu/ops/lz77.py:252-257,
    281-343, 368-380``) in plain torch.

    Each row's keys (hash << pbits) | pos (pbits = 16, hb = 15 at n =
    65536) are sorted as int64 (unique keys, so any sort gives the JAX
    order); the probes compare each sorted position with its ``probes``
    nearest predecessors in the same bucket on the context words, keep
    the longest match within ``window`` (the nearest on ties) as (ml <<
    15) | (0x7FFF - (dist - 1)), and a scatter takes the winners back to
    row order. Returns (ml, dist) (B, n) int32; dist is 32768 where
    nothing matched, as in the JAX package."""
    ctx, h, pbits, _hb = _hashed_context(data, lengths, n=n,
                                         min_match=min_match,
                                         ctx_words=ctx_words, width=n)
    iota = torch.arange(n, dtype=torch.int64, device=data.device)
    key_s, pos_s = torch.sort((h << pbits) | iota, dim=1)
    h_s = key_s >> pbits
    del key_s, h
    # the context words as int32 bit patterns: XOR and the zero tests
    # give the same answers, at half the bytes
    ctx_s = [torch.gather(_as_i32(c), 1, pos_s) for c in ctx]
    del ctx
    dmask = 0x7FFF
    cand = torch.zeros(pos_s.shape, dtype=torch.int32, device=data.device)
    for d in range(1, min(probes, n - 1) + 1):
        same = h_s[:, d:] == h_s[:, :-d]
        dist = pos_s[:, d:] - pos_s[:, :-d]
        # a prefix of word 0 never reaches min_match (>= 4): whole words
        alive = same & ((ctx_s[0][:, d:] ^ ctx_s[0][:, :-d]) == 0)
        ml = torch.where(alive, 4, 0).to(torch.int32)
        for c in ctx_s[1:]:
            x = c[:, d:] ^ c[:, :-d]
            full = (x == 0) & alive
            partial = (((x & 0xFF) == 0).to(torch.int32)
                       + ((x & 0xFFFF) == 0).to(torch.int32)
                       + ((x & 0xFFFFFF) == 0).to(torch.int32))
            ml = ml + torch.where(full, 4, torch.where(alive, partial, 0))
            alive = full
        ok = same & (dist >= 1) & (dist <= window) & (ml >= min_match)
        pk = (ml << 15) | (dmask - (dist - 1)).to(torch.int32)
        cand[:, d:] = torch.maximum(cand[:, d:], torch.where(ok, pk, 0))
    out = torch.empty_like(cand)
    out.scatter_(1, pos_s, cand ^ dmask)
    return out >> 15, (out & dmask) + 1


def _extend_matches(p: torch.Tensor, *, cap0: int, max_match: int,
                    min_match: int, n: int) -> torch.Tensor:
    """Saturation-doubling extension over a packed (ml << 16 | dist-1)
    plane: a match saturated at length ``cap`` whose continuation holds a
    same-distance match chains to cap + ml[cont]."""
    cap = cap0
    while cap < max_match and cap < n:
        np_ = _shl(p, cap, 0)
        nml = np_ >> 16
        cont = (((p >> 16) == cap) & (((np_ ^ p) & 0xFFFF) == 0)
                & (nml >= min_match))
        ext = torch.clamp(cap + nml, max=max_match)
        p = torch.where(cont, (ext << 16) | (p & 0xFFFF), p)
        cap *= 2
    return p


def _parse_inputs(lengths, ml, dist, *, n, min_match, max_match, ctx_bytes,
                  parse_seg, lz4_rules: bool = False):
    """Extension, lazy demotion, parse-segment trimming and, with
    ``lz4_rules``, the LZ4 block end rules (no match starts within the
    last 12 bytes, the last 5 are literals: the demotions the host
    ``lz4_pack`` makes token by token) of the raw candidates. Returns
    (is_match, ml, dist, seg), the parse's inputs."""
    iota = torch.arange(n, dtype=torch.int32, device=ml.device)
    p = (ml << 16) | (dist - 1)
    p = _extend_matches(p, cap0=ctx_bytes, max_match=max_match,
                        min_match=min_match, n=n)
    ml = p >> 16
    dist = (p & 0xFFFF) + 1

    ml = torch.minimum(ml, lengths[:, None] - iota)
    is_match = ml >= min_match
    ml = torch.where(is_match, ml, 0)

    # lazy matching: when the next position holds a strictly longer
    # match, emit this one as a literal
    is_match = is_match & ~(_shl(ml, 1, 0) > ml)
    ml = torch.where(is_match, ml, 0)

    # trim matches at parse-segment boundaries so segments parse alone
    seg = min(parse_seg, n)
    ml = torch.minimum(ml, seg - (iota % seg))
    is_match = is_match & (ml >= min_match)
    ml = torch.where(is_match, ml, 0)

    if lz4_rules:
        ml = torch.minimum(ml, lengths[:, None] - 5 - iota)
        is_match = (is_match & (iota <= lengths[:, None] - 12)
                    & (ml >= min_match))
        ml = torch.where(is_match, ml, 0)
    return is_match.contiguous(), ml.contiguous(), dist, seg


def _candidates(data, lengths, *, n, min_match, window, ctx_words, probes,
                search_seg, search_overlap):
    """The raw candidates (ml, dist), (B, n) int32: the full-row search
    for whole rows over MAX_WINDOW, else the kernel's windows."""
    if not 0 < search_seg < n and n > MAX_WINDOW:
        return _full_row_search(data, lengths, n=n, min_match=min_match,
                                window=window, ctx_words=ctx_words,
                                probes=probes)
    key, ctx, pbits, unwindow = _search_inputs(
        data, lengths, n=n, min_match=min_match, window=window,
        ctx_words=ctx_words, search_seg=search_seg,
        search_overlap=search_overlap)
    kv = unwindow(candidate_search(key, ctx, probes=probes,
                                   min_match=min_match, pbits=pbits))
    return (kv >> 13) & 0x1F, (kv & 0x1FFF) + 1


def _analyze(data: torch.Tensor, lengths: torch.Tensor, *, n: int,
             min_match: int, max_match: int, window: int, parse_seg: int,
             ctx_words: int, probes: int, search_seg: int = 0,
             search_overlap: int = 1024, lz4_rules: bool = False):
    """Match finding + greedy parse. Returns dense (B, n) planes: iota,
    ml, dist, taken, lit, valid. Where no candidate matched, ``dist`` is
    1 after the kernel's search and 32768 after the full-row search (the
    JAX sort route leaves other values there; every consumer reads dist
    only where ml > 0)."""
    lengths = lengths.to(torch.int32)
    ml, dist = _candidates(data, lengths, n=n, min_match=min_match,
                           window=window, ctx_words=ctx_words, probes=probes,
                           search_seg=search_seg,
                           search_overlap=search_overlap)
    is_match, ml, dist, seg = _parse_inputs(
        lengths, ml, dist, n=n, min_match=min_match, max_match=max_match,
        ctx_bytes=4 * ctx_words, parse_seg=parse_seg, lz4_rules=lz4_rules)
    taken, lit = parse_scan(is_match, ml, seg)
    iota = torch.arange(n, dtype=torch.int32, device=data.device)
    valid = iota < lengths[:, None]
    return iota.expand_as(ml), ml, dist, taken, lit & valid, valid


def lz77_tokenize(data: torch.Tensor, lengths: torch.Tensor, *, n: int,
                  min_match: int = 4, max_match: int = 258,
                  window: int = 32768, parse_seg: int = 8192,
                  ctx_words: int = 4, probes: int = 6, search_seg: int = 0,
                  search_overlap: int = 1024, compact_seg: int = 0,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tokenize a batch of chunks on ``data.device``.

    Args:
      data: (B, n) uint8, zero-padded beyond per-row ``lengths``.
      lengths: (B,) int32 valid byte count per row.
      n: row capacity (power of two, <= 65536).
      window: max backward distance; must cover the search window.

    Returns:
      tokens: (B, n) int32 packed tokens (uint32 bit patterns), compacted
              to each row's prefix in position order, or to each
              ``compact_seg`` segment's prefix when compact_seg > 0.
      ntok:   (B,) int32 token count per row, or (B, n / compact_seg).
    """
    iota, ml, dist, taken, lit, valid = _analyze(
        data, lengths, n=n, min_match=min_match, max_match=max_match,
        window=window, parse_seg=parse_seg, ctx_words=ctx_words,
        probes=probes, search_seg=search_seg, search_overlap=search_overlap)
    b = data.shape[0]

    # literal runs over the post-parse literal mask: lr[p] = forward run
    # length from p by saturation doubling, exact up to RUN_SPLIT
    lr = lit.to(torch.int16)
    for k in range(RUN_SPLIT.bit_length()):
        span = 1 << k
        nlr = torch.where(iota + span < n, torch.roll(lr, -span, 1), 0)
        lr = torch.where(lr == span, lr + nlr, lr)
    lr = lr.to(torch.int32)

    # run tokens at run starts and at RUN_SPLIT-aligned positions inside
    # a run; lengths stop at the next boundary
    prev_lit = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                      device=lit.device), lit[:, :-1]], dim=1)
    at_split = (iota & (RUN_SPLIT - 1)) == 0
    runstart = lit & (~prev_lit | at_split)
    span_left = RUN_SPLIT - (iota & (RUN_SPLIT - 1))
    run_tok = TOK_LITRUN_BIT | torch.minimum(lr, span_left)
    match_tok = TOK_MATCH_BIT | (ml << 16) | (dist - 1)
    emit = taken | runstart
    tok = torch.where(taken, match_tok, torch.where(runstart, run_tok, 0))

    # compaction: emitted tokens move to each row's (or compaction
    # segment's) prefix in position order; the rest are zeros
    cs = compact_seg if 0 < compact_seg < n else n
    ncs = n // cs
    key = (iota % cs) | ((~emit).to(torch.int32) << 17)
    order = torch.sort(key.reshape(b * ncs, cs), dim=1).indices
    tokens = torch.gather(tok.reshape(b * ncs, cs), 1, order).reshape(b, n)
    ntok = emit.reshape(b, ncs, cs).sum(dim=2, dtype=torch.int32)
    if cs == n:
        ntok = ntok.reshape(b)
    return tokens, ntok


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------

def merge_segment_tokens(tokens_row: np.ndarray, ntok_row,
                         parse_seg: int = 8192) -> np.ndarray:
    """One row's token stream from its per-segment compacted prefixes."""
    segs = np.atleast_1d(np.asarray(ntok_row)).ravel()
    tokens_row = np.asarray(tokens_row)
    if segs.size == 1:
        return tokens_row[: int(segs[0])]
    parts = [tokens_row[s * parse_seg: s * parse_seg + int(c)]
             for s, c in enumerate(segs) if int(c) > 0]
    if not parts:
        return np.zeros(0, np.uint32)
    return np.concatenate(parts)


def tokens_to_bytes(tokens: np.ndarray, ntok: int, src: bytes = b"") -> bytes:
    """Rebuild the chunk from packed tokens; ``src`` supplies the bytes of
    literal runs."""
    out = bytearray()
    for t in np.asarray(tokens[:ntok]).view(np.uint32):
        t = int(t)
        if t & 0x80000000:
            ml = (t >> 16) & 0x7FFF
            start = len(out) - ((t & 0xFFFF) + 1)
            if start < 0:
                raise ValueError("bad token distance")
            for k in range(ml):
                out.append(out[start + k])
        elif t & 0x40000000:
            run = t & 0x3FFF
            pos = len(out)
            if pos + run > len(src):
                raise ValueError("literal run past end of source")
            out += src[pos:pos + run]
        else:
            out.append(t & 0xFF)
    return bytes(out)
