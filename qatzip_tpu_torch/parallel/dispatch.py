"""The device chunk engine: tokenize on the device, pack on the device or
the host.

Counterpart of ``qatzip_tpu/parallel/dispatch.py`` on one device. The
dispatch layer (codec.py) fans a request into ``hw_buff_sz`` chunks; the
engine stages them in tiles of up to TILE_B rows and takes one of three
paths, as ``CudaEngine.packs_on_device`` picks them:

  * the full-device DEFLATE pack (every static session; dynamic sessions
    on a CUDA device): the device tokenizes (ops/lz77.py) and also
    entropy-packs (ops/deflate_pack.py, with the kernels of TPU kernels
    k1, k3 and k4); the engine fetches final deflate words, rounded to a
    bucket, and the host only frames them. Dynamic sessions take two
    device passes around a host tree build per chunk
    (``native.dyn_plan``), with one tile of lookahead;
  * the full-device LZ4 pack (ops/lz4_pack.py, LZ4 sessions on a CUDA
    device): the device parses and packs final block bytes; the rows
    that are not ``ok`` (a literal run over 270) are coded again on the
    host;
  * the token path (dynamic deflate and LZ4 sessions on the CPU, every
    LZ4s session): the device tokenizes every tile, the engine fetches
    each tile's token counts and the used token prefix, rounded to a
    bucket, and the host C++ packer (deflate, LZ4 or LZ4s) packs every
    chunk on the host pool while the device works on later tiles.

Chunks over 64 KiB (``hw_buff_sz`` up to 512 KiB) are cut into rows of
at most 64 KiB, the tokenizer's reach: the rows of a deflate chunk take
the same route, only its last row carries the chunk's final flag (the
others end with the full-flush sync), and their payloads are joined into
one raw stream. LZ4 and LZ4s blocks cannot be joined, so such chunks go
to the host coder, as in the JAX package.

Results return as (payload, crc32) per chunk in submission order. Each
chunk's crc32 comes from the host pool, or, where ``crc_on_device``
says so, for every full row from ``crc32_batch_device`` on the tile
already on the device (a ragged row's from the host). A crc is the same
number wherever it is taken, so no byte of any path depends on the
choice.

``decompress_chunks`` decodes independent LZ4 blocks: on the device
(a host parse into a reference plane, the chains resolved by the kernel
``lz4_resolve_refs``, ops/lz4_decode.py) where ``decodes_on_device``
says so, else on the host pool. On ``device="cpu"`` the same code runs
the kernels' plain versions.

Over several devices (``build_engine`` of a tuple of two or more, the
runtime's ``device="cuda"`` on a machine with several cards, or a list
such as ``["cuda:0", "cuda:1"]``) a ``MeshEngine`` deals each request's
rows over one ``CudaEngine`` a device (``parallel/mesh.py``): device d
takes the d-th contiguous block of the rows, all devices at once, each
on the route its engine picks, with the row width ``n`` and the
tokenizer's knobs taken from the whole request. Rows are independent,
so the engine over k devices gives the one-device engine's bytes on
every route, for every k. One device gets a ``CudaEngine`` itself.

Compress-and-verify (``compress_chunks(..., cnv=True)``, the reference's
CnV, src/qatzip.c:1774-1806) decodes every payload on the host pool after
the step that made it and compares it with the chunk
(``verify_or_fallback``): deflate with stock zlib, LZ4 with the native
LZ4 decoder; LZ4s blocks pass unverified, as in the JAX package. It
verifies after the host packer on the token path, after the stored-block
guard on the deflate device packs, after the device bytes (or the host
recoding) on the LZ4 device pack, and each joined chunk of the row split
(whose rows are compressed without it). A chunk that fails is coded
again on the host: on the token path, the deflate device packs and the
row split by ``HostEngine`` with stock zlib (``sw_coder="zlib"``; for
LZ4 its block coder at a 32 KiB window), on the LZ4 device pack by the
native LZ4 block coder at its 65535-byte window, each as the JAX package
does. The failure is logged (``qz_log``) and counted (``cnv_fallback``
in ``utils.debug.get_counters``); no crc changes, and a payload that
verifies is returned as it was. Over several devices each device
verifies its share, so the bytes stay the one-device engine's.

Left out on purpose: the multi-tile scan grouping.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.checksum import crc32
from ..ops.crc32_mxu import crc32_batch_device
from ..ops.deflate_pack import (deflate_analyze_hist, deflate_pack_device,
                                deflate_pack_dynamic, finish_stream,
                                finish_stream_dynamic)
from ..ops.lz4_decode import decode_blocks_device
from ..ops.lz4_pack import lz4_pack_device
from ..ops.lz77 import lz77_tokenize, merge_segment_tokens
from ..runtime import check_not_forked
from ..utils.debug import get_counters, qz_log
from ..utils.trace import span

# chunks per device dispatch
TILE_B = 256
# the tokenizer's 16-bit position field caps a row at 64 KiB
DEV_MAX = 65536


def _bucket(b: int) -> int:
    p = 1
    while p < b:
        p <<= 1
    return min(p, TILE_B)


def _pow2_chunk_n(chunks) -> int:
    """Smallest power-of-two row capacity covering every chunk (>=256)."""
    n = 1
    for c in chunks:
        while n < len(c):
            n <<= 1
    return max(n, 256)


def row_width(chunks) -> int:
    """The row capacity the engine gives ``chunks``: ``_pow2_chunk_n``,
    or DEV_MAX where longer chunks are cut into rows. The tokenizer's
    knobs follow it (``_tok_knobs``)."""
    return min(_pow2_chunk_n(chunks), DEV_MAX)


def _stage_tile(tile, b: int, n: int):
    """Zero-padded (b, n) staging batch + per-row lengths for one tile."""
    data = np.zeros((b, n), np.uint8)
    lengths = np.zeros(b, np.int32)
    for i, c in enumerate(tile):
        a = np.frombuffer(c, np.uint8)
        data[i, :len(a)] = a
        lengths[i] = len(a)
    return data, lengths


def _fetch_bucket(maxv: int, cap: int) -> int:
    """Power-of-two fetch width (min 256)."""
    k = 256
    while k < maxv:
        k <<= 1
    return min(k, cap)


def _tok_knobs(level: int, n: int):
    """Per-level tokenizer knobs: (search_seg, search_overlap,
    compact_seg, ctx_words, probes), the JAX package's defaults.

    Levels <= 5 window the candidate search (8K windows, 896 overlap)
    and carry 12 bytes of context with 7 probes; levels >= 6 keep the
    full-row search with 16-byte context. Small chunks (n <= 8192)
    search their whole row with ctx 4 / probes 6; rows of at most 512
    are not compacted in segments (compact_seg 0). No environment
    variable changes them."""
    fast = level <= 5
    ss = 8192 if fast and 8192 < n else 0
    ov = 896 if fast else 1024
    ctx = 3 if ss else 4
    probes = 7 if ss else 6
    cs = 512 if 512 < n else 0
    return ss, ov, cs, ctx, probes


def _tok_params(algorithm: str):
    """The tokenizer's match limits per algorithm: deflate's, and for LZ4
    and LZ4s a 32 KiB window (the reference's windowSize 7) with matches
    up to the token's 15-bit length field."""
    if algorithm == "deflate":
        return dict(min_match=4, max_match=258, window=32768)
    return dict(min_match=4, max_match=32767, window=32768)


def _decodes_to(chunk: bytes, payload: bytes, algorithm: str) -> bool:
    """Whether ``payload`` decodes to ``chunk``: deflate with stock zlib
    (a raw stream), LZ4 with the native block decoder; a decode error is
    a mismatch."""
    from .. import native
    try:
        if algorithm == "deflate":
            out = zlib.decompressobj(-15).decompress(payload)
        else:
            out = native.get_lib().lz4_decompress_block(payload, len(chunk))
    except Exception:  # noqa: BLE001 - any decode error is a mismatch
        return False
    return out == chunk


def _count_fallback(chunk: bytes, algorithm: str, coder: str) -> None:
    get_counters().bump("cnv_fallback", 1, len(chunk))
    qz_log("CnV mismatch: %s fallback (%s) for a %d-byte chunk", algorithm,
           coder, len(chunk))


def verify_or_fallback(chunk: bytes, payload: bytes, algorithm: str,
                       final: bool, level: int, mini_match: int) -> bytes:
    """Compress-and-verify one chunk: ``payload`` if it decodes to
    ``chunk`` (LZ4s passes unverified), else the chunk coded again by the
    host engine with stock zlib (``sw_coder="zlib"``; LZ4 by its block
    coder at a 32 KiB window), never by the packer whose output just
    failed. Counterpart of the JAX engine's ``_verify_or_fallback``."""
    if algorithm == "lz4s" or _decodes_to(chunk, payload, algorithm):
        return payload
    _count_fallback(chunk, algorithm, "host engine, stock zlib")
    from ..engines import host_engine
    (fb, _), = host_engine.compress_chunks(
        [chunk], level=level, algorithm=algorithm, final_flags=[final],
        mini_match=mini_match, sw_coder="zlib")
    return fb


def verify_lz4_device(chunk: bytes, payload: bytes) -> bytes:
    """Compress-and-verify one chunk of the LZ4 device pack: ``payload``
    if the native LZ4 decoder gives back ``chunk``, else the native block
    coder's block at its default 65535-byte window (as the JAX package's
    LZ4 device pack does; the token path's fallback,
    ``verify_or_fallback``, takes the host engine's 32 KiB window)."""
    from .. import native
    if _decodes_to(chunk, payload, "lz4"):
        return payload
    _count_fallback(chunk, "lz4", "native LZ4 block coder")
    return native.get_lib().lz4_compress_block(chunk)


class _ChunkEngine:
    """What an engine over one device and one over several share: the
    request's row width, and the cut of chunks over DEV_MAX into rows.
    A subclass gives ``compress_rows``."""

    def compress_chunks(self, chunks: Sequence[bytes], *, level: int,
                        algorithm: str = "deflate",
                        final_flags: Optional[Sequence[bool]] = None,
                        mini_match: int = 3, huffman_static: bool = False,
                        cnv: bool = False) -> List[Tuple[bytes, int]]:
        """Compress each chunk to an independent payload + its crc32, on
        the route ``packs_on_device`` picks: a raw deflate stream, or one
        LZ4 or LZ4s block. On the token path the deflate host packer runs
        mode 1 (static Huffman) for static sessions, mode 0 (best of
        stored/static/dynamic) otherwise. ``cnv`` verifies every payload
        and codes a chunk that fails again on the host (the module's
        docstring). In a child forked after CUDA came up, an engine on a
        CUDA device raises QZ_NOSW_NO_HW (``runtime.check_not_forked``)."""
        if algorithm not in ("deflate", "lz4", "lz4s"):
            raise ValueError(f"unknown algorithm {algorithm}")
        check_not_forked(self.devices)
        finals = (list(final_flags) if final_flags is not None
                  else [True] * len(chunks))
        if any(len(c) > DEV_MAX for c in chunks):
            return self._compress_split(chunks, finals, level, algorithm,
                                        mini_match, huffman_static, cnv)
        return self.compress_rows(chunks, finals, _pow2_chunk_n(chunks),
                                  level=level, algorithm=algorithm,
                                  mini_match=mini_match,
                                  huffman_static=huffman_static, cnv=cnv)

    def _compress_split(self, chunks, finals, level: int, algorithm: str,
                        mini_match: int, huffman_static: bool,
                        cnv: bool = False):
        """Chunks over DEV_MAX: each deflate chunk cut into rows of at most
        DEV_MAX bytes, the rows compressed on the session's route with
        only the chunk's last row final, and each chunk's row payloads
        joined; with ``cnv`` the rows are compressed without it and each
        joined chunk is verified on the host pool. LZ4 and LZ4s chunks go
        to the host coder whole, unverified."""
        if algorithm != "deflate":
            from ..engines import host_engine
            return host_engine.compress_chunks(
                chunks, level=level, algorithm=algorithm, final_flags=finals,
                mini_match=mini_match, huffman_static=huffman_static)
        rows, row_finals, counts = [], [], []
        for chunk, final in zip(chunks, finals):
            pieces = [chunk[o:o + DEV_MAX]
                      for o in range(0, len(chunk), DEV_MAX)] or [b""]
            rows += pieces
            row_finals += [False] * (len(pieces) - 1) + [final]
            counts.append(len(pieces))
        done = iter(self.compress_chunks(
            rows, level=level, algorithm=algorithm, final_flags=row_finals,
            mini_match=mini_match, huffman_static=huffman_static))
        joined = [b"".join(next(done)[0] for _ in range(cnt))
                  for cnt in counts]
        if cnv:
            from ..engines import host_pool
            joined = list(host_pool().map(
                lambda a: verify_or_fallback(a[0], a[1], algorithm, a[2],
                                             level, mini_match),
                zip(chunks, joined, finals)))
        return [(payload, crc32(chunk))
                for chunk, payload in zip(chunks, joined)]


class CudaEngine(_ChunkEngine):
    """Chunk-batch engine on one torch device ("cuda:i" or "cpu")."""

    name = "cuda"

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.devices = (self.device,)

    def _tokenize_tiles(self, chunks: Sequence[bytes], n: int, level: int,
                        algorithm: str = "deflate"):
        """Yield (tile_start, tile_len, tokens uint32, ntok, crcs) per
        tile (``crcs``: see ``_host_crcs``).

        Every tile is dispatched first; the fetch is two-phase: ntok, then
        only the used token prefix, rounded to a bucket. With compact_seg
        the tokens come back as (b, nseg, k) segment prefixes plus (b,
        nseg) counts, joined by merge_segment_tokens in the pack stage."""
        ss, ov, cs, ctx, probes = _tok_knobs(level, n)
        kw = dict(parse_seg=min(8192, n), search_seg=ss, search_overlap=ov,
                  compact_seg=cs, ctx_words=ctx, probes=probes,
                  **_tok_params(algorithm))
        pending = []
        for start in range(0, len(chunks), TILE_B):
            tile = chunks[start:start + TILE_B]
            dd, ll, lengths = self._upload_tile(tile, n)
            toks, ntok = lz77_tokenize(dd, ll, n=n, **kw)
            pending.append((start, len(tile), toks, ntok,
                            self._tile_crcs(dd, lengths, n)))
        for start, nt, toks, ntok, dcrc in pending:
            with span("fetch") as sp:
                ntok_np = ntok.cpu().numpy()
                if ntok_np.ndim == 2:
                    # segment-compacted: fetch each segment's used prefix,
                    # or the whole row when a dense segment makes that
                    # larger
                    b_, ncs = ntok_np.shape
                    cseg = n // ncs
                    k = _fetch_bucket(int(ntok_np.max()), cseg)
                    sl = toks.reshape(b_, ncs, cseg)
                    if k * ncs < n:
                        sl = sl[:, :, :k]
                else:
                    sl = toks[:, :_fetch_bucket(int(ntok_np.max()), n)]
                toks_np = sl.cpu().numpy().view(np.uint32)
                crcs = _host_crcs(dcrc)
                sp.add(d2h_bytes=_nbytes(ntok_np, toks_np, crcs))
            yield start, nt, toks_np, ntok_np, crcs

    def _upload_tile(self, tile: Sequence[bytes], n: int):
        """A tile staged into a zero-padded (bucket, n) batch and copied
        to the device: (data, lengths) on the device, the host lengths."""
        b = _bucket(len(tile))
        with span("upload", h2d_bytes=b * (n + 4)):
            data, lengths = _stage_tile(tile, b, n)
            return (torch.from_numpy(data).to(self.device),
                    torch.from_numpy(lengths).to(self.device), lengths)

    def packs_on_device(self, huffman_static: bool,
                        algorithm: str = "deflate") -> bool:
        """Whether a session's chunks take the full-device pack.

        Deflate: static sessions always do, as in the JAX package. Dynamic
        sessions do on a CUDA device: there the host packer bounds the
        token path, and on an H100 with 8 host cores the device pack
        compressed a 64 MiB request 1.3-1.9x as fast at the same ratio
        (chip_smoke.py's "path" lines, PERF.md). On the CPU neither route
        won every run, and the token path keeps the JAX package's default
        bytes.

        LZ4 sessions do on a CUDA device: on an H100 with 8 host cores the
        LZ4 device pack compressed a 64 MiB request at 0.18-0.22 GB/s
        against the token path's 0.10-0.14 in each of six chip_smoke.py
        runs, at a better ratio (1.8615 against 1.7839; PERF.md). On the
        CPU they take the token path, the JAX package's default. LZ4s
        always takes the token path, as in the JAX package."""
        if algorithm == "lz4s":
            return False
        return ((algorithm == "deflate" and huffman_static)
                or self.device.type == "cuda")

    def crc_on_device(self) -> bool:
        """Whether full rows take their crc32 from the device
        (``crc32_batch_device`` on the staged tile) instead of the host
        pool.

        On a CUDA device they do: on an NVIDIA H100 80GB HBM3 at 700.00 W
        with 8 host cores, the kernel ``crc32_rows`` took 0.0126 ms of
        device time for a tile of 256 x 64 KiB (0.0161-0.0238 ms with its
        wrapper), where the host crc32 of the same rows on the host pool
        took 14.5-16.3 ms, in two chip_smoke.py runs of one call (PERF.md
        section 6); a 64 MiB request's warm GB/s
        with either crc stayed within its run-to-run noise (PERF.md). On
        the CPU the host takes every crc, the JAX package's default. The
        bytes are the same either way."""
        return self.device.type == "cuda"

    def decodes_on_device(self) -> bool:
        """Whether LZ4 blocks decode on the device leg
        (``ops/lz4_decode.py``) instead of the host pool.

        They do not: on an NVIDIA H100 80GB HBM3 at 700.00 W with 8 host
        cores, the LZ4 session's 64 MiB frame (896 coded blocks) decoded
        at 0.8611-0.8720 GB/s warm on the host leg against 0.2467-0.3506
        on the device leg in each of two chip_smoke.py runs: the device
        leg's host parse into reference planes alone took 78-108 ms, and
        its device work (h2d of the planes, ``lz4_resolve_refs``, d2h)
        5.5-6.1 ms (PERF.md). The device leg stays reachable by holding
        this route, as the tests and chip_smoke.py do. On the CPU the
        host decodes, the JAX package's default."""
        return False

    def _tile_crcs(self, dd: torch.Tensor, lengths: np.ndarray, n: int):
        """A staged tile's device crcs where ``crc_on_device`` says so:
        (the (b,) crcs on the device, host mask of the full rows), else
        None."""
        if not self.crc_on_device():
            return None
        return crc32_batch_device(dd, n=n), lengths == n

    def decompress_chunks(self, payloads: Sequence[bytes],
                          expected_sizes: Sequence[int], *,
                          algorithm: str) -> List[bytes]:
        """Decode independent LZ4 blocks, in order, each of at most its
        expected size: on this engine's device where ``decodes_on_device``
        says so, else on the host pool (``HostEngine.decompress_chunks``,
        which takes LZ4 only: the codec inflates deflate members itself,
        on the host, as the JAX package does). A malformed block raises
        QZ_DATA_ERROR on either leg."""
        if algorithm == "lz4" and self.decodes_on_device():
            return decode_blocks_device(payloads, expected_sizes,
                                        device=self.device)
        from ..engines import host_engine
        return host_engine.decompress_chunks(payloads, expected_sizes,
                                             algorithm=algorithm)

    def compress_rows(self, chunks: Sequence[bytes], finals: Sequence[bool],
                      n: int, *, level: int, algorithm: str, mini_match: int,
                      huffman_static: bool, cnv: bool = False
                      ) -> List[Tuple[bytes, int]]:
        """``compress_chunks`` for chunks of at most ``n`` <= DEV_MAX
        bytes at row width ``n``, which sets the tokenizer's knobs: the
        caller takes it from the whole request (a ``MeshEngine`` gives
        each device's share the request's width)."""
        if self.packs_on_device(huffman_static, algorithm):
            if algorithm == "lz4":
                return self._finish_lz4(chunks, self._fetch_lz4(
                    self._lz4_device_pack(chunks, n)), cnv=cnv)
            items = self._device_pack(chunks, n, level, not huffman_static)
            return self._finish(chunks, finals, self._fetch_words(items),
                                level=level, cnv=cnv)
        return self._pack(chunks, finals, 1 if huffman_static else 0,
                          self._tokenize_tiles(chunks, n, level, algorithm),
                          algorithm, mini_match, level=level, cnv=cnv)

    def _pack(self, chunks, finals, mode: int, tiles,
              algorithm: str = "deflate", mini_match: int = 3, *,
              level: int = 1, cnv: bool = False):
        """Pack every chunk of ``tiles`` (as _tokenize_tiles yields them)
        with the host packer of ``algorithm`` on the host pool, in
        submission order; with ``cnv`` each payload is verified there,
        after its packer (``verify_or_fallback``)."""
        from .. import native
        from ..engines import host_pool
        lib = native.get_lib()

        def pack_one(args):
            gi, row_toks, row_ntok, dcrc = args
            chunk = chunks[gi]
            if np.ndim(row_ntok) > 0:       # segment-compacted (nseg, k)
                toks = merge_segment_tokens(row_toks.ravel(), row_ntok,
                                            row_toks.shape[-1])
            else:
                toks = row_toks[:int(row_ntok)]
            if algorithm == "lz4":
                payload = lib.lz4_pack(chunk, toks, len(toks))
            elif algorithm == "lz4s":
                payload = lib.lz4s_pack(chunk, toks, len(toks), mini_match)
            else:
                payload = lib.deflate_pack(chunk, toks, len(toks),
                                           final=finals[gi], mode=mode)
            if cnv:
                payload = verify_or_fallback(chunk, payload, algorithm,
                                             finals[gi], level, mini_match)
            return payload, lib.crc32(chunk) if dcrc < 0 else dcrc

        pool = host_pool()
        futures = [pool.submit(pack_one, (start + i, toks[i], ntok[i],
                                          _row_crc(crcs, i)))
                   for start, nt, toks, ntok, crcs in tiles
                   for i in range(nt)]
        with span("pool_wait"):
            return [f.result() for f in futures]

    # -- the full-device DEFLATE pack ---------------------------------------

    def _device_pack(self, chunks: Sequence[bytes], n: int, level: int,
                     dynamic: bool):
        """Dispatch every tile's device pack. Returns one (tile_start,
        tile_len, words, nbits, hdrs, packs, dcrc) per tile: device words
        and bit counts, for dynamic tiles each chunk's header bytes and
        lit/len table (its EOB code), and the tile's device crcs
        (``_tile_crcs``). Dynamic tiles run pass 1 one tile
        ahead of pass 2, so the host builds tile k's trees while the
        device analyzes tile k + 1, and at most two tiles' planes are
        held at a time."""
        with span("device_pack"):
            ss, ov, _cs, ctx, probes = _tok_knobs(level, n)
            pkw = dict(parse_seg=8192, search_seg=ss, search_overlap=ov,
                       ctx_words=ctx, probes=probes)
            items, ahead = [], None
            for start in range(0, len(chunks), TILE_B):
                tile = chunks[start:start + TILE_B]
                dd, ll, lengths = self._upload_tile(tile, n)
                dcrc = self._tile_crcs(dd, lengths, n)
                if not dynamic:
                    words, nbits = deflate_pack_device(dd, ll, n=n, **pkw)
                    items.append((start, len(tile), words, nbits, None, None,
                                  dcrc))
                    continue
                hist, *planes = deflate_analyze_hist(dd, ll, n=n, **pkw)
                cur = (start, len(tile), dd, planes, _to_host(hist), dcrc)
                if ahead is not None:
                    items.append(self._dyn_pass2(n, *ahead))
                ahead = cur
            if ahead is not None:
                items.append(self._dyn_pass2(n, *ahead))
            return items

    def _dyn_pass2(self, n, start, nt, dd, planes, hist, dcrc):
        """Dynamic pass 2 for one tile: wait for its histograms, build each
        chunk's trees and header on the host, dispatch the pack."""
        hist_np, ready = hist
        if ready is not None:
            with span("hist_wait"):
                ready.synchronize()
        packs, dpacks, hdrs, hbits = plan_tile(hist_np.numpy(), nt)
        tables = (packs.astype(np.int32), dpacks.astype(np.int32), hbits)
        with span("upload", h2d_bytes=_nbytes(*tables)):
            tables = [torch.from_numpy(t).to(self.device) for t in tables]
        words, nbits = deflate_pack_dynamic(dd, *planes, *tables, n=n)
        return start, nt, words, nbits, hdrs, packs, dcrc

    @staticmethod
    def _fetch_words(items):
        """Yield each tile with its words fetched: the prefix that covers
        the longest row, rounded to a bucket (the dynamic nbits leaves out
        the <= 15-bit EOB, hence the pad)."""
        for start, nt, words, nbits, hdrs, packs, dcrc in items:
            with span("fetch") as sp:
                nbits_np = nbits.cpu().numpy()
                maxw = int(nbits_np.max() + 15 + 31) // 32 + 1
                k = _fetch_bucket(maxw, words.shape[1])
                words_np = words[:, :k].cpu().numpy().view(np.uint32)
                crcs = _host_crcs(dcrc)
                sp.add(d2h_bytes=_nbytes(nbits_np, words_np, crcs))
            yield start, nt, words_np, nbits_np, hdrs, packs, crcs

    def _finish(self, chunks, finals, fetched, *, level: int = 1,
                cnv: bool = False):
        """Frame every fetched row on the host pool, in submission order:
        header and EOB for dynamic rows, BFINAL or the full-flush sync,
        the stored-block guard, with ``cnv`` the verify
        (``verify_or_fallback``), crc32."""
        with span("finish"):
            from .. import native
            from ..engines import host_pool
            lib = native.get_lib()

            def finish_one(args):
                gi, words_row, bits, hdr, eob_pack, dcrc = args
                chunk = chunks[gi]
                if hdr is not None:
                    payload = finish_stream_dynamic(words_row, bits, hdr,
                                                    eob_pack, final=finals[gi])
                else:
                    payload = finish_stream(words_row, bits, final=finals[gi])
                # stored-block guard: never ship an expanded stream; repack
                # the chunk as all-literal runs with the host packer's best
                # of stored/static/dynamic
                if len(payload) >= len(chunk) + 8 and chunk:
                    runs = [0x40000000 | min(16383, len(chunk) - o)
                            for o in range(0, len(chunk), 16383)]
                    payload = lib.deflate_pack(
                        chunk, np.asarray(runs, np.uint32), len(runs),
                        final=finals[gi], mode=0)
                if cnv:
                    payload = verify_or_fallback(chunk, payload, "deflate",
                                                 finals[gi], level, 3)
                return payload, lib.crc32(chunk) if dcrc < 0 else dcrc

            pool = host_pool()
            futures = [pool.submit(finish_one, (
                start + i, words_np[i], int(nbits_np[i]),
                hdrs[i] if hdrs is not None else None,
                int(packs[i][256]) if packs is not None else 0,
                _row_crc(crcs, i)))
                for start, nt, words_np, nbits_np, hdrs, packs, crcs
                in fetched
                for i in range(nt)]
            with span("pool_wait"):
                return [f.result() for f in futures]

    # -- the full-device LZ4 pack ---------------------------------------------

    def _lz4_device_pack(self, chunks: Sequence[bytes], n: int):
        """Dispatch every tile's LZ4 device pack. Returns one (tile_start,
        tile_len, words, nbytes, ok, dcrc) per tile, all on the device
        (``dcrc``: ``_tile_crcs``)."""
        with span("device_pack"):
            items = []
            for start in range(0, len(chunks), TILE_B):
                tile = chunks[start:start + TILE_B]
                dd, ll, lengths = self._upload_tile(tile, n)
                words, nbytes, ok = lz4_pack_device(dd, ll, n=n)
                items.append((start, len(tile), words, nbytes, ok,
                              self._tile_crcs(dd, lengths, n)))
            return items

    @staticmethod
    def _fetch_lz4(items):
        """Yield each tile with its block bytes fetched: the word prefix
        that covers the longest row, rounded to a bucket."""
        for start, nt, words, nbytes, ok, dcrc in items:
            with span("fetch") as sp:
                nb_np = nbytes.cpu().numpy()
                ok_np = ok.cpu().numpy()
                k = _fetch_bucket(int(nb_np.max() + 3) // 4 + 1,
                                  words.shape[1])
                words_np = words[:, :k].cpu().numpy().view(np.uint32)
                crcs = _host_crcs(dcrc)
                sp.add(d2h_bytes=_nbytes(nb_np, ok_np, words_np, crcs))
            yield start, nt, words_np, nb_np, ok_np, crcs

    def _finish_lz4(self, chunks, fetched, *, cnv: bool = False):
        """Each chunk's block on the host pool, in submission order: the
        device's bytes, or the host LZ4 coder's for a row that is not ok
        (or an empty chunk), counted as ``lz4_recoded`` of ``lz4_rows``
        on the ``finish`` span; with ``cnv`` the verify
        (``verify_lz4_device``); crc32."""
        with span("finish", lz4_rows=len(chunks)) as sp:
            from .. import native
            from ..engines import host_pool
            lib = native.get_lib()

            def finish_one(args):
                gi, words_row, nb, device_bytes, dcrc = args
                chunk = chunks[gi]
                if device_bytes:
                    payload = words_row[:(nb + 3) // 4].tobytes()[:nb]
                else:
                    payload = lib.lz4_compress_block(chunk)
                if cnv:
                    payload = verify_lz4_device(chunk, payload)
                return payload, lib.crc32(chunk) if dcrc < 0 else dcrc

            pool = host_pool()
            futures, recoded = [], 0
            for start, nt, words_np, nb_np, ok_np, crcs in fetched:
                for i in range(nt):
                    device_bytes = bool(ok_np[i] and chunks[start + i])
                    recoded += not device_bytes
                    futures.append(pool.submit(finish_one, (
                        start + i, words_np[i], int(nb_np[i]), device_bytes,
                        _row_crc(crcs, i))))
            sp.add(lz4_recoded=recoded)
            with span("pool_wait"):
                return [f.result() for f in futures]


def _host_crcs(dcrc):
    """A tile's device crcs (``CudaEngine._tile_crcs``) fetched: a numpy
    array with the crc of each full row and -1 where the host takes it;
    None where the host takes every crc."""
    if dcrc is None:
        return None
    crcs, full = dcrc
    return np.where(full, crcs.cpu().numpy(), -1)


def _nbytes(*arrays) -> int:
    """Bytes of the numpy arrays given (None counts 0)."""
    return sum(a.nbytes for a in arrays if a is not None)


def _row_crc(crcs, i: int) -> int:
    """Row ``i``'s device crc, or -1 when the host takes it."""
    return -1 if crcs is None else int(crcs[i])


def _to_host(t: torch.Tensor):
    """Start copying ``t`` to the host: (host tensor, event to wait on
    before reading it, or None when the copy is already done)."""
    if t.device.type != "cuda":
        return t.cpu(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def plan_tile(hist: np.ndarray, nt: int):
    """Each of the first ``nt`` chunks' dynamic plan (``native.dyn_plan``)
    from their (316,) histograms, the EOB counted. Returns (lit_pack (b,
    286) u16, dist_pack (b, 30) u16, header bytes per row, header bits
    (b,) int32); rows past ``nt`` keep empty tables."""
    from .. import native
    lib = native.get_lib()
    b = hist.shape[0]
    packs = np.zeros((b, 286), np.uint16)
    dpacks = np.zeros((b, 30), np.uint16)
    hdrs = [b""] * b
    hbits = np.zeros(b, np.int32)
    with span("dyn_plan"):
        for i in range(nt):
            lf = hist[i, :286].astype(np.uint32)
            lf[256] += 1
            packs[i], dpacks[i], hdrs[i], hbits[i] = lib.dyn_plan(
                lf, hist[i, 286:].astype(np.uint32))
    return packs, dpacks, hdrs, hbits


class MeshEngine(_ChunkEngine):
    """Chunk-batch engine over several torch devices (one may repeat):
    each request's rows dealt in contiguous blocks over one ``CudaEngine``
    a device, every device at once (``mesh.Mesh.map``), the results in
    submission order. The routes are the ``CudaEngine``'s, by device type
    (its predicates answer for the mesh); ``device`` is the first
    device."""

    name = "cuda-mesh"

    def __init__(self, devices: Sequence[torch.device]):
        from .mesh import Mesh
        self.mesh = Mesh(devices)
        self.devices = self.mesh.devices
        self.device = self.devices[0]
        self.engines = tuple(CudaEngine(d) for d in self.devices)

    def packs_on_device(self, huffman_static: bool,
                        algorithm: str = "deflate") -> bool:
        return self.engines[0].packs_on_device(huffman_static, algorithm)

    def crc_on_device(self) -> bool:
        return self.engines[0].crc_on_device()

    def decodes_on_device(self) -> bool:
        return self.engines[0].decodes_on_device()

    def _shares(self, count: int):
        """Each device's engine and contiguous block [lo, hi) of ``count``
        rows, in device order (a block may be empty)."""
        k = len(self.engines)
        cuts = [d * count // k for d in range(k + 1)]
        return list(zip(self.engines, cuts, cuts[1:]))

    def compress_rows(self, chunks, finals, n, *, level, algorithm,
                      mini_match, huffman_static, cnv=False):
        """Each device's block of rows through its engine's
        ``compress_rows`` at the request's row width ``n``, each share
        verified by its engine where ``cnv`` asks for it."""
        def share(_dev, item):
            eng, lo, hi = item
            if lo == hi:
                return []
            return eng.compress_rows(
                chunks[lo:hi], finals[lo:hi], n, level=level,
                algorithm=algorithm, mini_match=mini_match,
                huffman_static=huffman_static, cnv=cnv)
        parts = self.mesh.map(share, self._shares(len(chunks)))
        return [r for part in parts for r in part]

    def decompress_chunks(self, payloads, expected_sizes, *, algorithm):
        """``CudaEngine.decompress_chunks`` with the device leg's blocks
        dealt over the devices."""
        if not (algorithm == "lz4" and self.decodes_on_device()):
            return self.engines[0].decompress_chunks(
                payloads, expected_sizes, algorithm=algorithm)

        def share(dev, item):
            _eng, lo, hi = item
            if lo == hi:
                return []
            return decode_blocks_device(payloads[lo:hi],
                                        expected_sizes[lo:hi], device=dev)
        parts = self.mesh.map(share, self._shares(len(payloads)))
        return [r for part in parts for r in part]


def build_engine(device):
    """Factory used by the runtime's engine pool: a ``CudaEngine`` for one
    device, a ``MeshEngine`` for a sequence of two or more."""
    devs = ((device,) if isinstance(device, (str, torch.device))
            else tuple(device))
    if len(devs) == 1:
        return CudaEngine(devs[0])
    return MeshEngine(devs)
