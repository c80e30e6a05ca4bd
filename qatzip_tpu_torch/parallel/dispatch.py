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

Results return as (payload, crc32) per chunk in submission order. On
``device="cpu"`` the same code runs the kernels' plain versions.

Not ported yet: compress-and-verify, the multi-tile scan grouping, the
mesh, the device CRC and the device LZ4 decode.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.checksum import crc32
from ..ops.deflate_pack import (deflate_analyze_hist, deflate_pack_device,
                                deflate_pack_dynamic, finish_stream,
                                finish_stream_dynamic)
from ..ops.lz4_pack import lz4_pack_device
from ..ops.lz77 import lz77_tokenize, merge_segment_tokens

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


class CudaEngine:
    """Chunk-batch engine on one torch device ("cuda:i" or "cpu")."""

    name = "cuda"

    def __init__(self, device: torch.device):
        self.device = torch.device(device)

    def _tokenize_tiles(self, chunks: Sequence[bytes], n: int, level: int,
                        algorithm: str = "deflate"):
        """Yield (tile_start, tile_len, tokens uint32, ntok) per tile.

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
            data, lengths = _stage_tile(tile, _bucket(len(tile)), n)
            toks, ntok = lz77_tokenize(
                torch.from_numpy(data).to(self.device),
                torch.from_numpy(lengths).to(self.device), n=n, **kw)
            pending.append((start, len(tile), toks, ntok))
        for start, nt, toks, ntok in pending:
            ntok_np = ntok.cpu().numpy()
            if ntok_np.ndim == 2:
                # segment-compacted: fetch each segment's used prefix, or
                # the whole row when a dense segment makes that larger
                b_, ncs = ntok_np.shape
                cseg = n // ncs
                k = _fetch_bucket(int(ntok_np.max()), cseg)
                sl = toks.reshape(b_, ncs, cseg)
                if k * ncs < n:
                    sl = sl[:, :, :k]
            else:
                sl = toks[:, :_fetch_bucket(int(ntok_np.max()), n)]
            yield start, nt, sl.cpu().numpy().view(np.uint32), ntok_np

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

    def compress_chunks(self, chunks: Sequence[bytes], *, level: int,
                        algorithm: str = "deflate",
                        final_flags: Optional[Sequence[bool]] = None,
                        mini_match: int = 3, huffman_static: bool = False,
                        ) -> List[Tuple[bytes, int]]:
        """Compress each chunk to an independent payload + its crc32, on
        the route ``packs_on_device`` picks: a raw deflate stream, or one
        LZ4 or LZ4s block. On the token path the deflate host packer runs
        mode 1 (static Huffman) for static sessions, mode 0 (best of
        stored/static/dynamic) otherwise."""
        if algorithm not in ("deflate", "lz4", "lz4s"):
            raise ValueError(f"unknown algorithm {algorithm}")
        finals = (list(final_flags) if final_flags is not None
                  else [True] * len(chunks))
        if any(len(c) > DEV_MAX for c in chunks):
            return self._compress_split(chunks, finals, level, algorithm,
                                        mini_match, huffman_static)
        n = _pow2_chunk_n(chunks)
        if self.packs_on_device(huffman_static, algorithm):
            if algorithm == "lz4":
                return self._finish_lz4(chunks, self._fetch_lz4(
                    self._lz4_device_pack(chunks, n)))
            items = self._device_pack(chunks, n, level, not huffman_static)
            return self._finish(chunks, finals, self._fetch_words(items))
        return self._pack(chunks, finals, 1 if huffman_static else 0,
                          self._tokenize_tiles(chunks, n, level, algorithm),
                          algorithm, mini_match)

    def _compress_split(self, chunks, finals, level: int, algorithm: str,
                        mini_match: int, huffman_static: bool):
        """Chunks over DEV_MAX: each deflate chunk cut into rows of at most
        DEV_MAX bytes, the rows compressed on the session's route with
        only the chunk's last row final, and each chunk's row payloads
        joined. LZ4 and LZ4s chunks go to the host coder whole."""
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
        return [(b"".join(next(done)[0] for _ in range(cnt)), crc32(chunk))
                for chunk, cnt in zip(chunks, counts)]

    def _pack(self, chunks, finals, mode: int, tiles,
              algorithm: str = "deflate", mini_match: int = 3):
        """Pack every chunk of ``tiles`` (as _tokenize_tiles yields them)
        with the host packer of ``algorithm`` on the host pool, in
        submission order."""
        from .. import native
        from ..engines import host_pool
        lib = native.get_lib()

        def pack_one(args):
            gi, row_toks, row_ntok = args
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
            return payload, lib.crc32(chunk)

        pool = host_pool()
        futures = [pool.submit(pack_one, (start + i, toks[i], ntok[i]))
                   for start, nt, toks, ntok in tiles for i in range(nt)]
        return [f.result() for f in futures]

    # -- the full-device DEFLATE pack ---------------------------------------

    def _device_pack(self, chunks: Sequence[bytes], n: int, level: int,
                     dynamic: bool):
        """Dispatch every tile's device pack. Returns one (tile_start,
        tile_len, words, nbits, hdrs, packs) per tile: device words and
        bit counts, and for dynamic tiles each chunk's header bytes and
        lit/len table (its EOB code). Dynamic tiles run pass 1 one tile
        ahead of pass 2, so the host builds tile k's trees while the
        device analyzes tile k + 1, and at most two tiles' planes are
        held at a time."""
        ss, ov, _cs, ctx, probes = _tok_knobs(level, n)
        pkw = dict(parse_seg=8192, search_seg=ss, search_overlap=ov,
                   ctx_words=ctx, probes=probes)
        items, ahead = [], None
        for start in range(0, len(chunks), TILE_B):
            tile = chunks[start:start + TILE_B]
            data, lengths = _stage_tile(tile, _bucket(len(tile)), n)
            dd = torch.from_numpy(data).to(self.device)
            ll = torch.from_numpy(lengths).to(self.device)
            if not dynamic:
                words, nbits = deflate_pack_device(dd, ll, n=n, **pkw)
                items.append((start, len(tile), words, nbits, None, None))
                continue
            hist, *planes = deflate_analyze_hist(dd, ll, n=n, **pkw)
            cur = (start, len(tile), dd, planes, _to_host(hist))
            if ahead is not None:
                items.append(self._dyn_pass2(n, *ahead))
            ahead = cur
        if ahead is not None:
            items.append(self._dyn_pass2(n, *ahead))
        return items

    def _dyn_pass2(self, n, start, nt, dd, planes, hist):
        """Dynamic pass 2 for one tile: wait for its histograms, build each
        chunk's trees and header on the host, dispatch the pack."""
        hist_np, ready = hist
        if ready is not None:
            ready.synchronize()
        packs, dpacks, hdrs, hbits = plan_tile(hist_np.numpy(), nt)
        words, nbits = deflate_pack_dynamic(
            dd, *planes, torch.from_numpy(packs.astype(np.int32)).to(
                self.device),
            torch.from_numpy(dpacks.astype(np.int32)).to(self.device),
            torch.from_numpy(hbits).to(self.device), n=n)
        return start, nt, words, nbits, hdrs, packs

    @staticmethod
    def _fetch_words(items):
        """Yield each tile with its words fetched: the prefix that covers
        the longest row, rounded to a bucket (the dynamic nbits leaves out
        the <= 15-bit EOB, hence the pad)."""
        for start, nt, words, nbits, hdrs, packs in items:
            nbits_np = nbits.cpu().numpy()
            maxw = int(nbits_np.max() + 15 + 31) // 32 + 1
            k = _fetch_bucket(maxw, words.shape[1])
            words_np = words[:, :k].cpu().numpy().view(np.uint32)
            yield start, nt, words_np, nbits_np, hdrs, packs

    def _finish(self, chunks, finals, fetched):
        """Frame every fetched row on the host pool, in submission order:
        header and EOB for dynamic rows, BFINAL or the full-flush sync,
        the stored-block guard, crc32."""
        from .. import native
        from ..engines import host_pool
        lib = native.get_lib()

        def finish_one(args):
            gi, words_row, bits, hdr, eob_pack = args
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
                payload = lib.deflate_pack(chunk, np.asarray(runs, np.uint32),
                                           len(runs), final=finals[gi],
                                           mode=0)
            return payload, lib.crc32(chunk)

        pool = host_pool()
        futures = [pool.submit(finish_one, (
            start + i, words_np[i], int(nbits_np[i]),
            hdrs[i] if hdrs is not None else None,
            int(packs[i][256]) if packs is not None else 0))
            for start, nt, words_np, nbits_np, hdrs, packs in fetched
            for i in range(nt)]
        return [f.result() for f in futures]

    # -- the full-device LZ4 pack ---------------------------------------------

    def _lz4_device_pack(self, chunks: Sequence[bytes], n: int):
        """Dispatch every tile's LZ4 device pack. Returns one (tile_start,
        tile_len, words, nbytes, ok) per tile, all on the device."""
        items = []
        for start in range(0, len(chunks), TILE_B):
            tile = chunks[start:start + TILE_B]
            data, lengths = _stage_tile(tile, _bucket(len(tile)), n)
            words, nbytes, ok = lz4_pack_device(
                torch.from_numpy(data).to(self.device),
                torch.from_numpy(lengths).to(self.device), n=n)
            items.append((start, len(tile), words, nbytes, ok))
        return items

    @staticmethod
    def _fetch_lz4(items):
        """Yield each tile with its block bytes fetched: the word prefix
        that covers the longest row, rounded to a bucket."""
        for start, nt, words, nbytes, ok in items:
            nb_np = nbytes.cpu().numpy()
            ok_np = ok.cpu().numpy()
            k = _fetch_bucket(int(nb_np.max() + 3) // 4 + 1, words.shape[1])
            yield (start, nt, words[:, :k].cpu().numpy().view(np.uint32),
                   nb_np, ok_np)

    def _finish_lz4(self, chunks, fetched):
        """Each chunk's block on the host pool, in submission order: the
        device's bytes, or the host LZ4 coder's for a row that is not ok
        (or an empty chunk); crc32."""
        from .. import native
        from ..engines import host_pool
        lib = native.get_lib()

        def finish_one(args):
            gi, words_row, nb, row_ok = args
            chunk = chunks[gi]
            if row_ok and len(chunk):
                payload = words_row[:(nb + 3) // 4].tobytes()[:nb]
            else:
                payload = lib.lz4_compress_block(chunk)
            return payload, lib.crc32(chunk)

        pool = host_pool()
        futures = [pool.submit(finish_one, (start + i, words_np[i],
                                            int(nb_np[i]), bool(ok_np[i])))
                   for start, nt, words_np, nb_np, ok_np in fetched
                   for i in range(nt)]
        return [f.result() for f in futures]


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
    for i in range(nt):
        lf = hist[i, :286].astype(np.uint32)
        lf[256] += 1
        packs[i], dpacks[i], hdrs[i], hbits[i] = lib.dyn_plan(
            lf, hist[i, 286:].astype(np.uint32))
    return packs, dpacks, hdrs, hbits


def build_engine(device) -> CudaEngine:
    """Factory used by the runtime's engine pool."""
    return CudaEngine(device)
