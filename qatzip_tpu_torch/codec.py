"""Compress/decompress dispatch: chunk fan-out, ordered stitch, crc fold.

Counterpart of ``qatzip_tpu/codec.py`` (reference qzCompressCrcExt,
src/qatzip.c:2029-2255, and qzDecompressExt, :2819-2997). A request is
cut into ``hw_buff_sz`` chunks (at most 64 KiB for LZ4 and LZ4s), the
engine returns one (payload, crc32) per chunk in order, and the chunks
are framed: a member each for the gzip framings, one stream for raw and
zlib, one LZ4 frame (blocks that did not shrink stored), or the LZ4s
block stream. With ``QZ_AUTO_SELECT_BEST`` an engine's request is also
compressed in software, and the smaller output is returned.

Decompression: strict gzip-ext members are walked natively and inflated
in one GIL-free batched call; other gzip and 4-byte members take the
member walk and the same batched inflate; LZ4 frames decode their blocks
in one batched native call; raw and zlib streams, and whatever the fast
walks do not take, go through the software walk (``sw/codec.py``).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from .constants import (DataFormat, LZ4_BLOCK_UNCOMPRESSED_FLAG,
                        QZ_AUTO_SELECT_BEST, QZ_DATA_ERROR, QzError)
from .engines import host_engine
from .formats.gzip_format import (output_footer_gen, output_header_gen,
                                  scan_members)
from .formats.lz4_format import (lz4_frame_footer, lz4_frame_header,
                                 lz4s_block_header, parse_lz4_frame_header,
                                 walk_lz4_blocks)
from .ops.checksum import (adler32, adler32_combine, crc32, crc32_combine,
                           crc32_combine_many)
from .ops.xxhash import xxh32
from .sw import codec as swc
from .utils.debug import get_counters

ALGORITHMS = ("deflate", "lz4", "lz4s")


def _split_chunks(data: bytes, hw_buff_sz: int) -> List[bytes]:
    if not len(data):
        return [b""]
    mv = memoryview(data)          # zero-copy chunk views
    return [mv[o:o + hw_buff_sz] for o in range(0, len(data), hw_buff_sz)]


def _request_chunks(data: bytes, algorithm: str, data_fmt: DataFormat,
                    hw_buff_sz: int):
    """One request's engine chunks + per-chunk final flags: LZ4 and LZ4s
    chunks are capped at 64 KiB (the largest LZ4 block); raw and zlib
    output is one stream (only the last chunk is final), every other
    format frames each chunk on its own."""
    if algorithm in ("lz4", "lz4s"):
        hw_buff_sz = min(hw_buff_sz, 64 * 1024)
    chunks = _split_chunks(data, hw_buff_sz)
    if algorithm == "deflate" and data_fmt in (DataFormat.DEFLATE_RAW,
                                               DataFormat.ZLIB):
        finals = [False] * (len(chunks) - 1) + [True]
    else:
        finals = [True] * len(chunks)
    return chunks, finals


def _frame_results(data: bytes, chunks: List[bytes], results,
                   algorithm: str, data_fmt: DataFormat) -> Tuple[bytes, int]:
    """Stitch ordered chunk results into framed output."""
    total_crc = crc32_combine_many([c for _, c in results],
                                   [len(ch) for ch in chunks])
    if algorithm == "lz4":
        parts = [lz4_frame_header(len(data))]
        for (payload, _crc), chunk in zip(results, chunks):
            if len(payload) >= len(chunk) and len(chunk):
                parts += [struct.pack("<I", len(chunk)
                                      | LZ4_BLOCK_UNCOMPRESSED_FLAG), chunk]
            else:
                parts += [struct.pack("<I", len(payload)), payload]
        parts.append(lz4_frame_footer(xxh32(data)))
        return b"".join(parts), total_crc
    if algorithm == "lz4s":
        return b"".join(lz4s_block_header(len(p)) + p
                        for p, _ in results), total_crc
    if data_fmt in (DataFormat.DEFLATE_RAW, DataFormat.ZLIB):
        body = b"".join(p for p, _ in results)
        if data_fmt == DataFormat.ZLIB:
            ad = 1
            for ch in chunks:
                ad = adler32_combine(ad, adler32(ch), len(ch))
            return b"\x78\x9c" + body + struct.pack(">I", ad), total_crc
        return body, total_crc
    parts = []
    for (payload, ccrc), chunk in zip(results, chunks):
        parts.append(output_header_gen(data_fmt, len(chunk), len(payload)))
        parts.append(payload)
        parts.append(output_footer_gen(data_fmt, ccrc, len(chunk)))
    return b"".join(parts), total_crc


def compress_buffer(data: bytes, *, data_fmt: DataFormat, level: int,
                    hw_buff_sz: int, engine=None, algorithm: str = "deflate",
                    sw_backup: int = 1, input_sz_thrshold: int = 1024,
                    mini_match: int = 3,
                    huffman_static: bool = False) -> Tuple[bytes, int]:
    """Compress one request. Returns (framed output, crc32 of input).

    ``engine=None``, or a request shorter than ``input_sz_thrshold``, is
    compressed in software (the host engine), the reference's size gate
    (src/qatzip.c:2098-2116). With ``sw_backup == QZ_AUTO_SELECT_BEST``
    an engine's output is set beside ``sw_compress``'s and the smaller
    one returned, per request (include/qatzip.h:606-621)."""
    if algorithm not in ALGORITHMS:
        raise QzError(QZ_DATA_ERROR, f"unknown algorithm {algorithm}")
    counters = get_counters()
    use_engine = engine is not None and len(data) >= input_sz_thrshold
    counters.bump("hw_compress" if use_engine else "sw_compress", 1,
                  len(data))
    chunks, finals = _request_chunks(data, algorithm, data_fmt, hw_buff_sz)
    results = (engine if use_engine else host_engine).compress_chunks(
        chunks, level=level, algorithm=algorithm, final_flags=finals,
        mini_match=mini_match, huffman_static=huffman_static)
    out, crc = _frame_results(data, chunks, results, algorithm, data_fmt)
    if use_engine and sw_backup == QZ_AUTO_SELECT_BEST:
        sw_fmt = {"lz4": DataFormat.LZ4, "lz4s": DataFormat.LZ4S}.get(
            algorithm, data_fmt)
        sw_out, sw_crc = swc.sw_compress(data, sw_fmt, level, hw_buff_sz,
                                         mini_match=mini_match)
        if len(sw_out) < len(out):
            return sw_out, sw_crc
    return out, crc


# ---------------------------------------------------------------------------
# Decompress
# ---------------------------------------------------------------------------

def decompress_buffer(data: bytes, *, data_fmt: DataFormat,
                      algorithm: str = "deflate",
                      max_out: Optional[int] = None
                      ) -> Tuple[bytes, int, int]:
    """Decompress one request. Returns (out, consumed, crc32(out)); raises
    QZ_DATA_ERROR on malformed input, or a member checksum or size that
    does not match. When gzip-ext members declare more than ``max_out``
    bytes in all, the software walk decodes them and stops after the
    member that reaches it (qzDecompressExt's bound on the destination,
    src/qatzip.c:2909); the other walks decode every member, as in the
    JAX package."""
    counters = get_counters()
    if algorithm == "lz4":
        return _decompress_lz4(data)
    if algorithm == "lz4s":
        raise QzError(QZ_DATA_ERROR, "LZ4S decode is a post-process input")
    if data_fmt in (DataFormat.DEFLATE_RAW, DataFormat.ZLIB):
        counters.bump("sw_decompress", 1, len(data))
        return swc.sw_decompress_multi(data, data_fmt, max_out)
    from . import native
    lib = native.get_lib()
    if data_fmt == DataFormat.DEFLATE_GZIP_EXT and len(data):
        scanned = lib.scan_gzipext(data)
        if scanned is not None and scanned[4] == len(data) and len(scanned[0]):
            in_offs, in_lens, sizes, want_crcs, consumed = scanned
            if max_out is not None and int(sizes.sum()) > max_out:
                counters.bump("sw_decompress_fallback", 1, len(data))
                return swc.sw_decompress_multi(data, data_fmt, max_out)
            out, crcs, out_lens, in_used = lib.inflate_batch_bytes(
                data, in_offs, in_lens, sizes)
            if (out_lens == sizes).all() and (in_used == in_lens).all():
                if not (crcs == want_crcs).all():
                    raise QzError(QZ_DATA_ERROR, "member crc32 mismatch")
                counters.bump("hw_decompress", 1, len(data))
                return out, consumed, crc32_combine_many(
                    [int(c) for c in crcs], sizes.tolist())
            counters.bump("sw_decompress_fallback", 1, len(data))
            return swc.sw_decompress_multi(data, data_fmt, max_out)

    members = scan_members(data, data_fmt)
    if not members:
        counters.bump("sw_decompress", 1, len(data))
        return swc.sw_decompress_multi(data, data_fmt, max_out)
    sizes = [m.uncompressed_sz for m in members]
    consumed = members[-1].offset + members[-1].total_sz
    if all(s >= 0 for s in sizes):
        out, crcs, out_lens, in_used = lib.inflate_batch_bytes(
            data, [m.payload_off for m in members],
            [m.payload_sz for m in members], sizes)
        # a payload the decode did not use up means the member walk took
        # trailing input for payload (concatenated std gzip members carry
        # no compressed size): the software walk decodes them one by one
        if ((out_lens == sizes).all()
                and all(int(u) == m.payload_sz
                        for u, m in zip(in_used, members))):
            for m, c in zip(members, crcs):
                if m.crc32 is not None and int(c) != m.crc32:
                    raise QzError(QZ_DATA_ERROR, "member crc32 mismatch")
            counters.bump("hw_decompress", 1, len(data))
            return out, consumed, crc32_combine_many([int(c) for c in crcs],
                                                     sizes)
    counters.bump("sw_decompress_fallback", 1, len(data))
    return swc.sw_decompress_multi(data, data_fmt, max_out)


def _decompress_lz4(data: bytes) -> Tuple[bytes, int, int]:
    """Concatenated LZ4 frames: every block of a frame in one batched
    native decode, the content size and checksum checked. A frame whose
    non-final blocks fall short of the block size (another coder's)
    decodes block by block on the host pool; frames with block checksums, or
    data that starts with no LZ4 frame, take the software walk."""
    info = parse_lz4_frame_header(data, 0)
    if info is None:
        return swc.sw_decompress_multi(data, DataFormat.LZ4)
    walked = walk_lz4_blocks(data, 0, len(data), info.header_sz)
    if walked is None or info.has_block_checksum:
        return swc.sw_decompress_multi(data, DataFormat.LZ4)
    blocks, footer_off = walked
    max_block = 1 << (8 + 2 * max(4, (info.bd >> 4) & 7))
    from . import native
    lib = native.get_lib()
    nb = len(blocks)
    caps = [max_block] * nb
    if nb and info.content_size is not None:
        # the last block's exact size when the declared content size
        # gives one, so the output needs no trailing cut
        tail = info.content_size - (nb - 1) * max_block
        if 0 < tail <= max_block:
            caps[-1] = tail
    buf, out_lens, crcs, frame_xxh = lib.lz4_batch_bytes(
        data, [b[0] for b in blocks],
        [-b[1] if b[2] else b[1] for b in blocks], caps,
        want_xxh=info.has_content_checksum)
    if not ((out_lens >= 0).all() and (out_lens[:-1] == max_block).all()):
        # a malformed block, or a non-final block short of max_block (a
        # frame from another coder): block by block on the host pool
        payloads = [bytes(memoryview(data)[off:off + sz])
                    for off, sz, _stored in blocks]
        coded = [p for p, b in zip(payloads, blocks) if not b[2]]
        decoded = iter(host_engine.decompress_chunks(
            coded, [max_block] * len(coded), algorithm="lz4"))
        out = b"".join(p if b[2] else next(decoded)
                       for p, b in zip(payloads, blocks))
        frame_xxh, total_crc = None, crc32(out)
    else:
        out = buf[:int(out_lens.sum())]
        total_crc = crc32_combine_many([int(c) for c in crcs],
                                       [int(x) for x in out_lens])
    consumed = footer_off + 4
    if info.has_content_checksum:
        if consumed + 4 > len(data):
            raise QzError(QZ_DATA_ERROR, "missing content checksum")
        (want,) = struct.unpack_from("<I", data, consumed)
        got = frame_xxh if frame_xxh is not None else xxh32(out)
        if got != want:
            raise QzError(QZ_DATA_ERROR, "LZ4 content checksum mismatch")
        consumed += 4
    if info.content_size is not None and info.content_size != len(out):
        raise QzError(QZ_DATA_ERROR, "LZ4 content size mismatch")
    get_counters().bump("hw_decompress", 1, consumed)
    if consumed < len(data):
        rest, more, rest_crc = _decompress_lz4(data[consumed:])
        if more:
            out += rest
            consumed += more
            total_crc = crc32_combine(total_crc, rest_crc, len(rest))
    return out, consumed, total_crc
