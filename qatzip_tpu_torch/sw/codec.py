"""The software codec: compress and decompress of every framing.

Counterpart of ``qatzip_tpu/sw/codec.py`` (reference ``src/qatzip_sw.c``:
qzSWCompress :632 with qzDeflateSWCompress :76-253, qzSWDecompressMulti
:702-734, the LZ4 frame codec :430-628). Deflate goes through zlib, one
member per ``hw_buff_sz`` chunk in the member framings; LZ4 blocks go
through the native block codec. ``QZ_AUTO_SELECT_BEST`` sets
``sw_compress`` beside the engine's output, and the codec takes the
decode walks for the framings its batched native decode does not parse.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

from .. import native
from ..constants import (DataFormat, LZ4_BLOCK_UNCOMPRESSED_FLAG,
                         LZ4_SKIPPABLE_MAGIC_MIN, QZ_DATA_ERROR, QzError,
                         effective_deflate_sw_level)
from ..formats.gzip_format import output_footer_gen, output_header_gen
from ..formats.lz4_format import (lz4_frame_footer, lz4_frame_header,
                                  lz4s_block_header, parse_lz4_frame_header,
                                  walk_lz4_blocks)
from ..ops.checksum import crc32, crc32_combine
from ..ops.xxhash import xxh32


def deflate_raw_compress(chunk, level: int = 1) -> bytes:
    """One complete raw deflate stream (BFINAL set) of ``chunk``, zlib at
    ``level``."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(chunk) + co.flush(zlib.Z_FINISH)


def inflate_raw(payload) -> bytes:
    """Decode one raw deflate stream; raises QZ_DATA_ERROR when it is
    malformed."""
    try:
        do = zlib.decompressobj(-15)
        return do.decompress(bytes(payload)) + do.flush()
    except zlib.error as e:
        raise QzError(QZ_DATA_ERROR, str(e)) from None


def _chunks(data: bytes, sz: int):
    for off in range(0, len(data), sz):
        yield data[off:off + sz]
    if not data:
        yield b""


def sw_compress(data, data_fmt: DataFormat, level: int, hw_buff_sz: int,
                mini_match: int = 3) -> Tuple[bytes, int]:
    """``data`` compressed in software into ``data_fmt``. Returns (out,
    crc32 of data). Deflate runs zlib at the QATzip level's zlib level,
    one member per ``hw_buff_sz`` chunk in the gzip, gzip-ext and 4-byte
    framings, one stream for raw and zlib; LZ4 and LZ4s take 64 KiB
    blocks at most."""
    zlevel = effective_deflate_sw_level(level)
    if data_fmt in (DataFormat.DEFLATE_GZIP_EXT, DataFormat.DEFLATE_GZIP,
                    DataFormat.DEFLATE_4B):
        parts: List[bytes] = []
        total_crc = 0
        for chunk in _chunks(data, hw_buff_sz):
            payload = deflate_raw_compress(chunk, zlevel)
            ccrc = crc32(chunk)
            total_crc = crc32_combine(total_crc, ccrc, len(chunk))
            parts += [output_header_gen(data_fmt, len(chunk), len(payload)),
                      payload, output_footer_gen(data_fmt, ccrc, len(chunk))]
        return b"".join(parts), total_crc
    if data_fmt == DataFormat.DEFLATE_RAW:
        return deflate_raw_compress(data, zlevel), crc32(data)
    if data_fmt == DataFormat.ZLIB:
        co = zlib.compressobj(zlevel, zlib.DEFLATED, 15)
        return co.compress(data) + co.flush(), crc32(data)
    if data_fmt == DataFormat.LZ4:
        return (lz4_frame_compress(data, min(hw_buff_sz, 64 * 1024)),
                crc32(data))
    if data_fmt == DataFormat.LZ4S:
        return (lz4s_blocks_compress(data, min(hw_buff_sz, 64 * 1024),
                                     mini_match), crc32(data))
    raise QzError(QZ_DATA_ERROR, f"unsupported format {data_fmt}")


def sw_decompress_multi(data, data_fmt: DataFormat,
                        max_out: Optional[int] = None
                        ) -> Tuple[bytes, int, int]:
    """Decode concatenated members of ``data_fmt`` until the input ends
    or a member is cut short, or, in the gzip framings, once ``max_out``
    bytes or more are out (whole members only). Returns (out, bytes
    consumed, crc32 of out); raises QZ_DATA_ERROR when the first member
    is malformed."""
    data = bytes(data)
    n = len(data)
    if data_fmt in (DataFormat.DEFLATE_GZIP_EXT, DataFormat.DEFLATE_GZIP):
        out = bytearray()
        pos = 0
        while pos < n:
            do = zlib.decompressobj(31)
            try:
                piece = do.decompress(data[pos:]) + do.flush()
            except zlib.error as e:
                if pos == 0:
                    raise QzError(QZ_DATA_ERROR, str(e)) from None
                break
            if not do.eof:
                break                   # a trailing member cut short
            out += piece
            consumed = n - pos - len(do.unused_data)
            if consumed <= 0:
                break
            pos += consumed
            if max_out is not None and len(out) >= max_out:
                break
        return bytes(out), pos, crc32(bytes(out))

    if data_fmt == DataFormat.DEFLATE_4B:
        out = bytearray()
        pos = 0
        while pos + 4 <= n:
            (blk,) = struct.unpack_from("<I", data, pos)
            if blk == 0 or pos + 4 + blk > n:
                break
            out += inflate_raw(data[pos + 4:pos + 4 + blk])
            pos += 4 + blk
        return bytes(out), pos, crc32(bytes(out))

    if data_fmt in (DataFormat.DEFLATE_RAW, DataFormat.ZLIB):
        do = zlib.decompressobj(-15 if data_fmt == DataFormat.DEFLATE_RAW
                                else 15)
        try:
            out = do.decompress(data) + do.flush()
        except zlib.error as e:
            raise QzError(QZ_DATA_ERROR, str(e)) from None
        return out, n - len(do.unused_data), crc32(out)

    if data_fmt == DataFormat.LZ4:
        out, consumed = lz4_frame_decompress(data)
        return out, consumed, crc32(out)

    raise QzError(QZ_DATA_ERROR, f"unsupported format {data_fmt}")


# ---------------------------------------------------------------------------
# LZ4 frames and LZ4s block streams
# ---------------------------------------------------------------------------

def lz4_frame_compress(data: bytes, hw_buff_sz: int = 64 * 1024) -> bytes:
    """One LZ4 frame of ``data`` with the session's header flags (content
    size and checksum, 64 KiB blocks); a block that would not shrink is
    stored."""
    lib = native.get_lib()
    parts = [lz4_frame_header(len(data))]
    for chunk in _chunks(data, hw_buff_sz):
        if not chunk and data:
            continue
        payload = lib.lz4_compress_block(chunk, 32768)
        if len(payload) >= len(chunk) and chunk:
            parts += [struct.pack("<I", len(chunk)
                                  | LZ4_BLOCK_UNCOMPRESSED_FLAG), chunk]
        else:
            parts += [struct.pack("<I", len(payload)), payload]
    parts.append(lz4_frame_footer(xxh32(data)))
    return b"".join(parts)


def lz4_frame_decompress(data) -> Tuple[bytes, int]:
    """Decode concatenated LZ4 frames, skippable frames skipped. Returns
    (out, bytes consumed); raises QZ_DATA_ERROR on a malformed or cut
    frame, or a checksum or content size that does not match."""
    data = bytes(data)
    lib = native.get_lib()
    out = bytearray()
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        (magic,) = struct.unpack_from("<I", data, pos)
        if (magic & 0xFFFFFFF0) == LZ4_SKIPPABLE_MAGIC_MIN:
            if pos + 8 > n:
                break
            (sz,) = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + sz
            continue
        info = parse_lz4_frame_header(data, pos)
        if info is None:
            if pos == 0:
                raise QzError(QZ_DATA_ERROR, "not an LZ4 frame")
            break
        walked = walk_lz4_blocks(data, pos, n - pos, info.header_sz,
                                 block_checksum=info.has_block_checksum)
        if walked is None:
            raise QzError(QZ_DATA_ERROR, "truncated LZ4 frame")
        blocks, footer_off = walked
        frame: List[bytes] = []
        max_block = 1 << (8 + 2 * max(4, (info.bd >> 4) & 7))
        for off, sz, stored in blocks:
            payload = data[off:off + sz]
            if info.has_block_checksum:
                (want_bc,) = struct.unpack_from("<I", data, off + sz)
                if xxh32(payload) != want_bc:
                    raise QzError(QZ_DATA_ERROR,
                                  "LZ4 block checksum mismatch")
            if stored:
                frame.append(payload)
            else:
                try:
                    frame.append(lib.lz4_decompress_block(payload,
                                                          max_block))
                except ValueError as e:
                    raise QzError(QZ_DATA_ERROR, str(e)) from None
        frame_out = b"".join(frame)
        pos = footer_off + 4
        if info.has_content_checksum:
            if pos + 4 > n:
                raise QzError(QZ_DATA_ERROR, "missing content checksum")
            (want,) = struct.unpack_from("<I", data, pos)
            if xxh32(frame_out) != want:
                raise QzError(QZ_DATA_ERROR, "LZ4 content checksum mismatch")
            pos += 4
        if (info.content_size is not None
                and info.content_size != len(frame_out)):
            raise QzError(QZ_DATA_ERROR, "LZ4 content size mismatch")
        out += frame_out
    return bytes(out), pos


def lz4s_blocks_compress(data: bytes, hw_buff_sz: int = 64 * 1024,
                         mini_match: int = 3) -> bytes:
    """The LZ4s block stream of ``data``: ``[size:u32][payload]*``, the
    shape the post-process callback takes."""
    lib = native.get_lib()
    parts = []
    for chunk in _chunks(data, hw_buff_sz):
        if not chunk and data:
            continue
        payload = lib.lz4s_compress_block(chunk, mini_match)
        parts += [lz4s_block_header(len(payload)), payload]
    return b"".join(parts)
