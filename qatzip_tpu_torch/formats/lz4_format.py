"""LZ4 frame and block framing, and the LZ4s block framing.

Counterpart of ``qatzip_tpu/formats/lz4_format.py`` (reference
``src/qatzip_lz4.c``: header :104-132, footer :134-143, the frame walk
``findLZ4Footer`` :145-173, the header check :62-102, the LZ4s block
header :219-231).

Frame layout the session writes (15-byte header)::

    magic:u32 = 0x184D2204
    FLG:u8    = version 1 << 6 | content size 1 << 3 | content checksum
                1 << 2 (blocks dependent, no block checksum, no dict id)
    BD:u8     = max block size id 4 (64 KiB) << 4
    content_size:u64 (little-endian)
    HC:u8     = (XXH32(FLG..content_size, seed 0) >> 8) & 0xFF

    blocks: [ blk_size:u32 (bit 31: stored, uncompressed) payload ]*
    footer: endmark:u32 = 0, content_xxh32:u32

An LZ4s stream is ``[payload size:u32][payload]*``, no frame around it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..constants import (LZ4_BLOCK_UNCOMPRESSED_FLAG, LZ4_MAGIC,
                         LZ4_SKIPPABLE_MAGIC_MIN, QZ_FAIL, QZ_FORCE_SW, QZ_OK)
from ..ops.xxhash import xxh32

LZ4_MAGIC_SIZE = 4
LZ4_FD_SIZE = 11
LZ4_FRAME_HEADER_SZ = LZ4_MAGIC_SIZE + LZ4_FD_SIZE  # 15
LZ4_FRAME_FOOTER_SZ = 8                             # endmark + checksum
LZ4_BLK_HEADER_SZ = 4
LZ4_VERSION = 1
LZ4_MAX_BLK_SIZE_ID = 4                             # 64 KiB

_FLG = (LZ4_VERSION << 6) | (1 << 3) | (1 << 2)
_BD = LZ4_MAX_BLK_SIZE_ID << 4


def lz4_frame_header(content_size: int) -> bytes:
    """The 15-byte frame header (reference qzLZ4HeaderGen)."""
    fd = struct.pack("<BBQ", _FLG, _BD, content_size)
    return (struct.pack("<I", LZ4_MAGIC) + fd
            + bytes([(xxh32(fd, 0) >> 8) & 0xFF]))


def lz4_frame_footer(content_xxh32: int) -> bytes:
    """The frame footer {endmark 0, content checksum}."""
    return struct.pack("<II", 0, content_xxh32 & 0xFFFFFFFF)


@dataclass
class LZ4FrameInfo:
    flg: int
    bd: int
    content_size: Optional[int]
    header_sz: int
    has_content_checksum: bool
    has_block_checksum: bool
    block_independence: bool


def parse_lz4_frame_header(buf, offset: int = 0) -> Optional[LZ4FrameInfo]:
    """Parse any LZ4 frame header (optional content size and dict id);
    None when ``buf`` holds no LZ4 frame header at ``offset``."""
    mv = memoryview(buf)
    if len(mv) - offset < 7:
        return None
    (magic,) = struct.unpack_from("<I", mv, offset)
    if magic != LZ4_MAGIC:
        return None
    flg = mv[offset + 4]
    bd = mv[offset + 5]
    pos = offset + 6
    content_size = None
    if flg & 0x08:
        if len(mv) - pos < 8:
            return None
        (content_size,) = struct.unpack_from("<Q", mv, pos)
        pos += 8
    if flg & 0x01:                  # dict id
        pos += 4
    pos += 1                        # header checksum
    if pos > len(mv):
        return None
    return LZ4FrameInfo(flg=flg, bd=bd, content_size=content_size,
                        header_sz=pos - offset,
                        has_content_checksum=bool(flg & 0x04),
                        has_block_checksum=bool(flg & 0x10),
                        block_independence=bool(flg & 0x20))


def verify_lz4_frame_header(buf, offset: int = 0) -> int:
    """QZ_OK when the session's own block walk can take the frame,
    QZ_FORCE_SW when it is a valid frame (or a skippable one) that only
    the software frame decoder takes, QZ_FAIL when it is not LZ4."""
    mv = memoryview(buf)
    if len(mv) - offset < 4:
        return QZ_FAIL
    (magic,) = struct.unpack_from("<I", mv, offset)
    if (magic & 0xFFFFFFF0) == LZ4_SKIPPABLE_MAGIC_MIN:
        return QZ_FORCE_SW
    info = parse_lz4_frame_header(mv, offset)
    if info is None or (info.flg >> 6) & 0x3 != LZ4_VERSION:
        return QZ_FAIL
    if (info.flg & 0x01 or info.has_block_checksum
            or not info.has_content_checksum or info.content_size is None):
        return QZ_FORCE_SW
    return QZ_OK


def walk_lz4_blocks(buf, offset: int, avail: int, header_sz: int,
                    block_checksum: bool = False,
                    ) -> Optional[Tuple[List[Tuple[int, int, bool]], int]]:
    """Walk the block headers from ``offset + header_sz`` to the endmark.

    Returns ([(payload offset, payload size, stored)], endmark offset), or
    None when the frame is cut short. ``block_checksum`` skips the 4-byte
    checksum after each block."""
    mv = memoryview(buf)
    pos = offset + header_sz
    end = offset + avail
    blocks: List[Tuple[int, int, bool]] = []
    while pos + LZ4_BLK_HEADER_SZ <= end:
        (word,) = struct.unpack_from("<I", mv, pos)
        if word == 0:
            return blocks, pos
        size = word & 0x7FFFFFFF
        pos += LZ4_BLK_HEADER_SZ
        if pos + size > end:
            return None
        blocks.append((pos, size, bool(word & LZ4_BLOCK_UNCOMPRESSED_FLAG)))
        pos += size
        if block_checksum:
            if pos + 4 > end:
                return None
            pos += 4
    return None


def find_lz4_footer(buf, offset: int, avail: int) -> Optional[int]:
    """Offset of the frame's endmark, or None when the frame is cut
    short or not LZ4."""
    info = parse_lz4_frame_header(buf, offset)
    if info is None:
        return None
    walked = walk_lz4_blocks(buf, offset, avail, info.header_sz)
    return None if walked is None else walked[1]


def lz4s_block_header(payload_sz: int) -> bytes:
    """The LZ4s block header: the payload's size."""
    return struct.pack("<I", payload_sz & 0xFFFFFFFF)
