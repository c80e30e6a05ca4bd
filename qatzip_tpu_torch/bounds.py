"""Compressed-size upper bounds: qzMaxCompressedLength.

Counterpart of ``qatzip_tpu/bounds.py`` (reference src/qatzip.c:3175-3404):
the deflate bound of 9/8 of the input plus a skid pad and the framing per
chunk (:3175-3211) with its Gen4 dynamic variant (:3213-3274), the LZ4
(:3332-3370) and LZ4s (:3292-3330) bounds, and the 34-byte empty gzip-ext
output (include/qatzip.h:1694).

The port's coders stay inside them: static-Huffman deflate costs at most
9 bits a byte plus block overhead, and the stored-block guard caps every
deflate chunk; LZ4 and LZ4s add at most one run-length byte per 255
literals and each sequence's overhead.
"""

from __future__ import annotations

from .constants import DataFormat, QZ_EMPTY_OUT_SZ_GZIP_EXT
from .formats.gzip_format import (GZIP_EXT_HEADER_SZ, GZIP_FOOTER_SZ,
                                  GZIP_HEADER_SZ, QZ4B_HEADER_SZ)
from .formats.lz4_format import (LZ4_BLK_HEADER_SZ, LZ4_FRAME_FOOTER_SZ,
                                 LZ4_FRAME_HEADER_SZ)

#: deflate per-chunk skid pad (reference QZ_SKID_PAD, qatzip_internal.h)
DEFLATE_SKID_PAD = 48
DEFLATE_SKID_PAD_GEN4 = 512
DEFLATE_SKID_PAD_GEN4_DYN = 1029


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def output_header_sz(data_fmt: DataFormat) -> int:
    """Bytes of framing before each chunk's payload (outputHeaderSz)."""
    return {DataFormat.DEFLATE_GZIP_EXT: GZIP_EXT_HEADER_SZ,
            DataFormat.DEFLATE_GZIP: GZIP_HEADER_SZ,
            DataFormat.DEFLATE_4B: QZ4B_HEADER_SZ}.get(data_fmt, 0)


def output_footer_sz(data_fmt: DataFormat) -> int:
    """Bytes of framing after each chunk's payload (outputFooterSz)."""
    return (GZIP_FOOTER_SZ if data_fmt in (DataFormat.DEFLATE_GZIP_EXT,
                                           DataFormat.DEFLATE_GZIP) else 0)


def deflate_bound(src_sz: int, data_fmt: DataFormat, hw_buff_sz: int,
                  gen4: bool = False, dynamic: bool = True) -> int:
    """Worst-case framed deflate output (qzDeflateBound)."""
    hdr_ftr = output_header_sz(data_fmt) + output_footer_sz(data_fmt)
    if src_sz == 0:
        if data_fmt == DataFormat.DEFLATE_GZIP_EXT:
            return QZ_EMPTY_OUT_SZ_GZIP_EXT
        return hdr_ftr + 8
    chunks = _cdiv(src_sz, hw_buff_sz)
    skid, extra = DEFLATE_SKID_PAD, 0
    if gen4:
        skid = DEFLATE_SKID_PAD_GEN4_DYN if dynamic else DEFLATE_SKID_PAD_GEN4
        if dynamic:
            # the Gen4 dynamic-Huffman term for pathological input
            extra = chunks * ((8 * hw_buff_sz * 155 // 7) // 16384)
    return src_sz + _cdiv(src_sz, 8) + chunks * (hdr_ftr + skid) + extra


def lz4_bound(src_sz: int, hw_buff_sz: int) -> int:
    """Worst-case LZ4 frame output."""
    if src_sz == 0:
        return LZ4_FRAME_HEADER_SZ + LZ4_FRAME_FOOTER_SZ + LZ4_BLK_HEADER_SZ + 1
    chunks = _cdiv(src_sz, min(hw_buff_sz, 64 * 1024))
    return (LZ4_FRAME_HEADER_SZ + LZ4_FRAME_FOOTER_SZ
            + chunks * LZ4_BLK_HEADER_SZ
            + src_sz + _cdiv(src_sz, 1520) * 13 + 1024)


def lz4s_bound(src_sz: int, hw_buff_sz: int) -> int:
    """Worst-case LZ4s block-stream output."""
    if src_sz == 0:
        return LZ4_BLK_HEADER_SZ + 1
    chunks = _cdiv(src_sz, min(hw_buff_sz, 64 * 1024))
    return (src_sz + _cdiv(src_sz, 2000) * 11 + 1024
            + chunks * LZ4_BLK_HEADER_SZ)


def max_compressed_length(src_sz: int, *, algorithm: str = "deflate",
                          data_fmt: DataFormat = DataFormat.DEFLATE_GZIP_EXT,
                          hw_buff_sz: int = 64 * 1024,
                          gen4: bool = False) -> int:
    """qzMaxCompressedLength (dispatch at src/qatzip.c:3372-3404); "zstd"
    bounds the LZ4s -> zstd post-process output."""
    if algorithm == "deflate":
        return deflate_bound(src_sz, data_fmt, hw_buff_sz, gen4=gen4)
    if algorithm == "lz4":
        return lz4_bound(src_sz, hw_buff_sz)
    if algorithm == "lz4s":
        return lz4s_bound(src_sz, hw_buff_sz)
    if algorithm == "zstd":
        return src_sz + (src_sz >> 8) + 1024
    raise ValueError(f"unknown algorithm {algorithm}")
