"""Configurable CRC64, the session's CRC64 calls and metadata blocks.

Counterpart of ``qatzip_tpu/crc64.py``: the v2.3 API that the reference's
``include/qatzip.h`` declares (``QzCrc64Config_T`` :742-753,
``qzCompressCrc64`` :1098, ``qz{Get,Set}SessionCrc64Config``
:2366-2420, ``qzAllocateMetadata`` and ``qzMetadataBlockRead/Write``
:1215, :2479-2548). The defaults are the reference's: polynomial
0x42F0E1EBA9EA3693 (ECMA-182), initial value 0, no reflection, no
xor-out. ``Crc64`` computes in the native library (slicing-by-8, tables
built per polynomial and reflection); ``_compute_py`` is the per-byte
Python loop the tests hold it against.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from . import native
from .constants import QZ_FAIL, QZ_OK, QZ_OUT_OF_RANGE, QZ_PARAMS, QzError

_M64 = (1 << 64) - 1


@dataclasses.dataclass
class Crc64Config:
    """QzCrc64Config_T, with the reference's defaults."""

    polynomial: int = 0x42F0E1EBA9EA3693
    initial_value: int = 0
    reflect_in: bool = False
    reflect_out: bool = False
    xor_out: int = 0


def _reflect(v: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


class Crc64:
    """CRC64 for any ``Crc64Config``: ``Crc64(cfg)(data)`` is the
    finalized checksum of ``data``."""

    _ntbl_cache: dict = {}      # (poly, reflect_in) -> native tables

    def __init__(self, config: Optional[Crc64Config] = None):
        self.config = config or Crc64Config()
        self._table = None       # the per-byte table of _compute_py
        key = (self.config.polynomial, self.config.reflect_in)
        tbl = Crc64._ntbl_cache.get(key)
        if tbl is None:
            tbl = Crc64._ntbl_cache[key] = native.get_lib().crc64_tables(*key)
        self._ntbl = tbl

    def _build_table(self) -> List[int]:
        cfg = self.config
        table = []
        if cfg.reflect_in:
            poly = _reflect(cfg.polynomial, 64)
            for i in range(256):
                c = i
                for _ in range(8):
                    c = (c >> 1) ^ (poly if c & 1 else 0)
                table.append(c & _M64)
        else:
            for i in range(256):
                c = i << 56
                for _ in range(8):
                    if c & (1 << 63):
                        c = ((c << 1) ^ cfg.polynomial) & _M64
                    else:
                        c = (c << 1) & _M64
                table.append(c)
        return table

    def compute(self, data, crc: Optional[int] = None) -> int:
        """The register after ``data``, from ``crc`` (the initial value
        by default); not finalized."""
        c = self.config.initial_value if crc is None else crc
        return native.get_lib().crc64(data, self._ntbl, c,
                                      self.config.reflect_in)

    def _compute_py(self, data, c: int) -> int:
        """``compute`` one byte at a time in Python."""
        if self._table is None:
            self._table = self._build_table()
        t = self._table
        if self.config.reflect_in:
            for byte in data:
                c = (c >> 8) ^ t[(c ^ byte) & 0xFF]
        else:
            for byte in data:
                c = ((c << 8) & _M64) ^ t[((c >> 56) ^ byte) & 0xFF]
        return c

    def finalize(self, c: int) -> int:
        cfg = self.config
        if cfg.reflect_out != cfg.reflect_in:
            c = _reflect(c, 64)
        return c ^ cfg.xor_out

    def __call__(self, data) -> int:
        return self.finalize(self.compute(data))


# -- the session's CRC64 configuration ----------------------------------------

def qz_set_session_crc64_config(sess, config: Crc64Config) -> int:
    """qzSetSessionCrc64Config: QZ_OK, QZ_PARAMS, or QZ_FAIL for a session
    that is not set up (qatzip.h:2403)."""
    if sess is None or config is None:
        return QZ_PARAMS
    if sess.params is None:
        return QZ_FAIL
    if not 0 < config.polynomial <= _M64:
        return QZ_PARAMS
    sess._crc64 = Crc64(config)
    return QZ_OK


def qz_get_session_crc64_config(sess) -> Crc64Config:
    """qzGetSessionCrc64Config: a copy of the session's configuration (the
    default one until set)."""
    if sess is None:
        raise QzError(QZ_PARAMS, "null session")
    if sess.params is None:
        raise QzError(QZ_FAIL, "session not set up")
    eng = getattr(sess, "_crc64", None)
    return dataclasses.replace(eng.config) if eng else Crc64Config()


def qz_compress_crc64(sess, src, last: int = 1):
    """qzCompressCrc64: (rc, out, CRC64 of ``src``)."""
    try:
        out = sess.compress(src, last=bool(last))
        eng = getattr(sess, "_crc64", None) or Crc64()
        return QZ_OK, out, eng(bytes(src))
    except QzError as e:
        return e.rc, b"", 0


def qz_decompress_crc64(sess, src):
    """qzDecompressCrc64: (rc, out, CRC64 of ``out``)."""
    try:
        out = sess.decompress(src)
        eng = getattr(sess, "_crc64", None) or Crc64()
        return QZ_OK, out, eng(out)
    except QzError as e:
        return e.rc, b"", 0


# -- metadata blocks (qzAllocateMetadata family, qatzip.h:2479-2548) -----------

@dataclasses.dataclass
class MetadataBlock:
    offset: int = 0      # bytes from the previous compressed block
    size: int = 0        # compressed block size
    flags: int = 0       # 1 = compressed, 0 = stored
    hash: int = 0        # xxh32 of the block's plain hw_buff_sz bytes


class Metadata:
    """QzMetadataBlob_T: one descriptor per chunk."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise QzError(QZ_PARAMS, "num_blocks must be positive")
        self.blocks = [MetadataBlock() for _ in range(num_blocks)]


def qz_allocate_metadata(data_size: int, hw_buff_sz: int) -> Metadata:
    """qzAllocateMetadata: one block per ``hw_buff_sz`` chunk."""
    if data_size < 0 or hw_buff_sz <= 0:
        raise QzError(QZ_PARAMS, "bad sizes")
    return Metadata(max(1, -(-data_size // hw_buff_sz)))


def qz_metadata_block_read(block_num: int, metadata: Metadata):
    """qzMetadataBlockRead: (offset, size, flags, hash)."""
    if metadata is None:
        raise QzError(QZ_PARAMS, "metadata is NULL")
    if not 0 <= block_num < len(metadata.blocks):
        raise QzError(QZ_OUT_OF_RANGE, "block_num out of range")
    b = metadata.blocks[block_num]
    return b.offset, b.size, b.flags, b.hash


def qz_metadata_block_write(block_num: int, metadata: Metadata,
                            block_offset: Optional[int] = None,
                            block_size: Optional[int] = None,
                            block_flags: Optional[int] = None,
                            block_hash: Optional[int] = None) -> int:
    """qzMetadataBlockWrite: set the fields given; QZ_OK, QZ_PARAMS or
    QZ_OUT_OF_RANGE."""
    if metadata is None:
        return QZ_PARAMS
    if not 0 <= block_num < len(metadata.blocks):
        return QZ_OUT_OF_RANGE
    b = metadata.blocks[block_num]
    if block_offset is not None:
        b.offset = block_offset
    if block_size is not None:
        b.size = block_size
    if block_flags is not None:
        b.flags = block_flags
    if block_hash is not None:
        b.hash = block_hash
    return QZ_OK


def qz_compress_with_metadata(sess, src, metadata: Metadata, last: int = 1):
    """qzCompressWithMetadataExt: compress, then describe each member in
    ``metadata`` (offset, size, flags 1, xxh32 of its plain chunk).
    Returns (rc, out)."""
    from .formats.gzip_format import scan_members
    from .ops.xxhash import xxh32

    if metadata is None:
        return QZ_PARAMS, b""
    data = bytes(src)
    hw = sess.common.hw_buff_sz if sess.params else 64 * 1024
    try:
        out = sess.compress(data, last=bool(last))
    except QzError as e:
        return e.rc, b""
    prev_end = 0
    for i, m in enumerate(scan_members(out, sess.data_fmt)):
        if i >= len(metadata.blocks):
            break
        blk = metadata.blocks[i]
        blk.offset = m.offset - prev_end
        blk.size = m.total_sz
        blk.flags = 1
        blk.hash = xxh32(data[i * hw:(i + 1) * hw])
        prev_end = m.offset + m.total_sz
    return QZ_OK, out
