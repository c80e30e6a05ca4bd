"""The streaming API: QzStream and the qz*Stream wrappers.

Counterpart of ``qatzip_tpu/stream.py`` (reference ``QzStream_T``,
include/qatzip.h:2002; ``qzCompressStream`` src/qatzip_stream.c:403-596,
``qzDecompressStream`` :599-748, ``qzEndStream`` :751-781).

Compress: input is staged in a pooled ``strm_buff_sz`` buffer
(``memory.qz_malloc``); each full unit, and the tail when ``last`` is
set, is one ``session.compress(unit)``, so a stream's members are those
of its units' requests. The running crc32 is carried across calls
(``crc_32``). A raw DEFLATE stream is one bit stream: one persistent
zlib deflater, full-flushed between calls.

Decompress: whole members are decoded as they complete and a partial one
is carried in ``pending_in``; raw and zlib streams go through one
persistent zlib inflater. ``max_out`` bounds what a call returns, the
rest is carried in ``pending_out`` and returned first by the next call.

Push and pull::

    strm = QzStream(sess)
    out = strm.compress(piece)
    out += strm.compress(b"", last=True)
    strm.end()
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from . import codec as _codec
from .constants import (DataFormat, QZ_DATA_ERROR, QZ_FAIL, QZ_OK, QZ_PARAMS,
                        QZ_STRM_BUFF_MAX_SZ, QZ_STRM_BUFF_MIN_SZ, QzError,
                        effective_deflate_sw_level)
from .memory import qz_free, qz_malloc
from .ops.checksum import crc32_combine


class QzStream:
    """A stream cursor bound to a session. Its staging buffer comes from
    the process-wide buffer pool and goes back to it at ``end()``."""

    def __init__(self, session, strm_buff_sz: Optional[int] = None):
        self.session = session
        if strm_buff_sz is None:
            strm_buff_sz = (session.common.strm_buff_sz if session.params
                            else 64 * 1024)
        if not QZ_STRM_BUFF_MIN_SZ <= strm_buff_sz <= QZ_STRM_BUFF_MAX_SZ:
            raise QzError(QZ_PARAMS,
                          f"strm_buff_sz {strm_buff_sz} out of range")
        self.strm_buff_sz = strm_buff_sz
        self._in_buf = qz_malloc(strm_buff_sz)
        self._in_len = 0
        self.pending_in = bytearray()    # decompress: a partial member
        self.pending_out = bytearray()   # output past a call's max_out
        self.crc_32 = 0
        self.total_in = 0
        self.total_out = 0
        self._raw_comp = None            # the DEFLATE_RAW deflater
        self._raw_decomp = None          # the raw / zlib inflater
        self._ended = False

    def _bound_out(self, out: bytes, max_out: Optional[int]) -> bytes:
        """``pending_out`` then ``out``, at most ``max_out`` bytes of it;
        the rest is carried (src/qatzip_stream.c:487-503)."""
        if self.pending_out:
            out = bytes(self.pending_out) + out
            self.pending_out.clear()
        if max_out is not None and len(out) > max_out:
            self.pending_out += out[max_out:]
            return out[:max_out]
        return out

    def compress(self, data=b"", last: bool = False,
                 max_out: Optional[int] = None) -> bytes:
        """Feed ``data``; returns the output ready so far (at most
        ``max_out`` bytes)."""
        if self._ended:
            raise QzError(QZ_FAIL, "stream ended")
        sess = self.session
        c = sess._ready()
        data = bytes(data)
        self.total_in += len(data)
        out = bytearray()

        if sess.data_fmt == DataFormat.DEFLATE_RAW and sess.algorithm == "deflate":
            if self._raw_comp is None:
                self._raw_comp = zlib.compressobj(
                    effective_deflate_sw_level(c.comp_lvl), zlib.DEFLATED, -15)
            self.crc_32 = crc32_combine(self.crc_32, zlib.crc32(data),
                                        len(data))
            out += self._raw_comp.compress(data)
            if last:
                out += self._raw_comp.flush(zlib.Z_FINISH)
                self._raw_comp = None
            else:
                out += self._raw_comp.flush(zlib.Z_FULL_FLUSH)
            self.total_out += len(out)
            return self._bound_out(bytes(out), max_out)

        pos = 0
        while True:
            take = min(len(data) - pos, self.strm_buff_sz - self._in_len)
            if take:
                self._in_buf[self._in_len:self._in_len + take] = \
                    np.frombuffer(data, np.uint8, take, pos)
                self._in_len += take
                pos += take
            flush_last = last and pos == len(data)
            if self._in_len == self.strm_buff_sz or flush_last:
                unit = self._in_buf[:self._in_len].tobytes()
                self._in_len = 0
                blob, crc = sess.compress(unit, last=flush_last,
                                          with_crc=True)
                self.crc_32 = crc32_combine(self.crc_32, crc, len(unit))
                out += blob
            if pos >= len(data):
                break
        self.total_out += len(out)
        return self._bound_out(bytes(out), max_out)

    def decompress(self, data=b"", last: bool = False,
                   max_out: Optional[int] = None) -> bytes:
        """Feed compressed ``data``; returns the output ready so far (at
        most ``max_out`` bytes). Before ``last``, input that does not
        decode yet waits for more; on ``last`` it raises, and so do
        trailing bytes after the last whole member."""
        if self._ended:
            raise QzError(QZ_FAIL, "stream ended")
        sess = self.session
        sess._ready()
        fmt = sess.data_fmt
        self.pending_in += bytes(data)
        self.total_in += len(data)

        if fmt in (DataFormat.DEFLATE_RAW, DataFormat.ZLIB):
            if self._raw_decomp is None:
                self._raw_decomp = zlib.decompressobj(
                    -15 if fmt == DataFormat.DEFLATE_RAW else 15)
            try:
                piece = self._raw_decomp.decompress(bytes(self.pending_in))
                if last:
                    piece += self._raw_decomp.flush()
            except zlib.error as e:
                raise QzError(QZ_DATA_ERROR, str(e)) from None
            self.pending_in.clear()
            self.total_out += len(piece)
            return self._bound_out(piece, max_out)

        try:
            out, consumed, _crc = _codec.decompress_buffer(
                bytes(self.pending_in), algorithm=sess.algorithm,
                data_fmt=fmt, engine=sess._engine)
        except QzError:
            if last:
                raise
            return self._bound_out(b"", max_out)
        del self.pending_in[:consumed]
        if last and self.pending_in:
            raise QzError(QZ_DATA_ERROR, "trailing garbage in stream")
        self.total_out += len(out)
        return self._bound_out(out, max_out)

    def end(self) -> int:
        """qzEndStream: drop the state and return the staging buffer to
        the pool."""
        if self._in_buf is not None:
            qz_free(self._in_buf)
            self._in_buf = None
        self.pending_in = bytearray()
        self.pending_out = bytearray()
        self._raw_comp = None
        self._raw_decomp = None
        self._ended = True
        return QZ_OK


def qz_compress_stream(sess, strm: QzStream, data, last: int = 0):
    """qzCompressStream: (rc, output)."""
    try:
        return QZ_OK, strm.compress(data, last=bool(last))
    except QzError as e:
        return e.rc, b""


def qz_decompress_stream(sess, strm: QzStream, data, last: int = 0):
    """qzDecompressStream: (rc, output)."""
    try:
        return QZ_OK, strm.decompress(data, last=bool(last))
    except QzError as e:
        return e.rc, b""


def qz_end_stream(sess, strm: QzStream) -> int:
    """qzEndStream."""
    return strm.end()
