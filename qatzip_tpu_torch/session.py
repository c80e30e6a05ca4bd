"""The compression session.

Counterpart of ``qatzip_tpu/session.py`` (``QzSession_T``,
qzSetupSessionDeflate / LZ4 / LZ4S, qzCompress, qzDecompress,
qzMaxCompressedLength). The session takes the torch device it runs on:
``"cuda"`` (the default) or ``"cpu"``, which runs the kernels' plain
versions. An LZ4s session runs its post-process callback (for example
``postproc.zstd_callback``) on each compressed request.
"""

from __future__ import annotations

import copy

from . import codec as _codec
from .constants import (DataFormat, Direction, HuffmanHdr, QZ_AUTO_SELECT_BEST,
                        QZ_EMPTY_OUT_SZ_GZIP_EXT, QZ_NOT_SUPPORTED, QZ_OK,
                        QZ_PARAMS, QZ_POST_PROCESS_ERROR, QzError)
from .ops.checksum import crc32_combine
from .params import SessionParamsDeflate, SessionParamsLZ4, SessionParamsLZ4S
from .runtime import get_runtime

_HDR_FTR = {DataFormat.DEFLATE_GZIP_EXT: 24 + 8, DataFormat.DEFLATE_GZIP: 10 + 8,
            DataFormat.DEFLATE_4B: 4}
DEFLATE_SKID_PAD = 48
LZ4_FRAME_HDR_FTR = 15 + 8
LZ4_BLK_HEADER_SZ = 4


class QzSession:
    """A compression session on one torch device."""

    def __init__(self, device="cuda"):
        self._engine = get_runtime().get_engine(device)
        self.device = self._engine.device
        self.params = None
        self.algorithm = "deflate"
        self.data_fmt = DataFormat.DEFLATE_GZIP_EXT
        self.huffman_hdr = HuffmanHdr.DYNAMIC_HDR
        self.mini_match = 3
        self.qz_callback = None
        self.qz_callback_external = None
        self.total_in = 0
        self.total_out = 0
        self.crc32 = 0

    def _setup(self, params, algorithm: str) -> int:
        rc = params.check()
        if rc != QZ_OK:
            return rc
        if params.common.sw_backup == QZ_AUTO_SELECT_BEST:
            raise QzError(QZ_NOT_SUPPORTED, "QZ_AUTO_SELECT_BEST is not "
                          "ported to qatzip_tpu_torch yet")
        self.params = copy.deepcopy(params)
        self.algorithm = algorithm
        return QZ_OK

    def setup_deflate(self, params: SessionParamsDeflate = None) -> int:
        """qzSetupSessionDeflate: validate and adopt ``params``. Returns
        QZ_OK or QZ_PARAMS."""
        params = params or SessionParamsDeflate()
        rc = self._setup(params, "deflate")
        if rc == QZ_OK:
            self.data_fmt = params.data_fmt
            self.huffman_hdr = params.huffman_hdr
        return rc

    def setup_lz4(self, params: SessionParamsLZ4 = None) -> int:
        """qzSetupSessionLZ4: LZ4 frames of 64 KiB blocks."""
        rc = self._setup(params or SessionParamsLZ4(), "lz4")
        if rc == QZ_OK:
            self.data_fmt = DataFormat.LZ4
        return rc

    def setup_lz4s(self, params: SessionParamsLZ4S = None) -> int:
        """qzSetupSessionLZ4S: LZ4s block streams, handed to the params'
        ``qzCallback`` when it is set."""
        params = params or SessionParamsLZ4S()
        rc = self._setup(params, "lz4s")
        if rc == QZ_OK:
            self.data_fmt = DataFormat.LZ4S
            self.mini_match = params.lz4s_mini_match
            self.qz_callback = params.qzCallback
            self.qz_callback_external = params.callback_external
        return rc

    def _common(self):
        if self.params is None:
            self.setup_deflate()
        return self.params.common

    def compress(self, data, with_crc: bool = False):
        """Compress ``data`` to framed output (bytes, or (bytes, crc32)
        with ``with_crc``); updates the session totals and running crc.
        An LZ4s session with a callback returns the callback's output
        (reference src/qatzip.c:2217-2249); a callback that fails raises
        QZ_POST_PROCESS_ERROR."""
        c = self._common()
        if c.direction == Direction.DIR_DECOMPRESS:
            raise QzError(QZ_PARAMS, "session is decompress-only")
        data = bytes(data)
        out, crc = _codec.compress_buffer(
            data, algorithm=self.algorithm, data_fmt=self.data_fmt,
            level=c.comp_lvl, hw_buff_sz=c.hw_buff_sz, engine=self._engine,
            input_sz_thrshold=c.input_sz_thrshold, mini_match=self.mini_match,
            huffman_static=self.huffman_hdr == HuffmanHdr.STATIC_HDR)
        if self.algorithm == "lz4s" and self.qz_callback is not None:
            try:
                out = self.qz_callback(self.qz_callback_external, data, out,
                                       self.mini_match)
            except Exception as e:  # noqa: BLE001 (any callback failure)
                raise QzError(QZ_POST_PROCESS_ERROR, str(e)) from None
        self.total_in += len(data)
        self.total_out += len(out)
        self.crc32 = crc32_combine(self.crc32, crc, len(data))
        return (out, crc) if with_crc else out

    def decompress(self, data) -> bytes:
        """qzDecompress: decode the session's framing, verifying each
        member's or frame's checksum."""
        if self._common().direction == Direction.DIR_COMPRESS:
            raise QzError(QZ_PARAMS, "session is compress-only")
        out, consumed, _crc = _codec.decompress_buffer(
            bytes(data), data_fmt=self.data_fmt, algorithm=self.algorithm)
        self.total_in += consumed
        self.total_out += len(out)
        return out

    def max_compressed_length(self, src_sz: int) -> int:
        """qzMaxCompressedLength (src/qatzip.c:3175-3211, LZ4
        :3332-3370, LZ4s :3292-3330)."""
        hw = self._common().hw_buff_sz
        if self.algorithm != "deflate":
            chunks = -(-src_sz // min(hw, 64 * 1024))
            if self.algorithm == "lz4":
                if src_sz == 0:
                    return LZ4_FRAME_HDR_FTR + LZ4_BLK_HEADER_SZ + 1
                return (LZ4_FRAME_HDR_FTR + chunks * LZ4_BLK_HEADER_SZ
                        + src_sz + -(-src_sz // 1520) * 13 + 1024)
            if src_sz == 0:
                return LZ4_BLK_HEADER_SZ + 1
            return (src_sz + -(-src_sz // 2000) * 11 + 1024
                    + chunks * LZ4_BLK_HEADER_SZ)
        hdr_ftr = _HDR_FTR.get(self.data_fmt, 0)
        if src_sz == 0:
            if self.data_fmt == DataFormat.DEFLATE_GZIP_EXT:
                return QZ_EMPTY_OUT_SZ_GZIP_EXT
            return hdr_ftr + 8
        chunks = -(-src_sz // hw)
        return (src_sz + -(-src_sz // 8)
                + chunks * (hdr_ftr + DEFLATE_SKID_PAD))
