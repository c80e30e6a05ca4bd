"""Session parameter structs and their validation.

Counterpart of ``qatzip_tpu/params.py`` for the deflate, LZ4 and LZ4s
sessions: the same fields, defaults and checks (reference
``qzCheckParams*``, src/qatzip_utils.c:385-520).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import constants as C
from .constants import DataFormat, Direction, HuffmanHdr, PollingMode, QZ_OK, QZ_PARAMS


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass
class SessionParamsCommon:
    """Fields shared by every algorithm (``QzSessionParamsCommon_T``)."""

    direction: Direction = C.QZ_DIRECTION_DEFAULT
    comp_lvl: int = C.QZ_COMP_LEVEL_DEFAULT
    comp_algorithm: str = "deflate"
    max_forks: int = C.QZ_MAX_FORKS_DEFAULT
    sw_backup: int = C.QZ_SW_BACKUP_DEFAULT
    hw_buff_sz: int = C.QZ_HW_BUFF_SZ
    strm_buff_sz: int = C.QZ_STRM_BUFF_SZ_DEFAULT
    input_sz_thrshold: int = C.QZ_COMP_THRESHOLD_DEFAULT
    req_cnt_thrshold: int = C.QZ_REQ_THRESHOLD_DEFAULT
    wait_cnt_thrshold: int = C.QZ_WAIT_CNT_THRESHOLD_DEFAULT
    polling_mode: PollingMode = PollingMode.PERIODICAL_POLLING
    is_sensitive_mode: bool = False

    def check(self, *, max_level: int = C.QZ_DEFLATE_COMP_LVL_MAXIMUM) -> int:
        """Validate; returns QZ_OK or QZ_PARAMS."""
        if self.direction not in (Direction.DIR_COMPRESS,
                                  Direction.DIR_DECOMPRESS,
                                  Direction.DIR_BOTH):
            return QZ_PARAMS
        if not (1 <= self.comp_lvl <= max_level):
            return QZ_PARAMS
        if self.sw_backup not in (C.QZ_SW_BACKUP_OFF, C.QZ_SW_BACKUP_ON,
                                  C.QZ_AUTO_SELECT_BEST):
            return QZ_PARAMS
        if not (_is_pow2(self.hw_buff_sz)
                and C.QZ_HW_BUFF_MIN_SZ <= self.hw_buff_sz <= C.QZ_HW_BUFF_MAX_SZ):
            return QZ_PARAMS
        if not (C.QZ_STRM_BUFF_MIN_SZ <= self.strm_buff_sz
                <= C.QZ_STRM_BUFF_MAX_SZ):
            return QZ_PARAMS
        if self.input_sz_thrshold < C.QZ_COMP_THRESHOLD_MINIMUM:
            return QZ_PARAMS
        if not (C.QZ_REQ_THRESHOLD_MINIMUM <= self.req_cnt_thrshold
                <= C.QZ_REQ_THRESHOLD_MAXIMUM):
            return QZ_PARAMS
        return QZ_OK


@dataclasses.dataclass
class SessionParamsDeflate:
    """Deflate session params (``QzSessionParamsDeflate_T``)."""

    common: SessionParamsCommon = dataclasses.field(
        default_factory=SessionParamsCommon)
    huffman_hdr: HuffmanHdr = HuffmanHdr.DYNAMIC_HDR
    data_fmt: DataFormat = C.QZ_DATA_FORMAT_DEFAULT

    def check(self) -> int:
        rc = self.common.check()
        if rc != QZ_OK:
            return rc
        if self.huffman_hdr not in (HuffmanHdr.DYNAMIC_HDR,
                                    HuffmanHdr.STATIC_HDR):
            return QZ_PARAMS
        if self.data_fmt not in (DataFormat.DEFLATE_4B, DataFormat.DEFLATE_GZIP,
                                 DataFormat.DEFLATE_GZIP_EXT,
                                 DataFormat.DEFLATE_RAW, DataFormat.ZLIB):
            return QZ_PARAMS
        return QZ_OK


@dataclasses.dataclass
class SessionParamsLZ4:
    """LZ4 session params (``QzSessionParamsLZ4_T``)."""

    common: SessionParamsCommon = dataclasses.field(
        default_factory=SessionParamsCommon)

    def check(self) -> int:
        return self.common.check(max_level=C.QZ_LZ4_COMP_LVL_MAXIMUM)


@dataclasses.dataclass
class SessionParamsLZ4S:
    """LZ4s session params (``QzSessionParamsLZ4S_T``). ``qzCallback`` is
    the post-process hook the session runs on each compressed request,
    ``qzCallback(callback_external, src, lz4s_blocks, mini_match)``
    (reference ``qzLZ4SCallbackFn``; ``postproc.zstd_callback`` is the
    lz4s -> zstd one)."""

    common: SessionParamsCommon = dataclasses.field(
        default_factory=SessionParamsCommon)
    lz4s_mini_match: int = C.LZ4S_MIN_MATCH_DEFAULT
    qzCallback: Optional[Callable] = None
    callback_external: Optional[object] = None

    def check(self) -> int:
        rc = self.common.check(max_level=C.QZ_LZ4_COMP_LVL_MAXIMUM)
        if rc != QZ_OK:
            return rc
        if self.lz4s_mini_match not in (3, 4):
            return QZ_PARAMS
        return QZ_OK
