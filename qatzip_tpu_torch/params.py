"""Session parameter structs, their validation and the process defaults.

Counterpart of ``qatzip_tpu/params.py``: the deflate, LZ4 and LZ4s
params and the legacy combined params, with the same fields, defaults and
checks (reference ``qzCheckParams*``, src/qatzip_utils.c:385-520), and
``get_defaults`` / ``set_defaults`` (qz{Get,Set}Defaults*,
src/qatzip.c:3071-3174). No configuration file overlays the defaults:
the JAX package's ``.conf`` loader is not ported.
"""

from __future__ import annotations

import copy
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


@dataclasses.dataclass
class SessionParams:
    """Legacy combined params (``QzSessionParams_T``), deflate only, for
    the legacy setup (qzSetupSession, src/qatzip.c:1027-1068)."""

    huffman_hdr: HuffmanHdr = HuffmanHdr.DYNAMIC_HDR
    direction: Direction = C.QZ_DIRECTION_DEFAULT
    data_fmt: DataFormat = C.QZ_DATA_FORMAT_DEFAULT
    comp_lvl: int = C.QZ_COMP_LEVEL_DEFAULT
    comp_algorithm: str = "deflate"
    max_forks: int = C.QZ_MAX_FORKS_DEFAULT
    sw_backup: int = C.QZ_SW_BACKUP_DEFAULT
    hw_buff_sz: int = C.QZ_HW_BUFF_SZ
    strm_buff_sz: int = C.QZ_STRM_BUFF_SZ_DEFAULT
    input_sz_thrshold: int = C.QZ_COMP_THRESHOLD_DEFAULT
    req_cnt_thrshold: int = C.QZ_REQ_THRESHOLD_DEFAULT
    wait_cnt_thrshold: int = C.QZ_WAIT_CNT_THRESHOLD_DEFAULT

    def to_deflate(self) -> SessionParamsDeflate:
        common = SessionParamsCommon(
            direction=self.direction, comp_lvl=self.comp_lvl,
            comp_algorithm=self.comp_algorithm, max_forks=self.max_forks,
            sw_backup=self.sw_backup, hw_buff_sz=self.hw_buff_sz,
            strm_buff_sz=self.strm_buff_sz,
            input_sz_thrshold=self.input_sz_thrshold,
            req_cnt_thrshold=self.req_cnt_thrshold,
            wait_cnt_thrshold=self.wait_cnt_thrshold)
        return SessionParamsDeflate(common=common,
                                    huffman_hdr=self.huffman_hdr,
                                    data_fmt=self.data_fmt)

    def check(self) -> int:
        """The deflate checks; the legacy API stops at level 9, which it
        sends to software zlib (src/qatzip.c:2101-2103)."""
        return self.to_deflate().check()


_defaults = {"deflate": SessionParamsDeflate(), "lz4": SessionParamsLZ4(),
             "lz4s": SessionParamsLZ4S(), "legacy": SessionParams()}


def get_defaults(kind: str = "legacy"):
    """qzGetDefaults: a copy of the current defaults of ``kind``
    ("deflate", "lz4", "lz4s" or "legacy")."""
    return copy.deepcopy(_defaults[kind])


def set_defaults(params, kind: str = "legacy") -> int:
    """qzSetDefaults: check ``params`` and install a copy as the defaults
    of ``kind``. Returns QZ_OK or QZ_PARAMS."""
    rc = params.check()
    if rc != QZ_OK:
        return rc
    _defaults[kind] = copy.deepcopy(params)
    return QZ_OK
