"""Public enums, return codes, the session defaults and the LZ4 framing
constants.

Counterpart of ``qatzip_tpu/constants.py``; values stay numerically
identical to the reference's ``include/qatzip.h`` so parameters and return
codes carry across both packages unchanged.
"""

from __future__ import annotations

import enum

#: the API version the session reports among its software components
API_VERSION = "2.3-torch"


class HuffmanHdr(enum.IntEnum):
    """Huffman header type (reference ``QzHuffmanHdr_T``)."""

    DYNAMIC_HDR = 0
    STATIC_HDR = 1


class MemType(enum.IntEnum):
    """Memory placement of a buffer (reference ``PinMem_T``): PINNED
    buffers come from and return to the pool (``memory.py``), COMMON ones
    are plain host memory."""

    DEFLATE_4B = -1      # kept from the JAX package's enum, never used
    COMMON_MEM = 0
    PINNED_MEM = 1


class Direction(enum.IntEnum):
    """Session direction (reference ``QzDirection_T``)."""

    DIR_COMPRESS = 0
    DIR_DECOMPRESS = 1
    DIR_BOTH = 2


class DataFormat(enum.IntEnum):
    """On-wire framing format (reference ``QzDataFormat_T``)."""

    DEFLATE_4B = 0
    DEFLATE_GZIP = 1
    DEFLATE_GZIP_EXT = 2
    DEFLATE_RAW = 3
    LZ4 = 4
    LZ4S = 5
    ZLIB = 6


class PollingMode(enum.IntEnum):
    """Polling mode (reference ``QzPollingMode_T``)."""

    PERIODICAL_POLLING = 0
    BUSY_POLLING = 1


class CrcType(enum.IntEnum):
    """Checksum selector (reference ``QzCrcType_T``)."""

    NONE = 0
    CRC32 = 1
    ADLER32 = 2
    XXHASH32 = 3
    CRC64 = 4


class SessionState(enum.IntEnum):
    """Session state (reference qatzip_internal.h session states)."""

    QZ_NONE = 0
    QZ_INIT_HW = 1
    QZ_INIT_SW = 2
    QZ_SETUP_HW = 3
    QZ_SETUP_SW = 4


# Return codes (reference include/qatzip.h, numeric parity).
QZ_OK = 0
QZ_DUPLICATE = 1
QZ_FORCE_SW = 2
QZ_PARAMS = -1
QZ_FAIL = -2
QZ_BUF_ERROR = -3
QZ_DATA_ERROR = -4
QZ_TIMEOUT = -5
QZ_INTEG = -100
QZ_NO_HW = 11
QZ_NO_MDRV = 12
QZ_NO_INST_ATTACH = 13
QZ_LOW_MEM = 14
QZ_LOW_DEST_MEM = 15
QZ_UNSUPPORTED_FMT = 16
QZ_NONE = 100
QZ_NOSW_NO_HW = -101
QZ_NOSW_NO_MDRV = -102
QZ_NOSW_NO_INST_ATTACH = -103
QZ_NOSW_LOW_MEM = -104
QZ_NO_SW_AVAIL = -105
QZ_NOSW_UNSUPPORTED_FMT = -116
QZ_POST_PROCESS_ERROR = -117
QZ_METADATA_OVERFLOW = -118
QZ_OUT_OF_RANGE = -119
QZ_NOT_SUPPORTED = -200

#: the async return codes as the JAX package's constants carry them; its
#: async engine (and ``async_engine.py`` here) returns 0, 1 and 2 instead
AQZ_OK = 0
AQZ_NO_SPACE = -300
AQZ_STOPPED = -301

QZ_SW_BACKUP_OFF = 0
QZ_SW_BACKUP_ON = 1
QZ_AUTO_SELECT_BEST = 2

# Defaults (reference include/qatzip.h:563-589).
QZ_DIRECTION_DEFAULT = Direction.DIR_BOTH
QZ_COMP_LEVEL_DEFAULT = 1
QZ_COMP_ALGOL_DEFAULT = "deflate"
QZ_POLL_SLEEP_DEFAULT = 10
QZ_DATA_FORMAT_DEFAULT = DataFormat.DEFLATE_GZIP_EXT
QZ_MAX_FORKS_DEFAULT = 3
QZ_SW_BACKUP_DEFAULT = 1
QZ_HW_BUFF_SZ = 64 * 1024
QZ_HW_BUFF_MIN_SZ = 1 * 1024
QZ_HW_BUFF_MAX_SZ = 512 * 1024
QZ_STRM_BUFF_SZ_DEFAULT = QZ_HW_BUFF_SZ
QZ_STRM_BUFF_MIN_SZ = 1 * 1024
QZ_STRM_BUFF_MAX_SZ = 2 * 1024 * 1024 - 5 * 1024
QZ_COMP_THRESHOLD_DEFAULT = 1024
QZ_COMP_THRESHOLD_MINIMUM = 128
QZ_REQ_THRESHOLD_MINIMUM = 1
QZ_REQ_THRESHOLD_MAXIMUM = 32
QZ_REQ_THRESHOLD_DEFAULT = QZ_REQ_THRESHOLD_MAXIMUM
QZ_WAIT_CNT_THRESHOLD_DEFAULT = 8
QZ_DEFLATE_COMP_LVL_MINIMUM = 1
QZ_DEFLATE_COMP_LVL_MAXIMUM = 9
QZ_DEFLATE_COMP_LVL_MAXIMUM_GEN4 = 12
QZ_LZ4_COMP_LVL_MINIMUM = 1
QZ_LZ4_COMP_LVL_MAXIMUM = 12

#: in-flight ring depth per device lane (reference qatzip_internal.h:63-68)
QZ_NUM_BUFF = 32
QZ_NUM_BUFF_SMALL_CHUNK = 128
#: largest deflate stored-block payload (qatzip_internal.h:85)
QZ_STORED_BLK_MAX = 65535
#: deflate history window
QZ_HISTORY_WINDOW = 32 * 1024
#: the reference's adaptive polling ladder, microseconds (src/qatzip.c:75-78)
QZ_POLLING_LADDER_US = (
    10, 20, 40, 80, 160, 320, 640, 1000,
    2000, 4000, 8000, 16000, 24000, 32000, 48000, 64000,
)
#: most retries of a device submit (qatzip_internal.h:69)
QZ_MAX_NUM_RETRY = 500

#: LZ4 frame constants (reference src/qatzip_internal.h:136-158)
LZ4_MAGIC = 0x184D2204
LZ4_SKIPPABLE_MAGIC_MIN = 0x184D2A50
LZ4_SKIPPABLE_MAGIC_MAX = 0x184D2A5F
LZ4_FRAME_VERSION = 1
LZ4_MAX_BLOCK_SIZE_ID = 4  # 64 KiB blocks
LZ4_BLOCK_UNCOMPRESSED_FLAG = 0x80000000
#: the LZ4s minimum match (3 or 4) of a session that does not set one
LZ4S_MIN_MATCH_DEFAULT = 3

#: Size of output for a zero-byte gzip-ext compress (reference qatzip.h:1694)
QZ_EMPTY_OUT_SZ_GZIP_EXT = 34


def effective_deflate_sw_level(level: int) -> int:
    """QATzip level -> zlib level: 1-4 map through, 5-8 clamp to 4, 9 = 9."""
    if level <= 4:
        return max(1, level)
    if level <= 8:
        return 4
    return 9


# Only genuine return codes: limits such as QZ_HW_BUFF_SZ are not rcs.
# The first name of a value wins (AQZ_OK is QZ_OK).
_RC_NAMES: dict = {}
for _k in (
        "QZ_OK", "QZ_DUPLICATE", "QZ_FORCE_SW", "QZ_PARAMS", "QZ_FAIL",
        "QZ_BUF_ERROR", "QZ_DATA_ERROR", "QZ_TIMEOUT", "QZ_INTEG",
        "QZ_NO_HW", "QZ_NO_MDRV", "QZ_NO_INST_ATTACH", "QZ_LOW_MEM",
        "QZ_LOW_DEST_MEM", "QZ_UNSUPPORTED_FMT", "QZ_NONE", "QZ_NOSW_NO_HW",
        "QZ_NOSW_NO_MDRV", "QZ_NOSW_NO_INST_ATTACH", "QZ_NOSW_LOW_MEM",
        "QZ_NO_SW_AVAIL", "QZ_NOSW_UNSUPPORTED_FMT", "QZ_POST_PROCESS_ERROR",
        "QZ_METADATA_OVERFLOW", "QZ_OUT_OF_RANGE", "QZ_NOT_SUPPORTED",
        "AQZ_OK", "AQZ_NO_SPACE", "AQZ_STOPPED"):
    _RC_NAMES.setdefault(globals()[_k], _k)


def rc_name(rc: int) -> str:
    """Human-readable name for a return code."""
    return _RC_NAMES.get(rc, f"QZ_RC({rc})")


class QzError(Exception):
    """Exception carrying a QZ return code, raised by the pythonic API."""

    def __init__(self, rc: int, msg: str = ""):
        self.rc = rc
        super().__init__(f"{rc_name(rc)}{': ' + msg if msg else ''}")
