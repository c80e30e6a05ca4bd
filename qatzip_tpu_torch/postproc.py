"""The lz4s -> zstd post-process (the qzstd bridge).

Counterpart of ``qatzip_tpu/postproc.py`` (reference ``zstdCallBack``,
utils/qzstd.c:211-278): an LZ4s session's output, ``[size:u32][LZ4s
payload]*``, is decoded into (literal length, match length, offset)
sequences and written out again as standard zstd frames through
``ZSTD_compressSequences`` with explicit block delimiters, in the native
library (``qz_zstd_post_process``). The library reaches libzstd.so.1 by
its soname; where it is missing, every call here raises
QZ_POST_PROCESS_ERROR. There is no pure-Python zstd in its place.
"""

from __future__ import annotations

from . import native
from .constants import QZ_POST_PROCESS_ERROR, QzError


def zstd_callback(external, src: bytes, lz4s_blocks: bytes,
                  mini_match: int) -> bytes:
    """A ``SessionParamsLZ4S.qzCallback``: the zstd frames of ``src`` made
    from its LZ4s blocks. ``external`` may carry {"level": int}, the zstd
    level (0 = zstd's default)."""
    level = 0
    if isinstance(external, dict):
        level = int(external.get("level", 0))
    lib = native.get_lib()
    try:
        return lib.zstd_post_process(src, lz4s_blocks, mini_match, level)
    except RuntimeError as e:
        raise QzError(QZ_POST_PROCESS_ERROR, str(e)) from None


def zstd_compress(data: bytes, level: int = 3) -> bytes:
    """One zstd frame of ``data`` at ``level``."""
    lib = native.get_lib()
    try:
        return lib.zstd_compress(data, level)
    except RuntimeError as e:
        raise QzError(QZ_POST_PROCESS_ERROR, str(e)) from None


def zstd_decompress(data: bytes) -> bytes:
    """Decode one or more zstd frames (skippable frames skipped), growing
    the output buffer until it fits."""
    lib = native.get_lib()
    pos = 0
    while pos + 8 <= len(data):
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 != 0x184D2A50:
            break
        pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
    body = data[pos:]
    if not body:
        return b""
    cap = max(1 << 20, 4 * len(body))
    while True:
        try:
            return lib.zstd_decompress(body, cap)
        except BufferError:
            cap *= 4
        except RuntimeError as e:
            raise QzError(QZ_POST_PROCESS_ERROR, str(e)) from None
