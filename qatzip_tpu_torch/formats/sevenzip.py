"""7z archive container — writer and reader.

Parity reference: utils/qzip_7z.c (3311 LoC): signature header
(Qz7zSignatureHeader_T, utils/qzip.h:348), end-header property tree
(PackInfo / CodersInfo / SubStreamsInfo / FilesInfo, utils/qzip.h:321-520,
writers utils/qzip_7z.c:2731-3060, resolvers :784-1537), the
concatenate-all-files-into-one-DEFLATE_RAW-stream compression strategy
(doCompressFile :447-737), and the varint number codec
(getU64FromBytes/getUint64Bytes :182-246).

Re-implemented from the public 7z format description. The payload stream
is compressed through a framework session (on the session's device); the
reader additionally understands Copy, LZMA1 and LZMA2 coders so archives
produced by stock 7-Zip extract too (reference decompresses 7z in software
only, README.md:128).

The port's own copy of ``qatzip_tpu/formats/sevenzip.py``, which imports
no JAX: the same writer, reader and hardened extraction, against the
port's ``constants``.
"""

from __future__ import annotations

import io
import os
import stat as statmod
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..constants import QZ_DATA_ERROR, QzError

MAGIC = b"7z\xbc\xaf\x27\x1c"
VERSION = b"\x00\x04"

K_END = 0x00
K_HEADER = 0x01
K_MAIN_STREAMS = 0x04
K_FILES_INFO = 0x05
K_PACK_INFO = 0x06
K_UNPACK_INFO = 0x07
K_SUBSTREAMS_INFO = 0x08
K_SIZE = 0x09
K_CRC = 0x0A
K_FOLDER = 0x0B
K_CODERS_UNPACK_SIZE = 0x0C
K_NUM_UNPACK_STREAM = 0x0D
K_EMPTY_STREAM = 0x0E
K_EMPTY_FILE = 0x0F
K_NAME = 0x11
K_MTIME = 0x14
K_ATTRIBUTES = 0x15
K_ENCODED_HEADER = 0x17
K_DUMMY = 0x19

CODEC_COPY = b"\x00"
CODEC_DELTA = b"\x03"
CODEC_DEFLATE = b"\x04\x01\x08"
CODEC_LZMA1 = b"\x03\x01\x01"
CODEC_LZMA2 = b"\x21"
CODEC_BCJ_X86 = b"\x03\x03\x01\x03"
CODEC_BCJ2 = b"\x03\x03\x01\x1b"

FILETIME_EPOCH = 11644473600  # seconds between 1601 and 1970


# ---------------------------------------------------------------------------
# Branch-converter / delta filters (decoded stage of stock 7z folders)
# ---------------------------------------------------------------------------

def _test86(b: int) -> bool:
    return b == 0x00 or b == 0xFF


_MASK_ALLOWED = (True, True, True, False, True, False, False, False)
_MASK_BITNUM = (0, 1, 2, 2, 3, 3, 3, 3)


def bcj_x86_filter(data: bytes, encode: bool) -> bytes:
    """x86 BCJ branch converter (E8/E9 rel32<->abs32), one-shot.

    Same transform as 7-Zip's Bra86 / liblzma's x86 simple filter; applied
    to a folder's full filter-stage stream (ip base 0). Cross-validated in
    tests against liblzma's FILTER_X86 output.
    """
    buf = bytearray(data)
    size = len(buf)
    if size < 5:
        return bytes(buf)
    prev_mask = 0
    prev_pos = -5
    limit = size - 5
    pos = 0
    while pos <= limit:
        # fast scan to the next E8/E9 opcode
        i8 = buf.find(0xE8, pos, limit + 1)
        i9 = buf.find(0xE9, pos, limit + 1)
        if i8 < 0 and i9 < 0:
            break
        pos = min(x for x in (i8, i9) if x >= 0)
        if pos > limit:
            break
        offset = pos - prev_pos
        prev_pos = pos
        if offset > 5:
            prev_mask = 0
        else:
            for _ in range(offset):
                prev_mask = (prev_mask & 0x77) << 1
        b = buf[pos + 4]
        if (_test86(b) and _MASK_ALLOWED[(prev_mask >> 1) & 0x7]
                and (prev_mask >> 1) < 0x10):
            src = ((b << 24) | (buf[pos + 3] << 16)
                   | (buf[pos + 2] << 8) | buf[pos + 1])
            while True:
                if encode:
                    dest = (src + (pos + 5)) & 0xFFFFFFFF
                else:
                    dest = (src - (pos + 5)) & 0xFFFFFFFF
                if prev_mask == 0:
                    break
                i = _MASK_BITNUM[prev_mask >> 1]
                b = (dest >> (24 - i * 8)) & 0xFF
                if not _test86(b):
                    break
                src = dest ^ ((1 << (32 - i * 8)) - 1)
            buf[pos + 4] = (~(((dest >> 24) & 1) - 1)) & 0xFF
            buf[pos + 3] = (dest >> 16) & 0xFF
            buf[pos + 2] = (dest >> 8) & 0xFF
            buf[pos + 1] = dest & 0xFF
            pos += 5
            prev_mask = 0
        else:
            prev_mask |= 1
            if _test86(b):
                prev_mask |= 0x10
            pos += 1
    return bytes(buf)


def delta_filter(data: bytes, dist: int, encode: bool) -> bytes:
    """Delta filter (7z codec 0x03): byte delta at ``dist`` spacing."""
    if not 1 <= dist <= 256:
        raise QzError(QZ_DATA_ERROR, f"7z: bad delta distance {dist}")
    import numpy as np
    a = np.frombuffer(data, np.uint8).copy()
    if encode:
        a[dist:] = a[dist:] - a[:-dist]
        return a.tobytes()
    # decode: per-phase cumulative sum (out[i] = in[i] + out[i-dist])
    n = len(a)
    for phase in range(min(dist, n)):
        a[phase::dist] = np.cumsum(a[phase::dist], dtype=np.uint8)
    return a.tobytes()


# ---------------------------------------------------------------------------
# BCJ2 (codec 0x0303011B): 4-stream x86 branch converter.
#
# Stock 7-Zip splits x86 code into main bytes + big-endian absolute CALL
# targets + JUMP targets + a range-coded control stream that marks which
# E8/E9/0F8x opcodes were converted. The range coder is the standard
# LZMA binary model (11-bit probabilities, 5 move bits, 2^24 top value)
# with 256 adaptive contexts for E8 (indexed by the previous byte) plus
# one each for E9 and Jcc. Implemented from the public format; the
# reference's 7z reader handles only its own deflate folders
# (utils/qzip_7z.c:44), so this exceeds parity.
# ---------------------------------------------------------------------------

_RC_TOP = 1 << 24
_RC_MODEL_TOTAL_BITS = 11
_RC_MOVE_BITS = 5


class _RangeDecoder:
    """LZMA-style binary range decoder over one control stream."""

    def __init__(self, data: bytes):
        self.data = data
        # stock Bcj2Dec shifts FIVE bytes into the 32-bit code — the
        # first byte falls off the top and its value is ignored (encoders
        # emit 0, but an unusual-yet-decodable archive must not be
        # rejected), so skip it without validating
        self.pos = 1
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF

    def _byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode_bit(self, probs: list, i: int) -> int:
        ttt = probs[i]
        bound = (self.range >> _RC_MODEL_TOTAL_BITS) * ttt
        if self.code < bound:
            self.range = bound
            probs[i] = ttt + (((1 << _RC_MODEL_TOTAL_BITS) - ttt)
                              >> _RC_MOVE_BITS)
            bit = 0
        else:
            self.range -= bound
            self.code -= bound
            probs[i] = ttt - (ttt >> _RC_MOVE_BITS)
            bit = 1
        if self.range < _RC_TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
        return bit


class _RangeEncoder:
    """LZMA-style binary range encoder (fixture/writer side of BCJ2)."""

    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def encode_bit(self, probs: list, i: int, bit: int):
        ttt = probs[i]
        bound = (self.range >> _RC_MODEL_TOTAL_BITS) * ttt
        if bit == 0:
            self.range = bound
            probs[i] = ttt + (((1 << _RC_MODEL_TOTAL_BITS) - ttt)
                              >> _RC_MOVE_BITS)
        else:
            self.low += bound
            self.range -= bound
            probs[i] = ttt - (ttt >> _RC_MOVE_BITS)
        while self.range < _RC_TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self._shift_low()

    def _shift_low(self):
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            temp = self.cache
            while True:
                self.out.append((temp + carry) & 0xFF)
                temp = 0xFF
                self.cache_size -= 1
                if self.cache_size == 0:
                    break
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low & 0x00FFFFFF) << 8

    def flush(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


def _bcj2_is_marker(prev: int, b: int) -> bool:
    return b == 0xE8 or b == 0xE9 or (prev == 0x0F and (b & 0xF0) == 0x80)


def _bcj2_prob_index(prev: int, b: int) -> int:
    # E8 adapts per previous byte; E9 and Jcc each get one context
    return prev if b == 0xE8 else (256 if b == 0xE9 else 257)


def bcj2_decode(main: bytes, call: bytes, jump: bytes, rc: bytes,
                out_size: int) -> bytes:
    """Decode BCJ2's four streams back into the original byte stream."""
    probs = [1 << (_RC_MODEL_TOTAL_BITS - 1)] * 258
    rd = _RangeDecoder(rc)
    out = bytearray()
    mi = ci = ji = 0
    prev = 0
    while len(out) < out_size:
        if mi >= len(main):
            raise QzError(QZ_DATA_ERROR, "7z: BCJ2 main stream truncated")
        b = main[mi]
        mi += 1
        out.append(b)
        if _bcj2_is_marker(prev, b):
            if rd.decode_bit(probs, _bcj2_prob_index(prev, b)):
                src = call if b == 0xE8 else jump
                si = ci if b == 0xE8 else ji
                if si + 4 > len(src):
                    raise QzError(QZ_DATA_ERROR,
                                  "7z: BCJ2 address stream truncated")
                if b == 0xE8:
                    ci += 4
                else:
                    ji += 4
                absolute = int.from_bytes(src[si:si + 4], "big")
                rel = (absolute - (len(out) + 4)) & 0xFFFFFFFF
                out += rel.to_bytes(4, "little")
                prev = (rel >> 24) & 0xFF
                continue
        prev = b
    if len(out) != out_size:
        raise QzError(QZ_DATA_ERROR, "7z: BCJ2 output overrun")
    return bytes(out)


def bcj2_encode(data: bytes) -> Tuple[bytes, bytes, bytes, bytes]:
    """Split ``data`` into BCJ2's (main, call, jump, rc) streams.

    Converts every E8/E9/Jcc site with 4 following bytes (the simple
    always-convert policy — the adaptive contexts make unconvertible
    sites cheap, and any policy decodes identically)."""
    probs = [1 << (_RC_MODEL_TOTAL_BITS - 1)] * 258
    re_ = _RangeEncoder()
    main = bytearray()
    call = bytearray()
    jump = bytearray()
    i = 0
    prev = 0
    n = len(data)
    while i < n:
        b = data[i]
        main.append(b)
        i += 1
        if _bcj2_is_marker(prev, b):
            idx = _bcj2_prob_index(prev, b)
            if i + 4 <= n:
                re_.encode_bit(probs, idx, 1)
                rel = int.from_bytes(data[i:i + 4], "little")
                absolute = (rel + i + 4) & 0xFFFFFFFF
                (call if b == 0xE8 else jump).extend(
                    absolute.to_bytes(4, "big"))
                prev = data[i + 3]
                i += 4
                continue
            re_.encode_bit(probs, idx, 0)
        prev = b
    return bytes(main), bytes(call), bytes(jump), re_.flush()


# ---------------------------------------------------------------------------
# 7z number codec (utils/qzip_7z.c:182-246 analog)
# ---------------------------------------------------------------------------

def write_number(v: int) -> bytes:
    first = 0
    mask = 0x80
    i = 0
    while i < 8:
        if v < (1 << (7 * (i + 1))):
            first |= (v >> (8 * i)) & 0xFF
            break
        first |= mask
        mask >>= 1
        i += 1
    out = bytearray([first & 0xFF])
    for _ in range(i):
        out.append(v & 0xFF)
        v >>= 8
    return bytes(out)


def read_number(buf, pos: int) -> Tuple[int, int]:
    if pos >= len(buf):
        raise QzError(QZ_DATA_ERROR, "7z: truncated number")
    first = buf[pos]
    pos += 1
    mask = 0x80
    for i in range(8):
        if not (first & mask):
            if pos + i > len(buf):
                raise QzError(QZ_DATA_ERROR, "7z: truncated number")
            low = int.from_bytes(bytes(buf[pos:pos + i]), "little")
            high = first & (mask - 1)
            return low | (high << (8 * i)), pos + i
        mask >>= 1
    if pos + 8 > len(buf):
        raise QzError(QZ_DATA_ERROR, "7z: truncated number")
    return int.from_bytes(bytes(buf[pos:pos + 8]), "little"), pos + 8


def _read_exact_numbers(buf, pos, count):
    out = []
    for _ in range(count):
        v, pos = read_number(buf, pos)
        out.append(v)
    return out, pos


def _write_bitmap(bits: List[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i >> 3] |= 0x80 >> (i & 7)
    return bytes(out)


def _read_bitmap(buf, pos, n) -> Tuple[List[bool], int]:
    nb = (n + 7) // 8
    if pos + nb > len(buf):
        raise QzError(QZ_DATA_ERROR, "7z: truncated bitmap")
    bits = []
    for i in range(n):
        bits.append(bool(buf[pos + (i >> 3)] & (0x80 >> (i & 7))))
    return bits, pos + nb


def _unix_to_filetime(t: float) -> int:
    return int((t + FILETIME_EPOCH) * 10_000_000)


def _filetime_to_unix(ft: int) -> float:
    return ft / 10_000_000 - FILETIME_EPOCH


# ---------------------------------------------------------------------------
# Item list (Qz7zItemList_T analog)
# ---------------------------------------------------------------------------

@dataclass
class Entry:
    path: str          # on-disk path
    name: str          # archive-relative name
    is_dir: bool
    is_empty: bool
    size: int
    mtime: float
    mode: int
    crc: int = 0
    is_symlink: bool = False
    link_target: str = ""


def _collect(inputs: List[str], recursive: bool = True) -> List[Entry]:
    """Resolve file/dir arguments into archive entries (dirs first like the
    reference's category-1/category-2 split, utils/qzip_7z.c:784-900).
    Symlinks are stored as small files whose content is the target path
    with S_IFLNK in the unix-mode attribute (reference symlink handling,
    utils/qzip_7z.c resolvers)."""
    entries: List[Entry] = []

    def add(path: str, name: str):
        st = os.lstat(path)
        if statmod.S_ISLNK(st.st_mode):
            target = os.readlink(path)
            entries.append(Entry(path, name, False, len(target) == 0,
                                 len(target), st.st_mtime, st.st_mode,
                                 is_symlink=True, link_target=target))
        elif statmod.S_ISDIR(st.st_mode):
            entries.append(Entry(path, name, True, True, 0, st.st_mtime,
                                 st.st_mode))
            for child in sorted(os.listdir(path)):
                add(os.path.join(path, child), name + "/" + child)
        elif statmod.S_ISREG(st.st_mode):
            entries.append(Entry(path, name, False, st.st_size == 0,
                                 st.st_size, st.st_mtime, st.st_mode))
        # device/socket nodes skipped

    for arg in inputs:
        add(arg, os.path.basename(arg.rstrip("/")) or arg)
    return entries


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

FOLDER_LIMIT = 512 << 20   # reference chunks the stream at 512 MB


def create_7z(inputs: List[str], out_path: str, sess=None,
              recursive: bool = True,
              folder_limit: int = FOLDER_LIMIT,
              encode_header: bool = False) -> Tuple[int, int]:
    """Create a .7z archive: non-empty file contents concatenated into
    DEFLATE folder streams, one folder per ``folder_limit`` bytes
    (reference doCompressFile strategy, 512 MB chunks,
    utils/qzip_7z.c:447-737).

    Returns (total uncompressed, total archive bytes).
    """
    entries = _collect(inputs, recursive)
    nonempty = [e for e in entries if not e.is_dir and not e.is_empty]

    # --- group whole files into folders up to folder_limit -----------------
    groups: List[List[Entry]] = []
    cur: List[Entry] = []
    cur_sz = 0
    for e in nonempty:
        sz = e.size if not e.is_symlink else len(e.link_target.encode())
        if cur and cur_sz + sz > folder_limit:
            groups.append(cur)
            cur, cur_sz = [], 0
        cur.append(e)
        cur_sz += sz
    if cur:
        groups.append(cur)

    def _deflate(body: bytes) -> bytes:
        if sess is not None and body:
            from ..constants import DataFormat
            saved_fmt = sess.data_fmt
            sess.data_fmt = DataFormat.DEFLATE_RAW
            try:
                return sess.compress(body)
            finally:
                sess.data_fmt = saved_fmt
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        return co.compress(body) + co.flush()

    packed_streams: List[bytes] = []
    body_sizes: List[int] = []
    for grp in groups:
        raw = io.BytesIO()
        for e in grp:
            if e.is_symlink:
                data = e.link_target.encode()
            else:
                with open(e.path, "rb") as fh:
                    data = fh.read()
            e.crc = zlib.crc32(data) & 0xFFFFFFFF
            e.size = len(data)
            raw.write(data)
        body = raw.getvalue()
        body_sizes.append(len(body))
        packed_streams.append(_deflate(body))
    packed = b"".join(packed_streams)

    # --- end header ----------------------------------------------------------
    hdr = bytearray()
    hdr.append(K_HEADER)
    if nonempty:
        hdr.append(K_MAIN_STREAMS)
        # PackInfo
        hdr.append(K_PACK_INFO)
        hdr += write_number(0)            # pack pos
        hdr += write_number(len(groups))  # num pack streams
        hdr.append(K_SIZE)
        for ps in packed_streams:
            hdr += write_number(len(ps))
        hdr.append(K_END)
        # UnPackInfo
        hdr.append(K_UNPACK_INFO)
        hdr.append(K_FOLDER)
        hdr += write_number(len(groups))  # num folders
        hdr.append(0)                     # external = 0
        for _grp in groups:
            hdr += write_number(1)        # num coders in folder
            hdr.append(len(CODEC_DEFLATE))  # flags: id size, simple coder
            hdr += CODEC_DEFLATE
        hdr.append(K_CODERS_UNPACK_SIZE)
        for bs in body_sizes:
            hdr += write_number(bs)
        hdr.append(K_END)
        # SubStreamsInfo
        hdr.append(K_SUBSTREAMS_INFO)
        hdr.append(K_NUM_UNPACK_STREAM)
        for grp in groups:
            hdr += write_number(len(grp))
        hdr.append(K_SIZE)
        for grp in groups:
            for e in grp[:-1]:            # last substream size is derived
                hdr += write_number(e.size)
        hdr.append(K_CRC)
        hdr.append(1)                     # all defined
        for grp in groups:
            for e in grp:
                hdr += struct.pack("<I", e.crc)
        hdr.append(K_END)
        hdr.append(K_END)
    # FilesInfo
    hdr.append(K_FILES_INFO)
    hdr += write_number(len(entries))
    empty_bits = [e.is_dir or e.is_empty for e in entries]
    if any(empty_bits):
        bm = _write_bitmap(empty_bits)
        hdr.append(K_EMPTY_STREAM)
        hdr += write_number(len(bm))
        hdr += bm
        ef_bits = [not e.is_dir for e in entries if e.is_dir or e.is_empty]
        if any(ef_bits):
            bm2 = _write_bitmap(ef_bits)
            hdr.append(K_EMPTY_FILE)
            hdr += write_number(len(bm2))
            hdr += bm2
    # names (UTF-16LE, NUL-terminated)
    names = bytearray([0])  # external = 0
    for e in entries:
        names += e.name.replace(os.sep, "/").encode("utf-16-le") + b"\x00\x00"
    hdr.append(K_NAME)
    hdr += write_number(len(names))
    hdr += names
    # mtimes
    tm = bytearray([1, 0])  # all defined, external=0
    for e in entries:
        tm += struct.pack("<Q", _unix_to_filetime(e.mtime))
    hdr.append(K_MTIME)
    hdr += write_number(len(tm))
    hdr += tm
    # attributes: unix mode << 16 | 0x8000 (+0x10 dir flag)
    at = bytearray([1, 0])
    for e in entries:
        a = 0x8000 | (statmod.S_IMODE(e.mode) << 16)
        if e.is_dir:
            a |= 0x10 | (statmod.S_IFDIR << 16)
        elif e.is_symlink:
            a |= (statmod.S_IFLNK << 16)
        else:
            a |= (statmod.S_IFREG << 16)
        at += struct.pack("<I", a)
    hdr.append(K_ATTRIBUTES)
    hdr += write_number(len(at))
    hdr += at
    hdr.append(K_END)  # FilesInfo end
    hdr.append(K_END)  # Header end

    # --- assemble ------------------------------------------------------------
    hdr = bytes(hdr)
    if encode_header:
        # compress the end header into its own deflate folder and describe
        # it with a K_ENCODED_HEADER streams-info tree (the layout stock
        # 7-Zip writes by default, here with our deflate coder)
        hdr_packed = _deflate(hdr)
        hdr_crc = zlib.crc32(hdr) & 0xFFFFFFFF
        tree = bytearray([K_ENCODED_HEADER])
        tree.append(K_PACK_INFO)
        tree += write_number(len(packed))      # pack pos of the hdr stream
        tree += write_number(1)
        tree.append(K_SIZE)
        tree += write_number(len(hdr_packed))
        tree.append(K_END)
        tree.append(K_UNPACK_INFO)
        tree.append(K_FOLDER)
        tree += write_number(1)
        tree.append(0)                         # external = 0
        tree += write_number(1)                # one coder
        tree.append(len(CODEC_DEFLATE))
        tree += CODEC_DEFLATE
        tree.append(K_CODERS_UNPACK_SIZE)
        tree += write_number(len(hdr))
        tree.append(K_CRC)
        tree.append(1)
        tree += struct.pack("<I", hdr_crc)
        tree.append(K_END)
        tree.append(K_END)
        tail = hdr_packed + bytes(tree)
        next_hdr_off = len(packed) + len(hdr_packed)
        next_hdr_blob = bytes(tree)
    else:
        tail = hdr
        next_hdr_off = len(packed)
        next_hdr_blob = hdr
    next_hdr_crc = zlib.crc32(next_hdr_blob) & 0xFFFFFFFF
    start = struct.pack("<QQI", next_hdr_off, len(next_hdr_blob),
                        next_hdr_crc)
    start_crc = zlib.crc32(start) & 0xFFFFFFFF
    with open(out_path, "wb") as out:
        out.write(MAGIC + VERSION + struct.pack("<I", start_crc) + start)
        out.write(packed)
        out.write(tail)
    total_in = sum(e.size for e in entries)
    return total_in, 32 + len(packed) + len(tail)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

@dataclass
class _Coder:
    codec: bytes
    nin: int = 1
    nout: int = 1
    props: bytes = b""


@dataclass
class _Folder:
    coders: List[_Coder] = field(default_factory=list)
    bind_pairs: List[Tuple[int, int]] = field(default_factory=list)
    packed_in_indices: List[int] = field(default_factory=list)  # in-stream idx
    first_pack: int = 0          # global index of this folder's first pack
    num_packed: int = 1
    unpack_sizes: List[int] = field(default_factory=list)
    crc: Optional[int] = None

    def main_out_index(self) -> int:
        """The folder's output = the coder out-stream no bind pair consumes."""
        bound_outs = {o for (_i, o) in self.bind_pairs}
        nout = sum(c.nout for c in self.coders)
        for idx in range(nout):
            if idx not in bound_outs:
                return idx
        raise QzError(QZ_DATA_ERROR, "7z: folder has no unbound output")

    def output_size(self) -> int:
        return self.unpack_sizes[self.main_out_index()]


def _decode_coder(coder: _Coder, data: bytes, out_size: int) -> bytes:
    if coder.codec == CODEC_COPY:
        return data[:out_size]
    if coder.codec == CODEC_BCJ_X86:
        return bcj_x86_filter(data, encode=False)[:out_size]
    if coder.codec == CODEC_DELTA:
        dist = (coder.props[0] + 1) if coder.props else 1
        return delta_filter(data, dist, encode=False)[:out_size]
    if coder.codec == CODEC_DEFLATE:
        try:
            return zlib.decompressobj(-15).decompress(data, out_size)
        except zlib.error as e:
            raise QzError(QZ_DATA_ERROR, f"7z: bad deflate stream: {e}") \
                from None
    if coder.codec == CODEC_LZMA1:
        import lzma
        if len(coder.props) != 5:
            raise QzError(QZ_DATA_ERROR, "bad LZMA props")
        pb_lp_lc = coder.props[0]
        lc = pb_lp_lc % 9
        lp = (pb_lp_lc // 9) % 5
        pb = pb_lp_lc // 45
        (dict_size,) = struct.unpack_from("<I", coder.props, 1)
        filt = [{"id": lzma.FILTER_LZMA1, "lc": lc, "lp": lp, "pb": pb,
                 "dict_size": max(dict_size, 4096)}]
        d = lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=filt)
        return d.decompress(data, out_size)
    if coder.codec == CODEC_LZMA2:
        import lzma
        dict_size = 1 << 24
        if coder.props:
            p = coder.props[0]
            if p < 40:
                dict_size = (2 | (p & 1)) << (p // 2 + 11)
        filt = [{"id": lzma.FILTER_LZMA2, "dict_size": dict_size}]
        d = lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=filt)
        return d.decompress(data, out_size)
    raise QzError(QZ_DATA_ERROR,
                  f"unsupported 7z codec {coder.codec.hex()}")


class _HeaderParser:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.pack_sizes: List[int] = []
        self.pack_pos = 0
        self.folders: List[_Folder] = []
        self.num_unpack_streams: List[int] = []
        self.sub_sizes: List[List[int]] = []
        self.sub_crcs: List[Optional[int]] = []
        self.files: List[dict] = []

    # -- primitives (bounds-checked: a truncated or corrupt end-header
    # surfaces as QZ_DATA_ERROR, never a raw IndexError/struct.error) ------
    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise QzError(QZ_DATA_ERROR, "7z: truncated header")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def num(self) -> int:
        v, self.pos = read_number(self.buf, self.pos)
        return v

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise QzError(QZ_DATA_ERROR, "7z: truncated header")
        d = self.buf[self.pos:self.pos + n]
        self.pos += n
        return d

    def expect(self, k: int):
        got = self.byte()
        if got != k:
            raise QzError(QZ_DATA_ERROR, f"7z: expected id {k}, got {got}")

    # -- sections --------------------------------------------------------------
    def parse_header(self):
        t = self.byte()
        if t != K_HEADER:
            raise QzError(QZ_DATA_ERROR, "7z: not a plain header")
        t = self.byte()
        if t == K_MAIN_STREAMS:
            self.parse_streams_info()
            t = self.byte()
        if t == K_FILES_INFO:
            self.parse_files_info()
            t = self.byte()
        # trailing K_END consumed by parse_files_info caller loop

    def parse_streams_info(self):
        t = self.byte()
        if t == K_PACK_INFO:
            self.pack_pos = self.num()
            n = self.num()
            while True:
                t2 = self.byte()
                if t2 == K_SIZE:
                    self.pack_sizes, self.pos = _read_exact_numbers(
                        self.buf, self.pos, n)
                elif t2 == K_END:
                    break
                elif t2 == K_CRC:
                    self._skip_crc(n)
                else:
                    raise QzError(QZ_DATA_ERROR, "7z: bad PackInfo")
            t = self.byte()
        if t == K_UNPACK_INFO:
            self.parse_unpack_info()
            t = self.byte()
        if t == K_SUBSTREAMS_INFO:
            self.parse_substreams_info()
            t = self.byte()
        if t != K_END:
            raise QzError(QZ_DATA_ERROR, "7z: bad StreamsInfo terminator")

    def _skip_crc(self, n):
        all_defined = self.byte()
        bits = [True] * n
        if not all_defined:
            bits, self.pos = _read_bitmap(self.buf, self.pos, n)
        self.take(4 * sum(bits))

    def parse_unpack_info(self):
        self.expect(K_FOLDER)
        nfolders = self.num()
        external = self.byte()
        if external:
            raise QzError(QZ_DATA_ERROR, "7z: external folders unsupported")
        pack_index = 0
        for _ in range(nfolders):
            f = _Folder()
            ncoders = self.num()
            total_out = total_in = 0
            for _c in range(ncoders):
                flags = self.byte()
                idsize = flags & 0x0F
                codec = self.take(idsize)
                c = _Coder(codec)
                if flags & 0x10:  # complex
                    c.nin = self.num()
                    c.nout = self.num()
                if flags & 0x20:  # has props
                    psz = self.num()
                    c.props = self.take(psz)
                f.coders.append(c)
                total_in += c.nin
                total_out += c.nout
            nbind = total_out - 1
            for _bp in range(nbind):
                i = self.num()
                o = self.num()
                f.bind_pairs.append((i, o))
            npacked = total_in - nbind
            f.first_pack = pack_index   # pack streams are consumed
            f.num_packed = npacked      # sequentially across folders
            if npacked == 1:
                bound_ins = {i for (i, _o) in f.bind_pairs}
                f.packed_in_indices = [
                    i for i in range(total_in) if i not in bound_ins]
                if len(f.packed_in_indices) != 1:
                    raise QzError(QZ_DATA_ERROR, "7z: bad folder bindings")
            else:
                # explicit in-stream indices for each pack stream
                f.packed_in_indices = [self.num() for _ in range(npacked)]
            pack_index += npacked
            f._total_out = total_out
            self.folders.append(f)
        self.expect(K_CODERS_UNPACK_SIZE)
        for f in self.folders:
            f.unpack_sizes, self.pos = _read_exact_numbers(
                self.buf, self.pos, f._total_out)
        t = self.byte()
        if t == K_CRC:
            n = len(self.folders)
            all_defined = self.byte()
            bits = [True] * n
            if not all_defined:
                bits, self.pos = _read_bitmap(self.buf, self.pos, n)
            for f, has in zip(self.folders, bits):
                if has:
                    (f.crc,) = struct.unpack_from("<I", self.take(4))
            t = self.byte()
        if t != K_END:
            raise QzError(QZ_DATA_ERROR, "7z: bad UnPackInfo terminator")

    def parse_substreams_info(self):
        t = self.byte()
        nums = [1] * len(self.folders)
        if t == K_NUM_UNPACK_STREAM:
            nums = [self.num() for _ in self.folders]
            t = self.byte()
        self.num_unpack_streams = nums
        sizes: List[List[int]] = []
        if t == K_SIZE:
            for f, n in zip(self.folders, nums):
                ss = []
                for _ in range(n - 1):
                    ss.append(self.num())
                ss.append(f.output_size() - sum(ss))
                sizes.append(ss)
            t = self.byte()
        else:
            sizes = [[f.output_size()] for f in self.folders]
        self.sub_sizes = sizes
        total_streams = sum(nums)
        crcs: List[Optional[int]] = [None] * total_streams
        if t == K_CRC:
            # digests for streams whose folder-crc doesn't already cover them
            ndig = 0
            known = []
            for f, n in zip(self.folders, nums):
                for _ in range(n):
                    k = (n == 1 and f.crc is not None)
                    known.append(k)
                    if not k:
                        ndig += 1
            all_defined = self.byte()
            bits = [True] * ndig
            if not all_defined:
                bits, self.pos = _read_bitmap(self.buf, self.pos, ndig)
            di = 0
            for si in range(total_streams):
                if known[si]:
                    crcs[si] = None  # folder crc applies
                else:
                    if bits[di]:
                        (crcs[si],) = struct.unpack_from("<I", self.take(4))
                    di += 1
            t = self.byte()
        self.sub_crcs = crcs
        if t != K_END:
            raise QzError(QZ_DATA_ERROR, "7z: bad SubStreamsInfo terminator")

    def parse_files_info(self):
        nfiles = self.num()
        files = [dict(name=None, empty_stream=False, empty_file=False,
                      mtime=None, attr=None) for _ in range(nfiles)]
        while True:
            prop = self.byte()
            if prop == K_END:
                break
            size = self.num()
            end = self.pos + size
            if prop == K_EMPTY_STREAM:
                bits, self.pos = _read_bitmap(self.buf, self.pos, nfiles)
                for fobj, b in zip(files, bits):
                    fobj["empty_stream"] = b
            elif prop == K_EMPTY_FILE:
                nempty = sum(1 for fobj in files if fobj["empty_stream"])
                bits, self.pos = _read_bitmap(self.buf, self.pos, nempty)
                i = 0
                for fobj in files:
                    if fobj["empty_stream"]:
                        fobj["empty_file"] = bits[i]
                        i += 1
            elif prop == K_NAME:
                external = self.byte()
                if external:
                    raise QzError(QZ_DATA_ERROR, "7z: external names")
                blob = self.take(size - 1)
                parts = blob.split(b"\x00\x00")
                # utf-16 2-byte alignment: rebuild by scanning
                names = []
                cur = bytearray()
                i = 0
                while i + 1 < len(blob) + 1 and len(names) < nfiles:
                    ch = blob[i:i + 2]
                    if ch == b"\x00\x00":
                        names.append(cur.decode("utf-16-le"))
                        cur = bytearray()
                    else:
                        cur += ch
                    i += 2
                for fobj, nm in zip(files, names):
                    fobj["name"] = nm
            elif prop == K_MTIME:
                all_defined = self.byte()
                bits = [True] * nfiles
                if not all_defined:
                    bits, self.pos = _read_bitmap(self.buf, self.pos, nfiles)
                external = self.byte()
                for fobj, b in zip(files, bits):
                    if b:
                        (ft,) = struct.unpack_from("<Q", self.take(8))
                        fobj["mtime"] = _filetime_to_unix(ft)
            elif prop == K_ATTRIBUTES:
                all_defined = self.byte()
                bits = [True] * nfiles
                if not all_defined:
                    bits, self.pos = _read_bitmap(self.buf, self.pos, nfiles)
                external = self.byte()
                for fobj, b in zip(files, bits):
                    if b:
                        (fobj["attr"],) = struct.unpack_from(
                            "<I", self.take(4))
            self.pos = end
        self.files = files


def _read_header(fh) -> Tuple[bytes, int]:
    sig = fh.read(32)
    if sig[:6] != MAGIC:
        raise QzError(QZ_DATA_ERROR, "not a 7z archive")
    start_crc, = struct.unpack_from("<I", sig, 8)
    nh_off, nh_size, nh_crc = struct.unpack_from("<QQI", sig, 12)
    if zlib.crc32(sig[12:32]) & 0xFFFFFFFF != start_crc:
        raise QzError(QZ_DATA_ERROR, "7z: signature header CRC mismatch")
    fh.seek(32 + nh_off)
    hdr = fh.read(nh_size)
    if zlib.crc32(hdr) & 0xFFFFFFFF != nh_crc:
        raise QzError(QZ_DATA_ERROR, "7z: end header CRC mismatch")
    return hdr, nh_off


def _decode_folder(fh, folder: _Folder, pack_offsets: List[int],
                   pack_sizes: List[int], base: int) -> bytes:
    """Decode a folder by resolving its bind-pair dataflow graph.

    Stock 7z lists filter chains in arbitrary declaration order (BCJ often
    precedes the compressor); the decode order comes from the bind pairs:
    pack streams feed unbound coder inputs, each bind pair (in, out) wires
    one coder's output into another's input, and the folder's result is the
    single unbound output (utils/qzip_7z.c resolver surface :784-1537).
    """
    packs = []
    for j in range(folder.num_packed):
        pi = folder.first_pack + j
        fh.seek(base + pack_offsets[pi])
        packs.append(fh.read(pack_sizes[pi]))

    # in-stream index -> its source; out-stream index -> owning coder
    in_src = {}
    for j, ii in enumerate(folder.packed_in_indices):
        in_src[ii] = ("pack", j)
    for (ii, oi) in folder.bind_pairs:
        in_src[ii] = ("out", oi)
    out_owner = {}
    in_base = out_base = 0
    for c in folder.coders:
        for k in range(c.nout):
            out_owner[out_base + k] = (c, in_base)
        in_base += c.nin
        out_base += c.nout

    memo = {}

    def decode_out(oi: int, depth: int = 0) -> bytes:
        if depth > 16:
            raise QzError(QZ_DATA_ERROR, "7z: coder graph too deep")
        if oi in memo:
            return memo[oi]
        if oi not in out_owner:
            raise QzError(QZ_DATA_ERROR, "7z: bad bind-pair out index")
        coder, ib = out_owner[oi]
        if coder.nout != 1:
            raise QzError(QZ_DATA_ERROR, "7z: multi-output coder unsupported")

        def resolve_in(k: int) -> bytes:
            src = in_src.get(ib + k)
            if src is None:
                raise QzError(QZ_DATA_ERROR, "7z: unbound coder input")
            return (packs[src[1]] if src[0] == "pack"
                    else decode_out(src[1], depth + 1))

        if coder.codec == CODEC_BCJ2:
            if coder.nin != 4:
                raise QzError(QZ_DATA_ERROR, "7z: BCJ2 needs 4 in-streams")
            out = bcj2_decode(resolve_in(0), resolve_in(1), resolve_in(2),
                              resolve_in(3), folder.unpack_sizes[oi])
        elif coder.nin != 1:
            raise QzError(QZ_DATA_ERROR, "7z: multi-stream coder unsupported")
        else:
            out = _decode_coder(coder, resolve_in(0),
                                folder.unpack_sizes[oi])
        memo[oi] = out
        return out

    return decode_out(folder.main_out_index())


def _safe_join(dest_root: str, name: str) -> str:
    """Join an archive-supplied name under dest_root, rejecting absolute
    names and any path that escapes the destination (zip-slip)."""
    name = name.replace("\\", "/")
    if name.startswith("/") or (len(name) > 1 and name[1] == ":"):
        raise QzError(QZ_DATA_ERROR, f"7z: absolute entry name {name!r}")
    norm = os.path.normpath(name)
    if norm == ".." or norm.startswith("../" ) or os.path.isabs(norm):
        raise QzError(QZ_DATA_ERROR, f"7z: entry escapes archive root: {name!r}")
    return os.path.join(dest_root, norm)


def _check_parent(path: str, dest_root: str):
    """Refuse to write through a symlinked parent that escapes dest_root
    (a symlink extracted earlier must not redirect later writes)."""
    parent = os.path.dirname(path) or "."
    real_parent = os.path.realpath(parent)
    root = os.path.realpath(dest_root)
    if real_parent != root and not real_parent.startswith(root + os.sep):
        raise QzError(QZ_DATA_ERROR,
                      f"7z: refusing to write outside destination: {path!r}")


def extract_7z(archive: str, dest_dir: str = ".",
               verify_crc: bool = True) -> List[str]:
    """Extract a .7z archive. Returns the list of extracted paths.

    Hardened against hostile archives: entry names are sanitized against
    directory traversal, writes through symlinked parents are refused, and
    symlink entries are created last so they cannot redirect file writes.
    """
    written: List[str] = []
    os.makedirs(dest_dir, exist_ok=True)
    with open(archive, "rb") as fh:
        hdr, _ = _read_header(fh)
        if hdr and hdr[0] == K_ENCODED_HEADER:
            p = _HeaderParser(hdr[1:])
            p.parse_streams_info()
            offs = [0]
            for s in p.pack_sizes[:-1]:
                offs.append(offs[-1] + s)
            real = _decode_folder(fh, p.folders[0], offs, p.pack_sizes,
                                  32 + p.pack_pos)
            hdr = real
        p = _HeaderParser(hdr)
        p.parse_header()

        # substream payloads, in folder order; single-stream folders with
        # only a folder CRC (stock 7-Zip's common layout) are verified
        # against folder.crc — sub_crcs holds None for those
        payloads: List[bytes] = []
        crcs: List[Optional[int]] = []
        if p.folders:
            offs = [0]
            for s in p.pack_sizes[:-1]:
                offs.append(offs[-1] + s)
            si = 0
            for fi, folder in enumerate(p.folders):
                data = _decode_folder(fh, folder, offs, p.pack_sizes,
                                      32 + p.pack_pos)
                if verify_crc and folder.crc is not None:
                    if zlib.crc32(data) & 0xFFFFFFFF != folder.crc:
                        raise QzError(QZ_DATA_ERROR,
                                      f"7z: folder {fi} CRC mismatch")
                n = (p.num_unpack_streams[fi]
                     if p.num_unpack_streams else 1)
                sizes = (p.sub_sizes[fi] if p.sub_sizes
                         else [folder.output_size()])
                pos = 0
                for k in range(n):
                    payloads.append(data[pos:pos + sizes[k]])
                    crcs.append(p.sub_crcs[si] if p.sub_crcs else None)
                    pos += sizes[k]
                    si += 1

        symlinks = []   # (path, target, mtime) — created after all files
        sidx = 0
        for fobj in p.files:
            name = fobj["name"] or f"file{sidx}"
            path = _safe_join(dest_dir, name)
            attr = fobj["attr"] or 0
            is_dir = bool(attr & 0x10) or (
                fobj["empty_stream"] and not fobj["empty_file"])
            if is_dir:
                _check_parent(path, dest_dir)
                os.makedirs(path, exist_ok=True)
                written.append(path)
                continue
            _check_parent(path, dest_dir)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if fobj["empty_stream"]:
                data = b""
            else:
                data = payloads[sidx]
                if verify_crc and crcs[sidx] is not None:
                    if zlib.crc32(data) & 0xFFFFFFFF != crcs[sidx]:
                        raise QzError(QZ_DATA_ERROR,
                                      f"7z: CRC mismatch for {name}")
                sidx += 1
            unix_mode = (attr >> 16) & 0xFFFF
            if (attr & 0x8000) and statmod.S_ISLNK(unix_mode):
                symlinks.append((path, data.decode(errors="surrogateescape"),
                                 fobj["mtime"]))
                continue
            _check_parent(path, dest_dir)   # re-check after makedirs
            with open(path, "wb") as out:
                out.write(data)
            if attr & 0x8000:
                os.chmod(path, (attr >> 16) & 0o7777 or 0o644)
            if fobj["mtime"]:
                os.utime(path, (fobj["mtime"], fobj["mtime"]))
            written.append(path)
        for path, target, mtime in symlinks:
            _check_parent(path, dest_dir)
            try:
                if os.path.lexists(path):
                    os.unlink(path)
                os.symlink(target, path)
            except OSError as e:
                raise QzError(QZ_DATA_ERROR,
                              f"7z: cannot create symlink {path!r}: {e}") \
                    from None
            written.append(path)
    return written


def list_7z(archive: str) -> List[dict]:
    with open(archive, "rb") as fh:
        hdr, _ = _read_header(fh)
        if hdr and hdr[0] == K_ENCODED_HEADER:
            p = _HeaderParser(hdr[1:])
            p.parse_streams_info()
            offs = [0]
            for s in p.pack_sizes[:-1]:
                offs.append(offs[-1] + s)
            hdr = _decode_folder(fh, p.folders[0], offs, p.pack_sizes,
                                 32 + p.pack_pos)
        p = _HeaderParser(hdr)
        p.parse_header()
        return p.files
