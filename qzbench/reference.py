"""The plain reference that decides ``correct``: what any user's decoder
reads back from each answer, held against the request's own bytes.

It imports nothing of the program and nothing of the JAX package. DEFLATE
members are inflated and checksummed by the interpreter's stock zlib;
zstd frames are walked here (RFC 8878) and each decoded by stock
``libzstd.so.1``, which this module loads itself through ctypes; the
LZ4 frame is read by a plain LZ4 block decoder and XXH32, frozen copies
of ``qatzip_tpu_torch/sw/lz4_py.py`` and of ``_xxh32_py`` in
``qatzip_tpu_torch/ops/xxhash.py`` at commit 0cd1e03 (the decoder here
also keeps the frame's earlier content as its window, copies an
overlapping match by repeating its period, and holds a block to the
format's end rules, which the original does not check; XXH32 runs one
lane at a time, so its four lanes can run in four processes).

Each answer gets four counts, all with the limit 0:

* ``frame_errors``: framing that a stock reader would refuse or misread:
  magic, flags, the QZ extra field or the LZ4 descriptor and its header
  checksum, a member or block that does not match its chunk's place and
  size, bytes past the end; in zstd, a bad magic or header, the reserved
  bit, a reserved block type, a block past the end, a frame that
  libzstd refuses for another reason than its checksum, or a content
  size other than what the frame decodes to;
* ``checksum_errors``: a member's CRC32 or ISIZE, or the frame's content
  size or XXH32 content checksum, that is not the request's or is left
  out; a zstd frame's checksum, where it carries one, that libzstd finds
  wrong (qzstd's frames carry none);
* ``content_errors``: a member or block that does not decode, decodes
  to other bytes than its chunk, or, in LZ4, breaks the block format's
  end rules (the last sequence literals alone, the last 5 bytes
  literals, the last match starting 12 bytes or more before the end);
  zstd frames whose contents, joined, are not the request's input (a
  frame dropped, repeated or swapped);
* ``expanded_chunks``: a DEFLATE payload over QATzip's bound for its
  chunk (``qzMaxCompressedLength``, src/qatzip.c:3175-3211: the chunk,
  an eighth more and a 48-byte skid pad, the bound users size their
  buffers by), an LZ4 block coded no smaller than its chunk instead of
  stored (the frame's rule for a block that does not shrink), or a zstd
  frame longer than ``ZSTD_COMPRESSBOUND`` of its content (the capacity
  the post-process gives each block).
"""

from __future__ import annotations

import ctypes
import functools
import multiprocessing
import struct
import zlib
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

COUNTS = ("frame_errors", "checksum_errors", "content_errors",
          "expanded_chunks")
LZ4_MAGIC = 0x184D2204
LZ4_STORED = 0x80000000
MINMATCH = 4
#: the block format's end rules: the last 5 bytes are literals, and the
#: last match starts at least 12 bytes before the block's end
LASTLITERALS, MFLIMIT = 5, 12
#: blocks a decode task takes (8 MiB of content at 64 KiB blocks)
RANGE_BLOCKS = 128
#: below this many bytes of content an answer is checked in this process
PARALLEL_BYTES = 8 << 20


def zero_counts() -> Dict[str, int]:
    return dict.fromkeys(COUNTS, 0)


def deflate_bound(n: int) -> int:
    """QATzip's bound on one chunk's DEFLATE payload: ``n`` bytes, an
    eighth more and the 48-byte skid pad."""
    return n + -(-n // 8) + 48


def chunks_of(data: bytes, hw: int) -> List[bytes]:
    return [data[o:o + hw] for o in range(0, len(data), hw)] or [b""]


# ---------------------------------------------------------------------------
# gzip-ext (QATzip's DEFLATE_GZIP_EXT): one gzip member a chunk
# ---------------------------------------------------------------------------

def check_gzip_ext(out: bytes, data: bytes, hw: int) -> Dict[str, int]:
    """Counts for one gzip-ext answer: one member per ``hw``-byte chunk,
    each a 10-byte header with FLG = FEXTRA, the 12-byte extra field
    'QZ' {src_sz, dest_sz}, ``dest_sz`` bytes of raw DEFLATE ending in a
    final block, and {CRC32, ISIZE} of the chunk."""
    c = zero_counts()
    pos = 0
    for chunk in chunks_of(data, hw):
        if len(out) - pos < 32:
            c["frame_errors"] += 1
            return c
        id1, id2, cm, flg = out[pos:pos + 4]
        xlen, si, sublen, src_sz, dest_sz = struct.unpack_from(
            "<H2sHII", out, pos + 10)
        if ((id1, id2, cm, flg) != (0x1F, 0x8B, 8, 0x04) or xlen != 12
                or si != b"QZ" or sublen != 8
                or pos + 32 + dest_sz > len(out)):
            c["frame_errors"] += 1
            return c
        if src_sz != len(chunk):
            c["frame_errors"] += 1
        payload = out[pos + 24:pos + 24 + dest_sz]
        crc, isize = struct.unpack_from("<II", out, pos + 24 + dest_sz)
        pos += 32 + dest_sz
        try:
            d = zlib.decompressobj(-15)
            got = d.decompress(payload, len(chunk) + 1)
            good = d.eof and not d.unused_data and got == chunk
        except zlib.error:
            good = False
        c["content_errors"] += not good
        c["checksum_errors"] += ((crc != zlib.crc32(chunk))
                                 + (isize != len(chunk) & 0xFFFFFFFF))
        c["expanded_chunks"] += len(payload) > deflate_bound(len(chunk))
    c["frame_errors"] += pos != len(out)
    return c


# ---------------------------------------------------------------------------
# XXH32 (frozen copy; one lane at a time)
# ---------------------------------------------------------------------------

P1, P2, P3, P4, P5 = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
                      0x165667B1)
M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def xxh32_lane(words: bytes, acc: int) -> int:
    """One XXH32 accumulator after its lane's little-endian words."""
    import numpy as np
    for w in ((np.frombuffer(words, "<u4").astype(np.uint64) * P2)
              & M32).tolist():
        acc = (acc + w) & M32
        acc = ((((acc << 13) & M32) | (acc >> 19)) * P1) & M32
    return acc


def _lanes(data: bytes) -> List[bytes]:
    import numpy as np
    n = len(data) // 16 * 16
    w = np.frombuffer(data, "<u4", count=n // 4).reshape(-1, 4)
    return [w[:, j].tobytes() for j in range(4)]


def _xxh32_init(seed: int = 0) -> List[int]:
    return [(seed + P1 + P2) & M32, (seed + P2) & M32, seed & M32,
            (seed - P1) & M32]


def xxh32_finish(data: bytes, accs: Sequence[int], seed: int = 0) -> int:
    """XXH32 of ``data`` from its four lane accumulators."""
    n = len(data)
    if n >= 16:
        a1, a2, a3, a4 = accs
        h = (_rotl(a1, 1) + _rotl(a2, 7) + _rotl(a3, 12) + _rotl(a4, 18)) & M32
    else:
        h = (seed + P5) & M32
    h = (h + n) & M32
    tail = data[n // 16 * 16:]
    pos = 0
    while len(tail) - pos >= 4:
        (lane,) = struct.unpack_from("<I", tail, pos)
        h = (_rotl((h + lane * P3) & M32, 17) * P4) & M32
        pos += 4
    for b in tail[pos:]:
        h = (_rotl((h + b * P5) & M32, 11) * P1) & M32
    h ^= h >> 15
    h = (h * P2) & M32
    h ^= h >> 13
    h = (h * P3) & M32
    return h ^ (h >> 16)


def xxh32(data: bytes, seed: int = 0) -> int:
    data = bytes(data)
    accs = [xxh32_lane(w, a) for w, a in zip(_lanes(data), _xxh32_init(seed))]
    return xxh32_finish(data, accs, seed)


# ---------------------------------------------------------------------------
# LZ4 frame
# ---------------------------------------------------------------------------

def lz4_decode_block(src: bytes, window: bytearray, cap: int) -> bytes:
    """Decode one LZ4 block after ``window`` (the frame's content so far,
    which matches may reach into; it is extended in place). Returns the
    block's bytes; raises ValueError on a malformed block, one that
    gives more than ``cap`` bytes, or one that breaks the block format's
    end rules, which decoders may rely on: the last sequence is literals
    alone, the last ``LASTLITERALS`` bytes are literals, and the last
    match starts at least ``MFLIMIT`` bytes before the block's end."""
    out = window
    base = len(out)
    ip = 0
    n = len(src)
    last_start = last_end = None            # the last match, in the block
    try:
        while True:
            token = src[ip]
            ip += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    s = src[ip]
                    ip += 1
                    lit += s
                    if s != 255:
                        break
            if ip + lit > n:
                raise ValueError("LZ4 literals past the block's end")
            out += src[ip:ip + lit]
            ip += lit
            if ip >= n:
                break                       # the last sequence: no match
            offset = src[ip] | (src[ip + 1] << 8)
            ip += 2
            if offset == 0 or offset > len(out):
                raise ValueError("bad LZ4 offset")
            mlen = token & 15
            if mlen == 15:
                while True:
                    s = src[ip]
                    ip += 1
                    mlen += s
                    if s != 255:
                        break
            mlen += MINMATCH
            start = len(out) - offset
            last_start = len(out) - base
            if offset >= mlen:
                out += out[start:start + mlen]
            else:
                period = out[start:]
                out += (period * (mlen // offset + 1))[:mlen]
            last_end = len(out) - base
            if last_end > cap:
                raise ValueError("LZ4 block over its size")
            if ip >= n:
                raise ValueError("LZ4 block ends on a match")
    except IndexError:
        raise ValueError("LZ4 block cut short") from None
    size = len(out) - base
    if last_end is not None and (last_end > size - LASTLITERALS
                                 or last_start > size - MFLIMIT):
        raise ValueError("LZ4 match too near the block's end")
    return bytes(out[base:])


def decode_range(blocks: Sequence[Tuple[bool, bytes]], history: bytes,
                 expected: Sequence[bytes]) -> int:
    """Blocks whose content is not ``expected`` (their chunks), decoding
    in order after ``history`` (the content before the first block)."""
    window = bytearray(history)
    bad = 0
    for (stored, payload), chunk in zip(blocks, expected):
        if stored:
            got = bytes(payload)
            window += got
        else:
            base = len(window)
            try:
                got = lz4_decode_block(payload, window, len(chunk))
            except ValueError:
                got = None
                del window[base:]
                window += chunk             # carry on after the chunk
        bad += got != chunk
        if len(window) > 1 << 17:
            del window[:len(window) - (1 << 16)]
    return bad


def parse_lz4_frame(out: bytes, data: bytes, hw: int):
    """The frame's structure: (counts, [(stored, payload)], the content
    checksum or None). Content and checksum are not checked here."""
    c = zero_counts()
    if len(out) < 7 or struct.unpack_from("<I", out)[0] != LZ4_MAGIC:
        c["frame_errors"] += 1
        return c, [], None
    flg, bd = out[4], out[5]
    pos = 6
    has_size, has_dict = flg & 0x08, flg & 0x01
    block_sum, content_sum = flg & 0x10, flg & 0x04
    if flg >> 6 != 1 or flg & 0x02 or bd & 0x8F or not 4 <= bd >> 4 <= 7:
        c["frame_errors"] += 1
        return c, [], None
    bmax = 1 << (8 + 2 * (bd >> 4))
    if has_size:
        if len(out) < pos + 8:
            c["frame_errors"] += 1
            return c, [], None
        c["checksum_errors"] += (struct.unpack_from("<Q", out, pos)[0]
                                 != len(data))
        pos += 8
    else:
        c["checksum_errors"] += 1           # the configuration asks for it
    pos += 4 if has_dict else 0
    if len(out) < pos + 1 or out[pos] != (xxh32(out[4:pos]) >> 8) & 0xFF:
        c["frame_errors"] += 1
        return c, [], None
    pos += 1
    blocks = []
    while True:
        if len(out) < pos + 4:
            c["frame_errors"] += 1
            return c, blocks, None
        (word,) = struct.unpack_from("<I", out, pos)
        pos += 4
        if word == 0:
            break
        size = word & ~LZ4_STORED
        if size > bmax or pos + size + (4 if block_sum else 0) > len(out):
            c["frame_errors"] += 1
            return c, blocks, None
        blocks.append((bool(word & LZ4_STORED), out[pos:pos + size]))
        pos += size + (4 if block_sum else 0)
    checksum = None
    if content_sum:
        if len(out) < pos + 4:
            c["frame_errors"] += 1
            return c, blocks, None
        (checksum,) = struct.unpack_from("<I", out, pos)
        pos += 4
    else:
        c["checksum_errors"] += 1           # the configuration asks for it
    c["frame_errors"] += pos != len(out)
    chunks = chunks_of(data, hw)
    c["frame_errors"] += len(blocks) != len(chunks)
    c["expanded_chunks"] += sum(not st and len(p) >= len(ch)
                                for (st, p), ch in zip(blocks, chunks))
    return c, blocks, checksum


class Lz4Job:
    """One LZ4 answer's decode and checksum, in this process or as tasks
    of a process pool (``submit``), then ``counts``."""

    def __init__(self, out: bytes, data: bytes, hw: int):
        self.data, self.hw = data, hw
        self.c, self.blocks, self.checksum = parse_lz4_frame(out, data, hw)
        self.parts = []
        self.lanes = []

    def _ranges(self):
        chunks = chunks_of(self.data, self.hw)
        for i in range(0, min(len(self.blocks), len(chunks)), RANGE_BLOCKS):
            start = i * self.hw
            yield (self.blocks[i:i + RANGE_BLOCKS],
                   self.data[max(0, start - 65536):start],
                   chunks[i:i + RANGE_BLOCKS])

    def submit(self, pool: Optional[ProcessPoolExecutor]) -> None:
        run = (pool.submit if pool is not None
               else lambda f, *a: _Done(f(*a)))
        self.parts = [run(decode_range, *r) for r in self._ranges()]
        if self.checksum is not None:
            self.lanes = [run(xxh32_lane, w, a) for w, a in
                          zip(_lanes(self.data), _xxh32_init())]

    def counts(self) -> Dict[str, int]:
        c = dict(self.c)
        c["content_errors"] += sum(p.result() for p in self.parts)
        if self.checksum is not None:
            want = xxh32_finish(self.data, [f.result() for f in self.lanes])
            c["checksum_errors"] += self.checksum != want
        return c


class _Done:
    def __init__(self, value):
        self.value = value

    def result(self):
        return self.value


# ---------------------------------------------------------------------------
# zstd frames (RFC 8878): the frames walked here, each decoded by libzstd
# ---------------------------------------------------------------------------

ZSTD_MAGIC = 0xFD2FB528
#: a skippable frame's magic, its low four bits masked off
ZSTD_SKIPPABLE = 0x184D2A50
#: the largest block a frame may hold (Block_Maximum_Size's cap)
ZSTD_BLOCK_MAX = 128 << 10
#: ``ZSTD_ErrorCode`` values, pinned by zstd since 1.3.1
ZSTD_CHECKSUM_WRONG = 22


def zstd_bound(n: int) -> int:
    """``ZSTD_COMPRESSBOUND(n)``: the capacity the post-process gives a
    block of ``n`` bytes, and the most a frame of it may take."""
    return n + (n >> 8) + (((128 << 10) - n) >> 11 if n < 128 << 10 else 0)


@functools.lru_cache(maxsize=None)
def libzstd():
    """Stock ``libzstd.so.1``, loaded here by its soname (never through
    the program). Raises OSError where it is not installed: the reader
    cannot judge, so the run fails."""
    lib = ctypes.CDLL("libzstd.so.1")
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorCode.restype = ctypes.c_int
    lib.ZSTD_getErrorCode.argtypes = [ctypes.c_size_t]
    return lib


def zstd_frame_header(out: bytes, pos: int):
    """The header of the zstd frame at ``pos``: (its end, the frame
    content size or None, whether it carries a checksum). Raises
    ValueError on a header a stock reader refuses: the magic, the
    reserved bit, a header cut short."""
    if (len(out) - pos < 6
            or struct.unpack_from("<I", out, pos)[0] != ZSTD_MAGIC):
        raise ValueError("no zstd magic")
    fhd = out[pos + 4]
    if fhd & 0x08:
        raise ValueError("reserved bit of the frame header set")
    single = fhd & 0x20
    fcs_len = (1 if single else 0, 2, 4, 8)[fhd >> 6]
    did_len = (0, 1, 2, 4)[fhd & 3]
    p = pos + 5 + (0 if single else 1) + did_len
    if p + fcs_len > len(out):
        raise ValueError("zstd frame header cut short")
    fcs = (int.from_bytes(out[p:p + fcs_len], "little")
           + (256 if fcs_len == 2 else 0)) if fcs_len else None
    return p + fcs_len, fcs, bool(fhd & 0x04)


def zstd_blocks(out: bytes, pos: int):
    """Walk the blocks from ``pos`` to the frame's last: (their end, the
    most content they can give). Raises ValueError on a reserved block
    type, a block over ``ZSTD_BLOCK_MAX``, or one running past the end."""
    most = 0
    while True:
        if pos + 3 > len(out):
            raise ValueError("zstd block header past the end")
        h = int.from_bytes(out[pos:pos + 3], "little")
        kind, size = (h >> 1) & 3, h >> 3
        if kind == 3:
            raise ValueError("reserved zstd block type")
        if size > ZSTD_BLOCK_MAX:
            raise ValueError("zstd block over the maximum")
        pos += 3 + (1 if kind == 1 else size)
        most += ZSTD_BLOCK_MAX if kind == 2 else size
        if pos > len(out):
            raise ValueError("zstd block past the end")
        if h & 1:
            return pos, most


def check_zstd_frames(out: bytes, data: bytes) -> Dict[str, int]:
    """Counts for one answer of zstd frames (skippable frames stepped
    over): each frame is walked here and decoded by stock libzstd; their
    contents, joined, have to be the request's input. A frame that
    libzstd refuses but whose header gives its content size is passed
    over by that size, so the frames after it are still held to their
    place; where a header or block cannot be walked, or a refused frame
    gives no size, the rest of the answer goes unread."""
    lib = libzstd()
    c = zero_counts()
    pos = done = 0
    content_ok = True
    while pos < len(out):
        if (len(out) - pos >= 8 and struct.unpack_from("<I", out, pos)[0]
                & 0xFFFFFFF0 == ZSTD_SKIPPABLE):
            pos += 8 + struct.unpack_from("<I", out, pos + 4)[0]
            if pos > len(out):
                c["frame_errors"] += 1
                return c
            continue
        try:
            body, fcs, has_sum = zstd_frame_header(out, pos)
            end, most = zstd_blocks(out, body)
        except ValueError:
            c["frame_errors"] += 1            # bytes after the last frame too
            return c
        end += 4 if has_sum else 0
        if end > len(out):
            c["frame_errors"] += 1
            return c
        # the content this frame may give, up to a block past the input
        cap = min(most, max(0, len(data) - done) + ZSTD_BLOCK_MAX)
        buf = ctypes.create_string_buffer(max(cap, 1))
        r = lib.ZSTD_decompress(buf, cap, out[pos:end], end - pos)
        if lib.ZSTD_isError(r):
            if lib.ZSTD_getErrorCode(r) == ZSTD_CHECKSUM_WRONG:
                c["checksum_errors"] += 1
            else:
                c["frame_errors"] += 1
            if fcs is None:
                return c
            done += fcs
        else:
            got = ctypes.string_at(buf, r)
            c["frame_errors"] += fcs is not None and fcs != r
            c["expanded_chunks"] += end - pos > zstd_bound(r)
            content_ok = content_ok and got == data[done:done + r]
            done += r
        pos = end
    c["content_errors"] += not (content_ok and done == len(data))
    return c


# ---------------------------------------------------------------------------
# judging a run's answers
# ---------------------------------------------------------------------------

def judge(fmt: str, hw: int, answers: Sequence[Tuple[object, bytes, bytes]],
          workers: int = 1) -> Tuple[Dict[str, int], List[bool]]:
    """Judge every answer: (key of its input, input, output). Answers to
    one input that are byte for byte equal share one check; each other
    output is checked on its own. Returns the counts summed over the
    answers and whether each answer is wrong. ``fmt`` is ``"gzip_ext"``,
    ``"lz4_frame"`` or ``"zstd_frames"``; ``workers`` > 1 runs large LZ4
    checks in that many processes."""
    units: List[Tuple[bytes, bytes]] = []
    seen: Dict[object, List[int]] = {}
    unit_of = []
    for key, data, out in answers:
        for u in seen.get(key, ()):
            if units[u][1] == out:
                break
        else:
            u = len(units)
            units.append((data, out))
            seen.setdefault(key, []).append(u)
        unit_of.append(u)
    if fmt == "gzip_ext":
        verdicts = [check_gzip_ext(out, data, hw) for data, out in units]
    elif fmt == "zstd_frames":
        verdicts = [check_zstd_frames(out, data) for data, out in units]
    elif fmt == "lz4_frame":
        jobs = [Lz4Job(out, data, hw) for data, out in units]
        big = sum(len(d) for d, _ in units) >= PARALLEL_BYTES
        if workers > 1 and big:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
                for j in jobs:
                    j.submit(pool)
                verdicts = [j.counts() for j in jobs]
        else:
            for j in jobs:
                j.submit(None)
            verdicts = [j.counts() for j in jobs]
    else:
        raise ValueError(f"unknown reference format {fmt!r}")
    total = zero_counts()
    wrong = []
    for u in unit_of:
        for k in COUNTS:
            total[k] += verdicts[u][k]
        wrong.append(any(verdicts[u].values()))
    return total, wrong
