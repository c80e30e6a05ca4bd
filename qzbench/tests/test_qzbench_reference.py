"""The plain reference: it reads back what the port writes, and finds
each kind of fault in an answer."""

import ctypes
import random
import struct
import zlib

import pytest

from qzbench import corpus, reference

HW = 65536


@pytest.fixture(scope="module")
def data():
    return corpus.silesia_like(5 * HW + 1234, "ref")


@pytest.fixture(scope="module")
def port_out(data):
    import qatzip_tpu_torch as qz
    out = {}
    for kind in ("deflate", "lz4"):
        s = qz.QzSession(device="cpu")
        (s.setup_deflate if kind == "deflate" else s.setup_lz4)()
        out[kind] = s.compress(data)
    return out


def test_xxh32_equals_the_port_oracle():
    from qatzip_tpu_torch.ops.xxhash import _xxh32_py
    rnd = random.Random(4)
    for n in (0, 1, 15, 16, 17, 100, 4099):
        b = rnd.randbytes(n)
        assert reference.xxh32(b) == _xxh32_py(b)


def test_the_ports_answers_read_back(data, port_out):
    c, wrong = reference.judge("gzip_ext", HW, [(0, data, port_out["deflate"])])
    assert c == reference.zero_counts() and wrong == [False]
    c, wrong = reference.judge("lz4_frame", HW, [(0, data, port_out["lz4"])])
    assert c == reference.zero_counts() and wrong == [False]


def _members(out):
    pos, got = 0, []
    while pos < len(out):
        dest = struct.unpack_from("<I", out, pos + 20)[0]
        got.append((pos, dest))
        pos += 32 + dest
    return got


def test_each_kind_of_gzip_fault_is_counted(data, port_out):
    out = port_out["deflate"]
    (p0, d0), (p1, d1) = _members(out)[:2]

    def judge(bad):
        return reference.judge("gzip_ext", HW, [(0, data, bytes(bad))])[0]
    b = bytearray(out)
    b[p1 + 24 + d1 // 2] ^= 0x10                 # a payload byte
    assert judge(b)["content_errors"] == 1
    b = bytearray(out)
    b[p0 + 24 + d0] ^= 1                         # the first CRC32
    assert judge(b)["checksum_errors"] == 1
    b = bytearray(out)
    b[p0 + 3] = 0                                # FLG
    assert judge(b)["frame_errors"] == 1
    assert judge(out + b"\0")["frame_errors"] == 1
    assert judge(out[:p1])["frame_errors"] == 1
    # 10 bytes stored in 5 blocks of 2 and a final empty one: 40 bytes,
    # inside QATzip's bound (10 + 2 + 48 = 60); 5 more empty blocks: over
    big = b"".join(b"\0" + struct.pack("<HH", 2, 0xFFFD) + b"\0\0"
                   for _ in range(5))
    for blocks, over in ((b"", 0), (b"\0\0\0\xff\xff" * 5, 1)):
        pay = big + blocks + b"\1\0\0\xff\xff"
        member = (struct.pack("<BBBB4sBBH2sHII", 0x1F, 0x8B, 8, 4, b"\0" * 4,
                              0, 255, 12, b"QZ", 8, 10, len(pay)) + pay
                  + struct.pack("<II", zlib.crc32(b"\0" * 10), 10))
        c = reference.judge("gzip_ext", HW, [(0, b"\0" * 10, member)])[0]
        assert c["content_errors"] == 0 and c["expanded_chunks"] == over


def test_each_kind_of_lz4_fault_is_counted(data, port_out):
    out = port_out["lz4"]

    def judge(bad):
        return reference.judge("lz4_frame", HW, [(0, data, bytes(bad))])[0]
    b = bytearray(out)
    b[-1] ^= 1                                   # the content checksum
    assert judge(b)["checksum_errors"] == 1
    b = bytearray(out)
    b[14] ^= 1                                   # the header checksum
    assert judge(b)["frame_errors"] == 1
    b = bytearray(out)
    size = struct.unpack_from("<I", out, 15)[0] & 0x7FFFFFFF
    b[19 + size // 2] ^= 0x40                    # inside the first block
    c = judge(b)
    assert c["content_errors"] >= 1 or c["frame_errors"] >= 1


def test_equal_answers_share_one_check_and_others_are_checked(data, port_out):
    out = port_out["deflate"]
    bad = bytearray(out)
    bad[40] ^= 0xFF
    answers = [(0, data, out), (0, data, bytes(out)), (0, data, bytes(bad))]
    c, wrong = reference.judge("gzip_ext", HW, answers)
    assert wrong == [False, False, True]


def test_lz4_decoder_repeats_overlapping_matches():
    # literals "ab", then a match at offset 2 of length 4 + 6 = 10, then
    # the five last literals the format asks for
    block = bytes([0x26]) + b"ab" + struct.pack("<H", 2)
    got = reference.lz4_decode_block(block + bytes([0x50]) + b"vwxyz",
                                     bytearray(), 100)
    assert got == b"ab" + b"ababababab" + b"vwxyz"


def _block(lead, mlen, tail):
    """Literals ``lead``, one match of ``mlen`` at offset 1, then the
    last literals ``tail`` (none: the block ends on the match)."""
    b = bytes([(len(lead) << 4) | (mlen - 4)]) + lead + struct.pack("<H", 1)
    return b + (bytes([len(tail) << 4]) + tail if tail is not None else b"")


@pytest.mark.parametrize("lead,mlen,tail,ok", [
    (b"a" * 8, 8, b"12345", True),      # start 8 <= 21 - 12, end 16 <= 16
    (b"a" * 8, 8, None, False),         # ends right after a match
    (b"a" * 8, 8, b"1234", False),      # four last literals
    (b"a" * 8, 12, b"12345", True),     # start 8 <= 25 - 12
    (b"a" * 9, 5, b"12345", False),     # start 9 > 19 - 12
    (b"a", 4, b"12345678", True),       # start 1 <= 13 - 12
    (b"abc", 0 + 4, b"x" * 6, False),   # start 3 > 13 - 12
])
def test_lz4_blocks_that_break_the_end_rules_are_refused(lead, mlen, tail,
                                                         ok):
    blk = _block(lead, mlen, tail)
    want = lead + lead[-1:] * mlen + (tail or b"")
    if ok:
        assert reference.lz4_decode_block(blk, bytearray(), 100) == want
    else:
        with pytest.raises(ValueError):
            reference.lz4_decode_block(blk, bytearray(), 100)
    # in a frame: the block is a content error
    fd = struct.pack("<BBQ", 0x4C, 0x40, len(want))
    frame = (struct.pack("<I", reference.LZ4_MAGIC) + fd
             + bytes([(reference.xxh32(fd) >> 8) & 0xFF])
             + struct.pack("<I", len(blk)) + blk
             + struct.pack("<II", 0, reference.xxh32(want)))
    c = reference.judge("lz4_frame", HW, [(0, want, frame)])[0]
    assert c["content_errors"] == (not ok)
    assert c["frame_errors"] == c["checksum_errors"] == 0


def test_an_lz4_frame_without_its_content_size_is_counted():
    data = b"q" * 100
    fd = bytes([0x44, 0x40])                     # FLG without content size
    frame = (struct.pack("<I", reference.LZ4_MAGIC) + fd
             + bytes([(reference.xxh32(fd) >> 8) & 0xFF])
             + struct.pack("<I", len(data) | reference.LZ4_STORED) + data
             + struct.pack("<II", 0, reference.xxh32(data)))
    c = reference.judge("lz4_frame", HW, [(0, data, frame)])[0]
    assert c["checksum_errors"] == 1
    assert c["frame_errors"] == c["content_errors"] == 0


# ---------------------------------------------------------------------------
# zstd frames: qzstd's LZ4s session with the zstd post-process
# ---------------------------------------------------------------------------

#: inputs of several sizes: whole blocks and a short last one, one block,
#: a request under one block
ZSTD_SIZES = (5 * HW + 1234, HW, 3000)


@pytest.fixture(scope="module")
def zstd_outs():
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch import params as P, postproc
    got = []
    for k, n in enumerate(ZSTD_SIZES):
        data = corpus.silesia_like(n, f"zstd{k}")
        s = qz.QzSession(device="cpu")
        s.setup_lz4s(P.SessionParamsLZ4S(qzCallback=postproc.zstd_callback,
                                         callback_external={"level": 1}))
        got.append((data, s.compress(data)))
    return got


def _zstd_frames(out):
    """Each frame of ``out`` as (start, end)."""
    pos, got = 0, []
    while pos < len(out):
        body, _fcs, has_sum = reference.zstd_frame_header(out, pos)
        end = reference.zstd_blocks(out, body)[0] + 4 * has_sum
        got.append((pos, end))
        pos = end
    return got


def _raw_block(n, last):
    return int.to_bytes((n << 3) | last, 3, "little")


def _raw_frame(content, empty_blocks=0):
    """A single-segment frame of ``content`` (under 256 bytes) in one raw
    block, after ``empty_blocks`` empty raw blocks."""
    return (struct.pack("<IBB", reference.ZSTD_MAGIC, 0x20, len(content))
            + _raw_block(0, 0) * empty_blocks
            + _raw_block(len(content), 1) + content)


def test_the_ports_zstd_frames_read_back(zstd_outs):
    for data, out in zstd_outs:
        frames = _zstd_frames(out)
        assert len(frames) == -(-len(data) // HW)
        c, wrong = reference.judge("zstd_frames", HW, [(0, data, out)])
        assert c == reference.zero_counts() and wrong == [False]


def _drop(out, f):
    return out[:f[1][0]] + out[f[1][1]:]


def _swap(out, f):
    (a0, a1), (b0, b1) = f[0], f[1]
    return out[b0:b1] + out[a0:a1] + out[b1:]


def _lie(out, f):
    b = bytearray(out)
    assert b[4] >> 6 == 1                        # a 2-byte content size
    size = struct.unpack_from("<H", b, 5)[0]
    struct.pack_into("<H", b, 5, size - 1)
    return bytes(b)


def _reserved(out, f):
    b = bytearray(out)
    b[f[1][0] + 4] |= 0x08
    return bytes(b)


def _flip(out, f):
    b = bytearray(out)
    b[(f[0][0] + f[0][1]) // 2] ^= 0x55          # inside a compressed block
    return bytes(b)


ZSTD_FAULTS = {
    "truncated": (lambda out, f: out[:-5], "frame_errors"),
    "dropped": (_drop, "content_errors"),
    "swapped": (_swap, "content_errors"),
    "content_size_lies": (_lie, "frame_errors"),
    "reserved_bit": (_reserved, "frame_errors"),
    "trailing_bytes": (lambda out, f: out + b"\0\0\0", "frame_errors"),
    "trailing_frame_header": (lambda out, f: out + out[:6], "frame_errors"),
    "flipped_byte": (_flip, None),
}


@pytest.mark.parametrize("fault", list(ZSTD_FAULTS))
def test_each_kind_of_zstd_fault_is_counted(zstd_outs, fault):
    data, out = zstd_outs[0]
    plant, name = ZSTD_FAULTS[fault]
    c, wrong = reference.judge("zstd_frames", HW,
                               [(0, data, plant(out, _zstd_frames(out)))])
    assert wrong == [True]
    if name is None:    # libzstd refuses it, or it decodes to other bytes
        assert c["frame_errors"] + c["content_errors"] >= 1, c
    else:
        assert c[name] >= 1, c


def test_a_byte_flipped_in_a_raw_block_is_a_content_error():
    content = b"the quick brown fox"
    frame = bytearray(_raw_frame(content))
    frame[-3] ^= 0x20
    c = reference.judge("zstd_frames", HW, [(0, content, bytes(frame))])[0]
    assert c == dict(reference.zero_counts(), content_errors=1)


def test_a_zstd_frame_over_its_bound_is_counted():
    content = b"0123456789"                      # bound: 10 + 63 = 73 bytes
    for empty, over in ((0, 0), (20, 1)):        # 19 bytes; 79 bytes
        frame = _raw_frame(content, empty)
        c = reference.judge("zstd_frames", HW, [(0, content, frame)])[0]
        assert c == dict(reference.zero_counts(), expanded_chunks=over)


def test_a_zstd_frame_with_a_wrong_checksum_is_counted():
    """A frame with a checksum, made by stock libzstd (a handle of this
    test's own, so the reader's declarations stay as they are)."""
    lib = ctypes.CDLL("libzstd.so.1")
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t, ctypes.c_char_p,
                                   ctypes.c_size_t]
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    content = corpus.silesia_like(20000, "sum")
    cap = reference.zstd_bound(len(content))
    buf = ctypes.create_string_buffer(cap)
    cctx = lib.ZSTD_createCCtx()
    try:
        lib.ZSTD_CCtx_setParameter(cctx, 201, 1)     # ZSTD_c_checksumFlag
        n = lib.ZSTD_compress2(cctx, buf, cap, content, len(content))
    finally:
        lib.ZSTD_freeCCtx(cctx)
    assert n < cap
    frame = bytearray(buf.raw[:n])
    assert frame[4] & 0x04
    c = reference.judge("zstd_frames", HW, [(0, content, bytes(frame))])[0]
    assert c == reference.zero_counts()
    frame[-1] ^= 1
    c = reference.judge("zstd_frames", HW, [(0, content, bytes(frame))])[0]
    assert c == dict(reference.zero_counts(), checksum_errors=1)


def test_a_skippable_frame_between_two_frames_is_stepped_over(zstd_outs):
    data, out = zstd_outs[0]
    f = _zstd_frames(out)
    skip = struct.pack("<II", 0x184D2A5E, 7) + b"skipped"
    planted = out[:f[0][1]] + skip + out[f[0][1]:]
    c, wrong = reference.judge("zstd_frames", HW, [(0, data, planted)])
    assert c == reference.zero_counts() and wrong == [False]


def test_without_libzstd_the_zstd_reader_fails(monkeypatch):
    def refused(name, *a, **kw):
        raise OSError(f"{name}: cannot open shared object file")
    reference.libzstd.cache_clear()
    monkeypatch.setattr(reference.ctypes, "CDLL", refused)
    try:
        with pytest.raises(OSError):
            reference.judge("zstd_frames", HW,
                            [(0, b"x", _raw_frame(b"x"))])
    finally:
        monkeypatch.undo()
        reference.libzstd.cache_clear()


def test_the_zstd_reader_loads_none_of_the_program():
    import subprocess
    import sys
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        reference.__file__)))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {root!r})\n"
        "from qzbench import reference\n"
        "f = bytes.fromhex('28b52ffd2005') + (0x29).to_bytes(3, 'little')"
        " + b'hello'\n"
        "c, w = reference.judge('zstd_frames', 65536, [(0, b'hello', f)])\n"
        "assert c == reference.zero_counts() and w == [False], c\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "qzbench" in loaded and "qatzip_tpu_torch" not in loaded
