"""The plain reference: it reads back what the port writes, and finds
each kind of fault in an answer."""

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
