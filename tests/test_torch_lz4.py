"""The port's LZ4 and LZ4s sessions against the JAX package, on the CPU.

``qatzip_tpu_torch.QzSession(device="cpu")`` (plain versions of the
kernels) must give the bytes of ``qatzip_tpu.codec.compress_buffer`` on a
JAX-CPU ``TpuEngine`` with the same knobs, tolerance 0:

  * LZ4 frames on the token route (host ``lz4_pack``), and with both
    engines held on the full-device LZ4 pack (``QZTPU_DEVICE_PACK=1`` on
    the JAX side): the device's block bytes where a row is ok, the host
    coder's where it is not;
  * LZ4s block streams (mini match 3 and 4), and through the lz4s -> zstd
    callback, which libzstd decodes;
  * the LZ4 byte packer's plain version and ``lz4_pack_device`` against
    the JAX package's ``lz4_pack_device`` (words where ok, ``nbytes`` and
    ``ok`` everywhere) on corpus rows and rows hard for the packer;
  * frames: header and footer, stored blocks, concatenated and skippable
    frames, a corrupt checksum or content size; xxh32; the software gate.

All chunks are 16 KiB, so JAX compiles each route once for the file.
"""

import ctypes
import dataclasses
import gc
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qatzip_tpu import codec as jcodec
from qatzip_tpu import params as jparams
from qatzip_tpu import postproc as jpostproc
from qatzip_tpu.formats import lz4_format as jlz4f
from qatzip_tpu.ops import lz4_pack as jlp
from qatzip_tpu.ops import xxhash as jxx
from qatzip_tpu.parallel.dispatch import TpuEngine
from qatzip_tpu.sw import codec as jswc
import qatzip_tpu_torch as qz
from qatzip_tpu_torch import convert, native, postproc
from qatzip_tpu_torch.constants import (DataFormat, QZ_DATA_ERROR,
                                        QZ_POST_PROCESS_ERROR)
from qatzip_tpu_torch.formats import lz4_format as lz4f
from qatzip_tpu_torch.ops import lz4_pack as lp
from qatzip_tpu_torch.ops import xxhash as xx
from qatzip_tpu_torch.parallel.dispatch import CudaEngine
from qatzip_tpu_torch.sw import codec as swc
from qatzip_tpu_torch.sw.lz4_py import lz4_decompress_block_py

from tests.corpus import make_corpus, text_like


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Give what this module held back to the system when it ends: the
    test runner keeps each worker process for many files, JAX keeps every
    compiled program, and glibc keeps freed pages (a file's several GB
    would pile up)."""
    yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


HW = 16384
N = 16384


@pytest.fixture(scope="module")
def data():
    c = make_corpus()
    return (c["text"][:70000] + c["json"][:60000] + c["binary"][:40000]
            + c["runs"][:20000] + c["noise"][:10000])


@pytest.fixture(scope="module")
def jax_engines():
    dev = jax.devices("cpu")[0]
    return {a: TpuEngine([dev], a) for a in ("lz4", "lz4s")}


def _jax_params(algorithm, mini_match=3):
    if algorithm == "lz4":
        jp = jparams.SessionParamsLZ4()
    else:
        jp = jparams.SessionParamsLZ4S()
        jp.lz4s_mini_match = mini_match
    jp.common.hw_buff_sz = HW
    return jp


def _both(data, jax_engines, monkeypatch, algorithm, *, device_pack=False,
          mini_match=3, callback=None):
    """(JAX bytes, port bytes, port session) for one request, both
    engines on the token route or held on the LZ4 device pack."""
    monkeypatch.setenv("QZTPU_DEVICE_PACK", "1" if device_pack else "0")
    monkeypatch.setattr(CudaEngine, "packs_on_device",
                        lambda self, s, algorithm="deflate":
                        device_pack and algorithm == "lz4")
    jp = _jax_params(algorithm, mini_match)
    fmt = DataFormat.LZ4 if algorithm == "lz4" else DataFormat.LZ4S
    want, want_crc = jcodec.compress_buffer(
        data, algorithm=algorithm, data_fmt=_jfmt(fmt), level=1,
        hw_buff_sz=HW, engine=jax_engines[algorithm],
        input_sz_thrshold=jp.common.input_sz_thrshold, mini_match=mini_match)
    if callback is not None:
        want = callback[0](None, data, want, mini_match)
    p = convert.params_from_reference(dataclasses.asdict(jp))
    sess = qz.QzSession(device="cpu")
    if algorithm == "lz4":
        assert sess.setup_lz4(p) == qz.QZ_OK
    else:
        p.qzCallback = None if callback is None else callback[1]
        assert sess.setup_lz4s(p) == qz.QZ_OK
    got, crc = sess.compress(data, with_crc=True)
    assert crc == want_crc
    return want, got, sess


def _jfmt(fmt):
    from qatzip_tpu.constants import DataFormat as JFmt
    return JFmt(int(fmt))


def _frame_blocks(blob):
    """(payload, stored) of every block of the LZ4 frame in ``blob``."""
    info = lz4f.parse_lz4_frame_header(blob, 0)
    blocks, _end = lz4f.walk_lz4_blocks(blob, 0, len(blob), info.header_sz)
    return [(blob[o:o + s], st) for o, s, st in blocks]


@pytest.mark.parametrize("device_pack", [False, True],
                         ids=["token", "device-pack"])
def test_lz4_session_matches_jax_codec(data, jax_engines, monkeypatch,
                                       device_pack):
    want, got, sess = _both(data, jax_engines, monkeypatch, "lz4",
                            device_pack=device_pack)
    assert got == want
    assert sess.decompress(got) == data
    # the independent decoder, block by block
    out = b"".join(p if st else lz4_decompress_block_py(p, HW)
                   for p, st in _frame_blocks(got))
    assert out == data
    assert jswc.lz4_frame_decompress(got)[0] == data
    assert len(got) < 0.6 * len(data)


@pytest.mark.parametrize("mini_match", [3, 4])
def test_lz4s_session_matches_jax_codec(data, jax_engines, monkeypatch,
                                        mini_match):
    want, got, _ = _both(data, jax_engines, monkeypatch, "lz4s",
                         mini_match=mini_match)
    assert got == want
    # [size][payload]*, one block a chunk
    pos, nblk = 0, 0
    while pos < len(got):
        (sz,) = struct.unpack_from("<I", got, pos)
        pos += 4 + sz
        nblk += 1
    assert pos == len(got) and nblk == -(-len(data) // HW)


def test_lz4s_zstd_matches_jax_and_decodes(data, jax_engines, monkeypatch):
    want, got, _ = _both(data, jax_engines, monkeypatch, "lz4s",
                         callback=(jpostproc.zstd_callback,
                                   postproc.zstd_callback))
    assert got == want
    assert got[:4] == b"\x28\xb5\x2f\xfd"          # a zstd frame
    assert postproc.zstd_decompress(got) == data
    assert jpostproc.zstd_decompress(got) == data


def test_missing_zstd_raises_post_process_error(data, monkeypatch):
    """Without libzstd.so.1 (the library linked without it) every zstd
    call raises QZ_POST_PROCESS_ERROR; nothing falls back."""
    lib = native.get_lib()
    monkeypatch.setattr(lib, "zstd_version", 0)
    p = qz.SessionParamsLZ4S()
    p.qzCallback = postproc.zstd_callback
    sess = qz.QzSession(device="cpu")
    sess.setup_lz4s(p)
    for call in (lambda: sess.compress(data[:5000]),
                 lambda: postproc.zstd_compress(b"abc"),
                 lambda: postproc.zstd_decompress(b"\x28\xb5\x2f\xfd" * 4)):
        with pytest.raises(qz.QzError) as e:
            call()
        assert e.value.rc == QZ_POST_PROCESS_ERROR


def _pack_rows(n):
    """The JAX test's rows (corpus text in place of the reference source)
    and rows hard for the packer: back-to-back 273-matches, literal runs
    of exactly 269, 270 and 271, a length that is not a multiple of 4,
    and the empty row; 16 rows, the session's tile shape."""
    rng = np.random.default_rng(4)
    rows = [
        text_like(n + 64, seed=1)[:n],
        b"A" * n,
        rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes(),
        b"hello",
        bytes(rng.integers(0, 256, 270, dtype=np.uint8)) * 2 + b"Z" * 100,
        ((b"abcd" * 2000
          + rng.integers(0, 256, 200, dtype=np.uint8).tobytes()) * 2)[:n],
        b"",
        rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
    ]
    for run in (269, 270, 271):
        rows.append(bytes(rng.integers(0, 256, run - 1, dtype=np.uint8))
                    + b"x" * n)
    rows.append(text_like(n + 64, seed=2)[:n - 3])
    data = np.zeros((16, n), np.uint8)
    lengths = np.zeros(16, np.int32)
    for i, r in enumerate(rows):
        r = r[:n]
        data[i, :len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    return data, lengths, len(rows)


@pytest.fixture(scope="module")
def pack_case():
    data, lengths, nrows = _pack_rows(N)
    words, nbytes, ok = jlp.lz4_pack_device(jnp.asarray(data),
                                            jnp.asarray(lengths), n=N)
    return dict(data=data, lengths=lengths, nrows=nrows,
                words=np.asarray(words), nbytes=np.asarray(nbytes),
                ok=np.asarray(ok))


def test_lz4_pack_device_matches_jax(pack_case):
    c = pack_case
    words, nbytes, ok = lp.lz4_pack_device(torch.from_numpy(c["data"]),
                                           torch.from_numpy(c["lengths"]),
                                           n=N)
    assert np.array_equal(nbytes.numpy(), c["nbytes"])
    assert np.array_equal(ok.numpy(), c["ok"])
    w = words.numpy().view(np.uint32)
    assert np.array_equal(w[c["ok"]], c["words"][c["ok"]])
    assert not w[~c["ok"]].any()          # rows that are not ok: zeros
    # the 271-literal run and the noise row fall back, the rest fit
    assert c["ok"].tolist()[:12] == [True] * 7 + [False, True, True, False,
                                                  True]
    for i in range(c["nrows"]):
        ln = int(c["lengths"][i])
        if c["ok"][i] and ln:
            blk = w[i].tobytes()[:int(nbytes[i])]
            src = c["data"][i, :ln].tobytes()
            assert lz4_decompress_block_py(blk, ln) == src
            assert native.get_lib().lz4_decompress_block(blk, ln) == src


def test_lz4_pack_rows_ref_matches_jax_on_the_same_planes(pack_case):
    """The byte packer alone, on the port's planes (equal to the JAX
    package's: same words), with and without a short max_words."""
    c = pack_case
    planes = lp.lz4_planes(torch.from_numpy(c["data"]),
                           torch.from_numpy(c["lengths"]), n=N)
    args = (torch.from_numpy(c["data"]),) + planes
    words, nbytes, ok = lp.lz4_pack_rows(*args, max_words=lp.lz4_max_words(N))
    assert np.array_equal(nbytes.numpy(), c["nbytes"])
    w = words.numpy().view(np.uint32)
    assert np.array_equal(w[c["ok"]], c["words"][c["ok"]])
    short, nb2, ok2 = lp.lz4_pack_rows_ref(*args, max_words=100)
    assert np.array_equal(short.numpy(), words.numpy()[:, :100])
    assert torch.equal(nb2, nbytes) and torch.equal(ok2, ok)


def test_ok_is_no_run_over_270_literals(pack_case):
    """What the card's byte packer decides ok by, before it writes a
    word: a row is ok exactly when no run of consecutive literals in its
    lit plane is longer than LZ4_MAX_RUN (the JAX route's flags)."""
    c = pack_case
    lit = lp.lz4_planes(torch.from_numpy(c["data"]),
                        torch.from_numpy(c["lengths"]), n=N)[3].numpy()
    longest = []
    for row in lit:
        edges = np.flatnonzero(np.diff(np.concatenate(
            [[0], row.astype(np.int8), [0]])))
        longest.append(int((edges[1::2] - edges[::2]).max(initial=0)))
    assert [r <= lp.LZ4_MAX_RUN for r in longest] == c["ok"].tolist()
    # the fixture holds rows on both sides of the limit
    assert 270 in longest and 271 in longest


def test_lz4_group_cap_never_binds_on_ok_rows(pack_case):
    """The JAX route dropped what lay past LZ4_GROUP_W words of a
    256-position group: on ok rows no group comes near it."""
    c = pack_case
    t = torch.from_numpy
    planes = lp.lz4_planes(t(c["data"]), t(c["lengths"]), n=N)
    lr, nm = lp.run_planes(planes[0], planes[2], planes[3])
    _vals, nbs = lp.lz4_emissions(t(c["data"]), *planes, lr, nm)
    group_bytes = nbs.reshape(16, -1, 256).sum(2)
    worst = int(group_bytes[torch.tensor(c["ok"])].max())
    assert (worst + 3) // 4 + 1 <= lp.LZ4_GROUP_W
    assert worst <= 300


def test_xxh32_matches_the_python_oracle_and_jax():
    rng = np.random.default_rng(9)
    for n in (0, 1, 3, 4, 15, 16, 17, 100, 4099):
        b = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 1, 0x9E3779B1):
            want = xx._xxh32_py(b, seed)
            assert xx.xxh32(b, seed) == want == jxx._xxh32_py(b, seed)
        st = xx.XXH32State()
        for piece in (b[:5], b[5:40], b[40:]):
            st.update(piece)
        assert st.digest() == xx.xxh32(b)


def test_lz4_frames(data, jax_engines, monkeypatch):
    """Header and footer, stored blocks, concatenated and skippable
    frames, and a corrupt checksum or content size."""
    for size in (0, 1, 65536, 1 << 40):
        assert lz4f.lz4_frame_header(size) == jlz4f.lz4_frame_header(size)
    assert lz4f.lz4_frame_footer(0xDEADBEEF) == jlz4f.lz4_frame_footer(
        0xDEADBEEF)
    noise = np.random.default_rng(2).integers(0, 256, 40000,
                                              np.uint8).tobytes()
    _want, blob, sess = _both(data[:60000] + noise, jax_engines, monkeypatch,
                              "lz4")
    stored = [st for _p, st in _frame_blocks(blob)]
    assert any(stored) and not all(stored)
    info = lz4f.parse_lz4_frame_header(blob)
    jinfo = jlz4f.parse_lz4_frame_header(blob)
    assert dataclasses.astuple(info) == dataclasses.astuple(jinfo)
    assert (lz4f.find_lz4_footer(blob, 0, len(blob))
            == jlz4f.find_lz4_footer(blob, 0, len(blob)) == len(blob) - 8)
    assert lz4f.verify_lz4_frame_header(blob) == jlz4f.verify_lz4_frame_header(
        blob) == qz.QZ_OK
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    # a frame whose non-final blocks fall short of 64 KiB decodes block by
    # block on the session's engine
    short = swc.lz4_frame_compress(data[:5000], hw_buff_sz=1000)
    assert short == jswc.lz4_frame_compress(data[:5000], hw_buff_sz=1000)
    two = (blob + skippable + swc.lz4_frame_compress(data[:30000])
           + short)
    assert swc.lz4_frame_compress(data[:30000]) == jswc.lz4_frame_compress(
        data[:30000])
    want = data[:60000] + noise + data[:30000] + data[:5000]
    assert sess.decompress(two) == want
    assert swc.sw_decompress_multi(two, DataFormat.LZ4)[0] == want
    bad_sum = bytearray(blob)
    bad_sum[-1] ^= 1
    bad_size = bytearray(blob)
    bad_size[6] ^= 1                        # the content size's low byte
    bad_size[14] = (jxx.xxh32(bytes(bad_size[4:14])) >> 8) & 0xFF
    for bad in (bad_sum, bad_size):
        with pytest.raises(qz.QzError) as e:
            sess.decompress(bytes(bad))
        assert e.value.rc == QZ_DATA_ERROR
    with pytest.raises(qz.QzError) as e:
        sess.decompress(bytes(blob[:len(blob) // 2]))
    assert e.value.rc == QZ_DATA_ERROR


@pytest.mark.parametrize("algorithm", ["lz4", "lz4s"])
@pytest.mark.parametrize("size", [0, 500])
def test_small_requests_take_the_software_gate(data, jax_engines,
                                               monkeypatch, algorithm, size):
    want, got, sess = _both(data[:size], jax_engines, monkeypatch, algorithm)
    assert got == want
    if algorithm == "lz4":
        assert sess.decompress(got) == data[:size]
    assert qz.QzSession(device="cpu").max_compressed_length(size) > 0


def test_host_engine_and_software_codec_match_jax(data):
    from qatzip_tpu.engines import host_engine as jhost
    from qatzip_tpu_torch.engines import host_engine
    chunks = [data[o:o + HW] for o in range(0, len(data), HW)]
    for algorithm in ("lz4", "lz4s"):
        for part in (chunks, chunks[:1]):
            got = host_engine.compress_chunks(part, level=1,
                                              algorithm=algorithm,
                                              mini_match=4)
            want = jhost.compress_chunks(part, level=1, algorithm=algorithm,
                                         mini_match=4)
            assert [(bytes(p), c) for p, c in got] == [
                (bytes(p), c) for p, c in want]
    assert swc.lz4s_blocks_compress(data, mini_match=4) == \
        jswc.lz4s_blocks_compress(data, mini_match=4)
    blocks = host_engine.compress_chunks(chunks, level=1, algorithm="lz4")
    assert b"".join(host_engine.decompress_chunks(
        [p for p, _ in blocks], [HW] * len(blocks), algorithm="lz4")) == data


def test_lz4_params_carry_across():
    for jp in (_jax_params("lz4"), _jax_params("lz4s", 4)):
        p = convert.params_from_reference(dataclasses.asdict(jp))
        assert type(p).__name__ == type(jp).__name__
        assert dataclasses.asdict(p.common) == dataclasses.asdict(jp.common)
        assert p.check() == qz.QZ_OK
    bad = qz.SessionParamsLZ4S(lz4s_mini_match=5)
    assert qz.QzSession(device="cpu").setup_lz4s(bad) == qz.QZ_PARAMS
    lvl = qz.SessionParamsLZ4()
    lvl.common.comp_lvl = 13
    assert qz.QzSession(device="cpu").setup_lz4(lvl) == qz.QZ_PARAMS
