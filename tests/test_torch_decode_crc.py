"""The port's device LZ4 decode, device CRC32 and tracing, on the CPU.

Each is held to the JAX package with the same inputs, made from a numpy
seed, tolerance 0:

  * ``resolve_refs_ref`` (the plain version of the kernel
    ``lz4_resolve_refs``) against the JAX ``resolve_refs``: bytes and
    flag, on the reference planes of five rows, of a 300,001-byte chain
    of depth 300,000, and with too few rounds;
  * ``decode_blocks_device(device="cpu")`` against the JAX one, and a
    malformed block raising QZ_DATA_ERROR on both of the port's legs;
  * LZ4 frames through a port session whose engine is held on the device
    decode leg against the JAX package's decode;
  * ``crc32_batch_ref`` (the plain version of the kernel ``crc32_rows``)
    against the JAX ``crc32_batch_device`` and zlib, and the engine's
    crcs with the device CRC held, on each route;
  * ``stage``'s counters against the JAX ``stage``; ``qz_trace`` and
    ``maybe_trace_from_env``; the new modules import without jax.

JAX compiles ``resolve_refs`` at (5, 32768) and (1, 524288) and
``crc32_batch_device`` at n = 2048 and 8192 only.
"""

import contextlib
import ctypes
import gc
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qatzip_tpu import codec as jcodec
from qatzip_tpu.constants import DataFormat as JDataFormat
from qatzip_tpu.ops import crc32_mxu as jcrc
from qatzip_tpu.ops import lz4_decode as jdec
from qatzip_tpu.utils import debug as jdebug
from qatzip_tpu.utils import trace as jtrace
import qatzip_tpu_torch as qz
from qatzip_tpu_torch import codec, native
from qatzip_tpu_torch.constants import DataFormat, QZ_DATA_ERROR, QzError
from qatzip_tpu_torch.engines import host_engine
from qatzip_tpu_torch.formats import lz4_format as lz4f
from qatzip_tpu_torch.ops import crc32_mxu as crc
from qatzip_tpu_torch.ops import lz4_decode as dec
from qatzip_tpu_torch.parallel import dispatch
from qatzip_tpu_torch.parallel.dispatch import CudaEngine
from qatzip_tpu_torch.utils import debug
from qatzip_tpu_torch.utils import trace

from tests.corpus import make_corpus
from tests.reference_native import (one_intra_op_thread,
                                     require_reference_native)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows():
    """The rows of the JAX package's own device-decode test."""
    rng = np.random.default_rng(9)
    return [
        b"compress me please " * 300,
        rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        b"A" * 20000,                      # dist-1 chains of depth 19,999
        (b"abc" * 5000 + b"xyz" * 100),
        b"x",
    ]


DEEP = b"Z" * 300001                       # one chain of depth 300,000


def _planes(rows, n):
    """(B, n) int32 reference planes of the rows' LZ4 blocks, -1 padded."""
    lib = native.get_lib()
    refs = np.full((len(rows), n), -1, np.int32)
    for i, r in enumerate(rows):
        assert lib.lz4_ref_block(lib.lz4_compress_block(r), refs[i], n) \
            == len(r)
    return refs


@pytest.mark.parametrize("case,rounds", [("rows", 16), ("deep", 20),
                                         ("too-few-rounds", 3)])
def test_resolve_refs_ref_matches_jax(case, rounds):
    """Bytes and flag bit for bit; 16 and 20 rounds are the ones
    decode_blocks_device takes at n = 32768 and 524288 (resolved), 3 are
    too few for the rows' chains (both flags set, the plane the same
    synchronous rounds left)."""
    refs = (_planes([DEEP], 524288) if case == "deep"
            else _planes(_rows(), 32768))
    want, want_flag = jdec.resolve_refs(jnp.asarray(refs), max_rounds=rounds)
    plane = torch.from_numpy(refs.copy())
    got, flag = dec.resolve_refs_ref(plane, rounds)
    assert bool(flag) == bool(want_flag) == (case == "too-few-rounds")
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the wrapper takes the plain version for a CPU tensor, in place
    plane2 = torch.from_numpy(refs.copy())
    got2, flag2 = dec.resolve_refs(plane2, rounds)
    assert torch.equal(got2, got) and bool(flag2) == bool(flag)
    assert torch.equal(plane2, plane)
    if case != "too-few-rounds":
        assert (plane < 0).all()


def test_decode_blocks_device_matches_jax():
    lib = native.get_lib()
    for rows in (_rows(), [DEEP, b"short tail"]):
        payloads = [lib.lz4_compress_block(r) for r in rows]
        sizes = [len(r) for r in rows]
        got = dec.decode_blocks_device(payloads, sizes, device="cpu")
        assert got == jdec.decode_blocks_device(payloads, sizes) == rows
    assert dec.decode_blocks_device([], [], device="cpu") == []


def test_decode_blocks_device_tiles(monkeypatch):
    """Rows go to the device in tiles of at most TILE_B rows and
    TILE_REFS references; the bytes do not depend on the tiling."""
    lib = native.get_lib()
    rows = _rows() * 3
    payloads = [lib.lz4_compress_block(r) for r in rows]
    calls = []
    real = dec.resolve_refs

    def counted(ref, max_rounds):
        calls.append(tuple(ref.shape))
        return real(ref, max_rounds)
    monkeypatch.setattr(dec, "resolve_refs", counted)
    monkeypatch.setattr(dec, "TILE_B", 4)
    monkeypatch.setattr(dec, "TILE_REFS", 3 * 32768)
    got = dec.decode_blocks_device(payloads, [len(r) for r in rows],
                                   device="cpu")
    assert got == rows
    assert calls == [(3, 32768)] * 5


def _corrupt_blocks():
    """(name, payload, expected size) of blocks the device leg's parse and
    the host decoder must both refuse."""
    lib = native.get_lib()
    good = lib.lz4_compress_block(b"compress me please " * 300)
    return [
        ("offset before the start", bytes([0x0F, 0x05, 0x00]), 100),
        ("truncated", good[:len(good) // 2], 5700),
        ("over its expected size", good, 5699),
    ]


@pytest.mark.parametrize("leg", ["host", "device"])
def test_malformed_block_raises_data_error(leg, monkeypatch):
    """Both of the port's legs raise QzError(QZ_DATA_ERROR); the device
    leg is not retried on the host."""
    eng = CudaEngine(torch.device("cpu"))
    monkeypatch.setattr(CudaEngine, "decodes_on_device",
                        lambda self: leg == "device")
    host_calls = []
    real = host_engine.decompress_chunks

    def counted(*a, **k):
        host_calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(host_engine, "decompress_chunks", counted)
    for name, payload, size in _corrupt_blocks():
        with pytest.raises(QzError) as e:
            eng.decompress_chunks([payload], [size], algorithm="lz4")
        assert e.value.rc == QZ_DATA_ERROR, name
    assert len(host_calls) == (3 if leg == "host" else 0)


def _lz4_frame(data: bytes) -> bytes:
    out, _crc = codec.compress_buffer(
        data, data_fmt=DataFormat.LZ4, level=1, hw_buff_sz=65536,
        engine=None, algorithm="lz4")
    return out


def _frames():
    c = make_corpus()
    text = c["text"][:150000]
    noisy = c["text"][:70000] + c["noise"][:70000]   # a stored block
    return {"one": _lz4_frame(text), "stored": _lz4_frame(noisy),
            "pair": _lz4_frame(text[:90000]) + _lz4_frame(noisy),
            "empty": _lz4_frame(b"")}, {"one": text, "stored": noisy,
                                         "pair": text[:90000] + noisy,
                                         "empty": b""}


def _blocks(frame: bytes):
    """The (offset, size, stored) of each block of the frame's first
    frame."""
    info = lz4f.parse_lz4_frame_header(frame, 0)
    return lz4f.walk_lz4_blocks(frame, 0, len(frame), info.header_sz)[0]


def test_lz4_session_on_the_device_leg_matches_jax(monkeypatch):
    """A port LZ4 session on CudaEngine(device="cpu"), held on the device
    decode leg, decodes frames (one with a stored block, a concatenated
    pair) to the JAX package's output, through decode_blocks_device."""
    frames, plain = _frames()
    monkeypatch.setattr(CudaEngine, "decodes_on_device", lambda self: True)
    calls = []
    real = dispatch.decode_blocks_device

    def counted(payloads, sizes, *, device):
        calls.append(len(payloads))
        return real(payloads, sizes, device=device)
    monkeypatch.setattr(dispatch, "decode_blocks_device", counted)
    sess = qz.QzSession(device="cpu")
    assert sess.setup_lz4() == qz.QZ_OK
    for name, frame in frames.items():
        want, _c, _crc = jcodec.decompress_buffer(
            frame, data_fmt=JDataFormat.LZ4, algorithm="lz4")
        got = sess.decompress(frame)
        assert got == want == plain[name], name
        out, consumed, crc_ = codec.decompress_buffer(
            frame, data_fmt=DataFormat.LZ4, algorithm="lz4",
            engine=sess._engine)
        assert (out, consumed, crc_) == (want, len(frame),
                                        zlib.crc32(want))
    assert calls and sum(calls) > 0
    # a stored block rides along: the "stored" frame has fewer coded
    # blocks than blocks
    blocks = _blocks(frames["stored"])
    assert any(b[2] for b in blocks) and not all(b[2] for b in blocks)


def test_lz4_session_device_leg_corrupt_frame(monkeypatch):
    """A frame with a corrupt block: the port's device leg raises
    QZ_DATA_ERROR. The JAX package under QZTPU_DEVICE_DECODE=1 raises
    too, but a ValueError: its router catches the device leg's error and
    decodes again on the host, whose native decoder lets ValueError out
    (a fault of the reference, not copied)."""
    frames, _plain = _frames()
    frame = bytearray(frames["one"])
    off, _sz, stored = _blocks(frames["one"])[0]
    assert not stored
    # the first block's first sequence: no literal, then a match at
    # offset 5 before any output
    frame[off:off + 3] = bytes([0x0F, 0x05, 0x00])
    frame = bytes(frame)
    monkeypatch.setattr(CudaEngine, "decodes_on_device", lambda self: True)
    sess = qz.QzSession(device="cpu")
    sess.setup_lz4()
    with pytest.raises(QzError) as e:
        sess.decompress(frame)
    assert e.value.rc == QZ_DATA_ERROR
    import qatzip_tpu as jqz
    monkeypatch.setenv("QZTPU_DEVICE_DECODE", "1")
    js = jqz.QzSession()
    js.setup_lz4()
    with pytest.raises(ValueError):
        js.decompress(frame)


def _crc_rows(n: int):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (7, n), dtype=np.uint8)
    data[3] = 0
    data[4] = 0xFF
    data[6, 1000:] = 0       # a ragged row of 1000 bytes, padded
    return data


@pytest.mark.parametrize("n", [2048, 8192])
def test_crc32_batch_ref_matches_jax_and_zlib(n):
    data = _crc_rows(n)
    want = np.asarray(jcrc.crc32_batch_device(data, n=n)).astype(np.int64)
    got = crc.crc32_batch_ref(torch.from_numpy(data), n=n)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert got.tolist() == [zlib.crc32(r.tobytes()) for r in data]
    # the padded row's crc is the padded message's: the host takes the
    # ragged row's own
    assert int(got[6]) != zlib.crc32(data[6, :1000].tobytes())
    assert torch.equal(crc.crc32_batch_device(torch.from_numpy(data), n=n),
                       got)
    with pytest.raises(ValueError):
        crc.crc32_batch_device(torch.from_numpy(data), n=n // 2)


def _chunks():
    c = make_corpus()
    src = c["text"][:40000] + c["json"][:30000] + c["binary"][:20000]
    return [src[o:o + 16384] for o in range(0, 65536, 16384)] + [src[-5000:]]


@pytest.mark.parametrize("route", ["token", "static-device-pack",
                                   "lz4-device-pack"])
def test_engine_device_crc_on_each_route(route, monkeypatch):
    """With crc_on_device held, every full row's crc comes from
    crc32_batch_device on the staged tile and the ragged chunk's from the
    host; every crc equals zlib's and every payload the host-crc route's."""
    chunks = _chunks()
    algorithm = "lz4" if route.startswith("lz4") else "deflate"
    static = route == "static-device-pack"
    monkeypatch.setattr(CudaEngine, "packs_on_device",
                        lambda self, s, algorithm="deflate": route != "token")
    eng = CudaEngine(torch.device("cpu"))
    kw = dict(level=1, algorithm=algorithm, huffman_static=static)
    host = eng.compress_chunks(chunks, **kw)
    rows = []
    real = dispatch.crc32_batch_device

    def counted(data, *, n):
        rows.append(int(data.shape[0]))
        return real(data, n=n)
    monkeypatch.setattr(dispatch, "crc32_batch_device", counted)
    monkeypatch.setattr(CudaEngine, "crc_on_device", lambda self: True)
    got = eng.compress_chunks(chunks, **kw)
    assert rows == [8]                    # one tile, bucketed to 8 rows
    assert [c for _p, c in got] == [zlib.crc32(c) for c in chunks]
    assert got == host


def test_stage_counts_match_jax():
    """Both packages' ``stage`` bump the same counter keys by the same
    counts in the calling thread."""
    import threading

    def mine():
        tid = threading.get_ident()
        return (dict(jdebug.get_counters().snapshot().get(tid, {})),
                dict(debug.get_counters().snapshot().get(tid, {})))
    (j0, p0) = mine()
    for _ in range(2):
        with jtrace.stage("parity_probe"):
            pass
        with trace.stage("parity_probe"):
            pass
    (j1, p1) = mine()

    def diff(a, b):
        return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}
    jd, pd = diff(j0, j1), diff(p0, p1)
    assert set(jd) == set(pd) == {"stage_parity_probe", "stage_parity_probe_us"}
    assert jd["stage_parity_probe"] == pd["stage_parity_probe"] == 2


def test_qz_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with trace.qz_trace(d) as got:
        assert got == d
        with trace.stage("traced_stage"):
            torch.arange(1000).sum()
    (name,) = os.listdir(d)
    assert name.startswith("qztpu_torch_") and name.endswith(".json")
    with open(os.path.join(d, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "traced_stage" for e in events)


def test_maybe_trace_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("QZTPU_TRACE", raising=False)
    assert isinstance(trace.maybe_trace_from_env(), contextlib.nullcontext)
    d = str(tmp_path / "env")
    monkeypatch.setenv("QZTPU_TRACE", d)
    with trace.maybe_trace_from_env():
        torch.ones(3).add_(1)
    assert len(os.listdir(d)) == 1


def test_new_modules_import_without_jax():
    """The modules of this slice import with jax and the JAX package
    unavailable, and leave neither in sys.modules."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['qatzip_tpu'] = None; "
            "import qatzip_tpu_torch.ops.lz4_decode, "
            "qatzip_tpu_torch.ops.crc32_mxu, qatzip_tpu_torch.utils.trace, "
            "qatzip_tpu_torch.parallel.dispatch, qatzip_tpu_torch.codec; "
            "from qatzip_tpu_torch.utils import qz_trace, stage, "
            "maybe_trace_from_env; "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'qatzip_tpu') and sys.modules[k] is not None))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Load the JAX package's native library first (the reference;
    tests/reference_native.py), and give what this module held back to the
    system when it ends (the test runner keeps each worker for many files;
    JAX keeps every compiled program, glibc freed pages)."""
    require_reference_native()
    with one_intra_op_thread():
        yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def test_reference_native_reloads_a_missing_library(monkeypatch):
    """The module fixtures' guard: a worker whose JAX-package library did
    not load (lib None) loads it again; if it still cannot, the guard
    fails with a message that names the build race."""
    from qatzip_tpu import native as jnative
    monkeypatch.setattr(jnative, "lib", None)
    require_reference_native()
    assert jnative.lib is not None
    assert jnative.lib.crc32(b"abc") == zlib.crc32(b"abc")
    monkeypatch.setattr(jnative, "lib", None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    with pytest.raises(AssertionError, match="build race"):
        require_reference_native(tries=2, wait_s=0.0)
