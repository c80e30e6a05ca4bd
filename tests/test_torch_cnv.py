"""Compress-and-verify (CnV) in the port, on the CPU.

  * every compress route with ``cnv=True`` and no fault gives the
    ``cnv=False`` bytes: the deflate token path (host packer modes 0 and
    1), the static and dynamic device packs, the row split (256 KiB
    chunks) on the token path and the dynamic device pack, LZ4 on the
    token path and the device pack, LZ4s; the engine over 2 and 3 CPU
    devices gives the one-device bytes on each;
  * faults: the packer or finish step is patched to corrupt the chunks
    a predicate picks by content (the host pool reorders calls). Each
    corrupted chunk's payload equals what the JAX package's
    ``TpuEngine._verify_or_fallback`` returns for the corrupted payload
    (a host function: no JAX program is compiled), or on the LZ4 device
    pack what the JAX package's device-pack finish does (the native
    block coder at its 65535-byte window, ``dispatch.py:704-711``); every
    other chunk keeps its ``cnv=False`` bytes; stock zlib or the LZ4
    decoder gives back every chunk; the fallbacks are counted. LZ4s
    passes unverified. Over 3 devices the faults give the one-device
    bytes;
  * ``HostEngine.compress_chunks(..., sw_coder="zlib")`` equals the JAX
    host engine's at levels 1, 4, 6 and 9, both final flags, deflate,
    LZ4 and LZ4s;
  * ``utils.debug``: ``Counters.dump`` and ``Timer``, and the dump at
    exit under ``QZTPU_DEBUG=1``.

Every comparison is exact (tolerance 0): the outputs are bytes.
"""

import ctypes
import gc
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

import jax

from qatzip_tpu import native as jnative
from qatzip_tpu.engines import host_engine as jhost_engine
from qatzip_tpu.parallel.dispatch import TpuEngine
from qatzip_tpu_torch import native
from qatzip_tpu_torch.engines import host_engine
from qatzip_tpu_torch.parallel import dispatch
from qatzip_tpu_torch.parallel.dispatch import CudaEngine
from qatzip_tpu_torch.utils import debug

from tests.reference_native import (one_intra_op_thread,
                                     require_reference_native)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the chunks of tests/test_errinject.py, with the final flags mixed
DEFLATE = [(b"inject %d " % i) * 400 for i in range(4)]
DEFLATE_FINALS = [True, False, True, False]
# the chunks of test_lz4_pack_device.py::test_lz4_device_pack_engine_path,
# and one whose second part repeats its first at distance 40,000: the LZ4
# coders at a 32 KiB and a 65535-byte window give it other blocks
_REC = b"".join(b"rec%05d;" % i for i in range(5000))
LZ4 = [b"engine path " * 3000,
       np.random.default_rng(8).integers(0, 256, 50000,
                                         dtype=np.uint8).tobytes(),
       b"R" * 40000, b"", _REC + _REC[:20000]]
# the row split: a 256 KiB chunk (four 64 KiB rows) and a 100 KB one
_SPLIT_TEXT = b"".join(b"split row %d; " % i for i in range(30000))
SPLIT = [_SPLIT_TEXT[:262144], _SPLIT_TEXT[5000:105000]]

# (route, algorithm, huffman_static, held on the device pack, chunks,
#  final flags, the content the fault picks)
ROUTES = {
    "token-mode0": ("deflate", False, False, DEFLATE, DEFLATE_FINALS,
                    lambda c: c.startswith((b"inject 1 ", b"inject 3 "))),
    "token-mode1": ("deflate", True, False, DEFLATE, DEFLATE_FINALS,
                    lambda c: c.startswith((b"inject 0 ", b"inject 3 "))),
    "static-device-pack": ("deflate", True, True, DEFLATE, DEFLATE_FINALS,
                           lambda c: c.startswith((b"inject 1 ",
                                                   b"inject 2 "))),
    "dynamic-device-pack": ("deflate", False, True, DEFLATE, DEFLATE_FINALS,
                            lambda c: c.startswith((b"inject 1 ",
                                                    b"inject 3 "))),
    # the second row of the 256 KiB chunk
    "split-token": ("deflate", False, False, SPLIT, None,
                    lambda c: c[:32] == SPLIT[0][65536:65568]),
    "split-dynamic-device-pack": ("deflate", False, True, SPLIT, None,
                                  lambda c: c[:32] == SPLIT[0][65536:65568]),
    "lz4-token": ("lz4", False, False, LZ4, None,
                  lambda c: c.startswith((b"engine path", b"rec00000;"))),
    "lz4-device-pack": ("lz4", False, True, LZ4, None,
                        lambda c: c.startswith((b"engine path",
                                                b"rec00000;"))),
    "lz4s": ("lz4s", False, False, LZ4, None,
             lambda c: c.startswith((b"engine path", b"rec00000;"))),
}
# chunks whose payload the fault changes on each route
CORRUPTED = {"token-mode0": {1, 3}, "token-mode1": {0, 3},
             "static-device-pack": {1, 2}, "dynamic-device-pack": {1, 3},
             "split-token": {0}, "split-dynamic-device-pack": {0},
             "lz4-token": {0, 4}, "lz4-device-pack": {0, 4}, "lz4s": {0, 4}}


@pytest.fixture(scope="module", autouse=True)
def _module():
    """The JAX package's native library first (tests/reference_native.py);
    torch on one intra-op thread; at the end JAX's caches cleared and the
    freed heap returned to the system."""
    require_reference_native()
    with one_intra_op_thread():
        yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def _hold(monkeypatch, device_pack: bool) -> None:
    monkeypatch.setattr(CudaEngine, "packs_on_device",
                        lambda self, static, algorithm="deflate":
                        device_pack)


def _compress(route, cnv, devices=1):
    algorithm, static, _pack, chunks, finals, _pick = ROUTES[route]
    eng = dispatch.build_engine(["cpu"] * devices)
    return eng.compress_chunks(chunks, level=1, algorithm=algorithm,
                               final_flags=finals, huffman_static=static,
                               cnv=cnv)


def _flip(payload) -> bytes:
    out = bytearray(payload)
    out[5] ^= 0xFF
    return bytes(out)


def _inject(monkeypatch, route) -> None:
    """Corrupt, after the step that made it, the payload (or the row's
    device words) of every chunk or row ``route``'s predicate picks."""
    algorithm, _static, device_pack, _chunks, _finals, pick = ROUTES[route]
    lib = native.get_lib()
    if algorithm == "lz4" and device_pack:
        real_pack = dispatch.lz4_pack_device

        def pack(data, lengths, *, n):
            words, nbytes, ok = real_pack(data, lengths, n=n)
            words = words.clone()
            for i, ln in enumerate(lengths.tolist()):
                if ok[i] and pick(data[i, :ln].numpy().tobytes()):
                    words[i, 1] ^= 0xFF
            return words, nbytes, ok
        monkeypatch.setattr(dispatch, "lz4_pack_device", pack)
    elif device_pack:
        for name in ("finish_stream", "finish_stream_dynamic"):
            def finish(*args, _real=getattr(dispatch, name), **kw):
                out = _real(*args, **kw)
                if pick(zlib.decompressobj(-15).decompress(out)):
                    return _flip(out)
                return out
            monkeypatch.setattr(dispatch, name, finish)
    else:
        name = {"deflate": "deflate_pack", "lz4": "lz4_pack",
                "lz4s": "lz4s_pack"}[algorithm]

        def packer(src, *args, _real=getattr(lib, name), **kw):
            out = _real(src, *args, **kw)
            return _flip(out) if pick(bytes(src)) else out
        monkeypatch.setattr(lib, name, packer)


def _fallbacks() -> int:
    return sum(c.get("cnv_fallback", 0)
               for c in debug.get_counters().snapshot().values())


def _decodes(algorithm, chunks, results) -> None:
    for chunk, (payload, crc) in zip(chunks, results):
        assert crc == zlib.crc32(chunk)
        if algorithm == "deflate":
            assert zlib.decompressobj(-15).decompress(payload) == chunk
        elif algorithm == "lz4":
            assert native.get_lib().lz4_decompress_block(
                payload, len(chunk)) == chunk


def _jax_lz4_device_fallback(chunk: bytes, payload: bytes) -> bytes:
    """The JAX package's LZ4 device-pack verify
    (``TpuEngine._compress_lz4_device``'s finish, dispatch.py:704-711),
    on the reference's native library."""
    try:
        if jnative.lib.lz4_decompress_block(payload, len(chunk)) == chunk:
            return payload
    except Exception:  # noqa: BLE001
        pass
    return jnative.lib.lz4_compress_block(chunk)


_CLEAN = {}


def _clean(route):
    """The route's ``cnv=False`` output on one device, computed once."""
    if route not in _CLEAN:
        _CLEAN[route] = _compress(route, False)
    return _CLEAN[route]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cnv_without_a_fault_keeps_the_bytes(monkeypatch, route):
    algorithm, _s, device_pack, chunks, _f, _p = ROUTES[route]
    _hold(monkeypatch, device_pack)
    before = _fallbacks()
    got = _compress(route, True)
    assert got == _clean(route)
    assert _fallbacks() == before
    _decodes(algorithm, chunks, got)


@pytest.mark.parametrize("devices", [2, 3])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cnv_over_devices_keeps_the_one_device_bytes(monkeypatch, route,
                                                     devices):
    _hold(monkeypatch, ROUTES[route][2])
    assert _compress(route, True, devices) == _clean(route)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cnv_recovers_each_corrupted_chunk(monkeypatch, route):
    algorithm, _s, device_pack, chunks, finals, _p = ROUTES[route]
    finals = finals or [True] * len(chunks)
    _hold(monkeypatch, device_pack)
    clean = _clean(route)
    _inject(monkeypatch, route)
    bad = _compress(route, False)
    hit = {i for i, (b, c) in enumerate(zip(bad, clean)) if b != c}
    assert hit == CORRUPTED[route], "the fault did not reach the output"
    before = _fallbacks()
    got = _compress(route, True)
    for i, chunk in enumerate(chunks):
        assert got[i][1] == clean[i][1]
        if i not in hit:
            assert got[i] == clean[i]
        elif algorithm == "lz4s":           # LZ4s passes unverified
            assert got[i] == bad[i]
        elif route == "lz4-device-pack":
            assert got[i][0] == _jax_lz4_device_fallback(chunk, bad[i][0])
        else:
            assert got[i][0] == TpuEngine._verify_or_fallback(
                None, chunk, bad[i][0], algorithm, finals[i], 1, 3)
    if algorithm == "lz4s":
        assert _fallbacks() == before
        return
    assert _fallbacks() == before + len(hit)
    _decodes(algorithm, chunks, got)
    # over three devices the same faults give the one-device bytes
    assert _compress(route, True, 3) == got


def test_lz4_fallbacks_differ_by_window(monkeypatch):
    """The chunk that repeats at distance 40,000 takes the host engine's
    32 KiB window on the LZ4 token path and the block coder's 65535 on
    the LZ4 device pack, as the JAX package's two fallbacks do."""
    chunk = LZ4[4]
    lib = native.get_lib()
    near = host_engine.compress_chunks([chunk], level=1, algorithm="lz4",
                                       sw_coder="zlib")[0][0]
    far = lib.lz4_compress_block(chunk)
    assert near != far and len(far) < len(near)
    assert dispatch.verify_or_fallback(chunk, b"\x00", "lz4", True, 1,
                                       3) == near
    assert dispatch.verify_lz4_device(chunk, b"\x00") == far
    assert near == TpuEngine._verify_or_fallback(None, chunk, b"\x00", "lz4",
                                                 True, 1, 3)


@pytest.mark.parametrize("algorithm", ["deflate", "lz4", "lz4s"])
@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("level", [1, 4, 6, 9])
def test_host_engine_zlib_coder_matches_jax(algorithm, final, level):
    chunks = DEFLATE[:3] + [LZ4[4][:30000]]
    for batch in (chunks, chunks[:1]):
        kw = dict(level=level, algorithm=algorithm,
                  final_flags=[final] * len(batch), sw_coder="zlib")
        got = host_engine.compress_chunks(batch, **kw)
        want = jhost_engine.compress_chunks(batch, **kw)
        assert [(bytes(p), int(c)) for p, c in got] == \
            [(bytes(p), int(c)) for p, c in want]
        if algorithm == "deflate":
            for c, (p, _crc) in zip(batch, got):
                assert zlib.decompressobj(-15).decompress(p) == c
    # None and "native" keep the default coder
    kw = dict(level=level, algorithm=algorithm, final_flags=[final] * 4)
    assert host_engine.compress_chunks(chunks, **kw) == \
        host_engine.compress_chunks(chunks, sw_coder="native", **kw)


def test_host_engine_rejects_an_unknown_coder():
    with pytest.raises(ValueError):
        host_engine.compress_chunks([b"x"], level=1, sw_coder="lzma")


def test_counters_dump_and_timer(capsys, monkeypatch):
    c = debug.Counters()
    c.dump()
    assert capsys.readouterr().err == ""
    c.bump("cnv_fallback", 1, 100)
    import threading
    t = threading.Thread(target=c.bump, args=("cnv_fallback", 2, 50))
    t.start()
    t.join()
    c.dump()
    assert capsys.readouterr().err == (
        "[qztpu_torch] service counters: cnv_fallback=3, "
        "cnv_fallback_bytes=150\n")
    monkeypatch.setattr(debug, "DEBUG", True)
    import time
    with debug.Timer("block") as tm:
        time.sleep(0.02)
    assert 0.02 <= tm.elapsed < 1.0
    assert capsys.readouterr().err.startswith("[qztpu_torch] timer block: ")


def test_counters_dump_at_exit_under_qztpu_debug():
    code = ("from qatzip_tpu_torch.utils.debug import get_counters; "
            "get_counters().bump('hw_compress', 2, 10)")
    env = dict(os.environ, QZTPU_DEBUG="1")
    quiet = {k: v for k, v in env.items() if k != "QZTPU_DEBUG"}
    on, off = (subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                                env=e, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
               for e in (env, quiet))
    err_on = on.communicate(timeout=120)[1]
    err_off = off.communicate(timeout=120)[1]
    assert on.returncode == 0 and off.returncode == 0, (err_on, err_off)
    assert ("[qztpu_torch] service counters: hw_compress=2, "
            "hw_compress_bytes=10") in err_on
    assert "service counters" not in err_off
