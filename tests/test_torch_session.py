"""The port's session against the JAX package's codec, on the CPU.

``qatzip_tpu_torch.QzSession(device="cpu")`` (plain versions of the
kernels, the port's host packer build) must give the same bytes as
``qatzip_tpu.codec.compress_buffer`` on a JAX-CPU ``TpuEngine`` with the
same knobs, carried across by ``params_from_reference``: dynamic and
static Huffman, every deflate framing, on the token path (host packer)
and on the full-device pack: each side's own route, or the route that
``QZTPU_DEVICE_PACK`` gives the JAX side with the port's engine held on
the same one; at level 1 and at level 6 (the full-row search). Stock
zlib must decode the output and the port's ``decompress`` must give the
input back, for every framing. All chunks are 16 KiB, so JAX compiles
each route once for the whole file.
"""

import ctypes
import dataclasses
import gc
import os
import re
import zlib

import numpy as np
import pytest
import torch

import jax

from qatzip_tpu import codec as jcodec
from qatzip_tpu import params as jparams
from qatzip_tpu.parallel.dispatch import TpuEngine
import qatzip_tpu_torch as qz
from qatzip_tpu_torch import convert
from qatzip_tpu_torch.constants import (DataFormat, HuffmanHdr, QZ_DATA_ERROR,
                                        QZ_NOSW_NO_HW, QZ_NOT_SUPPORTED,
                                        QZ_PARAMS)
from qatzip_tpu_torch.parallel.dispatch import CudaEngine

from tests.corpus import make_corpus


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


@pytest.fixture(scope="module")
def data():
    c = make_corpus()
    return (c["text"][:70000] + c["json"][:60000] + c["binary"][:40000]
            + c["runs"][:20000] + c["noise"][:10000])


@pytest.fixture(scope="module")
def jax_engine():
    return TpuEngine([jax.devices("cpu")[0]], "deflate")


def _both(data, jax_engine, monkeypatch, *, static=False,
          fmt=DataFormat.DEFLATE_GZIP_EXT, device_pack="0", level=1):
    """(JAX bytes, port bytes, port session) for one request: the JAX side
    routed by QZTPU_DEVICE_PACK, the port's engine held on the same route
    (None: both sides' own choice)."""
    if device_pack is None:
        monkeypatch.delenv("QZTPU_DEVICE_PACK", raising=False)
    else:
        monkeypatch.setenv("QZTPU_DEVICE_PACK", device_pack)
        monkeypatch.setattr(CudaEngine, "packs_on_device",
                            lambda self, static, algorithm="deflate":
                            device_pack == "1")
    jp = jparams.SessionParamsDeflate()
    jp.common.hw_buff_sz = HW
    jp.common.comp_lvl = level
    jp.data_fmt = type(jp.data_fmt)(int(fmt))
    if static:
        jp.huffman_hdr = type(jp.huffman_hdr)(int(HuffmanHdr.STATIC_HDR))
    want, want_crc = jcodec.compress_buffer(
        data, algorithm="deflate", data_fmt=jp.data_fmt,
        level=jp.common.comp_lvl, hw_buff_sz=HW, engine=jax_engine,
        input_sz_thrshold=jp.common.input_sz_thrshold, huffman_static=static)
    sess = qz.QzSession(device="cpu")
    assert sess.setup_deflate(
        convert.params_from_reference(dataclasses.asdict(jp))) == qz.QZ_OK
    got, crc = sess.compress(data, with_crc=True)
    assert crc == want_crc == zlib.crc32(data)
    return want, got, sess


def _gunzip(blob):
    out, rest = b"", blob
    while rest:
        d = zlib.decompressobj(31)
        out += d.decompress(rest) + d.flush()
        assert d.eof
        rest = d.unused_data
    return out


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_gzipext_matches_jax_codec(data, jax_engine, monkeypatch, static):
    want, got, sess = _both(data, jax_engine, monkeypatch, static=static)
    assert got == want
    assert _gunzip(got) == data
    assert sess.decompress(got) == data
    assert len(got) < len(data) / 2


@pytest.mark.parametrize("static,device_pack,fmt", [
    (True, None, DataFormat.DEFLATE_GZIP_EXT),
    (True, None, DataFormat.DEFLATE_RAW),
    (False, "1", DataFormat.DEFLATE_GZIP_EXT),
    (False, "1", DataFormat.DEFLATE_RAW)],
    ids=["static-default", "static-default-raw", "dynamic-device-pack",
         "dynamic-device-pack-raw"])
def test_device_pack_matches_jax_codec(data, jax_engine, monkeypatch, static,
                                       device_pack, fmt):
    """The full-device DEFLATE pack: static sessions take it by default,
    dynamic ones held on it (their default on a CUDA device); raw output
    joins non-final chunks with the full-flush sync."""
    want, got, sess = _both(data, jax_engine, monkeypatch, static=static,
                            fmt=fmt, device_pack=device_pack)
    assert got == want
    if fmt == DataFormat.DEFLATE_RAW:
        assert zlib.decompress(got, -15) == data
    else:
        assert _gunzip(got) == data
        assert sess.decompress(got) == data
    assert len(got) < len(data) / 2


@pytest.mark.parametrize("level", [6, 8])
@pytest.mark.parametrize("static,device_pack", [
    (False, "0"), (True, None), (False, "1")],
    ids=["token", "static-device-pack", "dynamic-device-pack"])
def test_levels_6_to_8_match_jax_codec(data, jax_engine, monkeypatch, static,
                                       device_pack, level):
    """Levels >= 6 search whole rows (the full-row search, ctx 4, probes
    6) on the token path and on both device packs."""
    want, got, sess = _both(data, jax_engine, monkeypatch, static=static,
                            device_pack=device_pack, level=level)
    assert got == want
    assert _gunzip(got) == data
    assert sess.decompress(got) == data


@pytest.mark.parametrize("device,static,algorithm,on_device", [
    ("cpu", True, "deflate", True), ("cpu", False, "deflate", False),
    ("cuda", True, "deflate", True), ("cuda", False, "deflate", True),
    ("cpu", False, "lz4", False), ("cuda", False, "lz4", True),
    ("cpu", False, "lz4s", False), ("cuda", False, "lz4s", False)])
def test_engine_route(monkeypatch, device, static, algorithm, on_device):
    """Static deflate sessions pack on the device everywhere; dynamic
    deflate and LZ4 sessions on a CUDA device only; LZ4s sessions never.
    The JAX package's QZTPU_DEVICE_PACK is not read."""
    monkeypatch.setenv("QZTPU_DEVICE_PACK", "0" if on_device else "1")
    assert CudaEngine(device).packs_on_device(static, algorithm) is on_device


@pytest.mark.parametrize("fmt", [DataFormat.DEFLATE_GZIP,
                                 DataFormat.DEFLATE_RAW, DataFormat.ZLIB,
                                 DataFormat.DEFLATE_4B],
                         ids=lambda f: f.name)
def test_other_framings_match_jax_codec(data, jax_engine, monkeypatch, fmt):
    want, got, sess = _both(data, jax_engine, monkeypatch, fmt=fmt)
    assert got == want
    assert sess.decompress(got) == data
    if fmt == DataFormat.DEFLATE_GZIP:
        assert _gunzip(got) == data
    elif fmt == DataFormat.DEFLATE_RAW:
        assert zlib.decompress(got, -15) == data
    elif fmt == DataFormat.ZLIB:
        assert zlib.decompress(got) == data


@pytest.mark.parametrize("size", [0, 500])
def test_small_requests_take_the_software_gate(data, jax_engine, monkeypatch,
                                               size):
    want, got, sess = _both(data[:size], jax_engine, monkeypatch)
    assert got == want
    assert sess.decompress(got) == data[:size]
    if size == 0:
        assert len(got) == sess.max_compressed_length(0) == 34


def test_max_compressed_length_holds(data):
    sess = qz.QzSession(device="cpu")
    sess.setup_deflate()
    noise = np.random.default_rng(1).integers(0, 256, 200000, np.uint8)
    for blob in (data, noise.tobytes()):
        assert len(sess.compress(blob)) <= sess.max_compressed_length(
            len(blob))


def test_params_from_reference_round_trips_every_field():
    jp = jparams.SessionParamsDeflate()
    jp.common.comp_lvl = 4
    jp.common.hw_buff_sz = 32768
    jp.common.direction = type(jp.common.direction)(1)
    jp.data_fmt = type(jp.data_fmt)(int(DataFormat.DEFLATE_GZIP))
    p = convert.params_from_reference(dataclasses.asdict(jp))
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert isinstance(p.common.direction, qz.Direction)
    with pytest.raises(ValueError):
        convert.params_from_reference({**dataclasses.asdict(jp), "x": 1})


def test_setup_rejects_bad_params():
    sess = qz.QzSession(device="cpu")
    p = qz.SessionParamsDeflate()
    p.common.comp_lvl = 10
    assert sess.setup_deflate(p) == QZ_PARAMS
    p.common.comp_lvl = 1
    p.common.hw_buff_sz = 3000
    assert sess.setup_deflate(p) == QZ_PARAMS


def test_unported_paths_raise(data):
    """What is still unported: deflate chunks over 64 KiB (the device row
    split), on the token path, both device packs and at level 6; an LZ4
    session caps its chunks at 64 KiB and takes them."""
    sess = qz.QzSession(device="cpu")
    p = qz.SessionParamsDeflate()
    p.common.hw_buff_sz = 131072
    for static, level in ((False, 1), (True, 1), (True, 6), (False, 6)):
        p.huffman_hdr = (HuffmanHdr.STATIC_HDR if static
                         else HuffmanHdr.DYNAMIC_HDR)
        p.common.comp_lvl = level
        sess.setup_deflate(p)
        with pytest.raises(qz.QzError) as e:
            sess.compress(data)
        assert e.value.rc == QZ_NOT_SUPPORTED and "64 KiB" in str(e.value)
    lz = qz.SessionParamsLZ4()
    lz.common.hw_buff_sz = 131072
    sess.setup_lz4(lz)
    assert sess.decompress(sess.compress(data)) == data


def test_decompress_rejects_corrupt_input(data):
    sess = qz.QzSession(device="cpu")
    sess.setup_deflate()
    blob = bytearray(sess.compress(data[:50000]))
    blob[-6] ^= 0xFF                       # a footer crc byte
    with pytest.raises(qz.QzError) as e:
        sess.decompress(bytes(blob))
    assert e.value.rc == QZ_DATA_ERROR
    with pytest.raises(qz.QzError) as e:
        sess.decompress(b"not a gzip member at all, not at all")
    assert e.value.rc == QZ_DATA_ERROR


def test_direction_is_enforced():
    sess = qz.QzSession(device="cpu")
    p = qz.SessionParamsDeflate()
    p.common.direction = qz.Direction.DIR_DECOMPRESS
    sess.setup_deflate(p)
    with pytest.raises(qz.QzError):
        sess.compress(b"x" * 2000)


def test_cuda_session_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(qz.QzError) as e:
        qz.QzSession(device="cuda")
    assert e.value.rc == QZ_NOSW_NO_HW
    with pytest.raises(qz.QzError) as e:
        qz.QzSession()                     # the default device is the GPU
    assert e.value.rc == QZ_NOSW_NO_HW


def test_port_never_imports_jax_or_the_jax_package():
    pkg = os.path.dirname(qz.__file__)
    banned = re.compile(r"^\s*(import|from)\s+(jax\b|qatzip_tpu\b(?!_torch))",
                        re.M)
    srcs = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
            if f.endswith(".py")]
    assert len(srcs) >= 24
    for path in srcs:
        with open(path) as f:
            src = f.read()
        assert not banned.search(src), path
        assert not re.search(r"\bqatzip_tpu\b(?!_torch)\s*(\.|import)",
                             re.sub(r"#.*|\"\"\"[\s\S]*?\"\"\"", "", src)), path
    smoke = os.path.join(os.path.dirname(pkg), "chip_smoke.py")
    with open(smoke) as f:
        assert not banned.search(f.read())


@pytest.mark.parametrize("fmt", [DataFormat.DEFLATE_GZIP_EXT,
                                 DataFormat.DEFLATE_GZIP,
                                 DataFormat.DEFLATE_4B],
                         ids=lambda f: f.name)
def test_scan_members_matches_jax(data, fmt):
    from qatzip_tpu.formats import scan_members as jax_scan
    from qatzip_tpu_torch.formats.gzip_format import scan_members
    sess = qz.QzSession(device="cpu")
    p = qz.SessionParamsDeflate()
    p.common.hw_buff_sz = HW
    p.data_fmt = fmt
    sess.setup_deflate(p)
    blob = sess.compress(data)
    got = [dataclasses.astuple(m) for m in scan_members(blob, fmt)]
    jfmt = type(jparams.SessionParamsDeflate().data_fmt)(int(fmt))
    want = [dataclasses.astuple(m) for m in jax_scan(blob, jfmt)]
    assert got == want and len(got) == -(-len(data) // HW)
