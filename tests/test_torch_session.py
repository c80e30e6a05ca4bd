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
each route once for the whole file, except the row split of 128 KiB
chunks into 64 KiB rows (one compile each for the token path and the
static device pack). The session API (legacy setup, QZ_AUTO_SELECT_BEST,
teardown, decompress bounds, the ``qz_*`` return codes) and the size
bounds are held against ``qatzip_tpu.session`` and ``qatzip_tpu.bounds``
on software-path requests and the 16 KiB shapes.
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

from qatzip_tpu import bounds as jbounds
from qatzip_tpu import codec as jcodec
from qatzip_tpu import constants as jconst
from qatzip_tpu import params as jparams
from qatzip_tpu import session as jsession
from qatzip_tpu.parallel.dispatch import TpuEngine
import qatzip_tpu_torch as qz
from qatzip_tpu_torch import bounds, convert
from qatzip_tpu_torch.constants import (DataFormat, HuffmanHdr, QZ_DATA_ERROR,
                                        QZ_NOSW_NO_HW, QZ_PARAMS)
from qatzip_tpu_torch.parallel.dispatch import DEV_MAX, CudaEngine

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
          fmt=DataFormat.DEFLATE_GZIP_EXT, device_pack="0", level=1, hw=HW,
          sw_backup=1):
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
    jp.common.hw_buff_sz = hw
    jp.common.comp_lvl = level
    jp.common.sw_backup = sw_backup
    jp.data_fmt = type(jp.data_fmt)(int(fmt))
    if static:
        jp.huffman_hdr = type(jp.huffman_hdr)(int(HuffmanHdr.STATIC_HDR))
    want, want_crc = jcodec.compress_buffer(
        data, algorithm="deflate", data_fmt=jp.data_fmt,
        level=jp.common.comp_lvl, hw_buff_sz=hw, engine=jax_engine,
        sw_backup=sw_backup, input_sz_thrshold=jp.common.input_sz_thrshold,
        huffman_static=static)
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


def _inflate_raw(blob):
    d = zlib.decompressobj(-15)
    out = d.decompress(blob) + d.flush()
    assert d.eof
    return out


@pytest.mark.parametrize("static,device_pack,fmt", [
    (False, "0", DataFormat.DEFLATE_GZIP_EXT),
    (True, None, DataFormat.DEFLATE_RAW)],
    ids=["token", "static-device-pack-raw"])
def test_row_split_matches_jax_codec(data, jax_engine, monkeypatch, static,
                                     device_pack, fmt):
    """128 KiB chunks go through the tokenizer as 64 KiB rows, only a
    chunk's last row final, the row payloads joined: the JAX engine's
    split on the token path and the static device pack."""
    want, got, sess = _both(data[:140000], jax_engine, monkeypatch,
                            static=static, fmt=fmt, device_pack=device_pack,
                            hw=131072)
    assert got == want
    if fmt == DataFormat.DEFLATE_RAW:
        assert _inflate_raw(got) == data[:140000]
    else:
        assert _gunzip(got) == data[:140000]
        assert sess.decompress(got) == data[:140000]


def test_unported_paths_raise(data, monkeypatch):
    """Nothing on the compress path is refused any more: deflate chunks
    over 64 KiB, on the routes the JAX comparison above leaves out (the
    dynamic device pack; level 6 on the token path and both device
    packs), give each chunk's rows compressed with per-row final flags
    and joined, and stock zlib decodes the members; LZ4 chunks over 64
    KiB go to the host coder whole, and an LZ4 session caps its chunks
    at 64 KiB."""
    chunks = [data[:140000], data[140000:]]
    for static, level, device_pack in ((False, 1, True), (False, 6, False),
                                       (True, 6, True), (False, 6, True)):
        monkeypatch.setattr(CudaEngine, "packs_on_device",
                            lambda self, st, algorithm="deflate",
                            dp=device_pack: dp)
        eng = CudaEngine("cpu")
        kw = dict(level=level, huffman_static=static)
        got = eng.compress_chunks(chunks, final_flags=[False, True], **kw)
        for (payload, crc), chunk, final in zip(got, chunks, (False, True)):
            rows = [chunk[o:o + DEV_MAX] for o in range(0, len(chunk),
                                                        DEV_MAX)]
            flags = [False] * (len(rows) - 1) + [final]
            assert payload == b"".join(p for p, _ in eng.compress_chunks(
                rows, final_flags=flags, **kw))
            assert crc == zlib.crc32(chunk)
        assert _inflate_raw(b"".join(p for p, _ in got)) == data
        sess = qz.QzSession(device="cpu")
        p = qz.SessionParamsDeflate()
        p.common.hw_buff_sz = 131072
        p.common.comp_lvl = level
        p.huffman_hdr = (HuffmanHdr.STATIC_HDR if static
                         else HuffmanHdr.DYNAMIC_HDR)
        assert sess.setup_deflate(p) == qz.QZ_OK
        assert _gunzip(sess.compress(data)) == data
    monkeypatch.undo()
    (payload, crc), = CudaEngine("cpu").compress_chunks(
        [data[:140000]], level=1, algorithm="lz4")
    from qatzip_tpu_torch import native
    assert native.get_lib().lz4_decompress_block(payload, 140000) == \
        data[:140000]
    lz = qz.SessionParamsLZ4()
    lz.common.hw_buff_sz = 131072
    sess = qz.QzSession(device="cpu")
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


# ---------------------------------------------------------------------------
# the session API against qatzip_tpu.session
# ---------------------------------------------------------------------------

# every request below this compresses in software on both sides
SW_ONLY = 1 << 20


def _pair(setup, kind, **fields):
    """(JAX session, port session on the CPU) and the two setup rcs of
    ``setup`` ("setup", "setup_deflate", ...) with params of ``kind``
    built by each package from ``fields`` (see ``_params``)."""
    js, ps = jsession.QzSession(), qz.QzSession(device="cpu")
    jp = _params(jparams, jconst, kind, **fields)
    pp = _params(qz, qz, kind, **fields)
    return js, ps, getattr(js, setup)(jp), getattr(ps, setup)(pp)


def _params(pmod, cmod, kind, **fields):
    """Params of ``kind`` from ``pmod`` with the common fields set from
    ``fields`` (enums given as ints and converted with ``cmod``)."""
    if kind == "legacy":
        p = pmod.SessionParams()
        target = p
    else:
        p = {"deflate": pmod.SessionParamsDeflate, "lz4": pmod.SessionParamsLZ4,
             "lz4s": pmod.SessionParamsLZ4S}[kind]()
        target = p.common
    for k, v in fields.items():
        if k == "data_fmt":
            p.data_fmt = cmod.DataFormat(v)
        elif k == "huffman_hdr":
            p.huffman_hdr = cmod.HuffmanHdr(v)
        else:
            setattr(target, k, v)
    return p


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_auto_select_best_matches_jax_codec(data, jax_engine, monkeypatch,
                                            static):
    """QZ_AUTO_SELECT_BEST keeps the smaller of the engine's output and
    the software coder's, per request: the same pick and bytes as the JAX
    package (a static session's engine output loses to zlib's dynamic
    blocks on this data, a dynamic one's wins)."""
    want, got, sess = _both(data, jax_engine, monkeypatch, static=static,
                            device_pack=None if static else "0",
                            sw_backup=qz.QZ_AUTO_SELECT_BEST)
    assert got == want
    assert _gunzip(got) == data
    from qatzip_tpu_torch.sw.codec import sw_compress
    sw_out, sw_crc = sw_compress(data, DataFormat.DEFLATE_GZIP_EXT, 1, HW)
    assert sw_crc == zlib.crc32(data)
    assert (got == sw_out) == static
    from qatzip_tpu.sw.codec import sw_compress as jsw
    assert jsw(data, jconst.DataFormat.DEFLATE_GZIP_EXT, 1, HW)[0] == sw_out


@pytest.mark.parametrize("level", [1, 9])
def test_legacy_setup_matches_jax(data, level):
    """The legacy setup (qzSetupSession) with its combined params; level
    9 sends even a large request to software zlib."""
    js, ps, jrc, prc = _pair("setup", "legacy", comp_lvl=level,
                             hw_buff_sz=HW)
    assert jrc == prc == qz.QZ_OK
    blob = data[:500] if level == 1 else data[:40000]
    want, got = js.compress(blob), ps.compress(blob)
    assert got == want and _gunzip(got) == blob
    assert (ps.total_in, ps.total_out) == (js.total_in, js.total_out)
    assert ps.decompress(got) == blob
    assert ps.common.comp_lvl == level
    bad_j, bad_p, jrc, prc = _pair("setup", "legacy", comp_lvl=10)
    assert jrc == prc == QZ_PARAMS


def test_defaults_match_jax():
    for kind in ("deflate", "lz4", "lz4s", "legacy"):
        assert (dataclasses.asdict(qz.get_defaults(kind))
                == dataclasses.asdict(jparams.get_defaults(kind)))
    p = qz.get_defaults("legacy")
    p.comp_lvl = 10
    assert qz.set_defaults(p, "legacy") == QZ_PARAMS
    p.comp_lvl = 3
    try:
        assert qz.set_defaults(p, "legacy") == qz.QZ_OK
        assert qz.get_defaults("legacy").comp_lvl == 3
        sess = qz.QzSession(device="cpu")
        assert sess.setup() == qz.QZ_OK and sess.common.comp_lvl == 3
    finally:
        qz.set_defaults(qz.SessionParams(), "legacy")


def test_teardown_and_close_match_jax(data):
    """After teardown a request sets up the deflate defaults again; rcs
    and bytes as the JAX package's."""
    js, ps, jrc, prc = _pair("setup_lz4", "lz4")
    assert jrc == prc == qz.QZ_OK
    blob = data[:700]
    assert ps.compress(blob) == js.compress(blob)
    assert ps.teardown() == js.teardown() == qz.QZ_OK
    assert ps.state == qz.SessionState.QZ_NONE and ps.params is None
    assert ps.compress(blob) == js.compress(blob)       # lazy defaults
    assert ps.state.name == js.state.name == "QZ_SETUP_HW"
    assert ps.close() == js.close() == qz.QZ_OK
    assert qz.qz_close(ps) == jsession.qz_close(js) == qz.QZ_OK


@pytest.mark.parametrize("fmt", [DataFormat.DEFLATE_GZIP_EXT,
                                 DataFormat.DEFLATE_GZIP,
                                 DataFormat.DEFLATE_4B, DataFormat.ZLIB],
                         ids=lambda f: f.name)
def test_decompress_max_out_and_consumed_match_jax(data, fmt):
    """decompress(max_out=, return_consumed=) on several members, a cut
    trailing member too: the same output and consumed count."""
    js, ps, jrc, prc = _pair("setup_deflate", "deflate", hw_buff_sz=1024,
                             input_sz_thrshold=SW_ONLY, data_fmt=int(fmt))
    assert jrc == prc == qz.QZ_OK
    blob = ps.compress(data[:5000])
    assert blob == js.compress(data[:5000])
    for src in (blob, blob + blob[:40]):
        for max_out in (None, 2500, 1024, 1):
            want = js.decompress(src, max_out=max_out, return_consumed=True)
            got = ps.decompress(src, max_out=max_out, return_consumed=True)
            assert got == want, (max_out, len(src))
    assert (ps.total_in, ps.total_out) == (js.total_in, js.total_out)
    assert ps.decompress(blob) == data[:5000]


def test_qz_functions_match_jax(data):
    """The rc-returning wrappers: setup rcs, qz_compress into buffers that
    fit and that do not (QZ_BUF_ERROR with whole members consumed),
    qz_compress_crc, qz_decompress, the bounds, the status keys."""
    js, ps = jsession.QzSession(), qz.QzSession(device="cpu")
    qz.qz_init(ps)
    jsession.qz_init(js)
    assert qz.qz_init(ps) == jsession.qz_init(js) == qz.QZ_DUPLICATE
    for name, args in (("qz_setup_session", ("legacy",)),
                       ("qz_setup_session_lz4", ("lz4",)),
                       ("qz_setup_session_lz4s", ("lz4s",)),
                       ("qz_setup_session_deflate",
                        ("deflate", dict(comp_lvl=0))),
                       ("qz_setup_session_deflate",
                        ("deflate", dict(hw_buff_sz=1024,
                                         input_sz_thrshold=SW_ONLY)))):
        kind, fields = args[0], (args[1] if len(args) > 1 else {})
        assert (getattr(qz, name)(ps, _params(qz, qz, kind, **fields))
                == getattr(jsession, name)(js, _params(jparams, jconst, kind,
                                                       **fields)))
    src = data[:5000]
    assert qz.qz_compress(ps, src) == jsession.qz_compress(js, src)
    full = ps.compress(src)
    js.compress(src)
    for size in (len(full), len(full) - 1, 1500, 10):
        jd, pd = bytearray(size), bytearray(size)
        got, want = qz.qz_compress(ps, src, pd), jsession.qz_compress(js, src,
                                                                      jd)
        assert got == want and pd == jd, size
        assert (ps.total_in, ps.total_out) == (js.total_in, js.total_out)
        if size == 1500:                  # whole members that fit
            assert got[0] == qz.QZ_BUF_ERROR and got[1] % 1024 == 0
            assert 0 < got[2] <= size
    assert qz.qz_compress_crc(ps, src) == jsession.qz_compress_crc(js, src)
    for size in (None, 5000, 4999):
        jd = pd = None
        if size is not None:
            jd, pd = bytearray(size), bytearray(size)
        assert (qz.qz_decompress(ps, full, pd)
                == jsession.qz_decompress(js, full, jd))
        assert pd == jd
    assert (qz.qz_decompress(ps, b"junk, not a member")
            == jsession.qz_decompress(js, b"junk, not a member"))
    for n in (0, 1, 5000, 10 ** 6):
        assert (qz.qz_max_compressed_length(n, ps)
                == jsession.qz_max_compressed_length(n, js))
        assert (qz.qz_max_compressed_length(n)
                == jsession.qz_max_compressed_length(n))
    status = qz.qz_get_status(ps)
    assert status.keys() == jsession.qz_get_status(js).keys()
    assert status["session_state"] == "QZ_SETUP_HW" and status["initialized"]
    comps = qz.qz_get_software_component_version_list()
    assert qz.qz_get_software_component_count() == len(comps)
    assert {"qatzip_tpu_torch", "zlib", "torch", "cuda"} <= {
        c["name"] for c in comps}


@pytest.mark.parametrize("algorithm", ["deflate", "lz4", "lz4s", "zstd"])
def test_bounds_match_jax(algorithm):
    for fmt in DataFormat:
        for hw in (1024, 65536, 524288):
            for n in (0, 1, 1000, 65536, 10 ** 6 + 7):
                for gen4 in (False, True):
                    kw = dict(algorithm=algorithm, hw_buff_sz=hw, gen4=gen4)
                    assert bounds.max_compressed_length(
                        n, data_fmt=fmt, **kw) == jbounds.max_compressed_length(
                        n, data_fmt=jconst.DataFormat(int(fmt)), **kw)
