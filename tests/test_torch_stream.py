"""The port's buffer pool, settings file, streams, batches and async
engine against the JAX package's, on the CPU.

The same inputs (``tests/corpus.py``) go through ``qatzip_tpu`` and
``qatzip_tpu_torch`` (``device="cpu"``) and must give the same bytes and
return codes. So that no JAX shape is compiled, the JAX side always takes
its software route: ``input_sz_thrshold`` above every request (SW), or
the legacy level-9 setup, which batches through the host engine. On the
engine route the port is held to its own ``compress`` of the same units
and requests, which ``test_torch_session.py`` holds to the JAX package.
"""

import ctypes
import dataclasses
import gc
import gzip
import threading
import time
import zlib

import pytest
import torch

import jax

import qatzip_tpu as jqz
from qatzip_tpu import async_engine as jasync
from qatzip_tpu import config as jconfig
from qatzip_tpu import constants as jconst
from qatzip_tpu import memory as jmemory
from qatzip_tpu import params as jparams
from qatzip_tpu import session as jsession
import qatzip_tpu_torch as qz
from qatzip_tpu_torch import async_engine, codec, config, memory
from qatzip_tpu_torch.constants import (DataFormat, Direction, MemType,
                                        QZ_DATA_ERROR, QZ_FAIL, QZ_NOSW_NO_HW,
                                        QZ_OK, QZ_PARAMS)
from qatzip_tpu_torch.parallel.dispatch import CudaEngine, row_width

from tests.corpus import make_corpus
from tests.reference_native import (one_intra_op_thread,
                                     require_reference_native)


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Load the JAX package's native library first (the reference;
    tests/reference_native.py), and give what this module held back to the
    system when it ends (see test_torch_session.py)."""
    require_reference_native()
    with one_intra_op_thread():
        yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


# every request below this compresses in software on both sides
SW = 1 << 30
HW = 16384


@pytest.fixture(scope="module")
def corpus():
    return make_corpus()


def _params(pmod, cmod, kind, **fields):
    """Params of ``kind`` from ``pmod``: the common fields set from
    ``fields``, ``data_fmt`` / ``huffman_hdr`` given as ints."""
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


_SETUP = {"deflate": "setup_deflate", "lz4": "setup_lz4", "lz4s": "setup_lz4s",
          "legacy": "setup"}


def _pair(kind="deflate", **fields):
    """A JAX session and a port session on the CPU, set up alike."""
    js, ps = jsession.QzSession(), qz.QzSession(device="cpu")
    assert getattr(js, _SETUP[kind])(
        _params(jparams, jconst, kind, **fields)) == QZ_OK
    assert getattr(ps, _SETUP[kind])(_params(qz, qz, kind, **fields)) == QZ_OK
    return js, ps


def _feed(strm, data, piece, op="compress", **kw):
    out = bytearray()
    fn = getattr(strm, op)
    for off in range(0, len(data), piece):
        out += fn(data[off:off + piece], **kw)
    out += fn(b"", last=True, **kw)
    return bytes(out)


def _gunzip(blob):
    out, rest = b"", blob
    while rest:
        d = zlib.decompressobj(31)
        out += d.decompress(rest) + d.flush()
        assert d.eof
        rest = d.unused_data
    return out


# ---------------------------------------------------------------------------
# memory.py
# ---------------------------------------------------------------------------

def _pool_trace(mod, const):
    """One sequence of pool calls and what each pool says after it."""
    pool = mod.BufferPool(list_depth=2)
    a = pool.qz_malloc(4096)
    kinds = [int(pool.qz_mem_find_addr(a))]
    pool.qz_free(a)
    b = pool.qz_malloc(4096)
    kinds.append(int(pool.qz_mem_find_addr(b)))
    c = pool.qz_malloc(128, const.MemType.COMMON_MEM)
    kinds.append(int(pool.qz_mem_find_addr(c)))
    kinds.append(int(pool.qz_mem_find_addr(b"not an array")))
    pool.qz_free(c)
    pool.qz_free(None)
    bufs = [pool.qz_malloc(64) for _ in range(5)]
    for x in bufs:
        pool.qz_free(x)
    big = [pool.qz_malloc((8 << 20) + 1) for _ in range(3)]
    for x in big:
        pool.qz_free(x)
    state = (pool.alloc_count, pool.reuse_count,
             {k: len(v) for k, v in pool._free.items()}, len(pool._kind),
             kinds, b.nbytes, b.dtype.str)
    pool.destroy()
    return state, (dict(pool._free), dict(pool._kind))


def test_buffer_pool_matches_jax():
    """Reuse of PINNED buffers, COMMON ones left unregistered, the list
    depth cap, two buffers kept per bucket over 8 MiB, destroy."""
    got, want = _pool_trace(memory, qz), _pool_trace(jmemory, jconst)
    assert got == want
    state, after = got
    assert state[1] == 1 and state[2][64] == 2 and state[2][(8 << 20) + 1] == 2
    assert after == ({}, {})
    assert int(MemType.PINNED_MEM) == 1 and state[4] == [1, 1, 0, 0]
    assert memory.POOL_LIST_DEPTH == jmemory.POOL_LIST_DEPTH == 8


def test_default_pool_functions():
    a = qz.qz_malloc(2048)
    assert qz.qz_mem_find_addr(a) == MemType.PINNED_MEM
    qz.qz_free(a)
    assert qz.qz_malloc(2048) is a


# ---------------------------------------------------------------------------
# config.py and the get_defaults overlay
# ---------------------------------------------------------------------------

CONF = ("[SHIM]\nhw_buff_sz = 32768\ncomp_lvl = 4\ntile_chunks = 0x40\n"
        "strm_buff_sz = 8192\nlz4s_mini_match = 4\nsw_backup = 0\n"
        "input_sz_thrshold = junk\npolling_mode = busy\n"
        "[SMALL]\nhw_buff_sz = 16384\nmax_forks = 5\n")


def _all_defaults(pmod):
    return {k: dataclasses.asdict(pmod.get_defaults(k))
            for k in ("deflate", "lz4", "lz4s", "legacy")}


@pytest.mark.parametrize("where", ["env", "cwd", "home"])
def test_config_overlay_matches_jax(tmp_path, monkeypatch, where):
    """The settings file, found at $QZTPU_CONF, ./qztpu.conf or
    ~/.config/qztpu.conf, overlays get_defaults in both packages alike;
    QZTPU_SECTION_NAME picks the section; a value that is not a number
    is skipped."""
    monkeypatch.delenv("QZTPU_CONF", raising=False)
    monkeypatch.delenv("QZTPU_SECTION_NAME", raising=False)
    home, cwd = tmp_path / "home", tmp_path / "cwd"
    (home / ".config").mkdir(parents=True)
    cwd.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(cwd)
    plain = _all_defaults(qz)
    assert plain == _all_defaults(jparams)
    conf = {"env": tmp_path / "any.conf", "cwd": cwd / "qztpu.conf",
            "home": home / ".config" / "qztpu.conf"}[where]
    conf.write_text(CONF)
    if where == "env":
        monkeypatch.setenv("QZTPU_CONF", str(conf))
    assert config.load() == jconfig.load()
    assert config.load()["tile_chunks"] == 64
    assert "input_sz_thrshold" not in config.load()
    got = _all_defaults(qz)
    assert got == _all_defaults(jparams)
    assert got["deflate"]["common"]["hw_buff_sz"] == 32768
    assert got["legacy"]["comp_lvl"] == 4
    assert got["lz4s"]["lz4s_mini_match"] == 4
    monkeypatch.setenv("QZTPU_SECTION_NAME", "SMALL")
    got = _all_defaults(qz)
    assert got == _all_defaults(jparams)
    assert got["deflate"]["common"]["hw_buff_sz"] == 16384
    assert got["deflate"]["common"]["comp_lvl"] == 1
    monkeypatch.setenv("QZTPU_SECTION_NAME", "NONE")
    assert config.load() == jconfig.load() == {}
    assert _all_defaults(qz) == plain


def test_configured_session_matches_jax(tmp_path, monkeypatch, corpus):
    """Sessions set up from the file's defaults give the JAX package's
    bytes (both on the software route the file asks for)."""
    conf = tmp_path / "qztpu.conf"
    conf.write_text(f"[SHIM]\nhw_buff_sz = {HW}\ncomp_lvl = 3\n"
                    f"input_sz_thrshold = {SW}\n")
    monkeypatch.setenv("QZTPU_CONF", str(conf))
    monkeypatch.delenv("QZTPU_SECTION_NAME", raising=False)
    js, ps = jsession.QzSession(), qz.QzSession(device="cpu")
    assert js.setup_deflate() == ps.setup_deflate() == QZ_OK
    assert ps.common.hw_buff_sz == HW and ps.common.comp_lvl == 3
    data = corpus["json"][:100000]
    out = ps.compress(data)
    assert out == js.compress(data)
    assert _gunzip(out) == data and ps.decompress(out) == data


# ---------------------------------------------------------------------------
# stream.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("piece", [1000, 4096, 100_000])
def test_stream_compress_matches_jax(corpus, piece):
    data = corpus["text"][:300000]
    js, ps = _pair(strm_buff_sz=64 * 1024, input_sz_thrshold=SW)
    jst, pst = jqz.QzStream(js), qz.QzStream(ps)
    got, want = _feed(pst, data, piece), _feed(jst, data, piece)
    assert got == want
    assert gzip.decompress(got) == data
    assert pst.crc_32 == jst.crc_32 == zlib.crc32(data)
    assert (pst.total_in, pst.total_out) == (jst.total_in, jst.total_out)
    assert pst.end() == QZ_OK
    with pytest.raises(qz.QzError) as e:
        pst.compress(b"x")
    assert e.value.rc == QZ_FAIL


@pytest.mark.parametrize("fmt", [DataFormat.DEFLATE_GZIP_EXT,
                                 DataFormat.DEFLATE_GZIP,
                                 DataFormat.DEFLATE_4B, DataFormat.DEFLATE_RAW,
                                 DataFormat.ZLIB], ids=lambda f: f.name)
def test_stream_formats_match_jax(corpus, fmt):
    """Small staging buffers (many members), and raw DEFLATE as one
    stream through a persistent deflater; each decodes back piecewise."""
    data = corpus["json"][:120000]
    js, ps = _pair(strm_buff_sz=8 * 1024, input_sz_thrshold=SW,
                   data_fmt=int(fmt))
    got = _feed(qz.QzStream(ps), data, 3000)
    assert got == _feed(jqz.QzStream(js), data, 3000)
    if fmt == DataFormat.DEFLATE_RAW:
        assert zlib.decompress(got, -15) == data
    elif fmt in (DataFormat.DEFLATE_GZIP_EXT, DataFormat.DEFLATE_GZIP):
        assert _gunzip(got) == data
    dec = _feed(qz.QzStream(ps), got, 5000, op="decompress")
    assert dec == _feed(jqz.QzStream(js), got, 5000, op="decompress")
    if fmt == DataFormat.ZLIB:
        # each unit is a whole zlib stream; the stream's one inflater and
        # the session both stop after the first, in both packages
        assert dec == ps.decompress(got) == data[:8 * 1024]
        assert js.decompress(got) == dec
    else:
        assert dec == data


def test_stream_lz4_matches_jax(corpus):
    data = corpus["noise"][:10000] + corpus["text"][:40000]
    js, ps = _pair("lz4", input_sz_thrshold=SW)
    want = bytearray()
    got = bytearray()
    jst, pst = jqz.QzStream(js, strm_buff_sz=8192), qz.QzStream(
        ps, strm_buff_sz=8192)
    for off in range(0, len(data), 3000):
        last = off + 3000 >= len(data)
        got += pst.compress(data[off:off + 3000], last=last)
        want += jst.compress(data[off:off + 3000], last=last)
    assert got == want
    dst = qz.QzStream(ps)
    dec = bytearray()
    for off in range(0, len(got), 4096):
        dec += dst.decompress(got[off:off + 4096],
                              last=off + 4096 >= len(got))
    assert bytes(dec) == data


def test_stream_decompress_carry_and_errors_match_jax(corpus):
    """A member split in two gives nothing until it completes; trailing
    bytes on ``last`` and bad input raise QZ_DATA_ERROR; the rc wrappers
    give the same codes."""
    data = corpus["one_chunk"]
    js, ps = _pair(input_sz_thrshold=SW)
    blob = ps.compress(data)
    half = len(blob) // 2
    for mod, sess in ((qz, ps), (jqz, js)):
        strm = mod.QzStream(sess)
        assert strm.decompress(blob[:half]) == b""
        assert strm.decompress(blob[half:], last=True) == data
    rcs = []
    for mod, smod, sess in ((qz, qz, ps), (jqz, jqz, js)):
        strm = mod.QzStream(sess)
        rcs.append((
            smod.qz_decompress_stream(sess, strm, blob + b"junk", 1)[0],
            smod.qz_decompress_stream(sess, mod.QzStream(sess),
                                      b"\x1f\x8b" + b"\x00" * 40, 1)[0],
            smod.qz_compress_stream(sess, mod.QzStream(sess), data, 1),
            smod.qz_end_stream(sess, strm)))
    assert rcs[0] == rcs[1]
    assert rcs[0][0] == rcs[0][1] == QZ_DATA_ERROR
    assert rcs[0][2][0] == QZ_OK and rcs[0][3] == QZ_OK


def test_stream_max_out_matches_jax(corpus):
    """``max_out`` bounds each call; the rest comes first in the next."""
    data = corpus["binary"][:60000]
    js, ps = _pair(strm_buff_sz=16384, input_sz_thrshold=SW)
    seqs = []
    for mod, sess in ((qz, ps), (jqz, js)):
        strm = mod.QzStream(sess)
        seq = [strm.compress(data[o:o + 7000], max_out=1000)
               for o in range(0, len(data), 7000)]
        seq.append(strm.compress(b"", last=True, max_out=1000))
        while strm.pending_out:
            seq.append(strm.compress(b"", max_out=1000))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert all(len(s) <= 1000 for s in seqs[0])
    assert gzip.decompress(b"".join(seqs[0])) == data


def test_stream_buffer_size_and_empty_match_jax():
    js, ps = _pair(input_sz_thrshold=SW)
    for bad in (512, 3 << 20):
        for mod, sess in ((qz, ps), (jqz, js)):
            with pytest.raises(Exception) as e:
                mod.QzStream(sess, strm_buff_sz=bad)
            assert e.value.rc == QZ_PARAMS
    got = qz.QzStream(ps).compress(b"", last=True)
    assert got == jqz.QzStream(js).compress(b"", last=True)
    assert gzip.decompress(got) == b"" and len(got) == 34


def test_stream_on_the_engine_route_is_its_units(corpus):
    """On the engine route (dynamic session, the CPU's token path) a
    stream's output is its units' ``compress`` outputs in order."""
    data = corpus["text"][:70000] + corpus["runs"][:30000]
    ps = qz.QzSession(device="cpu")
    ps.setup_deflate(_params(qz, qz, "deflate", hw_buff_sz=HW))
    strm = qz.QzStream(ps, strm_buff_sz=2 * HW)
    got = _feed(strm, data, 9000)
    unit = 2 * HW
    want = b"".join(ps.compress(data[o:o + unit])
                    for o in range(0, len(data), unit))
    assert got == want and _gunzip(got) == data
    assert strm.crc_32 == zlib.crc32(data)


# ---------------------------------------------------------------------------
# compress_batch and codec.compress_buffers
# ---------------------------------------------------------------------------

def _requests(corpus):
    c = corpus
    return [c["text"][:20000], b"", c["json"][:5000], c["tiny"],
            c["binary"][:40000], c["runs"][:700], c["noise"][:3000],
            c["json"][5000:45000]]


@pytest.mark.parametrize("kind,fields", [
    ("legacy", dict(comp_lvl=9, hw_buff_sz=HW)),
    ("legacy", dict(comp_lvl=9, hw_buff_sz=HW, data_fmt=1)),
    ("deflate", dict(input_sz_thrshold=SW, hw_buff_sz=HW)),
    ("legacy", dict(comp_lvl=9, hw_buff_sz=HW, sw_backup=2)),
    ("lz4", dict(input_sz_thrshold=SW)),
], ids=["legacy9-gzipext", "legacy9-gzip", "software", "auto-select-best",
        "lz4-software"])
def test_compress_batch_matches_jax(corpus, kind, fields):
    """On the software route (and the legacy level 9, which batches
    through the host engine) both packages' batches give the same bytes,
    crcs and session totals."""
    reqs = _requests(corpus)
    js, ps = _pair(kind, **fields)
    got, want = ps.compress_batch(reqs), js.compress_batch(reqs)
    assert got == want
    assert [c for _o, c in got] == [zlib.crc32(r) for r in reqs]
    assert (ps.total_in, ps.total_out, ps.crc32) == (js.total_in,
                                                     js.total_out, js.crc32)
    assert [ps.decompress(o) for o, _c in got] == reqs


def test_compress_batch_direction_matches_jax(corpus):
    js, ps = _pair(input_sz_thrshold=SW, direction=int(Direction.DIR_DECOMPRESS))
    for sess in (js, ps):
        with pytest.raises(Exception) as e:
            sess.compress_batch([b"abc"])
        assert e.value.rc == QZ_PARAMS


@pytest.fixture()
def counted(monkeypatch):
    """The number of CudaEngine.compress_chunks calls made from outside
    the engine."""
    calls = []
    real = CudaEngine.compress_chunks

    def counting(self, chunks, **kw):
        calls.append(len(chunks))
        return real(self, chunks, **kw)
    monkeypatch.setattr(CudaEngine, "compress_chunks", counting)
    return calls


@pytest.mark.parametrize("kind,fields", [
    ("deflate", dict(hw_buff_sz=HW)),
    ("deflate", dict(hw_buff_sz=HW, huffman_hdr=1)),
    ("deflate", dict(hw_buff_sz=HW, data_fmt=int(DataFormat.DEFLATE_4B))),
    ("deflate", dict(hw_buff_sz=HW, data_fmt=int(DataFormat.ZLIB))),
    ("lz4", dict()),
    ("lz4s", dict()),
], ids=["dynamic", "static", "4B", "zlib", "lz4", "lz4s"])
def test_compress_batch_on_the_engine_route_is_compress(corpus, counted, kind,
                                                        fields):
    """On the engine route every request's bytes are its own ``compress``
    output; requests under the size gate go to software one at a time and
    the rest of one row width share one engine call."""
    reqs = _requests(corpus)
    ps = qz.QzSession(device="cpu")
    assert getattr(ps, _SETUP[kind])(_params(qz, qz, kind, **fields)) == QZ_OK
    got = ps.compress_batch(reqs)
    widths = {row_width(codec._request_chunks(
        r, ps.algorithm, ps.data_fmt, ps.common.hw_buff_sz)[0])
        for r in reqs if len(r) >= ps.common.input_sz_thrshold}
    assert len(counted) == len(widths)
    totals = (ps.total_in, ps.total_out, ps.crc32)
    ref = qz.QzSession(device="cpu")
    getattr(ref, _SETUP[kind])(_params(qz, qz, kind, **fields))
    assert got == [ref.compress(r, with_crc=True) for r in reqs]
    # the running crc folds the requests under the gate first, then the
    # batch, as in the JAX package
    gate = ps.common.input_sz_thrshold
    order = ([r for r in reqs if len(r) < gate]
             + [r for r in reqs if len(r) >= gate])
    assert totals == (ref.total_in, ref.total_out, zlib.crc32(b"".join(order)))


def test_compress_buffers_one_call_per_width(corpus, counted):
    """Requests of one size share one engine call; a request of 8 KiB or
    less in a batch of wider ones keeps its own row width and bytes."""
    ps = qz.QzSession(device="cpu")
    ps.setup_deflate()
    same = [corpus["text"][i * 30000:(i + 1) * 30000] for i in range(4)]
    out = codec.compress_buffers(same, data_fmt=ps.data_fmt, level=1,
                                 hw_buff_sz=65536, engine=ps._engine)
    assert len(counted) == 1
    assert [o for o, _c in out] == [ps.compress(r) for r in same]
    counted.clear()
    small = corpus["json"][:5000]
    out = codec.compress_buffers([small] + same, data_fmt=ps.data_fmt,
                                 level=1, hw_buff_sz=65536, engine=ps._engine)
    assert len(counted) == 2
    assert out[0][0] == ps.compress(small)


# ---------------------------------------------------------------------------
# async_engine.py
# ---------------------------------------------------------------------------

def _run_async(mod, asess, reqs, op="compress", timeout=120):
    """Submit every request (retrying on AQZ_NO_SPACE); {i: (rc, dest,
    crc)} once every callback came."""
    results, done = {}, threading.Event()
    lock = threading.Lock()

    def cb(external, src, dest, rc, crc):
        with lock:
            results[external] = (rc, dest, crc)
            if len(results) == len(reqs):
                done.set()
    for i, r in enumerate(reqs):
        while True:
            rc = getattr(asess, op)(r, cb, external=i)
            if rc != mod.AQZ_NO_SPACE:
                break
            time.sleep(0.001)
        assert rc == mod.AQZ_OK
    assert done.wait(timeout)
    return results


def _async_pair(**fields):
    js, ps = _pair(**fields)
    return jqz.AQzSession(session=js), qz.AQzSession(session=ps)


def test_async_compress_and_decompress_match_jax(corpus):
    reqs = [(b"piece-%d " % i) * 500 for i in range(16)] + _requests(corpus)
    ja, pa = _async_pair(input_sz_thrshold=SW, hw_buff_sz=HW)
    assert jqz.aqz_init(num_threads=2) == qz.aqz_init(num_threads=2) == QZ_OK
    try:
        got = _run_async(qz, pa, reqs)
        want = _run_async(jqz, ja, reqs)
        assert got == want
        assert all(got[i][0] == QZ_OK and got[i][2] == zlib.crc32(r)
                   for i, r in enumerate(reqs))
        blobs = [got[i][1] for i in range(len(reqs))]
        dec = _run_async(qz, pa, blobs, op="decompress")
        assert [dec[i][:2] for i in range(len(reqs))] == [(QZ_OK, r)
                                                          for r in reqs]
        bad = _run_async(qz, pa, [b"\x1f\x8b junk"], op="decompress")
        jbad = _run_async(jqz, ja, [b"\x1f\x8b junk"], op="decompress")
        assert bad == jbad and bad[0][0] == QZ_DATA_ERROR
    finally:
        assert qz.aqz_stop() == jqz.aqz_stop() == QZ_OK


def test_async_on_the_engine_route_is_compress(corpus, counted):
    """The port's workers batch plain compress requests through
    ``compress_batch`` (fewer engine calls than requests) and every
    callback gets ``compress``'s bytes."""
    reqs = [corpus["text"][i * 20000:(i + 1) * 20000] for i in range(16)]
    pa = qz.AQzSession(device="cpu")
    assert pa.setup_deflate(_params(qz, qz, "deflate", hw_buff_sz=HW)) == QZ_OK
    gate = threading.Event()
    # hold the worker on its first request so the rest queue up behind it
    assert qz.aqz_init(num_threads=1) == QZ_OK
    try:
        first = {}

        def hold(external, src, dest, rc, crc):
            first["r"] = (rc, dest)
            gate.wait(60)
        assert pa.compress(reqs[0], hold, external=-1) == qz.AQZ_OK
        time.sleep(0.2)
        calls_before = len(counted)
        results, done = {}, threading.Event()

        def cb(external, src, dest, rc, crc):
            results[external] = (rc, dest)
            if len(results) == len(reqs):
                done.set()
        for i, r in enumerate(reqs):
            assert pa.compress(r, cb, external=i) == qz.AQZ_OK
        gate.set()
        assert done.wait(120)
    finally:
        qz.aqz_stop()
    assert len(counted) - calls_before < len(reqs)
    ref = qz.QzSession(device="cpu")
    ref.setup_deflate(_params(qz, qz, "deflate", hw_buff_sz=HW))
    assert [results[i] for i in range(len(reqs))] == [
        (QZ_OK, ref.compress(r)) for r in reqs]


def test_async_ring_full_and_stopped_match_jax():
    """A full ring answers AQZ_NO_SPACE, a stopped runtime AQZ_STOPPED;
    init checks its arguments; the codes are the JAX package's."""
    assert (async_engine.AQZ_OK, async_engine.AQZ_NO_SPACE,
            async_engine.AQZ_STOPPED) == (jasync.AQZ_OK, jasync.AQZ_NO_SPACE,
                                          jasync.AQZ_STOPPED)
    assert (async_engine.BATCH_MAX, async_engine.DEFAULT_RING_DEPTH) == (
        jasync.BATCH_MAX, jasync.DEFAULT_RING_DEPTH) == (64, 128)
    codes = []
    for mod in (async_engine, jasync):
        rt = mod.AQzRuntime()
        sess = qz.QzSession(device="cpu")
        sess.compress(b"warm")
        req = lambda cb: mod._Request(  # noqa: E731
            seq=0, session=sess, direction=Direction.DIR_COMPRESS,
            src=b"abc" * 100, callback=cb, external=None)
        seen = [mod.AQzRuntime().init(num_threads=0), rt.submit(req(None))]
        assert rt.init(num_threads=1, ring_depth=1) == QZ_OK
        gate, got = threading.Event(), []

        def cb(external, src, dest, rc, crc):
            got.append(rc)
            gate.wait(30)
        seen.append(rt.submit(req(cb)))
        time.sleep(0.2)                   # the worker holds the first one
        seen += [rt.submit(req(cb)), rt.submit(req(cb))]
        gate.set()
        seen.append(rt.stop())
        seen.append(got)
        codes.append(seen)
    assert codes[0] == codes[1]
    assert codes[0] == [QZ_PARAMS, async_engine.AQZ_STOPPED, QZ_OK,
                        QZ_OK, async_engine.AQZ_NO_SPACE, QZ_OK,
                        [QZ_OK, QZ_OK]]


def test_async_chain_compress_and_hash_match_jax(corpus):
    data = corpus["text"][:9000]
    ja, pa = _async_pair(input_sz_thrshold=SW)
    outs = []
    for mod, asess in ((qz, pa), (jqz, ja)):
        assert mod.aqz_init(num_threads=1) == QZ_OK
        got, ev = {}, threading.Event()

        def cb(external, src, dest, rc, crc, digest):
            got[external] = (rc, dest, crc, digest)
            if len(got) == 2:
                ev.set()
        try:
            assert asess.chain_compress(data, cb, external="chain") == 0
            assert asess.hash(data, cb, external="hash") == 0
            assert ev.wait(60)
        finally:
            mod.aqz_stop()
        outs.append(got)
    assert outs[0] == outs[1]
    import hashlib
    assert outs[0]["hash"] == (QZ_OK, b"", 0, hashlib.sha256(data).digest())
    assert gzip.decompress(outs[0]["chain"][1]) == data


def test_async_batch_failure_runs_requests_one_by_one(corpus, monkeypatch):
    """A batch that raises is run again one request at a time, so each
    request still gets its own result."""
    ps = qz.QzSession(device="cpu")
    ps.setup_deflate(_params(qz, qz, "deflate", input_sz_thrshold=SW))

    def broken(datas):
        raise RuntimeError("batch failed")
    monkeypatch.setattr(ps, "compress_batch", broken)
    reqs = [corpus["json"][i * 3000:(i + 1) * 3000] for i in range(6)]
    rs = [async_engine._Request(seq=i, session=ps,
                                direction=Direction.DIR_COMPRESS, src=r,
                                callback=None, external=i)
          for i, r in enumerate(reqs)]
    got = {}
    for r in rs:
        r.callback = lambda ext, src, dest, rc, crc: got.__setitem__(
            ext, (rc, dest))
    async_engine.AQzRuntime._process_group(rs, Direction.DIR_COMPRESS)
    ref = qz.QzSession(device="cpu")
    ref.setup_deflate(_params(qz, qz, "deflate", input_sz_thrshold=SW))
    assert [got[i] for i in range(6)] == [(QZ_OK, ref.compress(r))
                                          for r in reqs]


def test_async_session_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(qz.QzError) as e:
        qz.AQzSession()                 # the default device is the GPU
    assert e.value.rc == QZ_NOSW_NO_HW
    assert qz.AQzSession(device="cpu").session.device.type == "cpu"
