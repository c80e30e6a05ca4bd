"""The port's multi-device layer against the JAX package, on the CPU.

Every comparison is exact (tolerance 0): each output is an integer or a
byte.

  * ``host_stripe`` and ``interleave_stripes`` against
    ``qatzip_tpu.parallel.multihost``'s (pure Python);
  * ``init_distributed()`` with no arguments and no ``WORLD_SIZE``;
  * ``mesh_tokenize``, ``mesh_pack_device`` and ``mesh_analyze_hist`` ->
    ``dyn_plan`` -> ``mesh_pack_dynamic`` over eight CPU devices against
    the JAX functions over the eight-device test mesh, at
    ``__graft_entry__._example_batch(16, 2048)`` with the JAX defaults,
    the shapes ``tests/test_lz77_tpu.py::test_graft_entry`` compiles;
    the port's ``graft_entry.entry()`` tokens against JAX's at (4, 16384);
  * the engine over two and three CPU devices against the one-device
    engine on every route, and on a ragged request also against the JAX
    package's one-device ``TpuEngine``; ``compress_striped`` in one
    process, and two-process gloo runs of ``python -m
    qatzip_tpu_torch.tools.distrun``.
"""

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

import __graft_entry__ as jentry
from qatzip_tpu.parallel import mesh as jmesh
from qatzip_tpu.parallel import multihost as jmh
import qatzip_tpu_torch as qz
from qatzip_tpu_torch import graft_entry
from qatzip_tpu_torch.constants import QZ_NOSW_NO_HW, QZ_PARAMS, QzError
from qatzip_tpu_torch.engines import host_engine
from qatzip_tpu_torch.parallel import mesh, multihost
from qatzip_tpu_torch.parallel.dispatch import (CudaEngine, MeshEngine,
                                                build_engine, plan_tile)
from qatzip_tpu_torch.runtime import get_runtime, resolve_device
from qatzip_tpu_torch.tools.distrun import make_corpus

from tests.reference_native import (one_intra_op_thread,
                                     require_reference_native)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


# -- multihost ---------------------------------------------------------------

@pytest.mark.parametrize("num_items,nprocs", [
    (13, 3), (7, 1), (2, 5), (0, 2), (64, 4), (65, 8)])
def test_stripes_match_jax(num_items, nprocs):
    stripes = [multihost.host_stripe(num_items, pid, nprocs)
               for pid in range(nprocs)]
    assert stripes == [jmh.host_stripe(num_items, pid, nprocs)
                       for pid in range(nprocs)]
    assert sorted(sum(stripes, [])) == list(range(num_items))
    outs = [[(pid, i) for i in idx] for pid, idx in enumerate(stripes)]
    merged = multihost.interleave_stripes(outs, num_items)
    assert merged == jmh.interleave_stripes(outs, num_items)
    assert [i for _pid, i in merged] == list(range(num_items))


def test_init_distributed_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.init_distributed() == (0, 1)
    assert multihost.init_distributed(num_processes=1) == (0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        multihost.init_distributed(coordinator_address="127.0.0.1:1",
                                   num_processes=2)


def test_compress_striped_single_process():
    chunks = [(b"stripe %d " % i) * 300 for i in range(7)]
    idx, results = multihost.compress_striped(chunks, device="cpu")
    assert idx == list(range(7))
    want = get_runtime().get_engine("cpu").compress_chunks(chunks, level=1)
    assert results == [(bytes(p), c) for p, c in want]
    merged = multihost.interleave_stripes([results], len(chunks))
    for (payload, crc), c in zip(merged, chunks):
        assert zlib.decompressobj(-15).decompress(payload) == c
        assert crc == zlib.crc32(c)
    # the host engine (device None)
    idx, results = multihost.compress_striped(chunks, device=None)
    assert results == [(bytes(p), c) for p, c in
                       host_engine.compress_chunks(chunks, level=1)]


def test_distrun_corpus_is_deterministic():
    a = make_corpus(1)
    assert a == make_corpus(1) and len(a) == 1 << 20
    assert a != make_corpus(1, seed=1)
    # a mix that compresses, with incompressible parts
    assert 1.5 < len(a) / len(zlib.compress(a, 1)) < 6


# -- the runtime -------------------------------------------------------------

def test_resolve_device_and_the_engine_pool():
    assert resolve_device("cpu") == (CPU,)
    assert resolve_device(["cpu", CPU, "cpu"]) == (CPU,) * 3
    for bad in ([], ["cpu", "cuda:0"]):
        with pytest.raises(QzError) as e:
            resolve_device(bad)
        assert e.value.rc in (QZ_PARAMS, QZ_NOSW_NO_HW)
    if not torch.cuda.is_available():
        for dev in ("cuda", "cuda:0", ["cuda:0", "cuda:0"]):
            with pytest.raises(QzError) as e:
                resolve_device(dev)
            assert e.value.rc == QZ_NOSW_NO_HW
    rt = get_runtime()
    one = rt.get_engine("cpu")
    assert type(one) is CudaEngine and rt.get_engine(["cpu"]) is one
    assert one.devices == (CPU,)
    two = rt.get_engine(["cpu", "cpu"])
    assert type(two) is MeshEngine and two.device == CPU
    assert two.devices == (CPU, CPU) and rt.get_engine((CPU, CPU)) is two
    sess = qz.QzSession(device=["cpu", "cpu"])
    assert sess._engine is two and sess.devices == (CPU, CPU)
    assert qz.qz_get_status(sess)["platform"] == "cpu"
    assert type(build_engine(CPU)) is CudaEngine


def test_mesh_refuses_a_batch_that_does_not_divide():
    m = mesh.make_mesh(["cpu"] * 3)
    data, lengths = graft_entry._example_batch(4, 2048)
    with pytest.raises(ValueError):
        mesh.mesh_tokenize(m, data, lengths, n=2048)
    with pytest.raises(ValueError):
        mesh.Mesh([])


# -- the mesh functions against the JAX package's ---------------------------

@pytest.fixture(scope="module")
def mesh_runs():
    """Both packages' four mesh functions over eight devices at the
    shapes of ``__graft_entry__.dryrun_multichip(8)``."""
    n, b = 2048, 16
    data, lengths = jentry._example_batch(b, n)
    mine = graft_entry._example_batch(b, n)
    assert np.array_equal(mine[0], data) and np.array_equal(mine[1], lengths)
    devs = jax.devices("cpu")[:8]
    assert len(devs) == 8
    jm = jmesh.make_mesh(devs)
    pm = mesh.make_mesh(["cpu"] * 8)
    out = {"data": data, "lengths": lengths}
    out["jtok"] = jmesh.mesh_tokenize(jm, data, lengths, n=n)
    out["tok"] = mesh.mesh_tokenize(pm, data, lengths, n=n)
    out["jpack"] = [np.asarray(x) for x in
                    jmesh.mesh_pack_device(jm, data, lengths, n=n)]
    out["pack"] = mesh.mesh_pack_device(pm, data, lengths, n=n)
    jhist, *jplanes = jmesh.mesh_analyze_hist(jm, data, lengths, n=n)
    hist, *planes = mesh.mesh_analyze_hist(pm, data, lengths, n=n)
    out["jhist"], out["hist"] = np.asarray(jhist), hist
    out["plan"] = packs, dpacks, hdrs, hbits = plan_tile(hist, b)
    out["jdyn"] = [np.asarray(x) for x in jmesh.mesh_pack_dynamic(
        jm, data, *jplanes, packs.astype(np.uint32),
        dpacks.astype(np.uint32), hbits, n=n)]
    out["dyn"] = mesh.mesh_pack_dynamic(pm, data, *planes, packs, dpacks,
                                        hbits, n=n)
    out["planes"] = planes
    return out


def test_mesh_tokenize_matches_jax(mesh_runs):
    (jt, jn, js), (t, nt, st) = mesh_runs["jtok"], mesh_runs["tok"]
    assert t.shape == jt.shape == (16, 2048)
    assert np.array_equal(t, np.asarray(jt).view(np.uint32))
    assert np.array_equal(nt, jn) and np.array_equal(st, js)
    assert int(st[1]) == int(mesh_runs["lengths"].sum())


def test_mesh_pack_device_matches_jax(mesh_runs):
    (jw, jb), (w, nb) = mesh_runs["jpack"], mesh_runs["pack"]
    assert w.shape == jw.shape
    assert np.array_equal(w, jw.view(np.uint32)) and np.array_equal(nb, jb)


def test_mesh_dynamic_passes_match_jax(mesh_runs):
    assert np.array_equal(mesh_runs["hist"], mesh_runs["jhist"])
    (jw, jb), (w, nb) = mesh_runs["jdyn"], mesh_runs["dyn"]
    assert w.shape == jw.shape
    assert np.array_equal(w, jw.view(np.uint32)) and np.array_equal(nb, jb)
    # pass 1's planes stay dealt: eight shards of two rows on their devices
    ml = mesh_runs["planes"][0]
    assert isinstance(ml, mesh.Sharded) and len(ml.shards) == 8
    assert all(tuple(s.shape) == (2, 2048) and s.device == CPU
               for s in ml.shards)
    from qatzip_tpu_torch.ops.deflate_pack import finish_stream_dynamic
    data, lengths = mesh_runs["data"], mesh_runs["lengths"]
    packs, _dp, hdrs, _hb = mesh_runs["plan"]
    for i in range(16):
        stream = finish_stream_dynamic(w[i], int(nb[i]), hdrs[i],
                                       int(packs[i][256]), final=True)
        assert zlib.decompressobj(-15).decompress(stream) == \
            data[i, :lengths[i]].tobytes()


def test_dryrun_multichip_on_the_cpu():
    got = graft_entry.dryrun_multichip(3, device="cpu")
    assert got["devices"] == ["cpu"] * 3 and got["rows"] == 6
    assert got["distinct"] == 1 and got["repeated"]


def test_entry_matches_jax():
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jentry.entry()
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    toks, ntok = fn(*args)
    jtoks, jntok = jfn(*jargs)
    assert toks.shape == (4, 16384)
    assert np.array_equal(ntok.numpy(), np.asarray(jntok))
    assert np.array_equal(toks.numpy().view(np.uint32),
                          np.asarray(jtoks).view(np.uint32))


# -- the engine over several devices against one ----------------------------

def _ragged(size=61001, chunk=4096):
    """``size`` bytes of the tool's corpus in ``chunk``-byte chunks (a
    ragged tail). The routes are held on 1 KiB chunks: on the CPU the
    plain candidate search's time grows with the row width."""
    blob = make_corpus(1, seed=3)[:size]
    return [blob[o:o + chunk] for o in range(0, len(blob), chunk)]


# (route, algorithm, huffman_static, packs_on_device held or None, crc held)
ROUTES = [
    ("token-dynamic", "deflate", False, None, None),
    ("static-device-pack", "deflate", True, None, None),
    ("dynamic-device-pack", "deflate", False, True, None),
    ("dynamic-device-pack-device-crc", "deflate", False, True, True),
    ("lz4-token", "lz4", False, None, None),
    ("lz4-device-pack", "lz4", False, True, None),
    ("lz4s", "lz4s", False, None, None),
]


def _hold(monkeypatch, pack, crc):
    if pack is not None:
        monkeypatch.setattr(CudaEngine, "packs_on_device",
                            lambda self, static, algorithm="deflate": pack)
    if crc is not None:
        monkeypatch.setattr(CudaEngine, "crc_on_device", lambda self: crc)


def _one_and_mesh(k, chunks, **kw):
    one = CudaEngine(CPU).compress_chunks(chunks, **kw)
    many = build_engine([CPU] * k).compress_chunks(chunks, **kw)
    return one, many


_ONE_DEVICE = {}        # route -> the one-device engine's results


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("route,algorithm,static,pack,crc", ROUTES)
def test_mesh_engine_matches_one_device(monkeypatch, k, route, algorithm,
                                        static, pack, crc):
    _hold(monkeypatch, pack, crc)
    chunks = _ragged(13013, 1024)
    kw = dict(level=1, algorithm=algorithm, huffman_static=static)
    if route not in _ONE_DEVICE:
        _ONE_DEVICE[route] = CudaEngine(CPU).compress_chunks(chunks, **kw)
    one = _ONE_DEVICE[route]
    many = build_engine([CPU] * k).compress_chunks(chunks, **kw)
    assert many == one and len(one) == len(chunks)
    for (payload, c), src in zip(many, chunks):
        assert c == zlib.crc32(src)
        if algorithm == "deflate":
            assert zlib.decompressobj(-15).decompress(payload) == src


@pytest.fixture(scope="module")
def jax_ragged():
    """The JAX package's one-device engine on ``_ragged()``, on its own
    route (the token path, as the port's engine on the CPU), no
    ``QZTPU_*`` knob set."""
    from qatzip_tpu.parallel.dispatch import TpuEngine
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("QZTPU_")]:
            mp.delenv(key)
        eng = TpuEngine([jax.devices("cpu")[0]], "deflate")
        got = eng.compress_chunks(_ragged(), level=1, algorithm="deflate")
    return [(bytes(p), c) for p, c in got]


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_engine_ragged_request_in_4k_chunks(jax_ragged, k):
    chunks = _ragged()
    one, many = _one_and_mesh(k, chunks, level=1)
    assert many == one and len(one) == 15
    assert [(bytes(p), c) for p, c in many] == jax_ragged
    assert zlib.decompressobj(-15).decompress(many[-1][0]) == chunks[-1]


@pytest.mark.parametrize("k,pack", [(2, None), (3, None), (2, True)])
def test_mesh_engine_takes_the_row_width_from_the_whole_request(
        monkeypatch, k, pack):
    """The longest chunk lands on the last shard only: the shares before
    it must still take its row width and knobs (alone they would give
    other bytes)."""
    _hold(monkeypatch, pack, None)
    blob = make_corpus(1, seed=4)
    chunks = [blob[:1500], blob[1500:3000], blob[100000:110000]]
    one, many = _one_and_mesh(k, chunks, level=1)
    assert many == one
    alone = CudaEngine(CPU).compress_chunks(chunks[:1], level=1)
    assert alone != one[:1]


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_engine_splits_rows_over_64k(k):
    blob = make_corpus(1, seed=5)
    chunks = [blob[:65537], blob[200000:203000]]
    one, many = _one_and_mesh(k, chunks, level=1, final_flags=[False, True])
    assert many == one
    d = zlib.decompressobj(-15)
    assert d.decompress(b"".join(p for p, _c in many)) == b"".join(chunks)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("device_leg", [False, True])
def test_mesh_engine_decompress_chunks(monkeypatch, k, device_leg):
    monkeypatch.setattr(CudaEngine, "decodes_on_device",
                        lambda self: device_leg)
    chunks = _ragged()
    blocks = [p for p, _c in host_engine.compress_chunks(chunks, level=1,
                                                         algorithm="lz4")]
    sizes = [len(c) for c in chunks]
    one = CudaEngine(CPU).decompress_chunks(blocks, sizes, algorithm="lz4")
    many = build_engine([CPU] * k).decompress_chunks(blocks, sizes,
                                                     algorithm="lz4")
    assert many == one == chunks


def test_mesh_session_matches_one_device():
    data = make_corpus(1, seed=6)[:40000]
    outs = []
    for device in ("cpu", ["cpu"] * 2):
        sess = qz.QzSession(device=device)
        p = qz.SessionParamsDeflate()
        p.common.hw_buff_sz = 16384
        assert sess.setup_deflate(p) == qz.QZ_OK
        outs.append(sess.compress(data))
        assert sess.decompress(outs[-1]) == data
    assert outs[0] == outs[1]


# -- two processes (started with the module) ------------------------------

# (engine, the tool's arguments): --engine device is the default
DISTRUNS = [("sw", ["--mb", "4", "--engine", "sw"]),
            ("device", ["--mb", "1", "--device", "cpu"])]


@pytest.fixture(scope="module", autouse=True)
def distruns():
    """Both two-process runs of the tool, started with the module: they
    run beside this process's tests (each of their processes mostly waits
    for its interpreter and torch to load)."""
    procs = {engine: subprocess.Popen(
        [sys.executable, "-m", "qatzip_tpu_torch.tools.distrun", "--procs",
         "2", "--timeout", "150", *extra], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO)
        for engine, extra in DISTRUNS}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("engine,extra", DISTRUNS)
def test_distrun_two_processes(distruns, engine, extra):
    out, err = distruns[engine].communicate(timeout=180)
    assert distruns[engine].returncode == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["ok"] is True and line["procs"] == 2
    assert line["engine"] == engine and line["sum_gbps"] > 0
    assert line["chunks"] == int(extra[1]) * 16
    assert set(line) >= {"ok", "procs", "chunks", "mb", "engine",
                         "sum_gbps", "verified"}


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Load the JAX package's native library first (the reference;
    tests/reference_native.py), run torch on one intra-op thread (the
    test runner's workers share the host's cores, and this file's small
    ops only contend for them), and give what this module held back to
    the system when it ends: the test runner keeps each worker process
    for many files, JAX keeps every compiled program, and glibc keeps
    freed pages."""
    require_reference_native()
    with one_intra_op_thread():
        yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
