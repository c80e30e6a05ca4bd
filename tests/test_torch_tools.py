"""The port's test and perf tools and the runtime's close and fork, on
the CPU.

  * ``qatzip_tpu_torch.tools.qztest``: every mode 1-23 through its
    ``main`` at ``--device cpu -t 2 -l 3 -b 16384 -v`` (mode 21, which
    forks, in a process of its own with a timeout); exit codes for
    unknown modes and for ``--device cuda`` without a GPU;
  * ``Runtime.close`` and the module ``qz_init`` / ``qz_close``; a child
    made by fork starts with an empty pool, caches and host pool; with
    torch's bad-fork flag set, CUDA is refused with QZ_NOSW_NO_HW;
  * ``run_perf_test``: its sum over a fixed log equals the frozen
    ``tools/run_perf_test.sh``'s awk, and two processes end to end;
  * ``soak --iters 8 --seed 0 --device cpu``;
  * ``decprof --device cpu --mb 2`` prints every stage line;
    ``ratiocheck --device cpu --mb 1`` at the engine's level-1 knobs
    packs each row into the CPU token path's payload, and its
    ``strided_corpus`` is the frozen ``tools/ratiocheck.py``'s byte for
    byte; neither module imports JAX;
  * against the JAX package: ``gen_random_data`` byte for byte, mode 6's
    bad-parameter cases rc for rc, and a ``-m 4`` request's bytes (16
    KiB, seed 0; the JAX engine at the (16, 16384) token-path shape that
    ``tests/test_torch_session.py`` compiles).

Every comparison is exact (tolerance 0): the outputs are bytes, return
codes and sums printed to three decimals.
"""

import argparse
import ctypes
import gc
import importlib.util
import os
import re
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import jax

from qatzip_tpu import codec as jcodec
from qatzip_tpu import params as jparams
from qatzip_tpu import session as jsession
from qatzip_tpu.parallel.dispatch import TpuEngine
import qatzip_tpu_torch as qz
from qatzip_tpu_torch import engines, runtime
from qatzip_tpu_torch.constants import (QZ_DUPLICATE, QZ_NO_HW,
                                        QZ_NOSW_NO_HW, QZ_OK, QzError)
from qatzip_tpu_torch.ops import crc32_mxu
from qatzip_tpu_torch.parallel.dispatch import CudaEngine
from qatzip_tpu_torch.runtime import get_runtime
from qatzip_tpu_torch.tools import (decprof, qztest, ratiocheck,
                                    run_perf_test, soak)

from tests.reference_native import (one_intra_op_thread,
                                     require_reference_native)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ARGS = ["--device", "cpu", "-t", "2", "-l", "3", "-b", "16384", "-v"]
IMPORTS_NO_JAX = (
    "import sys; import qatzip_tpu_torch.tools.decprof, "
    "qatzip_tpu_torch.tools.ratiocheck as r; r.strided_corpus(1); "
    "print(sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith(('jax.', 'qatzip_tpu.'))))")


def _tool(module, *args):
    return subprocess.Popen([sys.executable, "-m", module, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO)


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


@pytest.fixture(scope="module")
def programs():
    """Mode 21, two ``run_perf_test`` processes and an import of
    ``decprof`` and ``ratiocheck`` as programs, started once; each
    mostly waits for its interpreter and torch to load, so they run
    beside this process's tests."""
    procs = {
        "mode21": _tool("qatzip_tpu_torch.tools.qztest", "-m", "21",
                        *CPU_ARGS),
        # the modules JAX and the JAX package would add to a fresh process
        "imports": subprocess.Popen(
            [sys.executable, "-c", IMPORTS_NO_JAX], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=REPO),
        "perf": _tool("qatzip_tpu_torch.tools.run_perf_test", "-p", "2",
                      "-t", "1", "-l", "2", "-b", "16384", "--device",
                      "cpu"),
    }
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finished(proc, timeout=150):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


# -- qztest --------------------------------------------------------------------

@pytest.mark.parametrize("mode", [m for m in range(1, 24) if m != 21])
def test_qztest_mode_on_the_cpu(mode, capsys):
    assert qztest.main(["-m", str(mode), *CPU_ARGS]) == 0
    out, err = capsys.readouterr()
    if mode in (1, 3):
        assert f"Test mode {mode} has been removed" in err
        return
    info = [ln for ln in out.splitlines() if ln.startswith("[INFO]")]
    assert len(info) == 2 and "[FAIL]" not in err
    if mode == 4:
        assert sorted(ln.split("tid=")[1][0] for ln in info) == ["0", "1"]
        assert all(ln.endswith(" Gbps") and "bytes=98304" in ln
                   for ln in info)
        assert re.search(r"^\[TOTAL\] threads=2 sum=\S+ Gbps", out, re.M)


def test_qztest_mode_21_forks_on_the_cpu(programs):
    """forkResourceCheck as a program: each thread's child compresses and
    decompresses on the CPU with the parent's bytes; the parent waits
    with its own deadline."""
    rc, out, err = _finished(programs["mode21"])
    assert rc == 0, err
    assert sorted(re.findall(r"\[INFO\] tid=(\d) fork ok", out)) == ["0", "1"]


@pytest.mark.parametrize("mode", [0, 24, -1])
def test_qztest_unknown_mode_exits_2(mode, capsys):
    assert qztest.main(["-m", str(mode), "--device", "cpu"]) == 2
    assert "unsupported mode" in capsys.readouterr().err


def test_qztest_without_a_gpu_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    for mode in range(1, 24):
        assert qztest.main(["-m", str(mode)]) == 1, mode
        assert "QZ_NOSW_NO_HW" in capsys.readouterr().err
    assert run_perf_test.main(["-p", "1"]) == 1
    assert soak.main(["--iters", "1"]) == 1
    assert decprof.main(["--mb", "1"]) == 1
    with pytest.raises(SystemExit, match="no CUDA device"):
        ratiocheck.main(["--mb", "1"])


def test_tools_read_no_qztpu_variable():
    for mod in (qztest, run_perf_test, soak, decprof, ratiocheck):
        with open(mod.__file__) as f:
            src = f.read()
        read = re.findall(r"(?:environ(?:\.get)?|getenv)[\[(]\s*['\"](\w+)",
                          src)
        assert not [v for v in read if v.startswith("QZTPU")], mod.__name__


def test_qztest_thread_failure_fails_the_run(monkeypatch, capsys):
    """An error inside a mode fails its thread and the run (exit 1)."""
    def boom(args, tid, stats):
        raise QzError(QZ_NO_HW, "boom")
    monkeypatch.setitem(qztest.MODES, 9, boom)
    assert qztest.main(["-m", "9", *CPU_ARGS]) == 1
    assert "[FAIL] 2 thread(s) failed" in capsys.readouterr().err


# -- the runtime: close and fork ------------------------------------------------

def test_runtime_close_drops_the_engines():
    data = qztest.gen_random_data(20000, seed=3)
    rt = get_runtime()
    first = qz.QzSession("cpu")
    assert rt.init("cpu") in (QZ_OK, QZ_DUPLICATE)
    assert rt.init("cpu") == QZ_DUPLICATE
    want = first.compress(data)
    assert rt.close() == QZ_OK
    assert rt._engines == {} and rt._initialized == set()
    assert not rt.initialized("cpu")
    second = qz.QzSession("cpu")
    assert second._engine is not first._engine
    assert second.compress(data) == want
    # a session keeps the engine it holds
    assert first.decompress(want) == data
    assert runtime.qz_init("cpu") == QZ_OK
    assert runtime.qz_init("cpu") == QZ_DUPLICATE
    assert runtime.qz_close() == QZ_OK
    assert runtime.qz_init("cpu", 0) == QZ_OK
    if not torch.cuda.is_available():
        assert runtime.qz_init() == QZ_NO_HW
        assert runtime.qz_init("cuda", 0) == QZ_NOSW_NO_HW


def _in_child(fn, timeout=60.0) -> int:
    """Run ``fn()`` in a child made by fork; its exit code (``fn``'s
    return value, 2 when it raised, -9 when it hung and was killed)."""
    pid = os.fork()
    if pid == 0:
        code = 2
        try:
            torch.set_num_threads(1)
            code = fn()
        finally:
            os._exit(code)
    deadline = time.monotonic() + timeout
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            return os.waitstatus_to_exitcode(status)
        if time.monotonic() > deadline:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
            return -9
        time.sleep(0.02)


def test_forked_child_starts_clean():
    data = qztest.gen_random_data(30000, seed=5)
    sess = qz.QzSession("cpu")
    want = sess.compress(data)
    rt = get_runtime()
    # a device-tensor cache entry, the host pool's threads and the async
    # workers, all alive in the parent at the fork
    crc32_mxu._on("tails", 3, torch.device("cpu"))
    assert crc32_mxu._dev_cache and rt._engines
    engines.host_pool().submit(int).result()
    assert qz.aqz_init(num_threads=1) == QZ_OK
    try:
        def child():
            from qatzip_tpu_torch import async_engine
            if rt._engines or rt._initialized:
                return 3
            if crc32_mxu._dev_cache or crc32_mxu._v_dev_cache:
                return 4
            if engines._pool is not None:
                return 5
            if async_engine._aqz_runtime._running:
                return 6
            # a new engine and host pool: the same bytes
            got = qz.QzSession("cpu").compress(data)
            return 0 if got == want else 7
        assert _in_child(child) == 0
    finally:
        qz.aqz_stop()
    assert rt._engines and crc32_mxu._dev_cache


def test_bad_fork_refuses_cuda(monkeypatch):
    """In a child forked after CUDA came up (torch's flag patched here),
    a CUDA device is refused with QZ_NOSW_NO_HW before any CUDA call;
    the CPU works."""
    monkeypatch.setattr(torch.cuda, "_is_in_bad_fork", lambda: True)
    rt = runtime.Runtime()
    assert rt.init("cuda") == QZ_NO_HW
    assert rt.init("cuda:0", 0) == QZ_NOSW_NO_HW
    assert rt.init("cpu") == QZ_OK
    for dev in ("cuda", "cuda:0", ["cuda:0", "cuda:0"]):
        with pytest.raises(QzError) as e:
            qz.QzSession(dev)
        assert e.value.rc == QZ_NOSW_NO_HW and "spawn" in str(e.value)
    # an engine the child inherited raises before its first CUDA call
    with pytest.raises(QzError) as e:
        CudaEngine(torch.device("cuda", 0)).compress_chunks([b"x" * 100],
                                                            level=1)
    assert e.value.rc == QZ_NOSW_NO_HW
    data = b"fork " * 1000
    s = qz.QzSession("cpu")
    assert s.decompress(s.compress(data)) == data
    assert qztest.main(["-m", "4", "--device", "cuda", "-l", "1"]) == 1


def test_crc_device_caches_fill_once_under_threads():
    """More threads than cores fill a device-tensor cache at once, with a
    short switch interval: all get the one tensor the cache keeps."""
    dev = torch.device("cpu")
    key = 4321
    crc32_mxu._v_dev_cache.pop((key, str(dev)), None)
    crc32_mxu._dev_cache.pop(("tails", key, str(dev)), None)
    workers = 2 * (os.cpu_count() or 8)
    got, start = [], threading.Barrier(workers)

    def fill():
        start.wait()
        got.append((crc32_mxu._v_on(key, dev),
                    crc32_mxu._on("tails", key, dev)))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fill) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == workers
    assert all(v is got[0][0] and t is got[0][1] for v, t in got)
    assert got[0][0] is crc32_mxu._v_dev_cache[(key, str(dev))]


# -- run_perf_test -------------------------------------------------------------

PERF_LOG = """\
[INFO] srv=both, tid=0, verify=True, count=20, msec=812, bytes=2621440, 25.826 Gbps
[INFO] srv=both, tid=1, verify=True, count=20, msec=790, bytes=2621440, 26.546 Gbps
[TOTAL] threads=2 sum=52.372 Gbps wall=815 msec
[INFO] tid=0 async-batching: sync=120ms async=40ms (faster, 64 x 4KB buffers)
[INFO] srv=comp, tid=3, verify=False, count=1, msec=0, bytes=0, 0.000 Gbps
[INFO] srv=decomp, tid=2, verify=True, count=5, msec=3, bytes=5, .5 Gbps, 1e1 Gbps
[INFO] odd, x Gbps, 7 Gbps of 9 Gbps, -1.25 Gbps
thread 0: VERIFY FAILED 9.9 Gbps
"""


def test_perf_sum_matches_the_shell_scripts_awk(tmp_path):
    with open(os.path.join(REPO, "tools", "run_perf_test.sh")) as f:
        script = f.read()
    awk = re.search(r"awk -F', ' '([^']*)'", script).group(1)
    log = tmp_path / "proc1.log"
    log.write_text(PERF_LOG)
    want = subprocess.run(
        f"cat {log} | grep '\\[INFO\\]' | awk -F', ' '{awk}'", shell=True,
        check=True, capture_output=True, text=True).stdout
    assert f"{run_perf_test.gbps_sum(PERF_LOG.splitlines(True)):.3f}" == want
    assert want == "68.622"


def test_run_perf_test_two_processes(programs):
    rc, out, err = _finished(programs["perf"])
    assert rc == 0, err
    lines = out.splitlines(True)
    info = [ln for ln in lines if ln.startswith("[INFO]")]
    assert len(info) == 2 and all("verify=True" in ln for ln in info)
    total = re.search(r"^\[perf\] TOTAL: (\S+) Gbps across 2 processes$",
                      out, re.M)
    assert total and total.group(1) == f"{run_perf_test.gbps_sum(info):.3f}"


# -- soak ------------------------------------------------------------------------

def test_soak_on_the_cpu(capsys):
    assert soak.main(["--iters", "8", "--seed", "0", "--device", "cpu"]) == 0
    assert "soak: all clear (8 iterations" in capsys.readouterr().out


def test_soak_varies_level_and_chunk_size():
    """The deflate surface's level and chunk size reach the session (the
    JAX soak set them on the params object, where no field reads them)."""
    cases = [soak.deflate_case(rng) for _it, _s, rng, *_r, surface
             in soak.iterations(0, 40) if surface == 0]
    assert len({c[0] for c in cases}) > 3 and len({c[2] for c in cases}) > 2
    level, fmt, hw = cases[0]
    s = soak.deflate_session("cpu", level, fmt, hw)
    assert (s.common.comp_lvl, s.common.hw_buff_sz, s.data_fmt) == (
        level, hw, fmt)


# -- decprof and ratiocheck ------------------------------------------------------

def test_decprof_on_the_cpu(capsys):
    assert decprof.main(["--device", "cpu", "--mb", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "card: none (--device cpu)"
    assert lines[1].startswith("corpus 2 MB -> blob ")
    assert lines[2] == "members: 32"
    for i, stage in enumerate(("scan_gzipext:", "inflate_batch_bytes:",
                               "crc_combine_many:", "e2e decompress:",
                               "unaccounted:")):
        assert lines[3 + i].startswith(stage) and " ms" in lines[3 + i]
    threads = [int(re.search(r"nthreads=(\d+)", ln).group(1))
               for ln in lines if "inflate nthreads=" in ln]
    assert threads == [1, 2, 4, 8, 16, 32]
    groups = [ln for ln in lines if ln.lstrip().startswith("members [")]
    assert len(groups) == 8 and all("1-thread" in ln for ln in groups)
    assert len(lines) == 8 + 6 + 8


def test_ratiocheck_packs_the_token_paths_payloads(monkeypatch):
    """At the engine's level-1 knobs the tool's rows are the CPU token
    path's payloads (mode 0, final), which tests/test_torch_session.py
    holds to the JAX package; its ratio is theirs."""
    kept = {}

    def keep(data, **kw):
        kept["rows"], kept["payloads"] = data, real(data, **kw)
        return kept["payloads"]
    real = ratiocheck.row_payloads
    monkeypatch.setattr(ratiocheck, "row_payloads", keep)
    line = ratiocheck.main(["--device", "cpu", "--mb", "1", "--search-seg",
                            "8192", "--search-overlap", "896", "--ctx", "3",
                            "--probes", "7"])
    rows = [r.tobytes() for r in kept["rows"]]
    assert len(rows) == 16
    monkeypatch.setattr(CudaEngine, "packs_on_device",
                        lambda self, static, algorithm="deflate": False)
    want = [p for p, _c in CudaEngine("cpu").compress_chunks(rows, level=1)]
    assert kept["payloads"] == want
    total = sum(len(p) for p in want)
    assert line == {
        "corpus": "mixed", "ctx": 3, "seg": 8192, "probes": 7,
        "search_seg": 8192, "search_overlap": 896, "mb": 1,
        "ratio": round(16 * 65536 / total, 4),
        "zlib_l1_ratio": line["zlib_l1_ratio"],
        "vs_zlib_l1": line["vs_zlib_l1"]}
    zl = sum(len(zlib.compress(r, 1)) for r in rows)
    assert line["zlib_l1_ratio"] == round(16 * 65536 / zl, 4)


def test_ratiocheck_strided_corpus_is_the_jax_tools():
    spec = importlib.util.spec_from_file_location(
        "jax_ratiocheck", os.path.join(REPO, "tools", "ratiocheck.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = ratiocheck.strided_corpus(1)
    assert len(got) == 1 << 20 and got == mod.strided_corpus(1)


def test_decprof_and_ratiocheck_import_no_jax(programs):
    rc, out, err = _finished(programs["imports"])
    assert rc == 0 and out.strip() == "[]", err


# -- against the JAX package -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_qztest():
    spec = importlib.util.spec_from_file_location(
        "jax_qztest", os.path.join(REPO, "tools", "qztest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sz,seed", [(0, 0), (1, 0), (255, 1), (16384, 0),
                                     (65536, 3), (100001, 7)])
def test_gen_random_data_matches_jax(jax_qztest, sz, seed):
    got = qztest.gen_random_data(sz, seed=seed)
    assert got == jax_qztest.gen_random_data(sz, seed=seed)
    # under 512 bytes the reference's repeat falls short, in both copies
    assert len(got) == sz or sz < 512


@pytest.mark.parametrize("field,value", qztest.BAD_PARAMS)
def test_mode6_bad_params_match_jax(field, value):
    jp = jparams.SessionParamsDeflate()
    setattr(jp.common, field, value)
    p = qz.SessionParamsDeflate()
    setattr(p.common, field, value)
    want = jsession.QzSession().setup_deflate(jp)
    assert want != QZ_OK
    assert qz.QzSession("cpu").setup_deflate(p) == want


class _Padded:
    """The JAX engine with each call's chunks padded to 13 (a tile of the
    (16, 16384) bucket that tests/test_torch_session.py compiles); rows
    are independent, so the first results are the request's own."""

    def __init__(self, engine):
        self.engine = engine

    def compress_chunks(self, chunks, *, final_flags, **kw):
        pad = 13 - len(chunks)
        got = self.engine.compress_chunks(
            list(chunks) + [chunks[0]] * pad,
            final_flags=list(final_flags) + [True] * pad, **kw)
        return got[:len(chunks)]


def test_mode4_request_matches_jax(monkeypatch):
    """``-m 4``'s request (16 KiB, seed 0) on the port's CPU session, as
    ``qztest`` sets it up, against the JAX codec on the token path."""
    monkeypatch.setenv("QZTPU_DEVICE_PACK", "0")
    args = argparse.Namespace(
        algorithm="deflate", level_arg=1, chunk=65536, fmt=None,
        device="cpu")
    data = qztest.gen_random_data(16384, seed=0)
    got = qztest.make_session(args).compress(data)
    jp = jparams.SessionParamsDeflate()
    want, _crc = jcodec.compress_buffer(
        data, algorithm="deflate", data_fmt=jp.data_fmt, level=1,
        hw_buff_sz=65536,
        engine=_Padded(TpuEngine([jax.devices("cpu")[0]], "deflate")),
        sw_backup=1, input_sz_thrshold=jp.common.input_sz_thrshold)
    assert got == want
    assert zlib.decompressobj(31).decompress(got) == data
