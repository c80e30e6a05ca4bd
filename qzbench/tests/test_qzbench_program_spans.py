"""The dispatch layer's metrics that read the program's own spans
(``program_spans.py``, ``metrics/{upload,launch,hist_wait,fetch,
pool_wait}_ms.py``, ``metrics/recoded_pct.py``): their values from
synthetic program spans, None where the program records nothing or has
no recorder, a traced run in a copy of qzbench/ that reads them from the
program on the CPU, a ``--trace 0`` run that leaves the recorder off,
and, on the card, the recorder on under the benchmark's profiler."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from qzbench import harness

ROOT = harness.ROOT
MS = 1_000_000
NEW = {"upload_ms": 6.0, "launch_ms": 21.0, "hist_wait_ms": 4.0,
       "fetch_ms": 4.0, "pool_wait_ms": 24.0, "recoded_pct": 12.5}


def _span(name, sid, parent, request, a_ms, b_ms, **counts):
    from qatzip_tpu_torch.utils.trace import Span
    s = Span(name, counts)
    s.id, s.parent, s.request, s.thread = sid, parent, request, 1
    s.start_ns, s.end_ns = int(a_ms * MS), int(b_ms * MS)
    return s


def _request(t, base):
    """One request's spans, opened at ``t`` ms, ids from ``base``."""
    r = base
    return [
        _span("compress", r, None, r, t + 1, t + 99),
        _span("device_pack", r + 2, r, r, t + 3, t + 53),
        _span("upload", r + 3, r + 2, r, t + 4, t + 9, h2d_bytes=1),
        _span("hist_wait", r + 4, r + 2, r, t + 10, t + 14),
        _span("dyn_plan", r + 5, r + 2, r, t + 15, t + 35),
        _span("finish", r + 6, r, r, t + 55, t + 95, lz4_rows=256,
              lz4_recoded=32),
        _span("fetch", r + 7, r + 6, r, t + 56, t + 60, d2h_bytes=1),
        _span("pool_wait", r + 8, r + 6, r, t + 70, t + 94),
        # an upload outside the device pack (the token path's) is no
        # part of the launch time's children
        _span("upload", r + 9, r, r, t + 96, t + 97, h2d_bytes=1),
    ]


def _run(n=2):
    reqs = [harness.Request(0, 0, b"", b"", 0, k * 200 * MS,
                            k * 200 * MS + 100 * MS, k * 200 * MS)
            for k in range(n)]
    return harness.Run(0.0, 1.0, reqs)


@pytest.fixture()
def synthetic(monkeypatch):
    from qatzip_tpu_torch.utils import trace
    spans = _request(0, 100) + _request(200, 200)
    # outside the window (before the first submission, after the last
    # return): not read
    spans += _request(-150, 300) + _request(400, 400)
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return spans


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_reads_the_synthetic_program_spans(name, synthetic):
    assert harness.reader(name).read(_run()) == pytest.approx(NEW[name])


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_gives_none_without_program_spans(name, monkeypatch):
    from qatzip_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert harness.reader(name).read(_run()) is None
    # a program without the recorder (the parent of this change)
    monkeypatch.delattr(trace, "spans")
    assert harness.reader(name).read(_run()) is None


def test_every_new_metric_has_its_entry_and_layer():
    bench = harness.load_benchmark()
    got = {m["name"]: m for m in bench["per_layer"]
           if m["name"].split(".")[0] in NEW}
    assert len(got) == 11
    for m in got.values():
        # the small cell reports no compress_gbps end to end (PERF.md §2)
        moves = "ratio" if m["name"].endswith(".small") else "compress_gbps"
        assert (m["layer"], m["source"], m["moves"]) == (
            "dispatch", "program_span", moves)
        assert m["unit"] == ("%" if m["name"].startswith("recoded")
                             else "ms/req")


RUN_IN_COPY = '''
import dataclasses, json, sys
sys.path[:0] = [{copy!r}, {root!r}]
from qzbench import harness
assert harness.ROOT == {copy!r}, harness.ROOT
from qatzip_tpu_torch.parallel.dispatch import CudaEngine
from qatzip_tpu_torch.utils import trace
CudaEngine.packs_on_device = lambda self, s, algorithm="deflate": True
c = harness.load_cell({cell!r})
c = dataclasses.replace(c, traffic=dict(c.traffic, request_bytes=262144,
                                        buffers=2, buffer_bytes=262144))
r, k, i = harness.run_cell(c, 2**32 + 5, 0.5, False, t_process=0.0,
                           device="cpu", check_engine=False)
assert r["correct"], k
off = (trace._enabled, len(trace.spans()))
trace.enable()
r, k, i = harness.run_cell(c, 2**32 + 5, 0.5, True, t_process=0.0,
                           device="cpu", check_engine=False)
assert r["correct"], k
n = sum(s.name == "compress" for s in trace.spans())
print(json.dumps([off, i["requests"], n,
                  {{m: v["value"] for m, v in r["metrics"].items()}}]))
'''


@pytest.mark.parametrize("cell", ["deflate_l1.bulk64m", "lz4_l1.bulk64m"])
def test_a_traced_run_in_a_copy_reads_the_programs_spans(cell, tmp_path):
    """In a copy of qzbench/ and BENCHMARK.json, on the CPU with the
    device packs held (the card's route, the kernels' plain versions): a
    ``--trace 0`` run leaves the recorder off and empty; with the
    recorder on, a traced run's line has each of the cell's new metrics
    (``hist_wait`` only where pass 1's histograms travel to the host, on
    a card), read from the program's spans, one ``compress`` span a
    request and the warm-up's left out."""
    shutil.copytree(os.path.join(ROOT, "qzbench"), tmp_path / "qzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = RUN_IN_COPY.format(copy=str(tmp_path), root=ROOT, cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    off, requests, compress_spans, metrics = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert off == [False, 0]
    # the warm-up request is recorded too, before the window
    assert requests >= 1 and compress_spans == requests + 1
    want = {m["name"] for m in harness.load_cell(cell).per_layer
            if m["name"].split(".")[0] in NEW} - {"hist_wait_ms.bulk"}
    assert want and want <= set(metrics)
    assert all(metrics[m] >= 0 for m in want)


@pytest.mark.cuda
def test_spans_record_while_the_benchmarks_profiler_runs(card):
    """The benchmark's profiler (CUDA activity only) switches the
    program's recorder on, and its stop switches it off."""
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.utils import trace as ptrace
    from qzbench import corpus, trace
    ptrace.disable()
    sess = qz.QzSession(device="cuda:0")
    data = corpus.silesia_like(1 << 20, "spans")
    sess.compress(data)
    assert ptrace.spans() == []
    prof = trace.Profiler([0])
    prof.start()
    try:
        sess.compress(data)
    finally:
        prof.stop()
    spans = ptrace.spans()
    assert {s.name for s in spans} == {
        "compress", "device_pack", "upload", "hist_wait", "dyn_plan",
        "finish", "fetch", "pool_wait"}
    assert len({s.request for s in spans}) == 1
    sess.compress(data)
    assert len(ptrace.spans()) == len(spans)
