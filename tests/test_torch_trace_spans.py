"""The port's span recorder (``qatzip_tpu_torch/utils/trace.py``) on the
CPU: off it records nothing, its counts still reach the service counters
and ``stage`` keeps its two counters; it reads torch's profiler flag; on
(``enable()`` or ``qz_trace``) a compress records the dispatch's spans
with one request id, parents around their children and starts on the
host's wall clock; the request id crosses to another thread the way
``Mesh.map`` carries it; a span's counts reach the service counters;
the LZ4 device pack counts the rows the host codes again."""

import concurrent.futures as fut
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import qatzip_tpu_torch as qz
from qatzip_tpu_torch.parallel.dispatch import CudaEngine
from qatzip_tpu_torch.utils import debug, trace

TEXT = b"the quick brown fox jumps over the lazy dog, again and again. " * 1200
NOISE = np.random.default_rng(7).integers(0, 256, 65536, np.uint8).tobytes()
DATA = TEXT[:65536] * 3 + NOISE + TEXT[:30000]

#: the spans of each route on the CPU (no hist_wait: pass 1's
#: histograms are on the host at once there)
ROUTE_SPANS = {
    "token": {"compress", "upload", "fetch", "pool_wait"},
    "deflate-device": {"compress", "device_pack", "upload", "dyn_plan",
                       "finish", "fetch", "pool_wait"},
    "lz4-device": {"compress", "device_pack", "upload", "finish", "fetch",
                   "pool_wait"},
}


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    yield
    trace.disable()


def _mine():
    tid = threading.get_ident()
    return dict(debug.get_counters().snapshot().get(tid, {}))


def _diff(a, b):
    return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}


def _session(route, monkeypatch):
    if route != "token":
        monkeypatch.setattr(CudaEngine, "packs_on_device",
                            lambda self, s, algorithm="deflate": True)
    sess = qz.QzSession(device="cpu")
    if route.startswith("lz4"):
        sess.setup_lz4()
    else:
        sess.setup_deflate()
    return sess


def test_off_span_records_nothing_and_stage_keeps_its_two_counters():
    before = _mine()
    with trace.span("upload", h2d_bytes=5) as sp:
        sp.add(h2d_bytes=7)
    with trace.stage("span_probe"):
        pass
    assert trace.spans() == []
    d = _diff(before, _mine())
    assert set(d) == {"h2d_bytes", "stage_span_probe", "stage_span_probe_us"}
    assert (d["h2d_bytes"], d["stage_span_probe"]) == (12, 1)


def test_the_recorder_reads_torchs_profiler_flag():
    """The flag ``span`` reads while off is torch's own, and it follows a
    running profiler; so does the C call the recorder falls back on."""
    import torch.autograd.profiler as tap
    assert hasattr(tap, "_is_profiler_enabled")
    assert not trace._profiling()
    assert not torch._C._autograd._profiler_enabled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace._profiling() and tap._is_profiler_enabled
        assert torch._C._autograd._profiler_enabled()
        with trace.span("upload") as sp:
            assert isinstance(sp, trace.Span)
    assert not trace._profiling()
    assert [s.name for s in trace.spans()] == ["upload"]


def _check_request(spans, names):
    assert {s.name for s in spans} == names
    (root,) = [s for s in spans if s.name == "compress"]
    assert root.parent is None and root.request == root.id
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.request == root.id
        if s is not root:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    return root


@pytest.mark.parametrize("route", sorted(ROUTE_SPANS))
def test_enable_records_the_dispatch_spans_of_a_request(route, monkeypatch):
    sess = _session(route, monkeypatch)
    sess.compress(DATA)
    trace.enable()
    t0 = time.time_ns()
    sess.compress(DATA)
    t1 = time.time_ns()
    spans = trace.spans()
    root = _check_request(spans, ROUTE_SPANS[route])
    assert t0 <= root.start_ns <= root.end_ns <= t1 + 1_000_000
    assert root.counts == {}
    by = {s.name: s for s in spans}
    if "device_pack" in by:
        assert by["device_pack"].counts == {}
        assert by["finish"].counts.get("lz4_rows", 5) == 5
        assert by["fetch"].parent == by["finish"].id
        assert by["pool_wait"].parent == by["finish"].id
        assert by["upload"].parent == by["device_pack"].id
    else:
        assert by["fetch"].parent == root.id

    def total(name, count):
        return sum(s.counts[count] for s in spans if s.name == name)
    assert total("upload", "h2d_bytes") >= len(DATA)
    assert total("fetch", "d2h_bytes") > 0
    trace.disable()
    assert trace.spans() == []
    sess.compress(DATA)
    assert trace.spans() == []


def test_qz_trace_records_spans_and_puts_them_in_the_chrome_trace(
        tmp_path, monkeypatch):
    sess = _session("deflate-device", monkeypatch)
    sess.compress(DATA)
    d = str(tmp_path / "trace")
    with trace.qz_trace(d):
        sess.compress(DATA)
    _check_request(trace.spans(), ROUTE_SPANS["deflate-device"])
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"compress", "device_pack", "finish", "dyn_plan"} <= events
    # the profiler stopped: recording stopped with it
    n = len(trace.spans())
    sess.compress(DATA)
    assert len(trace.spans()) == n


def test_the_request_id_crosses_to_a_pool_thread_as_mesh_map_carries_it():
    trace.enable()
    pool = fut.ThreadPoolExecutor(2)

    def share(k):
        with trace.span("device_pack", tiles=k):
            return threading.get_ident()
    with trace.span("compress"):
        with trace.span("finish"):
            tids = [f.result() for f in
                    [trace.submit(pool, share, k) for k in (1, 2)]]
        bare = pool.submit(share, 3).result()
    pool.shutdown()
    spans = {(s.name, s.counts.get("tiles")): s for s in trace.spans()}
    root = spans[("compress", None)]
    fin = spans[("finish", None)]
    for k, tid in zip((1, 2), tids):
        s = spans[("device_pack", k)]
        assert (s.request, s.parent, s.thread) == (root.id, fin.id, tid)
        assert tid != threading.get_ident()
    # a thread pool alone does not carry it: a new request there
    lone = spans[("device_pack", 3)]
    assert lone.parent is None and lone.request == lone.id
    assert lone.thread == bare


def test_span_counts_reach_the_service_counters():
    before = _mine()
    trace.enable()
    with trace.span("upload", h2d_bytes=10) as sp:
        sp.add(h2d_bytes=5, lz4_recoded=2)
    assert _diff(before, _mine()) == {"h2d_bytes": 15, "lz4_recoded": 2}
    (s,) = trace.spans()
    assert s.counts == {"h2d_bytes": 15, "lz4_recoded": 2}
    assert s.end_ns >= s.start_ns


def test_lz4_device_pack_counts_the_rows_the_host_codes_again(monkeypatch):
    monkeypatch.setattr(CudaEngine, "packs_on_device",
                        lambda self, s, algorithm="deflate": True)
    eng = CudaEngine(torch.device("cpu"))
    chunks = [TEXT[:65536], NOISE, b"", TEXT[:1000], NOISE[:9000]]
    want = eng.compress_chunks(chunks, level=1, algorithm="lz4")
    before = _mine()
    trace.enable()
    got = eng.compress_chunks(chunks, level=1, algorithm="lz4")
    assert got == want
    (fin,) = [s for s in trace.spans() if s.name == "finish"]
    # the noise rows (a literal run over 270 bytes) and the empty one
    assert fin.counts == {"lz4_rows": 5, "lz4_recoded": 3}
    d = _diff(before, _mine())
    assert (d["lz4_rows"], d["lz4_recoded"]) == (5, 3)


def test_threads_record_every_span_and_count_every_byte():
    """More threads than cores open nested spans at once with a short
    switch interval: no span, id or count is lost."""
    import sys
    threads, each = 2 * (os.cpu_count() or 4), 200
    before = sum(c.get("h2d_bytes", 0)
                 for c in debug.get_counters().snapshot().values())
    trace.enable()

    def work():
        for _ in range(each):
            with trace.span("compress"):
                with trace.span("upload", h2d_bytes=3):
                    pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    spans = trace.spans()
    assert len(spans) == 2 * threads * each
    assert len({s.id for s in spans}) == len(spans)
    roots = {s.id: s for s in spans if s.name == "compress"}
    for s in spans:
        if s.name == "upload":
            assert roots[s.parent].thread == s.thread
            assert s.request == s.parent
    after = sum(c.get("h2d_bytes", 0)
                for c in debug.get_counters().snapshot().values())
    assert after - before == 3 * threads * each
