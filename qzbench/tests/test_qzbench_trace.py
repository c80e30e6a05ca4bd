"""The trace's reduction on synthetic spans and device events: busy and
idle shares, gaps and their labels, a layer's self time, the metrics
that read them."""

import pytest

from qzbench import harness, trace

MS = 1_000_000


def _spans(records):
    s = trace.Spans()
    s.records = list(records)
    return s


def test_union_clips_merges_and_finds_gaps():
    covered, gaps = trace.union([(0, 10), (5, 20), (30, 40), (38, 60),
                                 (70, 80)], 10, 75)
    assert covered == 10 + 30 + 5
    assert gaps == [(20, 30), (60, 70)]
    assert trace.union([], 0, 10) == (0, [(0, 10)])


def test_device_window_busy_idle_and_times():
    events = [("kern_a", 0, 0, 4 * MS), ("Memcpy HtoD (Pageable -> Device)",
                                          0, 6 * MS, 7 * MS),
              ("kern_b", 1, 2 * MS, 10 * MS), ("spin_kernel", 0, 1, 2),
              ("late", 0, 20 * MS, 30 * MS)]
    w = trace.DeviceWindow(events, 1 * MS, 9 * MS, [0, 1])
    assert w.window_s == pytest.approx(0.008)
    # card 0: [1, 4] and [6, 7] = 4 ms; card 1: [2, 9] = 7 ms
    assert w.busy_s() == pytest.approx(0.0055)
    assert w.time_s(trace.is_copy) == pytest.approx(0.001)
    assert w.time_s(lambda n: not trace.is_copy(n)) == pytest.approx(0.010)
    assert w.started(lambda n: n == "kern_b") == (1, pytest.approx(0.008))
    run = harness.Run(0.0, 1.0, [], device=w, profiled=2.0)
    assert harness.reader("device_idle_pct").read(run) == pytest.approx(
        100 * (1 - 0.0055 / 0.008))
    assert harness.reader("copy_ms").read(run) == pytest.approx(0.5)


def test_idle_gaps_take_the_innermost_span():
    spans = _spans([("request", 1, 0, 100), ("compress_chunks", 1, 10, 90),
                    ("stage", 2, 20, 40), ("finish", 1, 60, 80)])
    got = trace.label_gaps([(25, 35), (65, 67), (45, 55), (95, 99),
                            (200, 210)], spans, offset_ns=0)
    assert got == pytest.approx({"stage": 10e-9, "finish": 2e-9,
                                 "compress_chunks": 10e-9, "request": 4e-9,
                                 "between_requests": 10e-9})
    # the device clock ahead of the host's by the offset
    assert trace.label_gaps([(125, 135)], spans, offset_ns=100) == \
        pytest.approx({"stage": 10e-9})


def test_self_time_and_per_request_spans():
    spans = _spans([("request", 1, 0, 100 * MS),
                    ("compress_chunks", 1, 10 * MS, 90 * MS),
                    ("request", 2, 0, 50 * MS),
                    ("compress_chunks", 2, 5 * MS, 45 * MS),
                    ("stage", 3, 0, 30 * MS), ("stage", 4, 0, 30 * MS)])
    run = harness.Run(0.0, 1.0, [], spans=spans)
    # (150 - 120) ms outside compress_chunks over 2 requests
    assert harness.reader("session_ms").read(run) == pytest.approx(15.0)
    assert harness.reader("stage_ms").read(run) == pytest.approx(30.0)
    assert harness.reader("finish_ms").read(run) is None


def test_wrappers_time_every_thread_and_come_out_again():
    import threading

    class Owner:
        def work(self, x):
            return x + 1
    spans = trace.Spans()
    target = {"work": (f"{__name__}:Owner.work",)}
    globals()["Owner"] = Owner
    undo = trace.install(target, spans)
    ts = [threading.Thread(target=lambda: Owner().work(1)) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert Owner().work(2) == 3 and spans.count("work") == 5
    undo()
    assert not hasattr(Owner.work, "__wrapped__")


def test_roofline_share_uses_each_kernels_mean_bound():
    rls = harness.rooflines()
    args = (1, 2, 3, 256, 65536, 0)          # symbol_histogram, one tile
    events = [("hist_kernel(int const*)", 0, i * MS, i * MS + 100_000)
              for i in range(4)] + [("other_kernel", 0, 0, MS)]
    w = trace.DeviceWindow(events, 0, 10 * MS, [0])
    run = harness.Run(0.0, 1.0, [], device=w, profiled=1.0,
                      launches={"symbol_histogram": [args] * 3},
                      rooflines=rls, peaks=harness.peaks())
    bound = rls["symbol_histogram"].count(args)[0] / 3.35e12
    assert harness.reader("kernel_roofline_pct").read(run) == pytest.approx(
        100 * bound / 100e-6)
    assert harness.reader("torch_ops_ms").read(run) == pytest.approx(1.0)
