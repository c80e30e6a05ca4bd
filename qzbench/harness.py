"""One run of one cell: set-up, the measured window, the reference's
judgement, the metrics.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json`` names the configuration (``configs/<config>.json``) and
the traffic mix (``traffic/<traffic>.json``, which names its generator
``traffic/<generator>.py``); each metric of the cell has its reader
``metrics/<name up to the first dot>.py``; each hand kernel its roofline
count ``roofline/<kernel>.py``. A new cell, configuration, mix,
generator, metric or kernel is a new file and a new entry, and no edit
here.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import reference, trace, traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may load (compared whole: the
#: port's own name begins with the JAX package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qatzip_tpu", "bench",
                       "chip_smoke", "tests"})
#: every number compared has the limit 0: exact comparisons
LIMITS = {k: 0 for k in (*reference.COUNTS, "errors", "off_engine",
                         "route_short")}
#: processes that read the answers back after the window
JUDGE_WORKERS = min(8, os.cpu_count() or 1)
#: the analysed part of a traced window, as shares of ``--seconds``
TRACE_FROM, TRACE_TO = 0.25, 0.75


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(name: str, bench: Optional[Dict] = None,
              root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration's file,
    its traffic mix, and the metrics it reports (an end-to-end metric
    without ``workloads`` in every cell; a per-layer one in the cells its
    ``workloads`` lists, or without the key in every cell that reports
    the end-to-end metric it moves)."""
    bench = bench if bench is not None else load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        cfg = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name, cfg, traffic.load(entry["traffic"]), entry["chips"],
                e2e, layer)


def reader(metric: str):
    return importlib.import_module(f"qzbench.metrics.{metric.split('.')[0]}")


def rooflines() -> Dict[str, object]:
    names = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "roofline"))
                   if f.endswith(".py") and not f.startswith("_"))
    return {k: importlib.import_module(f"qzbench.roofline.{k}")
            for k in names}


def peaks() -> Dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclass
class Request:
    client: int
    key: int
    data: bytes
    out: Optional[bytes]
    p0: int            # perf_counter_ns when due: latency counts from it
    ps: int            # perf_counter_ns at submission
    p1: int            # perf_counter_ns at return
    w0: int            # time_ns at submission
    err: Optional[str] = None

    @property
    def bytes_in(self) -> int:
        return len(self.data)

    @property
    def bytes_out(self) -> int:
        return len(self.out) if self.out is not None else 0

    @property
    def latency_s(self) -> float:
        return (self.p1 - self.p0) / 1e9


@dataclass
class Run:
    """What a metric's reader reads."""
    setup_s: float
    window_s: float
    requests: List[Request]
    spans: Optional[trace.Spans] = None
    device: Optional[trace.DeviceWindow] = None
    profiled: float = 0.0
    launches: Dict[str, List[tuple]] = field(default_factory=dict)
    rooflines: Dict[str, object] = field(default_factory=dict)
    peaks: Dict = field(default_factory=dict)

    def per_request_ms(self, label: str) -> Optional[float]:
        """A span label's seconds per request of the window, in ms."""
        if not self.spans or not self.spans.count(label):
            return None
        return self.spans.total_s(label) / self.spans.count("request") * 1e3

    def hand_kernel(self, name: str) -> bool:
        return any(m.matches(name) for m in self.rooflines.values())

    def bound_s(self, kernel: str, args) -> float:
        nbytes, ops = self.rooflines[kernel].count(args)
        return max(nbytes / self.peaks["hbm_bytes_per_s"],
                   ops / self.peaks["ops_per_s"])


def _sync(torch, devs) -> None:
    for d in devs:
        torch.cuda.synchronize(d)


def _wrap_points(cell: Cell) -> Dict[str, set]:
    """The wrap points the cell's per-layer metrics name, by label."""
    points: Dict[str, set] = {}
    for m in cell.per_layer:
        for label, targets in getattr(reader(m["name"]), "WRAPS", {}).items():
            points.setdefault(label, set()).update(targets)
    return points


def _window(sessions, tr, seconds: float, spans: Optional[trace.Spans],
            prof) -> Tuple[List[Request], float, int]:
    """Every client sends the requests of its schedule for ``seconds``:
    each when it is due, or, where it has no time, when the client's
    previous request has returned. Returns the requests in order of
    submission, set-up's end (perf_counter) and the window's start on the
    wall clock (time_ns)."""
    records: List[List[Request]] = [[] for _ in sessions]
    gate = threading.Barrier(len(sessions) + 1)
    start_ns, end_ns = [0], [0]

    def client(j: int) -> None:
        sess, recs = sessions[j], records[j]
        plan = tr.schedule(j)
        gate.wait()
        for key, data, at in plan:
            now = time.perf_counter_ns()
            due = now if at is None else start_ns[0] + int(at * 1e9)
            if max(now, due) >= end_ns[0]:
                return
            if due > now:
                time.sleep((due - now) / 1e9)
            ps = time.perf_counter_ns()
            w0 = time.time_ns()
            try:
                out, err = sess.compress(data), None
            except Exception as e:  # noqa: BLE001 - a failed request
                out, err = None, f"{type(e).__name__}: {e}"
            p1 = time.perf_counter_ns()
            recs.append(Request(j, key, data, out, min(due, ps), ps, p1, w0,
                                err))
            if spans is not None:
                spans.add("request", w0, p1 - ps)

    threads = [threading.Thread(target=client, args=(j,), daemon=True)
               for j in range(len(sessions))]
    for t in threads:
        t.start()
    if prof is not None:
        prof.start()
    setup_end = time.perf_counter()
    w_start = time.time_ns()
    start_ns[0] = time.perf_counter_ns()
    end_ns[0] = start_ns[0] + int(seconds * 1e9)
    gate.wait()
    for t in threads:
        t.join()
    reqs = sorted((r for rs in records for r in rs), key=lambda r: r.p0)
    return reqs, setup_end, w_start


def _engine_checks(cfg: Dict, before: Dict, after: Dict,
                   reqs: List[Request], cards: int) -> Dict:
    """``off_engine``: requests the engine's ``hw_compress`` counter did
    not count, and any the host coder served; ``route_short``: the
    launches of the route's kernels short of those that every request
    makes when all of it is served on the cards (``sut.route_launches``),
    for the kernel that fell shortest."""
    from . import sut

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)
    want = sum(sut.route_launches(cfg, r.bytes_in, cards) for r in reqs)
    return {"off_engine": max(0, len(reqs) - delta("hw_compress"))
            + delta("sw_compress"),
            "route_short": max([max(0, want - delta(f"launches.{k}"))
                                for k in cfg.get("route_kernels", ())] or [0])}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *,
             t_process: float, device=None, make_session: Callable = None,
             check_engine: bool = True):
    """Run ``cell`` once. Returns (the result line's object, the numbers
    compared, details for standard error). ``device`` overrides the
    configuration's (the CPU tests), ``make_session`` puts another system
    in the program's place (the control), ``check_engine`` False leaves
    out the program's counters (neither the control nor the CPU counts
    launches)."""
    import torch
    from . import sut
    cfg = cell.config
    make_session = make_session or sut.make_session
    device = cfg["device"] if device is None else device
    tr = traffic.make(cell.traffic, seed)
    sessions = [make_session(cfg, device) for _ in range(tr.clients)]
    cuda = [d.index for d in getattr(sessions[0], "devices", ())
            if d.type == "cuda"]
    if check_engine and cuda and len(cuda) != cell.chips:
        raise RuntimeError(f"the session runs on {len(cuda)} cards, the "
                           f"cell asks for {cell.chips}")
    for j, sess in enumerate(sessions):
        sess.compress(tr.warmup(j))
    _sync(torch, cuda)

    rls = rooflines()
    spans = prof = rec = None
    undo = []
    if traced:
        spans = trace.Spans()
        undo.append(trace.install(_wrap_points(cell), spans))
        if cuda:
            rec, restore = trace.install_launches(list(rls))
            undo.append(restore)
            prof = trace.Profiler(cuda)
    before = sut.engine_counts() if check_engine else {}
    reqs, setup_end, w_start = _window(sessions, tr, seconds, spans, prof)
    events, offset = prof.stop() if prof is not None else ([], 0)
    after = sut.engine_counts() if check_engine else {}
    for u in reversed(undo):
        u()
    peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)
    kind = torch.cuda.get_device_name(cuda[0]) if cuda else "cpu"
    del sessions
    if cuda:
        torch.cuda.empty_cache()

    done = [r for r in reqs if r.out is not None]
    t_ref = time.perf_counter()
    checks, wrong = reference.judge(
        sut.reference_format(cfg), cfg["session"]["hw_buff_sz"],
        [(r.key, r.data, r.out) for r in done], JUDGE_WORKERS)
    ref_s = time.perf_counter() - t_ref
    checks["errors"] = len(reqs) - len(done)
    checks.update(_engine_checks(cfg, before, after, reqs, len(cuda))
                  if check_engine else {"off_engine": 0, "route_short": 0})
    failed = min(len(reqs), checks["errors"] + sum(wrong)
                 + checks["off_engine"] + checks["route_short"])
    correct = bool(reqs) and all(checks[k] <= LIMITS[k] for k in checks)

    window_s = ((max(r.p1 for r in reqs) - min(r.p0 for r in reqs)) / 1e9
                if reqs else 0.0)
    run = Run(setup_end - t_process, window_s, done, spans=spans,
              launches=rec.launches if rec is not None else {},
              rooflines=rls, peaks=peaks())
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": len(cuda) or 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(reqs), "failed": failed,
              "metrics": {}, "device": dev}
    if events:
        ha = w_start + int(TRACE_FROM * seconds * 1e9)
        hb = w_start + int(TRACE_TO * seconds * 1e9)
        run.device = trace.DeviceWindow(events, ha + offset, hb + offset,
                                        cuda)
        for r in done:
            w1 = r.w0 + (r.p1 - r.ps)
            if w1 > r.w0:
                run.profiled += (max(0, min(w1, hb) - max(r.w0, ha))
                                 / (w1 - r.w0))
        dev["busy_s"] = run.device.busy_s()
        dev["window_s"] = run.device.window_s
        result["breakdown"] = _breakdown(run.device, spans, offset)
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(m["name"]).read(run)
        if v is not None:
            result["metrics"][m["name"]] = {"value": float(v),
                                            "unit": m["unit"]}
    return result, checks, _info(cell, seed, traced, run, reqs, ref_s,
                                 before, after)


def _info(cell, seed, traced, run: Run, reqs, ref_s, before, after) -> Dict:
    """A run's details for standard error: requests, latencies, the
    engine's counters, the reference's seconds."""
    lat = sorted(r.latency_s * 1e3 for r in run.requests)
    info = {"cell": cell.name, "seed": seed, "trace": int(traced),
            "requests": len(reqs), "window_s": run.window_s,
            "compress_gbps": (sum(r.bytes_in for r in run.requests)
                              / run.window_s / 1e9 if run.window_s else None),
            "latency_ms": {"mean": sum(lat) / len(lat) if lat else None,
                           "quartiles": ([lat[len(lat) // 4],
                                          lat[len(lat) // 2],
                                          lat[3 * len(lat) // 4]]
                                         if lat else None),
                           "max": lat[-1] if lat else None,
                           "first": [r.latency_s * 1e3 for r in reqs[:3]]},
            "setup_s": run.setup_s, "reference_s": ref_s,
            "profiled_requests": run.profiled,
            "engine": {k: after.get(k, 0) - before.get(k, 0)
                       for k in sorted(after)
                       if after.get(k, 0) != before.get(k, 0)}}
    first_err = next((r.err for r in reqs if r.err), None)
    if first_err:
        info["first_error"] = first_err
    return info


def _breakdown(window: trace.DeviceWindow, spans: trace.Spans,
               offset: int) -> Dict:
    """The device operations that took most time, and the idle gaps by
    what the host was doing, seconds averaged over the devices."""
    by_op: Dict[str, float] = {}
    for name, _, s, e in window.events:
        t = (min(e, window.b) - max(s, window.a)) / 1e9
        by_op[name] = by_op.get(name, 0.0) + t
    gaps: Dict[str, float] = {}
    for d in window.devices:
        for lab, secs in trace.label_gaps(window.busy(d)[1], spans,
                                          offset).items():
            gaps[lab] = gaps.get(lab, 0.0) + secs / len(window.devices)
    k = len(window.devices)

    def top(d):
        return [[n[:160], v] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top({n: v / k for n, v in by_op.items()}),
            "idle_gaps": top(gaps)}


def report(result: Dict, checks: Dict, info: Dict) -> str:
    """The result line, with the numbers compared under ``checks`` last;
    the same numbers, each beside its limit, go to stderr as its last
    lines."""
    sys.stderr.write("info " + json.dumps(info) + "\n")
    line = dict(result)
    line["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                      for k, v in checks.items()}
    for k, v in checks.items():
        sys.stderr.write(f"check {k} {v} limit {LIMITS[k]}\n")
    sys.stderr.flush()
    return json.dumps(line)
