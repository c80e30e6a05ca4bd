"""What a traced run (``--trace 1``) records, and its reduction.

* Spans: the benchmark's own wrappers around the program's functions,
  installed for the traced run only and taken out after it. A metric's
  file names its wrap points (``WRAPS``: label -> ``"module:Owner.attr"``);
  a wrapper times each call on its thread and changes no byte. Calls on
  several threads (a ``MeshEngine``'s shares, the client threads) each
  count, so a label's total is summed over them.
* Launches: each hand kernel's launch arguments, recorded by a stand-in
  for the kernel extension module (``ops/cuda_pack._ext``) for the kernels
  that have a file in ``roofline/``.
* Device activity: ``torch.profiler`` over the whole window, CUDA
  activity only; the metrics read the middle half of the window (from a
  quarter to three quarters of ``--seconds`` after its start), which is
  steady. The host's clock is put on the device's by a marker kernel
  timed while the card is idle.
"""

from __future__ import annotations

import importlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: the marker kernel (``torch.cuda._sleep``) and its profiler name
MARKER = "spin_kernel"


class Spans:
    """Spans of every thread: (label, thread, start ns, end ns) on the
    host's wall clock (``time.time_ns``), durations by
    ``perf_counter_ns``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.records: List[Tuple[str, int, int, int]] = []

    def add(self, label: str, start_ns: int, dur_ns: int) -> None:
        rec = (label, threading.get_ident(), start_ns, start_ns + dur_ns)
        with self._lock:
            self.records.append(rec)

    def total_s(self, label: str) -> float:
        return sum(e - s for lab, _, s, e in self.records if lab == label) / 1e9

    def count(self, label: str) -> int:
        return sum(lab == label for lab, *_ in self.records)

    def timed(self, label: str, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            w0 = time.time_ns()
            p0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(label, w0, time.perf_counter_ns() - p0)
        wrapper.__wrapped__ = fn
        return wrapper


def _resolve(target: str):
    """(owner object, attribute name) of ``"module:Owner.attr"``."""
    modname, path = target.split(":")
    owner = importlib.import_module(modname)
    *owners, name = path.split(".")
    for o in owners:
        owner = getattr(owner, o)
    return owner, name


def install(points: Dict[str, Sequence[str]], spans: Spans) -> Callable:
    """Wrap every target of ``points`` (label -> targets) with a span;
    returns the function that takes the wrappers out again."""
    undo = []
    for label, targets in points.items():
        for target in sorted(set(targets)):
            owner, name = _resolve(target)
            fn = owner.__dict__[name] if isinstance(owner, type) else \
                getattr(owner, name)
            setattr(owner, name, spans.timed(label, fn))
            undo.append((owner, name, fn))

    def restore():
        for owner, name, fn in reversed(undo):
            setattr(owner, name, fn)
    return restore


class LaunchRecorder:
    """Stands in for the kernel extension module: passes every call on,
    and records the integer arguments of each launch of ``kernels``."""

    def __init__(self, ext, kernels: Sequence[str]):
        self._ext = ext
        self._kernels = set(kernels)
        self.launches: Dict[str, List[tuple]] = {k: [] for k in kernels}

    def __getattr__(self, name):
        attr = getattr(self._ext, name)
        if name not in self._kernels:
            return attr
        rec = self.launches[name]

        def launch(*args):
            rec.append(args)        # list.append holds the interpreter lock
            return attr(*args)
        return launch


def install_launches(kernels: Sequence[str]):
    """Put a ``LaunchRecorder`` in place of the loaded kernel module.
    Returns (recorder, restore)."""
    from qatzip_tpu_torch.ops import cuda_pack
    ext = cuda_pack.kernels()
    rec = LaunchRecorder(ext, kernels)
    cuda_pack._ext = rec

    def restore():
        cuda_pack._ext = ext
    return rec, restore


# ---------------------------------------------------------------------------
# the device's activity
# ---------------------------------------------------------------------------

def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    if what == "start":
        return int(e.start_us() * 1000)
    return int((e.start_us() + e.duration_us()) * 1000)


def device_events(prof) -> List[Tuple[str, int, int, int]]:
    """(name, device index, start ns, end ns) of every device activity in
    a finished ``torch.profiler.profile``."""
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        out.append((e.name(), int(e.device_index()), _ns(e, "start"),
                    _ns(e, "end")))
    return out


def union(intervals: Sequence[Tuple[int, int]], a: int, b: int):
    """(covered length, gaps) of ``intervals`` clipped to [a, b]; gaps
    are the uncovered (start, end) pieces of [a, b], in order."""
    covered = 0
    gaps = []
    cur = a
    for s, e in sorted(intervals):
        s, e = max(s, a), min(e, b)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            covered += e - max(s, cur)
            cur = e
    if cur < b:
        gaps.append((cur, b))
    return covered, gaps


class DeviceWindow:
    """The device activity of the analysed interval [a, b] (device clock,
    ns) over ``devices`` (indices)."""

    def __init__(self, events, a: int, b: int, devices: Sequence[int]):
        self.a, self.b = a, b
        self.devices = list(devices)
        self.events = [ev for ev in events
                       if ev[0].find(MARKER) < 0 and ev[3] > a and ev[2] < b]

    @property
    def window_s(self) -> float:
        return (self.b - self.a) / 1e9

    def busy(self, dev: int):
        return union([(s, e) for _, d, s, e in self.events if d == dev],
                     self.a, self.b)

    def busy_s(self) -> float:
        """Seconds in which an operation ran, averaged over the devices."""
        return (sum(self.busy(d)[0] for d in self.devices)
                / len(self.devices) / 1e9)

    def time_s(self, keep: Callable[[str], bool]) -> float:
        """Device seconds of the activities ``keep`` takes, clipped to the
        interval and summed over the devices."""
        return sum(min(e, self.b) - max(s, self.a)
                   for name, _, s, e in self.events if keep(name)) / 1e9

    def started(self, keep: Callable[[str], bool]):
        """(count, whole seconds) of the activities ``keep`` takes that
        start inside the interval."""
        sel = [e - s for name, _, s, e in self.events
               if keep(name) and self.a <= s < self.b]
        return len(sel), sum(sel) / 1e9


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def label_gaps(gaps, spans: Spans, offset_ns: int) -> Dict[str, float]:
    """Idle seconds by what the host was doing at each gap's middle: the
    innermost span (the shortest) that covers it on any thread, or
    ``between_requests``."""
    recs = sorted(spans.records, key=lambda r: r[2])
    out: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2 - offset_ns
        best: Optional[Tuple[int, str]] = None
        for lab, _, rs, re_ in recs:
            if rs > mid:
                break
            if re_ >= mid and (best is None or re_ - rs < best[0]):
                best = (re_ - rs, lab)
        lab = best[1] if best else "between_requests"
        out[lab] = out.get(lab, 0.0) + (e - s) / 1e9
    return out


class Profiler:
    """``torch.profiler`` over the window, CUDA activity only, started
    and stopped on one thread."""

    def __init__(self, devices: Sequence[int]):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.devices = list(devices)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.host_mark = 0

    def start(self) -> None:
        """Start, then time the marker kernel on the idle card: its start
        on the device clock, set against the host's clock just before its
        launch, gives the offset of the two clocks."""
        torch = self.torch
        self.prof.start()
        for d in self.devices:
            torch.cuda.synchronize(d)
        self.host_mark = time.time_ns()
        torch.cuda._sleep(1)
        torch.cuda.synchronize(self.devices[0])

    def stop(self) -> Tuple[list, int]:
        """Stop; returns (device events, offset: device ns - host ns)."""
        for d in self.devices:
            self.torch.cuda.synchronize(d)
        self.prof.stop()
        events = device_events(self.prof)
        marks = [s for name, _, s, _ in events if MARKER in name]
        offset = (min(marks) - self.host_mark) if marks else 0
        return events, offset
