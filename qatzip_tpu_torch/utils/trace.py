"""Structured tracing: spans of the dispatch, torch.profiler traces and
named stage timers.

Counterpart of ``qatzip_tpu/utils/trace.py``, with one recorder: ``span``.

* ``span(name, **counts)`` marks a host step of a request. It records
  only while tracing is on: while a ``torch.profiler`` runs (``qz_trace``,
  ``QZTPU_TRACE``, any profiler of the caller's) or after ``enable()``.
  Off, it reads one flag and returns a shared context that does nothing.
  On, each span keeps its name, its request id and parent span, its
  thread, its start on the host's wall clock (``time.time_ns``) and its
  end as the start plus a ``perf_counter_ns`` duration, and its counts;
  under a running profiler it also marks its scope as a profiler event
  of its name, so a Chrome trace shows the span beside the kernels and
  copies it caused. A span's counts (given when it opens, or later
  through ``add``) are added to the service counters
  (``utils.debug.get_counters``) whether tracing is on or off. A span
  opened with no span open around it is the root of a request and gives
  the request its id (``QzSession.compress``); the spans inside it carry
  that id, also on the threads of a ``parallel.mesh.Mesh``, which runs
  each shard in a copy of the caller's context (``submit``). ``spans()``
  returns what was recorded (the last ``MAX_SPANS``); ``disable()`` stops
  recording and clears it.
* ``qz_trace`` records the enclosed scope with ``torch.profiler``: the
  host's operations, and on a CUDA machine the device's kernels and
  copies, written as a Chrome trace (chrome://tracing, Perfetto).
* ``stage`` counts a named host stage and its wall time in the service
  counters (``stage_<name>`` and ``stage_<name>_us``, as the JAX package
  counts them), whether or not tracing is on, and is a ``span``; on a
  CUDA machine it also marks the scope as an NVTX range.

Usage::

    from qatzip_tpu_torch.utils.trace import qz_trace, spans

    with qz_trace("/tmp/qztpu_profile"):      # host + device trace
        sess.compress(data)
    for s in spans():
        print(s.name, s.request, s.parent, s.end_ns - s.start_ns, s.counts)

Or set ``QZTPU_TRACE=/dir`` and use ``maybe_trace_from_env()``. Tracing
changes no route and no byte.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler

from .debug import get_counters, qz_log

#: spans kept at most, the oldest going first: some minutes of a traced
#: service (a 64 MiB request records ~30, a 64 KiB one ~10)
MAX_SPANS = 1 << 17

_enabled = False
_lock = threading.Lock()
_recorded: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("qz_span",
                                                         default=None)

# Whether a torch.profiler runs: torch's own flag, a module global that
# costs one attribute read; a torch without it is asked through its C
# call, which costs more.
if hasattr(_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _profiler._is_profiler_enabled
else:
    _profiling = torch._C._autograd._profiler_enabled

# The profiler event a span opens: torch's C-level scope where it has one,
# which keeps the interpreter lock, else ``record_function``, an operator
# call several times dearer that lets go of the lock on entry and exit.
_event = getattr(getattr(torch._C, "_profiler", None),
                 "_RecordFunctionFast", torch.profiler.record_function)


class Span:
    """One recorded span. ``parent`` is the id of the span it opened in
    (None for a request's root), ``request`` its root's id, ``thread``
    ``threading.get_ident()``; ``start_ns`` is ``time.time_ns`` at its
    start and ``end_ns`` that plus its ``perf_counter_ns`` duration."""

    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns",
                 "end_ns", "counts", "_p0", "_token", "_mark")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name = name
        self.counts = counts

    def add(self, **counts: int) -> None:
        """Add to the span's counts and to the service counters."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v
        _bump(counts)

    # the clocks are read outermost: a span's time is what its scope
    # costs its caller, the profiler's event included
    def __enter__(self):
        self.start_ns = time.time_ns()
        self._p0 = time.perf_counter_ns()
        outer = _current.get()
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        self.request = outer.request if outer is not None else self.id
        self.thread = threading.get_ident()
        self._token = _current.set(self)
        self._mark = None
        if _profiling():
            self._mark = _event(self.name)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self._mark is not None:
            self._mark.__exit__(*exc)
        _current.reset(self._token)
        self._token = self._mark = None
        self.end_ns = self.start_ns + time.perf_counter_ns() - self._p0
        with _lock:
            _recorded.append(self)
        return False


class _Off:
    """What ``span`` returns while tracing is off: it records nothing,
    and its ``add`` only counts."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts: int) -> None:
        _bump(counts)


_OFF = _Off()


def _bump(counts: Dict[str, int]) -> None:
    counters = get_counters()
    for k, v in counts.items():
        counters.bump(k, v)


def span(name: str, **counts: int):
    """A context that records a span named ``name`` with ``counts`` while
    tracing is on (a profiler running, or ``enable()``), and does nothing
    otherwise. Either way ``counts``, and what its ``add(**counts)`` is
    given, go to the service counters."""
    if counts:
        _bump(counts)
    if _enabled or _profiling():
        return Span(name, counts)
    return _OFF


def enable() -> None:
    """Record spans whether or not a profiler runs."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording spans outside a profiler, and clear those kept."""
    global _enabled
    _enabled = False
    with _lock:
        _recorded.clear()


def submit(pool, fn, *args):
    """``pool.submit(fn, *args)``, with ``fn`` run in a copy of the
    caller's context: the spans it opens carry the caller's request and
    have the caller's open span as their parent. A thread pool does not
    carry the context by itself."""
    return pool.submit(contextvars.copy_context().run, fn, *args)


def spans() -> List[Span]:
    """The spans recorded so far (closed ones only), in order of their
    end."""
    with _lock:
        return list(_recorded)


@contextlib.contextmanager
def qz_trace(trace_dir: str):
    """Trace the enclosed scope with torch.profiler (CPU activity, and
    CUDA activity when a card is available) and write a Chrome trace
    into ``trace_dir`` when it ends, as ``qztpu_torch_<pid>_<ms>.json``.
    Spans record while it runs. Yields ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield trace_dir
    finally:
        prof.stop()
        path = os.path.join(trace_dir, f"qztpu_torch_{os.getpid()}_"
                            f"{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        qz_log("trace written to %s (%.1f ms)", path,
               (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def stage(name: str):
    """Named stage timer: one ``stage_<name>`` and its wall time in µs,
    ``stage_<name>_us``, in the service counters; the scope is a
    ``span`` and, on a CUDA machine, an NVTX range."""
    t0 = time.perf_counter()
    with contextlib.ExitStack() as marks:
        marks.enter_context(span(name))
        if torch.cuda.is_available():
            marks.enter_context(torch.cuda.nvtx.range(name))
        try:
            yield
        finally:
            get_counters().bump(f"stage_{name}", 1, 0)
            get_counters().bump(f"stage_{name}_us",
                                int((time.perf_counter() - t0) * 1e6))


def maybe_trace_from_env():
    """A ``qz_trace`` context into ``$QZTPU_TRACE`` when it is set, else a
    null one, so a whole span can be traced without a code change."""
    d = os.environ.get("QZTPU_TRACE")
    if d:
        return qz_trace(d)
    return contextlib.nullcontext()
