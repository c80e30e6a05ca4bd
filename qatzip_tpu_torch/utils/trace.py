"""Structured tracing: torch.profiler traces and named stage timers.

Counterpart of ``qatzip_tpu/utils/trace.py``. ``qz_trace`` records the
enclosed scope with ``torch.profiler``: the host's operations, and on a
CUDA machine the device's kernels and copies, written as a Chrome trace
(chrome://tracing, Perfetto). ``stage`` counts a named host stage and its
wall time in the service counters (``stage_<name>`` and
``stage_<name>_us``, as the JAX package counts them), and marks the
scope in an active trace with ``record_function`` and, on a CUDA
machine, in an NVTX range.

Usage::

    from qatzip_tpu_torch.utils.trace import qz_trace, stage

    with qz_trace("/tmp/qztpu_profile"):      # host + device trace
        with stage("compress"):
            sess.compress(data)

Or set ``QZTPU_TRACE=/dir`` and use ``maybe_trace_from_env()``. Tracing
changes no route and no byte.
"""

from __future__ import annotations

import contextlib
import os
import time

from .debug import get_counters, qz_log


@contextlib.contextmanager
def qz_trace(trace_dir: str):
    """Trace the enclosed scope with torch.profiler (CPU activity, and
    CUDA activity when a card is available) and write a Chrome trace
    into ``trace_dir`` when it ends, as ``qztpu_torch_<pid>_<ms>.json``.
    Yields ``trace_dir``."""
    import torch
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
    ``stage_<name>_us``, in the service counters; the scope is marked in
    any active torch.profiler trace and, on a CUDA machine, as an NVTX
    range."""
    import torch

    t0 = time.perf_counter()
    with contextlib.ExitStack() as marks:
        marks.enter_context(torch.profiler.record_function(name))
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
