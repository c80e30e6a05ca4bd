"""Logging and per-thread service counters.

Counterpart of ``qatzip_tpu/utils/debug.py`` (reference ``QZ_DEBUG`` /
``QZ_ERROR`` and the per-thread HW/SW counters). Logging is enabled with
``QZTPU_DEBUG=1``, the same switch as the JAX package; under it the
counters, summed over the threads, are written to stderr at exit
(``Counters.dump``, the reference's ``dumpThreadInfo``).
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import defaultdict

DEBUG = os.environ.get("QZTPU_DEBUG") == "1"


def qz_log(fmt: str, *args) -> None:
    if DEBUG:
        sys.stderr.write("[qztpu_torch] " + (fmt % args if args else fmt) + "\n")


def qz_error(fmt: str, *args) -> None:
    sys.stderr.write("[qztpu_torch:error] " + (fmt % args if args else fmt) + "\n")


class Counters:
    """Per-thread service counters: who served each request, and bytes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_thread = defaultdict(lambda: defaultdict(int))

    def bump(self, key: str, n: int = 1, nbytes: int = 0) -> None:
        tid = threading.get_ident()
        with self._lock:
            c = self._by_thread[tid]
            c[key] += n
            if nbytes:
                c[key + "_bytes"] += nbytes

    def snapshot(self):
        with self._lock:
            return {tid: dict(c) for tid, c in self._by_thread.items()}

    def dump(self) -> None:
        """Write every counter, summed over the threads, to stderr on one
        line (nothing when no counter was bumped)."""
        snap = self.snapshot()
        if not snap:
            return
        total = defaultdict(int)
        for c in snap.values():
            for k, v in c.items():
                total[k] += v
        sys.stderr.write("[qztpu_torch] service counters: "
                         + ", ".join(f"{k}={v}"
                                     for k, v in sorted(total.items()))
                         + "\n")


_counters = Counters()


def get_counters() -> Counters:
    return _counters


if DEBUG:
    atexit.register(_counters.dump)


class Timer:
    """A scope timer (the reference's per-thread timer, src/qatzip.c:
    410-419): ``elapsed`` seconds of the ``with`` block, logged by
    ``qz_log``."""

    def __init__(self, name: str):
        self.name = name
        self.t0 = 0.0
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        qz_log("timer %s: %.3f ms", self.name, self.elapsed * 1e3)
        return False
