"""The program's own spans (``qatzip_tpu_torch.utils.trace``) in a traced
run's window, for the readers of the dispatch layer's metrics.

The program records its spans while a ``torch.profiler`` runs, as it does
over a traced run's window on the cards. A span is kept when it starts
between the earliest submission and the latest return of the window's
requests. Where the program has no recorder, or recorded nothing (no
profiler runs on the CPU), every function here gives None.
"""

from typing import Dict, List, Optional


def window(run) -> Optional[List]:
    """The program's spans that start in the window of ``run``, or None."""
    try:
        from qatzip_tpu_torch.utils import trace
    except ImportError:
        return None
    recorded = getattr(trace, "spans", None)
    if recorded is None or not run.requests:
        return None
    a = min(r.w0 for r in run.requests)
    b = max(r.w0 + r.p1 - r.ps for r in run.requests)
    got = [s for s in recorded() if a <= s.start_ns <= b]
    return got or None


def requests(spans) -> int:
    """The requests among ``spans``: the program's ``compress`` spans."""
    return sum(s.name == "compress" for s in spans)


def seconds(spans, names, parents: Optional[Dict] = None) -> float:
    """Seconds of the spans named in ``names``, of those opened directly
    inside one of ``parents`` (ids) where that is given."""
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name in names and (parents is None or s.parent in parents)
               ) / 1e9


def per_request_ms(run, name: str) -> Optional[float]:
    """The ``name`` spans' ms per request of the window, or None where
    the window holds no such span."""
    spans = window(run)
    if not spans or not requests(spans) or \
            not any(s.name == name for s in spans):
        return None
    return seconds(spans, (name,)) / requests(spans) * 1e3
