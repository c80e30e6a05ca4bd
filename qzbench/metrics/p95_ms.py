"""p95_ms.small [ms]: the 95th percentile of the latency of every request
of the window, from when it was due to its return (nearest rank). A
per-layer metric of the session entry in the small cell, read in its
traced run: run to run it spreads too widely to hold a bound end to end
(PERF.md §2)."""

import math


def read(run):
    lat = sorted(r.latency_s for r in run.requests)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
