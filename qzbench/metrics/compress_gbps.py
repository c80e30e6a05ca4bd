"""compress_gbps [GB/s]: the input bytes of every request completed in
the window over the window's seconds (1e9 bytes a GB). The window runs
from the first request's submission to the last one's return; no request
starts after ``--seconds``. As ``compress_gbps.small`` it is a per-layer
reading of the small cell, taken in its traced run: there the host sets
the pace of each request, and runs on one machine spread too widely for
any bound end to end (PERF.md §2)."""


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    return sum(r.bytes_in for r in run.requests) / run.window_s / 1e9
