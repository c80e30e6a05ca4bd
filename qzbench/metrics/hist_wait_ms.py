"""hist_wait_ms [ms/req], layer dispatch: host time in the program's
``hist_wait`` spans: dynamic DEFLATE waiting, before a tile's tree build,
for pass 1's histograms to reach the host. Summed over a
``MeshEngine``'s shares, per program ``compress`` span."""

from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "hist_wait")
