"""pool_wait_ms [ms/req], layer dispatch: host time in the program's
``pool_wait`` spans: from a finish's last submission to the host pool
to its last result (framing, the host's recoding and crcs still
running). Summed over a ``MeshEngine``'s shares, per program
``compress`` span."""

from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "pool_wait")
