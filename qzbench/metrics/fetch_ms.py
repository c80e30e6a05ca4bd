"""fetch_ms [ms/req], layer dispatch: host time in the program's
``fetch`` spans: each tile's copies to the host (bit or byte counts,
the words that cover the longest row, the device crcs), with the waits
for the device's work that they hold. Summed over a ``MeshEngine``'s
shares, per program ``compress`` span."""

from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "fetch")
