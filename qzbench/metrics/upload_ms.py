"""upload_ms [ms/req], layer dispatch: host time in the program's
``upload`` spans (``parallel/dispatch.py``): each tile's staging into a
padded batch and its copies to the device, and dynamic DEFLATE's three
table copies before pass 2. A blocking copy also waits for the work
queued before it on the stream. Summed over a ``MeshEngine``'s shares,
per program ``compress`` span."""

from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "upload")
