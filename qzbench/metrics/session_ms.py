"""session_ms [ms/req], layer session (``session.py``, ``codec.py``): a
request's wall time outside the engine's ``compress_chunks``: chunking,
framing, the crc fold, joins. The request span is the benchmark's own
(around ``QzSession.compress``)."""

WRAPS = {"compress_chunks": (
    "qatzip_tpu_torch.parallel.dispatch:_ChunkEngine.compress_chunks",)}


def read(run):
    if not run.spans or not run.spans.count("compress_chunks"):
        return None
    self_s = run.spans.total_s("request") - run.spans.total_s("compress_chunks")
    return self_s / run.spans.count("request") * 1e3
