"""finish_ms [ms/req], layer dispatch: host time in
``CudaEngine._finish`` / ``_finish_lz4``, with the bucketed d2h fetch
they pull and the host pool's work they wait for. Summed over a
``MeshEngine``'s shares."""

WRAPS = {"finish": (
    "qatzip_tpu_torch.parallel.dispatch:CudaEngine._finish",
    "qatzip_tpu_torch.parallel.dispatch:CudaEngine._finish_lz4")}


def read(run):
    return run.per_request_ms("finish")
