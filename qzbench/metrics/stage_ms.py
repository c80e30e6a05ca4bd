"""stage_ms [ms/req], layer dispatch (``parallel/dispatch.py``): host
time in the device packs' dispatch, ``CudaEngine._device_pack`` /
``_lz4_device_pack``: staging, h2d, the launches, and on dynamic DEFLATE
the wait for pass 1 and the tree build between the passes. Summed over
a ``MeshEngine``'s shares."""

WRAPS = {"stage": (
    "qatzip_tpu_torch.parallel.dispatch:CudaEngine._device_pack",
    "qatzip_tpu_torch.parallel.dispatch:CudaEngine._lz4_device_pack")}


def read(run):
    return run.per_request_ms("stage")
