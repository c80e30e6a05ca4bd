"""dyn_plan_ms [ms/req], layer native host stages (``native.py`` through
``dispatch.plan_tile``): the serial Huffman plan of dynamic DEFLATE
between the device's two passes. Summed over a ``MeshEngine``'s
shares."""

WRAPS = {"dyn_plan": ("qatzip_tpu_torch.parallel.dispatch:plan_tile",)}


def read(run):
    return run.per_request_ms("dyn_plan")
