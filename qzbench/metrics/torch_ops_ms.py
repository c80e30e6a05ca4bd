"""torch_ops_ms [ms/req], layer ops (``ops/lz77.py``,
``ops/deflate_pack.py``, ``ops/lz4_pack.py``): device time of the
operations that are neither the port's hand kernels (a file in
``roofline/``) nor copies: torch's elementwise passes, sorts, the
full-row search, memsets. Summed over the devices, over the analysed
interval, per request in it."""

from qzbench import trace


def read(run):
    if run.device is None or run.profiled <= 0:
        return None
    hand = run.hand_kernel
    s = run.device.time_s(lambda n: not hand(n) and not trace.is_copy(n))
    return s / run.profiled * 1e3
