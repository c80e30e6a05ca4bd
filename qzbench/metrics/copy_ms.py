"""copy_ms [ms/req], layer device: device time of the host-device
copies (h2d and d2h), summed over the devices, over the analysed
interval, per request in it."""

from qzbench import trace


def read(run):
    if run.device is None or run.profiled <= 0:
        return None
    return run.device.time_s(trace.is_copy) / run.profiled * 1e3
