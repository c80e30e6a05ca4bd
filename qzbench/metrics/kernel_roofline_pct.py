"""kernel_roofline_pct [%], layer kernels (``csrc/*.cu`` through
``ops/cuda_pack.py``, ``ops/crc32_mxu.py``): the least time the card could
take for the hand kernels' launches over their device time. A launch's
least time is the larger of its bytes over the memory rate and its
operations over the peak rate (``peaks.json``), counted from its recorded
arguments by ``roofline/<kernel>.py``. Over the analysed interval: each
kernel's mean bound a launch times its launches that start there, over
their device time."""


def read(run):
    if run.device is None:
        return None
    bound = spent = 0.0
    for kernel, launches in run.launches.items():
        if not launches:
            continue
        mod = run.rooflines[kernel]
        n, secs = run.device.started(mod.matches)
        if not n:
            continue
        mean = sum(run.bound_s(kernel, a) for a in launches) / len(launches)
        bound += mean * n
        spent += secs
    if spent <= 0:
        return None
    return 100.0 * bound / spent
