"""One file a hand kernel: ``roofline/<kernel>.py``, named as the kernel's
function in the port's extension module (``ops/cuda_pack.LAUNCHES``).

Each has ``SYMBOL``, the kernel's ``__global__`` function, with
``matches``, which finds it in the profiler's kernel names, and
``count(args)``, the bytes and the operations one launch needs, from the
integer arguments the port passes to the extension module: every input byte read once and every output
byte written once, and the operations these inputs need at the least.
The counts are those of ``chip_smoke.py`` at commit 0cd1e03 (its
``record`` calls), which PERF.md's kernel table gives as "bound ms".
"""

import re


def matcher(symbol: str):
    """A test for the profiler name of the ``__global__`` function
    ``symbol`` (not a longer name that ends in it)."""
    rx = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(symbol)}(?![A-Za-z0-9_])")
    return lambda name: rx.search(name) is not None
