"""The JAX package's native library, loaded before a port test compares
with it.

``qatzip_tpu.native`` builds ``_qztpu_native.so`` on import when the file
is missing or older than its source, guarded by a thread lock only. On a
fresh tree several test workers can import it at once: one builds over
the file while another loads it, and the loser keeps ``lib = None`` for
its whole life. The JAX package then takes its pure-Python routes, whose
bytes differ from the native ones, and a port test would compare the port
with the wrong reference. So each port test module that compares with the
JAX package calls :func:`require_reference_native` first: it loads the
library once more (the file is whole by then) and fails loudly if it is
still missing.

Those modules' fixtures also run torch on one intra-op thread
(:func:`one_intra_op_thread`).
"""

from __future__ import annotations

import contextlib
import time

RACE = ("qatzip_tpu.native.lib is None: the JAX package's native library "
        "did not load in this process. The likely cause is the build race "
        "in qatzip_tpu/native.py (_build / _load): another test worker was "
        "writing _qztpu_native.so when this one loaded it. The port is "
        "compared with the native reference only, never with its "
        "pure-Python fallback.")


def require_reference_native(tries: int = 15, wait_s: float = 2.0) -> None:
    """Load ``qatzip_tpu.native.lib`` again if it is missing (waiting for
    a build in another process to finish), then assert that it is
    loaded."""
    from qatzip_tpu import native
    for _ in range(tries):
        if native.lib is not None:
            return
        native._load()
        if native.lib is None:
            time.sleep(wait_s)
    assert native.lib is not None, RACE


@contextlib.contextmanager
def one_intra_op_thread():
    """Run torch on one intra-op thread inside the block, and restore the
    count after it: the test runner's workers share the host's cores, and
    their intra-op pools only contend for them."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
