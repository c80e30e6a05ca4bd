"""Process runtime: device discovery and the engine pool.

Counterpart of ``qatzip_tpu/runtime.py``. Discovery goes through
``torch.cuda``; there is no probe thread. A session that asks for a CUDA
device on a machine without one gets ``QZ_NOSW_NO_HW``: the port never
carries on in software in its place. The engine runs on the CPU only
when the caller asks for ``device="cpu"``, and then uses the plain
versions of the kernels.

A device names one or several torch devices: ``"cuda"`` with no index is
every visible CUDA device (the JAX runtime's ``jax.local_devices()``),
``"cuda:i"`` one card, ``"cpu"`` the host, and a list or tuple names its
devices in order (``["cuda:0", "cuda:1"]``; a device may repeat). The
pool keeps one engine per tuple of devices: a ``CudaEngine`` for one
device, a ``MeshEngine`` that deals the rows over several.
``Runtime.close`` (qzClose) drops them all.

A process made by ``os.fork()`` starts with an empty pool. CUDA cannot
run in a child forked after CUDA came up in its parent: there a CUDA
device is refused with ``QZ_NOSW_NO_HW`` (``Runtime.init`` returns
QZ_NO_HW or QZ_NOSW_NO_HW), and ``device="cpu"`` works. A worker that
needs the card is started with the ``spawn`` start method.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Set, Tuple

import torch

from .constants import (QZ_DUPLICATE, QZ_NO_HW, QZ_NOSW_NO_HW, QZ_OK,
                        QZ_PARAMS, QzError)
from .utils.debug import qz_log


#: the refusal of a CUDA device in a child forked after CUDA came up
FORKED = ("this process was forked after CUDA came up in its parent, and "
          "CUDA cannot run in it: start it with the 'spawn' start method "
          "(multiprocessing.get_context('spawn')), or pass device='cpu'")


def check_not_forked(devs) -> None:
    """Raise QZ_NOSW_NO_HW if ``devs`` holds a CUDA device and this process
    was forked after CUDA came up in its parent (the first CUDA call
    would raise torch's RuntimeError)."""
    if (any(d.type == "cuda" for d in devs)
            and torch.cuda._is_in_bad_fork()):
        raise QzError(QZ_NOSW_NO_HW, FORKED)


def _one_device(device, every_card: bool) -> Tuple[torch.device, ...]:
    dev = torch.device(device)
    if dev.type == "cpu":
        return (torch.device("cpu"),)
    if dev.type != "cuda":
        raise QzError(QZ_PARAMS, f"unsupported device {dev}")
    check_not_forked((dev,))
    if not torch.cuda.is_available():
        raise QzError(QZ_NOSW_NO_HW, "no CUDA device is available; pass "
                      "device='cpu' to run the plain versions on the host")
    count = torch.cuda.device_count()
    if dev.index is None:
        if every_card:
            return tuple(torch.device("cuda", i) for i in range(count))
        return (torch.device("cuda", torch.cuda.current_device()),)
    if dev.index >= count:
        raise QzError(QZ_NOSW_NO_HW, f"no CUDA device {dev.index} "
                      f"({count} present)")
    return (torch.device("cuda", dev.index),)


def resolve_device(device) -> Tuple[torch.device, ...]:
    """The concrete torch devices ``device`` names, in order (see the
    module docstring); raises QZ_NOSW_NO_HW for a CUDA device this
    machine does not have and QZ_PARAMS for an empty list or one that
    mixes the CPU with CUDA."""
    if isinstance(device, (list, tuple)):
        devs = tuple(d for one in device for d in _one_device(one, False))
        if not devs:
            raise QzError(QZ_PARAMS, "an empty list of devices")
        if len({d.type for d in devs}) > 1:
            raise QzError(QZ_PARAMS, f"devices of two kinds: {devs}")
        return devs
    return _one_device(device, True)


def _key(devs: Tuple[torch.device, ...]) -> Tuple[str, ...]:
    return tuple(str(d) for d in devs)


class Runtime:
    """Singleton process runtime: one engine per tuple of devices."""

    def __init__(self):
        self._lock = threading.Lock()
        self._engines: Dict[Tuple[str, ...], object] = {}
        self._initialized: Set[Tuple[str, ...]] = set()

    def init(self, device="cuda", sw_backup: int = 1) -> int:
        """qzInit for ``device``: QZ_OK when this call brings it up,
        QZ_DUPLICATE when it is up already; for a CUDA device this machine
        does not have, QZ_NO_HW (``sw_backup`` set: sessions may still run
        on the CPU where the caller asks for it) or QZ_NOSW_NO_HW."""
        try:
            key = _key(resolve_device(device))
        except QzError as e:
            if e.rc != QZ_NOSW_NO_HW:
                raise
            return QZ_NO_HW if sw_backup else QZ_NOSW_NO_HW
        with self._lock:
            if key in self._initialized:
                return QZ_DUPLICATE
            self._initialized.add(key)
            return QZ_OK

    def initialized(self, device) -> bool:
        return _key(resolve_device(device)) in self._initialized

    def get_engine(self, device):
        devs = resolve_device(device)
        with self._lock:
            eng = self._engines.get(_key(devs))
            if eng is None:
                from .parallel.dispatch import build_engine
                eng = self._engines[_key(devs)] = build_engine(devs)
                qz_log("engine up on %s", ", ".join(_key(devs)))
            return eng

    def close(self) -> int:
        """qzClose (the JAX runtime's ``close``): drop every engine of the
        pool and forget which devices were brought up. A session keeps
        the engine it holds; the next session builds a new one. The
        device memory of a request lives only as long as the request (in
        torch's caching allocator), so nothing stays behind."""
        with self._lock:
            self._engines.clear()
            self._initialized.clear()
            return QZ_OK

    def _forget_after_fork(self) -> None:
        """In a child made by fork: the lock freed (another thread of the
        parent may have held it) and an empty pool."""
        self._lock._at_fork_reinit()
        self._engines = {}
        self._initialized = set()


_runtime = Runtime()
os.register_at_fork(after_in_child=_runtime._forget_after_fork)


def get_runtime() -> Runtime:
    return _runtime


def qz_init(device="cuda", sw_backup: int = 1) -> int:
    """qzInit on the process's runtime (``Runtime.init``)."""
    return _runtime.init(device, sw_backup)


def qz_close() -> int:
    """qzClose on the process's runtime (``Runtime.close``)."""
    return _runtime.close()
