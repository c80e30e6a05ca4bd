"""Process runtime: device discovery and the engine pool.

Counterpart of ``qatzip_tpu/runtime.py``. Discovery goes through
``torch.cuda``; there is no probe thread. A session that asks for a CUDA
device on a machine without one gets ``QZ_NOSW_NO_HW``: the port never
carries on in software in its place. The engine runs on the CPU only
when the caller asks for ``device="cpu"``, and then uses the plain
versions of the kernels.
"""

from __future__ import annotations

import threading
from typing import Dict, Set

import torch

from .constants import (QZ_DUPLICATE, QZ_NO_HW, QZ_NOSW_NO_HW, QZ_OK,
                        QZ_PARAMS, QzError)
from .utils.debug import qz_log


def resolve_device(device) -> torch.device:
    """The concrete torch device for ``device``; raises QZ_NOSW_NO_HW
    for a CUDA device this machine does not have."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise QzError(QZ_PARAMS, f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise QzError(QZ_NOSW_NO_HW, "no CUDA device is available; pass "
                      "device='cpu' to run the plain versions on the host")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise QzError(QZ_NOSW_NO_HW, f"no CUDA device {index} "
                      f"({torch.cuda.device_count()} present)")
    return torch.device("cuda", index)


class Runtime:
    """Singleton process runtime: one engine per device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._engines: Dict[str, object] = {}
        self._initialized: Set[str] = set()

    def init(self, device="cuda", sw_backup: int = 1) -> int:
        """qzInit for ``device``: QZ_OK when this call brings it up,
        QZ_DUPLICATE when it is up already; for a CUDA device this machine
        does not have, QZ_NO_HW (``sw_backup`` set: sessions may still run
        on the CPU where the caller asks for it) or QZ_NOSW_NO_HW."""
        try:
            dev = resolve_device(device)
        except QzError as e:
            if e.rc != QZ_NOSW_NO_HW:
                raise
            return QZ_NO_HW if sw_backup else QZ_NOSW_NO_HW
        with self._lock:
            if str(dev) in self._initialized:
                return QZ_DUPLICATE
            self._initialized.add(str(dev))
            return QZ_OK

    def initialized(self, device) -> bool:
        return str(resolve_device(device)) in self._initialized

    def get_engine(self, device):
        dev = resolve_device(device)
        with self._lock:
            eng = self._engines.get(str(dev))
            if eng is None:
                from .parallel.dispatch import build_engine
                eng = self._engines[str(dev)] = build_engine(dev)
                qz_log("engine up on %s", dev)
            return eng


_runtime = Runtime()


def get_runtime() -> Runtime:
    return _runtime
