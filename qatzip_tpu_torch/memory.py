"""The buffer pool: qz_malloc, qz_free and address classification.

Counterpart of ``qatzip_tpu/memory.py`` (reference ``qzMalloc`` /
``qzFree`` / ``qzMemFindAddr``, src/qatzip_mem.c:100-210, and the stream
buffer free list, src/qatzip_stream.c:56-278). Buffers are numpy
``uint8`` arrays on the host. PINNED buffers come from, and go back to,
a free list keyed by size and are registered by address, so
``qz_mem_find_addr`` can tell them from COMMON ones; COMMON buffers are
plain allocations. As in the JAX package, no buffer is page-locked: a
PINNED buffer is pooled host memory, not CUDA pinned memory.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List

import numpy as np

from .constants import MemType

#: free-list depth per size bucket (reference STREAM_BUFF_LIST_SZ,
#: src/qatzip_stream.c:56)
POOL_LIST_DEPTH = 8
#: buckets of buffers over this many bytes keep at most LARGE_DEPTH
LARGE_BUF = 8 << 20
LARGE_DEPTH = 2


class BufferPool:
    """Reusable host buffers with address classification."""

    def __init__(self, list_depth: int = POOL_LIST_DEPTH):
        self._lock = threading.Lock()
        self._free: Dict[int, List[np.ndarray]] = defaultdict(list)
        self._kind: Dict[int, MemType] = {}   # data address -> kind
        self._depth = list_depth
        self.alloc_count = 0
        self.reuse_count = 0

    def qz_malloc(self, sz: int,
                  kind: MemType = MemType.PINNED_MEM) -> np.ndarray:
        """A buffer of ``sz`` bytes: for PINNED, one from the pool when
        its bucket has one, registered by address; for COMMON, a plain
        allocation (qatzip_mem.c:167-210)."""
        with self._lock:
            bucket = self._free.get(sz)
            if kind == MemType.PINNED_MEM and bucket:
                buf = bucket.pop()
                self.reuse_count += 1
            else:
                buf = np.empty(sz, dtype=np.uint8)
                self.alloc_count += 1
            if kind == MemType.PINNED_MEM:
                self._kind[buf.ctypes.data] = MemType.PINNED_MEM
            return buf

    def qz_free(self, buf) -> None:
        """Return a PINNED buffer to its bucket, which keeps at most
        ``list_depth`` buffers (LARGE_DEPTH over LARGE_BUF bytes: a full
        list of 50 MB batch buffers would hold ~400 MB); the rest, and
        COMMON buffers, are left to the garbage collector."""
        if buf is None:
            return
        with self._lock:
            ptr = buf.ctypes.data
            if self._kind.get(ptr, MemType.COMMON_MEM) != MemType.PINNED_MEM:
                return
            bucket = self._free[buf.nbytes]
            depth = LARGE_DEPTH if buf.nbytes > LARGE_BUF else self._depth
            if len(bucket) < depth:
                bucket.append(buf)
                return
            del self._kind[ptr]

    def qz_mem_find_addr(self, buf) -> MemType:
        """PINNED for a registered pool buffer, else COMMON
        (qzMemFindAddr)."""
        if not isinstance(buf, np.ndarray):
            return MemType.COMMON_MEM
        with self._lock:
            return self._kind.get(buf.ctypes.data, MemType.COMMON_MEM)

    def destroy(self) -> None:
        """Drop every pooled buffer and registration (qzMemDestory)."""
        with self._lock:
            self._free.clear()
            self._kind.clear()


#: the process-wide pool (the reference's g_qz_mem)
default_pool = BufferPool()

qz_malloc = default_pool.qz_malloc
qz_free = default_pool.qz_free
qz_mem_find_addr = default_pool.qz_mem_find_addr
