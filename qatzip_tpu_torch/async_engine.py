"""The async engine: non-blocking requests, callbacks, batching.

Counterpart of ``qatzip_tpu/async_engine.py`` (reference src/qatzip.c
async subsystem :3439-5311 and src/qatzip_queue.c: per-instance request
rings, ``aqzInit`` with its submit and polling threads, non-blocking
``aqzCompress[Crc]`` / ``aqzDecompress`` returning AQZ_NO_SPACE when the
ring is full, completion callbacks).

Worker threads drain the ring in batches of up to BATCH_MAX requests. A
batch's plain compress requests of one (session, direction) go to one
``QzSession.compress_batch``, which sends their chunks to the engine in
one dispatch; decompress, hash and chain requests run one at a time. A
batch that raises is run again one request at a time, so one bad request
does not fail its neighbours. Within a batch a session's callbacks fire
in submission order; across batches and workers they may interleave, so
callers stitch results by their ``external`` tag (as utils/aqzip.c does).
Every session on one device shares that device's engine, so two workers
may run two dispatches on it at once.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import queue as _queue
import threading
from typing import Callable, List, Optional

from .constants import Direction, QZ_FAIL, QZ_OK, QZ_PARAMS, QzError

# the async return codes of the JAX package's async engine
AQZ_OK = 0
AQZ_NO_SPACE = 1
AQZ_STOPPED = 2

DEFAULT_RING_DEPTH = 128   # NUM_BUFF analog (qatzip_internal.h:63-68)
BATCH_MAX = 64             # requests drained per dispatch


@dataclasses.dataclass
class _Request:
    seq: int
    session: object
    direction: Direction
    src: bytes
    callback: Callable
    external: object
    last: bool = True
    hash_algo: Optional[str] = None   # chain and hash requests
    hash_only: bool = False


class AQzRuntime:
    """The process's async runtime (aqzInit / aqzStop)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queue: Optional[_queue.Queue] = None
        self._threads: List[threading.Thread] = []
        self._running = False
        self._depth = DEFAULT_RING_DEPTH

    def init(self, num_threads: int = 2,
             ring_depth: int = DEFAULT_RING_DEPTH) -> int:
        """aqzInit: start ``num_threads`` workers over a ring of
        ``ring_depth`` requests. QZ_OK (also when already running) or
        QZ_PARAMS."""
        with self._lock:
            if self._running:
                return QZ_OK
            if num_threads < 1 or ring_depth < 1:
                return QZ_PARAMS
            self._depth = ring_depth
            self._queue = _queue.Queue(maxsize=ring_depth)
            self._running = True
            self._threads = [
                threading.Thread(target=self._worker, daemon=True,
                                 name=f"aqz-worker-{i}")
                for i in range(num_threads)]
            for t in self._threads:
                t.start()
            return QZ_OK

    def stop(self) -> int:
        """aqzStop: let the workers finish what is queued, then join
        them."""
        with self._lock:
            if not self._running:
                return QZ_OK
            self._running = False
            for _ in self._threads:
                self._queue.put(None)
            for t in self._threads:
                t.join(timeout=30)
            self._threads = []
            self._queue = None
            return QZ_OK

    def _forget_after_fork(self) -> None:
        """In a child made by fork the workers are gone: the runtime is
        stopped, and ``aqz_init`` starts it again (the lock freed: another
        thread may have held it)."""
        self._lock._at_fork_reinit()
        self._queue = None
        self._threads = []
        self._running = False

    def submit(self, req: _Request) -> int:
        """Queue ``req`` without blocking: AQZ_OK, AQZ_NO_SPACE when the
        ring is full (the caller retries, src/qatzip.c:4202-4330) or
        AQZ_STOPPED."""
        q = self._queue
        if q is None or not self._running:
            return AQZ_STOPPED
        try:
            q.put_nowait(req)
            return AQZ_OK
        except _queue.Full:
            return AQZ_NO_SPACE

    def _worker(self):
        while True:
            q = self._queue
            if q is None:
                return
            item = q.get()
            if item is None:
                return
            batch = [item]
            while len(batch) < BATCH_MAX:
                try:
                    nxt = q.get_nowait()
                except _queue.Empty:
                    break
                if nxt is None:
                    q.put(None)          # the stop marker is a sibling's
                    break
                batch.append(nxt)
            groups = {}
            for r in batch:
                groups.setdefault((id(r.session), r.direction), []).append(r)
            for (_sid, direction), reqs in groups.items():
                self._process_group(reqs, direction)

    @staticmethod
    def _process_group(reqs: List[_Request], direction: Direction):
        """Run one (session, direction) group: its plain compress
        requests in one ``compress_batch``, the rest (and all of them when
        the batch raises) one at a time; callbacks in submission order."""
        sess = reqs[0].session
        ordered = sorted(reqs, key=lambda r: r.seq)
        outs = {}   # seq -> (out, crc, rc, digest)

        plain = [r for r in ordered
                 if direction == Direction.DIR_COMPRESS
                 and r.hash_algo is None and not r.hash_only]
        if len(plain) > 1:
            try:
                batch = sess.compress_batch([r.src for r in plain])
                for r, (out, crc) in zip(plain, batch):
                    outs[r.seq] = (out, crc, QZ_OK, None)
            except Exception:  # noqa: BLE001 (isolate one bad request:
                pass           # the group runs one request at a time below)

        for r in ordered:
            if r.seq not in outs:
                digest = None
                try:
                    if r.hash_algo is not None:
                        digest = hashlib.new(r.hash_algo, r.src).digest()
                    if r.hash_only:
                        out, crc = b"", 0
                    elif direction == Direction.DIR_COMPRESS:
                        out, crc = sess.compress(r.src, last=r.last,
                                                 with_crc=True)
                    else:
                        out, crc = sess.decompress(r.src), 0
                    rc = QZ_OK
                except QzError as e:
                    out, crc, rc = b"", 0, e.rc
                except Exception:  # noqa: BLE001 (a worker must go on)
                    out, crc, rc = b"", 0, QZ_FAIL
                outs[r.seq] = (out, crc, rc, digest)
            out, crc, rc, digest = outs[r.seq]
            try:
                if r.hash_algo is not None:
                    r.callback(r.external, r.src, out, rc, crc, digest)
                else:
                    r.callback(r.external, r.src, out, rc, crc)
            except Exception:  # noqa: BLE001 (a callback's error must
                pass           # not stop the worker; the reference ignores it)


_aqz_runtime = AQzRuntime()
os.register_at_fork(after_in_child=_aqz_runtime._forget_after_fork)


def aqz_init(num_threads: int = 2,
             ring_depth: int = DEFAULT_RING_DEPTH) -> int:
    """aqzInit on the process's runtime."""
    return _aqz_runtime.init(num_threads, ring_depth)


def aqz_stop() -> int:
    """aqzStop on the process's runtime."""
    return _aqz_runtime.stop()


class AQzSession:
    """An async session (aqzSetupSession) over a ``QzSession``; with none
    given it builds ``QzSession(device)``, on the card by default.

    Callbacks: ``cb(external, src, dest, rc, crc32)``
    (QzAsyncCallbackFn, include/qatzip.h:2588-2655); chain and hash
    requests also pass the digest."""

    def __init__(self, session=None, device="cuda"):
        from .session import QzSession
        self.session = session if session is not None else QzSession(device)
        self._seq = 0
        self._lock = threading.Lock()

    def setup_deflate(self, params=None) -> int:
        return self.session.setup_deflate(params)

    def setup_lz4(self, params=None) -> int:
        return self.session.setup_lz4(params)

    def setup_lz4s(self, params=None) -> int:
        return self.session.setup_lz4s(params)

    def _submit(self, direction, src, callback, external, last=True,
                hash_algo=None, hash_only=False) -> int:
        with self._lock:
            seq = self._seq
            self._seq += 1
        return _aqz_runtime.submit(_Request(
            seq=seq, session=self.session, direction=direction,
            src=bytes(src), callback=callback, external=external, last=last,
            hash_algo=hash_algo, hash_only=hash_only))

    def compress(self, src, callback, external=None, last: bool = True) -> int:
        """aqzCompress[Crc]: non-blocking; AQZ_NO_SPACE when the ring is
        full."""
        return self._submit(Direction.DIR_COMPRESS, src, callback, external,
                            last)

    def decompress(self, src, callback, external=None) -> int:
        """aqzDecompress."""
        return self._submit(Direction.DIR_DECOMPRESS, src, callback,
                            external)

    def chain_compress(self, src, callback, external=None,
                       hash_algo: str = "sha256", last: bool = True) -> int:
        """aqzChainCompress: hash and compress in one request; the
        callback gets (external, src, dest, rc, crc, digest)."""
        return self._submit(Direction.DIR_COMPRESS, src, callback, external,
                            last, hash_algo=hash_algo)

    def hash(self, src, callback, external=None,
             hash_algo: str = "sha256") -> int:
        """aqzHash (include/qatzip.h:3359): a digest-only request."""
        return self._submit(Direction.DIR_COMPRESS, src, callback, external,
                            hash_algo=hash_algo, hash_only=True)

    def teardown(self) -> int:
        return self.session.teardown()
