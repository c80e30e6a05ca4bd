"""qztest: the threaded functional and perf test tool, on the GPU.

Counterpart of ``tools/qztest.py``, the analog of the reference's
``qatzip-test`` (``test/main.c``, 22 modes, dispatch at :4115-4185). A
mode is picked with ``-m`` and runs in ``-t`` threads, each printing the
reference's greppable line (``srv=..., msec=..., bytes=..., N Gbps``,
test/main.c:1448-1485); ``[TOTAL]`` sums the threads' Gbps and
``[FAIL]`` counts the threads that failed (exit code 1). Modes 1 and 3
print the reference's "has been removed" message and exit 0; an unknown
mode exits 2.

   1  removed
   2  qzMemFuncTest        - qz_malloc / qz_free / classification loop
   3  removed
   4  qzCompressAndDecompress (-D comp|decomp|both, -v verify; perf loop)
   5  format mix: compress in one session, decompress in another
   6  qzSetupParamFuncTest - invalid session params are rejected
   7  qzDecompressSwQz     - zlib / gzip buffers decode via the session
   8  qzCompressDecompressSwQZMixed - engine <-> software cross decode
   9  qzCompressStreamAndDecompress - streaming round trip
  10  qzCompressStreamOnCommonMem  - streaming from unpinned buffers
  11  qzCompressStreamOutput       - stream output decodes one-shot
  12  qzDecompressStreamInput      - one-shot output decodes via stream
  13  qzCompressStreamInvalidChunkSize - out-of-range strm_buff_sz
  14  qzCompressStreamInvalidQzStreamParam - ended stream ops fail
  15  qzDecompressStreamNegParam   - garbage and truncated stream input
  16  qzEndStreamNegParam          - qz_end_stream on ended streams
  17  qzFuncTests          - software <-> engine equivalence
  18  thread safety: mode 4's round trip with random sleeps
  19  qzInitPcieCountCheck - Runtime.init / Runtime.close cycling; on
      the GPU the device memory in use must not grow after the first
      cycle
  20  qzCompressStreamWithPendingOut - bounded-output drain carry
  21  forkResourceCheck    - a child made by fork compresses and
      decompresses on the CPU with the parent's bytes; on the GPU it is
      also refused a CUDA session (QZ_NOSW_NO_HW); the parent waits
      with a deadline of its own
  22  qzDecompressStreamWithBufferError - bounded decompress drain
  23  (extension) async cross-request batching against the sync loop on
      many small buffers, byte-exact, timing printed

Every session runs on ``--device`` (``cuda``, the default, or ``cpu``);
without a GPU and without ``--device cpu`` the tool exits 1 with
QZ_NOSW_NO_HW.

Usage: python -m qatzip_tpu_torch.tools.qztest -m 4 -t 4 -l 100 -b 65536
       [-A deflate|lz4] [-i inputfile] [-v] [-D comp|decomp|both]
       [-F gzipext] [-C 65536] [-L 1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import gc
import os
import random
import signal
import sys
import threading
import time
import traceback
import weakref

import numpy as np

from .. import params as P
from ..cli import add_device_arg, device_error
from ..constants import (DataFormat, MemType, QZ_BUF_ERROR, QZ_DUPLICATE,
                         QZ_NOSW_NO_HW, QZ_OK, QZ_PARAMS, QzError)
from ..session import QzSession

FMT = {
    "deflate_4B": DataFormat.DEFLATE_4B,
    "gzip": DataFormat.DEFLATE_GZIP,
    "gzipext": DataFormat.DEFLATE_GZIP_EXT,
    "deflate_raw": DataFormat.DEFLATE_RAW,
    "lz4": DataFormat.LZ4,
    "zlib": DataFormat.ZLIB,
}

#: mode 6's out-of-range deflate params (reference qzCheckParams*,
#: src/qatzip_utils.c:385-520): (field of ``common``, value)
BAD_PARAMS = (("hw_buff_sz", 3000),      # not a power of two
              ("hw_buff_sz", 1 << 20),   # > 512K
              ("comp_lvl", 0),           # below the minimum
              ("comp_lvl", 99),          # above the maximum
              ("strm_buff_sz", 100))     # < 1K

#: seconds mode 21's parent waits for its child before it kills it
FORK_TIMEOUT_S = 120.0


def gen_random_data(sz: int, seed: int = 0) -> bytes:
    """genRandomData analog (test/main.c:286) — compressible mix."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 26, sz // 2, dtype=np.uint8) + 97
    rep = np.tile(base[:256], (sz // 2) // 256 + 1)[: sz - len(base)]
    return (np.concatenate([base, rep]).tobytes())[:sz]


def make_session(args, device=None) -> QzSession:
    """A session set up from the flags, on ``device`` (``args.device``
    by default)."""
    sess = QzSession(device or args.device)
    if args.algorithm == "lz4":
        p = P.SessionParamsLZ4()
        p.common.comp_lvl = args.level_arg
        p.common.hw_buff_sz = args.chunk
        rc = sess.setup_lz4(p)
    else:
        p = P.SessionParamsDeflate()
        p.common.comp_lvl = args.level_arg
        p.common.hw_buff_sz = args.chunk
        if args.fmt:
            p.data_fmt = FMT[args.fmt]
        rc = sess.setup_deflate(p)
    if rc != QZ_OK:
        raise QzError(rc, "session setup failed")
    return sess


def with_fmt(args, fmt: str) -> argparse.Namespace:
    """A copy of the flags with ``-F fmt``."""
    a2 = argparse.Namespace(**vars(args))
    a2.fmt = fmt
    return a2


class Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.gbps = []
        self.failures = 0

    def add(self, g):
        with self.lock:
            self.gbps.append(g)

    def fail(self, tid=None, msg=""):
        with self.lock:
            self.failures += 1
        if msg:
            print(f"thread {tid}: {msg}", file=sys.stderr)


def run_mode_2(args, tid, stats):
    """qzMemFuncTest analog (test/main.c mode 2): alloc/free/classify."""
    from ..memory import BufferPool
    pool = BufferPool()
    for _ in range(max(args.loops, 4)):
        a = pool.qz_malloc(4096)
        b = pool.qz_malloc(4096, MemType.COMMON_MEM)
        if pool.qz_mem_find_addr(a) != MemType.PINNED_MEM:
            stats.fail(tid, "pinned classification")
            return
        if pool.qz_mem_find_addr(b) != MemType.COMMON_MEM:
            stats.fail(tid, "common classification")
            return
        a[:] = 0xAA
        pool.qz_free(a)
        pool.qz_free(b)
    if pool.reuse_count == 0:
        stats.fail(tid, "no pool reuse")
        return
    print(f"[INFO] tid={tid} mem functest ok "
          f"(alloc={pool.alloc_count} reuse={pool.reuse_count})")


def run_mode_4(args, tid: int, stats: Stats, direction="both"):
    """qzCompressAndDecompress: ``-l`` loops of compress and/or
    decompress of one buffer, after one compress outside the clock."""
    if args.input:
        with open(args.input, "rb") as f:
            data = f.read()
    else:
        data = gen_random_data(args.block_sz, seed=tid)
    sess = make_session(args)
    comp = sess.compress(data)
    t0 = time.perf_counter()
    nbytes = 0
    for _ in range(args.loops):
        if direction in ("comp", "both"):
            comp = sess.compress(data)
            nbytes += len(data)
        if direction in ("decomp", "both"):
            out = sess.decompress(comp)
            nbytes += len(data)
            if args.verify and out != data:
                stats.fail(tid, "VERIFY FAILED")
                return
    msec = (time.perf_counter() - t0) * 1000
    gbps = nbytes * 8 / (msec / 1000) / 1e9 if msec else 0.0
    stats.add(gbps)
    print(f"[INFO] srv={direction}, tid={tid}, verify={args.verify}, "
          f"count={args.loops}, msec={msec:.0f}, bytes={nbytes}, "
          f"{gbps:.3f} Gbps")


def run_mode_5(args, tid, stats):
    """Format mix: compress in one session, decompress with another
    (parseFormatOption analog, test/main.c:204)."""
    data = gen_random_data(args.block_sz, seed=tid)
    for fmt in ("gzip", "gzipext", "deflate_4B", "zlib"):
        a2 = with_fmt(args, fmt)
        comp = make_session(a2).compress(data)
        if make_session(a2).decompress(comp) != data:
            stats.fail(tid, f"fmt {fmt} mismatch")
            return
    print(f"[INFO] tid={tid} format-mix ok")


def run_mode_6(args, tid, stats):
    """qzSetupParamFuncTest analog: out-of-range session params must be
    rejected (``BAD_PARAMS``)."""
    for i, (field, value) in enumerate(BAD_PARAMS):
        bad = P.SessionParamsDeflate()
        setattr(bad.common, field, value)
        if QzSession(args.device).setup_deflate(bad) == QZ_OK:
            stats.fail(tid, f"bad param case {i} accepted")
            return
    if QzSession(args.device).setup_deflate(P.SessionParamsDeflate()) != QZ_OK:
        stats.fail(tid, "good params rejected")
        return
    print(f"[INFO] tid={tid} param functest ok")


def run_mode_7(args, tid, stats):
    """qzDecompressSwQz analog: buffers produced by software zlib and gzip
    decode through the session."""
    import gzip as _gz
    import zlib
    data = gen_random_data(args.block_sz, seed=tid)
    if make_session(with_fmt(args, "zlib")).decompress(
            zlib.compress(data, 1)) != data:
        stats.fail(tid, "sw zlib decode")
        return
    gz = make_session(with_fmt(args, "gzip"))
    if gz.decompress(_gz.compress(data, 1)) != data:
        stats.fail(tid, "sw gzip decode")
        return
    # multi-member concatenation
    two = (_gz.compress(data[: len(data) // 2], 1)
           + _gz.compress(data[len(data) // 2:], 1))
    if gz.decompress(two) != data:
        stats.fail(tid, "sw gzip multi-member decode")
        return
    print(f"[INFO] tid={tid} sw->qz decode ok")


def run_mode_8(args, tid, stats):
    """qzCompressDecompressSwQZMixed analog: the engine's output decodes
    with the software codec and back, interleaved."""
    from ..sw import codec as swc
    data = gen_random_data(args.block_sz, seed=tid)
    a2 = with_fmt(args, args.fmt or "gzipext")
    fmt = FMT[a2.fmt]
    sess = make_session(a2)
    for _ in range(max(args.loops // 2, 2)):
        accel = sess.compress(data)
        out, _cons, _crc = swc.sw_decompress_multi(accel, fmt, None)
        if out != data:
            stats.fail(tid, "accel->sw mismatch")
            return
        sw_blob, _ = swc.sw_compress(data, fmt, 1, args.chunk)
        if sess.decompress(sw_blob) != data:
            stats.fail(tid, "sw->accel mismatch")
            return
    print(f"[INFO] tid={tid} mixed sw/qz ok")


def run_mode_9(args, tid, stats):
    from ..stream import QzStream
    data = gen_random_data(args.block_sz * 4, seed=tid)
    strm = QzStream(make_session(args))
    out = bytearray()
    step = max(args.block_sz // 3, 1)
    for off in range(0, len(data), step):
        last = off + step >= len(data)
        out += strm.compress(data[off:off + step], last=last)
    strm.end()
    strm2 = QzStream(make_session(args))
    dec = bytearray()
    comp = bytes(out)
    for off in range(0, len(comp), 4096):
        last = off + 4096 >= len(comp)
        dec += strm2.decompress(comp[off:off + 4096], last=last)
    strm2.end()
    if bytes(dec) != data:
        stats.fail(tid, f"stream mismatch {len(dec)} vs {len(data)}")
        return
    print(f"[INFO] tid={tid} streaming ok")


def run_mode_10(args, tid, stats):
    """qzCompressStreamOnCommonMem analog: a stream fed from COMMON
    (unpinned, non-bytes) buffers: memoryviews of a bytearray."""
    from ..stream import QzStream
    data = gen_random_data(args.block_sz * 2, seed=tid)
    strm = QzStream(make_session(args), strm_buff_sz=8192)
    out = bytearray()
    src = bytearray(data)               # COMMON mutable buffer
    step = 3000
    for off in range(0, len(src), step):
        last = off + step >= len(src)
        out += strm.compress(memoryview(src)[off:off + step], last=last)
    strm.end()
    if make_session(args).decompress(bytes(out)) != data:
        stats.fail(tid, "common-mem stream mismatch")
        return
    print(f"[INFO] tid={tid} common-mem streaming ok")


def run_mode_11(args, tid, stats):
    """qzCompressStreamOutput analog: stream output decodes through the
    one-shot API."""
    from ..stream import QzStream
    data = gen_random_data(args.block_sz * 2, seed=tid)
    strm = QzStream(make_session(args), strm_buff_sz=4096)
    out = bytearray()
    pos = 0
    step = 577  # deliberately unaligned
    while pos < len(data):
        last = pos + step >= len(data)
        out += strm.compress(data[pos:pos + step], last=last)
        pos += step
    strm.end()
    if make_session(args).decompress(bytes(out)) != data:
        stats.fail(tid, "stream-output one-shot decode mismatch")
        return
    print(f"[INFO] tid={tid} stream-output ok")


def run_mode_12(args, tid, stats):
    """qzDecompressStreamInput analog: one-shot output decodes through
    the stream API in pieces."""
    from ..stream import QzStream
    data = gen_random_data(args.block_sz * 2, seed=tid)
    comp = make_session(args).compress(data)
    strm = QzStream(make_session(args))
    dec = bytearray()
    step = 1111
    for off in range(0, len(comp), step):
        last = off + step >= len(comp)
        dec += strm.decompress(comp[off:off + step], last=last)
    strm.end()
    if bytes(dec) != data:
        stats.fail(tid, "decompress-stream input mismatch")
        return
    print(f"[INFO] tid={tid} decompress-stream input ok")


def run_mode_13(args, tid, stats):
    """qzCompressStreamInvalidChunkSize analog: out-of-range strm_buff_sz
    is rejected with QZ_PARAMS."""
    from ..stream import QzStream
    sess = make_session(args)
    for bad in (0, 100, 4 * 1024 * 1024):
        try:
            QzStream(sess, strm_buff_sz=bad)
            stats.fail(tid, f"strm_buff_sz {bad} accepted")
            return
        except QzError as e:
            if e.rc != QZ_PARAMS:
                stats.fail(tid, f"wrong rc {e.rc}")
                return
    print(f"[INFO] tid={tid} invalid-chunk-size ok")


def run_mode_14(args, tid, stats):
    """qzCompressStreamInvalidQzStreamParam analog: an ended stream's
    operations fail cleanly."""
    from ..stream import QzStream, qz_compress_stream, qz_decompress_stream
    sess = make_session(args)
    strm = QzStream(sess)
    strm.end()
    rc, _out = qz_compress_stream(sess, strm, b"late data", 1)
    if rc == QZ_OK:
        stats.fail(tid, "compress on ended stream accepted")
        return
    rc, _out = qz_decompress_stream(sess, strm, b"late data", 1)
    if rc == QZ_OK:
        stats.fail(tid, "decompress on ended stream accepted")
        return
    print(f"[INFO] tid={tid} invalid-stream-params ok")


def run_mode_15(args, tid, stats):
    """qzDecompressStreamNegParam analog: garbage and truncated input
    through the decompress stream raise QzError."""
    from ..stream import QzStream
    strm = QzStream(make_session(args))
    try:
        strm.decompress(b"\x00" * 64, last=True)
        stats.fail(tid, "garbage accepted")
        return
    except QzError:
        pass
    comp = make_session(args).compress(gen_random_data(8192, seed=tid))
    strm2 = QzStream(make_session(args))
    try:
        strm2.decompress(comp[: len(comp) // 3], last=True)
        stats.fail(tid, "truncated accepted")
        return
    except QzError:
        pass
    strm2.end()
    print(f"[INFO] tid={tid} decompress-neg-param ok")


def run_mode_16(args, tid, stats):
    """qzEndStreamNegParam analog: ``end`` is idempotent and a compress
    after it fails."""
    from ..stream import QzStream, qz_end_stream
    sess = make_session(args)
    strm = QzStream(sess)
    if qz_end_stream(sess, strm) != QZ_OK:
        stats.fail(tid, "end failed")
        return
    if qz_end_stream(sess, strm) != QZ_OK:   # double end is OK (idempotent)
        stats.fail(tid, "double end failed")
        return
    try:
        strm.compress(b"x", last=True)
        stats.fail(tid, "compress after end accepted")
        return
    except QzError:
        pass
    print(f"[INFO] tid={tid} end-stream-neg ok")


def run_mode_17(args, tid, stats):
    """Software <-> engine equivalence (qzFuncTests analog,
    test/main.c:3453)."""
    import zlib
    data = gen_random_data(args.block_sz, seed=tid)
    sess = make_session(args)
    # 1. the engine's output decodes with stock zlib
    comp = sess.compress(data)
    pieces, pos = [], 0
    while pos < len(comp):
        do = zlib.decompressobj(31)
        pieces.append(do.decompress(comp[pos:]) + do.flush())
        used = len(comp) - pos - len(do.unused_data)
        if used <= 0:
            break
        pos += used
    if b"".join(pieces) != data:
        stats.fail(tid, "stock zlib decode mismatch")
        return
    # 2. a software zlib buffer decodes through the session
    if make_session(with_fmt(args, "zlib")).decompress(
            zlib.compress(data, 1)) != data:
        stats.fail(tid, "session zlib decode mismatch")
        return
    # 3. negative: a truncated buffer must raise, not crash
    try:
        sess.decompress(comp[: len(comp) // 3])
    except QzError:
        pass
    print(f"[INFO] tid={tid} functests ok")


def run_mode_18(args, tid, stats):
    rng = random.Random(tid)
    data = gen_random_data(args.block_sz, seed=tid)
    sess = make_session(args)
    for _ in range(max(args.loops // 10, 3)):
        time.sleep(rng.random() * 0.01)
        comp = sess.compress(data)
        time.sleep(rng.random() * 0.01)
        if sess.decompress(comp) != data:
            stats.fail(tid, "thread-safety mismatch")
            return
    print(f"[INFO] tid={tid} thread-safety ok")


_MODE19_LOCK = threading.Lock()


def _device_memory(device: str) -> int:
    """The device memory torch's tensors hold on ``device`` (0 on the
    CPU)."""
    import torch
    gc.collect()
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def run_mode_19(args, tid, stats):
    """qzInitPcieCountCheck analog: four cycles of ``Runtime.init``, a
    round trip on a new engine and ``Runtime.close``, then init again.
    After each close the cycle's engine must be gone (from the second
    cycle on: the first may take an engine that other sessions hold),
    and the device memory in use must not grow from the second cycle to
    the last. Serialized across ``-t`` threads: the runtime is
    process-wide, and a sibling's close would drop this thread's
    engines."""
    from ..runtime import get_runtime
    rt = get_runtime()
    data = gen_random_data(args.block_sz, seed=tid)
    used = []
    with _MODE19_LOCK:
        for cycle in range(4):
            rc = rt.init(args.device, 1)
            if rc != QZ_OK and not (cycle == 0 and rc == QZ_DUPLICATE):
                stats.fail(tid, f"init rc {rc} in cycle {cycle}")
                return
            sess = make_session(args)
            if sess.decompress(sess.compress(data)) != data:
                stats.fail(tid, f"round trip failed in cycle {cycle}")
                return
            engine = weakref.ref(sess._engine)
            del sess
            if rt.close() != QZ_OK:
                stats.fail(tid, "close failed")
                return
            used.append(_device_memory(args.device))
            if cycle and engine() is not None:
                stats.fail(tid, f"the engine outlived close in cycle {cycle}")
                return
        rt.init(args.device, 1)
    if max(used[1:]) > used[1]:
        stats.fail(tid, f"device memory grew over the cycles: {used}")
        return
    print(f"[INFO] tid={tid} init/close ok (device memory after each "
          f"close {used} bytes)")


def run_mode_20(args, tid, stats):
    """qzCompressStreamWithPendingOut analog: a bounded output budget
    forces pending_out carry; draining must reassemble the stream."""
    from ..stream import QzStream
    data = gen_random_data(args.block_sz * 2, seed=tid)
    strm = QzStream(make_session(args), strm_buff_sz=4096)
    out = bytearray()
    pos = 0
    while pos < len(data):
        piece = data[pos:pos + 6000]
        pos += len(piece)
        out += strm.compress(piece, last=(pos >= len(data)), max_out=256)
    saw_pending = bool(strm.pending_out)
    while strm.pending_out:
        blob = strm.compress(b"", max_out=256)
        if len(blob) > 256:
            stats.fail(tid, "max_out exceeded")
            return
        out += blob
    strm.end()
    if not saw_pending:
        stats.fail(tid, "pending_out never engaged")
        return
    if make_session(args).decompress(bytes(out)) != data:
        stats.fail(tid, "pending-out roundtrip mismatch")
        return
    print(f"[INFO] tid={tid} pending-out ok")


def _fork_child(args, data: bytes, comp: bytes, route: bool) -> int:
    """Mode 21's child: 0 when its CPU session gives the parent's bytes
    and decodes them, and (after CUDA came up in the parent) a CUDA
    session is refused with QZ_NOSW_NO_HW naming the spawn start method;
    else the number of the check that failed."""
    import torch
    # libgomp's thread pool is not fork-safe: one intra-op thread before
    # any torch op, as torch's DataLoader workers do
    torch.set_num_threads(1)
    sess = make_session(args, "cpu")
    # the parent's engine picked ``route``; the CPU engine takes it too,
    # so both run the same kernels (their plain versions here)
    sess._engine.packs_on_device = lambda *_a, **_k: route
    if sess.compress(data) != comp:
        return 4
    if sess.decompress(comp) != data:
        return 5
    if args.device == "cuda" or torch.cuda._is_in_bad_fork():
        try:
            QzSession("cuda")
            return 6
        except QzError as e:
            if e.rc != QZ_NOSW_NO_HW or "spawn" not in str(e):
                return 7
    return 0


def run_mode_21(args, tid, stats):
    """forkResourceCheck analog: the parent compresses, forks, and waits
    for the child (``_fork_child``) with a deadline: a child that hangs
    is killed and fails the mode."""
    data = gen_random_data(args.block_sz, seed=tid)
    sess = make_session(args)
    comp = sess.compress(data)
    route = sess._engine.packs_on_device(False, sess.algorithm)
    pid = os.fork()
    if pid == 0:
        code = 2
        try:
            code = _fork_child(args, data, comp, route)
        except Exception:  # noqa: BLE001 (reported; the finally ends the child)
            traceback.print_exc()
        finally:
            os._exit(code)
    deadline = time.monotonic() + FORK_TIMEOUT_S
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        if time.monotonic() > deadline:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
            stats.fail(tid, f"fork child hung past {FORK_TIMEOUT_S:.0f} s")
            return
        time.sleep(0.02)
    code = os.waitstatus_to_exitcode(status)
    if code != 0:
        stats.fail(tid, f"fork child failed (exit code {code})")
        return
    print(f"[INFO] tid={tid} fork ok")


def run_mode_22(args, tid, stats):
    """qzDecompressStreamWithBufferError analog: undersized destination
    budgets on both APIs: qz_compress / qz_decompress report
    QZ_BUF_ERROR, the stream API carries pending_out."""
    from ..session import qz_compress, qz_decompress
    from ..stream import QzStream
    data = gen_random_data(args.block_sz, seed=tid)
    sess = make_session(args)
    rc, _c, _p = qz_compress(sess, data, bytearray(4))
    if rc != QZ_BUF_ERROR:
        stats.fail(tid, "compress buf-error missing")
        return
    comp = sess.compress(data)
    rc, _c, _p = qz_decompress(make_session(args), comp, bytearray(4))
    if rc != QZ_BUF_ERROR:
        stats.fail(tid, "decompress buf-error missing")
        return
    strm = QzStream(make_session(args))
    got = bytearray(strm.decompress(comp, last=True, max_out=512))
    while strm.pending_out:
        piece = strm.decompress(b"", max_out=512)
        if len(piece) > 512:
            stats.fail(tid, "max_out exceeded")
            return
        got += piece
    strm.end()
    if bytes(got) != data:
        stats.fail(tid, "bounded decompress mismatch")
        return
    print(f"[INFO] tid={tid} buffer-error ok")


_MODE23_LOCK = threading.Lock()


def run_mode_23(args, tid, stats):
    """Extension mode (not in the reference's 22): many small buffers
    through the async engine against the sync loop; the async engine
    batches a drained batch into one engine dispatch
    (``QzSession.compress_batch``). Results are byte-exact; the timing
    is printed, not asserted.

    Serialized across ``-t`` threads: the async runtime is process-wide
    and ``aqz_stop`` is not reference counted, so concurrent init / stop
    pairs would stop a sibling thread's run."""
    from .. import async_engine as ae

    nbuf = max(args.loops * 8, 64)
    bufs = [gen_random_data(4096, seed=tid * 1000 + i) + bytes([i & 0xFF])
            for i in range(nbuf)]
    sess = make_session(args)

    t0 = time.perf_counter()
    sync_out = [sess.compress(b) for b in bufs]
    sync_s = time.perf_counter() - t0

    with _MODE23_LOCK:
        ae.aqz_init(num_threads=1, ring_depth=max(nbuf, 128))
        try:
            asess = ae.AQzSession(sess)
            got = {}
            done = threading.Event()

            def cb(ext, src, dest, rc, crc):
                got[ext] = (dest, rc)
                if len(got) == nbuf:
                    done.set()

            t0 = time.perf_counter()
            for i, b in enumerate(bufs):
                while True:
                    rc = asess.compress(b, cb, external=i)
                    if rc == ae.AQZ_OK:
                        break
                    if rc != ae.AQZ_NO_SPACE:    # STOPPED etc: do not spin
                        stats.fail(tid, f"async submit rc={rc}")
                        return
                    time.sleep(0.001)
            if not done.wait(120):
                stats.fail(tid, "async requests did not complete")
                return
            async_s = time.perf_counter() - t0
        finally:
            ae.aqz_stop()

    dec = make_session(args)
    for i, b in enumerate(bufs):
        dest, rc = got[i]
        if rc != QZ_OK or dec.decompress(dest) != b:
            stats.fail(tid, f"async result {i} wrong")
            return
        if dest != sync_out[i]:
            stats.fail(tid, f"async result {i} differs from sync")
            return
    print(f"[INFO] tid={tid} async-batching: sync={sync_s*1e3:.0f}ms "
          f"async={async_s*1e3:.0f}ms "
          f"({'faster' if async_s < sync_s else 'slower'}, "
          f"{nbuf} x 4KB buffers)")


MODES = {2: run_mode_2, 4: run_mode_4, 5: run_mode_5, 6: run_mode_6,
         7: run_mode_7, 8: run_mode_8, 9: run_mode_9, 10: run_mode_10,
         11: run_mode_11, 12: run_mode_12, 13: run_mode_13,
         14: run_mode_14, 15: run_mode_15, 16: run_mode_16,
         17: run_mode_17, 18: run_mode_18, 19: run_mode_19,
         20: run_mode_20, 21: run_mode_21, 22: run_mode_22,
         23: run_mode_23}

REMOVED_MODES = (1, 3)   # the reference's own skip semantics


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qztest")
    p.add_argument("-m", dest="mode", type=int, default=4)
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("-l", dest="loops", type=int, default=2)
    p.add_argument("-b", dest="block_sz", type=int, default=65536)
    p.add_argument("-C", dest="chunk", type=int, default=64 * 1024)
    p.add_argument("-L", dest="level_arg", type=int, default=1)
    p.add_argument("-A", dest="algorithm", default="deflate")
    p.add_argument("-F", dest="fmt", default=None, choices=list(FMT))
    p.add_argument("-i", dest="input", default=None)
    p.add_argument("-v", dest="verify", action="store_true")
    p.add_argument("-D", dest="direction", default="both",
                   choices=["comp", "decomp", "both"])
    add_device_arg(p)
    args = p.parse_args(argv)

    fn = MODES.get(args.mode)
    if fn is None and args.mode not in REMOVED_MODES:
        print(f"unsupported mode {args.mode}; have {sorted(MODES)}",
              file=sys.stderr)
        return 2
    if device_error("qztest", args.device):
        return 1
    if fn is None:
        # reference: QZ_ERROR("Test mode N has been removed\n"); return 0
        print(f"Test mode {args.mode} has been removed", file=sys.stderr)
        return 0
    stats = Stats()

    def runner(tid):
        try:
            if args.mode == 4:
                run_mode_4(args, tid, stats, args.direction)
            else:
                fn(args, tid, stats)
        except Exception as e:  # noqa: BLE001 (a thread's error fails it)
            traceback.print_exc()
            stats.fail(tid, f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=runner, args=(i,))
               for i in range(args.threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if stats.gbps:
        print(f"[TOTAL] threads={args.threads} sum={sum(stats.gbps):.3f} "
              f"Gbps wall={wall*1000:.0f} msec")
    if stats.failures:
        print(f"[FAIL] {stats.failures} thread(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
