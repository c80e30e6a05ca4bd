"""soak: a randomized soak across the session's surfaces, on the GPU.

Counterpart of ``tools/soak.py``: sessions x deflate framings x levels
1-9 x chunk sizes (``hw_buff_sz`` 4 KiB-128 KiB) x request sizes up to
800 KB, the stream API in random pieces, LZ4 frames and async batches,
with stock zlib decoding the gzip and raw framings. Every failure prints
its reproducing seed (``FAIL iter= surface= seed= n= kind=``) and
raises. The long-running cousin of the unit tests, after the
reference's hammer modes (test/main.c -m 4/17/18):

    python -m qatzip_tpu_torch.tools.soak --iters 300             # the GPU
    python -m qatzip_tpu_torch.tools.soak --iters 8 --device cpu

The level and the chunk size are set on the session params' ``common``
fields, where they live, so both vary from request to request.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
import zlib

import numpy as np

from .. import aqz_init, aqz_stop, AQzSession, QzSession, QzStream
from .. import params as P
from ..cli import add_device_arg, device_error
from ..constants import DataFormat, QZ_OK

FMTS = (DataFormat.DEFLATE_GZIP_EXT, DataFormat.DEFLATE_GZIP,
        DataFormat.DEFLATE_RAW, DataFormat.DEFLATE_4B)
HW_SIZES = (4096, 16384, 65536, 131072)


def check(cond, what: str) -> None:
    """Raise ``what`` unless ``cond`` (a check that ``-O`` keeps)."""
    if not cond:
        raise AssertionError(what)


def corpus(rng, n, kind):
    if kind == 0:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 1:
        return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()
    if kind == 2:
        base = rng.integers(32, 127, max(n // 17, 1),
                            dtype=np.uint8).tobytes()
        return (base * 40)[:n]
    if kind == 3:
        return bytes(n)
    words = [b"the ", b"of ", b"tpu ", b'<row id="%d"/>' % int(n), b"\n"]
    return b"".join(words[int(i) % 5]
                    for i in rng.integers(0, 5, max(n // 3, 1)))[:n]


def iterations(seed: int, iters: int):
    """The soak's requests: (iteration, its seed, its rng, n, corpus
    kind, data, surface) for each iteration; the surfaces take turns
    (0 deflate, 1 stream, 2 LZ4, 3 async)."""
    master = np.random.default_rng(seed)
    for it in range(iters):
        it_seed = int(master.integers(0, 2**31))
        rng = np.random.default_rng(it_seed)
        n = int(rng.integers(0, 800000))
        kind = int(rng.integers(0, 5))
        yield it, it_seed, rng, n, kind, corpus(rng, n, kind), it % 4


def deflate_case(rng):
    """A deflate request's (level, framing, hw_buff_sz), drawn in the
    JAX soak's order."""
    level = int(rng.integers(1, 10))
    fmt = FMTS[int(rng.integers(0, len(FMTS)))]
    hw = int(rng.choice(HW_SIZES))
    return level, fmt, hw


def deflate_session(device, level: int, fmt, hw: int) -> QzSession:
    s = QzSession(device)
    p = P.SessionParamsDeflate()
    p.common.comp_lvl = level
    p.common.hw_buff_sz = hw
    p.data_fmt = fmt
    check(s.setup_deflate(p) == QZ_OK, "setup_deflate")
    return s


def check_deflate(device, data, level, fmt, hw) -> bytes:
    s = deflate_session(device, level, fmt, hw)
    blob = s.compress(data)
    check(s.decompress(blob) == data, "self round-trip")
    if fmt in (DataFormat.DEFLATE_GZIP_EXT, DataFormat.DEFLATE_GZIP):
        # stock multi-member decode
        pos, pieces = 0, []
        while pos < len(blob):
            do = zlib.decompressobj(31)
            pieces.append(do.decompress(blob[pos:]) + do.flush())
            rem = len(do.unused_data)
            if rem == 0:
                break
            pos = len(blob) - rem
        check(b"".join(pieces) == data, "stock zlib decode")
    elif fmt == DataFormat.DEFLATE_RAW:
        do = zlib.decompressobj(-15)
        check(do.decompress(blob) + do.flush() == data, "stock raw inflate")
    return blob


def check_stream(device, rng, data):
    s = QzSession(device)
    s.setup_deflate()
    strm = QzStream(s)
    out = b""
    pos = 0
    while pos < len(data):
        step = int(rng.integers(1, 200000))
        piece = data[pos:pos + step]
        pos += len(piece)
        out += strm.compress(piece, last=(pos >= len(data)))
    if not data:
        out += strm.compress(b"", last=True)
    strm.end()
    check(s.decompress(out) == data, "stream round-trip")


def check_lz4(device, data):
    s = QzSession(device)
    s.setup_lz4(P.SessionParamsLZ4())
    blob = s.compress(data)
    check(s.decompress(blob) == data, "lz4 round-trip")


def check_async(device, datas):
    aqz_init(num_threads=2)
    results = {}
    done = threading.Event()
    remaining = [len(datas)]

    def cb(i):
        def _cb(ext, src, dest, rc, crc):
            results[i] = bytes(dest)
            remaining[0] -= 1
            if remaining[0] == 0:
                done.set()
        return _cb

    try:
        sess = AQzSession(device=device)
        sess.setup_deflate()
        for i, d in enumerate(datas):
            while sess.compress(d, callback=cb(i)) != 0:
                time.sleep(0.001)        # AQZ_NO_SPACE: ring full, retry
        check(done.wait(timeout=120), "async completion timeout")
    finally:
        aqz_stop()
    dec = QzSession(device)
    dec.setup_deflate()
    for i, d in enumerate(datas):
        check(dec.decompress(results[i]) == d, f"async req {i}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="soak",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if device_error("soak", args.device):
        return 1
    t0 = time.perf_counter()
    for it, seed, rng, n, kind, data, surface in iterations(args.seed,
                                                            args.iters):
        try:
            if surface == 0:
                check_deflate(args.device, data, *deflate_case(rng))
            elif surface == 1:
                check_stream(args.device, rng, data)
            elif surface == 2:
                check_lz4(args.device, data)
            else:
                datas = [corpus(rng, int(rng.integers(0, 150000)),
                                int(rng.integers(0, 5)))
                         for _ in range(int(rng.integers(1, 6)))]
                check_async(args.device, datas)
        except Exception:
            print(f"FAIL iter={it} surface={surface} seed={seed} "
                  f"n={n} kind={kind}", file=sys.stderr)
            raise
        if (it + 1) % 25 == 0:
            print(f"{it + 1}/{args.iters} ok", flush=True)
    dt = time.perf_counter() - t0
    print(f"soak: all clear ({args.iters} iterations in {dt:.3f} s, "
          f"{args.iters / dt:.3f} iterations/s on {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
