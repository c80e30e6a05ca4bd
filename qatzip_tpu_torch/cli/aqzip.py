"""aqzip — async CLI sample driving the callback engine.

Parity reference: utils/aqzip.c (:238-360, :616-795): files are split into
requests submitted through the non-blocking aqz API with an inflight
window; completions arrive via callback and are stitched in submission
order; the digest sample verifies a SHA-256 of the round trip
(calSWDigest, utils/aqzip.c:163).

Counterpart of ``qatzip_tpu/cli/aqzip.py``: the same flags, messages and
exit codes, and --device {cuda,cpu} (default cuda).

Usage: python -m qatzip_tpu_torch.cli.aqzip [-d] [-t threads] [-w window] files...
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import threading
import time

from ..async_engine import AQzSession, aqz_init, aqz_stop, AQZ_OK, AQZ_NO_SPACE
from ..constants import QZ_OK
from . import add_device_arg, device_error


def _build_parser():
    p = argparse.ArgumentParser(prog="aqzip")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-k", "--keep", action="store_true")
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite existing output files")
    p.add_argument("-t", dest="threads", type=int, default=2)
    p.add_argument("-w", dest="window", type=int, default=16,
                   help="max inflight requests")
    p.add_argument("-C", dest="chunk", type=int, default=4 * 1024 * 1024,
                   help="request granularity in bytes")
    p.add_argument("--digest", action="store_true",
                   help="print SHA-256 of the output (verify sample)")
    add_device_arg(p)
    p.add_argument("files", nargs="+")
    return p


def process_file(args, name: str) -> int:
    if args.decompress:
        if not name.endswith(".gz"):
            print(f"aqzip: {name}: unknown suffix -- ignored",
                  file=sys.stderr)
            return 1
        out_name = name[:-3]
    else:
        out_name = name + ".gz"
    if os.path.exists(out_name) and not args.force:
        # reference aqzip refuses existing outputs without -f
        print(f"aqzip: {out_name} already exists; use -f to force",
              file=sys.stderr)
        return 1
    sess = AQzSession(device=args.device)
    sess.setup_deflate()

    results = {}
    done = threading.Event()
    lock = threading.Lock()
    expected = 0

    def cb(external, src, dest, rc, crc):
        with lock:
            results[external] = (rc, dest)
            if len(results) == expected:
                done.set()

    with open(name, "rb") as fh:
        if args.decompress:
            # gzip members may straddle arbitrary byte offsets, so the
            # whole file is one request — requests are the unit of
            # decomposition only for compression, where we control the
            # member framing (reference aqzip decompresses per complete
            # compressed buffer as well)
            pieces = [fh.read()]
        else:
            pieces = []
            while True:
                b = fh.read(args.chunk)
                if not b:
                    break
                pieces.append(b)
    expected = len(pieces)
    if expected == 0:
        pieces = [b""]
        expected = 1

    t0 = time.perf_counter()
    inflight_sem = threading.Semaphore(args.window)
    for i, piece in enumerate(pieces):
        inflight_sem.acquire()

        def cb_rel(external, src, dest, rc, crc, _cb=cb):
            inflight_sem.release()
            _cb(external, src, dest, rc, crc)

        while True:
            rc = (sess.decompress(piece, cb_rel, external=i)
                  if args.decompress
                  else sess.compress(piece, cb_rel, external=i))
            if rc == AQZ_OK:
                break
            if rc == AQZ_NO_SPACE:
                time.sleep(0.001)  # ring full — retry (reference behavior)
                continue
            print(f"aqzip: submit failed rc={rc}", file=sys.stderr)
            return 1
    if not done.wait(timeout=600):
        print("aqzip: timeout waiting for completions", file=sys.stderr)
        return 1
    secs = time.perf_counter() - t0

    total_out = 0
    h = hashlib.sha256()
    with open(out_name, "wb") as out:
        for i in range(expected):
            rc, dest = results[i]
            if rc != QZ_OK:
                print(f"aqzip: request {i} failed rc={rc}", file=sys.stderr)
                return 1
            out.write(dest)
            h.update(dest)
            total_out += len(dest)
    total_in = sum(len(p) for p in pieces)
    print(f"aqzip: {name}: {total_in} -> {total_out} bytes in "
          f"{secs*1000:.0f} ms ({total_in*8/max(secs,1e-9)/1e6:.0f} Mbit/s)",
          file=sys.stderr)
    if args.digest:
        print(h.hexdigest())
    if not args.keep:
        os.unlink(name)
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if device_error("aqzip", args.device):
        return 1
    aqz_init(num_threads=args.threads)
    try:
        rc = 0
        for name in args.files:
            if not os.path.exists(name):
                print(f"aqzip: {name}: No such file or directory",
                      file=sys.stderr)
                rc = 1
                continue
            rc |= process_file(args, name)
        return rc
    finally:
        aqz_stop()


if __name__ == "__main__":
    sys.exit(main())
