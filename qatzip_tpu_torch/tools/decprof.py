"""decprof: the decompress path's host stages, timed one by one.

Counterpart of ``tools/decprof.py``. It compresses a corpus with
``QzSession`` on ``--device`` (gzip-ext, level 1, dynamic Huffman: the
main path), then times the stages of the gzip-ext fast path in
``codec.decompress_buffer`` apart: the member scan (``scan_gzipext``),
the batched native inflate (``inflate_batch_bytes``), the crc fold
(``crc32_combine_many``), the end-to-end ``decompress`` and the rest it
does not account for; then the batch inflate at 1, 2, 4, 8, 16 and 32
threads, and the one-thread rate of each of eight member groups (member
index maps onto the corpus in order, so a slow group names a slow
region). Each time is the best of a few runs on the host clock: the
decode runs on the host whatever the device. The first line names the
card and its power limit (``nvidia-smi``). Run it on a quiet machine:
contention skews every stage.

    python -m qatzip_tpu_torch.tools.decprof                    # on the card
    python -m qatzip_tpu_torch.tools.decprof --device cpu --mb 2
    python -m qatzip_tpu_torch.tools.decprof --file some.bin

Without ``--file`` the corpus is ``tools.distrun.make_corpus(--mb)``.
No GPU and no ``--device cpu``: exit 1 with the runtime's error.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from .. import QzSession, native
from ..cli import add_device_arg, device_error
from .distrun import make_corpus


def best_of(fn, iters: int = 5) -> float:
    """The least host time of ``iters`` calls of ``fn``, in seconds."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def card_line(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    what stands in for them on the CPU."""
    if device == "cpu":
        return "card: none (--device cpu)"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        first = r.stdout.strip().splitlines()[:1]
        return "card: " + (first[0] if first else "nvidia-smi said nothing")
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi failed ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="decprof",
                                 description=__doc__.splitlines()[0])
    add_device_arg(ap)
    ap.add_argument("--mb", type=int, default=64,
                    help="MiB of the tool's corpus (default 64)")
    ap.add_argument("--file", help="profile this file instead")
    args = ap.parse_args(argv)
    if device_error("decprof", args.device):
        return 1
    print(card_line(args.device), flush=True)
    if args.file:
        with open(args.file, "rb") as f:
            corpus = f.read()
    else:
        corpus = make_corpus(args.mb)
    n = len(corpus)
    s = QzSession(device=args.device)
    s.setup_deflate()
    blob = s.compress(corpus)
    print(f"corpus {n >> 20} MB -> blob {len(blob) >> 20} MB "
          f"(ratio {n / len(blob):.3f}), compressed on {args.device}")

    lib = native.get_lib()
    scanned = lib.scan_gzipext(blob)
    if scanned is None or scanned[4] != len(blob):
        raise RuntimeError("the session's output is not strict gzip-ext")
    in_offs, in_lens, sizes, _want_crcs, _consumed = scanned
    print(f"members: {len(in_offs)}")

    t_scan = best_of(lambda: lib.scan_gzipext(blob))
    t_inf = best_of(lambda: lib.inflate_batch_bytes(blob, in_offs, in_lens,
                                                    sizes))
    out, crcs, _out_lens, _in_used = lib.inflate_batch_bytes(
        blob, in_offs, in_lens, sizes)
    if out != corpus:
        raise RuntimeError("the batch inflate does not give back the corpus")
    t_crc = best_of(lambda: lib.crc32_combine_many(
        [int(c) for c in crcs], sizes.tolist()))
    t_e2e = best_of(lambda: s.decompress(blob))

    def rate(t):
        return n / t / 1e9

    print(f"scan_gzipext:        {t_scan * 1e3:8.2f} ms")
    print(f"inflate_batch_bytes: {t_inf * 1e3:8.2f} ms  "
          f"({rate(t_inf):.3f} GB/s)")
    print(f"crc_combine_many:    {t_crc * 1e3:8.2f} ms")
    print(f"e2e decompress:      {t_e2e * 1e3:8.2f} ms  "
          f"({rate(t_e2e):.3f} GB/s)")
    print(f"unaccounted:         "
          f"{(t_e2e - t_scan - t_inf - t_crc) * 1e3:8.2f} ms")

    # thread scaling of the batch inflate
    for nt in (1, 2, 4, 8, 16, 32):
        t = best_of(lambda nt=nt: lib.inflate_batch_bytes(
            blob, in_offs, in_lens, sizes, nthreads=nt), iters=3)
        print(f"  inflate nthreads={nt:<3d} {t * 1e3:8.2f} ms "
              f"({rate(t):.3f} GB/s)")

    # one-thread decode rate of each member group
    nm = len(in_offs)
    groups = min(8, nm)
    per = nm // groups
    for g in range(groups):
        lo, hi = g * per, (g + 1) * per if g < groups - 1 else nm
        t = best_of(lambda lo=lo, hi=hi: lib.inflate_batch_bytes(
            blob, in_offs[lo:hi], in_lens[lo:hi], sizes[lo:hi],
            nthreads=1), iters=3)
        sz = int(sizes[lo:hi].sum())
        csz = int(in_lens[lo:hi].sum())
        print(f"  members [{lo:4d},{hi:4d}) {sz >> 20:3d} MB "
              f"ratio {sz / max(csz, 1):6.2f}  1-thread "
              f"{sz / t / 1e6:7.0f} MB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
