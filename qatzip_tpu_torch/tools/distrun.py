"""distrun: a multi-process ``torch.distributed`` compress run, executed.

Counterpart of ``tools/distrun.py``. The reference proves process-DP by
running N processes and summing their Gbps
(test/performance_tests/run_perf_test.sh:106-125). This tool starts N
worker processes; each

  1. joins a gloo process group on a free localhost port
     (``parallel.multihost.init_distributed``) and checks its rank and
     the world size,
  2. runs a real ``torch.distributed.all_gather`` of its stripe's byte
     count and checks that the sum is the corpus size,
  3. compresses its round-robin chunk stripe
     (``parallel.multihost.compress_striped``) and reports bytes and
     wall time;

the parent interleaves the stripes back into submission order, checks
every member with stock zlib and every crc with ``zlib.crc32``, and
prints the summed Gbps in one JSON line.

Usage:
    python -m qatzip_tpu_torch.tools.distrun --procs 2  # on the card
    python -m qatzip_tpu_torch.tools.distrun --procs 2 --mb 4 --engine sw
    python -m qatzip_tpu_torch.tools.distrun --procs 2 --mb 1 --device cpu

``--engine device`` (the default) compresses on the runtime's engine for
``--device`` (default ``cuda``; both processes may share one card);
``--engine sw`` on the host engine (the software coder). The corpus
is the tool's own deterministic mix (``make_corpus``). Exit code 0: the
group, the collective and every round trip were verified.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_corpus(mb: int, seed: int = 0) -> bytes:
    """``mb`` MiB of a deterministic mix from a numpy seed, in 256 KiB
    blocks: word text, little-endian records, byte runs and noise in the
    proportions 4 : 2 : 1 : 1."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 10),
                                dtype=np.uint8)) for _ in range(2000)]
    zipf = np.minimum(rng.zipf(1.3, 1 << 20), len(vocab)) - 1
    block = 1 << 18
    kinds = ("text", "text", "records", "text", "runs", "text", "records",
             "noise")
    out = []
    for i in range(mb * (1 << 20) // block):
        kind = kinds[i % len(kinds)]
        if kind == "text":
            start = int(rng.integers(0, len(zipf) - block // 3))
            out.append(b" ".join(vocab[w] for w in
                                 zipf[start:start + block // 3])[:block])
        elif kind == "records":
            rec = np.zeros((block // 16, 4), np.uint32)
            rec[:, 0] = np.arange(block // 16) + i * block
            rec[:, 1] = rng.integers(0, 64, block // 16)
            rec[:, 2] = rng.integers(0, 1 << 20, block // 16) & ~0xFF
            rec[:, 3] = 0x51A7
            out.append(rec.tobytes())
        elif kind == "runs":
            lens = rng.integers(1, 400, block // 100)
            vals = rng.integers(0, 256, len(lens), dtype=np.uint8)
            out.append(np.repeat(vals, lens).tobytes()[:block].ljust(block,
                                                                     b"\0"))
        else:
            out.append(rng.integers(0, 256, block, dtype=np.uint8).tobytes())
    return b"".join(out)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def worker(args) -> None:
    """One process of the group: join it, all_gather the stripes' byte
    counts, compress this rank's stripe, write it to ``args.out``."""
    import torch
    import torch.distributed as dist

    from ..parallel.multihost import compress_striped, init_distributed

    got = init_distributed(coordinator_address=f"127.0.0.1:{args.port}",
                           num_processes=args.procs, process_id=args.rank)
    assert got == (args.rank, args.procs), got
    assert dist.get_world_size() == args.procs
    with open(args.chunks, "rb") as f:
        chunks = pickle.load(f)
    # the collective: every rank receives every stripe's byte count and
    # must agree on the corpus's size
    mine = chunks[args.rank::args.procs]
    local = torch.tensor([sum(len(c) for c in mine)], dtype=torch.int64)
    gathered = [torch.zeros_like(local) for _ in range(args.procs)]
    dist.all_gather(gathered, local)
    total = int(torch.cat(gathered).sum())
    assert total == sum(len(c) for c in chunks), total

    device = None if args.engine == "sw" else args.device
    if device == "cpu":
        # the processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.procs))
    t0 = time.perf_counter()
    idx, results = compress_striped(chunks, algorithm="deflate", level=1,
                                    device=device)
    dt = time.perf_counter() - t0
    nbytes = sum(len(chunks[i]) for i in idx)
    dist.barrier()
    dist.destroy_process_group()
    with open(args.out, "wb") as f:
        pickle.dump({"rank": args.rank, "idx": idx, "results": results,
                     "sec": dt, "bytes": nbytes, "gathered": total}, f)
    print(f"worker {args.rank}: {nbytes} bytes in {dt * 1000:.0f} ms = "
          f"{nbytes * 8 / dt / 1e9:.2f} Gbps", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--engine", choices=["device", "sw"], default="device")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device engine's device (--engine device)")
    ap.add_argument("--chunk-kb", type=int, default=64)
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds the parent waits for each worker")
    # a worker's own arguments (the parent passes them)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--chunks", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return {}

    blob = make_corpus(args.mb)
    ck = args.chunk_kb * 1024
    chunks = [blob[o:o + ck] for o in range(0, len(blob), ck)]
    with tempfile.TemporaryDirectory(prefix="qztorch_dist_") as tmp:
        chunks_path = os.path.join(tmp, "chunks.pkl")
        with open(chunks_path, "wb") as f:
            pickle.dump(chunks, f)
        port = free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        outs = [os.path.join(tmp, f"out{r}.pkl") for r in range(args.procs)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "qatzip_tpu_torch.tools.distrun",
             "--worker", "--rank", str(r), "--port", str(port),
             "--procs", str(args.procs), "--chunks", chunks_path,
             "--out", outs[r], "--engine", args.engine,
             "--device", args.device], env=env, cwd=REPO)
            for r in range(args.procs)]
        try:
            rc = [p.wait(timeout=args.timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rc):
            print(json.dumps({"ok": False, "rc": rc}))
            sys.exit(1)
        stripes, total_gbps = [], 0.0
        for out in outs:
            with open(out, "rb") as f:
                d = pickle.load(f)
            assert d["gathered"] == len(blob)
            stripes.append(d["results"])
            total_gbps += d["bytes"] * 8 / d["sec"] / 1e9

    # interleave the stripes back into submission order and verify
    from ..parallel.multihost import interleave_stripes
    merged = interleave_stripes(stripes, len(chunks))
    for (payload, crc), src in zip(merged, chunks):
        assert zlib.decompressobj(-15).decompress(payload) == src
        assert crc == zlib.crc32(src)
    line = {"ok": True, "procs": args.procs, "chunks": len(chunks),
            "mb": args.mb, "engine": args.engine,
            "sum_gbps": round(total_gbps, 4),
            "verified": "stock zlib round-trip, zlib crc32, submission order"}
    if args.engine == "device":
        line["device"] = args.device
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
