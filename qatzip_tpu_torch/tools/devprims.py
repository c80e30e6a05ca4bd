"""devprims: time the card's primitives that the kernels' designs choose
between.

Counterpart of ``tools/devprims.py``, which timed the TPU primitives
behind the sort-based Pallas design. The same cases, on the same inputs
(numpy, seed 7, drawn in the same order), one JSON line each:

  sort1/sort2/sort5      torch.sort of (B, 65536) u32 rows, 0, 1 or 4
                         payloads gathered by the sort's indices
  sortseg2-<s>           the same with one payload on (B * 65536 / s, s)
  xla_gather             torch.gather along the rows of (B, 65536)
  pl_gather_lane         lane_gather on (512 B, 128), idx < 128
  pl_gather_lane_wide    lane_gather on (8192, 1024), idx < 1024
  pl_gather_sublane      sublane_gather on (512, 128), idx < 512
  pl_roll_static7        roll_sum, shifts 1, 2, 4, ..., 64 compiled in
  pl_roll_dyn7           roll_sum, shifts (1, 3, 9, 27, 31, 77, 111) read
                         from a device tensor at run time
  pl_bitonic128          bitonic128 on the (B, 65536) keys as 128-lane
                         rows, the first payload carried
  lax_sort128            torch.sort of the same rows, the payload gathered
  bitonic128_correct     bitonic128's first 4 rows against np.sort

The pl_* cases run the hand kernels of ``ops/devprims.py`` (their plain
versions with ``--device cpu``); the others are the PyTorch library calls
set beside them. Each line has ``best_ms``, the best of ``--iters`` runs
of the operation alone after one warm-up (CUDA events on the card, the
host clock on the CPU); ``gbps`` over the byte count of the JAX tool's
line; ``bound_ms``, the least time an H100 could take: the bytes the
operation reads and writes once each over 3.35 TB/s; and ``sum``, the
u32 sum of the outputs, which is what the JAX probe returns. Keys are
below 2**31, as the JAX tool draws them, so torch.sort on int32 orders
them as u32.

Run:  python -m qatzip_tpu_torch.tools.devprims [--device cuda|cpu]
      [--b 128] [--iters 3]

Nothing is caught: a case that fails raises and the tool exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..ops import devprims as dv

N = 65536
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
DYN_SHIFTS = (1, 3, 9, 27, 31, 77, 111)
GATHERS = (("pl_gather_lane", 1, None, 128), ("pl_gather_lane_wide", 1, 8192,
                                              1024),
           ("pl_gather_sublane", 0, 512, 128))


def inputs(b: int, seed: int = 7) -> Dict[str, np.ndarray]:
    """The JAX tool's inputs at batch ``b``, drawn in its order: keys,
    four context planes, the gather's indices, each Pallas gather's
    plane and indices, the roll plane."""
    rng = np.random.default_rng(seed)
    out = {"keys": rng.integers(0, 1 << 31, (b, N), dtype=np.uint32)}
    for i in range(4):
        out[f"ctx{i}"] = rng.integers(0, 1 << 32, (b, N), dtype=np.uint32)
    out["idx_w"] = rng.integers(0, N, (b, N)).astype(np.int32)
    for name, axis, r, c in GATHERS:
        r = r or N // 128 * b
        out[f"{name}_x"] = rng.integers(0, 1 << 31, (r, c), dtype=np.uint32)
        out[f"{name}_idx"] = rng.integers(0, c if axis == 1 else r,
                                          (r, c)).astype(np.int32)
    out["x512"] = rng.integers(0, 1 << 31, (4096, 128), dtype=np.uint32)
    return out


def u32_sum(outs: Sequence[torch.Tensor]) -> int:
    """The sum of every word of ``outs`` mod 2**32 (int32 bit patterns)."""
    return sum(int(o.to(torch.int64).sum()) for o in outs) & 0xFFFFFFFF


def _timed(fn: Callable, iters: int, cuda: bool):
    """(first output, best ms of ``iters`` runs after the first)."""
    out = fn()
    best = float("inf")
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return out, best


def _sorted_with(keys: torch.Tensor, payloads: Sequence[torch.Tensor]):
    ks, order = torch.sort(keys, dim=1)
    return [ks] + [torch.gather(p, 1, order) for p in payloads]


def main(argv=None) -> List[dict]:
    """Run every case and print its line; returns the lines as dicts."""
    ap = argparse.ArgumentParser(
        prog="python -m qatzip_tpu_torch.tools.devprims",
        description="Time the card's gathers, lane rolls and 128-lane "
                    "bitonic sort beside PyTorch's library calls.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--b", type=int, default=128,
                    help="rows of 65536 words (default 128)")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions")
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    b = args.b
    host = inputs(b)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.view(np.int32)).to(dev)

    keys = put(host["keys"])
    ctx = [put(host[f"ctx{i}"]) for i in range(4)]
    lines = []

    def case(name: str, fn: Callable, nbytes: int, moved: int) -> None:
        """Time ``fn`` (returning its output tensors) and print its line;
        ``nbytes`` is the JAX tool's byte count, ``moved`` the bytes the
        operation reads and writes."""
        outs, best = _timed(fn, args.iters, cuda)
        line = {"case": name, "best_ms": best,
                "gbps": nbytes / best / 1e6,
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "sum": u32_sum(outs)}
        print(json.dumps(line), flush=True)
        lines.append(line)

    # the library sorts and gather
    for nops in (1, 2, 5):
        case(f"sort{nops}", lambda nops=nops: _sorted_with(
            keys, ctx[:nops - 1]), b * N * 4 * nops, 2 * b * N * 4 * nops)
    for s in (8192, 2048):
        case(f"sortseg2-{s}", lambda s=s: _sorted_with(
            keys.reshape(-1, s), [ctx[0].reshape(-1, s)]), b * N * 8,
            b * N * 16)
    idx_w = torch.from_numpy(host["idx_w"]).to(dev, torch.int64)
    # bound: int32 indices, as the kernels take them
    case("xla_gather", lambda: [torch.gather(keys, 1, idx_w)], b * N * 4,
         b * N * 12)

    # the hand kernels
    for name, axis, _r, _c in GATHERS:
        x = put(host[f"{name}_x"])
        idx = put(host[f"{name}_idx"])
        gather = dv.lane_gather if axis == 1 else dv.sublane_gather
        case(name, lambda x=x, idx=idx, gather=gather: [gather(x, idx)],
             x.numel() * 4, x.numel() * 12)
    x512 = put(host["x512"])
    shifts = torch.tensor(DYN_SHIFTS, dtype=torch.int32, device=dev)
    case("pl_roll_static7", lambda: [dv.roll_sum(x512)], x512.numel() * 28,
         x512.numel() * 8)
    case("pl_roll_dyn7", lambda: [dv.roll_sum(x512, shifts)],
         x512.numel() * 28, x512.numel() * 8)
    rows = N // 128 * b
    k128 = keys.reshape(rows, 128)
    v128 = ctx[0].reshape(rows, 128)
    case("pl_bitonic128", lambda: list(dv.bitonic128(k128, v128)),
         rows * 128 * 8, rows * 128 * 16)
    case("lax_sort128", lambda: _sorted_with(k128, [v128]), rows * 128 * 8,
         rows * 128 * 16)

    ks, _vs = dv.bitonic128(k128, v128)
    want = np.sort(host["keys"].reshape(rows, 128)[:4], axis=1)
    ok = bool((ks[:4].cpu().numpy().view(np.uint32) == want).all())
    line = {"case": "bitonic128_correct", "ok": ok}
    print(json.dumps(line), flush=True)
    lines.append(line)
    if not ok:
        raise RuntimeError("bitonic128 does not sort the first 4 rows as "
                           "np.sort does")
    return lines


if __name__ == "__main__":
    main()
