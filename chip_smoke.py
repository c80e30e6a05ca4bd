"""End-to-end check of qatzip_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(``python3 chip_smoke.py --host-cost`` runs only the host cost of one call
of every kernel wrapper, ``host_cost_table``.)

Phases, each printing its own lines; any failure raises and the script
exits non-zero without the final line:

  1. environment: torch / CUDA versions, the card, its power limit;
  2. build: the CUDA kernels and their Python binding (one nvcc per
     kernel source and one cc over csrc/binding.c, all at once, sm_90a,
     then a link into the extension module) and the host C++ library;
     beside it, the time of one nvcc command over all the kernel sources,
     which the build does not use; and the script's own measurement
     extension (MEASURE_SRC: the binding's argument path with no launch,
     and a C loop of launches) and a copy of the probe kernels linked
     with the shared CUDA runtime (LOOP_CU), neither part of the library;
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and on their own inputs (the first 16 MB tile of
     the corpus): bit-identical, with CUDA-event times beside the plain
     version's, one PyTorch library call's where there is one, and the
     least time the card could take (bytes or operations over its peak);
     the candidate search, the parse scan and the row bit-packer also on
     one adversarial plane each at that shape (one hash bucket per window;
     parse chains that never meet; back-to-back 4-byte matches at distance
     32768), bit-identical and timed; the row bit-packer also against the
     route it replaced (emission planes, offsets, the 256-position group
     pack and the window assembly, in plain torch), bit-identical, with
     that route's time;
     the LZ4 byte packer on the LZ4 device pack's own planes of that tile
     (the full-row search's parse, timed apart) against its plain version
     and against the torch route it stands for (the JAX package's run
     planes, emission planes, cumsum and 256-position group pack), and on
     adversarial planes (b"A" * n: back-to-back 273-matches with their
     own tokens; literal runs of exactly 269, 270 and 271, a length that
     is not a multiple of 4, an empty row; the hand-made planes of
     lz4_plane_rows, all 256 rows, B = 1 and 3, max_words 1000, and off
     their alignment); the four kernels of the probe
     tool (lane and sublane gathers, the lane-roll sum, the 128-lane
     bitonic sort) on the tool's own inputs at its default shapes (B =
     128) and on adversarial ones (gather indices all 0 or all C - 1, roll
     shifts 0 and 127, sort keys from 8 values with bit 31 set, all-equal,
     sorted and reverse-sorted rows, 1, 3, 5 and 4097 rows of tied keys),
     each also against one PyTorch call (torch.gather, seven torch.roll
     summed, torch.sort with its payload gathered); then the host cost of
     one call of every wrapper at its path's shape beside its library
     call (``host_cost_table``: a host clock over 1,000 calls, no sync
     within a batch of 100), and one sublane gather call at (512, 128)
     part by part beside the ctypes route the kernels took before,
     torch.gather and torch.cuda._sleep(0) (``sublane_breakdown``);
  4. the device time of the tokenizer layer on the full tiles, then the
     paths, each a 64 MiB request through QzSession(device="cuda") with
     the launch counts set to 0 just before and read just after: the
     dynamic and the static full-device pack (the engine's own choice for
     dynamic and static sessions on the card), the token path (the engine
     held on it: the route a dynamic session takes on the CPU), LZ4 on the
     token path and on the LZ4 device pack (each held there; the line
     names the engine's own pick), LZ4s through the lz4s -> zstd callback,
     and level 6 on the dynamic device pack (the full-row search). Every
     deflate member decodes with stock zlib, every LZ4 frame with the
     session and the blocks of its first 1 MiB with the pure-Python LZ4
     decoder, the zstd frames with libzstd; the session decodes the whole,
     a second compress gives the same bytes, and every kernel of the path
     was launched; the path line gives the peak device memory of the two
     compresses. Then each path's breakdown and a profile of one compress.
     Then three more paths, launch counts again zeroed before and read
     after each: devprims (the probe tool's main at its defaults, which
     launches the four probe kernels; it prints its own lines), the row
     split (the 64 MiB request in 256 KiB chunks, four 64 KiB rows each,
     on a dynamic session: stock zlib decodes every member and the first
     1 MiB equals the CPU session's) and one QZ_AUTO_SELECT_BEST request
     (its pick and size);
  5. the first 1 MiB through device="cpu" and device="cuda" on each
     path, both engines held on it: same bytes;
  6. the kernel summary line (ten kernels), the card line, and
     {"ok": true, ...}.

It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import subprocess
import sys
import time
import zlib

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
OPS_PER_S = 67e12             # H100 SXM 32-bit rate outside the tensor cores

# (path, session kind, level, route on the card: None = the engine's own
#  choice, False / True = the engine held on the token path / the device
#  pack; the kernels it runs). Kinds: "dynamic" and "static" deflate,
#  "lz4", and "lz4s-zstd" (an LZ4s session with the zstd callback).
PATHS = [
    ("token", "dynamic", 1, False, ("candidate_search", "parse_scan")),
    ("static-device-pack", "static", 1, None,
     ("candidate_search", "parse_scan", "pack_rows")),
    ("dynamic-device-pack", "dynamic", 1, None,
     ("candidate_search", "parse_scan", "symbol_histogram",
      "huffman_lookup", "pack_rows")),
    ("lz4-token", "lz4", 1, False, ("candidate_search", "parse_scan")),
    ("lz4-device-pack", "lz4", 1, True, ("parse_scan", "lz4_pack_rows")),
    ("lz4s-zstd", "lz4s-zstd", 1, None, ("candidate_search", "parse_scan")),
    ("level6-dynamic-device-pack", "dynamic", 6, None,
     ("parse_scan", "symbol_histogram", "huffman_lookup", "pack_rows")),
]
# the path whose launches the kernel summary reports: the default
# (dynamic) session on the card, which runs five kernels; the LZ4 byte
# packer's launches come from the LZ4 device pack's path
MAIN_PATH = "dynamic-device-pack"
# the probe kernels run on no codec path: their home is the devprims path,
# the probe tool's run
DEVPRIMS_KERNELS = ("lane_gather", "sublane_gather", "roll_sum", "bitonic128")
HOME_PATH = {"lz4_pack_rows": "lz4-device-pack",
             **{k: "devprims" for k in DEVPRIMS_KERNELS}}
# the row split's chunk size (four 64 KiB rows a chunk)
SPLIT_HW = 262144
# the paths that search whole 64 KiB rows (the full-row search)
FULL_ROW_PATHS = ("lz4-device-pack", "level6-dynamic-device-pack")


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_cost(fn):
    """(device operations launched, peak device bytes allocated above what
    was allocated before) of one run of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return ops, peak


def device_ms(fn, reps: int) -> float:
    """Mean device time of one run of ``fn`` over ``reps`` runs: the CUDA
    activity the profiler records, without the gaps between launches
    (which ``event_ms`` counts, and which set the time of a kernel whose
    work is shorter than its launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / reps / 1e3


def bound_ms(nbytes: float, ops: float):
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(got, want) -> int:
    import torch
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    torch.cuda.synchronize()
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def k2_probe_ops(key, ctx, probes: int, pbits: int):
    """The operations the candidate search needs on these inputs,
    whatever sorts them: one hash compare per probe, and an XOR and a
    zero test per context word each probe compares (a probe stops at the
    first word that differs), as the plain version counts them. Also
    returns counts of the work: same-hash predecessors probed per
    position, the share of positions that reach the probe cap, the
    distinct buckets per window (min, mean, max) and the share of keys
    in the overflow bucket (bit 31)."""
    import torch
    k64, _ = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    h = k64 >> pbits
    pos = k64 & ((1 << pbits) - 1)
    words = [torch.gather(c.to(torch.int64), 1, pos) for c in ctx]
    ops, prev, hits = 0, None, 0
    for d in range(1, min(probes, key.shape[1] - 1) + 1):
        same = h[:, d:] == h[:, :-d]              # sorted index i = d..w-1
        # probe d runs where probe d - 1 stayed in the bucket
        ops += same.numel() if prev is None else int(prev[:, 1:].sum())
        hits += int(same.sum())
        alive = same
        for c in words:
            ops += 2 * int(alive.sum())
            alive = alive & (c[:, d:] == c[:, :-d])
        prev = same
    buckets = (h[:, 1:] != h[:, :-1]).sum(1) + 1
    counts = {"probed_per_pos": hits / key.numel(),
              "cap_share": float(prev.sum()) / key.numel(),
              "buckets": (int(buckets.min()), float(buckets.float().mean()),
                          int(buckets.max())),
              "overflow_share": float((k64 >> 31).float().mean())}
    return ops, counts


def pr3_route(emit, base, max_words: int, group_w: int):
    """The route the row bit-packer replaced, as the port ran it before:
    the emission planes and their offsets (``emit()`` and ``base``), the
    group pack (each 256-position group's emissions scatter-added into a
    window of ``group_w`` words) and the window assembly (the windows
    scatter-added at their word offsets), in plain torch. A yardstick for
    ``pack_rows``; the port does not use it."""
    import torch
    from qatzip_tpu_torch.ops import deflate_pack as dp
    from qatzip_tpu_torch.ops.cuda_pack import _as_i32
    bits, nbits = emit()
    off, end = dp._offsets(nbits, base)
    b, n = bits.shape
    rows = b * (n // 256)
    s = off & 31
    lo = ((bits << s) & 0xFFFFFFFF).reshape(rows, 256)
    hi = ((bits >> 1) >> (31 - s)).reshape(rows, 256)
    word = (off >> 5).reshape(rows, 256)
    gbase = word[:, :1]
    widx = word - gbase
    nz = (nbits > 0).reshape(rows, 256)
    grp = torch.zeros((rows, group_w), dtype=torch.int64, device=bits.device)
    for part, at in ((lo, widx), (hi, widx + 1)):
        ok = nz & (at < group_w)
        grp.scatter_add_(1, torch.where(ok, at, 0), torch.where(ok, part, 0))
    idx = (gbase + torch.arange(group_w, device=bits.device)).reshape(b, -1)
    out = torch.zeros((b, max_words + 1), dtype=torch.int64,
                      device=bits.device)
    out.scatter_add_(1, idx.clamp(max=max_words), grp.reshape(b, -1))
    return _as_i32(out[:, :max_words]), end.to(torch.int32)


def lz4_route(data, ml, dist, taken, lit, max_words: int):
    """The torch route the LZ4 byte packer stands for, as the JAX package
    ran it: the run planes, the emission planes, their offsets, the
    256-position group pack into LZ4_GROUP_W words and the assembly, in
    plain torch. Returns (words, nbytes, ok); words of rows that are not
    ok are not comparable (the port zeroes them). A yardstick for
    ``lz4_pack_rows``; the port does not use it."""
    import torch
    from qatzip_tpu_torch.ops import lz4_pack as lp
    lr, nm = lp.run_planes(ml, taken, lit)

    def emit():
        vals, nbs = lp.lz4_emissions(data, ml, dist, taken, lit, lr, nm)
        return vals, nbs * 8
    zero = torch.zeros((ml.shape[0], 1), dtype=torch.int64, device=ml.device)
    words, end = pr3_route(emit, zero, max_words, lp.LZ4_GROUP_W)
    return words, end // 8, lr.max(dim=1).values <= lp.LZ4_MAX_RUN


def lz4_adversarial(n: int, kind: str, rows: int):
    """(data (rows, n) uint8, lengths) of planes hard for the LZ4 byte
    packer: "A" = b"A" * n in every row; "runs" = rows cycling through a
    literal run of exactly 269, 270 and 271 literals (random bytes from a
    seed, then one byte repeated), text whose length is not a multiple of
    4 (n - 3), and an empty row."""
    import numpy as np
    rng = np.random.default_rng(5)
    if kind == "A":
        kinds = [b"A" * n]
    else:
        kinds = [bytes(rng.integers(0, 256, run - 1, dtype=np.uint8))
                 + b"x" * (n - run + 1) for run in (269, 270, 271)]
        text = (b"the port packs each run start with its length bytes; "
                * (n // 50 + 1))
        kinds += [text[:n - 3], b""]
    data = np.zeros((rows, n), np.uint8)
    lengths = np.zeros(rows, np.int32)
    for i in range(rows):
        r = kinds[i % len(kinds)]
        data[i, :len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    return data, lengths


LZ4_STEP = 2048       # positions the LZ4 byte packer walks a step
LZ4_PLANE_KINDS = ("run 270 across a step", "run 271 across a step",
                   "runs of 270", "long run at the end",
                   "split emission at a step end", "all literals", "empty")


def lz4_plane_rows(n: int, rows: int, seed: int = 7):
    """(data, ml, dist, taken, lit) numpy planes (rows, n), LZ4 parse
    planes made by hand so that each row puts one case where the LZ4 byte
    packer's design is tight, row i of kind LZ4_PLANE_KINDS[i % 7]: a run
    of 270 literals and one of 271 across a step boundary; runs of 270
    literals between random matches all along the row (their tokens and
    the matches that end them straddle steps and the staging ring); a
    271-literal run that ends the row and is its only long run; a 4-byte
    match emission at a step's last position, at byte offsets that move
    with the row (every offset mod 4 over 49 rows); a row of literals
    only; an empty row. Between the cases, back-to-back matches of 4-273
    at distances 1-32768; ml and dist hold garbage where no match is
    taken, which no packer may read."""
    import numpy as np
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (rows, n), dtype=np.uint8)
    ml = rng.integers(-5, 1 << 20, (rows, n), dtype=np.int32)
    dist = rng.integers(-5, 1 << 20, (rows, n), dtype=np.int32)
    taken = np.zeros((rows, n), bool)
    lit = np.zeros((rows, n), bool)

    for i in range(rows):
        kind = LZ4_PLANE_KINDS[i % len(LZ4_PLANE_KINDS)]
        p = 0

        def lits(count):
            nonlocal p
            lit[i, p:p + count] = True
            p += count

        def match(m):
            nonlocal p
            taken[i, p] = True
            ml[i, p] = m
            dist[i, p] = int(rng.integers(1, 32769))
            p += m

        def matches_to(end):
            """Back-to-back matches from p to exactly ``end`` (end - p is
            0 or at least 4)."""
            while end - p >= 4:
                r = end - p
                match(r if r < 8 or (r <= 273 and rng.random() < 0.1)
                      else int(rng.integers(4, min(273, r - 4) + 1)))

        if kind == "empty":
            continue
        if kind == "all literals":
            lits(n)
            continue
        if kind.startswith("run 27"):
            run = int(kind[4:7])
            step = LZ4_STEP * (1 + (i // 7) % max(n // LZ4_STEP - 1, 1))
            matches_to(max(step - run // 2 - int(rng.integers(0, 9)), 0))
            lits(run)
        elif kind == "runs of 270":
            while n - p > 560:
                lits(270 if rng.random() < 0.8 else int(rng.integers(1, 271)))
                match(int(rng.integers(4, 274)))
        elif kind == "long run at the end":
            matches_to(n - 271)
            lits(271)
            continue
        else:                             # split emission
            lits(3 + 4 * ((i // 7) % 8))  # 3, 7, ..., 31 literals, then
            while p + 4 < LZ4_STEP:       # 4-byte matches (3 bytes each)
                match(4)
            match(20 + (i // 7) % 200)    # an own token and an ext byte
        matches_to(n - 5)
        lits(n - p)
    return data, ml, dist, taken, lit


def probe_kernels(dev, b: int, record, adversarial, res) -> None:
    """The probe kernels of the devprims tool at its shapes for batch
    ``b`` (its default is 128), on the tool's own inputs, then on
    adversarial ones, each against its plain version (``record`` keeps
    the kernel's main entry in ``res``, ``adversarial`` the others) and
    against one PyTorch library call: its full output where ties cannot
    occur, the bitonic sort's keys, and its payload on rows without
    ties."""
    import numpy as np
    import torch
    from qatzip_tpu_torch.ops import devprims as dv
    from qatzip_tpu_torch.tools import devprims as dvtool
    host = dvtool.inputs(b)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    def probe(name, label, kern, ref, lib, exact, nbytes, ops, shape,
              replaces=None):
        """One probe kernel on one input against its plain version and
        the library call; ``replaces`` records it as the kernel's main
        entry, otherwise it is kept beside it under ``label``."""
        got = kern()
        err = max_err(got, ref())
        check(exact(got, lib()), f"{name} ({label}) and its library call "
              "disagree")
        ms, plain_ms = event_ms(kern, 20), event_ms(ref, 3)
        lib_ms = event_ms(lib, 20)
        dev_ms, lib_dev_ms = device_ms(kern, 20), device_ms(lib, 20)
        if replaces is not None:
            record(name, "devprims.cu", replaces, err, ms, plain_ms, lib_ms,
                   nbytes, ops, shape)
            entry = res[name]
        else:
            adversarial(name, label, shape, err, ms, plain_ms)
            entry = res[name]["adversarial"][-1]
            entry["library_ms"] = lib_ms
        entry.update(device_ms=dev_ms, library_device_ms=lib_dev_ms)
        print(f"kernel {name} {shape} {label or ''}: device time a launch "
              f"(profiler) {dev_ms:.4f} ms, the library call's "
              f"{lib_dev_ms:.4f} ms")

    for case, axis, label in (("pl_gather_lane_wide", 1, "wide"),
                              ("pl_gather_lane", 1, None),
                              ("pl_gather_sublane", 0, None)):
        x, idx = put(host[f"{case}_x"]), put(host[f"{case}_idx"])
        name = "lane_gather" if axis == 1 else "sublane_gather"
        kern_f = dv.lane_gather if axis == 1 else dv.sublane_gather
        ref_f = dv.lane_gather_ref if axis == 1 else dv.sublane_gather_ref
        cases = [(label, idx)]
        if case == "pl_gather_lane":
            cases += [("idx 0", torch.zeros_like(idx)),
                      ("idx C - 1", torch.full_like(idx, x.shape[1] - 1))]
        for lab, ix in cases:
            ix64 = ix.to(torch.int64)
            if lab == "wide":           # kept until the main entry exists
                wide = (x, ix, ix64)
                continue
            probe(name, lab, lambda x=x, ix=ix: kern_f(x, ix),
                  lambda x=x, ix=ix: ref_f(x, ix),
                  lambda x=x, ix64=ix64, a=axis: torch.gather(x, a, ix64),
                  torch.equal, x.numel() * 12, x.numel(), tuple(x.shape),
                  None if lab else "tools/devprims.py:124")
        if case == "pl_gather_lane":
            x, ix, ix64 = wide
            probe(name, "wide (8192, 1024)", lambda: kern_f(x, ix),
                  lambda: ref_f(x, ix), lambda: torch.gather(x, 1, ix64),
                  torch.equal, x.numel() * 12, x.numel(), tuple(x.shape))
    del x, idx, ix, ix64, wide

    x512 = put(host["x512"])

    def roll_lib(ks):
        def run():
            acc = x512.clone()
            for k in ks:
                acc += torch.roll(x512, k, 1)
            return acc
        return run
    probe("roll_sum", None, lambda: dv.roll_sum(x512),
          lambda: dv.roll_sum_ref(x512), roll_lib(dv.STATIC_SHIFTS),
          torch.equal, x512.numel() * 8, x512.numel() * 7,
          tuple(x512.shape), "tools/devprims.py:158")
    for label, ks in (("dynamic shifts (1, 3, 9, 27, 31, 77, 111)",
                       dvtool.DYN_SHIFTS), ("dynamic shifts 0 and 127",
                                            (0, 127))):
        sh = torch.tensor(ks, dtype=torch.int32, device=dev)
        probe("roll_sum", label, lambda sh=sh: dv.roll_sum(x512, sh),
              lambda sh=sh: dv.roll_sum_ref(x512, sh), roll_lib(ks),
              torch.equal, x512.numel() * 8, x512.numel() * len(ks),
              tuple(x512.shape))

    rows = dvtool.N // 128 * b
    k_main = put(host["keys"].reshape(rows, 128))
    v_main = put(host["ctx0"].reshape(rows, 128))
    rng = np.random.default_rng(31)
    ties = np.array([0, 7, 1 << 20, 0x7FFFFFFF, 1 << 31, (1 << 31) + 7,
                     0xFFFFFFF0, 0xFFFFFFFF], np.uint32)
    rand = rng.integers(0, 1 << 32, (rows, 128), dtype=np.uint32)
    cases = [(None, k_main, v_main),
             ("keys from 8 values, bit 31 set in half",
              put(ties[rng.integers(0, 8, (rows, 128))]), v_main),
             ("all-equal rows", put(np.repeat(rand[:, :1], 128, axis=1)),
              v_main),
             ("sorted rows", put(np.sort(rand, axis=1)), v_main),
             ("reverse-sorted rows", put(np.sort(rand, axis=1)[:, ::-1]),
              v_main)]
    # row counts that leave a CTA's last threads (32 rows a CTA) idle
    for r in (1, 3, 5, 4097):
        cases.append((f"{r} rows, keys from 8 values",
                      put(ties[rng.integers(0, 8, (r, 128))]),
                      put(rng.integers(0, 1 << 32, (r, 128),
                                       dtype=np.uint32))))
    for label, keys, vals in cases:
        k64 = keys.to(torch.int64) & 0xFFFFFFFF
        r = keys.shape[0]

        def sort_lib(k64=k64, vals=vals):
            ks, order = torch.sort(k64, dim=1)
            return ks, torch.gather(vals, 1, order)

        def same_keys(got, lib):
            """Keys as torch.sort's; payloads on the rows without ties."""
            ks, vs = lib
            free = ~(ks[:, 1:] == ks[:, :-1]).any(1)
            return (torch.equal(got[0].to(torch.int64) & 0xFFFFFFFF, ks)
                    and torch.equal(got[1][free], vs[free]))
        probe("bitonic128", label,
              lambda keys=keys, vals=vals: dv.bitonic128(keys, vals),
              lambda keys=keys, vals=vals: dv.bitonic128_ref(keys, vals),
              sort_lib, same_keys, r * 128 * 16,
              # 28 stages of a compare and two selects a position
              r * 128 * 28 * 3, (r, 128),
              None if label else "tools/devprims.py:222")


# chip_smoke's own measurement extension, never part of the library: the
# binding's argument path (binding.c, included) with no launch behind it,
# the same as a bare C function for ctypes, and N sublane-gather launches
# (each with its cudaGetLastError) in one call. Linked against the kernel
# library, so the launches are the library's own.
MEASURE_SRC = r"""
#include "binding.c"

int qz_noop(const void* x, const void* idx, void* out, int log_r, int log_c,
            void* stream) {
  (void)x; (void)idx; (void)out; (void)log_r; (void)log_c; (void)stream;
  return 0;
}

static PyObject* py_noop(PyObject* self, PyObject* const* args,
                         Py_ssize_t nargs) {
  Py_ssize_t v[6];
  (void)self;
  if (!take("noop", "pppiip", 6, args, nargs, v)) return NULL;
  return done("noop", qz_noop(P(0), P(1), P(2), I(3), I(4), P(5)));
}

static PyObject* py_launch_loop(PyObject* self, PyObject* const* args,
                                Py_ssize_t nargs) {
  Py_ssize_t v[7];
  int rc = 0;
  (void)self;
  if (!take("launch_loop", "pppiipi", 7, args, nargs, v)) return NULL;
  for (int i = 0; i < I(6) && rc == 0; ++i)
    rc = qz_sublane_gather(P(0), P(1), P(2), I(3), I(4), P(5));
  return done("launch_loop", rc);
}

static PyMethodDef measure_methods[] = {
    {"noop", (PyCFunction)(void (*)(void))py_noop, METH_FASTCALL, NULL},
    {"launch_loop", (PyCFunction)(void (*)(void))py_launch_loop,
     METH_FASTCALL, NULL},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef measure_module = {
    PyModuleDef_HEAD_INIT, "_qz_measure", NULL, -1, measure_methods, NULL,
    NULL, NULL, NULL};

PyMODINIT_FUNC PyInit__qz_measure(void) {
  return PyModule_Create(&measure_module);
}
"""
# the probe kernels again, built by nvcc with the CUDA runtime linked as a
# shared library (at run time the libcudart.so.12 PyTorch loaded), where
# the kernel library links it statically, with two loops of sublane-gather
# launches: through the library's entry (qz::launch, one cudaLaunchKernel)
# and as kernel<<<>>> followed by cudaGetLastError
LOOP_CU = r"""
#include "devprims.cu"

extern "C" int qz_launch_loop(const void* x, const void* idx, void* out,
                              int log_r, int log_c, void* stream, int n) {
  int rc = 0;
  for (int i = 0; i < n && rc == 0; ++i)
    rc = qz_sublane_gather(x, idx, out, log_r, log_c, stream);
  return rc;
}

extern "C" int qz_chevron_loop(const void* x, const void* idx, void* out,
                               int log_r, int log_c, void* stream, int n) {
  const size_t want = (((size_t)1 << (log_r + log_c)) + kThreads - 1) /
                      kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  int rc = 0;
  for (int i = 0; i < n && rc == 0; ++i) {
    sublane_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const int32_t*)idx, (uint32_t*)out, log_r,
        log_c);
    rc = (int)cudaGetLastError();
  }
  return rc;
}
"""


def build_measure(kernels_so: str):
    """(the measurement extension, LOOP_CU's two launch loops, seconds the
    extension's compile took): MEASURE_SRC compiled by the binding's own
    host compiler command and linked against ``kernels_so``; LOOP_CU
    built by nvcc with ``-cudart shared`` beside the link."""
    import ctypes
    import importlib.machinery
    from qatzip_tpu_torch.ops import _build
    src = os.path.join(_build.BUILD_DIR, "qz_measure.c")
    cu = os.path.join(_build.BUILD_DIR, "qz_loop_shared.cu")
    for path, text in ((src, MEASURE_SRC), (cu, LOOP_CU)):
        with open(path, "w") as f:
            f.write(text)
    obj, so, loop_so = src[:-2] + ".o", src[:-2] + ".so", cu[:-3] + ".so"
    t0 = time.perf_counter()
    _build._run_all([_build.binding_command(src, obj)])
    secs = time.perf_counter() - t0
    _build._run_all([
        ["cc", "-shared", "-o", so, obj, kernels_so],
        [_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-cudart",
         "shared", "-I", _build.CSRC_DIR, "-o", loop_so, cu]])
    loader = importlib.machinery.ExtensionFileLoader("_qz_measure", so)
    spec = importlib.util.spec_from_file_location("_qz_measure", so,
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    lib = ctypes.CDLL(loop_so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    loops = (lib.qz_launch_loop, lib.qz_chevron_loop)
    for loop in loops:
        loop.restype, loop.argtypes = ci, [vp, vp, vp, ci, ci, vp, ci]
    return mod, loops, secs


def host_us(fns: dict, calls: int = 1000, batch: int = 100) -> dict:
    """Host microseconds a call of each function in ``fns``: a host clock
    over ``batch`` calls with no synchronisation, the card drained
    (untimed) between batches, ``calls`` calls in all. The functions take
    turns batch by batch, so each sees the same host."""
    import torch
    for fn in fns.values():
        fn()
    total = dict.fromkeys(fns, 0.0)
    rounds = max(calls // batch, 1)
    for _ in range(rounds):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            total[k] += time.perf_counter() - t0
    torch.cuda.synchronize()
    return {k: v / (rounds * batch) * 1e6 for k, v in total.items()}


def host_cost_table(dev) -> dict:
    """{kernel: {"wrapper": us, "library": us or None, "shape": ...}}: the
    host cost of one call of every kernel wrapper (``host_us``) at its
    main path's shape (the probe kernels: the probe tool's), beside the
    one PyTorch call that computes the same function where there is one.
    The inputs are zeros or a fixed pattern that the kernels take: a
    call's host cost follows the shapes, not the words. Uses only the
    wrappers' public signatures, so it also times an older tree's."""
    import torch
    from qatzip_tpu_torch.ops import cuda_pack as cp
    from qatzip_tpu_torch.ops import deflate_pack as dp
    from qatzip_tpu_torch.ops import devprims as dv
    from qatzip_tpu_torch.ops import lz4_pack as lp
    from qatzip_tpu_torch.parallel.dispatch import TILE_B, _tok_knobs

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    n, w, b = 65536, 8192, TILE_B
    probes = _tok_knobs(1, n)[4]
    key = (torch.arange(w, dtype=torch.int32, device=dev) | (5 << 13))
    key = key.expand(b * n // w * 9 // 8, w).contiguous()   # (2304, 8192)
    ctx = z(3, *key.shape)
    im, ml, base = z(b, n, dtype=torch.bool), z(b, n), z(b)
    tables = (z(b, 286), z(b, 30))
    sym = z(b, n)
    table = z(b, 318)
    tidx = z(b, 2 * n, dtype=torch.int64)
    flat = z(b * 2 * n, dtype=torch.int64)
    mw_dyn = (n * dp.DYN_LIMIT + 4096 + 31) // 32 + 2
    u8 = z(b, n, dtype=torch.uint8)
    x65, x512, x4096 = z(65536, 128), z(512, 128), z(4096, 128)
    i65, i512 = x65.to(torch.int64), x512.to(torch.int64)
    sh = torch.tensor((1, 3, 9, 27, 31, 77, 111), dtype=torch.int32,
                      device=dev)

    def rolls(ks):
        def run():
            acc = x4096.clone()
            for k in ks:
                acc += torch.roll(x4096, k, 1)
            return acc
        return run

    def sort_gather():
        ks, order = torch.sort(i65, dim=1)
        return ks, torch.gather(x65, 1, order)
    cases = {
        "candidate_search": (
            lambda: cp.candidate_search(key, ctx, probes=probes, min_match=4,
                                        pbits=13), None, tuple(key.shape)),
        "parse_scan": (lambda: cp.parse_scan(im, ml, 8192), None, (b, n)),
        "pack_rows": (
            lambda: dp.pack_rows(ml, ml, im, im, base, max_words=mw_dyn,
                                 lpack=sym, dpack=sym), None,
            f"dynamic ({b}, {n}) -> ({b}, {mw_dyn})"),
        "huffman_lookup": (lambda: cp.huffman_lookup(*tables, sym, sym),
                           lambda: torch.gather(table, 1, tidx), (b, n)),
        "symbol_histogram": (
            lambda: cp.symbol_histogram(sym, sym),
            lambda: torch.bincount(flat, minlength=b * (cp.NBINS + 1)),
            (b, n)),
        "lz4_pack_rows": (
            lambda: lp.lz4_pack_rows(u8, ml, ml, im, im,
                                     max_words=lp.lz4_max_words(n)),
            None, (b, n)),
        "lane_gather": (lambda: dv.lane_gather(x65, x65),
                        lambda: torch.gather(x65, 1, i65), (65536, 128)),
        "sublane_gather": (lambda: dv.sublane_gather(x512, x512),
                           lambda: torch.gather(x512, 0, i512), (512, 128)),
        "roll_sum": (lambda: dv.roll_sum(x4096), rolls(dv.STATIC_SHIFTS),
                     (4096, 128)),
        "roll_sum dynamic shifts": (lambda: dv.roll_sum(x4096, sh),
                                    rolls(sh.tolist()), (4096, 128)),
        "bitonic128": (lambda: dv.bitonic128(x65, x65), sort_gather,
                       (65536, 128)),
    }
    out = {}
    for name, (kern, lib, shape) in cases.items():
        if name == "symbol_histogram":
            # bincount reads its largest value back to the host: a few
            # calls, each its whole device time
            got = host_us({"wrapper": kern})
            got.update(host_us({"library": lib}, calls=20, batch=10))
        else:
            got = host_us({"wrapper": kern, **({"library": lib} if lib
                                               else {})})
        out[name] = {"wrapper": got["wrapper"], "library": got.get("library"),
                     "shape": shape}
    return out


def sublane_breakdown(dev, measure, shared_loops, kernels_so: str) -> dict:
    """The host cost of one ``sublane_gather`` call at (512, 128), part by
    part (``host_us``, microseconds), beside the same parts of the ctypes
    route the kernels took before (replayed here as a yardstick: the
    checks with ``torch.device`` objects, a locked library lookup, a
    ``torch.cuda.Stream`` object, ctypes with its argtypes), torch.gather
    on the same plane and ``torch.cuda._sleep(0)``, the card's floor for
    one launch from PyTorch (its host cost, and its device time from the
    profiler). A launch is timed in C, 100 launches a call: the kernel
    library's entry, and ``shared_loops`` (LOOP_CU, the CUDA runtime
    linked as a shared library): the same entry, and kernel<<<>>> with
    cudaGetLastError."""
    import ctypes
    import threading
    import numpy as np
    import torch
    from qatzip_tpu_torch.ops import cuda_pack as cp
    from qatzip_tpu_torch.ops import devprims as dv
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.integers(0, 1 << 31, (512, 128), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 512, (512, 128)).astype(
        np.int32)).to(dev)
    idx64 = idx.to(torch.int64)
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), idx.data_ptr(), out.data_ptr())
    k = cp.kernels()
    stream = k.stream(dev.index or 0)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    cdll = ctypes.CDLL(kernels_so)
    cnoop = ctypes.CDLL(measure.__file__).qz_noop
    for fn in (cdll.qz_sublane_gather, cnoop):
        fn.restype, fn.argtypes = ci, [vp, vp, vp, ci, ci, vp]
    lock = threading.Lock()

    def locked():
        with lock:
            return cdll

    def old_require(t, what, dtype, device):
        if t.dtype != dtype:
            raise TypeError(f"{what} must be {dtype}")
        if t.device != device:
            raise ValueError(f"{what} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")

    def old_checks():
        rows, c = x.shape
        log_r = dv._log2(rows, "row count", 1, 1 << 30)
        log_c = dv._log2(c, "row width", 1, 1 << 30)
        if log_r + log_c > 30 or tuple(idx.shape) != (rows, c):
            raise ValueError("plane")
        old_require(x, "x", torch.int32, x.device)
        old_require(idx, "idx", torch.int32, x.device)
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError("device")
        return log_r, log_c

    def new_checks():                    # as the wrapper makes them
        shape = x.shape
        rows, c = shape
        if rows & (rows - 1) or c & (c - 1) or not 0 < rows * c <= 1 << 30:
            raise ValueError("plane")
        if idx.shape != shape:
            raise ValueError("idx")
        return dv._pair(x, idx, "x", "idx")

    def ctypes_route():
        log_r, log_c = old_checks()
        o = torch.empty_like(x)
        rc = locked().qz_sublane_gather(
            x.data_ptr(), idx.data_ptr(), o.data_ptr(), log_r, log_c,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"sublane_gather launch failed: {rc}")
        return o

    check(torch.equal(ctypes_route(), dv.sublane_gather(x, idx)),
          "the ctypes route and the wrapper disagree")
    got = host_us({
        "wrapper": lambda: dv.sublane_gather(x, idx),
        "ctypes route": ctypes_route,
        "torch.gather": lambda: torch.gather(x, 0, idx64),
        "torch.cuda._sleep(0)": lambda: torch.cuda._sleep(0),
        "checks": new_checks,
        "checks, ctypes route": old_checks,
        "torch.empty_like": lambda: torch.empty_like(x),
        "lookup": lambda: cp._ext or cp.kernels(),
        "lookup, ctypes route (a lock)": locked,
        "stream": lambda: k.stream(0),
        "stream, ctypes route (a Stream object)":
            lambda: torch.cuda.current_stream().cuda_stream,
        "three data_ptr()": lambda: (x.data_ptr(), idx.data_ptr(),
                                     out.data_ptr()),
        "extension call, no launch": lambda: measure.noop(*ptrs, 9, 7,
                                                          stream),
        "ctypes call, no launch": lambda: cnoop(*ptrs, 9, 7, stream),
    })
    loop = 100
    entry, chevron = shared_loops
    loops = host_us({
        "launch (C loop, the library's entry)":
            lambda: measure.launch_loop(*ptrs, 9, 7, stream, loop),
        "the same, shared CUDA runtime":
            lambda: entry(*ptrs, 9, 7, stream, loop),
        "kernel<<<>>> and cudaGetLastError, shared CUDA runtime":
            lambda: chevron(*ptrs, 9, 7, stream, loop)},
        calls=20, batch=1)
    got.update({k: v / loop for k, v in loops.items()})
    got["torch.cuda._sleep(0) device time (profiler)"] = device_ms(
        lambda: torch.cuda._sleep(0), 100) * 1e3
    return got


def gunzip_members(blob: bytes):
    """Stock zlib over concatenated gzip members (wbits 31)."""
    out, rest, members = [], blob, 0
    while rest:
        d = zlib.decompressobj(31)
        out.append(d.decompress(rest) + d.flush())
        check(d.eof, "truncated gzip member")
        rest = d.unused_data
        members += 1
    return b"".join(out), members


def main() -> None:
    import torch

    # -- 1. environment -----------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda is not "
          "available")
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch import native, postproc
    from qatzip_tpu_torch.ops import _build, cuda_pack, lz77
    from qatzip_tpu_torch.ops import deflate_pack as dp
    from qatzip_tpu_torch.ops import lz4_pack as lp
    from qatzip_tpu_torch.parallel import dispatch
    from qatzip_tpu_torch.parallel.dispatch import TILE_B, _tok_knobs, plan_tile
    from qatzip_tpu_torch.formats.lz4_format import (parse_lz4_frame_header,
                                                     walk_lz4_blocks)
    from qatzip_tpu_torch.sw.codec import sw_compress
    from qatzip_tpu_torch.sw.lz4_py import lz4_decompress_block_py
    from qatzip_tpu_torch.tools import devprims as dvtool
    # by path: a package named "tests" installed elsewhere may shadow ours
    spec = importlib.util.spec_from_file_location("qz_corpus", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "corpus.py"))
    corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus)

    own_route = dispatch.CudaEngine.packs_on_device

    def set_route(device_pack) -> None:
        """Hold every engine on the device pack (True) or the token path
        (False); None gives the engines their own choice back."""
        dispatch.CudaEngine.packs_on_device = (
            own_route if device_pack is None
            else lambda self, static, algorithm="deflate": device_pack)

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    print(f"env: nvidia-smi {card}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_pack.kernels()
    t1 = time.perf_counter()
    native.get_lib()
    t2 = time.perf_counter()
    kernels_so = _build.kernels_library()
    measure, shared_loops, measure_s = build_measure(kernels_so)
    lib = native.get_lib()
    check(lib.has_zstd, "the native library reaches no zstd >= 1.5 "
          f"(version {lib.zstd_version}): the lz4s -> zstd path needs "
          "libzstd.so.1")
    # the same kernels in one nvcc command, timed and thrown away
    srcs = sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
    one = os.path.join(_build.BUILD_DIR, "one_command_build.so")
    t3 = time.perf_counter()
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", one, *srcs],
                   check=True, capture_output=True)
    one_s = time.perf_counter() - t3
    os.remove(one)
    print(f"build: kernels and their binding {t1 - t0:.2f} s ({len(srcs)} "
          f"nvcc and one cc over binding.c at once, then a link; built this "
          f"run: {_build.BUILD_SECONDS['qztorch_kernels'] > 0}), native "
          f"{t2 - t1:.2f} s; one nvcc over all {len(srcs)} kernel sources "
          f"{one_s:.2f} s; one cc over the measurement extension "
          f"(binding.c and two entries) {measure_s:.2f} s; native linked "
          f"with zstd {lib.zstd_version}")
    for ln in _build.BUILD_LOGS.get("qztorch_kernels", "").splitlines():
        if "Used" in ln or "Compiling entry" in ln:
            print("build: ptxas", ln.strip())

    # -- 3. kernels against their plain versions --------------------------------
    data = corpus.make_silesia_like(64)
    n = 65536
    ss, ov, cs, ctx_words, probes = _tok_knobs(1, n)
    tile = torch.frombuffer(bytearray(data[:TILE_B * n]), dtype=torch.uint8)
    tile = tile.reshape(TILE_B, n).to(dev)
    lengths = torch.full((TILE_B,), n, dtype=torch.int32, device=dev)
    res = {}       # kernel name -> its summary entry

    def record(name, source, replaces, err, ms, plain_ms, library_ms,
               nbytes, ops, shape):
        """Check one kernel's comparison, print it, and keep it for the
        summary (a later record of the same kernel replaces its numbers)."""
        b_ms, b_by = bound_ms(nbytes, ops)
        check(err == 0, f"{name} differs from its plain version (max abs "
              f"err {err})")
        # keys an earlier record added (another mode, adversarial planes)
        # stay
        res[name] = {**res.get(name, {}), **{
            "name": name, "route": "cuda",
            "source": f"qatzip_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}}
        lib_s = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"kernel {name} {shape}: identical, {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms, library {lib_s}, bound {b_ms:.4f} ms "
              f"({b_by})")

    def adversarial(name, plane, shape, err, ms, plain_ms):
        """Check one kernel on an adversarial plane at the main path's
        shape and keep its time beside the kernel's summary entry."""
        check(err == 0, f"{name} differs from its plain version on the "
              f"{plane} plane (max abs err {err})")
        res[name].setdefault("adversarial", []).append(
            {"plane": plane, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms})
        print(f"kernel {name} {shape} {plane}: identical, {ms:.4f} ms vs "
              f"plain {plain_ms:.4f} ms")

    key, ctx, pbits, unwindow = lz77._search_inputs(
        tile, lengths, n=n, min_match=4, window=32768, ctx_words=ctx_words,
        search_seg=ss, search_overlap=ov)
    check(tuple(key.shape) == (2304, 8192) and ctx.shape[0] == 3,
          f"unexpected k2 shapes {tuple(key.shape)} {tuple(ctx.shape)}")
    kw = dict(probes=probes, min_match=4, pbits=pbits)
    k2_ops, k2_counts = k2_probe_ops(key, ctx, probes, pbits)
    got = cuda_pack.candidate_search(key, ctx, **kw)
    err = max_err(got, cuda_pack.candidate_search_ref(key, ctx, **kw))
    k2_pos = key.numel()
    w = key.shape[1]
    record("candidate_search", "candidate_search.cu",
           "qatzip_tpu/ops/pallas_pack.py:242", err,
           event_ms(lambda: cuda_pack.candidate_search(key, ctx, **kw), 10),
           event_ms(lambda: cuda_pack.candidate_search_ref(key, ctx, **kw),
                    2), None,
           # key, ctx_words context words and the output, 4 bytes each;
           # the probes' compares on this tile
           k2_pos * 4 * (2 + ctx_words), k2_ops, tuple(key.shape))
    matched = float(((got >> 13) & 0x1F).gt(0).float().mean())
    print(f"kernel candidate_search: ctx {ctx_words} probes {probes}; "
          f"positions with a candidate {matched:.3f}; counts: same-hash "
          f"predecessors probed per position {k2_counts['probed_per_pos']:.3f}"
          f", positions at the cap {k2_counts['cap_share']:.3f}, buckets per "
          f"window min / mean / max {k2_counts['buckets']}, keys in the "
          f"overflow bucket {k2_counts['overflow_share']:.4f}")
    # adversarial: every key of every window in one bucket, so every
    # position probes its 7 predecessors on the tile's own context
    one = ((12345 << pbits) | torch.arange(w, dtype=torch.int32,
                                           device=dev)).expand_as(key)
    one = one.contiguous()
    adversarial("candidate_search", "one bucket", tuple(one.shape),
                max_err(cuda_pack.candidate_search(one, ctx, **kw),
                        cuda_pack.candidate_search_ref(one, ctx, **kw)),
                event_ms(lambda: cuda_pack.candidate_search(one, ctx, **kw),
                         10),
                event_ms(lambda: cuda_pack.candidate_search_ref(
                    one, ctx, **kw), 2))
    del one

    kv = unwindow(got)
    is_match, ml_c, _dist, seg = lz77._parse_inputs(
        lengths, (kv >> 13) & 0x1F, (kv & 0x1FFF) + 1, n=n, min_match=4,
        max_match=258, ctx_bytes=4 * ctx_words, parse_seg=8192)
    lanes = TILE_B * (n // seg)
    check(lanes == 2048 and seg == 8192, f"unexpected parse lanes {lanes}")
    taken, lit = cuda_pack.parse_scan(is_match, ml_c, seg)
    err = max_err((taken, lit), cuda_pack.parse_scan_ref(is_match, ml_c, seg))
    tk_ml = ml_c[taken].float()
    print(f"kernel parse_scan: counts: positions that may start a match "
          f"{float(is_match.float().mean()):.4f}, that start a taken match "
          f"{float(taken.float().mean()):.4f} (mean length "
          f"{float(tk_ml.mean()):.2f}, max {int(tk_ml.max())}); 32-position "
          f"sub-block starts on the true path "
          f"{float((taken | lit)[:, ::32].float().mean()):.4f}")
    del taken, lit, tk_ml
    record("parse_scan", "parse_scan.cu", "qatzip_tpu/ops/lz77.py:97", err,
           event_ms(lambda: cuda_pack.parse_scan(is_match, ml_c, seg), 10),
           event_ms(lambda: cuda_pack.parse_scan_ref(is_match, ml_c, seg), 1),
           None, is_match.numel() * (1 + 4 + 2), is_match.numel() * 4,
           (lanes, seg))
    # adversarial: each segment's first position a literal, every other a
    # match of 4, so the true path (1 mod 4) never meets a walk started
    # on a sub-block boundary (0 mod 4)
    col = torch.arange(n, device=dev) % seg
    nm_im = (col != 0).expand(TILE_B, n).contiguous()
    nm_ml = torch.full((TILE_B, n), 4, dtype=torch.int32, device=dev)
    adversarial("parse_scan", "never-meet", (lanes, seg),
                max_err(cuda_pack.parse_scan(nm_im, nm_ml, seg),
                        cuda_pack.parse_scan_ref(nm_im, nm_ml, seg)),
                event_ms(lambda: cuda_pack.parse_scan(nm_im, nm_ml, seg), 10),
                event_ms(lambda: cuda_pack.parse_scan_ref(nm_im, nm_ml, seg),
                         1))
    del key, ctx, got, kv, is_match, ml_c, nm_im, nm_ml

    # the device packers' planes of the same tile, at the level-1 knobs
    ml, dist, taken, lit = dp._analyze_planes(
        tile, lengths, n=n, parse_seg=8192, ctx_words=ctx_words,
        probes=probes, search_seg=ss, search_overlap=ov)

    def k1_phase(label, planes, base, max_words, group_w, emit, **kw):
        """The row bit-packer on the tile's own planes against its plain
        version and against the route it replaced; recorded under
        pack_rows (the dynamic phase, the wider one, comes last)."""
        args = (*planes, base)
        got = dp.pack_rows(*args, max_words=max_words, **kw)
        err = max_err(got, dp.pack_rows_ref(*args, max_words=max_words,
                                            **kw))
        base64 = base.to(torch.int64)[:, None]
        old = pr3_route(emit, base64, max_words, group_w)
        check(max_err(got, old) == 0, f"pack_rows ({label}) differs from "
              "the route it replaced")
        old_ms = event_ms(lambda: pr3_route(emit, base64, max_words,
                                            group_w), 3)
        b_, n_ = planes[0].shape
        # every plane byte read once (int32 ml, dist and, dynamic, lpack
        # and dpack; the byte planes), the words, end and base once
        per_pos = sum(t.element_size() for t in (*planes, *kw.values()))
        record("pack_rows", "pack_rows.cu",
               "qatzip_tpu/ops/pallas_pack.py:342", err,
               event_ms(lambda: dp.pack_rows(*args, max_words=max_words,
                                             **kw), 20),
               event_ms(lambda: dp.pack_rows_ref(*args, max_words=max_words,
                                                 **kw), 3), None,
               b_ * n_ * per_pos + b_ * (max_words + 2) * 4,
               # at the least: the emission's code arithmetic (~8), its
               # offset (a scan add) and two word parts (shift, OR each)
               b_ * n_ * 14, f"{label} ({b_}, {n_}) -> ({b_}, {max_words})")
        new_ops, new_peak = device_cost(
            lambda: dp.pack_rows(*args, max_words=max_words, **kw))
        old_ops, old_peak = device_cost(
            lambda: pr3_route(emit, base64, max_words, group_w))
        entry = res["pack_rows"]
        entry[label] = {k: entry[k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms")}
        entry[label].update(pr3_route_ms=old_ms, pr3_route_device_ops=old_ops,
                            pr3_route_peak_bytes=old_peak,
                            device_ops=new_ops, peak_bytes=new_peak)
        print(f"kernel pack_rows {label}: identical to the PR 3 route "
              f"(emissions, offsets, group pack, plain assembly), which takes "
              f"{old_ms:.4f} ms, {old_ops} device operations and {old_peak} "
              f"bytes of device memory above the planes a tile; pack_rows "
              f"{new_ops} and {new_peak}")

    def k1_adversarial(label, base, max_words, kw_of):
        """The row bit-packer on back-to-back 4-byte matches at distance
        32768 over the tile: the widest distance parts, straddling word
        boundaries throughout; ``kw_of`` gives the mode's planes."""
        tk = (torch.arange(n, device=dev) % 4 == 0).expand(TILE_B, n)
        tk = tk.contiguous()
        ml4 = torch.where(tk, 4, 0).to(torch.int32)
        d4 = torch.where(tk, 32768, 1).to(torch.int32)
        kw = kw_of(ml4, d4, tk)
        args = (ml4, d4, tk, torch.zeros_like(tk), base)
        adversarial("pack_rows", f"far-4 {label}", (TILE_B, n),
                    max_err(dp.pack_rows(*args, max_words=max_words, **kw),
                            dp.pack_rows_ref(*args, max_words=max_words,
                                             **kw)),
                    event_ms(lambda: dp.pack_rows(*args, max_words=max_words,
                                                  **kw), 20),
                    event_ms(lambda: dp.pack_rows_ref(
                        *args, max_words=max_words, **kw), 3))

    planes = (ml, dist, taken, lit)
    hdr3 = torch.full((TILE_B,), dp.HDR_BITS, dtype=torch.int32, device=dev)
    mw_static = (n * 9 + dp.HDR_BITS + dp.EOB_BITS + 31) // 32 + 2
    k1_phase("static", planes, hdr3, mw_static, 74,
             lambda: dp.static_emissions(tile, *planes), data=tile)
    k1_adversarial("static", hdr3, mw_static,
                   lambda ml4, d4, tk: {"data": tile})

    sym, dsym_m = dp.hist_symbols(tile, ml, dist, taken, lit)
    hist = cuda_pack.symbol_histogram(sym, dsym_m)
    err = max_err(hist, cuda_pack.symbol_histogram_ref(sym, dsym_m))
    # the library call's input: row * (NBINS + 1) + value, each row's
    # values that do not count in the row's own spare bin NBINS
    row = torch.arange(TILE_B, device=dev)[:, None] * (cuda_pack.NBINS + 1)
    flat = (row + torch.cat([sym, dsym_m], 1).clamp(
        max=cuda_pack.NBINS)).reshape(-1)
    check(torch.equal(torch.bincount(
        flat, minlength=TILE_B * (cuda_pack.NBINS + 1)).reshape(
            TILE_B, -1)[:, :cuda_pack.NBINS].to(torch.int32), hist),
        "symbol_histogram: the library call counts otherwise")
    record("symbol_histogram", "symbol_histogram.cu",
           "qatzip_tpu/ops/pallas_pack.py:312", err,
           event_ms(lambda: cuda_pack.symbol_histogram(sym, dsym_m), 20),
           event_ms(lambda: cuda_pack.symbol_histogram_ref(sym, dsym_m), 3),
           event_ms(lambda: torch.bincount(
               flat, minlength=TILE_B * (cuda_pack.NBINS + 1)), 10),
           sym.numel() * 8 + hist.numel() * 4, sym.numel() * 2,
           tuple(sym.shape))
    del sym, dsym_m, flat

    packs, dpacks, _hdrs, hbits = plan_tile(hist.cpu().numpy(), TILE_B)
    lit_pack = torch.from_numpy(packs.astype("int32")).to(dev)
    dist_pack = torch.from_numpy(dpacks.astype("int32")).to(dev)
    lsym, ldsym = dp.lookup_symbols(tile, ml, dist, taken, lit)
    lpack, dpack = cuda_pack.huffman_lookup(lit_pack, dist_pack, lsym, ldsym)
    err = max_err((lpack, dpack), cuda_pack.huffman_lookup_ref(
        lit_pack, dist_pack, lsym, ldsym))
    z = torch.zeros((TILE_B, 1), dtype=torch.int32, device=dev)
    table = torch.cat([lit_pack, z, dist_pack, z], 1)
    tidx = torch.cat([torch.where(lsym < 286, lsym, 286),
                      torch.where(ldsym < 30, ldsym + 287, 317)],
                     1).to(torch.int64)
    record("huffman_lookup", "huffman_lookup.cu",
           "qatzip_tpu/ops/pallas_pack.py:86", err,
           event_ms(lambda: cuda_pack.huffman_lookup(
               lit_pack, dist_pack, lsym, ldsym), 20),
           event_ms(lambda: cuda_pack.huffman_lookup_ref(
               lit_pack, dist_pack, lsym, ldsym), 3),
           event_ms(lambda: torch.gather(table, 1, tidx), 10),
           lsym.numel() * 16 + TILE_B * 316 * 4, lsym.numel() * 2,
           tuple(lsym.shape))
    del lsym, ldsym, table, tidx

    hdr = torch.from_numpy(hbits).to(dev)
    mw_dyn = (n * dp.DYN_LIMIT + 4096 + 31) // 32 + 2

    def lookup(ml4, d4, tk):
        """The far-4 plane's codes in the tile's own tables."""
        lp, dq = cuda_pack.huffman_lookup(
            lit_pack, dist_pack,
            *dp.lookup_symbols(tile, ml4, d4, tk, torch.zeros_like(tk)))
        return {"lpack": lp, "dpack": dq}
    k1_adversarial("dynamic", hdr, mw_dyn, lookup)
    k1_phase("dynamic", planes, hdr, mw_dyn, 99,
             lambda: dp.dynamic_emissions(*planes, lpack, dpack),
             lpack=lpack, dpack=dpack)
    del lpack, dpack, ml, dist, taken, lit, hist, planes
    torch.cuda.empty_cache()

    # the LZ4 device pack's planes of the same tile: the full-row search
    # (the level >= 6 knobs, timed apart), then the LZ4 parse
    full_row_ms = event_ms(lambda: lz77._full_row_search(
        tile, lengths, n=n, min_match=4, window=32768, ctx_words=4,
        probes=6), 3)
    print(f"layer full-row search: device time of the candidate search over "
          f"whole rows, ({TILE_B}, {n}), CUDA events: {full_row_ms:.3f} ms a "
          f"tile")
    mw_lz4 = lp.lz4_max_words(n)

    def lz4_check(label, planes, adversarial_plane=None, mw=mw_lz4):
        """The LZ4 byte packer on ``planes`` against its plain version and
        the torch route it stands for (nbytes and ok on every row, words
        on ok rows), ``mw`` words a row; recorded, or kept as an
        adversarial plane."""
        got = lp.lz4_pack_rows(*planes, max_words=mw)
        err = max_err(got, lp.lz4_pack_rows_ref(*planes, max_words=mw))
        old = lz4_route(*planes, mw)
        ok = got[2]
        check(torch.equal(got[1], old[1]) and torch.equal(ok, old[2])
              and torch.equal(got[0][ok], old[0][ok]),
              f"lz4_pack_rows ({label}) differs from the torch route")
        check(not got[0][~ok].any(), f"lz4_pack_rows ({label}): a row that "
              "is not ok holds a word that is not zero")
        ms = event_ms(lambda: lp.lz4_pack_rows(*planes, max_words=mw), 20)
        plain_ms = event_ms(lambda: lp.lz4_pack_rows_ref(
            *planes, max_words=mw), 3)
        route_ms = event_ms(lambda: lz4_route(*planes, mw), 3)
        b_ = planes[0].shape[0]
        if adversarial_plane is not None:
            adversarial("lz4_pack_rows", adversarial_plane,
                        (b_, n, mw), err, ms, plain_ms)
            res["lz4_pack_rows"]["adversarial"][-1].update(
                torch_route_ms=route_ms, rows_not_ok=int((~ok).sum()))
        else:
            record("lz4_pack_rows", "lz4_pack_rows.cu",
                   "qatzip_tpu/ops/lz4_pack.py:93", err, ms, plain_ms, None,
                   # data, ml, dist, taken and lit read once, the words,
                   # nbytes and ok written once
                   b_ * n * 11 + b_ * (mw_lz4 * 4 + 5),
                   # at the least: the emission's byte arithmetic (~8), its
                   # offset (a scan add) and two word parts
                   b_ * n * 12, f"({b_}, {n}) -> ({b_}, {mw_lz4})")
            new_ops, new_peak = device_cost(
                lambda: lp.lz4_pack_rows(*planes, max_words=mw_lz4))
            old_ops, old_peak = device_cost(
                lambda: lz4_route(*planes, mw_lz4))
            dev_ms = device_ms(lambda: lp.lz4_pack_rows(*planes,
                                                        max_words=mw), 20)
            res["lz4_pack_rows"].update(
                torch_route_ms=route_ms, torch_route_device_ops=old_ops,
                torch_route_peak_bytes=old_peak, device_ops=new_ops,
                peak_bytes=new_peak, rows_not_ok=int((~ok).sum()),
                device_ms=dev_ms)
            print(f"kernel lz4_pack_rows: identical to the torch route (run "
                  f"planes, emissions, cumsum, group pack), which takes "
                  f"{route_ms:.4f} ms, {old_ops} device operations and "
                  f"{old_peak} bytes of device memory above the planes a "
                  f"tile; lz4_pack_rows {new_ops} and {new_peak}, device "
                  f"time a launch (profiler) {dev_ms:.4f} ms; rows not ok "
                  f"{int((~ok).sum())} of {b_}")
        return ok

    lz4_check("tile", (tile,) + tuple(lp.lz4_planes(tile, lengths, n=n)))
    for plane, kind in (("A * n", "A"), ("runs 269/270/271, n - 3, empty",
                                         "runs")):
        adv, adv_len = lz4_adversarial(n, kind, TILE_B)
        adv = torch.from_numpy(adv).to(dev)
        ok = lz4_check(plane, (adv,) + tuple(lp.lz4_planes(
            adv, torch.from_numpy(adv_len).to(dev), n=n)), plane)
        want_ok = [kind == "A" or i % 5 != 2 for i in range(TILE_B)]
        check(ok.tolist() == want_ok, f"lz4_pack_rows ({plane}): ok flags "
              f"{ok.tolist()[:10]}... where {want_ok[:10]}... was due")
        del adv
    # hand-made planes where the kernel's design is tight (runs of 270 and
    # 271 across steps and the staging ring, a long run only at the row's
    # end, a 4-byte emission at a step's end), all rows, then B = 1 and 3,
    # a max_words under the block, and the planes off their alignment
    hand = [torch.from_numpy(a).to(dev)
            for a in lz4_plane_rows(n, TILE_B, seed=17)]
    bad = ("run 271 across a step", "long run at the end", "all literals")
    want_ok = [LZ4_PLANE_KINDS[i % len(LZ4_PLANE_KINDS)] not in bad
               for i in range(TILE_B)]
    moved = []
    for a in hand:
        flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=dev)
        flat[1:] = a.reshape(-1)
        moved.append(flat[1:].reshape(a.shape))
    for plane, planes, mw, rows_ok in (
            ("hand-made planes", hand, mw_lz4, want_ok),
            ("hand-made planes, B = 1", [a[:1] for a in hand], mw_lz4,
             want_ok[:1]),
            ("hand-made planes, B = 3", [a[:3] for a in hand], mw_lz4,
             want_ok[:3]),
            ("hand-made planes, max_words 1000", hand, 1000, want_ok),
            ("hand-made planes off their alignment (scalar loads)", moved,
             mw_lz4, want_ok)):
        ok = lz4_check(plane, planes, plane, mw)
        check(ok.tolist() == rows_ok, f"lz4_pack_rows ({plane}): ok flags "
              f"{ok.tolist()[:14]}... where {rows_ok[:14]}... was due")
    del hand, moved, flat
    torch.cuda.empty_cache()

    probe_kernels(dev, 128, record, adversarial, res)
    torch.cuda.empty_cache()

    # the host cost of one call of every wrapper, then the sublane
    # gather's part by part
    costs = host_cost_table(dev)
    for name, cost in costs.items():
        if name == "roll_sum dynamic shifts":
            res["roll_sum"]["host_us_per_call"]["dynamic shifts"] = cost
        else:
            res[name]["host_us_per_call"] = cost
        lib_s = ("none" if cost["library"] is None
                 else f"{cost['library']:.2f} us")
        print(f"host cost of one call {name} {cost['shape']}: wrapper "
              f"{cost['wrapper']:.2f} us, library call {lib_s} (host clock "
              "over 1000 calls in batches of 100, no sync in a batch)")
    parts = sublane_breakdown(dev, measure, shared_loops, kernels_so)
    res["sublane_gather"]["host_breakdown_us"] = parts
    res["sublane_gather"]["launch_floor_ms"] = (
        parts["torch.cuda._sleep(0)"] / 1e3)
    print("host cost breakdown of one sublane_gather call at (512, 128), "
          "us a call (host clock over 1000 calls in batches of 100): "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    torch.cuda.empty_cache()

    # -- 4. the tokenizer layer, then the paths ------------------------------------------
    full = len(data) // (TILE_B * n)           # full tiles only

    def over_tiles(tokenize):
        def run():
            for t in range(full):
                rows = torch.frombuffer(
                    bytearray(data[t * TILE_B * n:(t + 1) * TILE_B * n]),
                    dtype=torch.uint8).reshape(TILE_B, n)
                tokenize(rows.to(dev))
        return run
    tok_ms = event_ms(over_tiles(lambda rows: lz77.lz77_tokenize(
        rows, lengths, n=n, parse_seg=8192, search_seg=ss,
        search_overlap=ov, compact_seg=cs, ctx_words=ctx_words,
        probes=probes)), 2)
    ana_ms = event_ms(over_tiles(lambda rows: dp._analyze_planes(
        rows, lengths, n=n, parse_seg=8192, ctx_words=ctx_words,
        probes=probes, search_seg=ss, search_overlap=ov)), 2)
    tiled = full * TILE_B * n
    print(f"layer tokenize: device tokenize (incl. h2d) of {full} full "
          f"tiles, CUDA events: lz77_tokenize (token path) {tok_ms:.1f} ms "
          f"= {tiled / tok_ms / 1e6:.4f} GB/s; _analyze_planes (device "
          f"packs) {ana_ms:.1f} ms = {tiled / ana_ms / 1e6:.4f} GB/s")
    torch.cuda.empty_cache()

    zl1 = len(zlib.compress(data, 1))
    chunks = [data[o:o + n] for o in range(0, len(data), n)]
    from torch.profiler import ProfilerActivity, profile
    launches_by_path = {}
    warm_by_path = {}
    ratio_by_path = {}

    def session(kind, level, device):
        """A session of the path's kind on ``device``."""
        s = qz.QzSession(device=device)
        if kind.startswith("lz4s"):
            p = qz.SessionParamsLZ4S()
            p.qzCallback = postproc.zstd_callback
            check(s.setup_lz4s(p) == qz.QZ_OK, "setup_lz4s failed")
        elif kind == "lz4":
            check(s.setup_lz4() == qz.QZ_OK, "setup_lz4 failed")
        else:
            p = qz.SessionParamsDeflate()
            p.common.comp_lvl = level
            if kind == "static":
                p.huffman_hdr = qz.HuffmanHdr.STATIC_HDR
            check(s.setup_deflate(p) == qz.QZ_OK, "setup_deflate failed")
        return s

    def lz4_blocks(blob: bytes):
        info = parse_lz4_frame_header(blob, 0)
        check(info is not None, "not an LZ4 frame")
        walked = walk_lz4_blocks(blob, 0, len(blob), info.header_sz)
        check(walked is not None, "an LZ4 frame cut short")
        return [(blob[o:o + sz], st) for o, sz, st in walked[0]]

    def decodes(name, kind, sess, out):
        """Check ``out`` with an independent decoder; return what it
        says of the output's shape."""
        if kind == "lz4s-zstd":
            check(out[:4] == b"\x28\xb5\x2f\xfd", f"{name}: not zstd")
            check(postproc.zstd_decompress(out) == data,
                  f"{name}: libzstd does not give back the input")
            return "zstd frames, libzstd decodes them"
        if kind == "lz4":
            blocks = lz4_blocks(out)
            head = b"".join(p if st else lz4_decompress_block_py(p, n)
                            for p, st in blocks[:(1 << 20) // n])
            check(head == data[:len(head)] and len(head) == 1 << 20,
                  f"{name}: the pure-Python LZ4 decoder does not give back "
                  "the first 1 MiB")
            check(sess.decompress(out) == data, f"{name}: session "
                  "decompress differs")
            stored = sum(st for _p, st in blocks)
            return (f"{len(blocks)} blocks ({stored} stored), the first "
                    "1 MiB decoded by the pure-Python decoder")
        plain, members = gunzip_members(out)
        check(plain == data, f"{name}: stock zlib does not give back the "
              "input")
        check(members == len(chunks),
              f"{name}: {members} gzip members for {len(data)} bytes")
        check(sess.decompress(out) == data, f"{name}: session decompress "
              "differs")
        return f"{members} members, stock zlib decodes them"

    for name, kind, level, route, kernels in PATHS:
        set_route(route)
        sess = session(kind, level, "cuda")
        torch.cuda.reset_peak_memory_stats()
        cuda_pack.reset_launch_counts()
        t0 = time.perf_counter()
        out = sess.compress(data)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = dict(cuda_pack.LAUNCHES)
        launches_by_path[name] = launches
        check(all(launches[k] > 0 for k in kernels),
              f"{name}: a kernel of the path never launched: {launches}")
        shape = decodes(name, kind, sess, out)
        t0 = time.perf_counter()
        out2 = sess.compress(data)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        check(out2 == out, f"{name}: a second compress gave other bytes")
        peak = torch.cuda.max_memory_allocated()
        warm_by_path[name] = len(data) / warm_s / 1e9
        ratio_by_path[name] = len(data) / len(out)
        vs = (f", vs zlib level 1 {zl1 / len(out):.4f}"
              if kind in ("dynamic", "static") else "")
        fr = (f"; full-row search {full_row_ms:.3f} ms a tile"
              if name in FULL_ROW_PATHS else "")
        print(f"path {name}: {len(data)} bytes -> {len(out)} ({shape}), "
              f"ratio {len(data) / len(out):.4f}{vs}; compress cold "
              f"{cold_s:.3f} s = {len(data) / cold_s / 1e9:.4f} GB/s, warm "
              f"{warm_s:.3f} s = {warm_by_path[name]:.4f} GB/s; peak device "
              f"memory {peak} bytes; launches {launches}{fr}")

        # breakdown: the engine's stages apart
        eng = sess._engine
        finals = [True] * len(chunks)
        if kind == "lz4" and route:
            t0 = time.perf_counter()
            items = eng._lz4_device_pack(chunks, n)
            torch.cuda.synchronize()
            dev_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fetched = list(eng._fetch_lz4(items))
            fetch_s = time.perf_counter() - t0
            nfetch = sum(f[2].nbytes for f in fetched)
            not_ok = sum(int((~f[4][:f[1]]).sum()) for f in fetched)
            t0 = time.perf_counter()
            eng._finish_lz4(chunks, fetched)
            host_s = time.perf_counter() - t0
            del items, fetched
            print(f"breakdown {name}: stage + device pack {dev_s:.3f} s, d2h "
                  f"fetch {fetch_s:.3f} s ({nfetch} bytes fetched), host "
                  f"finish {host_s:.3f} s on {os.cpu_count()} cpus; rows "
                  f"not ok (coded again on the host) {not_ok} of "
                  f"{len(chunks)}")
        elif kind in ("lz4", "lz4s-zstd") or route is False:
            alg = {"lz4": "lz4", "lz4s-zstd": "lz4s"}.get(kind, "deflate")
            t0 = time.perf_counter()
            tiles = list(eng._tokenize_tiles(chunks, n, level, alg))
            dev_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            packed = eng._pack(chunks, finals, 0, tiles, alg)
            host_s = time.perf_counter() - t0
            fetched = sum(t[2].nbytes for t in tiles)
            post = ""
            if kind == "lz4s-zstd":
                stream = b"".join(len(p).to_bytes(4, "little") + p
                                  for p, _c in packed)
                t0 = time.perf_counter()
                postproc.zstd_callback(None, data, stream, sess.mini_match)
                post = (f", zstd post-process {time.perf_counter() - t0:.3f}"
                        f" s ({len(stream)} LZ4s bytes in)")
            print(f"breakdown {name}: stage + tokenize + fetch {dev_s:.3f} s "
                  f"({fetched} token bytes fetched), host pack alone "
                  f"{host_s:.3f} s on {os.cpu_count()} cpus{post}")
            del tiles, packed
        else:
            dynamic = kind == "dynamic"
            torch.cuda.synchronize()
            # time every host tree build of the run where it happens
            plan_s = [0.0]

            def timed_plan(*args):
                t0 = time.perf_counter()
                out = real_plan(*args)
                plan_s[0] += time.perf_counter() - t0
                return out
            real_plan, dispatch.plan_tile = dispatch.plan_tile, timed_plan
            try:
                t0 = time.perf_counter()
                items = eng._device_pack(chunks, n, level, dynamic)
                torch.cuda.synchronize()
                dev_s = time.perf_counter() - t0
            finally:
                dispatch.plan_tile = real_plan
            t0 = time.perf_counter()
            fetched = list(eng._fetch_words(items))
            fetch_s = time.perf_counter() - t0
            nfetch = sum(f[2].nbytes + f[3].nbytes for f in fetched)
            t0 = time.perf_counter()
            eng._finish(chunks, finals, fetched)
            host_s = time.perf_counter() - t0
            del items, fetched
            print(f"breakdown {name}: stage + device pack (dyn_plan "
                  f"included) {dev_s:.3f} s, d2h fetch {fetch_s:.3f} s "
                  f"({nfetch} bytes fetched), host finish {host_s:.3f} s on "
                  f"{os.cpu_count()} cpus, dyn_plan {plan_s[0]:.3f} s")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.compress(data)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        # device-side events only (kernels, copies): the host ops that
        # launched them carry the same time again
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in evs)
        print(f"profile {name}: one compress {prof_s:.3f} s under the "
              f"profiler, device busy {dev_us / 1e3:.2f} ms = "
              f"{dev_us / 1e4 / prof_s:.2f} % of it, "
              f"{sum(e.count for e in evs)} device operations")
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"profile {name}:   {e.self_device_time_total / 1e3:9.3f} "
                  f"ms {100 * e.self_device_time_total / max(dev_us, 1):5.1f}"
                  f" % x{e.count:<5d} {e.key[:80]}")
        torch.cuda.empty_cache()
    set_route(None)
    pick = dispatch.CudaEngine(dev).packs_on_device(False, "lz4")
    print(f"route lz4: warm GB/s token {warm_by_path['lz4-token']:.4f} vs "
          f"device pack {warm_by_path['lz4-device-pack']:.4f}, ratio token "
          f"{ratio_by_path['lz4-token']:.4f} vs device pack "
          f"{ratio_by_path['lz4-device-pack']:.4f}; the engine on the card "
          f"takes the {'device pack' if pick else 'token path'}")

    # the devprims path: the probe tool's main at its defaults (B = 128),
    # which runs the four probe kernels beside their library calls
    cuda_pack.reset_launch_counts()
    t0 = time.perf_counter()
    tool_lines = dvtool.main(["--device", "cuda"])
    torch.cuda.synchronize()
    tool_s = time.perf_counter() - t0
    launches = dict(cuda_pack.LAUNCHES)
    launches_by_path["devprims"] = launches
    check(all(launches[k] > 0 for k in DEVPRIMS_KERNELS),
          f"devprims: a probe kernel never launched: {launches}")
    check(len(tool_lines) == 14 and tool_lines[-1]["ok"],
          "devprims: the tool did not run every case")
    print(f"path devprims: {len(tool_lines)} cases in {tool_s:.2f} s; "
          f"launches {launches}")

    # the row split: 256 KiB chunks, each cut into four 64 KiB rows, on
    # the dynamic device pack (the card's own route for the session)
    p = qz.SessionParamsDeflate()
    p.common.hw_buff_sz = SPLIT_HW
    sess = qz.QzSession(device="cuda")
    check(sess.setup_deflate(p) == qz.QZ_OK, "setup_deflate failed")
    cuda_pack.reset_launch_counts()
    t0 = time.perf_counter()
    out = sess.compress(data)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(cuda_pack.LAUNCHES)
    launches_by_path["split-256k-dynamic"] = launches
    check(all(launches[k] > 0 for k in PATHS[2][4]),
          f"split: a kernel of the path never launched: {launches}")
    plain, members = gunzip_members(out)
    check(plain == data and members == -(-len(data) // SPLIT_HW),
          f"split: stock zlib gives {members} members that differ")
    t0 = time.perf_counter()
    check(sess.compress(data) == out, "split: a second compress differs")
    warm_s = time.perf_counter() - t0
    head = data[:1 << 20]
    set_route(True)                      # the CPU engine on the same route
    cpu = qz.QzSession(device="cpu")
    cpu.setup_deflate(p)
    cpu_head = cpu.compress(head)
    set_route(None)
    check(out[:len(cpu_head)] == cpu_head, "split: the first 1 MiB's "
          "members differ from the CPU session's")
    print(f"path split-256k-dynamic: {len(data)} bytes -> {len(out)} "
          f"({members} members of {SPLIT_HW} bytes, stock zlib decodes them; "
          f"the first 1 MiB equal to the CPU session's), ratio "
          f"{len(data) / len(out):.4f}; compress cold {cold_s:.3f} s, warm "
          f"{warm_s:.3f} s = {len(data) / warm_s / 1e9:.4f} GB/s against "
          f"the 64 KiB dynamic path's {warm_by_path[MAIN_PATH]:.4f}; "
          f"launches {launches}")

    # one QZ_AUTO_SELECT_BEST request: the smaller of the engine's output
    # and the software coder's
    p = qz.SessionParamsDeflate()
    p.common.sw_backup = qz.QZ_AUTO_SELECT_BEST
    sess = qz.QzSession(device="cuda")
    check(sess.setup_deflate(p) == qz.QZ_OK, "setup_deflate failed")
    t0 = time.perf_counter()
    out = sess.compress(data)
    auto_s = time.perf_counter() - t0
    sw_out, _crc = sw_compress(data, qz.DataFormat.DEFLATE_GZIP_EXT, 1, n)
    pick = "software" if out == sw_out else "engine"
    check(gunzip_members(out)[0] == data, "auto-select: stock zlib does not "
          "give back the input")
    check(len(out) <= len(sw_out), "auto-select: the larger output won")
    print(f"path auto-select-best: {len(data)} bytes -> {len(out)} (pick "
          f"{pick}; software {len(sw_out)} bytes), {auto_s:.3f} s")
    del out, sw_out, plain

    # -- 5. CPU and CUDA agree ---------------------------------------------------
    head = data[:1 << 20]
    for name, kind, level, route, _k in PATHS:
        # both engines held on the path (the CPU engine's own choice for a
        # dynamic session is the token path)
        set_route(route if route is not None else kind in ("dynamic",
                                                          "static"))
        outs = []
        for device in ("cpu", "cuda"):
            s = session(kind, level, device)
            t0 = time.perf_counter()
            outs.append(s.compress(head))
            if device == "cpu":
                cpu_s = time.perf_counter() - t0
        check(outs[0] == outs[1], f"{name}: device='cpu' and device='cuda' "
              "give other bytes for the first 1 MiB")
        print(f"cpu-vs-cuda {name}: first 1 MiB identical ({len(outs[0])} "
              f"bytes; plain versions on the host took {cpu_s:.3f} s)")
    set_route(None)

    # -- 6. summary -----------------------------------------------------------------
    for name, entry in res.items():
        entry["launches"] = launches_by_path[HOME_PATH.get(name,
                                                           MAIN_PATH)][name]
        check(entry["launches"] > 0, f"{name} never launched on its path")
        entry["launches_by_path"] = {p: c[name]
                                     for p, c in launches_by_path.items()}
    print(json.dumps({"kernels": list(res.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def host_cost_only() -> None:
    """``--host-cost``: the card line, then ``host_cost_table`` as one JSON
    line. Run from another tree's root through runpy, it times that
    tree's wrappers (a paired comparison)."""
    import torch
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda is not "
          "available")
    from qatzip_tpu_torch.ops import cuda_pack
    cuda_pack.kernels()
    print(card_line())
    print(json.dumps(host_cost_table(torch.device("cuda", 0))))


if __name__ == "__main__":
    if sys.argv[1:] == ["--host-cost"]:
        host_cost_only()
    else:
        main()
