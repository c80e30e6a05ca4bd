"""End-to-end check of qatzip_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(``python3 chip_smoke.py --host-cost`` runs only the host cost of one call
of every kernel wrapper, ``host_cost_table``; ``python3 chip_smoke.py
--pair parent=a.log change=b.log ...`` reads the logs of earlier runs,
of this tree and another, and sets the device times of
``lz4_resolve_refs`` and ``crc32_rows`` side by side with their bounds,
``pair_report``; ``python3 chip_smoke.py --crc-variants`` builds
``crc32_rows`` in the other CTA shapes it was chosen over and times
them, ``crc_variants``; ``python3 chip_smoke.py --threads`` times
``qztest -m 4`` threads sharing one engine, free and one request at a
time, ``thread_probe``.)

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
     that route's time; the stage kernels between them at the level-1
     main path's shapes: the search's inputs, the parse's inputs (also on
     b"A" rows under the LZ4 token path's rules, several launches) and
     both passes' symbol planes;
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
     summed, torch.sort with its payload gathered); the device LZ4
     decode's chain resolution on the reference planes of the first tile
     of the LZ4 session's frame and on adversarial planes (too few
     rounds, forward and self references, indices past the row, a
     524,288-wide row on the wide kernel, chains at exactly the JAX
     rounds at n = 4, 32 and 2048), and the device CRC32 on the
     first tile, on zero and 0xFF rows, at n = 2048, 131072 and 65544,
     one row and a second launch, each beside the JAX route in torch and
     the host leg, and with its design and share of the bound, beside
     the design it was chosen over (CRC_TABLE_CU's slicing-by-8 tables,
     at every cluster size)
     (``decode_crc_kernels``); then the host cost of
     one call of every wrapper at its path's shape beside its library
     call (``host_cost_table``: a host clock over 1,000 calls, no sync
     within a batch of 100), and one sublane gather call at (512, 128)
     part by part beside the ctypes route the kernels took before,
     torch.gather and torch.cuda._sleep(0) (``sublane_breakdown``);
  4. the device time of the tokenizer layer on the full tiles, then the
     paths, each a 64 MiB request through QzSession(device="cuda:0") with
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
     (its pick and size). Then the paths around the session
     (``session_paths``), each on a dynamic session, launch counts zeroed
     before and read after each: a QzStream fed in 1 MiB pieces into
     2,092,032-byte units (equal to its units' compress outputs, stock
     zlib decodes it, crc_32 checked); 256 requests of 256 KiB through
     one compress_batch (exactly one CudaEngine.compress_chunks call,
     counted by wrapping it here; each request equal to its own compress,
     beside the same requests one at a time); the same requests through
     AQzSession on two aqz workers (every callback rc 0 with compress's
     bytes, fewer compress_chunks calls than requests); qz_compress_crc64
     (the native CRC64 of the input, the Python loop on the first 1 MiB,
     qz_decompress_crc64 back); and the CLIs as programs with no --device
     (qzip -k, -d, -A lz4 and back, -O 7z of a three-file tree and back,
     qzstd and back, aqzip and back; each a new process that reports its
     launch counts, each round trip the input again). Then the mesh phase
     (``mesh_paths``): the engine over several devices (every visible
     card; on a one-card machine the card twice, then three times) on the
     same 64 MiB request, on the main path, the static device pack, the
     token path and the LZ4 device pack, launch counts zeroed before and
     read after each, the bytes equal to the one-card engine's, decoded by
     stock zlib or the session, GB/s and peak device memory beside the
     one-card figures, and both in turns on the first mesh;
     ``dryrun_multichip(2)`` and ``entry()`` on the
     card; ``python -m qatzip_tpu_torch.tools.distrun --procs 2 --engine
     device --device cuda`` as a program (its ``ok`` line required); and a
     line saying how many distinct cards the mesh had and what went
     unverified for want of a second. Then the tools phase
     (``tools_paths``): ``qztest`` modes 1-23 on the card at ``-t 2 -l 3
     -b 65536 -v`` (19 and 21, which drop the engines and fork, as
     programs); ``qztest -m 4`` on a file of the 64 MiB request, deflate
     and ``-A lz4``, at one and four threads (launch counts zeroed
     before and read after each: every kernel of the route launched),
     and at 64 KiB requests, each ``[TOTAL]`` line with the card's name
     and power limit; ``run_perf_test -p 2 -t 2``; ``soak`` (40
     iterations), its first four deflate requests also on device="cpu"
     held on the card's route: the same bytes; ``decprof --mb 16`` and
     ``ratiocheck --mb 2`` on the card, and ``ratiocheck --mb 1`` on the
     card and on the CPU (the same JSON line). Before those: the
     LZ4 frame decoded on the host leg and on the device leg (each held),
     the token path and the main path with the device CRC held, and one
     compress under ``qz_trace`` (``decode_crc_paths``); and right after
     it the cnv phase (``cnv_paths``): compress-and-verify on the 64 MiB
     request through the session (its engine wrapped to pass ``cnv``) on
     the main path, the static and LZ4 device packs and the held token
     path: ``cnv=True`` gives the path's bytes with the same launch
     counts; a byte flipped after the kernel in four rows' device words
     (the token path: in its host packer's output) changes exactly those
     chunks with ``cnv=False`` and sends exactly those to the fallback
     with ``cnv=True``, and stock zlib or the LZ4 decoder gives back the
     input; warm GB/s without and with CnV in turns on the main path and
     the LZ4 device pack;
  5. the first 1 MiB through device="cpu" and device="cuda" on each
     path, both engines held on it: same bytes; and its LZ4 frame decoded
     on both with the device leg held;
  6. the kernel summary line (fifteen kernels), the card line, and
     {"ok": true, ...}.

It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
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
    ("token", "dynamic", 1, False,
     ("search_inputs", "candidate_search", "parse_inputs", "parse_scan",
      "crc32_rows")),
    ("static-device-pack", "static", 1, None,
     ("search_inputs", "candidate_search", "parse_inputs", "parse_scan",
      "pack_rows", "crc32_rows")),
    ("dynamic-device-pack", "dynamic", 1, None,
     ("search_inputs", "candidate_search", "parse_inputs", "parse_scan",
      "symbol_planes", "symbol_histogram", "huffman_lookup", "pack_rows",
      "crc32_rows")),
    ("lz4-token", "lz4", 1, False,
     ("search_inputs", "candidate_search", "parse_inputs", "parse_scan",
      "crc32_rows")),
    ("lz4-device-pack", "lz4", 1, True,
     ("parse_inputs", "parse_scan", "lz4_pack_rows", "crc32_rows")),
    ("lz4s-zstd", "lz4s-zstd", 1, None,
     ("search_inputs", "candidate_search", "parse_inputs", "parse_scan",
      "crc32_rows")),
    ("level6-dynamic-device-pack", "dynamic", 6, None,
     ("parse_inputs", "parse_scan", "symbol_planes", "symbol_histogram",
      "huffman_lookup", "pack_rows", "crc32_rows")),
]
# the path whose launches the kernel summary reports: the default
# (dynamic) session on the card, which runs six kernels (the device CRC
# is the card's own route); the LZ4 byte packer's launches come from the
# LZ4 device pack's path, the chain resolution's from the device decode
MAIN_PATH = "dynamic-device-pack"
# the probe kernels run on no codec path: their home is the devprims path,
# the probe tool's run
DEVPRIMS_KERNELS = ("lane_gather", "sublane_gather", "roll_sum", "bitonic128")
HOME_PATH = {"lz4_pack_rows": "lz4-device-pack",
             "lz4_resolve_refs": "lz4-device-decode",
             **{k: "devprims" for k in DEVPRIMS_KERNELS}}
# the row split's chunk size (four 64 KiB rows a chunk)
SPLIT_HW = 262144
# the paths that search whole 64 KiB rows (the full-row search)
FULL_ROW_PATHS = ("lz4-device-pack", "level6-dynamic-device-pack")
# the paths the mesh phase drives over several devices
MESH_PATHS = ("dynamic-device-pack", "static-device-pack", "token",
              "lz4-device-pack")


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


def device_ms(fn, reps: int, symbol: str = "") -> float:
    """Mean device time of one run of ``fn`` over ``reps`` runs: the CUDA
    activity the profiler records, without the gaps between launches
    (which ``event_ms`` counts, and which set the time of a kernel whose
    work is shorter than its launch); with ``symbol``, only the kernels
    whose name holds it (a kernel's own time where ``fn`` also copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        # the profiler has once come back without the kernel it ran
        # (a run of this script on the card, 1 of 9): profile again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and symbol in e.key)
        if us > 0 or not symbol:
            return us / reps / 1e3
    # and once three times over in one process: time the calls with CUDA
    # events instead, which also count the gaps between launches (the
    # caller has checked the kernel's result already)
    ms = event_ms(fn, reps)
    print(f"device time: the profiler saw no kernel named *{symbol}* in "
          f"three profiles; CUDA events instead: {ms:.4f} ms")
    return ms


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


# a part of each kernel's function name as the profiler and a trace name
# it (the __global__ functions of csrc/*.cu)
KERNEL_SYMBOLS = {"candidate_search": "candsearch_kernel",
                  "parse_scan": "parse_scan_kernel",
                  "symbol_histogram": "hist_kernel",
                  "huffman_lookup": "lookup_kernel",
                  "pack_rows": "pack_rows_kernel",
                  "lz4_resolve_refs": "resolve_kernel",
                  "crc32_rows": "crc_kernel",
                  "search_inputs": "search_inputs_kernel",
                  "parse_inputs": "parse_inputs_kernel",
                  "symbol_planes": "symbol_planes_kernel"}


def host_ms(fn, reps: int = 3) -> float:
    """Best host-clock time of ``fn`` in ms over ``reps`` runs."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def decode_crc_kernels(dev, data: bytes, n: int, record, adversarial,
                       res, crc_table) -> None:
    """The kernels of the device LZ4 decode and the device CRC32 against
    their plain versions on the card.

    ``lz4_resolve_refs``: the reference planes of the first tile of the
    LZ4 session's frame (its coded 64 KiB blocks, parsed by the host as
    the decode leg parses them) at the decode's 17 rounds, bytes and flag
    bit-identical to the plain version (the JAX route in torch: one
    ``torch.gather`` a round) and equal to the input; its own device time
    (profiler; each run first copies the plane, since the kernel jumps it
    in place) beside the plane's copy, the host parse, the plane's h2d
    and the host leg (the batched native decode of the same blocks).
    Then adversarial planes: b"A" * n rows (chains of depth n - 1), rows
    of literals only, B = 1 and 3, 3 rounds (too few: the shared-memory
    kernel runs the JAX rounds, so flag and bytes equal the plain
    version's), a forward and a self reference, an index past the row,
    one 300,001-byte block at n = 524288 (20 rounds; the wide kernel,
    ``resolve_kernel_wide``), and at n = 4, 32 and 2048 a chain of depth
    n - 1 and b"A" * n at exactly (n - 1).bit_length() rounds, the
    fewest with which the plain version resolves them.

    ``crc32_rows``: the first 16 MB tile against the plain version (the
    JAX formulation: bits @ V in float32), zlib.crc32 of each row, beside
    one ``torch.matmul`` of the bits plane (the library call) and the
    host crc32 of the same rows on the host pool; then zero and 0xFF rows,
    n = 2048 (one block a row), 131072 and 65544 (not a multiple of 16:
    the kernel's byte loads), one row, and a second launch on the same
    tile. Beside it the design it was chosen over, CRC_TABLE_CU's
    slicing-by-8 tables with every cluster size (``crc_table_probe``),
    checked against its crcs.

    Each kernel's line gives its share of the bound; ``--pair`` sets the
    lines of two trees' runs side by side."""
    import numpy as np
    import torch
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch import native
    from qatzip_tpu_torch.engines import host_pool
    from qatzip_tpu_torch.formats.lz4_format import (parse_lz4_frame_header,
                                                     walk_lz4_blocks)
    from qatzip_tpu_torch.ops import crc32_mxu as cm
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.parallel.dispatch import TILE_B
    lib = native.get_lib()

    # -- lz4_resolve_refs on the first tile of the LZ4 frame
    head = data[:TILE_B * n]
    sess = qz.QzSession(device="cuda")
    check(sess.setup_lz4() == qz.QZ_OK, "setup_lz4 failed")
    frame = sess.compress(head)
    info = parse_lz4_frame_header(frame, 0)
    blocks = walk_lz4_blocks(frame, 0, len(frame), info.header_sz)[0]
    coded = [i for i, (_o, _s, stored) in enumerate(blocks) if not stored]
    b = len(coded)
    rounds = (n - 1).bit_length() + 1
    refs = np.full((b, n), -1, np.int32)
    mv = memoryview(frame)
    payloads = [bytes(mv[blocks[i][0]:blocks[i][0] + blocks[i][1]])
                for i in coded]

    def parse_all():
        return list(host_pool().map(
            lambda k: lib.lz4_ref_block(payloads[k], refs[k], n), range(b)))
    check(parse_all() == [n] * b, "the host parse of the tile's blocks "
          "failed")
    parse_ms = host_ms(parse_all)
    pinned = torch.from_numpy(refs).pin_memory()
    plane = pinned.to(dev)
    h2d_ms = event_ms(lambda: pinned.to(dev, non_blocking=True), 5)
    work = torch.empty_like(plane)

    def kernel(src=plane, r=rounds, work=work):
        work.copy_(src)
        return ld.resolve_refs(work, r)
    got, flag = kernel()
    want, want_flag = ld.resolve_refs_ref(plane.clone(), rounds)
    err = max_err(got, want)
    check(not bool(flag) and not bool(want_flag), "lz4_resolve_refs: the "
          "tile's chains did not resolve")
    host_rows = got.cpu().numpy()
    check(all(host_rows[k].tobytes() == head[i * n:(i + 1) * n]
              for k, i in enumerate(coded)),
          "lz4_resolve_refs: the tile's bytes differ from the input")
    ms = device_ms(kernel, 20, KERNEL_SYMBOLS["lz4_resolve_refs"])
    copy_ms = event_ms(lambda: work.copy_(plane), 20)
    with_copy_ms = event_ms(kernel, 20)
    plain_ms = event_ms(lambda: ld.resolve_refs_ref(plane.clone(), rounds),
                        2)
    offs = [blocks[i][0] for i in coded]
    sizes = [blocks[i][1] for i in coded]
    decode_ms = host_ms(lambda: lib.lz4_batch_bytes(frame, offs, sizes,
                                                    [n] * b))
    record("lz4_resolve_refs", "lz4_resolve.cu",
           "qatzip_tpu/ops/lz4_decode.py:35", err, ms, plain_ms, None,
           # the plane read once, the bytes and flags written once; one
           # step a position
           b * n * 5 + b * 4, b * n, (b, n))
    res["lz4_resolve_refs"].update(
        ms_with_plane_copy=with_copy_ms, plane_copy_ms=copy_ms,
        jax_route_in_torch_ms=plain_ms, host_parse_ms=parse_ms,
        plane_h2d_ms=h2d_ms, host_decode_ms=decode_ms, rows=b,
        stored_rows=len(blocks) - b)
    print(f"kernel lz4_resolve_refs ({b}, {n}), {rounds} rounds: device time "
          f"(profiler) {ms:.4f} ms, with the plane's copy {with_copy_ms:.4f} "
          f"ms (copy {copy_ms:.4f}); the JAX route in torch (the plain "
          f"version, a torch.gather a round) {plain_ms:.4f} ms; host legs: "
          f"parse into the plane {parse_ms:.3f} ms on the host pool, the "
          f"plane's h2d {h2d_ms:.4f} ms, the batched native decode of the "
          f"same {b} blocks {decode_ms:.3f} ms")
    share = res["lz4_resolve_refs"]["bound_ms"] / ms
    res["lz4_resolve_refs"]["share_of_bound"] = share
    print(f"design lz4_resolve_refs: rows up to 65536 front to back in "
          f"chunks of 16384 (resolve_kernel_chunks: two 512-thread CTAs an "
          f"SM, 96 KiB of shared memory each, the plane read once, a "
          f"reference before its chunk final at once, the chunk's chains "
          f"jumped in place, the bytes written once; a row with a forward "
          f"or self reference by the in-place loop), too few rounds by the "
          f"JAX rounds in shared memory (resolve_kernel_smem), wider rows in "
          f"place in device memory (resolve_kernel_wide); tile: {ms:.4f} ms "
          f"of device time, {100 * share:.1f} % of the bound "
          f"{res['lz4_resolve_refs']['bound_ms']:.4f} ms")

    def resolve_case(label, src, r, resolves=True, every_byte=True):
        """The kernel against the plain version on ``src``: the same flag
        and bit-identical bytes at every position the plain version
        resolved (``every_byte``: at every position)."""
        left = torch.empty_like(src)
        got, flag = kernel(src, r, left)
        plain_plane = src.clone()
        want, want_flag = ld.resolve_refs_ref(plain_plane, r)
        check(bool(want_flag) != resolves, f"lz4_resolve_refs ({label}): "
              f"the plain version's flag is {bool(want_flag)}")
        check(bool(flag) == bool(want_flag), f"lz4_resolve_refs ({label}): "
              f"flag {bool(flag)}, the plain version's {bool(want_flag)}")
        if every_byte:
            err = max_err(got, want)
        else:
            done = plain_plane < 0
            err = max_err(got[done], want[done])
        ms = device_ms(lambda: kernel(src, r, left), 5,
                              KERNEL_SYMBOLS["lz4_resolve_refs"])
        plain_ms = event_ms(lambda: ld.resolve_refs_ref(src.clone(), r), 1)
        adversarial("lz4_resolve_refs", label, tuple(src.shape), err, ms,
                    plain_ms)
        res["lz4_resolve_refs"]["adversarial"][-1].update(
            rounds=r, unresolved=bool(flag), plain_unresolved=bool(want_flag))
        if not resolves:
            print(f"kernel lz4_resolve_refs {label}: the plain version "
                  f"unresolved, the kernel "
                  f"{'unresolved' if bool(flag) else 'resolved'}")

    a_row = np.full(n, -1, np.int32)
    check(lib.lz4_ref_block(lib.lz4_compress_block(b"A" * n), a_row, n) == n,
          "the host parse of b'A' * n failed")
    resolve_case("A * n (chains of depth n - 1)",
                 torch.from_numpy(np.ascontiguousarray(
                     np.broadcast_to(a_row, (TILE_B, n)))).to(dev), rounds)
    rng = np.random.default_rng(11)
    resolve_case("all literals", torch.from_numpy(
        -1 - rng.integers(0, 256, (TILE_B, n), dtype=np.int32)).to(dev),
        rounds)
    resolve_case("the tile's first row, B = 1", plane[:1].clone(), rounds)
    resolve_case("the tile's first rows, B = 3", plane[:3].clone(), rounds)
    resolve_case("3 rounds (too few)", plane, 3, resolves=False)
    odd = plane[:3].clone()
    odd[0, 100] = n - 5                  # forward, to a resolving entry
    odd[1, 777] = 777                    # a self reference: never resolves
    odd[2, 3], odd[2, 4] = 4, 3          # a two-cycle
    resolve_case("a forward and a self reference, a two-cycle", odd,
                 rounds, resolves=False, every_byte=False)
    past = plane[:3].clone()
    past[0, 50] = n + 1000               # clipped to n - 1
    past[2, 0] = 1 << 30
    resolve_case("indices past the row", past, rounds, every_byte=False)
    for small in (4, 32, 2048):
        # the JAX rounds exactly: a row within one chunk takes the JAX
        # rounds themselves there (the chunks would need one pass more)
        rows_s = np.full((2, small), -1, np.int32)
        rows_s[0] = np.arange(-1, small - 1)
        rows_s[0, 0] = -1 - ord("A")
        check(lib.lz4_ref_block(lib.lz4_compress_block(b"A" * small),
                                rows_s[1], small) == small,
              f"the host parse of b'A' * {small} failed")
        resolve_case(f"a chain of depth {small - 1} and b'A' * {small}, "
                     f"{(small - 1).bit_length()} rounds (the JAX rounds)",
                     torch.from_numpy(rows_s).to(dev),
                     (small - 1).bit_length())
    wide = 524288
    deep = np.full((1, wide), -1, np.int32)
    check(lib.lz4_ref_block(lib.lz4_compress_block(b"Z" * 300001), deep[0],
                            wide) == 300001, "the host parse of a "
          "300,001-byte block failed")
    resolve_case("one 300,001-byte block at n = 524288",
                 torch.from_numpy(deep).to(dev), (wide - 1).bit_length() + 1)
    del work, plane, pinned, got, want
    torch.cuda.empty_cache()

    # -- crc32_rows on the first 16 MB tile
    tile = torch.frombuffer(bytearray(head), dtype=torch.uint8)
    tile = tile.reshape(TILE_B, n).to(dev)
    got = cm.crc32_batch_device(tile, n=n)
    err = max_err(got, cm.crc32_batch_ref(tile, n=n))
    rows = [memoryview(head)[i * n:(i + 1) * n] for i in range(TILE_B)]
    check(got.tolist() == [zlib.crc32(r) for r in rows],
          "crc32_rows differs from zlib.crc32")
    ms = event_ms(lambda: cm.crc32_batch_device(tile, n=n), 50)
    dev_ms = device_ms(lambda: cm.crc32_batch_device(tile, n=n), 20,
                              KERNEL_SYMBOLS["crc32_rows"])
    plain_ms = event_ms(lambda: cm.crc32_batch_ref(tile, n=n), 3)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = ((tile[:, :, None] >> shifts) & 1).reshape(TILE_B, 8 * n).float()
    v = cm._v_on(n, dev)
    library_ms = event_ms(lambda: torch.matmul(bits, v), 5)
    del bits
    host_crc_ms = host_ms(lambda: list(host_pool().map(lib.crc32, rows)))
    serial_crc_ms = host_ms(lambda: [lib.crc32(r) for r in rows])
    record("crc32_rows", "crc32_rows.cu", "qatzip_tpu/ops/crc32_mxu.py:95",
           err, ms, plain_ms, library_ms,
           # the tile read once, the crcs written once; a table step and an
           # xor a byte at the least
           TILE_B * n + TILE_B * 4, TILE_B * n * 2, (TILE_B, n))
    res["crc32_rows"].update(device_ms=dev_ms, host_crc_ms=host_crc_ms,
                             host_crc_one_thread_ms=serial_crc_ms,
                             jax_route_in_torch_ms=library_ms)
    print(f"kernel crc32_rows ({TILE_B}, {n}): equal to zlib.crc32; device "
          f"time (profiler) {dev_ms:.4f} ms; the JAX route's matmul alone "
          f"(bits @ V, float32) {library_ms:.4f} ms; the host crc32 of the "
          f"same rows on the host pool {host_crc_ms:.3f} ms, on one thread "
          f"{serial_crc_ms:.3f} ms")
    share = res["crc32_rows"]["bound_ms"] / dev_ms
    res["crc32_rows"]["share_of_bound"] = share
    ctas = TILE_B // 16 * (n // cm.BLOCK)
    print(f"design crc32_rows: the JAX package's GF(2) product on the "
          f"binary tensor cores (mma m16n8k256 .b1 .and.popc), 16 rows x a "
          f"{cm.BLOCK}-byte block a CTA ({ctas} CTAs of 128 threads), "
          f"V's fragments from L1, one shift product a block, the "
          f"blocks xored into the row's crc by atomicXor after a memset; "
          f"chosen over the slicing-by-8 tables (below) as the faster on "
          f"the card; tile: {dev_ms:.4f} ms of device time, "
          f"{100 * share:.1f} % of the bound "
          f"{res['crc32_rows']['bound_ms']:.4f} ms")
    res["crc32_rows"]["table_design"] = crc_table_probe(
        crc_table, dev, tile, n, got, dev_ms)
    again = cm.crc32_batch_device(tile, n=n)
    check(torch.equal(again, cm.crc32_batch_device(tile, n=n)) and
          again.tolist() == got.tolist(), "crc32_rows: two launches back to "
          "back differ")
    flat = tile.reshape(-1)
    for label, rows_t, width in (
            ("zero rows", torch.zeros_like(tile), n),
            ("0xFF rows", torch.full_like(tile, 0xFF), n),
            ("n = 2048", tile.reshape(-1, 2048), 2048),
            ("n = 131072", tile.reshape(-1, 131072), 131072),
            ("n = 65544 (the byte path)",
             flat[:flat.numel() // 65544 * 65544].reshape(-1, 65544), 65544),
            ("one row", tile[:1], n)):
        got = cm.crc32_batch_device(rows_t, n=width)
        err = max_err(got, cm.crc32_batch_ref(rows_t, n=width))
        host = rows_t[:4].cpu().numpy()
        check(got[:4].tolist() == [zlib.crc32(r.tobytes()) for r in host],
              f"crc32_rows ({label}) differs from zlib.crc32")
        adversarial("crc32_rows", label, tuple(rows_t.shape), err,
                    event_ms(lambda: cm.crc32_batch_device(rows_t, n=width),
                             20),
                    event_ms(lambda: cm.crc32_batch_ref(rows_t, n=width), 2))
    del tile, rows_t, flat, again
    torch.cuda.empty_cache()


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

# The design crc32_rows was chosen over, measured beside it and not part
# of the library: slicing by 8. A row's 32 KiB blocks go to a thread block
# cluster of C CTAs (a (256, 65536) tile at C = 2 is 512 CTAs of 256
# threads); each thread takes L of one 128-byte segment with eight
# 256-entry tables that its CTA builds in shared memory while the first
# loads fly, and one product by its own x^(8 * 128 t) moves it to the
# block's end; a CTA's blocks fold by Horner, and the cluster's rank 0
# xors its CTAs' values through distributed shared memory, with crc(0^n),
# into the row's int64 crc. Its shift table comes from table_shifts.
CRC_TABLE_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;  // reflected CRC-32
constexpr int kThreads = 256;
constexpr int kSeg = 128;                   // bytes a thread
constexpr int kBlock = kThreads * kSeg;     // 32 KiB a block
constexpr int kLoads = kSeg / 16 / 2;       // 16-byte loads a half segment
constexpr int kMaxCluster = 8;              // CTAs a row at most
// the shift table: kThreads thread shifts, the Horner stride, kMaxCluster
// tail shifts (table_shifts)
constexpr int kStride = kThreads;
constexpr int kTail = kThreads + 1;

// a * b mod P in zlib's reflected representation (bit 31 is x^0)
__device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

__device__ __forceinline__ uint32_t step8(const uint32_t (*t)[256],
                                          uint32_t crc, uint32_t lo,
                                          uint32_t hi) {
  lo ^= crc;
  return t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
         t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
         t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
}

__device__ void build_tables(uint32_t (*tab)[256], int tid) {
  uint32_t c = tid;
#pragma unroll
  for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
  tab[0][tid] = c;
  __syncthreads();
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    c = (c >> 8) ^ tab[0][c & 0xFF];
    tab[k][tid] = c;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 4)
crc_table_kernel(const uint8_t* __restrict__ data, long long* __restrict__ out,
           const uint32_t* __restrict__ shifts, int n, uint32_t zero_crc,
           int vec) {
  __shared__ uint32_t tab[8][256];
  __shared__ uint32_t warp_v[kThreads / 32];
  __shared__ uint32_t part;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const uint8_t* row = data + (size_t)(blockIdx.x / csize) * n;
  const int nb = (n + kBlock - 1) / kBlock;
  const long long pad = (long long)nb * kBlock - n;
  const uint32_t my_shift = shifts[tid];
  bool built = false;
  uint32_t acc = 0;
  int last = -1;
  for (int b = rank; b < nb; b += csize) {
    // this thread's segment, counted from the block's end (thread 0 the
    // last); its first byte's row index (below 0: the front padding)
    const long long start =
        (long long)(b + 1) * kBlock - (long long)(tid + 1) * kSeg - pad;
    uint32_t crc = 0;
    if (vec) {
      // n % 16 == 0 and a 16-byte aligned tile: every load is whole,
      // and wholly padding or wholly row
      uint4 w[2][kLoads];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const long long p = start + (h * kLoads + u) * 16;
          w[h][u] = p >= 0 ? __ldg(reinterpret_cast<const uint4*>(row + p))
                           : make_uint4(0, 0, 0, 0);
        }
      if (!built) {           // while the loads are in flight
        build_tables(tab, tid);
        built = true;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          crc = step8(tab, crc, w[h][u].x, w[h][u].y);
          crc = step8(tab, crc, w[h][u].z, w[h][u].w);
        }
    } else {
      if (!built) {
        build_tables(tab, tid);
        built = true;
      }
      if (start + kSeg > 0) {
        for (int o = 0; o < kSeg; o += 8) {
          uint32_t lo = 0, hi = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const long long p = start + o + u;
            if (p >= 0) lo |= (uint32_t)row[p] << (8 * u);
            if (p + 4 >= 0) hi |= (uint32_t)row[p + 4] << (8 * u);
          }
          crc = step8(tab, crc, lo, hi);
        }
      }
    }
    // this segment's L moved to the block's end, xored over the block
    const uint32_t v = __reduce_xor_sync(
        0xffffffffu, crc ? multmodp(crc, my_shift) : 0u);
    if (lane == 0) warp_v[tid >> 5] = v;
    __syncthreads();
    if (tid == 0) {
      uint32_t l = 0;
#pragma unroll
      for (int w8 = 0; w8 < kThreads / 32; ++w8) l ^= warp_v[w8];
      acc = multmodp(acc, shifts[kStride]) ^ l;
    }
    last = b;
    __syncthreads();   // warp_v is written again for the next block
  }
  if (tid == 0)
    part = last >= 0 ? multmodp(acc, shifts[kTail + nb - 1 - last]) : 0u;
  cluster.sync();
  if (rank == 0 && tid == 0) {
    uint32_t total = zero_crc;
    for (int r = 0; r < csize; ++r) total ^= *cluster.map_shared_rank(&part, r);
    out[blockIdx.x / csize] = (long long)total;
  }
  cluster.sync();      // the other CTAs' part stays until rank 0 read it
}

}  // namespace

extern "C" int qz_crc32_rows_table(const void* data, void* out,
                                   const void* shifts, int rows, int n,
                                   int zero_crc, int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)data % 16 == 0) && (n % 16 == 0);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, crc_table_kernel, (const uint8_t*)data,
                                 (long long*)out, (const uint32_t*)shifts, n,
                                 (uint32_t)zero_crc, vec);
}
"""
#: CRC_TABLE_CU's geometry: threads a CTA, bytes a thread, CTAs a row
TABLE_THREADS, TABLE_SEG, TABLE_MAX_CLUSTER = 256, 128, 8


def table_shifts(cluster: int):
    """CRC_TABLE_CU's shift table for a cluster of ``cluster`` CTAs,
    uint32: TABLE_THREADS thread shifts x^(8 SEG t), the Horner stride
    x^(8 BLOCK cluster) of a CTA's blocks, and TABLE_MAX_CLUSTER tail
    shifts x^(8 BLOCK m), BLOCK = TABLE_THREADS * TABLE_SEG."""
    import numpy as np
    from qatzip_tpu_torch.ops import crc32_mxu as cm
    block = TABLE_THREADS * TABLE_SEG
    seg, blk = cm.x_pow(8 * TABLE_SEG), cm.x_pow(8 * block)
    out = np.zeros(TABLE_THREADS + 1 + TABLE_MAX_CLUSTER, np.uint32)
    cur = 1 << 31
    for t in range(TABLE_THREADS):
        out[t] = cur
        cur = cm.multmodp(cur, seg)
    out[TABLE_THREADS] = cm.x_pow(8 * block * cluster)
    cur = 1 << 31
    for m in range(TABLE_MAX_CLUSTER):
        out[TABLE_THREADS + 1 + m] = cur
        cur = cm.multmodp(cur, blk)
    return out


def crc_table_probe(lib, dev, tile, n: int, want, route_dev_ms: float):
    """CRC_TABLE_CU on ``tile`` (B, n) at every cluster size: equal to
    ``want`` (the library kernel's crcs, themselves zlib's), each one's
    device time (the profiler, the kernel alone) beside the library
    kernel's ``route_dev_ms``. Returns {cluster: ms}."""
    import ctypes
    import numpy as np
    import torch
    from qatzip_tpu_torch.ops import crc32_mxu as cm
    rows = tile.shape[0]
    z = cm._zero_crc(n)
    out = torch.empty(rows, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    found = {}
    for c in range(1, TABLE_MAX_CLUSTER + 1):
        sh = torch.from_numpy(table_shifts(c).view(np.int32).copy()).to(dev)

        def run(sh=sh, c=c):
            rc = lib.qz_crc32_rows_table(
                tile.data_ptr(), out.data_ptr(), sh.data_ptr(), rows, n,
                z - (1 << 32) if z >= 1 << 31 else z, c, stream)
            check(rc == 0, f"the table design, cluster {c}: cudaError {rc}")
            return out
        check(torch.equal(run(), want), f"the table design with a cluster "
              f"of {c} differs from zlib.crc32")
        found[c] = device_ms(run, 20, "crc_table_kernel")
    print("design crc32_rows, the slicing-by-8 tables it was chosen over "
          f"(CRC_TABLE_CU, equal to zlib.crc32), ({rows}, {n}), device time "
          "(profiler) by CTAs a row: " + ", ".join(
              f"{c}: {ms:.4f} ms" for c, ms in found.items()) +
          f"; the library kernel {route_dev_ms:.4f} ms")
    return found


def build_measure(kernels_so: str):
    """(the measurement extension, LOOP_CU's two launch loops, seconds the
    extension's compile took, CRC_TABLE_CU's library): MEASURE_SRC
    compiled by the binding's own host compiler command and linked
    against ``kernels_so``; LOOP_CU and CRC_TABLE_CU built by nvcc with
    ``-cudart shared`` beside the link."""
    import ctypes
    import importlib.machinery
    from qatzip_tpu_torch.ops import _build
    src = os.path.join(_build.BUILD_DIR, "qz_measure.c")
    cu = os.path.join(_build.BUILD_DIR, "qz_loop_shared.cu")
    table_cu = os.path.join(_build.BUILD_DIR, "qz_crc_table.cu")
    for path, text in ((src, MEASURE_SRC), (cu, LOOP_CU),
                       (table_cu, CRC_TABLE_CU)):
        with open(path, "w") as f:
            f.write(text)
    obj, so, loop_so = src[:-2] + ".o", src[:-2] + ".so", cu[:-3] + ".so"
    table_so = table_cu[:-3] + ".so"
    t0 = time.perf_counter()
    _build._run_all([_build.binding_command(src, obj)])
    secs = time.perf_counter() - t0
    nvcc = [_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-cudart",
            "shared", "-I", _build.CSRC_DIR]
    _build._run_all([
        ["cc", "-shared", "-o", so, obj, kernels_so],
        nvcc + ["-o", loop_so, cu], nvcc + ["-o", table_so, table_cu]])
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
    table = ctypes.CDLL(table_so)
    table.qz_crc32_rows_table.restype = ci
    table.qz_crc32_rows_table.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    return mod, loops, secs, table


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
    if importlib.util.find_spec("qatzip_tpu_torch.ops.lz4_decode"):
        # the device decode and CRC (a tree before them has neither)
        from qatzip_tpu_torch.ops import crc32_mxu as cm
        from qatzip_tpu_torch.ops import lz4_decode as ld
        lits = z(b, n) - 1                  # literals: one pass a call
        bits = z(b, 8 * n, dtype=torch.float32)
        v = z(8 * n, 32, dtype=torch.float32)
        cases["lz4_resolve_refs"] = (lambda: ld.resolve_refs(lits, 17), None,
                                     (b, n))
        cases["crc32_rows"] = (lambda: cm.crc32_batch_device(u8, n=n),
                               lambda: torch.matmul(bits, v), (b, n))
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


# the session-level paths (stream, batch, async, crc64) and the CLI run
# on one 64 MiB buffer: 1 MiB stream pieces into the largest staging
# buffer, 256 requests of 256 KiB for the batch and async paths
STREAM_PIECE = 1 << 20
BATCH_REQ = 256 * 1024
BATCH_N = 256
# runs a CLI module as ``python -m`` does, then prints its launch counts
# (a fresh process: they start at 0) as the last line of its stderr
CLI_LAUNCHER = (
    "import json, runpy, sys\n"
    "from qatzip_tpu_torch.ops import cuda_pack\n"
    "mod = sys.argv[1]\n"
    "sys.argv = [mod] + sys.argv[2:]\n"
    "try:\n"
    "    runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
    "    rc = 0\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "print('launches ' + json.dumps(cuda_pack.LAUNCHES), file=sys.stderr)\n"
    "sys.exit(rc)\n")


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
    measure, shared_loops, measure_s, crc_table = build_measure(kernels_so)
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

    key, ctx, pbits, ov = lz77._search_inputs(
        tile, lengths, n=n, min_match=4, window=32768, ctx_words=ctx_words,
        search_seg=ss, search_overlap=ov)
    check(tuple(key.shape) == (2304, 8192) and ctx.shape[0] == 3,
          f"unexpected k2 shapes {tuple(key.shape)} {tuple(ctx.shape)}")
    # the candidate search's inputs: the rows' bytes read once, a key and
    # ctx_words context words written a slot; a few operations a word
    si_kw = dict(min_match=4, ctx_words=ctx_words, width=ss, overlap=ov)
    got = lz77.search_inputs(tile, lengths, **si_kw)
    record("search_inputs", "search_inputs.cu",
           "qatzip_tpu/ops/lz77.py:176-262 (XLA ops of _analyze)",
           max_err(got, lz77.search_inputs_ref(tile, lengths, **si_kw)),
           event_ms(lambda: lz77.search_inputs(tile, lengths, **si_kw), 10),
           event_ms(lambda: lz77.search_inputs_ref(tile, lengths, **si_kw),
                    2), None,
           tile.numel() + key.numel() * 4 * (1 + ctx_words),
           key.numel() * (8 * ctx_words + 4),
           f"{tuple(tile.shape)} -> {tuple(key.shape)} x {1 + ctx_words}")
    del got
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

    # the parse's inputs from the kernel's windows: the window words read
    # once (their overlap included), is_match, ml and dist written once;
    # each extension round and the tail a few operations a position
    pi_kw = dict(n=n, overlap=ov, min_match=4, max_match=258,
                 ctx_bytes=4 * ctx_words, parse_seg=8192)
    pi_launches = lz77.parse_inputs_launches(n=n, max_match=258,
                                             ctx_bytes=4 * ctx_words)
    pi = lz77.parse_inputs(lengths, kv=got, **pi_kw)
    record("parse_inputs", "parse_inputs.cu",
           "qatzip_tpu/ops/lz77.py:383-400, 542-590 (XLA ops of "
           "_extend_matches, _analyze_tail)",
           max_err(pi, lz77.parse_inputs_ref(lengths, kv=got, **pi_kw)),
           event_ms(lambda: lz77.parse_inputs(lengths, kv=got, **pi_kw), 10),
           event_ms(lambda: lz77.parse_inputs_ref(lengths, kv=got, **pi_kw),
                    2), None, got.numel() * 4 + tile.numel() * 9,
           tile.numel() * (6 * pi_launches[0][1] + 20),
           f"{tuple(got.shape)} -> {tuple(tile.shape)}, {len(pi_launches)} "
           "launch")
    is_match, ml_c, _dist = pi
    seg = 8192
    # adversarial: b"A" rows on the token path's LZ4 rules (max_match
    # 32767): the caps reach across the row, so the first seven rounds run
    # in one launch and each wider round in one more
    a_tile = torch.full_like(tile, 65)
    a_key, a_ctx, _pb, _ov = lz77._search_inputs(
        a_tile, lengths, n=n, min_match=4, window=32768, ctx_words=4,
        search_seg=ss, search_overlap=ov)
    a_kv = cuda_pack.candidate_search(a_key, a_ctx, probes=probes,
                                      min_match=4, pbits=pbits)
    a_kw = dict(n=n, overlap=ov, min_match=4, max_match=32767, ctx_bytes=16,
                parse_seg=8192, lz4_rules=True)
    a_launches = len(lz77.parse_inputs_launches(n=n, max_match=32767,
                                                ctx_bytes=16))
    adversarial("parse_inputs", f"A rows, LZ4 token rules ({a_launches} "
                "launches)", (TILE_B, n),
                max_err(lz77.parse_inputs(lengths, kv=a_kv, **a_kw),
                        lz77.parse_inputs_ref(lengths, kv=a_kv, **a_kw)),
                event_ms(lambda: lz77.parse_inputs(lengths, kv=a_kv, **a_kw),
                         10),
                event_ms(lambda: lz77.parse_inputs_ref(lengths, kv=a_kv,
                                                       **a_kw), 2))
    del a_tile, a_key, a_ctx, a_kv
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
    del key, ctx, got, pi, is_match, ml_c, nm_im, nm_ml

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

    # the dynamic pack's symbol planes, both passes: data, ml, dist,
    # taken and lit read once, two int32 planes written; the two symbols'
    # arithmetic ~24 operations a position
    sp_bytes = tile.numel() * (1 + 4 + 4 + 1 + 1 + 8)
    for mode in (1, 2):
        sp = dp.symbol_planes(tile, ml, dist, taken, lit, mode=mode)
        sp_err = max_err(sp, dp.symbol_planes_ref(tile, ml, dist, taken, lit,
                                                  mode=mode))
        sp_ms = event_ms(lambda: dp.symbol_planes(tile, ml, dist, taken,
                                                  lit, mode=mode), 20)
        sp_plain = event_ms(lambda: dp.symbol_planes_ref(
            tile, ml, dist, taken, lit, mode=mode), 3)
        if mode == 1:
            record("symbol_planes", "symbol_planes.cu",
                   "qatzip_tpu/ops/deflate_pack.py:362-382 (XLA ops of "
                   "_len_symbol, _dist_symbol)", sp_err, sp_ms, sp_plain,
                   None, sp_bytes, tile.numel() * 24,
                   f"pass 1 {tuple(tile.shape)}")
        else:
            adversarial("symbol_planes", "pass 2's form", (TILE_B, n),
                        sp_err, sp_ms, sp_plain)
    del sp
    sym, dsym_m = dp.symbol_planes(tile, ml, dist, taken, lit, mode=1)
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
    lsym, ldsym = dp.symbol_planes(tile, ml, dist, taken, lit, mode=2)
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
            *dp.symbol_planes(tile, ml4, d4, tk, torch.zeros_like(tk),
                              mode=2))
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
    del tile
    decode_crc_kernels(dev, data, n, record, adversarial, res, crc_table)

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
    peak_by_path = {}
    warm_by_path = {}
    ratio_by_path = {}
    outs_by_path = {}

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
        # one card, whatever the machine has (the mesh phase deals over
        # several and is held to these bytes)
        sess = session(kind, level, "cuda:0")
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
        outs_by_path[name] = out
        peak = torch.cuda.max_memory_allocated()
        peak_by_path[name] = peak
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
    # the one-card outputs the mesh phase is held to
    mesh_want = {name: outs_by_path[name] for name in MESH_PATHS}
    decode_crc_paths(qz, cuda_pack, dispatch, data, outs_by_path,
                     warm_by_path, launches_by_path, set_route)
    cnv_paths(qz, cuda_pack, dispatch, data, outs_by_path, card, session,
              set_route)
    del outs_by_path

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

    session_paths(qz, cuda_pack, dispatch, data, launches_by_path,
                  {"deflate": PATHS[2][4], "lz4": PATHS[4][4],
                   "lz4s": PATHS[5][4]})
    mesh_paths(qz, cuda_pack, data, len(chunks), mesh_want, warm_by_path,
               peak_by_path, launches_by_path, session, decodes, set_route)
    del mesh_want
    tools_paths(cuda_pack, data, card, set_route)

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
    # the first 1 MiB's LZ4 frame decoded with the device leg held on both
    frame = session("lz4", 1, "cuda").compress(head)
    own_decode = dispatch.CudaEngine.decodes_on_device
    dispatch.CudaEngine.decodes_on_device = lambda self: True
    try:
        cuda_pack.reset_launch_counts()
        outs = [session("lz4", 1, device).decompress(frame)
                for device in ("cpu", "cuda")]
    finally:
        dispatch.CudaEngine.decodes_on_device = own_decode
    check(outs[0] == outs[1] == head and cuda_pack.LAUNCHES[
        "lz4_resolve_refs"] > 0, "lz4 device decode: device='cpu' and "
          "device='cuda' give other bytes for the first 1 MiB")
    print(f"cpu-vs-cuda lz4-device-decode: the first 1 MiB's frame "
          f"({len(frame)} bytes) decodes to the same bytes on both")

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


# the cnv phase's paths: (path of PATHS, where its fault goes in: the
# dispatch function whose device words are flipped after its kernel, or
# the host packer's output on the token path)
CNV_PATHS = (("dynamic-device-pack", "deflate_pack_dynamic"),
             ("static-device-pack", "deflate_pack_device"),
             ("lz4-device-pack", "lz4_pack_device"),
             ("token", "deflate_pack"))
# the rows the fault picks, by their first 64 bytes: text, JSON, JSON and
# text, one in each tile (a binary-struct row takes the static pack's
# stored-block guard, which the fault would not reach)
CNV_ROWS = (5, 276, 600, 969)
CNV_TURNS = 4


class Verified:
    """An engine whose ``compress_chunks`` takes ``cnv`` from the
    instance, and keeps its last results; everything else is the
    engine's. A session whose ``_engine`` it is drives CnV through
    ``QzSession.compress``."""

    def __init__(self, engine, cnv: bool):
        self.engine, self.cnv, self.last = engine, cnv, None

    def compress_chunks(self, chunks, **kw):
        self.last = self.engine.compress_chunks(chunks, cnv=self.cnv, **kw)
        return self.last

    def __getattr__(self, name):
        return getattr(self.engine, name)


def flip_rows(dd, words, used, prefixes, per_word: int, ok=None):
    """``words`` with one byte flipped in the middle of the used words of
    every row of the staged tile ``dd`` whose first 64 bytes are in
    ``prefixes`` (and whose ``ok`` flag is set): ``used`` counts bits
    (``per_word`` 64: half of them over 32) or bytes (8)."""
    heads = dd[:, :64].cpu().numpy()
    used = used.cpu().numpy()
    oks = None if ok is None else ok.cpu().numpy()
    words = words.clone()
    for i, head in enumerate(heads):
        if head.tobytes() in prefixes and (oks is None or oks[i]):
            words[i, int(used[i]) // per_word] ^= 0x00FF0000
    return words


def cnv_paths(qz, cuda_pack, dispatch, data: bytes, outs_by_path, card: str,
              session, set_route, kernels_of=None, rows=CNV_ROWS,
              turns=CNV_TURNS) -> None:
    """The cnv phase: compress-and-verify on the 64 MiB request through
    ``QzSession.compress`` with the session's engine wrapped (``Verified``),
    on the main path, the static device pack, the LZ4 device pack and the
    held token path. Each path: ``cnv=False`` gives the path's bytes
    (``outs_by_path``); ``cnv=True`` gives them too, with every kernel of
    the path launched as often (counts set to 0 just before each run, read
    just after) and no fallback; then a fault in ``rows`` (a byte flipped
    in their device words after the kernel, or in the token path's host
    packer output): with ``cnv=False`` exactly those chunks' payloads
    change, with ``cnv=True`` exactly those take the fallback (stock zlib
    through the host engine; the native LZ4 block coder on the LZ4 device
    pack), the counter ``cnv_fallback`` counts them, and stock zlib (the
    session's LZ4 decode) gives back the input. Then warm GB/s without and
    with CnV in turns (off, on, on, off, ...; ``turns`` each) on the main
    path and the LZ4 device pack, and there the verify alone over the
    clean payloads, on one thread and on the host pool. ``kernels_of`` maps a path to the
    kernels it must launch (PATHS' by default). Any failure raises."""
    import statistics
    import torch
    from qatzip_tpu_torch import native
    from qatzip_tpu_torch.engines import host_engine, host_pool
    from qatzip_tpu_torch.utils.debug import get_counters

    kinds = {p[0]: p for p in PATHS}
    kernels_of = kernels_of or {p[0]: p[4] for p in PATHS}
    lib = native.get_lib()
    n = 65536
    chunks = [data[o:o + n] for o in range(0, len(data), n)]
    prefixes = {chunks[r][:64] for r in rows}
    check(len(prefixes) == len(rows) and all(
        sum(c[:64] == chunks[r][:64] for c in chunks) == 1 for r in rows),
        "cnv: the fault's rows do not have first 64 bytes of their own")

    def fallbacks() -> int:
        return sum(c.get("cnv_fallback", 0)
                   for c in get_counters().snapshot().values())

    def real(name):
        return getattr(lib if name == "deflate_pack" else dispatch, name)

    def faulty(name):
        """The function ``name`` with the fault after it."""
        fn = real(name)
        if name == "deflate_pack":
            def pack(src, *a, **kw):
                out = fn(src, *a, **kw)
                if bytes(src[:64]) in prefixes:
                    out = bytearray(out)
                    out[len(out) // 2] ^= 0xFF
                    out = bytes(out)
                return out
            return pack
        if name == "lz4_pack_device":
            def lz4(dd, ll, *, n):
                words, nbytes, ok = fn(dd, ll, n=n)
                return flip_rows(dd, words, nbytes, prefixes, 8, ok), \
                    nbytes, ok
            return lz4

        def deflate(dd, *a, **kw):
            words, nbits = fn(dd, *a, **kw)
            return flip_rows(dd, words, nbits, prefixes, 64), nbits
        return deflate

    def payloads(wrapped):
        return [p for p, _c in wrapped.last]

    t_phase = time.perf_counter()
    for name, where in CNV_PATHS:
        _n, kind, level, route, _k = kinds[name]
        kernels = kernels_of[name]
        set_route(route)
        sess = session(kind, level, "cuda:0")
        off = Verified(sess._engine, False)
        on = Verified(sess._engine, True)
        runs = {}
        for label, eng in (("off", off), ("on", on)):
            sess._engine = eng
            before = fallbacks()
            cuda_pack.reset_launch_counts()
            t0 = time.perf_counter()
            out = sess.compress(data)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            runs[label] = (out, dict(cuda_pack.LAUNCHES), secs)
            check(fallbacks() == before, f"cnv {name} cnv={label}: a "
                  "fallback without a fault")
            check(all(runs[label][1][k] > 0 for k in kernels),
                  f"cnv {name} cnv={label}: a kernel of the path never "
                  f"launched: {runs[label][1]}")
        check(runs["off"][0] == outs_by_path[name], f"cnv {name}: cnv=False "
              "gives other bytes than the path")
        check(runs["on"][0] == runs["off"][0], f"cnv {name}: cnv=True gives "
              "other bytes than cnv=False")
        check(runs["on"][1] == runs["off"][1], f"cnv {name}: other launch "
              f"counts under CnV: {runs['on'][1]} vs {runs['off'][1]}")
        clean = payloads(on)

        # the fault
        holder = lib if where == "deflate_pack" else dispatch
        own = getattr(holder, where)
        setattr(holder, where, faulty(where))
        try:
            sess._engine = off
            bad_out = sess.compress(data)
            bad = payloads(off)
            sess._engine = on
            before = fallbacks()
            t0 = time.perf_counter()
            got_out = sess.compress(data)
            torch.cuda.synchronize()
            fault_s = time.perf_counter() - t0
            got = payloads(on)
            counted = fallbacks() - before
        finally:
            setattr(holder, where, own)
        hit = sorted(i for i, (b, c) in enumerate(zip(bad, clean)) if b != c)
        check(hit == sorted(rows) and bad_out != runs["off"][0],
              f"cnv {name}: the fault changed chunks {hit}, not {rows}")
        took = sorted(i for i, (g, c) in enumerate(zip(got, clean))
                      if g != c)
        check(took == sorted(rows) and counted == len(rows),
              f"cnv {name}: chunks {took} took the fallback ({counted} "
              f"counted), not {rows}")
        for i in rows:
            if kind == "lz4":
                want = lib.lz4_compress_block(chunks[i])
            else:
                (want, _c), = host_engine.compress_chunks(
                    [chunks[i]], level=level, final_flags=[True],
                    sw_coder="zlib")
            check(got[i] == want, f"cnv {name}: chunk {i} is not the "
                  "fallback's block")
        if kind == "lz4":
            sess._engine = off
            check(sess.decompress(got_out) == data, f"cnv {name}: the LZ4 "
                  "decoder does not give back the input")
            decoded = "the session's LZ4 decode gives back the input"
        else:
            plain, members = gunzip_members(got_out)
            check(plain == data and members == len(chunks),
                  f"cnv {name}: stock zlib does not give back the input")
            decoded = (f"stock zlib decodes all {members} members to the "
                       "input")
        fb = "native LZ4 block coder" if kind == "lz4" else \
            "host engine, stock zlib"
        print(f"cnv {name}: cnv=True gives the cnv=False bytes "
              f"({len(runs['on'][0])}; {runs['off'][2]:.3f} s off, "
              f"{runs['on'][2]:.3f} s on, cold); launches under CnV the same "
              f"{ {k: v for k, v in runs['on'][1].items() if v} }; fault "
              f"({where}: a byte flipped after it) in rows {list(rows)}: "
              f"cnv=False changes exactly those chunks, cnv=True sends "
              f"exactly those to the fallback ({fb}; {counted} counted; "
              f"{fault_s:.3f} s), {decoded}")

        if name in ("dynamic-device-pack", "lz4-device-pack"):
            times = {False: [], True: []}
            for cnv in [False, True, True, False] * (turns // 2):
                sess._engine = on if cnv else off
                t0 = time.perf_counter()
                sess.compress(data)
                torch.cuda.synchronize()
                times[cnv].append(len(data) / (time.perf_counter() - t0)
                                  / 1e9)
            med = {k: statistics.median(v) for k, v in times.items()}
            print(f"cnv turns {name}: warm GB/s without CnV "
                  f"{[round(x, 4) for x in times[False]]} median "
                  f"{med[False]:.4f}, with CnV "
                  f"{[round(x, 4) for x in times[True]]} median "
                  f"{med[True]:.4f} = {med[True] / med[False]:.3f}x | {card}")
            # the verify alone on the clean payloads, one thread and the
            # host pool, beside the request's extra seconds under CnV
            if kind == "lz4":
                def verify(a):
                    return dispatch.verify_lz4_device(*a)
            else:
                def verify(a):
                    return dispatch.verify_or_fallback(
                        a[0], a[1], "deflate", True, level, 3)
            items = list(zip(chunks, clean))
            t0 = time.perf_counter()
            for a in items:
                verify(a)
            serial_s = time.perf_counter() - t0
            pool = host_pool()
            t0 = time.perf_counter()
            list(pool.map(verify, items))
            pool_s = time.perf_counter() - t0
            extra = len(data) / 1e9 * (1 / med[True] - 1 / med[False])
            print(f"cnv verify alone {name}: {len(items)} payloads "
                  f"({sum(map(len, clean))} bytes) on one thread "
                  f"{serial_s:.3f} s, on the host pool "
                  f"({pool._max_workers} threads) {pool_s:.3f} s; the "
                  f"request's median extra with CnV {extra:.3f} s | {card}")
        sess._engine = off.engine
    set_route(None)
    print(f"cnv: phase {time.perf_counter() - t_phase:.2f} s wall | {card}")


def decode_crc_paths(qz, cuda_pack, dispatch, data: bytes, outs_by_path,
                     warm_by_path, launches_by_path, set_route) -> None:
    """The device LZ4 decode, the device CRC32 and a trace on the card,
    launch counts zeroed before and read after each path:

      * ``lz4-host-decode`` and ``lz4-device-decode``: the LZ4 session's
        64 MiB frame (the ``lz4-device-pack`` path's output) decoded by a
        session held on each leg, cold and warm, equal to the input; the
        device leg's profile and its host parse apart; the engine's pick;
      * ``token-device-crc``: the token path held, with the device CRC
        held: the bytes of the held token path (so every member's crc32,
        which stock zlib checks, and the session's crc are zlib's);
        beside it the main path with the device CRC held, equal to the
        main path's bytes; the engine's pick;
      * one compress of the main path under ``qz_trace`` (and ``stage``)
        into a temporary directory: the trace file names at least one of
        the path's kernels."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from qatzip_tpu_torch import native
    from qatzip_tpu_torch.engines import host_pool
    from qatzip_tpu_torch.formats.lz4_format import (parse_lz4_frame_header,
                                                     walk_lz4_blocks)
    from qatzip_tpu_torch.utils.debug import get_counters
    from qatzip_tpu_torch.utils.trace import qz_trace, stage
    eng_cls = dispatch.CudaEngine
    own_decode, own_crc = eng_cls.decodes_on_device, eng_cls.crc_on_device
    dev = torch.device("cuda", 0)

    # -- the LZ4 decode legs
    frame = outs_by_path["lz4-device-pack"]
    info = parse_lz4_frame_header(frame, 0)
    blocks = walk_lz4_blocks(frame, 0, len(frame), info.header_sz)[0]
    stored = sum(st for _o, _s, st in blocks)
    sess = qz.QzSession(device="cuda")
    check(sess.setup_lz4() == qz.QZ_OK, "setup_lz4 failed")
    warm = {}
    try:
        for name, held in (("lz4-host-decode", False),
                           ("lz4-device-decode", True)):
            eng_cls.decodes_on_device = lambda self, held=held: held
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            cuda_pack.reset_launch_counts()
            t0 = time.perf_counter()
            out = sess.decompress(frame)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            launches = dict(cuda_pack.LAUNCHES)
            launches_by_path[name] = launches
            check(out == data, f"{name}: the decode differs from the input")
            check((launches["lz4_resolve_refs"] > 0) == held,
                  f"{name}: lz4_resolve_refs launches {launches}")
            t0 = time.perf_counter()
            out = sess.decompress(frame)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            check(out == data, f"{name}: a second decode differs")
            peak = torch.cuda.max_memory_allocated()
            warm[name] = len(data) / warm_s / 1e9
            print(f"path {name}: {len(frame)} bytes ({len(blocks)} blocks, "
                  f"{stored} stored) -> {len(data)}, equal to the input; "
                  f"decompress cold {cold_s:.3f} s, warm {warm_s:.3f} s = "
                  f"{warm[name]:.4f} GB/s; peak device memory {peak} bytes "
                  f"({peak - base} above what the script held); launches "
                  f"{launches}")
            if held:
                lib = native.get_lib()
                mv = memoryview(frame)
                payloads = [bytes(mv[o:o + sz]) for o, sz, st in blocks
                            if not st]
                refs = np.empty((len(payloads), 65536), np.int32)
                parse_ms = host_ms(lambda: list(host_pool().map(
                    lambda k: lib.lz4_ref_block(payloads[k], refs[k], 65536),
                    range(len(payloads)))))
                del refs
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    sess.decompress(frame)
                    torch.cuda.synchronize()
                    prof_s = time.perf_counter() - t0
                evs = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
                dev_us = sum(e.self_device_time_total for e in evs)
                print(f"breakdown {name}: the host parse of the "
                      f"{len(payloads)} coded blocks into reference planes "
                      f"{parse_ms:.3f} ms on the host pool ({len(payloads) * 4 * 65536} "
                      f"bytes of plane); one decode under the profiler "
                      f"{prof_s:.3f} s, device busy {dev_us / 1e3:.2f} ms")
                for e in sorted(evs, key=lambda e: -e.self_device_time_total
                                )[:5]:
                    print(f"profile {name}:   "
                          f"{e.self_device_time_total / 1e3:9.3f} ms x"
                          f"{e.count:<5d} {e.key[:80]}")
    finally:
        eng_cls.decodes_on_device = own_decode
    pick = eng_cls(dev).decodes_on_device()
    print(f"route lz4 decode: warm GB/s host leg "
          f"{warm['lz4-host-decode']:.4f} vs device leg "
          f"{warm['lz4-device-decode']:.4f}; the engine on the card takes "
          f"the {'device' if pick else 'host'} leg")

    # -- the device CRC32 on the token path, then on the main path; then
    # both routes with the host crc and the device crc in turns (host,
    # device, device, host, twice), warm, on one session each
    crc_warm = {}
    try:
        eng_cls.crc_on_device = lambda self: True
        for name, route, base_path in (
                ("token-device-crc", False, "token"),
                ("dynamic-device-pack-device-crc", None,
                 "dynamic-device-pack")):
            set_route(route)
            sess = qz.QzSession(device="cuda")
            check(sess.setup_deflate() == qz.QZ_OK, "setup_deflate failed")
            cuda_pack.reset_launch_counts()
            t0 = time.perf_counter()
            out = sess.compress(data)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            launches = dict(cuda_pack.LAUNCHES)
            launches_by_path[name] = launches
            check(launches["crc32_rows"] > 0 and launches["parse_scan"] > 0,
                  f"{name}: a kernel of the path never launched: {launches}")
            check(out == outs_by_path[base_path], f"{name}: the bytes differ "
                  f"from the {base_path} path's")
            check(sess.crc32 == zlib.crc32(data), f"{name}: the session's "
                  "crc32 differs from zlib's")
            plain, members = gunzip_members(out)
            check(plain == data, f"{name}: stock zlib does not give back "
                  "the input")
            turns = {False: [], True: []}
            for held in (False, True, True, False) * 2:
                eng_cls.crc_on_device = lambda self, held=held: held
                t0 = time.perf_counter()
                again = sess.compress(data)
                torch.cuda.synchronize()
                turns[held].append(time.perf_counter() - t0)
                check(again == out, f"{name}: a warm compress differs")
            eng_cls.crc_on_device = lambda self: True
            med = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
            crc_warm[name] = {k: len(data) / v / 1e9 for k, v in med.items()}
            print(f"path {name}: {len(data)} bytes -> {len(out)}, the "
                  f"{base_path} path's bytes ({members} members, each crc32 "
                  f"checked by stock zlib; the session's crc zlib's); "
                  f"compress cold {cold_s:.3f} s; warm in turns (host, "
                  f"device, device, host, twice), s: host crc "
                  f"{[round(t, 4) for t in turns[False]]}, device crc "
                  f"{[round(t, 4) for t in turns[True]]}; medians "
                  f"{crc_warm[name][False]:.4f} vs {crc_warm[name][True]:.4f}"
                  f" GB/s; launches {launches}")
    finally:
        eng_cls.crc_on_device = own_crc
        set_route(None)
    pick = eng_cls(dev).crc_on_device()
    tok, main = crc_warm["token-device-crc"], crc_warm[
        "dynamic-device-pack-device-crc"]
    print(f"route crc: warm GB/s (medians in turns) token path host crc "
          f"{tok[False]:.4f} vs device crc {tok[True]:.4f}, dynamic device "
          f"pack {main[False]:.4f} vs {main[True]:.4f}; the engine on the "
          f"card takes the {'device' if pick else 'host'} crc")

    # -- one compress of the main path under qz_trace
    sess = qz.QzSession(device="cuda")
    check(sess.setup_deflate() == qz.QZ_OK, "setup_deflate failed")
    trace_dir = tempfile.mkdtemp(prefix="qz_trace_")
    try:
        before = get_counters().snapshot()
        t0 = time.perf_counter()
        with qz_trace(trace_dir):
            with stage("chip_smoke_compress"):
                out = sess.compress(data)
                torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        check(out == outs_by_path["dynamic-device-pack"], "trace: the "
              "traced compress gave other bytes")
        files = os.listdir(trace_dir)
        check(len(files) == 1, f"trace: {files} in the trace directory")
        with open(os.path.join(trace_dir, files[0])) as f:
            text = f.read()
        named = [k for k in PATHS[2][4] if KERNEL_SYMBOLS[k] in text]
        check(named, "trace: the trace names none of the main path's kernels")
        check('"chip_smoke_compress"' in text, "trace: no stage range")
        tid = threading.get_ident()
        mine = get_counters().snapshot().get(tid, {})
        was = before.get(tid, {})
        counts = {k: mine.get(k, 0) - was.get(k, 0)
                  for k in ("stage_chip_smoke_compress",
                            "stage_chip_smoke_compress_us")}
        check(counts["stage_chip_smoke_compress"] == 1, f"trace: stage "
              f"counters {counts}")
        print(f"trace: one compress of the main path under qz_trace and "
              f"stage {trace_s:.3f} s (warm untraced "
              f"{len(data) / warm_by_path['dynamic-device-pack'] / 1e9:.3f} "
              f"s), a {len(text)}-byte Chrome trace naming {named}; "
              f"counters {counts}")
    finally:
        shutil.rmtree(trace_dir)


def session_paths(qz, cuda_pack, dispatch, data: bytes, launches_by_path,
                  path_kernels) -> None:
    """The paths around the session, each on a dynamic session on the
    card, with the launch counts set to 0 just before and read just
    after: a stream, one batch, async requests on two workers, CRC64, and
    the three CLIs as programs. ``path_kernels`` names the kernels that
    a compress of each algorithm ("deflate", "lz4", "lz4s") must launch.
    Every output is held to the session's own ``compress``."""
    import tempfile
    import threading

    import torch

    def dynamic():
        s = qz.QzSession(device="cuda")
        check(s.setup_deflate() == qz.QZ_OK, "setup_deflate failed")
        return s

    kernels = path_kernels["deflate"]

    def counted(name):
        launches = dict(cuda_pack.LAUNCHES)
        launches_by_path[name] = launches
        check(all(launches[k] > 0 for k in kernels),
              f"{name}: a kernel of the path never launched: {launches}")
        return launches

    sess = dynamic()
    whole = sess.compress(data)           # the one-request reference

    # -- path stream-dynamic: 1 MiB pieces into the largest staging buffer
    unit = qz.constants.QZ_STRM_BUFF_MAX_SZ

    def stream_once():
        strm = qz.QzStream(sess, strm_buff_sz=unit)
        out = bytearray()
        for o in range(0, len(data), STREAM_PIECE):
            out += strm.compress(data[o:o + STREAM_PIECE])
        out += strm.compress(b"", last=True)
        torch.cuda.synchronize()
        crc = strm.crc_32
        check(strm.end() == qz.QZ_OK, "stream: end failed")
        return bytes(out), crc

    torch.cuda.reset_peak_memory_stats()
    cuda_pack.reset_launch_counts()
    t0 = time.perf_counter()
    out, crc = stream_once()
    cold_s = time.perf_counter() - t0
    launches = counted("stream-dynamic")
    t0 = time.perf_counter()
    again, _crc = stream_once()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(again == out, "stream: a second run gave other bytes")
    full = len(data) // unit
    units = [data[i * unit:(i + 1) * unit] for i in range(full)]
    units.append(data[full * unit:])      # the tail ``last`` flushes
    check(out == b"".join(sess.compress(u) for u in units),
          "stream: the output is not its units' compress outputs")
    plain, members = gunzip_members(out)
    check(plain == data, "stream: zlib does not give back the input")
    check(crc == zlib.crc32(data), "stream: crc_32 is not the input's")
    print(f"path stream-dynamic: {len(data)} bytes in {STREAM_PIECE}-byte "
          f"pieces -> {len(units)} units of {unit} bytes -> {len(out)} "
          f"bytes ({members} members, stock zlib decodes them; equal to the "
          f"units' compress outputs; crc_32 checked), ratio "
          f"{len(data) / len(out):.4f}; cold {cold_s:.3f} s, warm "
          f"{warm_s:.3f} s = {len(data) / warm_s / 1e9:.4f} GB/s; peak "
          f"device memory {peak} bytes; launches {launches}")

    # -- path batch-dynamic: 256 requests of 256 KiB in one compress_batch
    reqs = [data[i * BATCH_REQ:(i + 1) * BATCH_REQ] for i in range(BATCH_N)]
    calls = []
    calls_lock = threading.Lock()
    real_cc = dispatch.CudaEngine.compress_chunks

    def counting(self, chunks, **kw):
        with calls_lock:
            calls.append(len(chunks))
        return real_cc(self, chunks, **kw)

    dispatch.CudaEngine.compress_chunks = counting
    try:
        torch.cuda.reset_peak_memory_stats()
        cuda_pack.reset_launch_counts()
        t0 = time.perf_counter()
        batch = sess.compress_batch(reqs)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = counted("batch-dynamic")
        check(len(calls) == 1, f"batch: {len(calls)} compress_chunks calls "
              "for one batch")
        nchunks = calls[0]
        t0 = time.perf_counter()
        again = sess.compress_batch(reqs)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(again == batch, "batch: a second batch gave other bytes")
        t0 = time.perf_counter()
        single = [sess.compress(r, with_crc=True) for r in reqs]
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        check(batch == single, "batch: a request's bytes differ from its "
              "own compress's")
        out = b"".join(o for o, _c in batch)
        check(gunzip_members(out)[0] == data, "batch: zlib does not give "
              "back the input")
        print(f"path batch-dynamic: {len(reqs)} requests of {BATCH_REQ} "
              f"bytes ({nchunks} chunks) in 1 compress_chunks call -> "
              f"{len(out)} bytes (each request equal to its own compress; "
              f"stock zlib decodes them), ratio {len(data) / len(out):.4f}; "
              f"cold {cold_s:.3f} s, warm {batch_s:.3f} s = "
              f"{len(data) / batch_s / 1e9:.4f} GB/s against one request at "
              f"a time {single_s:.3f} s = {len(data) / single_s / 1e9:.4f} "
              f"GB/s ({len(calls) - 2} calls); peak device memory {peak} "
              f"bytes; launches {launches}")

        # -- path async-dynamic: the same requests through two workers
        check(qz.aqz_init(2) == qz.QZ_OK, "aqz_init failed")
        try:
            asess = qz.AQzSession(device="cuda")
            check(asess.setup_deflate() == qz.QZ_OK, "setup_deflate failed")
            results, done = {}, threading.Event()
            res_lock = threading.Lock()

            def cb(external, src, dest, rc, crc):
                with res_lock:
                    results[external] = (rc, dest)
                    if len(results) == len(reqs):
                        done.set()
            calls.clear()
            retries = 0
            torch.cuda.reset_peak_memory_stats()
            cuda_pack.reset_launch_counts()
            t0 = time.perf_counter()
            for i, r in enumerate(reqs):
                while True:
                    rc = asess.compress(r, cb, external=i)
                    if rc != qz.AQZ_NO_SPACE:
                        break
                    retries += 1
                    time.sleep(0.0005)
                check(rc == qz.AQZ_OK, f"async: submit returned {rc}")
            check(done.wait(600), "async: not every callback came")
            torch.cuda.synchronize()
            async_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = counted("async-dynamic")
        finally:
            check(qz.aqz_stop() == qz.QZ_OK, "aqz_stop failed")
    finally:
        dispatch.CudaEngine.compress_chunks = real_cc
    check(all(results[i] == (qz.QZ_OK, single[i][0])
              for i in range(len(reqs))),
          "async: a callback's rc or bytes differ from compress's")
    check(len(calls) < len(reqs), f"async: {len(calls)} compress_chunks "
          f"calls for {len(reqs)} requests: no batch ran")
    print(f"path async-dynamic: {len(reqs)} requests on 2 workers "
          f"({retries} AQZ_NO_SPACE retries) in {len(calls)} compress_chunks "
          f"calls of {sorted(calls)} chunks; every callback rc 0 with its "
          f"compress bytes; {async_s:.3f} s = "
          f"{len(data) / async_s / 1e9:.4f} GB/s; peak device memory {peak} "
          f"bytes; launches {launches}")

    # -- path crc64: qz_compress_crc64 on the whole buffer
    cuda_pack.reset_launch_counts()
    t0 = time.perf_counter()
    rc, out, crc = qz.qz_compress_crc64(sess, data)
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    launches = counted("crc64")
    check(rc == qz.QZ_OK and out == whole, "crc64: the compress differs")
    eng = qz.Crc64()
    check(eng(b"123456789") == 0x6C40DF5F0B497347, "crc64: check vector")
    t0 = time.perf_counter()
    native_crc = eng(data)
    crc_s = time.perf_counter() - t0
    check(crc == native_crc, "crc64: not the native Crc64 of the input")
    head = data[:1 << 20]
    t0 = time.perf_counter()
    py = eng.finalize(eng._compute_py(head, eng.config.initial_value))
    py_s = time.perf_counter() - t0
    check(py == eng(head), "crc64: the Python loop and the native route "
          "differ on the first 1 MiB")
    rc, dec, dcrc = qz.qz_decompress_crc64(sess, out)
    check(rc == qz.QZ_OK and dec == data and dcrc == crc,
          "crc64: qz_decompress_crc64 does not give back the input")
    print(f"path crc64: {len(data)} bytes -> {len(out)}, CRC64 "
          f"{crc:#018x} (the native route {crc_s * 1e3:.1f} ms = "
          f"{len(data) / crc_s / 1e9:.3f} GB/s; the Python loop agrees on "
          f"the first 1 MiB, {py_s:.3f} s); compress {comp_s:.3f} s; "
          f"qz_decompress_crc64 gives the input back; launches {launches}")

    # -- path cli: the three tools as programs, on the card (no --device)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cli_launches = {k: 0 for k in cuda_pack.LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:

        def run(tool, *args, cwd=tmp, algorithm=None):
            """Run one tool; a compress of ``algorithm`` must launch its
            path's kernels."""
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", CLI_LAUNCHER,
                                f"qatzip_tpu_torch.cli.{tool}", *args],
                               cwd=cwd, env=env, capture_output=True,
                               text=True, timeout=600)
            wall = time.perf_counter() - t0
            check(r.returncode == 0, f"cli {tool} {' '.join(args)}: exit "
                  f"{r.returncode}: {r.stderr[-2000:]}")
            launches = json.loads(r.stderr.splitlines()[-1].split(" ", 1)[1])
            for k, v in launches.items():
                cli_launches[k] += v
            ran = {k: v for k, v in launches.items() if v}
            if algorithm is not None:
                check(all(launches[k] > 0 for k in path_kernels[algorithm]),
                      f"cli {tool} {' '.join(args)}: a kernel of the path "
                      f"never launched: {launches}")
            print(f"path cli: {tool} {' '.join(args)}: {wall:.2f} s wall "
                  f"(a new process on the card), launches {ran}")

        def path(*names):
            return os.path.join(tmp, *names)

        def read(*names):
            with open(path(*names), "rb") as f:
                return f.read()

        def write(blob, *names):
            os.makedirs(os.path.dirname(path(*names)), exist_ok=True)
            with open(path(*names), "wb") as f:
                f.write(blob)

        import gzip
        write(data, "c.bin")
        run("qzip", "-k", "c.bin", algorithm="deflate")
        blob = read("c.bin.gz")
        check(gzip.decompress(blob) == data and blob == whole,
              "cli qzip: not gzip of the input, or not the session's bytes")
        os.remove(path("c.bin"))
        run("qzip", "-d", "c.bin.gz")
        check(read("c.bin") == data, "cli qzip -d: not the input")
        run("qzip", "-A", "lz4", "-k", "c.bin", algorithm="lz4")
        os.remove(path("c.bin"))
        run("qzip", "-d", "c.bin.lz4")
        check(read("c.bin") == data, "cli qzip -A lz4: not the input back")
        third = len(data) // 3
        parts = [data[:third], data[third:2 * third], data[2 * third:]]
        for i, part in enumerate(parts):
            write(part, "tree", f"part{i}.bin")
        run("qzip", "-O", "7z", "-o", "t.7z", "tree", algorithm="deflate")
        os.makedirs(path("out"))
        run("qzip", "-d", "../t.7z", cwd=path("out"))
        check([read("out", "tree", f"part{i}.bin") for i in range(3)]
              == parts, "cli qzip -O 7z: the extracted tree differs")
        run("qzstd", "-k", "c.bin", algorithm="lz4s")
        os.remove(path("c.bin"))
        run("qzstd", "-d", "c.bin.zst")
        check(read("c.bin") == data, "cli qzstd: not the input back")
        run("aqzip", "-k", "c.bin", algorithm="deflate")
        check(gzip.decompress(read("c.bin.gz")) == data,
              "cli aqzip: not gzip of the input")
        os.remove(path("c.bin"))
        run("aqzip", "-d", "c.bin.gz")
        check(read("c.bin") == data, "cli aqzip -d: not the input back")
    launches_by_path["cli"] = cli_launches
    print(f"path cli: every tool round trip gave the input back (the "
          f"libzstd.so.1 the native library links, version "
          f"{qz.native.get_lib().zstd_version}); launches {cli_launches}")


def dealt_tiles(rows: int, shares: int, tile_b: int) -> int:
    """The tiles an engine dispatches for ``rows`` rows dealt in
    contiguous blocks over ``shares`` devices, ``tile_b`` rows a tile."""
    cuts = [d * rows // shares for d in range(shares + 1)]
    return sum(-(-(hi - lo) // tile_b) for lo, hi in zip(cuts, cuts[1:]))


def mesh_paths(qz, cuda_pack, data: bytes, rows: int, want, warm_by_path,
               peak_by_path, launches_by_path, session, decodes,
               set_route) -> None:
    """The mesh phase. (a) The engine over several devices (every visible
    card; on a one-card machine the card twice, then three times, which
    pads) on the 64 MiB request, on the main path, the static device
    pack, the token path and the LZ4 device pack (``rows`` chunks),
    launch counts zeroed before and read after each: the bytes equal the
    one-card engine's (``want``), stock zlib or the session decodes them,
    a second compress gives them again, every kernel of the path launched
    once a tile of each share, as on one card once a tile; GB/s and peak
    device memory beside the one-card figures, and for the first mesh
    warm compresses of one card and of the mesh in turns ("turns"
    lines). (b) ``dryrun_multichip(2)``
    and ``entry()`` on the card. (c) ``python -m
    qatzip_tpu_torch.tools.distrun --procs 2 --engine device --device
    cuda`` as a program, its ``ok`` line required. (d) One line on how
    many distinct cards the mesh had and what went unverified."""
    import torch

    from qatzip_tpu_torch.graft_entry import dryrun_multichip, entry
    from qatzip_tpu_torch.parallel import dispatch
    from qatzip_tpu_torch.parallel.dispatch import MeshEngine

    count = torch.cuda.device_count()
    meshes = ([[f"cuda:{i}" for i in range(count)]] if count > 1
              else [["cuda:0"] * 2, ["cuda:0"] * 3])
    for devs in meshes:
        for name, kind, level, route, kernels in PATHS:
            if name not in MESH_PATHS:
                continue
            set_route(route)
            sess = session(kind, level, devs)
            check(isinstance(sess._engine, MeshEngine) and len(
                sess.devices) == len(devs), f"mesh {devs}: not a MeshEngine")
            label = f"mesh-{len(devs)}x-{name}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_pack.reset_launch_counts()
            t0 = time.perf_counter()
            out = sess.compress(data)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            launches = dict(cuda_pack.LAUNCHES)
            launches_by_path[label] = launches
            check(all(launches[k] > 0 for k in kernels),
                  f"{label}: a kernel of the path never launched: {launches}")
            # each kernel launches as often a tile as on one card
            one_card = launches_by_path[name]
            tiles = [dealt_tiles(rows, k, dispatch.TILE_B)
                     for k in (1, len(devs))]
            check(all(v % tiles[0] == 0 for v in one_card.values()),
                  f"{name}: one card's launches {one_card} are not a whole "
                  f"number a tile of {tiles[0]}")
            exact = {k: v // tiles[0] * tiles[1] for k, v in one_card.items()}
            check(launches == exact, f"{label}: launches {launches}, not "
                  f"{exact} ({tiles[1]} tiles over the shares)")
            check(out == want[name], f"{label}: the bytes differ from the "
                  f"one-card engine's ({len(out)} against "
                  f"{len(want[name])})")
            shape = decodes(label, kind, sess, out)
            t0 = time.perf_counter()
            again = sess.compress(data)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            check(again == out, f"{label}: a second compress gave other "
                  "bytes")
            peak = torch.cuda.max_memory_allocated()
            print(f"path {label}: devices {devs}, {len(data)} bytes -> "
                  f"{len(out)} ({shape}), equal to the one-card engine's "
                  f"bytes; compress cold {cold_s:.3f} s, warm {warm_s:.3f} s "
                  f"= {len(data) / warm_s / 1e9:.4f} GB/s against one card's "
                  f"{warm_by_path[name]:.4f}; peak device memory {peak} bytes "
                  f"against one card's {peak_by_path[name]}; launches "
                  f"{launches}")
            del out, again
            if devs is meshes[0]:
                # warm compresses of one card and of the mesh in turns
                # (one, mesh, mesh, one, twice): host times move up to 2x
                # between runs, so only turns compare the two
                one = session(kind, level, "cuda:0")
                secs = {"one": [], "mesh": []}
                for who in ("one", "mesh", "mesh", "one") * 2:
                    s_ = one if who == "one" else sess
                    t0 = time.perf_counter()
                    s_.compress(data)
                    torch.cuda.synchronize()
                    secs[who].append(time.perf_counter() - t0)
                med = {k: sorted(v)[len(v) // 2 - 1:len(v) // 2 + 1]
                       for k, v in secs.items()}
                gbps = {k: len(data) / (sum(v) / 2) / 1e9
                        for k, v in med.items()}
                ones = [round(x, 4) for x in secs["one"]]
                mesh_s = [round(x, 4) for x in secs["mesh"]]
                print(f"turns {label}: warm s in turns (one, mesh, mesh, "
                      f"one, twice): one card {ones}, mesh {mesh_s}; median "
                      f"GB/s one card {gbps['one']:.4f}, mesh "
                      f"{gbps['mesh']:.4f} ({gbps['mesh'] / gbps['one']:.3f}x)")
                del one
            torch.cuda.empty_cache()
    set_route(None)

    t0 = time.perf_counter()
    got = dryrun_multichip(2)
    fn, args = entry()
    toks, ntok = fn(*args)
    torch.cuda.synchronize()
    check(tuple(toks.shape) == (4, 16384) and toks.is_cuda
          and int(ntok.min()) > 0, "entry: unexpected tokens")
    print(f"mesh dryrun_multichip(2): {json.dumps(got)}; entry(): tokens "
          f"{tuple(toks.shape)} on {toks.device}, ntok {ntok.tolist()}; "
          f"{time.perf_counter() - t0:.2f} s")

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "qatzip_tpu_torch.tools.distrun",
                        "--procs", "2", "--engine", "device", "--device",
                        "cuda", "--timeout", "300"], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=360)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"distrun: exit {r.returncode}: "
          f"{r.stderr[-2000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    check(line.get("ok") is True and line["procs"] == 2,
          f"distrun: no ok line: {line}")
    workers = [ln for ln in r.stdout.splitlines() if ln.startswith("worker")]
    print(f"mesh distrun: two processes on the card, {wall:.2f} s wall; "
          f"{'; '.join(workers)}; {json.dumps(line)}")

    if count > 1:
        print(f"mesh: {count} distinct cards; the shards were placed on "
              "distinct cards and launched on them at once; distrun's "
              "collective ran over gloo on the host, between processes "
              "sharing the cards")
    else:
        print("mesh: 1 distinct card (the card repeated in each mesh); "
              "unverified for want of a second card: peer placement of "
              "shards on distinct cards, concurrent launches on two devices "
              "(here two streams of one card), and a collective between two "
              "cards (distrun's all_gather ran over gloo on the host)")


# the tools phase: qztest's modes at the reference's request size, then
# qztest -m 4 on the main paths at full size and at the reference's
# request size, the perf harness and the soak (all --device cuda)
TOOL_ARGS = ["-t", "2", "-l", "3", "-b", "65536", "-v", "--device", "cuda"]
# modes that fork or drop the process's engines run as programs
TOOL_PROGRAM_MODES = (19, 21)
# the kernels qztest -m 4 must launch: the card's deflate route (the
# dynamic device pack with the device crc) and its LZ4 route
TOOL_KERNELS = {"deflate": PATHS[2][4], "lz4": ("parse_scan",
                                                "lz4_pack_rows")}
SOAK_ITERS = 40
SOAK_CPU_CHECKS = 4
DECPROF_MB = 16


def tool_main(main, argv):
    """``main(argv)`` with its standard output captured: (exit code,
    output lines, seconds)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines(), time.perf_counter() - t0


def tools_paths(cuda_pack, data: bytes, card: str, set_route) -> None:
    """The tools phase, everything on the card: (a) ``qztest`` modes 1-23
    at ``TOOL_ARGS``, in this process except 19 and 21, which run as
    programs; (b) ``qztest -m 4`` on a file of the 64 MiB corpus, deflate
    and ``-A lz4``, at one and four threads, each launching every kernel
    of its route (counts set to 0 just before, read just after), then at
    64 KiB requests (a request's fixed cost, not the kernels); (c)
    ``run_perf_test -p 2 -t 2``; (d) ``soak`` (``SOAK_ITERS``), and its
    first ``SOAK_CPU_CHECKS`` deflate requests again on device="cpu",
    held on the card's route: the same bytes; (e) ``decprof --mb
    DECPROF_MB`` (every stage line, the card's line first) and
    ``ratiocheck --mb 2``, and ``ratiocheck --mb 1`` on the card and on
    the CPU: the same JSON line. Any failure raises."""
    import tempfile

    from qatzip_tpu_torch.tools import (decprof, qztest, ratiocheck,
                                        run_perf_test, soak)

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    for mode in range(1, 24):
        argv = ["-m", str(mode), *TOOL_ARGS]
        if mode in TOOL_PROGRAM_MODES:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m",
                                "qatzip_tpu_torch.tools.qztest", *argv],
                               cwd=repo, capture_output=True, text=True,
                               timeout=600)
            rc, lines, secs = (r.returncode, r.stdout.splitlines(),
                               time.perf_counter() - t0)
            check(rc == 0, f"tools qztest -m {mode}: exit {rc}: "
                  f"{r.stderr[-3000:]}")
        else:
            rc, lines, secs = tool_main(qztest.main, argv)
            check(rc == 0, f"tools qztest -m {mode}: exit {rc}")
        info = [ln for ln in lines if ln.startswith("[INFO]")]
        check(mode in (1, 3) or len(info) == 2,
              f"tools qztest -m {mode}: {len(info)} [INFO] lines, not 2")
        total = [ln + " | " + card for ln in lines
                 if ln.startswith("[TOTAL]")]
        shown = (total or info[-1:] or [""])[0]
        how = " (a program)" if mode in TOOL_PROGRAM_MODES else ""
        print(f"tools qztest -m {mode} {' '.join(TOOL_ARGS)}: exit 0 in "
              f"{secs:.2f} s{how}: {shown}")

    with tempfile.TemporaryDirectory() as tmp:
        corpus_file = os.path.join(tmp, "corpus.bin")
        with open(corpus_file, "wb") as f:
            f.write(data)
        runs = [(algorithm, ["-t", str(t), "-l", "2", "-D", "both", "-v",
                             "-i", corpus_file], f"-t {t} -i 64 MiB file",
                 "the kernels' paths: 1024 rows a request")
                for algorithm in ("deflate", "lz4") for t in (1, 4)]
        runs += [("deflate", ["-t", str(t), "-l", "100", "-b", "65536",
                              "-v"], f"-t {t} -l 100 -b 65536",
                  "a request's fixed cost: one 64 KiB row a request")
                 for t in (1, 4)]
        for algorithm, extra, what, reads in runs:
            argv = ["-m", "4", "-A", algorithm, "--device", "cuda", *extra]
            cuda_pack.reset_launch_counts()
            rc, lines, secs = tool_main(qztest.main, argv)
            launches = dict(cuda_pack.LAUNCHES)
            check(rc == 0, f"tools qztest {' '.join(argv)}: exit {rc}")
            check(all(launches[k] > 0 for k in TOOL_KERNELS[algorithm]),
                  f"tools qztest -m 4 -A {algorithm} {what}: a kernel of "
                  f"the route never launched: {launches}")
            total = [ln for ln in lines if ln.startswith("[TOTAL]")]
            check(len(total) == 1, f"tools qztest {what}: no [TOTAL] line")
            for ln in lines:
                if ln.startswith("[INFO]"):
                    print(f"tools qztest -m 4 -A {algorithm} {what}: {ln}")
            print(f"tools qztest -m 4 -A {algorithm} {what} ({reads}): "
                  f"{total[0]} | {card}; {secs:.2f} s; launches "
                  f"{ {k: v for k, v in launches.items() if v} }")

    rc, lines, secs = tool_main(run_perf_test.main, [
        "-p", "2", "-t", "2", "--device", "cuda"])
    check(rc == 0, "tools run_perf_test: exit " + str(rc))
    for ln in lines:
        print(f"tools run_perf_test -p 2 -t 2: {ln}"
              + (f" | {card}; {secs:.2f} s wall" if "TOTAL" in ln else ""))

    rc, lines, secs = tool_main(soak.main, [
        "--iters", str(SOAK_ITERS), "--seed", "0", "--device", "cuda"])
    check(rc == 0 and lines[-1].startswith("soak: all clear"),
          f"tools soak: exit {rc}")
    print(f"tools soak --iters {SOAK_ITERS} --seed 0: {lines[-1]} | {card}")
    checked = []
    for it, _seed, rng, n, _kind, req, surface in soak.iterations(
            0, SOAK_ITERS):
        if surface != 0:
            continue
        level, fmt, hw = soak.deflate_case(rng)
        sess = soak.deflate_session("cuda", level, fmt, hw)
        got = sess.compress(req)
        set_route(sess._engine.packs_on_device(False, "deflate"))
        try:
            cpu = soak.deflate_session("cpu", level, fmt, hw).compress(req)
        finally:
            set_route(None)
        check(cpu == got, f"tools soak iter {it}: device='cpu' and "
              f"device='cuda' give other bytes (n {n}, level {level}, "
              f"{fmt.name}, hw_buff_sz {hw})")
        checked.append(f"iter {it}: {n} bytes, level {level}, {fmt.name}, "
                       f"hw_buff_sz {hw} -> {len(got)}")
        if len(checked) == SOAK_CPU_CHECKS:
            break
    print(f"tools soak: the first {len(checked)} deflate requests give the "
          f"same bytes on device='cpu' (held on the card's route): "
          f"{'; '.join(checked)}")

    # decprof and ratiocheck
    rc, lines, secs = tool_main(decprof.main, ["--mb", str(DECPROF_MB)])
    stages = ("scan_gzipext:", "inflate_batch_bytes:", "crc_combine_many:",
              "e2e decompress:", "unaccounted:")
    check(rc == 0 and lines[0] == "card: " + card and all(
        any(ln.startswith(st) for ln in lines) for st in stages)
        and sum("inflate nthreads=" in ln for ln in lines) == 6,
        f"tools decprof: exit {rc}, {len(lines)} lines")
    for ln in lines:
        print(f"tools decprof --mb {DECPROF_MB}: {ln}")
    print(f"tools decprof --mb {DECPROF_MB}: {secs:.2f} s wall")
    rc, lines, secs = tool_main(ratiocheck.main, ["--mb", "2"])
    print(f"tools ratiocheck --mb 2: {lines[-1]} ({secs:.2f} s) | {card}")
    one = {}
    for device in ("cuda", "cpu"):
        rc, lines, secs = tool_main(ratiocheck.main, ["--mb", "1",
                                                      "--device", device])
        one[device] = lines[-1]
        print(f"tools ratiocheck --mb 1 --device {device}: {lines[-1]} "
              f"({secs:.2f} s)")
    check(one["cuda"] == one["cpu"], "tools ratiocheck: the JSON line "
          "differs between --device cuda and --device cpu")
    print(f"tools: phase {time.perf_counter() - t_phase:.2f} s wall | {card}")


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


#: ``--threads``: the request sizes and thread counts of ``thread_probe``
THREAD_SIZES = (65536, 262144, 1048576)
THREAD_COUNTS = (1, 4)


def thread_probe() -> None:
    """``--threads``: how ``qztest -m 4`` threads share one engine on the
    card. For each request size of THREAD_SIZES, one and four threads
    (``-l 50``, ``-l 20`` over 64 KiB), each free and with every request
    held under one process lock (one ``QzSession.compress`` at a time),
    in turns, twice; at 64 KiB also four threads with a 0.2 ms GIL switch
    interval and with a CUDA stream a thread; then a profile of one and
    of four threads at 64 KiB: device activities a request and the host
    time of one ``cudaLaunchKernel``. Lines ``threads ...``; it measures
    and claims nothing."""
    import contextlib
    import io
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    check(torch.cuda.is_available(), "no CUDA device: torch.cuda is not "
          "available")
    from qatzip_tpu_torch.ops import cuda_pack
    from qatzip_tpu_torch.session import QzSession
    from qatzip_tpu_torch.tools import qztest

    cuda_pack.kernels()
    card = card_line()
    own_compress, own_mode4 = QzSession.compress, qztest.run_mode_4
    lock = threading.Lock()

    def held(*a, **k):
        with lock:
            return own_compress(*a, **k)

    def in_stream(args, tid, stats, direction="both"):
        with torch.cuda.stream(torch.cuda.Stream()):
            return own_mode4(args, tid, stats, direction)

    def run(threads, size, how="free", loops=None):
        QzSession.compress = held if how == "one at a time" else own_compress
        qztest.run_mode_4 = in_stream if how == "a stream each" else own_mode4
        switch = sys.getswitchinterval()
        if how == "switch 0.2 ms":
            sys.setswitchinterval(0.0002)
        loops = loops or (50 if size <= 65536 else 20)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = qztest.main(["-m", "4", "-t", str(threads), "-l",
                                  str(loops), "-b", str(size), "-v",
                                  "--device", "cuda"])
        finally:
            sys.setswitchinterval(switch)
            QzSession.compress, qztest.run_mode_4 = own_compress, own_mode4
        check(rc == 0, f"threads: qztest -m 4 -t {threads} -b {size} ({how}) "
              f"exit {rc}")
        total = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("[TOTAL]")][0]
        print(f"threads -b {size} -t {threads} {how}: {total} | {card}",
              flush=True)

    run(1, 65536, loops=10)                   # warm
    for _turn in range(2):
        for size in THREAD_SIZES:
            for how in ("free", "one at a time"):
                for threads in THREAD_COUNTS:
                    run(threads, size, how)
        for how in ("switch 0.2 ms", "a stream each"):
            run(4, 65536, how)
    sess = QzSession("cuda")
    sess.setup_deflate()
    data = qztest.gen_random_data(65536)
    for threads in THREAD_COUNTS:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            workers = [threading.Thread(
                target=lambda: [sess.compress(data) for _ in range(10)])
                for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = sum(e.count for e in events
                     if e.device_type.name == "CUDA")
        launch = [e for e in events if e.key == "cudaLaunchKernel"][0]
        print(f"threads profile -t {threads}, 10 requests of 64 KiB each: "
              f"{device / (10 * threads):.1f} device activities a request; "
              f"cudaLaunchKernel {launch.cpu_time_total / launch.count:.2f} "
              f"us of host time a call over {launch.count} calls | {card}",
              flush=True)


#: ``--crc-variants``: csrc/crc32_rows.cu's CTA shape (kWarps x kSteps, the
#: same 2 KiB block and fragments) and register cap, edited into a copy
CRC_VARIANTS = {
    "4 warps x 4 steps (the library's)": {},
    "8 warps x 2 steps": {"kWarps = 4;": "kWarps = 8;",
                          "kSteps = 4;": "kSteps = 2;"},
    "8 warps x 2 steps, at most 64 registers": {
        "kWarps = 4;": "kWarps = 8;", "kSteps = 4;": "kSteps = 2;",
        "__launch_bounds__(kWarps * 32)": "__launch_bounds__(kWarps * 32, 4)"},
}


def crc_variants() -> None:
    """``--crc-variants``: the card line, then csrc/crc32_rows.cu built
    again (nvcc with ``-Xptxas -v``, all at once) in each shape of
    CRC_VARIANTS: its registers, its crcs against zlib.crc32 and its
    device time at (256, 65536) (the profiler), one line each."""
    import ctypes
    import numpy as np
    import torch
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda is not "
          "available")
    from qatzip_tpu_torch.ops import _build
    from qatzip_tpu_torch.ops import crc32_mxu as cm
    print(card_line())
    src = open(os.path.join(_build.CSRC_DIR, "crc32_rows.cu")).read()
    out_dir = os.path.join(_build.BUILD_DIR, "crc_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for k, (name, edits) in enumerate(CRC_VARIANTS.items()):
        text = src
        for old, new in edits.items():
            check(old in text, f"crc variant {name}: no {old!r} in the source")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"v{k}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-I", _build.CSRC_DIR, "-o", cu[:-3] + ".so",
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    dev = torch.device("cuda", 0)
    n, rows = 65536, 256
    tile = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (rows, n), dtype=np.uint8)).to(dev)
    want = [zlib.crc32(r.tobytes()) for r in tile.cpu().numpy()]
    z = cm._zero_crc(n)
    frag = cm._on("frag", 0, dev)
    tails = cm._on("tails", n // cm.BLOCK, dev)
    out = torch.empty(rows, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"crc variant {name}: nvcc failed\n{log}")
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        lib = ctypes.CDLL(so)
        lib.qz_crc32_rows.restype = ci
        lib.qz_crc32_rows.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]

        def run(lib=lib):
            rc = lib.qz_crc32_rows(
                tile.data_ptr(), out.data_ptr(), frag.data_ptr(),
                tails.data_ptr(), rows, n,
                z - (1 << 32) if z >= 1 << 31 else z, stream)
            check(rc == 0, f"crc variant: cudaError {rc}")
            return out
        run()
        check(out.tolist() == want, f"crc variant {name} differs from "
              f"zlib.crc32")
        ms = device_ms(run, 50, "crc_kernel")
        print(f"crc variant {name}: equal to zlib.crc32, registers {regs} "
              f"(the byte-load and the vector kernel), device time "
              f"(profiler) {ms:.4f} ms at ({rows}, {n})")


PAIR_LINES = {
    "lz4_resolve_refs": re.compile(
        r"^kernel lz4_resolve_refs \((\d+), (\d+)\), \d+ rounds: device "
        r"time \(profiler\) ([0-9.]+) ms"),
    "crc32_rows": re.compile(
        r"^kernel crc32_rows \((\d+), (\d+)\): equal to zlib\.crc32; "
        r"device time \(profiler\) ([0-9.]+) ms"),
}


def pair_report(runs) -> dict:
    """``--pair LABEL=LOG ...``: the device times of the kernels in
    PAIR_LINES from the logs of several ``chip_smoke.py`` runs (of this
    tree and of another, in one call: parent, change, change, parent),
    each beside its bound from the run's ``kernels`` line and its share of
    it, and the range of each label's runs. Reads only the logs."""
    out = {}
    for arg in runs:
        label, path = arg.split("=", 1)
        with open(path, errors="replace") as f:
            lines = f.read().splitlines()
        bounds = {}
        for ln in lines:
            if ln.startswith('{"kernels"'):
                bounds = {k["name"]: k["bound_ms"]
                          for k in json.loads(ln)["kernels"]}
        card = next((ln[len("env: nvidia-smi "):] for ln in lines
                     if ln.startswith("env: nvidia-smi ")), "not found")
        for name, pat in PAIR_LINES.items():
            got = next((m for m in map(pat.match, lines) if m), None)
            check(got is not None and name in bounds,
                  f"{path}: no {name} line or bound")
            ms, bound = float(got.group(3)), bounds[name]
            out.setdefault(name, []).append(
                {"label": label, "log": path, "card": card,
                 "shape": [int(got.group(1)), int(got.group(2))],
                 "device_ms": ms, "bound_ms": bound,
                 "share_of_bound": bound / ms})
            print(f"pair {name} {label} ({path}, {card}): {ms:.4f} ms of "
                  f"device time at {got.group(1)} x {got.group(2)}, bound "
                  f"{bound:.4f} ms, {100 * bound / ms:.1f} % of it")
    for name, rows in out.items():
        for label in dict.fromkeys(r["label"] for r in rows):
            ms = [r["device_ms"] for r in rows if r["label"] == label]
            print(f"pair {name} {label}: {min(ms):.4f}-{max(ms):.4f} ms over "
                  f"{len(ms)} runs")
    print(json.dumps({"pair": out}))
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["--host-cost"]:
        host_cost_only()
    elif sys.argv[1:2] == ["--pair"]:
        pair_report(sys.argv[2:])
    elif sys.argv[1:] == ["--crc-variants"]:
        crc_variants()
    elif sys.argv[1:] == ["--threads"]:
        thread_probe()
    else:
        main()
