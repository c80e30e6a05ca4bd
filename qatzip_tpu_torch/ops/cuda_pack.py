"""Hand-written CUDA kernels of the tokenizer, with their plain versions.

Counterpart of ``qatzip_tpu/ops/pallas_pack.py``. Each kernel has:

  * a wrapper that checks device, dtype, shape and contiguity, launches
    the kernel on the tensors' device's current stream through the
    extension module (:func:`kernels`) for CUDA tensors, raises if the
    launch was refused, and counts its launches in ``LAUNCHES``
    (``count_launch``);
  * a plain PyTorch version (``*_ref``) of the same function, which the
    wrapper runs for CPU tensors (and only for them) and which the chip
    check compares the kernel with.

Kernels (sources in ``qatzip_tpu_torch/csrc/``), each bit-identical to
what it replaces:

  * ``candidate_search`` — TPU kernel k2 (``pallas_pack.py::candidate_search``);
  * ``parse_scan`` — the greedy-parse recurrence ``lz77.py::_parse_scan``;
  * ``pack_rows`` — TPU kernel k1 (``pallas_pack.py::assemble_windows``)
    together with the emission, offset and group-pack stages that fed it;
    its wrapper and plain version live in ``deflate_pack.py``, beside the
    emission functions they share;
  * ``huffman_lookup`` — TPU kernel k3 (``pallas_pack.py::huffman_lookup``);
  * ``symbol_histogram`` — TPU kernel k4 (``pallas_pack.py::symbol_histogram``);
  * ``lz4_pack_rows`` — the LZ4 device pack's byte packer, which the JAX
    package ran as XLA ops (``lz4_pack.py:65-143``); its wrapper and plain
    version live in ``lz4_pack.py``;
  * ``lane_gather``, ``sublane_gather``, ``roll_sum`` and ``bitonic128``
    — the probes of ``tools/devprims.py`` (its Pallas gathers, rolls and
    bitonic sort), which no codec path runs; their wrappers and plain
    versions live in ``devprims.py``;
  * ``lz4_resolve_refs`` — the device LZ4 decode's chain resolution,
    which the JAX package ran as an XLA loop of gathers
    (``lz4_decode.py::resolve_refs``); its wrapper and plain version live
    in ``lz4_decode.py``;
  * ``crc32_rows`` — the device CRC32, an XLA dot in the JAX package
    (``crc32_mxu.py::crc32_batch_device``); its wrapper and plain version
    live in ``crc32_mxu.py``;
  * ``search_inputs``, ``parse_inputs`` — the tokenizer's stages around
    the candidate search and the parse, which XLA fused in the JAX
    package (``lz77.py::_analyze``, ``_extend_matches``,
    ``_analyze_tail``); their wrappers and plain versions live in
    ``lz77.py``;
  * ``symbol_planes`` — the dynamic pack's symbol planes, XLA ops in the
    JAX package (``deflate_pack.py::_len_symbol``, ``_dist_symbol``); its
    wrapper and plain versions live in ``deflate_pack.py``.

32-bit words cross the kernel interface as int32 tensors holding the
uint32 bit pattern (torch has no full uint32 arithmetic). The plain
versions widen them to int64 first: as int32, keys with bit 31 set (the
overflow bucket) would sort first.
"""

from __future__ import annotations

import os
import threading

import torch

LAUNCHES = {"candidate_search": 0, "parse_scan": 0, "pack_rows": 0,
            "huffman_lookup": 0, "symbol_histogram": 0, "lz4_pack_rows": 0,
            "lane_gather": 0, "sublane_gather": 0, "roll_sum": 0,
            "bitonic128": 0, "lz4_resolve_refs": 0, "crc32_rows": 0,
            "search_inputs": 0, "parse_inputs": 0, "symbol_planes": 0}

#: the kernel extension module once loaded (``kernels()``); a wrapper
#: reads it as ``_ext or kernels()``, so no lock is taken after the load
_ext = None
_ext_lock = threading.Lock()


#: guards ``LAUNCHES``: a ``MeshEngine`` launches from a thread a device
_count_lock = threading.Lock()
# another thread may hold either lock when the process forks
os.register_at_fork(after_in_child=_ext_lock._at_fork_reinit)
os.register_at_fork(after_in_child=_count_lock._at_fork_reinit)


def count_launch(name: str) -> None:
    """Add one to kernel ``name``'s launch count (a wrapper calls it
    where it launches its kernel, and nowhere else)."""
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def kernels():
    """The CUDA kernels' extension module (``csrc/binding.c``), built with
    nvcc at first use: one function a kernel, named as the kernel, taking
    the C entry's arguments as ints and raising RuntimeError if the launch
    was refused; its ``stream(device_index)`` is the current raw stream of
    that device (``torch._C._cuda_getCurrentRawStream``)."""
    global _ext
    with _ext_lock:
        if _ext is None:
            from ._build import load_kernels
            ext = load_kernels()
            ext.stream = torch._C._cuda_getCurrentRawStream
            _ext = ext
    return _ext


def _device(t: torch.Tensor) -> int:
    """The CUDA device index of ``t``, or -1 on the CPU; other devices
    are refused."""
    d = t.get_device()
    if d < 0 and not t.is_cpu:
        raise ValueError(f"unsupported device {t.device}")
    return d


def _require(t: torch.Tensor, what: str, dtype, dev: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on device index
    ``dev`` (-1: the CPU)."""
    if t.dtype is not dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.get_device() != dev:
        raise ValueError(f"{what} is on {t.device}, expected "
                         f"{'cpu' if dev < 0 else f'cuda:{dev}'}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


# ---------------------------------------------------------------------------
# k2: candidate search
# ---------------------------------------------------------------------------

def candidate_search_ref(key: torch.Tensor, ctx: torch.Tensor, *,
                         probes: int, min_match: int,
                         pbits: int) -> torch.Tensor:
    """Plain version of :func:`candidate_search` (same arguments)."""
    w = key.shape[1]
    k64 = key.to(torch.int64) & 0xFFFFFFFF
    key_s, _ = torch.sort(k64, dim=1)          # keys unique per row
    pmask = (1 << pbits) - 1
    pos_s = key_s & pmask
    h_s = key_s >> pbits
    ctx_s = [torch.gather(c.to(torch.int64) & 0xFFFFFFFF, 1, pos_s)
             for c in ctx]
    best_ml = torch.zeros_like(pos_s)
    best_d1 = torch.zeros_like(pos_s)
    for d in range(1, min(probes, w - 1) + 1):
        same = h_s[:, d:] == h_s[:, :-d]
        dist = pos_s[:, d:] - pos_s[:, :-d]
        ml = torch.zeros_like(dist)
        alive = same
        for c in ctx_s:
            x = c[:, d:] ^ c[:, :-d]
            full = (x == 0) & alive
            partial = (((x & 0xFF) == 0).to(torch.int64)
                       + ((x & 0xFFFF) == 0).to(torch.int64)
                       + ((x & 0xFFFFFF) == 0).to(torch.int64))
            ml = ml + torch.where(full, 4, torch.where(alive, partial, 0))
            alive = full
        ok = same & (dist >= 1) & (ml >= min_match)
        better = ok & (ml > best_ml[:, d:])
        best_ml[:, d:] = torch.where(better, ml, best_ml[:, d:])
        best_d1[:, d:] = torch.where(better, dist - 1, best_d1[:, d:])
    packed = (pos_s << 18) | (best_ml << 13) | best_d1
    out = torch.empty_like(packed)
    out.scatter_(1, pos_s, packed)
    return out.to(torch.int32)


def candidate_search(key: torch.Tensor, ctx: torch.Tensor, *, probes: int,
                     min_match: int, pbits: int) -> torch.Tensor:
    """Fused sort -> probe -> unsort candidate search over window rows.

    Args:
      key: (rows, w) int32 holding uint32 (hash << pbits) | relpos; w a
           power of two, 2 <= w <= 8192, w <= 2**pbits; each row's relpos
           a permutation of 0..w-1 (so its keys are unique).
      ctx: (ctx_words, rows, w) int32 context words (uint32 bit patterns),
           1 <= ctx_words <= 4.
    Returns:
      (rows, w) int32: (relpos << 18) | (ml << 13) | (dist - 1) in window
      order; ml <= 4 * ctx_words, and ml = dist - 1 = 0 where nothing
      matched.
    """
    rows, w = key.shape
    ctx_words = ctx.shape[0]
    if w < 2 or w > 8192 or w & (w - 1):
        raise ValueError(f"window width {w} must be a power of two <= 8192")
    if not (w - 1 < (1 << pbits) and pbits <= 13):
        raise ValueError(f"pbits {pbits} does not fit window width {w}")
    if not (1 <= ctx_words <= 4 and 1 <= probes < 64
            and 1 <= min_match <= 16):
        raise ValueError("ctx_words 1..4, probes 1..63, min_match 1..16")
    if tuple(ctx.shape[1:]) != (rows, w):
        raise ValueError(f"ctx shape {tuple(ctx.shape)} != (*, {rows}, {w})")
    dev = _device(key)
    _require(key, "key", torch.int32, dev)
    _require(ctx, "ctx", torch.int32, dev)
    if dev < 0:
        return candidate_search_ref(key, ctx, probes=probes,
                                    min_match=min_match, pbits=pbits)
    out = torch.empty_like(key)
    if rows == 0:
        return out
    k = _ext or kernels()
    k.candidate_search(key.data_ptr(), ctx.data_ptr(), out.data_ptr(), rows,
                       w, pbits, ctx_words, probes, min_match, k.stream(dev))
    count_launch("candidate_search")
    return out


# ---------------------------------------------------------------------------
# greedy-parse scan
# ---------------------------------------------------------------------------

#: the widest parse segment: the kernel stages one in shared memory
MAX_PARSE_SEG = 8192


#: up to this many segment lanes the plain version walks each lane on
#: the host from token to token; over it, a torch step a position in
#: lockstep over all lanes costs less
HOST_WALK_LANES = 64


def _parse_walk(is_match: torch.Tensor, ml: torch.Tensor, seg: int):
    """:func:`parse_scan_ref` lane by lane in Python, from each token to
    the next: a match at p covers p .. p + ml - 1, so the next free
    position is max(p + 1, p + ml)."""
    b, n = is_match.shape
    lanes = b * (n // seg)
    ims = is_match.reshape(lanes, seg).tolist()
    mls = ml.reshape(lanes, seg).tolist()
    taken, lit = bytearray(b * n), bytearray(b * n)
    for r in range(lanes):
        im_r, ml_r, base, p = ims[r], mls[r], r * seg, 0
        while p < seg:
            if im_r[p]:
                taken[base + p] = 1
                p += max(ml_r[p], 1)
            else:
                lit[base + p] = 1
                p += 1

    def plane(buf):
        return (torch.frombuffer(buf, dtype=torch.uint8).reshape(b, n)
                .to(device=is_match.device, dtype=torch.bool))
    return plane(taken), plane(lit)


def parse_scan_ref(is_match: torch.Tensor, ml: torch.Tensor,
                   seg: int):
    """Plain version of :func:`parse_scan`: one column step per position,
    in lockstep over all lanes (up to HOST_WALK_LANES lanes, the same
    planes from :func:`_parse_walk`)."""
    b, n = is_match.shape
    rows = b * (n // seg)
    if rows <= HOST_WALK_LANES:
        return _parse_walk(is_match, ml, seg)
    im = is_match.reshape(rows, seg).t().contiguous()
    mls = ml.reshape(rows, seg).t().contiguous()
    taken = torch.empty_like(im)
    lit = torch.empty_like(im)
    reach = torch.zeros(rows, dtype=torch.int32, device=ml.device)
    for p in range(seg):
        free = reach <= p
        tk = free & im[p]
        taken[p] = tk
        lit[p] = free & ~im[p]
        reach = torch.where(tk, mls[p] + p, reach)
    return (taken.t().reshape(b, n).contiguous(),
            lit.t().reshape(b, n).contiguous())


def parse_scan(is_match: torch.Tensor, ml: torch.Tensor, seg: int):
    """Greedy-parse coverage scan over b * (n // seg) segment lanes.

    Args:
      is_match: (b, n) bool, a match may start at p.
      ml: (b, n) int32 match length at p (>= 1 where is_match, and
          ml + seg < 2**31); a match may run past its segment's end.
      seg: parse segment length, 1 <= seg <= MAX_PARSE_SEG; n % seg == 0.
    Returns:
      (taken, lit): (b, n) bool — a match token starts at p / p emits a
      literal. Positions inside a taken match are neither.
    """
    b, n = is_match.shape
    if not 1 <= seg <= MAX_PARSE_SEG:
        raise ValueError(f"parse segment {seg} outside 1..{MAX_PARSE_SEG}")
    if n % seg:
        raise ValueError(f"row length {n} is not a multiple of seg {seg}")
    if tuple(ml.shape) != (b, n):
        raise ValueError(f"ml shape {tuple(ml.shape)} != {(b, n)}")
    dev = _device(is_match)
    _require(is_match, "is_match", torch.bool, dev)
    _require(ml, "ml", torch.int32, dev)
    if dev < 0:
        return parse_scan_ref(is_match, ml, seg)
    taken = torch.empty_like(is_match)
    lit = torch.empty_like(is_match)
    lanes = b * (n // seg)
    if lanes == 0:
        return taken, lit
    k = _ext or kernels()
    k.parse_scan(is_match.data_ptr(), ml.data_ptr(), taken.data_ptr(),
                 lit.data_ptr(), lanes, seg, k.stream(dev))
    count_launch("parse_scan")
    return taken, lit


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# ---------------------------------------------------------------------------
# k3: Huffman code lookup
# ---------------------------------------------------------------------------

def huffman_lookup_ref(lit_pack: torch.Tensor, dist_pack: torch.Tensor,
                       sym: torch.Tensor, dsym: torch.Tensor):
    """Plain version of :func:`huffman_lookup`: two gathers on the tables
    padded with one zero entry, which every out-of-table symbol reads."""
    b = sym.shape[0]
    z = torch.zeros((b, 1), dtype=torch.int32, device=sym.device)
    lit = torch.cat([lit_pack, z], dim=1)
    dist = torch.cat([dist_pack, z], dim=1)
    si = torch.where((sym >= 0) & (sym < 286), sym, 286).to(torch.int64)
    di = torch.where((dsym >= 0) & (dsym < 30), dsym, 30).to(torch.int64)
    return torch.gather(lit, 1, si), torch.gather(dist, 1, di)


def huffman_lookup(lit_pack: torch.Tensor, dist_pack: torch.Tensor,
                   sym: torch.Tensor, dsym: torch.Tensor):
    """Resolve per-position codes against per-row Huffman tables.

    Args:
      lit_pack:  (B, 286) int32 packed lit/len codes (code | len << 12).
      dist_pack: (B, 30) int32 packed distance codes.
      sym:  (B, n) int32 lit/len symbol; outside [0, 286) reads 0 (286
            marks a position that emits nothing).
      dsym: (B, n) int32 distance symbol; outside [0, 30) reads 0.
    Returns:
      (lpack, dpack): (B, n) int32 table entries per position.
    """
    b, n = sym.shape
    if tuple(dsym.shape) != (b, n):
        raise ValueError(f"dsym shape {tuple(dsym.shape)} != {(b, n)}")
    if tuple(lit_pack.shape) != (b, 286) or tuple(dist_pack.shape) != (b, 30):
        raise ValueError("tables must be (B, 286) and (B, 30)")
    dev = _device(sym)
    _require(lit_pack, "lit_pack", torch.int32, dev)
    _require(dist_pack, "dist_pack", torch.int32, dev)
    _require(sym, "sym", torch.int32, dev)
    _require(dsym, "dsym", torch.int32, dev)
    if dev < 0:
        return huffman_lookup_ref(lit_pack, dist_pack, sym, dsym)
    lout = torch.empty_like(sym)
    dout = torch.empty_like(sym)
    if b == 0 or n == 0:
        return lout, dout
    k = _ext or kernels()
    k.huffman_lookup(lit_pack.data_ptr(), dist_pack.data_ptr(),
                     sym.data_ptr(), dsym.data_ptr(), lout.data_ptr(),
                     dout.data_ptr(), b, n, k.stream(dev))
    count_launch("huffman_lookup")
    return lout, dout


# ---------------------------------------------------------------------------
# k4: symbol histogram
# ---------------------------------------------------------------------------

NBINS = 316       # lit/len symbols 0..285, then distance symbols 286..315
DIST_LO = 284     # the TPU kernel counts dsym over its 32 bins 284..315


def symbol_histogram_ref(sym: torch.Tensor, dsym: torch.Tensor):
    """Plain version of :func:`symbol_histogram`: one bincount over
    ``row * (NBINS + 1) + value``, each row's values that do not count
    sent to the row's own spare bin NBINS."""
    b = sym.shape[0]
    row = torch.arange(b, dtype=torch.int64, device=sym.device)[:, None]
    s_ok = (sym >= 0) & (sym < NBINS)
    d_ok = (dsym >= DIST_LO) & (dsym < NBINS)
    idx = row * (NBINS + 1) + torch.cat([torch.where(s_ok, sym, NBINS),
                                         torch.where(d_ok, dsym, NBINS)], 1)
    counts = torch.bincount(idx.reshape(-1), minlength=b * (NBINS + 1))
    return counts.reshape(b, NBINS + 1)[:, :NBINS].to(torch.int32)


def symbol_histogram(sym: torch.Tensor, dsym: torch.Tensor):
    """Per-row histogram over the 316 deflate symbols.

    Args:
      sym:  (B, n) int32 lit/len symbol; counted in bin ``sym`` when in
            [0, 316), else ignored.
      dsym: (B, n) int32 distance symbol + 286; counted in bin ``dsym``
            when in [284, 316), else ignored.
    Returns:
      (B, 316) int32 counts. Any n is taken.
    """
    b, n = sym.shape
    if tuple(dsym.shape) != (b, n):
        raise ValueError(f"dsym shape {tuple(dsym.shape)} != {(b, n)}")
    dev = _device(sym)
    _require(sym, "sym", torch.int32, dev)
    _require(dsym, "dsym", torch.int32, dev)
    if dev < 0:
        return symbol_histogram_ref(sym, dsym)
    hist = sym.new_zeros((b, NBINS))    # int32 on sym's device
    if b == 0 or n == 0:
        return hist
    k = _ext or kernels()
    k.symbol_histogram(sym.data_ptr(), dsym.data_ptr(), hist.data_ptr(), b,
                       n, k.stream(dev))
    count_launch("symbol_histogram")
    return hist
