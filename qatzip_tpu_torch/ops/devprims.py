"""The primitive probes' kernels, with their plain versions.

Counterparts of the Pallas kernels in ``tools/devprims.py``, which timed
the TPU primitives behind the sort-based Pallas design; the probe tool
``qatzip_tpu_torch/tools/devprims.py`` times these on the card. Sources
in ``qatzip_tpu_torch/csrc/devprims.cu``; each wrapper checks device,
dtype, shape and contiguity, launches on the current stream for CUDA
tensors, raises if the launch was refused, and counts its launches in
``cuda_pack.LAUNCHES``; its plain version (``*_ref``) runs for CPU
tensors only:

  * ``lane_gather`` / ``sublane_gather`` — ``take_along_axis(x, idx,
    axis=1 / 0)`` (``pl_gather.go``);
  * ``roll_sum`` — ``x + sum_k roll(x, k, 1)`` over 128-lane rows
    (``roll_static`` with the shifts 1, 2, 4, ..., 64 fixed at compile
    time; ``roll_dyn`` with shifts read from a device tensor);
  * ``bitonic128`` — the 28-stage bitonic network of ``bitonic_kern`` on
    each 128-lane row, one payload carried (``bitonic``).

32-bit words cross as int32 tensors holding the uint32 bit pattern; the
plain versions widen them to int64 to compare and to add, then mask to 32
bits. Indices are taken modulo the power-of-two extent they index, which
is numpy's wrap for indices in [-extent, extent).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_pack as cp
from .cuda_pack import LAUNCHES  # noqa: F401 (re-exported)
from .cuda_pack import _as_i32, _device, _require, count_launch

MASK32 = 0xFFFFFFFF
WIDTH = 128                         # the roll and sort rows
STATIC_SHIFTS = (1, 2, 4, 8, 16, 32, 64)
MAX_SHIFTS = 32
MAX_GATHER_WIDTH = 8192             # a CTA stages 32 KB of rows


def _log2(n: int, what: str, lo: int, hi: int) -> int:
    if not (lo <= n <= hi and n & (n - 1) == 0):
        raise ValueError(f"{what} {n} must be a power of two in {lo}..{hi}")
    return n.bit_length() - 1


def _pair(a: torch.Tensor, b: torch.Tensor, name_a: str, name_b: str) -> int:
    """The CUDA device index of two contiguous int32 tensors on one device
    (-1: the CPU), in one pass of attribute reads; anything else is
    refused as ``_require`` refuses it, naming the tensor."""
    dev = a.get_device()
    if not (a.dtype is torch.int32 and b.dtype is torch.int32
            and b.get_device() == dev and a.is_contiguous()
            and b.is_contiguous() and (dev >= 0 or a.is_cpu)):
        _require(a, name_a, torch.int32, _device(a))
        _require(b, name_b, torch.int32, dev)
    return dev


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------

def lane_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lane_gather`: advanced indexing."""
    rows, c = x.shape
    r = torch.arange(rows, device=x.device)[:, None]
    return x[r, (idx & (c - 1)).to(torch.int64)]


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, c] = x[r, idx[r, c] mod C]``.

    Args:
      x:   (R, C) int32 words, C a power of two in 4..8192.
      idx: (R, C) int32 indices.
    Returns:
      (R, C) int32.
    """
    shape = x.shape
    rows, c = shape
    log_c = _log2(c, "row width", 4, MAX_GATHER_WIDTH)
    if idx.shape != shape:
        raise ValueError(f"idx shape {tuple(idx.shape)} != {(rows, c)}")
    dev = _pair(x, idx, "x", "idx")
    if dev < 0:
        return lane_gather_ref(x, idx)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    k = cp._ext or cp.kernels()
    k.lane_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, log_c,
                  k.stream(dev))
    count_launch("lane_gather")
    return out


def sublane_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sublane_gather`: advanced indexing."""
    rows, c = x.shape
    col = torch.arange(c, device=x.device)[None, :]
    return x[(idx & (rows - 1)).to(torch.int64), col]


def sublane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, c] = x[idx[r, c] mod R, c]``.

    Args:
      x:   (R, C) int32 words, R and C powers of two, R * C < 2**31.
      idx: (R, C) int32 indices.
    Returns:
      (R, C) int32.
    """
    shape = x.shape
    rows, c = shape
    if rows & (rows - 1) or c & (c - 1) or not 0 < rows * c <= 1 << 30:
        raise ValueError(f"plane ({rows}, {c}): R and C must be powers of "
                         "two, R * C at most 2**30")
    if idx.shape != shape:
        raise ValueError(f"idx shape {tuple(idx.shape)} != {(rows, c)}")
    dev = _pair(x, idx, "x", "idx")
    if dev < 0:
        return sublane_gather_ref(x, idx)
    out = torch.empty_like(x)
    k = cp._ext or cp.kernels()
    k.sublane_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                     rows.bit_length() - 1, c.bit_length() - 1,
                     k.stream(dev))
    count_launch("sublane_gather")
    return out


# ---------------------------------------------------------------------------
# lane rolls
# ---------------------------------------------------------------------------

def roll_sum_ref(x: torch.Tensor,
                 shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`roll_sum`: each roll as two slices joined,
    summed in int64 and masked to 32 bits."""
    ks = STATIC_SHIFTS if shifts is None else shifts.tolist()
    x64 = x.to(torch.int64) & MASK32
    acc = x64.clone()
    for k in ks:
        k &= WIDTH - 1
        acc += torch.cat([x64[:, WIDTH - k:], x64[:, :WIDTH - k]], 1)
    return _as_i32(acc & MASK32)


def roll_sum(x: torch.Tensor,
             shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + sum_k roll(x, k, 1)`` over 128-lane rows, wrapping mod 2**32,
    with ``roll(x, k, 1)[c] = x[(c - k) mod 128]`` (``jnp.roll``).

    Args:
      x:      (R, 128) int32 words.
      shifts: None for the shifts 1, 2, 4, ..., 64, compiled into the
              kernel; or a (S,) int32 tensor on x's device, 1 <= S <= 32,
              read by the kernel at run time (taken mod 128).
    Returns:
      (R, 128) int32.
    """
    rows, w = x.shape
    if w != WIDTH:
        raise ValueError(f"rows must be {WIDTH} wide, got {w}")
    if shifts is None:
        nshift = 0
        dev = _device(x)
        _require(x, "x", torch.int32, dev)
    else:
        nshift = shifts.numel()
        if shifts.dim() != 1 or not 1 <= nshift <= MAX_SHIFTS:
            raise ValueError(f"shifts must be 1..{MAX_SHIFTS} values")
        dev = _pair(x, shifts, "x", "shifts")
    if dev < 0:
        return roll_sum_ref(x, shifts)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    k = cp._ext or cp.kernels()
    k.roll_sum(x.data_ptr(), 0 if shifts is None else shifts.data_ptr(),
               nshift, out.data_ptr(), rows, k.stream(dev))
    count_launch("roll_sum")
    return out


# ---------------------------------------------------------------------------
# the 128-lane bitonic sort
# ---------------------------------------------------------------------------

def _partner(t: torch.Tensor, j: int) -> torch.Tensor:
    """Column c ^ j of every 128-lane row of ``t``."""
    rows = t.shape[0]
    return t.reshape(rows, WIDTH // (2 * j), 2, j).flip(2).reshape(rows, WIDTH)


def bitonic128_ref(keys: torch.Tensor, vals: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bitonic128`: the same 28 compare-exchange
    stages on int64 keys, the partner of column c (c ^ j) by flipping
    the halves of each 2j-column group. Not a stable sort: on equal keys
    the payloads follow the network."""
    k = keys.to(torch.int64) & MASK32
    v = vals
    c = torch.arange(WIDTH, device=keys.device)
    size = 2
    while size <= WIDTH:
        j = size >> 1
        while j >= 1:
            pk, pv = _partner(k, j), _partner(v, j)
            take_min = ((c & j) == 0) == ((c & size) == 0)
            swap = torch.where(take_min, pk < k, pk > k)
            k = torch.where(swap, pk, k)
            v = torch.where(swap, pv, v)
            j >>= 1
        size <<= 1
    return _as_i32(k), v


def bitonic128(keys: torch.Tensor, vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each 128-lane row of uint32 keys ascending with the 28-stage
    bitonic network of the TPU probe, carrying one payload word.

    Args:
      keys: (R, 128) int32 holding uint32 keys.
      vals: (R, 128) int32 payload words.
    Returns:
      (keys, vals) sorted, (R, 128) int32 each.
    """
    rows, w = keys.shape
    if w != WIDTH or vals.shape != keys.shape:
        raise ValueError(f"keys and vals must be (R, {WIDTH})")
    dev = _pair(keys, vals, "keys", "vals")
    if dev < 0:
        return bitonic128_ref(keys, vals)
    kout = torch.empty_like(keys)
    vout = torch.empty_like(vals)
    if rows == 0:
        return kout, vout
    k = cp._ext or cp.kernels()
    k.bitonic128(keys.data_ptr(), vals.data_ptr(), kout.data_ptr(),
                 vout.data_ptr(), rows, k.stream(dev))
    count_launch("bitonic128")
    return kout, vout
