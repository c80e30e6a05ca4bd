"""Batched CRC32 of whole rows on the device.

Counterpart of ``qatzip_tpu/ops/crc32_mxu.py``, whose name it keeps. The
JAX package takes a tile's CRCs as one GF(2) matrix product on the TPU's
matrix unit: CRC32 is affine, crc(M) = crc(0^n) ^ L(M), and for a fixed
length n the linear part L is an (8n, 32) bit matrix V, so

    counts[B, 32] = bits[B, 8n] @ V[8n, 32]
    crc[B]        = crc(0^n) ^ packbits(counts & 1)

On the H100 the hand kernel ``crc32_rows`` (``csrc/crc32_rows.cu``) runs
that product on the binary tensor cores (mma m16n8k256 .b1, AND and
popcount), reading each byte once: 16 rows and a BLOCK-byte block a CTA,
with V of one block (the same for every block) in the lane layout of
:func:`mma_fragments`, and each block's value moved to the row's end by
a GF(2) shift (zlib's ``crc32_combine``) from :func:`_tails`.
:func:`crc32_batch_ref`, the plain version, is the JAX formulation in
torch (float32, exact while the counts stay <= 2^24, so for n <= 2 MiB).

Rows shorter than n (zero-padded) get the crc of the padded row: the
caller takes the host crc for those.
"""

from __future__ import annotations

import functools
import os
import threading
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from . import cuda_pack as cp
from .cuda_pack import _device, _require, count_launch

_CRC_TABLE = None
_v_cache: Dict[int, np.ndarray] = {}
_v_dev_cache: Dict[Tuple[int, str], torch.Tensor] = {}
_zero_crc_cache: Dict[int, int] = {}
_dev_cache: Dict[Tuple[str, int, str], torch.Tensor] = {}
_lock = threading.Lock()
_forked_away = []


def _forget_after_fork() -> None:
    """In a child made by fork: empty the device-tensor caches and free
    the lock (another thread may have held it). The parent's tensors are
    kept, unused: freeing device memory is a CUDA call, which a child
    forked after CUDA came up cannot make."""
    _lock._at_fork_reinit()
    _forked_away.append((dict(_v_dev_cache), dict(_dev_cache)))
    _v_dev_cache.clear()
    _dev_cache.clear()


os.register_at_fork(after_in_child=_forget_after_fork)

#: bytes of each row a CTA of the kernel takes (csrc/crc32_rows.cu kBlock:
#: 4 warps of four 128-byte steps)
BLOCK = 2048
_POLY = 0xEDB88320


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = np.uint32(0xEDB88320)
        t = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            t = np.where(t & 1, (t >> np.uint32(1)) ^ poly,
                         t >> np.uint32(1))
        _CRC_TABLE = t
    return _CRC_TABLE


def _build_v(n: int) -> np.ndarray:
    """V[i*8+k] = L(bit k of byte i) for an n-byte message: the 8
    single-bit seeds advanced through the trailing zero bytes with the
    (linear) byte-0 crc update."""
    tab = _crc_table()
    seeds = np.zeros(8, np.uint32)
    for k in range(8):
        seeds[k] = tab[(1 << k) & 0xFF] ^ tab[0]
    v = np.empty((n, 8), np.uint32)
    cur = seeds.copy()
    v[n - 1] = cur
    for d in range(1, n):
        cur = (cur >> np.uint32(8)) ^ tab[cur & np.uint32(0xFF)]
        v[n - 1 - d] = cur
    return v.reshape(n * 8, 1)


def _v_bits(n: int) -> np.ndarray:
    """(8n, 32) float32 matrix of V's bits (bit j of each row's value)."""
    with _lock:
        got = _v_cache.get(n)
        if got is not None:
            return got
        v = _build_v(n).reshape(-1)
        bits = ((v[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
                & 1).astype(np.float32)
        _v_cache[n] = bits
        return bits


def _zero_crc(n: int) -> int:
    with _lock:
        got = _zero_crc_cache.get(n)
        if got is None:
            got = zlib.crc32(b"\x00" * n) & 0xFFFFFFFF
            _zero_crc_cache[n] = got
        return got


def _v_on(n: int, device: torch.device) -> torch.Tensor:
    """_v_bits(n) as a float32 tensor on ``device``, kept per device."""
    key = (n, str(device))
    got = _v_dev_cache.get(key)
    if got is None:
        got = torch.from_numpy(_v_bits(n)).to(device)
        with _lock:      # threads that raced here all take the first one
            got = _v_dev_cache.setdefault(key, got)
    return got


def multmodp(a: int, b: int) -> int:
    """a * b mod P in zlib's reflected representation (bit 31 is x^0),
    as the kernel's ``multmodp`` computes it."""
    p = 0
    for i in range(31, -1, -1):
        if (a >> i) & 1:
            p ^= b
        b = (b >> 1) ^ (_POLY if b & 1 else 0)
    return p


def x_pow(e: int) -> int:
    """x^e mod P (reflected), by squaring from x^1."""
    r, sq = 1 << 31, 1 << 30
    while e:
        if e & 1:
            r = multmodp(r, sq)
        sq = multmodp(sq, sq)
        e >>= 1
    return r


@functools.lru_cache(maxsize=None)
def mma_fragments() -> np.ndarray:
    """V of one BLOCK-byte block as the kernel's lanes load it, uint32
    (BLOCK / 128 steps, 32 lanes, 32 words): word (ks * 4 + j) * 2 + r of
    lane 4 g + q at step s holds, at bit i, bit 8 j + g of L(bit i % 8 of
    byte 128 s + 32 q + 8 ks + 4 r + i // 8) over the block; the mma
    pairs it with bit i of that lane's A word of the same bytes."""
    v = _build_v(BLOCK).reshape(BLOCK, 8)
    s, lane, ks, j, r, i = np.meshgrid(
        np.arange(BLOCK // 128), np.arange(32), np.arange(4), np.arange(4),
        np.arange(2), np.arange(32), indexing="ij")
    g, q = lane >> 2, lane & 3
    byte = 128 * s + 32 * q + 8 * ks + 4 * r + i // 8
    bit = (v[byte, i % 8] >> (8 * j + g).astype(np.uint32)) & 1
    words = (bit.astype(np.uint64) << i.astype(np.uint64)).sum(-1)
    out = words.astype(np.uint32).reshape(BLOCK // 128, 32, 32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def _tails(blocks: int) -> np.ndarray:
    """x^(8 BLOCK m) for m < ``blocks``, uint32: the shift that moves a
    block's value past the m blocks after it to its row's end."""
    step, cur = x_pow(8 * BLOCK), 1 << 31
    out = np.zeros(blocks, np.uint32)
    for m in range(blocks):
        out[m] = cur
        cur = multmodp(cur, step)
    out.setflags(write=False)
    return out


def _on(what: str, key: int, device: torch.device) -> torch.Tensor:
    """mma_fragments() (``what`` "frag") or _tails(key) ("tails") as an
    int32 tensor on ``device``, kept per device."""
    ck = (what, key, str(device))
    got = _dev_cache.get(ck)
    if got is None:
        host = mma_fragments() if what == "frag" else _tails(key)
        got = torch.from_numpy(host.view(np.int32).copy()).to(device)
        with _lock:
            got = _dev_cache.setdefault(ck, got)
    return got


def _check(data: torch.Tensor, n: int) -> int:
    if data.dim() != 2 or data.shape[1] != n:
        raise ValueError(f"data must be (B, {n}), got {tuple(data.shape)}")
    dev = _device(data)
    _require(data, "data", torch.uint8, dev)
    return dev


def crc32_batch_ref(data: torch.Tensor, *, n: int) -> torch.Tensor:
    """Plain version of :func:`crc32_batch_device`: the JAX package's
    formulation, the rows' bits (B, 8n) @ V (8n, 32) in float32 (the
    counts are exact for n up to 2 MiB), then parity, packing and
    ^ crc(0^n)."""
    _check(data, n)
    if n > 1 << 21:
        raise ValueError(f"row width {n}: the float32 counts are exact only "
                         "up to 2 MiB")
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data[:, :, None] >> shifts) & 1).reshape(data.shape[0], n * 8)
    counts = bits.to(torch.float32) @ _v_on(n, data.device)
    parity = counts.to(torch.int64) & 1
    weights = torch.ones(32, dtype=torch.int64, device=data.device) << \
        torch.arange(32, dtype=torch.int64, device=data.device)
    return (parity * weights).sum(1) ^ _zero_crc(n)


def crc32_batch_device(data: torch.Tensor, *, n: int) -> torch.Tensor:
    """CRC32 of every row of ``data`` (B, n) uint8, each row whole.

    Returns a (B,) int64 tensor of the uint32 crcs, on ``data``'s device.
    A CUDA tensor goes through the kernel ``crc32_rows``; a CPU tensor
    through :func:`crc32_batch_ref`."""
    dev = _check(data, n)
    if dev < 0:
        return crc32_batch_ref(data, n=n)
    b = data.shape[0]
    out = torch.empty((b,), dtype=torch.int64, device=data.device)
    if b:
        z = _zero_crc(n)
        k = cp._ext or cp.kernels()
        k.crc32_rows(data.data_ptr(), out.data_ptr(),
                     _on("frag", 0, data.device).data_ptr(),
                     _on("tails", -(-n // BLOCK), data.device).data_ptr(),
                     b, n, z - (1 << 32) if z >= 1 << 31 else z,
                     k.stream(dev))
        count_launch("crc32_rows")
    return out
