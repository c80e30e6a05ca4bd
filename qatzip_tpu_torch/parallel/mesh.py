"""Chunk-data-parallel dispatch over several torch devices.

Counterpart of ``qatzip_tpu/parallel/mesh.py``. The reference's only
parallelism is data-parallel over independent chunks and hardware
instances (src/qatzip.c:716-729). The JAX package shards a chunk batch
on its leading axis over a 1-D ``dp`` mesh (``P("dp")``); here a
``Mesh`` is a tuple of torch devices (one may repeat) and the batch is
dealt the same way: with b rows over k devices, device d takes rows
``[d * b / k, (d + 1) * b / k)``, runs the port's own ops on them, and
the results are gathered in row order. Nothing is compiled, so nothing
is cached per mesh.

On CUDA each shard runs on a host thread of its own, inside its device's
context and on a stream of its own, so launches on different devices (or
on one card twice over) do not wait for each other's host work; CPU
shards run one after another.
Rows are independent: which device ran which rows changes no byte.

All three device compress paths shard: the tokenizer, the static device
pack, and the two passes of the dynamic device pack (histograms and
trees are per row; the host tree build between the passes sees the
gathered (B, 316) histograms, and pass 1's planes stay on their shard's
device for pass 2). The JAX package's only collective, the sum of two
stats, is a sum of the shards' partial sums on the host.
"""

from __future__ import annotations

import concurrent.futures as _fut
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.deflate_pack import (deflate_analyze_hist, deflate_pack_device,
                                deflate_pack_dynamic)
from ..ops.lz77 import lz77_tokenize


class Mesh:
    """A 1-D chunk-DP mesh: a tuple of torch devices and the axis name."""

    def __init__(self, devices, axis: str = "dp"):
        self.devices = tuple(torch.device(d) for d in devices)
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh takes one or more devices of one "
                             f"kind, not {self.devices}")
        self.axis = axis
        self._lock = threading.Lock()
        self._pool = None
        self._streams = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def map(self, fn, items: Sequence) -> List:
        """``fn(device, item)`` for item i on shard i (at most ``size``
        items), all at once: one host thread a shard, inside its device's
        context and on the shard's own CUDA stream. Returns the results in
        shard order once every shard is done; raises the first shard's
        error. CPU shards run one after another on the calling thread:
        they share the host's cores, over which torch already spreads
        each op (concurrent ops only contend for them)."""
        if len(items) > self.size:
            raise ValueError(f"{len(items)} shards for {self.size} devices")
        if self.devices[0].type == "cpu":
            return [fn(d, item) for d, item in zip(self.devices, items)]
        with self._lock:
            if self._pool is None:
                self._pool = _fut.ThreadPoolExecutor(
                    self.size, thread_name_prefix="qz-mesh")
                self._streams = [torch.cuda.Stream(d) for d in self.devices]
        futures = [self._pool.submit(self._run, i, fn, item)
                   for i, item in enumerate(items)]
        _fut.wait(futures)
        return [f.result() for f in futures]

    def _run(self, i: int, fn, item):
        dev = self.devices[i]
        with torch.cuda.device(dev), torch.cuda.stream(self._streams[i]):
            out = fn(dev, item)
            # the results are read on other threads and streams
            self._streams[i].synchronize()
            return out


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    """A 1-D chunk-DP mesh over every visible CUDA device, or over
    ``devices`` (a list of torch devices or names; one may repeat).
    Raises QZ_NOSW_NO_HW where a CUDA device is missing."""
    from ..runtime import resolve_device
    return Mesh(resolve_device("cuda" if devices is None else list(devices)),
                axis)


class Sharded:
    """A (B, ...) array dealt over a mesh in contiguous row blocks:
    ``shards[d]`` holds rows ``[d * B / k, (d + 1) * B / k)`` on the mesh's
    device d (the JAX package's ``P("dp")``). ``np.asarray`` gathers it
    in row order."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = tuple(shards)

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([s.cpu().numpy() for s in self.shards])
        return out if dtype is None else out.astype(dtype)


def _deal(mesh: Mesh, x) -> List:
    """``x``'s rows dealt over the mesh: a ``Sharded`` array's own shards
    (on the mesh's devices), else k contiguous blocks of its rows on the
    host. The leading dimension must divide by the mesh size, as JAX's
    sharding requires."""
    if isinstance(x, Sharded):
        if len(x.shards) != mesh.size or any(
                s.device != d for s, d in zip(x.shards, mesh.devices)):
            raise ValueError("the array is sharded over another mesh")
        return list(x.shards)
    x = np.asarray(x)
    b = x.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} rows does not divide over "
                         f"{mesh.size} devices")
    s = b // mesh.size
    return [x[d * s:(d + 1) * s] for d in range(mesh.size)]


def _on(dev: torch.device, x, dtype=None) -> torch.Tensor:
    """A shard on ``dev``: a tensor as it is, a host block copied over."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x if dtype is None else x.astype(dtype))
    return torch.from_numpy(a).to(dev)


def _gather(parts: Sequence[torch.Tensor]) -> np.ndarray:
    return np.concatenate([p.cpu().numpy() for p in parts])


def _words(parts: Sequence[torch.Tensor]) -> np.ndarray:
    """Int32 word shards gathered as the uint32 bit patterns."""
    return _gather(parts).view(np.uint32)


def mesh_tokenize(mesh: Mesh, data: np.ndarray, lengths: np.ndarray, *,
                  n: int, min_match: int = 4, max_match: int = 258,
                  window: int = 32768, search_seg: int = 0,
                  search_overlap: int = 1024, ctx_words: int = 4,
                  probes: int = 6,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize a chunk batch dealt over the mesh. Returns numpy (tokens
    (B, n) uint32, ntok (B,) int32, stats [sum(ntok), sum(lengths)]).

    The batch's leading dim must be divisible by the mesh size (pad with
    empty chunks, lengths 0, to round up). As in the JAX package, the
    tokens come back uncompacted (no ``compact_seg``) with the default
    ``parse_seg``."""
    def step(dev, shard):
        dd, ll = _on(dev, shard[0]), _on(dev, shard[1], np.int32)
        toks, ntok = lz77_tokenize(dd, ll, n=n, min_match=min_match,
                                   max_match=max_match, window=window,
                                   search_seg=search_seg,
                                   search_overlap=search_overlap,
                                   ctx_words=ctx_words, probes=probes)
        # the shard's part of the stats (JAX: a psum over dp)
        part = torch.stack([ntok.sum(), ll.sum()])
        return toks.cpu(), ntok.cpu(), part.cpu()

    parts = mesh.map(step, list(zip(_deal(mesh, data), _deal(mesh, lengths))))
    stats = np.sum([p[2].numpy() for p in parts], axis=0).astype(np.int32)
    return (_words([p[0] for p in parts]), _gather([p[1] for p in parts]),
            stats)


def mesh_pack_device(mesh: Mesh, data: np.ndarray, lengths: np.ndarray, *,
                     n: int, search_seg: int = 0, search_overlap: int = 1024,
                     ctx_words: int = 4, probes: int = 6,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The static-Huffman device pack dealt over the mesh: numpy (words
    (B, max_words) uint32, nbits (B,) int32). The batch's leading dim
    must be divisible by the mesh size."""
    def step(dev, shard):
        words, nbits = deflate_pack_device(
            _on(dev, shard[0]), _on(dev, shard[1], np.int32), n=n,
            search_seg=search_seg, search_overlap=search_overlap,
            ctx_words=ctx_words, probes=probes)
        return words.cpu(), nbits.cpu()

    parts = mesh.map(step, list(zip(_deal(mesh, data), _deal(mesh, lengths))))
    return _words([p[0] for p in parts]), _gather([p[1] for p in parts])


def mesh_analyze_hist(mesh: Mesh, data: np.ndarray, lengths: np.ndarray, *,
                      n: int, search_seg: int = 0,
                      search_overlap: int = 1024, ctx_words: int = 4,
                      probes: int = 6):
    """Dynamic pass 1 dealt over the mesh. Returns (hist (B, 316) int32
    numpy, ml, dist, taken, lit): the parse planes stay ``Sharded`` on
    their devices for pass 2; only the histograms go to the host."""
    def step(dev, shard):
        hist, *planes = deflate_analyze_hist(
            _on(dev, shard[0]), _on(dev, shard[1], np.int32), n=n,
            search_seg=search_seg, search_overlap=search_overlap,
            ctx_words=ctx_words, probes=probes)
        return hist.cpu(), planes

    parts = mesh.map(step, list(zip(_deal(mesh, data), _deal(mesh, lengths))))
    return (_gather([p[0] for p in parts]),
            *(Sharded([p[1][j] for p in parts]) for j in range(4)))


def mesh_pack_dynamic(mesh: Mesh, data, ml, dist, taken, lit, lit_pack,
                      dist_pack, hdr_bits, *, n: int):
    """Dynamic pass 2 dealt over the mesh: pass 1's ``Sharded`` planes on
    their devices, the batch (host or ``Sharded``) and the per-row trees
    (``native.dyn_plan``'s ``revcode | len << 12`` tables, any integer
    dtype) dealt with it. Returns numpy (words (B, max_words) uint32,
    nbits (B,) int32 without the EOB)."""
    def step(dev, shard):
        dd, *planes = shard[:5]
        lp, dp, hb = shard[5:]
        words, nbits = deflate_pack_dynamic(
            _on(dev, dd), *planes, _on(dev, lp, np.int32),
            _on(dev, dp, np.int32), _on(dev, hb, np.int32), n=n)
        return words.cpu(), nbits.cpu()

    dealt = [_deal(mesh, x) for x in (data, ml, dist, taken, lit, lit_pack,
                                      dist_pack, hdr_bits)]
    parts = mesh.map(step, list(zip(*dealt)))
    return _words([p[0] for p in parts]), _gather([p[1] for p in parts])
