"""Device LZ4 block decode: a host parse, then chain resolution on the device.

Counterpart of ``qatzip_tpu/ops/lz4_decode.py``. LZ4 decode's only serial
part is the window copy: a match byte copies an earlier output byte. The
decode splits it in two:

  * the host parses each block into a reference plane (the native
    ``qz_lz4_ref_block``, on the host pool): ``ref[i]`` is the literal
    byte, stored as ``-(byte + 1)``, or the earlier output index that
    position ``i`` copies;
  * the device resolves the copy chains: :func:`resolve_refs`, the hand
    kernel ``lz4_resolve_refs`` (``csrc/lz4_resolve.cu``: rows up to
    65536 wide in shared memory, front to back in chunks, or in the JAX
    rounds when the rounds are too few; wider rows in place in device
    memory), with :func:`resolve_refs_ref` its plain version, the JAX
    function's synchronous pointer-doubling rounds.

The plane costs 4 bytes a decoded byte on the way to the device. Which
leg a decode takes is ``CudaEngine.decodes_on_device``'s choice.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import cuda_pack as cp
from .cuda_pack import _device, _require, count_launch
from ..constants import QZ_DATA_ERROR, QzError

#: most rows a device tile holds; wider rows take fewer, so a tile's plane
#: stays at TILE_B * 65536 references (64 MiB)
TILE_B = 256
TILE_REFS = TILE_B * 65536


def resolve_refs_ref(ref: torch.Tensor, max_rounds: int):
    """Plain version of :func:`resolve_refs`: the JAX function's rounds,
    ``ref = where(ref >= 0, ref[clip(ref)], ref)`` over the whole batch
    while any entry is >= 0, at most ``max_rounds`` of them; ``ref`` gets
    the last round's plane."""
    n = ref.shape[1]
    r = ref
    for _ in range(max_rounds):
        if not bool((r >= 0).any()):
            break
        chased = torch.gather(r, 1, r.clamp(0, max(n - 1, 0)).to(torch.int64))
        r = torch.where(r >= 0, chased, r)
    ref.copy_(r)
    return (~r).to(torch.uint8), (r >= 0).any()


def resolve_refs(ref: torch.Tensor, max_rounds: int):
    """Resolve a (B, n) LZ4 reference plane to its output bytes.

    Args:
      ref: (B, n) int32; ``ref[b, i] < 0`` is the literal ``-(byte + 1)``,
           ``ref[b, i] >= 0`` the output index position i copies (a valid
           plane's indices are all below i, so ``(n - 1).bit_length()``
           doubling rounds resolve it). Its content on return is not
           defined: the plain version leaves the last round's plane, the
           kernel the plane as it was or (wide rows, and rows with a
           forward or self reference) jumped in place.
      max_rounds: the most rounds to run.
    Returns:
      (bytes (B, n) uint8, unresolved: a bool scalar tensor, True when an
      entry is still a reference). Up to n = 65536 the kernel gives the
      plain version's flag for any plane and its byte at every entry that
      resolved; with fewer than max((n - 1).bit_length(),
      (min(n, 16384) - 1).bit_length() + 1) rounds (the decode gives more)
      it runs the plain version's rounds themselves (every byte the same
      unless the plane held an index past the row). Wider rows jump in place: where the plain version resolves
      they give its bytes, and with too few rounds they may resolve where
      it does not.
    """
    if ref.dim() != 2:
        raise ValueError(f"ref must be (B, n), got {tuple(ref.shape)}")
    b, n = ref.shape
    dev = _device(ref)
    _require(ref, "ref", torch.int32, dev)
    if dev < 0:
        return resolve_refs_ref(ref, max_rounds)
    out = torch.empty((b, n), dtype=torch.uint8, device=ref.device)
    flags = torch.zeros((b,), dtype=torch.int32, device=ref.device)
    if b == 0 or n == 0:
        return out, flags.bool().any()
    k = cp._ext or cp.kernels()
    k.lz4_resolve_refs(ref.data_ptr(), out.data_ptr(), flags.data_ptr(), b,
                       n, max(int(max_rounds), 0), k.stream(dev))
    count_launch("lz4_resolve_refs")
    return out, flags.bool().any()


def _row_width(expected_sizes: Sequence[int]) -> int:
    """The next power of two over the largest expected size (at least 1)."""
    n = 1
    for sz in expected_sizes:
        while n < max(sz, 1):
            n <<= 1
    return n


def decode_blocks_device(payloads: Sequence[bytes],
                         expected_sizes: Sequence[int], *,
                         device) -> List[bytes]:
    """Decode a batch of LZ4 blocks, each of at most its expected size,
    with the chains resolved on ``device``.

    Rows are ``n`` wide, the next power of two over the largest expected
    size, padded with -1 (literal 0); ``(n - 1).bit_length() + 1`` rounds,
    as in the JAX package. Rows go to the device in tiles of at most
    TILE_B rows and TILE_REFS references; the next tile's parse on the
    host pool overlaps the device's work on the last. A block the parse
    refuses or that decodes past its expected size, or a chain left
    unresolved, raises QzError(QZ_DATA_ERROR); nothing is decoded again on
    the host."""
    from .. import native
    from ..engines import host_pool
    from ..parallel.dispatch import _to_host
    lib = native.get_lib()
    device = torch.device(device)
    if not len(payloads):
        return []
    n = _row_width(expected_sizes)
    rounds = max((n - 1).bit_length() + 1, 1)
    rows = max(1, min(TILE_B, TILE_REFS // n))
    pinned = device.type == "cuda"
    pending = []
    for start in range(0, len(payloads), rows):
        tile = payloads[start:start + rows]
        host = torch.full((len(tile), n), -1, dtype=torch.int32,
                          pin_memory=pinned)
        refs = host.numpy()

        def parse(i, refs=refs, start=start):
            r = lib.lz4_ref_block(payloads[start + i], refs[i], n)
            if r < 0 or r > expected_sizes[start + i]:
                raise QzError(QZ_DATA_ERROR, "malformed LZ4 block")
            return r
        lens = list(host_pool().map(parse, range(len(tile))))
        got, unresolved = resolve_refs(host.to(device, non_blocking=pinned),
                                       rounds)
        unresolved, _ = _to_host(unresolved)
        pending.append((lens, host, unresolved, *_to_host(got)))
    out: List[bytes] = []
    for lens, _host, unresolved, got, ready in pending:
        if ready is not None:       # recorded after both copies
            ready.synchronize()
        if bool(unresolved):    # a valid plane always resolves
            raise QzError(QZ_DATA_ERROR, "unresolved LZ4 copy chain")
        got = got.numpy()
        out += [got[i, :r].tobytes() for i, r in enumerate(lens)]
    return out

