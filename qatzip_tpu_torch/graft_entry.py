"""Entry points that run the port's tokenizer and mesh functions.

Counterpart of the repository's ``__graft_entry__.py``. ``entry()``
returns the one-device forward step of the flagship compute path, the
batched LZ77 tokenizer (``ops/lz77.py``) that every algorithm (deflate,
LZ4, LZ4s) runs on the device, with its example inputs on the device.

``dryrun_multichip(n)`` runs one chunk-data-parallel step over an
``n``-device mesh (``parallel/mesh.py``) at small shapes: the tokenizer,
the static device pack, and the two dynamic passes with the host tree
build between them, each result checked.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def _example_batch(b: int, n: int):
    rng = np.random.default_rng(42)
    # compressible text-like rows with varying lengths
    base = (b"the quick brown fox jumps over the lazy dog 0123456789 " * 64)
    data = np.zeros((b, n), np.uint8)
    lengths = np.zeros(b, np.int32)
    for i in range(b):
        ln = n if i % 2 == 0 else n // 2
        row = (base * ((ln // len(base)) + 1))[:ln]
        arr = np.frombuffer(row, np.uint8).copy()
        noise_at = rng.integers(0, ln, ln // 16)
        arr[noise_at] = rng.integers(0, 256, ln // 16, dtype=np.uint8)
        data[i, :ln] = arr
        lengths[i] = ln
    return data, lengths


def entry(device="cuda"):
    """Return (fn, example_args): the tokenizer's forward step at n =
    16384 over 4 rows, and its inputs on ``device`` (one device)."""
    from .ops.lz77 import lz77_tokenize
    from .runtime import resolve_device

    dev = resolve_device(device)[0]
    n = 16384
    data, lengths = _example_batch(4, n)

    def forward(data, lengths):
        return lz77_tokenize(data, lengths, n=n, min_match=4, max_match=258,
                             window=32768)

    return forward, (torch.from_numpy(data).to(dev),
                     torch.from_numpy(lengths).to(dev))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run one full chunk-DP step over an ``n_devices`` mesh at n = 2048,
    b = 2 * n_devices, and check it: every row's tokens rebuild the row,
    ``stats[1]`` is the byte count, and stock zlib decodes every static
    and dynamic stream. Returns what ran: the mesh's devices, how many are
    distinct, and whether a card was repeated for want of more."""
    from .ops.deflate_pack import finish_stream, finish_stream_dynamic
    from .ops.lz77 import merge_segment_tokens, tokens_to_bytes
    from .parallel.dispatch import plan_tile
    from .parallel.mesh import (make_mesh, mesh_analyze_hist,
                                mesh_pack_device, mesh_pack_dynamic,
                                mesh_tokenize)
    from .runtime import resolve_device

    # distinct cards where there are that many, else the cards in turn
    # (one card repeated on a one-card machine); the CPU repeated
    cards = resolve_device(device)
    mesh = make_mesh([cards[i % len(cards)] for i in range(n_devices)])
    n = 2048
    b = 2 * n_devices            # leading dim divisible by the mesh size
    data, lengths = _example_batch(b, n)
    rows = [data[i, :lengths[i]].tobytes() for i in range(b)]

    toks, ntok, stats = mesh_tokenize(mesh, data, lengths, n=n)
    assert toks.shape == (b, n) and ntok.shape[0] == b
    assert int(stats[1]) == int(lengths.sum())
    for i in range(b):
        merged = merge_segment_tokens(toks[i], ntok[i], parse_seg=8192)
        assert tokens_to_bytes(merged, len(merged), rows[i]) == rows[i], \
            f"row {i} mismatch"

    # the static device pack over the same mesh
    words, nbits = mesh_pack_device(mesh, data, lengths, n=n)
    for i in range(b):
        stream = finish_stream(words[i], int(nbits[i]), final=True)
        assert zlib.decompressobj(-15).decompress(stream) == rows[i], \
            f"pack row {i}"

    # the dynamic pack's two passes, the host tree build between them on
    # the gathered (B, 316) histograms only
    hist, ml, dist, taken, lit = mesh_analyze_hist(mesh, data, lengths, n=n)
    packs, dpacks, hdrs, hbits = plan_tile(hist, b)
    w2, nb2 = mesh_pack_dynamic(mesh, data, ml, dist, taken, lit, packs,
                                dpacks, hbits, n=n)
    for i in range(b):
        stream = finish_stream_dynamic(w2[i], int(nb2[i]), hdrs[i],
                                       int(packs[i][256]), final=True)
        assert zlib.decompressobj(-15).decompress(stream) == rows[i], \
            f"dyn row {i}"
    distinct = len(set(mesh.devices))
    return {"devices": [str(d) for d in mesh.devices], "distinct": distinct,
            "repeated": distinct < n_devices, "rows": b, "n": n,
            "tokens": int(stats[0]), "bytes": int(stats[1])}
