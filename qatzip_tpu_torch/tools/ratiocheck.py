"""ratiocheck: the compression ratio of a set of tokenizer knobs.

Counterpart of ``tools/ratiocheck.py``. It cuts a corpus into 64 KiB
rows, tokenizes them with the port's ``lz77_tokenize`` on ``--device``
(the same tokens on the card and on the CPU, so the ratio is the same on
both), joins each row's segment tokens, packs each row with the native
deflate packer (mode 0: best of stored, static and dynamic; final),
checks each row with stock zlib, and prints one JSON line: the knobs,
the ratio, zlib level 1's ratio on the same rows and the quotient.

    python -m qatzip_tpu_torch.tools.ratiocheck --ctx 4 --seg 8192 --probes 6
    python -m qatzip_tpu_torch.tools.ratiocheck --corpus strided --device cpu

The engine's own knobs at levels 1-5 are ``--search-seg 8192
--search-overlap 896 --ctx 3 --probes 7``. The JAX tool's
``--search-stride`` is left out, and so is its key in the JSON line: the
port has no ``search_stride=2`` (the stride-2 search was measured and
rejected at -13.6 % ratio in the JAX package). The mixed corpus is
``tools.distrun.make_corpus``; the strided one, ``strided_corpus``, is
the JAX tool's byte for byte. A row that does not decode raises.
"""

from __future__ import annotations

import argparse
import json
import zlib
from typing import List

import numpy as np

N = 65536
# rows tokenized in one call
BATCH = 256


def strided_corpus(mb: int = 8) -> bytes:
    """Fixed-stride records (the round-1 ratio weakness: 333-byte period)."""
    rng = np.random.default_rng(3)
    rec = rng.integers(0, 256, 333, dtype=np.uint8)
    n = (mb << 20) // 333 + 1
    rows = np.tile(rec, (n, 1))
    # per-record mutation: a few fields change
    rows[:, 7] = np.arange(n) & 0xFF
    rows[:, 100] = (np.arange(n) >> 8) & 0xFF
    rows[:, 200] = rng.integers(0, 256, n, dtype=np.uint8)
    return rows.tobytes()[: mb << 20]


def corpus_rows(blob: bytes) -> np.ndarray:
    """The whole 64 KiB rows of ``blob`` as a (b, N) uint8 array."""
    b = len(blob) // N
    return np.frombuffer(blob[:b * N], np.uint8).reshape(b, N)


def row_payloads(data: np.ndarray, *, ctx: int, seg: int, probes: int,
                 search_seg: int, search_overlap: int,
                 device: str) -> List[bytes]:
    """Each row of ``data`` tokenized on ``device`` with these knobs and
    packed by the native deflate packer (mode 0, final), each checked
    with stock zlib."""
    import torch

    from .. import native
    from ..ops.lz77 import lz77_tokenize, merge_segment_tokens
    lib = native.get_lib()
    dev = torch.device(device)
    payloads = []
    for start in range(0, len(data), BATCH):
        rows = data[start:start + BATCH]
        toks, ntok = lz77_tokenize(
            torch.from_numpy(rows.copy()).to(dev),
            torch.full((len(rows),), N, dtype=torch.int32, device=dev),
            n=N, parse_seg=seg, ctx_words=ctx, probes=probes,
            search_seg=search_seg, search_overlap=search_overlap)
        toks = toks.cpu().numpy().view(np.uint32)
        ntok = ntok.cpu().numpy()
        for i, row in enumerate(rows):
            src = row.tobytes()
            t = merge_segment_tokens(toks[i], ntok[i], seg)
            payload = lib.deflate_pack(src, t, len(t), final=True, mode=0)
            if zlib.decompressobj(-15).decompress(payload) != src:
                raise RuntimeError(f"row {start + i} does not decode")
            payloads.append(payload)
    return payloads


def main(argv=None) -> dict:
    """Print the JSON line and return it as a dict."""
    p = argparse.ArgumentParser(prog="ratiocheck",
                                description=__doc__.splitlines()[0])
    p.add_argument("--ctx", type=int, default=4)
    p.add_argument("--seg", type=int, default=8192)
    p.add_argument("--probes", type=int, default=6)
    p.add_argument("--search-seg", type=int, default=0)
    p.add_argument("--search-overlap", type=int, default=1024)
    p.add_argument("--mb", type=int, default=8)
    p.add_argument("--corpus", default="mixed", choices=["mixed", "strided"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="tokenize on the GPU (the default) or the CPU")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("ratiocheck: no CUDA device: pass --device cpu "
                             "to tokenize on the CPU")

    if args.corpus == "strided":
        blob = strided_corpus(args.mb)
    else:
        from .distrun import make_corpus
        blob = make_corpus(args.mb)
    data = corpus_rows(blob)
    b = len(data)
    total = sum(len(x) for x in row_payloads(
        data, ctx=args.ctx, seg=args.seg, probes=args.probes,
        search_seg=args.search_seg, search_overlap=args.search_overlap,
        device=args.device))
    zl = sum(len(zlib.compress(row.tobytes(), 1)) for row in data)
    ours = b * N / total
    zratio = b * N / zl
    line = {
        "corpus": args.corpus, "ctx": args.ctx, "seg": args.seg,
        "probes": args.probes, "search_seg": args.search_seg,
        "search_overlap": args.search_overlap,
        "mb": b * N >> 20,
        "ratio": round(ours, 4), "zlib_l1_ratio": round(zratio, 4),
        "vs_zlib_l1": round(ours / zratio, 4),
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
