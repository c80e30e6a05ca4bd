"""The Silesia-like corpus, made from a seed.

A frozen copy of ``tests/corpus.py`` at commit 0cd1e03 (``text_like``,
``json_like``, ``binary_structs``, ``runs``, ``noise`` and
``make_silesia_like``), with one change: each part's generator is seeded
from a key (``"<seed>:<buffer>:<part>"``) instead of a fixed number, so
every ``--seed`` gives other bytes in the same mix: text-like words, JSON
records, binary structs, byte runs and incompressible noise, in the same
proportions. The Silesia corpus itself is not in the repository.
"""

from __future__ import annotations

import json
import random
import struct

WORDS = ("the quick brown fox jumps over lazy dog compression ratio "
         "throughput deflate huffman entropy stream buffer chunk "
         "hardware device kernel vector lane systolic matrix").split()


def text_like(n: int, seed) -> bytes:
    rnd = random.Random(seed)
    out = []
    total = 0
    while total < n:
        w = rnd.choice(WORDS)
        out.append(w)
        total += len(w) + 1
    return (" ".join(out))[:n].encode()


def json_like(n: int, seed) -> bytes:
    rnd = random.Random(seed)
    recs = []
    total = 0
    i = 0
    while total < n:
        rec = {"id": i, "user": f"user_{rnd.randrange(1000)}",
               "score": rnd.random(), "tags": ["a", "b", "c"][: rnd.randrange(4)],
               "active": bool(rnd.getrandbits(1))}
        s = json.dumps(rec)
        recs.append(s)
        total += len(s) + 1
        i += 1
    return ("\n".join(recs))[:n].encode()


def binary_structs(n: int, seed) -> bytes:
    rnd = random.Random(seed)
    out = bytearray()
    while len(out) < n:
        out += struct.pack("<IHHd", rnd.randrange(1 << 20), rnd.randrange(500),
                           rnd.randrange(16), rnd.random() * 100)
    return bytes(out[:n])


def runs(n: int, seed) -> bytes:
    rnd = random.Random(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([rnd.randrange(256)]) * rnd.randrange(1, 400)
    return bytes(out[:n])


def noise(n: int, seed) -> bytes:
    rnd = random.Random(seed)
    return rnd.randbytes(n)


def silesia_like(total: int, key: str) -> bytes:
    """``total`` bytes of ``make_silesia_like``'s mix, its parts seeded
    from ``key``: a 4 MiB unit (1 MiB each of text, JSON and structs, 512
    KiB each of runs and noise), repeated with each repetition rotated a
    little so that no chunk repeats another."""
    mb = 1024 * 1024
    unit = (text_like(mb, f"{key}:text") + json_like(mb, f"{key}:json")
            + binary_structs(mb, f"{key}:binary") + runs(mb // 2, f"{key}:runs")
            + noise(mb // 2, f"{key}:noise"))
    reps = max(1, -(-total // len(unit)))
    parts = []
    for i in range(reps):
        parts.append(unit[i % 4096:] + unit[: i % 4096])
    return b"".join(parts)[:total]
