"""The closed-loop generator (``"generator": "closed"``): each of
``clients`` threads sends its next request when the previous one has
returned, as callers that each wait for a reply do.

Keys of a mix file besides ``generator``:

* ``clients``: client threads, each with a session of its own (QATzip's
  session per thread);
* ``request_bytes``: the size of every request;
* ``buffers``, ``buffer_bytes``: the pool, ``buffers`` distinct buffers of
  the Silesia-like mix (``corpus.silesia_like``) made from the seed; a
  request is a ``request_bytes`` slice of a buffer at a multiple of
  ``request_bytes``;
* ``order``: ``"round_robin"`` (the pool's slices in turn) or
  ``"seeded"``: the slices in blocks of ``block`` (a power of two), each
  block taken in bit-reversed order, which spreads consecutive requests
  over the whole block, and each ``group`` consecutive requests of that
  order shuffled with the seed. One sequence serves all clients: client c
  takes its requests c, c + clients, ... and starts again at its end.
  With 64 KiB slices a block of 64 is one 4 MiB unit of the corpus, whose
  parts fill fixed shares of it (text, JSON and structs a quarter each,
  runs and noise an eighth), so every 8 consecutive requests hold the
  mix: a window's ratio does not hang on where its last request falls.

Every seed gives the same sizes and the same number of slices; only the
bytes and the order change.
"""

from __future__ import annotations

import itertools
import random
from typing import Dict, Iterator, List, Optional, Tuple

from .. import corpus

KEYS = {"clients", "request_bytes", "buffers", "buffer_bytes", "order"}


def check(spec: Dict) -> None:
    missing = KEYS - set(spec)
    if missing:
        raise ValueError(f"traffic mix lacks {sorted(missing)}")
    if spec["order"] not in ("round_robin", "seeded"):
        raise ValueError(f"unknown order {spec['order']!r}")
    r, b = spec["request_bytes"], spec["buffer_bytes"]
    if spec["order"] == "seeded":
        blk, grp = spec.get("block", 0), spec.get("group", 0)
        if not (blk >= 1 and blk & (blk - 1) == 0 and (b // r) % blk == 0
                and grp >= 1):
            raise ValueError("a seeded order needs a power-of-two block "
                             "that divides a buffer's slices, and a group")
    if not (0 < r <= b and b % r == 0 and spec["clients"] >= 1
            and spec["buffers"] >= 1):
        raise ValueError("request_bytes must divide buffer_bytes, and "
                         "clients and buffers be positive")


class Traffic:
    """The requests of one run: the pool made from ``seed`` and each
    client's order over its slices. ``slices[k]`` is the bytes of slice
    ``k``; a client's requests are slice numbers."""

    def __init__(self, spec: Dict, seed: int):
        check(spec)
        self.spec = spec
        r, b = spec["request_bytes"], spec["buffer_bytes"]
        per = b // r
        self.slices: List[bytes] = []
        for i in range(spec["buffers"]):
            buf = corpus.silesia_like(b, f"{seed}:{i}")
            self.slices += ([buf] if per == 1 else
                            [buf[o:o + r] for o in range(0, b, r)])
        n = len(self.slices)
        seq = list(range(n))
        if spec["order"] == "seeded":
            rnd = random.Random(f"{seed}:order")
            blk, grp = spec["block"], spec["group"]
            bits = blk.bit_length() - 1
            rev = [int(f"{i:0{bits}b}"[::-1], 2) if bits else 0
                   for i in range(blk)]
            seq = [o + r for o in range(0, n, blk) for r in rev]
            for o in range(0, n, grp):
                part = seq[o:o + grp]
                rnd.shuffle(part)
                seq[o:o + grp] = part
        c = spec["clients"]
        self.orders = [seq[j::c] or [seq[j % n]] for j in range(c)]

    @property
    def clients(self) -> int:
        return self.spec["clients"]

    def schedule(self, client: int) -> Iterator[Tuple[int, bytes,
                                                      Optional[float]]]:
        """The client's requests, each sent when the previous returns."""
        for k in itertools.cycle(self.orders[client]):
            yield k, self.slices[k], None

    def warmup(self, client: int) -> bytes:
        """A request of the mix's size for set-up: the client's last slice
        in its order, which the window reaches last."""
        return self.slices[self.orders[client][-1]]
