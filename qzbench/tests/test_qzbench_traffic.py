"""The closed-loop traffic generator: the same seed gives the same
requests, another seed other bytes in the same sizes and mix; and a mix
finds its generator by name."""

import itertools
import zlib

from qzbench import corpus, traffic
from qzbench.traffic import closed

SPEC = {"generator": "closed", "clients": 3, "request_bytes": 65536, "buffers": 2,
        "buffer_bytes": 262144, "order": "seeded", "block": 4,
        "group": 2}


def test_same_seed_same_requests_other_seed_other_bytes():
    a, b = traffic.make(SPEC, 2**40 + 3), traffic.make(SPEC, 2**40 + 3)
    c = traffic.make(SPEC, 2**40 + 4)
    assert isinstance(a, closed.Traffic)
    assert a.slices == b.slices and a.orders == b.orders
    assert all(x != y for x, y in zip(a.slices, c.slices))
    assert [len(s) for s in a.slices] == [len(s) for s in c.slices] == [65536] * 8
    # one sequence dealt to the clients; each block of 4 slices in its
    # bit-reversed order, shuffled in groups of 2
    seq = [k for i in range(3) for k in a.orders[i]]
    assert sorted(seq) == list(range(8))
    flat = [a.orders[i % 3][i // 3] for i in range(8)]
    assert sorted(flat[:4]) == [0, 1, 2, 3] and sorted(flat[4:]) == [4, 5, 6, 7]
    assert a.orders != c.orders or a.orders != traffic.make(SPEC, 7).orders


def test_orders_and_warmup():
    rr = traffic.make(dict(SPEC, order="round_robin", clients=2), 5)
    assert rr.orders == [[0, 2, 4, 6], [1, 3, 5, 7]]
    got = list(itertools.islice(rr.schedule(1), 5))
    assert [k for k, _, _ in got] == [1, 3, 5, 7, 1]
    assert all(d is rr.slices[k] and at is None for k, d, at in got)
    bulk = traffic.make(dict(SPEC, clients=1, request_bytes=262144,
                                order="round_robin"), 5)
    assert len(bulk.slices) == 2 and len(bulk.slices[0]) == 262144
    assert bulk.warmup(0) is bulk.slices[1]


def test_every_eight_requests_hold_the_mix():
    """In a 4 MiB unit of 64 KiB slices, the corpus's parts fill slices
    0-15 (text), 16-31 (JSON), 32-47 (structs), 48-55 (runs), 56-63
    (noise): every 8 consecutive requests take 2, 2, 2, 1, 1 of them."""
    spec = dict(SPEC, clients=4, buffers=1, buffer_bytes=4 << 20,
                block=64, group=8)
    t = traffic.make(spec, 99)
    seq = [t.orders[i % 4][i // 4] for i in range(64)]
    for g in range(0, 64, 8):
        parts = sorted(k // 16 if k < 48 else 3 + (k >= 56)
                       for k in seq[g:g + 8])
        assert parts == [0, 0, 1, 1, 2, 2, 3, 4]


def test_the_mix_compresses_alike_across_seeds():
    """Every seed's buffer holds the same mix: zlib's ratio on two seeds'
    4 MiB units differs by under 2 %."""
    r = [len(u) / len(zlib.compress(u, 1)) for u in
         (corpus.silesia_like(4 << 20, k) for k in ("1:0", "2:0"))]
    assert abs(r[0] / r[1] - 1) < 0.02


def test_checked_specs():
    import pytest
    for bad in ({**SPEC, "order": "random"}, {**SPEC, "request_bytes": 3},
                {**SPEC, "block": 0}, {**SPEC, "block": 3},
                {k: v for k, v in SPEC.items() if k != "group"},
                {k: v for k, v in SPEC.items() if k != "clients"},
                {**SPEC, "generator": "nonesuch"},
                {k: v for k, v in SPEC.items() if k != "generator"}):
        with pytest.raises(ValueError):
            traffic.check(bad)
