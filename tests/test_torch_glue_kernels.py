"""The plain versions of the tokenizer's and the dynamic pack's stage
kernels against the JAX package's stages, on the CPU.

Three CUDA kernels take the stages that the JAX package left to XLA
between its kernels: ``search_inputs`` (the hashed context cut into the
candidate search's windows), ``parse_inputs`` (the saturation-doubling
extension, the clamp, the lazy demotion, the parse-segment trim and the
LZ4 end rules) and ``symbol_planes`` (the dynamic pack's symbol planes of
both passes). On the CPU each wrapper runs its plain version, which must
give what the JAX package's stage gives on the same numpy inputs:

  * the key and context words that JAX's ``_analyze`` hands its first
    sort (recorded by a stand-in for ``jax.lax.sort``), whole rows and
    overlapped windows, on ragged rows;
  * ``_extend_matches`` and the rest of ``_analyze_tail`` up to the parse
    (its ``ml`` and ``dist``), DEFLATE's and LZ4's rules, max_match 258,
    273 and 32767;
  * ``_len_symbol`` / ``_dist_symbol``, and the planes built from them.
"""

import ctypes
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qatzip_tpu.ops import deflate_pack as jdp
from qatzip_tpu.ops import lz77 as jlz
from qatzip_tpu_torch.ops import cuda_pack
from qatzip_tpu_torch.ops import deflate_pack as dp
from qatzip_tpu_torch.ops import lz77 as tlz

from tests.corpus import json_like, text_like
from tests.reference_native import one_intra_op_thread


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Give what this module held back to the system when it ends (JAX
    keeps every compiled program, glibc freed pages)."""
    with one_intra_op_thread():
        yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


#: ragged row lengths: empty, shorter than a hash word, the LZ4 end
#: rules' edges, and full rows
LENGTHS = (0, 1, 3, 4, 11, 12, 13, -1, 0)
KINDS = ("random", "zero", "A", "periodic", "corpus")


def rows(kind: str, n: int, seed: int = 0):
    """(data, lengths) numpy: nine rows of ``kind``, zeroed past the
    ragged ``LENGTHS`` (-1: n - 1, 0 at the end: n)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        data = rng.integers(0, 256, (len(LENGTHS), n), dtype=np.uint8)
    elif kind == "zero":
        data = np.zeros((len(LENGTHS), n), np.uint8)
    elif kind == "A":
        data = np.full((len(LENGTHS), n), 65, np.uint8)
    elif kind == "periodic":
        unit = rng.integers(0, 256, 37, dtype=np.uint8)
        data = np.tile(unit, (len(LENGTHS), n // 37 + 1))[:, :n].copy()
    elif kind == "corpus":
        data = np.stack([np.frombuffer(
            (text_like if i % 2 else json_like)(n + 64, seed=i)[:n],
            np.uint8) for i in range(len(LENGTHS))])
    else:
        raise ValueError(kind)
    lengths = np.array([n if ln == 0 and i else n - 1 if ln == -1 else ln
                        for i, ln in enumerate(LENGTHS)], np.int32)
    for i, ln in enumerate(lengths):
        data[i, ln:] = 0
    return np.ascontiguousarray(data), lengths


def jax_search_operands(monkeypatch, data, lengths, *, n, ctx_words,
                        search_seg, search_overlap):
    """The (key, *ctx) operands that JAX's ``_analyze`` hands its first
    sort, as numpy uint32: one program whose sort is a stand-in that keeps
    its operands, and whose tail returns them."""
    kept = []

    def sort(operands, *args, **kwargs):
        if isinstance(operands, tuple):
            kept.append(operands)
        return operands
    monkeypatch.setattr(jax.lax, "sort", sort)
    monkeypatch.setattr(jlz, "_analyze_tail", lambda *a, **k: kept[0])
    out = jax.jit(lambda d, ln: jlz._analyze(
        d, ln, n=n, min_match=4, max_match=258, window=32768,
        parse_seg=min(8192, n), ctx_words=ctx_words, probes=1,
        search_seg=search_seg, search_overlap=search_overlap,
        pallas="scatter"))(jnp.asarray(data), jnp.asarray(lengths))
    monkeypatch.undo()
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("n,search_seg,overlap,ctx_words", [
    (256, 0, 0, 4), (4096, 0, 0, 3), (4096, 1024, 200, 3),
    (16384, 8192, 896, 3), (8192, 0, 0, 4)])
@pytest.mark.parametrize("kind", KINDS)
def test_search_inputs_plain_matches_jax_layout(monkeypatch, kind, n,
                                                search_seg, overlap,
                                                ctx_words):
    data, lengths = rows(kind, n)
    want = jax_search_operands(monkeypatch, data, lengths, n=n,
                               ctx_words=ctx_words, search_seg=search_seg,
                               search_overlap=overlap)
    before = dict(cuda_pack.LAUNCHES)
    key, ctx, _pbits, ov = tlz._search_inputs(
        torch.from_numpy(data), torch.from_numpy(lengths), n=n,
        min_match=4, window=32768, ctx_words=ctx_words,
        search_seg=search_seg, search_overlap=overlap)
    assert cuda_pack.LAUNCHES == before       # the plain version ran
    assert ov == (overlap if search_seg else 0)
    assert np.array_equal(key.numpy().view(np.uint32), want[0])
    assert len(want) == 1 + ctx_words
    for c in range(ctx_words):
        assert np.array_equal(ctx[c].numpy().view(np.uint32), want[1 + c])


def _raw_candidates(data, lengths, *, n, ctx_words, search_seg, overlap):
    """The raw candidates of the port's search (plain versions): the
    kernel's window words and the same in row order (ml, dist)."""
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
    if not 0 < search_seg < n and n > tlz.MAX_WINDOW:
        ml, dist = tlz._full_row_search(d, ln, n=n, min_match=4,
                                        window=32768, ctx_words=ctx_words,
                                        probes=6)
        return None, ml, dist
    key, ctx, pbits, ov = tlz._search_inputs(
        d, ln, n=n, min_match=4, window=32768, ctx_words=ctx_words,
        search_seg=search_seg, search_overlap=overlap)
    kv = cuda_pack.candidate_search_ref(key, ctx, probes=7, min_match=4,
                                        pbits=pbits)
    rowkv = tlz._unwindow(kv, d.shape[0], n, ov)
    return (kv, ov), (rowkv >> 13) & 0x1F, (rowkv & 0x1FFF) + 1


@pytest.mark.parametrize("lz4_rules,max_match,ctx_words", [
    (False, 258, 3), (True, 273, 4), (True, 32767, 4), (False, 32767, 3)],
    ids=["deflate", "lz4-device-pack", "lz4-token", "lz4s-token"])
@pytest.mark.parametrize("n,search_seg", [(4096, 0), (16384, 8192),
                                          (16384, 0)])
def test_parse_inputs_plain_matches_jax(monkeypatch, lz4_rules, max_match,
                                        ctx_words, n, search_seg):
    """``parse_inputs`` on the CPU, from the window words and from row
    order, against JAX's ``_analyze_tail`` (extension, clamp, lazy
    demotion, trim, LZ4 rules) on the same raw candidates."""
    data, lengths = rows("corpus", n, seed=n)
    data[2, :n // 2] = 65                 # a long run: the widest caps
    lengths[2] = n
    windows, ml, dist = _raw_candidates(data, lengths, n=n,
                                        ctx_words=ctx_words,
                                        search_seg=search_seg, overlap=896)
    kw = dict(n=n, min_match=4, max_match=max_match, ctx_bytes=4 * ctx_words,
              parse_seg=8192, lz4_rules=lz4_rules)
    ln = torch.from_numpy(lengths)
    got = tlz.parse_inputs(ln, ml=ml, dist=dist, **kw)
    if windows is not None:
        by_win = tlz.parse_inputs(ln, kv=windows[0], overlap=windows[1],
                                  **kw)
        assert all(torch.equal(a, b) for a, b in zip(by_win, got))

    b = data.shape[0]
    iota = np.broadcast_to(np.arange(n, dtype=np.int32), (b, n))

    def tail(d, lens, io, m, ds):
        return jlz._analyze_tail(d, lens, io, m, ds, b, n, 4, max_match,
                                 4 * ctx_words, min(8192, n), lz4_rules)
    # the parse itself is parse_scan's (tests/test_torch_lz77.py): here
    # the stages before it, so the scan is left out of the program
    monkeypatch.setattr(jlz, "_parse_scan", lambda im, m, *a: (im, im))
    _io, jml, jdist, _tk, _lt, _vl = jax.jit(tail)(
        jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(iota),
        jnp.asarray(ml.numpy()), jnp.asarray(dist.numpy()))
    is_match, tml, tdist = got
    assert np.array_equal(tml.numpy(), np.asarray(jml))
    assert np.array_equal(tdist.numpy(), np.asarray(jdist))
    assert np.array_equal(is_match.numpy(), np.asarray(jml) > 0)
    assert is_match.any()
    if max_match > 258:                   # the run's matches chained on
        assert int(tml.max()) > 258 if not lz4_rules or max_match > 273 \
            else int(tml.max()) == 273


@pytest.mark.parametrize("cap0,max_match,n", [
    (12, 258, 4096), (16, 258, 4096), (16, 273, 8192), (12, 32767, 65536),
    (16, 32767, 65536)])
def test_extend_matches_plain_matches_jax(cap0, max_match, n):
    """The extension rounds alone on packed planes (ml << 16 | dist - 1)
    built to chain: runs of matches at the cap with one distance, broken
    at random by another distance, a length below min_match or none."""
    rng = np.random.default_rng(cap0 + n)
    b = 3
    ml = rng.choice(np.array([0, 3, 4, 7, cap0, cap0, cap0, cap0]), (b, n))
    d1 = rng.choice(np.array([0, 0, 0, 2, 4095]), (b, n))
    ml[0] = cap0                          # one chain across the row
    d1[0] = 0
    p = (ml.astype(np.int64) << 16 | d1).astype(np.int32)
    got = tlz._extend_matches(torch.from_numpy(p), cap0=cap0,
                              max_match=max_match, min_match=4, n=n)
    want = jax.jit(lambda x: jlz._extend_matches(
        x, cap0=cap0, max_match=max_match, min_match=4, n=n))(
            jnp.asarray(p.view(np.uint32)))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert int(got[0].max() >> 16) == min(max_match, n)


def test_symbols_plain_match_jax():
    """``_len_symbol`` / ``_dist_symbol`` over every length and distance
    DEFLATE has, and both passes' planes from them."""
    ml = np.arange(3, 259, dtype=np.int32)
    dist = np.arange(1, 32769, dtype=np.int32)
    for t, j, x in ((dp._len_symbol, jdp._len_symbol, ml),
                    (dp._dist_symbol, jdp._dist_symbol, dist)):
        got = t(torch.from_numpy(x))
        want = jax.jit(j)(jnp.asarray(x))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))

    rng = np.random.default_rng(5)
    b, n = 4, 4096
    data = rng.integers(0, 256, (b, n), dtype=np.uint8)
    mls = rng.integers(4, 259, (b, n)).astype(np.int32)
    dists = rng.integers(1, 32769, (b, n)).astype(np.int32)
    taken = rng.random((b, n)) < 0.2
    lit = (rng.random((b, n)) < 0.5) & ~taken
    lsym = np.asarray(jax.jit(jdp._len_symbol)(jnp.asarray(mls))[0])
    dsym = np.asarray(jax.jit(jdp._dist_symbol)(jnp.asarray(dists))[0])
    byte = data.astype(np.int32)
    want = {1: (np.where(taken, lsym, np.where(lit, byte, 320)),
                np.where(taken, 286 + dsym, 320)),
            2: (np.where(taken, lsym, np.where(lit, byte, 286)), dsym)}
    planes = [torch.from_numpy(x) for x in (data, mls, dists, taken, lit)]
    for mode in (1, 2):
        before = dict(cuda_pack.LAUNCHES)
        sym, ds = dp.symbol_planes(*planes, mode=mode)
        assert cuda_pack.LAUNCHES == before
        assert sym.dtype == ds.dtype == torch.int32
        assert np.array_equal(sym.numpy(), want[mode][0])
        assert np.array_equal(ds.numpy(), want[mode][1])
        ref = dp.symbol_planes_ref(*planes, mode=mode)
        assert all(torch.equal(a, c) for a, c in zip((sym, ds), ref))


@pytest.mark.parametrize("kernel", ["search_inputs", "parse_inputs",
                                    "symbol_planes"])
def test_wrappers_return_their_plain_version_and_refuse_other_devices(
        kernel):
    """On CPU tensors each wrapper returns its plain version and launches
    nothing; a tensor on a device the port has no kernel for (``meta``)
    is refused before anything runs."""
    data, lengths = rows("corpus", 4096, seed=3)
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
    windows, ml, dist = _raw_candidates(data, lengths, n=4096, ctx_words=3,
                                        search_seg=1024, overlap=200)
    taken, lit = cuda_pack.parse_scan_ref(ml >= 4, ml, 4096)
    pkw = dict(n=4096, min_match=4, max_match=258, ctx_bytes=12,
               parse_seg=8192)
    calls = {
        "search_inputs": (
            lambda t: tlz.search_inputs(t, ln, min_match=4, ctx_words=3,
                                        width=1024, overlap=200),
            lambda t: tlz.search_inputs_ref(t, ln, min_match=4, ctx_words=3,
                                            width=1024, overlap=200), d),
        "parse_inputs": (
            lambda t: tlz.parse_inputs(t, kv=windows[0], overlap=200, **pkw),
            lambda t: tlz.parse_inputs_ref(t, kv=windows[0], overlap=200,
                                           **pkw), ln),
        "symbol_planes": (
            lambda t: dp.symbol_planes(d, t, dist, taken, lit, mode=1),
            lambda t: dp.symbol_planes_ref(d, t, dist, taken, lit, mode=1),
            ml),
    }
    call, plain, first = calls[kernel]
    before = dict(cuda_pack.LAUNCHES)
    got = call(first)
    assert cuda_pack.LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(got, plain(first)))
    with pytest.raises(ValueError, match="unsupported device"):
        call(first.to("meta"))
    assert cuda_pack.LAUNCHES == before


def test_parse_inputs_launches_per_route():
    """One launch a tile where the extension's caps fit one CTA's halo
    (DEFLATE at every level, the LZ4 device pack); the token path's LZ4
    (max_match 32767) runs its first seven rounds in one launch and one
    launch a wider round, the last ending the stage."""
    launches = tlz.parse_inputs_launches
    assert launches(n=65536, max_match=258, ctx_bytes=12) == [(12, 5, True)]
    assert launches(n=65536, max_match=258, ctx_bytes=16) == [(16, 5, True)]
    assert launches(n=65536, max_match=273, ctx_bytes=16) == [(16, 5, True)]
    assert launches(n=4096, max_match=258, ctx_bytes=16) == [(16, 5, True)]
    assert launches(n=256, max_match=258, ctx_bytes=12) == [(12, 5, True)]
    assert launches(n=65536, max_match=32767, ctx_bytes=16) == [
        (16, 7, False), (2048, 1, False), (4096, 1, False),
        (8192, 1, False), (16384, 1, True)]
    assert launches(n=65536, max_match=32767, ctx_bytes=12) == [
        (12, 7, False), (1536, 1, False), (3072, 1, False),
        (6144, 1, False), (12288, 1, False), (24576, 1, True)]
    for n in (256, 4096, 65536):
        for ctx_bytes in (12, 16):
            for mm in (258, 273, 32767):
                plan = launches(n=n, max_match=mm, ctx_bytes=ctx_bytes)
                caps = [c << r for c, k, _e in plan for r in range(k)]
                want = []
                cap = ctx_bytes
                while cap < mm and cap < n:
                    want.append(cap)
                    cap *= 2
                assert caps == want
                assert [e for *_x, e in plan] == [False] * (len(plan) - 1) \
                    + [True]
                assert sum(c * ((1 << k) - 1) for c, k, _e in plan[:1]) \
                    + (len(plan) == 1) <= tlz.PARSE_MAX_HALO
