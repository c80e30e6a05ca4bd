"""The port's CUDA kernels and its main path on the card.

Every test here is marked ``cuda`` and skips on a machine without a GPU.
On the card, run them with:  python -m pytest tests/test_torch_cuda.py
This file imports neither jax nor the JAX package, so it runs where jax
is not installed.
"""

import zlib

import numpy as np
import pytest
import torch

from qatzip_tpu_torch.ops import cuda_pack

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _k2_inputs(w, rows, ctx_words, seed):
    rng = np.random.default_rng(seed)
    pbits = (w - 1).bit_length()
    hb = min(18, 31 - pbits)
    h = rng.integers(0, max(4, w // 64), (rows, w)).astype(np.uint64)
    h[:, -200:] = 1 << hb
    key = ((h << np.uint64(pbits)) | np.arange(w, dtype=np.uint64))
    sym = rng.integers(0, 3, (ctx_words, rows, w)).astype(np.uint64)
    top = rng.integers(0, 2, (ctx_words, rows, w)).astype(np.uint64) << 31
    ctx = (sym * 0x00010101 + top).astype(np.uint32)
    return (torch.from_numpy(key.astype(np.uint32).view(np.int32)),
            torch.from_numpy(ctx.view(np.int32)), pbits)


PARSE_PLANES = ("literal", "all-258", "never-meet", "boundaries", "past-end")
K2_WINDOWS = ("one-bucket", "overflow", "reverse")


def parse_plane(kind, b, nseg, seg, seed=0):
    """(is_match, ml) numpy planes of shape (b, nseg * seg) that the
    card's speculate-then-verify parse (32-position sub-blocks) must get
    right as the plain version does:

      literal:    no match anywhere;
      all-258:    a match of 258 at every position, untrimmed;
      never-meet: each segment's first position a literal, every other
                  position a match of 4: the true path runs 1, 5, 9, ...
                  and the walk from every sub-block's start (0 mod 4)
                  never meets it;
      boundaries: matches that end exactly on sub-block boundaries, the
                  next one or the one after, and on the segment's end;
      past-end:   random matches up to 4 * seg long, so ``reach`` passes
                  the segment's end.
    """
    rng = np.random.default_rng(seed)
    n = nseg * seg
    p = np.broadcast_to(np.arange(n) % seg, (b, n))
    q = p % 32
    if kind == "literal":
        im, ml = np.zeros((b, n), bool), rng.integers(4, 40, (b, n))
    elif kind == "all-258":
        im, ml = np.ones((b, n), bool), np.full((b, n), 258)
    elif kind == "never-meet":
        im, ml = p != 0, np.full((b, n), 4)
    elif kind == "boundaries":
        # from q = 5 to the next sub-block, or (p % 64 == 5) two on
        im, ml = q == 5, np.where(p % 64 == 5, 91, 32 - q)
    elif kind == "past-end":
        im, ml = rng.random((b, n)) < 0.3, rng.integers(1, 4 * seg, (b, n))
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(im), ml.astype(np.int32)


def k2_window(kind, w, rows, ctx_words, seed=0):
    """(key, ctx, pbits): numpy uint32 windows that stress the card's
    sort and probes, with context words over a tiny alphabet (bit 31 set
    at random) so that matches, partial-byte ones too, are common:

      one-bucket: every key in one hash bucket, so every position but
                  the first few probes its ``probes`` predecessors;
      overflow:   every key in the overflow bucket 1 << hb (bit 31 set
                  at pbits 13);
      reverse:    the hash falls as relpos rises (two positions a
                  bucket), so the keys come in descending order.
    """
    rng = np.random.default_rng(seed)
    pbits = max((w - 1).bit_length(), 1)
    hb = min(18, 31 - pbits)
    rel = np.arange(w, dtype=np.uint64)
    if kind == "one-bucket":
        h = np.full(w, 12345, np.uint64)
    elif kind == "overflow":
        h = np.full(w, 1 << hb, np.uint64)
    elif kind == "reverse":
        h = (np.uint64(w - 1) - rel) >> np.uint64(1)
    else:
        raise ValueError(kind)
    key = np.broadcast_to((h << np.uint64(pbits)) | rel, (rows, w))
    sym = rng.integers(0, 3, (ctx_words, rows, w)).astype(np.uint64)
    top = rng.integers(0, 2, (ctx_words, rows, w)).astype(np.uint64) << 31
    lowb = rng.integers(0, 2, (ctx_words, rows, w)).astype(np.uint64)
    ctx = (sym * 0x00010101 + lowb + top).astype(np.uint32)
    return np.ascontiguousarray(key, dtype=np.uint32), ctx, pbits


@pytest.mark.parametrize("w,ctx_words,probes", [
    (8192, 3, 7), (8192, 4, 6), (1024, 3, 7), (256, 4, 6)])
def test_candidate_search_kernel_matches_ref(card, w, ctx_words, probes):
    key, ctx, pbits = _k2_inputs(w, 6, ctx_words, seed=w)
    kw = dict(probes=probes, min_match=4, pbits=pbits)
    want = cuda_pack.candidate_search_ref(key, ctx, **kw)
    before = cuda_pack.LAUNCHES["candidate_search"]
    got = cuda_pack.candidate_search(key.to(card), ctx.to(card), **kw)
    torch.cuda.synchronize()
    assert cuda_pack.LAUNCHES["candidate_search"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("seg", [512, 8192])
def test_parse_scan_kernel_matches_ref(card, seg):
    rng = np.random.default_rng(seg)
    im = torch.from_numpy(rng.random((4, 2 * seg)) < 0.3)
    ml = torch.from_numpy(rng.integers(4, 40, (4, 2 * seg)).astype(np.int32))
    want = cuda_pack.parse_scan_ref(im, ml, seg)
    got = cuda_pack.parse_scan(im.to(card), ml.to(card), seg)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("seg", [256, 512, 768, 8192])
@pytest.mark.parametrize("kind", PARSE_PLANES)
def test_parse_scan_kernel_adversarial_planes(card, kind, seg):
    im, ml = parse_plane(kind, 2, 3, seg, seed=seg)
    im, ml = torch.from_numpy(im), torch.from_numpy(ml)
    want = cuda_pack.parse_scan_ref(im, ml, seg)
    before = cuda_pack.LAUNCHES["parse_scan"]
    got = cuda_pack.parse_scan(im.to(card), ml.to(card), seg)
    torch.cuda.synchronize()
    assert cuda_pack.LAUNCHES["parse_scan"] == before + 1
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_parse_scan_kernel_scalar_path(card):
    """A segment that is not a multiple of 16, and planes that start off
    a 16-byte boundary, take the kernel's scalar path."""
    im, ml = parse_plane("past-end", 3, 2, 1000, seed=1)
    cases = [(torch.from_numpy(im), torch.from_numpy(ml), 1000, card)]
    im, ml = parse_plane("never-meet", 2, 2, 512, seed=2)
    flat_im = torch.zeros(im.size + 1, dtype=torch.bool)
    flat_ml = torch.zeros(ml.size + 1, dtype=torch.int32)
    flat_im[1:] = torch.from_numpy(im).reshape(-1)
    flat_ml[1:] = torch.from_numpy(ml).reshape(-1)
    # sliced on the card: contiguous, one element past an aligned start
    cases.append((flat_im.to(card)[1:].reshape(2, 1024),
                  flat_ml.to(card)[1:].reshape(2, 1024), 512, card))
    for it, mt, seg, dev in cases:
        want = cuda_pack.parse_scan_ref(it.cpu(), mt.cpu(), seg)
        got = cuda_pack.parse_scan(it.to(dev), mt.to(dev), seg)
        torch.cuda.synchronize()
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("w", [2, 256, 8192])
@pytest.mark.parametrize("kind", K2_WINDOWS)
def test_candidate_search_kernel_adversarial_windows(card, kind, w):
    key, ctx, pbits = k2_window(kind, w, 3, 3, seed=w)
    key = torch.from_numpy(key.view(np.int32))
    ctx = torch.from_numpy(ctx.view(np.int32))
    kw = dict(probes=7, min_match=4, pbits=pbits)
    want = cuda_pack.candidate_search_ref(key, ctx, **kw)
    before = cuda_pack.LAUNCHES["candidate_search"]
    got = cuda_pack.candidate_search(key.to(card), ctx.to(card), **kw)
    torch.cuda.synchronize()
    assert cuda_pack.LAUNCHES["candidate_search"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("ctx_words,probes", [(1, 63), (2, 1), (3, 7),
                                              (4, 6)])
def test_candidate_search_kernel_one_bucket_ctx_words(card, ctx_words,
                                                      probes):
    key, ctx, pbits = k2_window("one-bucket", 8192, 2, ctx_words, seed=9)
    key = torch.from_numpy(key.view(np.int32))
    ctx = torch.from_numpy(ctx.view(np.int32))
    kw = dict(probes=probes, min_match=4, pbits=pbits)
    want = cuda_pack.candidate_search_ref(key, ctx, **kw)
    got = cuda_pack.candidate_search(key.to(card), ctx.to(card), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert ((want >> 13) & 0x1F).gt(0).any()


def test_wrapper_rejects_host_and_device_mix(card):
    key, ctx, pbits = _k2_inputs(1024, 1, 3, seed=3)
    with pytest.raises(ValueError):
        cuda_pack.candidate_search(key.to(card), ctx, probes=7, min_match=4,
                                   pbits=pbits)
    lit = torch.zeros((1, 286), dtype=torch.int32)
    dist = torch.zeros((1, 30), dtype=torch.int32)
    sym = torch.zeros((1, 512), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_pack.huffman_lookup(lit, dist.to(card), sym.to(card),
                                 sym.to(card))
    with pytest.raises(ValueError):
        cuda_pack.symbol_histogram(sym.to(card), sym)
    with pytest.raises(ValueError):
        cuda_pack.assemble_windows(torch.zeros((1, 2, 74), dtype=torch.int32),
                                   torch.zeros((1, 2), dtype=torch.int32).to(
                                       card), max_words=100)


def _k1_inputs(b, n, w, seed):
    """Windows as the packers give them, one per 256 positions: window g
    writes span[g] < w words and the next one starts at its last word,
    which the two share with disjoint bits (the low half to g, the high
    half to g + 1)."""
    rng = np.random.default_rng(seed)
    ng = n // 256
    span = rng.integers(1, w, (b, ng))
    wo = np.zeros((b, ng), np.int64)
    wo[:, 1:] = np.cumsum(span - 1, axis=1)[:, :-1]
    j = np.arange(w)
    grp = rng.integers(0, 1 << 32, (b, ng, w), dtype=np.uint64)
    grp = np.where(j < span[:, :, None], grp, 0)
    grp[:, :, 0] &= 0xFFFF0000
    last = (span - 1)[:, :, None]
    np.put_along_axis(grp, last,
                      np.take_along_axis(grp, last, 2) & 0xFFFF, 2)
    return (torch.from_numpy(grp.astype(np.uint32).view(np.int32)),
            torch.from_numpy(wo.astype(np.int32)))


@pytest.mark.parametrize("b,n,w,max_words", [
    (4, 65536, 99, 24706), (4, 65536, 74, 18435), (3, 2048, 74, 200)])
def test_assemble_windows_kernel_matches_ref(card, b, n, w, max_words):
    grp, wo = _k1_inputs(b, n, w, seed=n + w)
    want = cuda_pack.assemble_windows_ref(grp, wo, max_words=max_words)
    before = cuda_pack.LAUNCHES["assemble_windows"]
    got = cuda_pack.assemble_windows(grp.to(card), wo.to(card),
                                     max_words=max_words)
    torch.cuda.synchronize()
    assert cuda_pack.LAUNCHES["assemble_windows"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,n", [(4, 65536), (3, 1000), (2, 4096)])
def test_huffman_lookup_kernel_matches_ref(card, b, n):
    rng = np.random.default_rng(n)
    lit = torch.from_numpy(rng.integers(0, 1 << 16, (b, 286)).astype(np.int32))
    dist = torch.from_numpy(rng.integers(0, 1 << 16, (b, 30)).astype(np.int32))
    sym = torch.from_numpy(rng.integers(-2, 300, (b, n)).astype(np.int32))
    dsym = torch.from_numpy(rng.integers(-2, 40, (b, n)).astype(np.int32))
    want = cuda_pack.huffman_lookup_ref(lit, dist, sym, dsym)
    before = cuda_pack.LAUNCHES["huffman_lookup"]
    got = cuda_pack.huffman_lookup(lit.to(card), dist.to(card), sym.to(card),
                                   dsym.to(card))
    torch.cuda.synchronize()
    assert cuda_pack.LAUNCHES["huffman_lookup"] == before + 1
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("b,n", [(4, 65536), (3, 1000), (2, 8193)])
def test_symbol_histogram_kernel_matches_ref(card, b, n):
    rng = np.random.default_rng(n)
    sym = rng.integers(-3, 330, (b, n)).astype(np.int32)
    sym[0, : n // 2] = 97                     # one hot bin
    dsym = rng.integers(270, 330, (b, n)).astype(np.int32)
    sym, dsym = torch.from_numpy(sym), torch.from_numpy(dsym)
    want = cuda_pack.symbol_histogram_ref(sym, dsym)
    before = cuda_pack.LAUNCHES["symbol_histogram"]
    got = cuda_pack.symbol_histogram(sym.to(card), dsym.to(card))
    torch.cuda.synchronize()
    assert cuda_pack.LAUNCHES["symbol_histogram"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("static,device_pack", [
    (False, False), (True, True), (False, True)],
    ids=["dynamic-token-path", "static-device-pack", "dynamic-device-pack"])
def test_session_on_card_matches_cpu(card, monkeypatch, static, device_pack):
    """Both engines held on one route: the CPU's and the card's bytes
    agree."""
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.parallel.dispatch import CudaEngine
    from corpus import make_corpus     # tests/ is on sys.path under pytest
    c = make_corpus()
    data = c["text"][:300000] + c["binary"][:100000] + c["noise"][:50000]
    monkeypatch.setattr(CudaEngine, "packs_on_device",
                        lambda self, s: device_pack)
    p = qz.SessionParamsDeflate()
    if static:
        p.huffman_hdr = qz.HuffmanHdr.STATIC_HDR
    outs = []
    for device in ("cpu", "cuda"):
        sess = qz.QzSession(device=device)
        sess.setup_deflate(p)
        outs.append(sess.compress(data))
        assert sess.decompress(outs[-1]) == data
    assert outs[0] == outs[1]
    d = zlib.decompressobj(31)
    assert d.decompress(outs[1])[:65536] == data[:65536]
