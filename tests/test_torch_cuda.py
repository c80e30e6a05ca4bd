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
from qatzip_tpu_torch.ops import deflate_pack as dp
from qatzip_tpu_torch.ops import lz4_pack as lp
from qatzip_tpu_torch.parallel.dispatch import _tok_knobs, plan_tile

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
    planes = pack_plane("far-4", 1, 512)
    args, kw, _plan = pack_args("far-4", planes, True)
    with pytest.raises(ValueError):
        dp.pack_rows(*[a.to(card) for a in args], max_words=300,
                     lpack=kw["lpack"], dpack=kw["dpack"].to(card))


PACK_PLANES = ("literal-144", "far-4", "run-258")


def pack_plane(kind, b, n, seed=0):
    """(data, ml, dist, taken, lit) numpy planes of shape (b, n), ones a
    parse can give, that are hard for the row bit-packer:

      literal-144: every position a literal of a byte 152-160: 9-bit static
                   codes, and 10-12-bit dynamic ones under
                   :func:`pack_tables`;
      far-4:       back-to-back 4-byte matches at distance 32768, the
                   widest distance parts (25 of a static match's bits),
                   straddling word boundaries throughout;
      run-258:     a literal, then matches of 258 at distance 1, literals
                   to the row's end; the last row ends at n // 3, its
                   planes empty past it.
    """
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (b, n)).astype(np.uint8)
    ml = np.zeros((b, n), np.int32)
    dist = np.ones((b, n), np.int32)
    taken = np.zeros((b, n), bool)
    lit = np.zeros((b, n), bool)
    if kind == "literal-144":
        data = rng.integers(152, 161, (b, n)).astype(np.uint8)
        lit[:] = True
    elif kind == "far-4":
        taken[:, ::4] = True
        ml[taken], dist[taken] = 4, 32768
    elif kind == "run-258":
        for r in range(b):
            end = n // 3 if r == b - 1 else n
            runs = (end - 1) // 258
            starts = 1 + 258 * np.arange(runs)
            taken[r, starts], ml[r, starts] = True, 258
            lit[r, 0] = True
            lit[r, 1 + 258 * runs:end] = True
    else:
        raise ValueError(kind)
    return data, ml, dist, taken, lit


def pack_tables(kind, data, ml, dist, taken, lit):
    """Each row's dynamic plan (lit_pack, dist_pack, header bytes, header
    bits) from its own symbol counts; for "literal-144" from counts 2^16,
    2^15, ..., 1 on symbols 144-160 instead, whose last seven codes take
    the 12-bit limit."""
    t = torch.from_numpy
    hist = cuda_pack.symbol_histogram(*dp.hist_symbols(
        t(data), t(ml), t(dist), t(taken), t(lit))).numpy()
    if kind == "literal-144":
        hist[:] = 0
        hist[:, 144:161] = 1 << (16 - np.arange(17))
    return plan_tile(hist, len(hist))


def pack_args(kind, planes, dynamic):
    """pack_rows' arguments (CPU tensors) for the planes: (ml, dist,
    taken, lit, base), the mode's keywords, and the dynamic plan (None
    for static)."""
    data, ml, dist, taken, lit = planes
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (ml, dist, taken, lit)]
    if not dynamic:
        base = torch.full((len(data),), dp.HDR_BITS, dtype=torch.int32)
        return args + [base], {"data": torch.from_numpy(data)}, None
    plan = pack_tables(kind, *planes)
    packs, dpacks, _hdrs, hbits = plan
    lpack, dpack = cuda_pack.huffman_lookup(
        torch.from_numpy(packs.astype(np.int32)),
        torch.from_numpy(dpacks.astype(np.int32)),
        *dp.lookup_symbols(torch.from_numpy(data), *args))
    return (args + [torch.from_numpy(hbits)],
            {"lpack": lpack, "dpack": dpack}, plan)


def _max_words(n, dynamic):
    if dynamic:
        return (n * dp.DYN_LIMIT + 4096 + 31) // 32 + 2
    return (n * 9 + dp.HDR_BITS + dp.EOB_BITS + 31) // 32 + 2


def _real_planes(card, b, n):
    """The port's level-1 parse planes of corpus rows, on the card."""
    from corpus import make_silesia_like   # tests/ is on sys.path
    data = np.frombuffer(make_silesia_like(b * n >> 20 or 1)[:b * n],
                         np.uint8).reshape(b, n).copy()
    ss, ov, _cs, ctx_words, probes = _tok_knobs(1, n)
    lengths = torch.full((b,), n, dtype=torch.int32, device=card)
    planes = dp._analyze_planes(torch.from_numpy(data).to(card), lengths,
                                n=n, parse_seg=8192, ctx_words=ctx_words,
                                probes=probes, search_seg=ss,
                                search_overlap=ov)
    return (data,) + tuple(p.cpu().numpy() for p in planes)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("kind,n", [("real", 65536), ("real", 2048),
                                    *[(k, 65536) for k in PACK_PLANES],
                                    ("run-258", 2048)])
def test_pack_rows_kernel_matches_ref(card, kind, n, dynamic):
    planes = (_real_planes(card, 4, n) if kind == "real"
              else pack_plane(kind, 4, n, seed=n))
    args, kw, _plan = pack_args(kind, planes, dynamic)
    max_words = _max_words(n, dynamic)
    want = dp.pack_rows_ref(*args, max_words=max_words, **kw)
    before = cuda_pack.LAUNCHES["pack_rows"]
    got = dp.pack_rows(*[a.to(card) for a in args], max_words=max_words,
                       **{k: v.to(card) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert cuda_pack.LAUNCHES["pack_rows"] == before + 1
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert want[0].any()


def test_pack_rows_kernel_scalar_path_and_short_rows(card):
    """Rows whose length is not a multiple of 4 and planes off a 16-byte
    boundary take the kernel's scalar loads; max_words cuts a row short."""
    for dynamic in (False, True):
        planes = pack_plane("run-258", 3, 1001, seed=5)
        args, kw, _plan = pack_args("run-258", planes, dynamic)
        for max_words in (_max_words(1001, dynamic), 37):
            want = dp.pack_rows_ref(*args, max_words=max_words, **kw)
            got = dp.pack_rows(*[a.to(card) for a in args],
                               max_words=max_words,
                               **{k: v.to(card) for k, v in kw.items()})
            torch.cuda.synchronize()
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        # the planes one element into a buffer on the card
        moved = []
        for a in [*args[:4], *kw.values()]:
            flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=card)
            flat[1:] = a.reshape(-1).to(card)
            moved.append(flat[1:].reshape(a.shape))
        max_words = _max_words(1001, dynamic)
        want = dp.pack_rows_ref(*args, max_words=max_words, **kw)
        got = dp.pack_rows(*moved[:4], args[4].to(card), max_words=max_words,
                           **dict(zip(kw, moved[4:])))
        torch.cuda.synchronize()
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_pack_rows_refuses_what_the_kernel_does_not_take(card):
    planes = pack_plane("run-258", 2, 2048)
    args, kw, _plan = pack_args("run-258", planes, False)
    on_card = [a.to(card) for a in args]
    with pytest.raises(ValueError):          # one plane left on the host
        dp.pack_rows(*on_card[:3], args[3], on_card[4], max_words=600,
                     data=kw["data"].to(card))
    with pytest.raises(ValueError):          # a row past shared memory
        dp.pack_rows(*on_card, max_words=dp.MAX_SMEM // 4,
                     data=kw["data"].to(card))
    with pytest.raises(ValueError):          # no mode
        dp.pack_rows(*on_card, max_words=600)


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
                        lambda self, s, algorithm="deflate": device_pack)
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


# ---------------------------------------------------------------------------
# the LZ4 byte packer and the LZ4 / LZ4s / level-6 sessions
# ---------------------------------------------------------------------------

def lz4_rows(n, seed=0):
    """(data (6, n) uint8, lengths) rows that are hard for the LZ4 byte
    packer: ``b"A" * n`` (back-to-back 273-matches with their own
    tokens), a literal run of exactly 269, 270 and 271 literals (random
    bytes, then one byte repeated), corpus text whose length is not a
    multiple of 4, and an empty row."""
    from corpus import text_like          # tests/ is on sys.path
    rng = np.random.default_rng(seed)
    rows = [b"A" * n]
    for run in (269, 270, 271):
        rows.append(bytes(rng.integers(0, 256, run - 1, dtype=np.uint8))
                    + b"x" * n)
    rows += [text_like(n + 64, seed=seed)[:n - 3], b""]
    data = np.zeros((len(rows), n), np.uint8)
    lengths = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        r = r[:n]
        data[i, :len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    return torch.from_numpy(data), torch.from_numpy(lengths)


def _lz4_planes_on(card, n, seed=0):
    """The rows' LZ4 parse planes on the card (data, ml, dist, taken,
    lit), and the same on the host."""
    data, lengths = lz4_rows(n, seed)
    planes = lp.lz4_planes(data.to(card), lengths.to(card), n=n)
    on_card = [data.to(card)] + [p.to(torch.int32) if p.dtype != torch.bool
                                 else p for p in planes]
    return on_card, [p.cpu() for p in on_card]


def _lz4_same(got, want):
    torch.cuda.synchronize()
    return all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [65536, 8192, 1024])
def test_lz4_pack_rows_kernel_matches_ref(card, n):
    on_card, host = _lz4_planes_on(card, n, seed=n)
    mw = lp.lz4_max_words(n)
    want = lp.lz4_pack_rows_ref(*host, max_words=mw)
    before = cuda_pack.LAUNCHES["lz4_pack_rows"]
    got = lp.lz4_pack_rows(*on_card, max_words=mw)
    assert _lz4_same(got, want)
    assert cuda_pack.LAUNCHES["lz4_pack_rows"] == before + 1
    # the 269- and 270-literal runs fit an emission, the 271 does not
    assert want[2].tolist() == [True, True, True, False, True, True]
    assert want[0][:5].any() and not want[0][3].any()


def test_lz4_pack_rows_kernel_scalar_path_and_short_rows(card):
    """Rows whose length is not a multiple of 16 and planes off their
    alignment take the kernel's scalar loads; max_words cuts a row
    short."""
    on_card, host = _lz4_planes_on(card, 1024, seed=3)
    cut = [p[:, :1001].contiguous() for p in on_card]
    cut_host = [p.cpu() for p in cut]
    for mw in (lp.lz4_max_words(1001), 37):
        assert _lz4_same(lp.lz4_pack_rows(*cut, max_words=mw),
                         lp.lz4_pack_rows_ref(*cut_host, max_words=mw))
    moved = []
    for a in on_card:
        flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=card)
        flat[1:] = a.reshape(-1)
        moved.append(flat[1:].reshape(a.shape))
    mw = lp.lz4_max_words(1024)
    assert _lz4_same(lp.lz4_pack_rows(*moved, max_words=mw),
                     lp.lz4_pack_rows_ref(*host, max_words=mw))


def test_lz4_pack_rows_refuses_what_the_kernel_does_not_take(card):
    """A plane left on the host and a row whose literal bitmap passes
    shared memory are refused; a row of MAX_SMEM / 4 words, which the
    first design (the row's words in shared memory) refused, packs."""
    on_card, host = _lz4_planes_on(card, 1024)
    with pytest.raises(ValueError):          # one plane left on the host
        lp.lz4_pack_rows(*on_card[:4], host[4], max_words=600)
    wide = dp.MAX_SMEM // 4
    assert _lz4_same(lp.lz4_pack_rows(*on_card, max_words=wide),
                     lp.lz4_pack_rows_ref(*host, max_words=wide))
    n = 8 * lp.LZ4_SMEM_LIMIT
    z8 = torch.zeros((1, n), dtype=torch.uint8, device=card)
    z32 = torch.zeros((1, n), dtype=torch.int32, device=card)
    zb = torch.zeros((1, n), dtype=torch.bool, device=card)
    with pytest.raises(ValueError):          # a bitmap past shared memory
        lp.lz4_pack_rows(z8, z32, z32, zb, zb, max_words=16)


def _hand_made_planes(n, rows, seed):
    """chip_smoke.lz4_plane_rows (loaded by path) as CPU tensors, and the
    kinds of its rows."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("qz_chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    kinds = [cs.LZ4_PLANE_KINDS[i % len(cs.LZ4_PLANE_KINDS)]
             for i in range(rows)]
    planes = [torch.from_numpy(a) for a in cs.lz4_plane_rows(n, rows, seed)]
    return planes, kinds


@pytest.mark.parametrize("n,rows", [(65536, 56), (65536, 1), (65536, 3),
                                    (8192, 21), (8197, 14)])
def test_lz4_pack_rows_kernel_hand_made_planes(card, n, rows):
    """Runs of 270 and 271 literals across a step boundary, runs of 270
    all along a row (tokens and their matches across steps and the
    staging ring), a long run only at the row's end, a 4-byte emission at
    a step's last position at every byte offset mod 4, literal-only and
    empty rows; B = 1 and 3; max_words smaller than the block; n = 8197
    takes the scalar loads."""
    host, kinds = _hand_made_planes(n, rows, seed=n + rows)
    on_card = [p.to(card) for p in host]
    for mw in (lp.lz4_max_words(n), 1000, 37):
        want = lp.lz4_pack_rows_ref(*host, max_words=mw)
        assert _lz4_same(lp.lz4_pack_rows(*on_card, max_words=mw), want)
    bad = ("run 271 across a step", "long run at the end", "all literals")
    assert want[2].tolist() == [k not in bad for k in kinds]


def test_lz4_pack_rows_kernel_hand_made_planes_unaligned(card):
    """The hand-made planes one element off their alignment: the scalar
    loads at the main path's width."""
    n = 65536
    host, _kinds = _hand_made_planes(n, 14, seed=11)
    moved = []
    for a in host:
        flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=card)
        flat[1:] = a.reshape(-1).to(card)
        moved.append(flat[1:].reshape(a.shape))
    mw = lp.lz4_max_words(n)
    assert _lz4_same(lp.lz4_pack_rows(*moved, max_words=mw),
                     lp.lz4_pack_rows_ref(*host, max_words=mw))


@pytest.mark.parametrize("kind", ["lz4-token", "lz4-device-pack", "lz4s",
                                  "level6-device-pack", "level6-token"])
def test_lz4_and_level6_sessions_on_card_match_cpu(card, monkeypatch, kind):
    """Both engines held on one route: the CPU's and the card's bytes
    agree, and the output decodes."""
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch import postproc
    from qatzip_tpu_torch.parallel.dispatch import CudaEngine
    from corpus import make_corpus
    c = make_corpus()
    data = c["text"][:300000] + c["binary"][:100000] + c["noise"][:50000]
    held = kind.endswith("device-pack")
    monkeypatch.setattr(CudaEngine, "packs_on_device",
                        lambda self, s, algorithm="deflate": held)
    outs = []
    for device in ("cpu", "cuda"):
        sess = qz.QzSession(device=device)
        if kind.startswith("lz4s"):
            p = qz.SessionParamsLZ4S()
            p.qzCallback = postproc.zstd_callback
            sess.setup_lz4s(p)
        elif kind.startswith("lz4"):
            sess.setup_lz4()
        else:
            p = qz.SessionParamsDeflate()
            p.common.comp_lvl = 6
            sess.setup_deflate(p)
        outs.append(sess.compress(data))
        if kind == "lz4s":
            assert postproc.zstd_decompress(outs[-1]) == data
        else:
            assert sess.decompress(outs[-1]) == data
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the probe kernels (ops/devprims.py) and the row split
# ---------------------------------------------------------------------------

def _words(rng, shape):
    return torch.from_numpy(rng.integers(0, 1 << 32, shape,
                                         dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("shape,kind", [
    ((512, 128), "random"), ((8192, 1024), "random"), ((1000, 128), "random"),
    ((512, 128), "zero"), ((512, 128), "last"), ((300, 1024), "negative"),
    ((64, 4), "random")])
def test_lane_gather_kernel_matches_plain(card, shape, kind):
    """Random indices, every index 0 or C - 1, negative ones (numpy's
    wrap), and row counts that do not fill the last CTA."""
    from qatzip_tpu_torch.ops import devprims as dv
    rng = np.random.default_rng(21)
    x = _words(rng, shape)
    c = shape[1]
    idx = {"random": lambda: rng.integers(0, c, shape),
           "zero": lambda: np.zeros(shape, np.int64),
           "last": lambda: np.full(shape, c - 1),
           "negative": lambda: rng.integers(-c, c, shape)}[kind]()
    idx = torch.from_numpy(idx.astype(np.int32))
    before = cuda_pack.LAUNCHES["lane_gather"]
    got = dv.lane_gather(x.to(card), idx.to(card))
    assert torch.equal(got.cpu(), dv.lane_gather_ref(x, idx))
    assert torch.equal(got, torch.gather(x.to(card), 1,
                                         (idx & (c - 1)).to(card).long()))
    assert cuda_pack.LAUNCHES["lane_gather"] == before + 1


@pytest.mark.parametrize("shape", [(512, 128), (4096, 256), (2, 8)])
def test_sublane_gather_kernel_matches_plain(card, shape):
    from qatzip_tpu_torch.ops import devprims as dv
    rng = np.random.default_rng(22)
    x = _words(rng, shape)
    idx = torch.from_numpy(rng.integers(-shape[0], shape[0], shape).astype(
        np.int32))
    idx[0] = 0
    idx[1] = shape[0] - 1
    got = dv.sublane_gather(x.to(card), idx.to(card))
    assert torch.equal(got.cpu(), dv.sublane_gather_ref(x, idx))


@pytest.mark.parametrize("shifts", [
    None, (1, 3, 9, 27, 31, 77, 111), (0, 127), (-1, -33, 200, 128, 96),
    tuple(range(0, 128, 4)), (5, 5, 133, 5, -123, 0, 0, 127, 127)],
    ids=["static", "dynamic", "0-127", "negative-wrap", "32-shifts",
         "repeated"])
@pytest.mark.parametrize("rows", [4096, 1001, 1, 7, 9])
def test_roll_sum_kernel_matches_plain(card, shifts, rows):
    from qatzip_tpu_torch.ops import devprims as dv
    x = _words(np.random.default_rng(23), (rows, 128))
    sh = None if shifts is None else torch.tensor(shifts, dtype=torch.int32)
    got = dv.roll_sum(x.to(card), None if sh is None else sh.to(card))
    want = dv.roll_sum_ref(x, sh)
    assert torch.equal(got.cpu(), want)
    ks = dv.STATIC_SHIFTS if shifts is None else shifts
    xc = x.to(card)
    lib = xc.clone()
    for k in ks:
        lib += torch.roll(xc, k, 1)
    assert torch.equal(got, lib)


def _bitonic_keys(kind, rng, rows):
    if kind == "random":
        return _words(rng, (rows, 128))
    if kind == "ties-bit31":
        vals = np.array([0, 7, 1 << 20, 0x7FFFFFFF, 1 << 31, (1 << 31) + 7,
                         0xFFFFFFF0, 0xFFFFFFFF], np.uint32)
        return torch.from_numpy(vals[rng.integers(0, 8, (rows, 128))].view(
            np.int32))
    if kind == "all-equal":
        return _words(rng, (rows, 1)).expand(rows, 128).contiguous()
    keys = np.sort(rng.integers(0, 1 << 32, (rows, 128), dtype=np.uint32), 1)
    if kind == "reversed":
        keys = keys[:, ::-1]
    return torch.from_numpy(np.ascontiguousarray(keys).view(np.int32))


@pytest.mark.parametrize("kind", ["random", "ties-bit31", "all-equal",
                                  "sorted", "reversed"])
@pytest.mark.parametrize("rows", [65536, 1003, 1, 3, 5, 4097])
def test_bitonic128_kernel_matches_plain(card, kind, rows):
    """Keys and payloads bit-identical to the network's plain version;
    keys also equal torch.sort's. Row counts that do not fill a CTA's 32
    rows leave its last threads without a row."""
    from qatzip_tpu_torch.ops import devprims as dv
    rng = np.random.default_rng(24)
    keys = _bitonic_keys(kind, rng, rows)
    vals = _words(rng, (rows, 128))
    before = cuda_pack.LAUNCHES["bitonic128"]
    gk, gv = dv.bitonic128(keys.to(card), vals.to(card))
    assert cuda_pack.LAUNCHES["bitonic128"] == before + 1
    wk, wv = dv.bitonic128_ref(keys.to(card), vals.to(card))
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    k64 = keys.to(card).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(gk.to(torch.int64) & 0xFFFFFFFF,
                       torch.sort(k64, dim=1).values)


def test_bitonic128_kernel_unaligned_rows(card):
    """Planes off their 16-byte alignment take the scalar loads."""
    from qatzip_tpu_torch.ops import devprims as dv
    rng = np.random.default_rng(25)
    rows = 37
    keys = _bitonic_keys("ties-bit31", rng, rows)
    vals = _words(rng, (rows, 128))
    moved = []
    for a in (keys, vals):
        flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=card)
        flat[1:] = a.reshape(-1).to(card)
        moved.append(flat[1:].reshape(a.shape))
    gk, gv = dv.bitonic128(*moved)
    wk, wv = dv.bitonic128_ref(keys, vals)
    assert torch.equal(gk.cpu(), wk) and torch.equal(gv.cpu(), wv)


def test_devprims_tool_on_card(card):
    """The probe tool end to end on the card at B = 2: every case, every
    new kernel launched."""
    from qatzip_tpu_torch.tools import devprims as tool
    cuda_pack.reset_launch_counts()
    lines = tool.main(["--device", "cuda", "--b", "2", "--iters", "1"])
    assert len(lines) == 14 and lines[-1]["ok"] is True
    for k in ("lane_gather", "sublane_gather", "roll_sum", "bitonic128"):
        assert cuda_pack.LAUNCHES[k] > 0, k
    cpu = tool.main(["--device", "cpu", "--b", "2", "--iters", "1"])
    assert [ln.get("sum") for ln in lines] == [ln.get("sum") for ln in cpu]


@pytest.mark.parametrize("static,sw_backup", [(False, 1), (True, 1),
                                              (False, 2)],
                         ids=["dynamic", "static", "auto-select-best"])
def test_row_split_on_card_matches_cpu(card, static, sw_backup):
    """256 KiB chunks: the card's device packs against the CPU engine
    held on the same route; QZ_AUTO_SELECT_BEST picks the same way."""
    import zlib as _zlib
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.parallel.dispatch import CudaEngine
    from corpus import make_corpus
    c = make_corpus()
    data = c["text"][:400000] + c["binary"][:100000] + c["noise"][:30000]
    own = CudaEngine.packs_on_device
    outs = []
    try:
        CudaEngine.packs_on_device = (lambda self, s, algorithm="deflate":
                                      algorithm != "lz4s")
        for device in ("cpu", "cuda"):
            sess = qz.QzSession(device=device)
            p = qz.SessionParamsDeflate()
            p.common.hw_buff_sz = 262144
            p.common.sw_backup = sw_backup
            if static:
                p.huffman_hdr = qz.HuffmanHdr.STATIC_HDR
            assert sess.setup_deflate(p) == qz.QZ_OK
            outs.append(sess.compress(data))
    finally:
        CudaEngine.packs_on_device = own
    assert outs[0] == outs[1]
    d = _zlib.decompressobj(31)
    assert d.decompress(outs[1]) == data[:262144]


# ---------------------------------------------------------------------------
# the binding: every wrapper on the caller's stream, refused launches
# ---------------------------------------------------------------------------

def _card_calls(kernel):
    """(call, plain, host tensors) of one kernel wrapper at a small shape:
    ``call(*tensors)`` runs the wrapper, ``plain(*host)`` its plain
    version on the host tensors."""
    from qatzip_tpu_torch.ops import devprims as dv
    rng = np.random.default_rng(61)

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))
    if kernel == "candidate_search":
        key, ctx, pbits = _k2_inputs(256, 6, 3, seed=5)
        kw = dict(probes=7, min_match=4, pbits=pbits)
        return (lambda k, c: cuda_pack.candidate_search(k, c, **kw),
                lambda k, c: cuda_pack.candidate_search_ref(k, c, **kw),
                [key, ctx])
    if kernel == "parse_scan":
        im, ml = parse_plane("past-end", 2, 2, 512, seed=3)
        return (lambda a, b: cuda_pack.parse_scan(a, b, 512),
                lambda a, b: cuda_pack.parse_scan_ref(a, b, 512),
                [torch.from_numpy(im), torch.from_numpy(ml)])
    if kernel == "pack_rows":
        args, kw, _plan = pack_args("far-4", pack_plane("far-4", 2, 1024),
                                    True)
        mw = _max_words(1024, True)

        def run(f):
            return lambda *t: f(*t[:5], max_words=mw, lpack=t[5], dpack=t[6])
        return (run(dp.pack_rows), run(dp.pack_rows_ref),
                args + [kw["lpack"], kw["dpack"]])
    if kernel == "huffman_lookup":
        return (cuda_pack.huffman_lookup, cuda_pack.huffman_lookup_ref,
                [ints(0, 1 << 20, (3, 286)), ints(0, 1 << 20, (3, 30)),
                 ints(-5, 300, (3, 1000)), ints(-5, 40, (3, 1000))])
    if kernel == "symbol_histogram":
        return (cuda_pack.symbol_histogram, cuda_pack.symbol_histogram_ref,
                [ints(-5, 330, (3, 1000)), ints(270, 330, (3, 1000))])
    if kernel == "lz4_pack_rows":
        mw = lp.lz4_max_words(1024)
        data, lengths = lz4_rows(1024)
        planes = lp.lz4_planes(data, lengths, n=1024)
        host = [data] + [p.to(torch.int32) if p.dtype != torch.bool else p
                         for p in planes]
        return (lambda *t: lp.lz4_pack_rows(*t, max_words=mw),
                lambda *t: lp.lz4_pack_rows_ref(*t, max_words=mw), host)
    if kernel == "lane_gather":
        return (dv.lane_gather, dv.lane_gather_ref,
                [_words(rng, (64, 128)), ints(-128, 128, (64, 128))])
    if kernel == "sublane_gather":
        return (dv.sublane_gather, dv.sublane_gather_ref,
                [_words(rng, (512, 128)), ints(-512, 512, (512, 128))])
    if kernel == "roll_sum":
        return (dv.roll_sum, dv.roll_sum_ref,
                [_words(rng, (1001, 128)),
                 torch.tensor((1, 3, 9, 27, 31, 77, 111), dtype=torch.int32)])
    if kernel == "bitonic128":
        return (dv.bitonic128, dv.bitonic128_ref,
                [_bitonic_keys("ties-bit31", rng, 37), _words(rng, (37, 128))])
    raise ValueError(kernel)


@pytest.mark.parametrize("kernel", sorted(cuda_pack.LAUNCHES))
def test_wrapper_launches_on_the_current_side_stream(card, kernel):
    """Inside ``torch.cuda.stream(side)``, with its inputs made on that
    stream behind a ~10 ms sleep, each wrapper launches its kernel once
    on ``side``: a launch on any other stream would read the inputs
    before they exist. After ``side.synchronize()`` the result equals the
    plain version's."""
    call, plain, host = _card_calls(kernel)
    staged = [t.to(card) for t in host]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    before = cuda_pack.LAUNCHES[kernel]
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)
        got = call(*[t.clone() for t in staged])
    assert cuda_pack.LAUNCHES[kernel] == before + 1
    side.synchronize()
    want = plain(*host)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_refused_launch_raises_and_is_not_counted(card, monkeypatch):
    """A launch the C entry refuses raises RuntimeError through the
    wrapper, nothing takes a plain version's place, and the launch is not
    counted: 33 run-time shifts (the roll kernel stages 32) and a row
    image past a CTA's shared memory (the row bit-packer), each let past
    the wrapper's own check; then the same through the binding alone,
    and a launch the CUDA runtime itself refuses."""
    from qatzip_tpu_torch.ops import devprims as dv
    x = torch.zeros((8, 128), dtype=torch.int32, device=card)
    sh = torch.ones(33, dtype=torch.int32, device=card)
    before = dict(cuda_pack.LAUNCHES)
    monkeypatch.setattr(dv, "MAX_SHIFTS", 64)
    with pytest.raises(RuntimeError, match=r"^roll_sum launch failed: "
                       r"cudaError 1 "):
        dv.roll_sum(x, sh)
    args, kw, _plan = pack_args("far-4", pack_plane("far-4", 1, 512), False)
    on_card = [a.to(card) for a in args]
    monkeypatch.setattr(dp, "MAX_SMEM", 1 << 30)
    with pytest.raises(RuntimeError, match=r"^pack_rows launch failed: "):
        dp.pack_rows(*on_card, max_words=1 << 20,
                     data=kw["data"].to(card))
    assert cuda_pack.LAUNCHES == before
    k = cuda_pack.kernels()
    out = torch.empty_like(x)
    with pytest.raises(RuntimeError, match="cudaError 1 "):
        k.roll_sum(x.data_ptr(), sh.data_ptr(), 33, out.data_ptr(), 8,
                   k.stream(card.index))
    k.roll_sum(x.data_ptr(), sh.data_ptr(), 32, out.data_ptr(), 8,
               k.stream(card.index))
    torch.cuda.synchronize()
    assert torch.equal(out, x)
    # a launch the CUDA runtime refuses (a grid of no blocks), then the
    # next launch runs: the error is not left behind
    hist = torch.zeros((1, cuda_pack.NBINS), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match=r"^symbol_histogram launch "
                       r"failed: cudaError 9 \(invalid configuration"):
        k.symbol_histogram(x.data_ptr(), x.data_ptr(), hist.data_ptr(), 0,
                           128, k.stream(card.index))
    sym = torch.arange(256, dtype=torch.int32, device=card)[None]
    got = cuda_pack.symbol_histogram(sym, sym)
    assert torch.equal(got.cpu(), cuda_pack.symbol_histogram_ref(
        sym.cpu(), sym.cpu()))
