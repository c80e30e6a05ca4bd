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
from qatzip_tpu_torch.ops import lz77
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
    if kernel == "lz4_resolve_refs":
        from qatzip_tpu_torch.ops import lz4_decode as ld
        planes = torch.from_numpy(lz4_ref_planes(
            [b"A" * 3000, bytes(rng.integers(0, 4, 4000, dtype=np.uint8))],
            4096))
        return (lambda r: ld.resolve_refs(r, 13),
                lambda r: ld.resolve_refs_ref(r, 13), [planes])
    if kernel == "search_inputs":
        kw = dict(min_match=4, ctx_words=3, width=256, overlap=64)
        return (lambda d, ln: lz77.search_inputs(d, ln, **kw),
                lambda d, ln: lz77.search_inputs_ref(d, ln, **kw),
                list(stage_rows("corpus", 1024)))
    if kernel == "parse_inputs":
        data, lengths = stage_rows("corpus", 1024)
        key, ctx, pbits, ov = lz77._search_inputs(
            data, lengths, n=1024, min_match=4, window=32768, ctx_words=3,
            search_seg=256, search_overlap=64)
        kv = cuda_pack.candidate_search_ref(key, ctx, probes=7, min_match=4,
                                            pbits=pbits)
        kw = dict(n=1024, overlap=ov, min_match=4, max_match=258,
                  ctx_bytes=12, parse_seg=512)
        return (lambda ln, k: lz77.parse_inputs(ln, kv=k, **kw),
                lambda ln, k: lz77.parse_inputs_ref(ln, kv=k, **kw),
                [lengths, kv])
    if kernel == "symbol_planes":
        host = [torch.from_numpy(np.ascontiguousarray(a))
                for a in pack_plane("run-258", 2, 1024)]
        return (lambda *t: dp.symbol_planes(*t, mode=1),
                lambda *t: dp.symbol_planes_ref(*t, mode=1), host)
    if kernel == "crc32_rows":
        from qatzip_tpu_torch.ops import crc32_mxu as cm
        return (lambda d: cm.crc32_batch_device(d, n=3000),
                lambda d: cm.crc32_batch_ref(d, n=3000),
                [torch.from_numpy(rng.integers(0, 256, (5, 3000),
                                               dtype=np.uint8))])
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


# ---------------------------------------------------------------------------
# streams, batches, async requests and threads on the card
# ---------------------------------------------------------------------------

def _slice_requests():
    from corpus import make_corpus
    c = make_corpus()
    return ([c["text"][i * 40000:(i + 1) * 40000] for i in range(6)]
            + [c["json"][:5000], c["runs"][:700], c["binary"][:70000], b""])


def _device_pack_session(device, hw=16384):
    import qatzip_tpu_torch as qz
    sess = qz.QzSession(device=device)
    p = qz.SessionParamsDeflate()
    p.common.hw_buff_sz = hw
    assert sess.setup_deflate(p) == qz.QZ_OK
    return sess


@pytest.fixture()
def device_pack(monkeypatch):
    """Both engines held on the device pack (the card's own route for a
    dynamic session; the CPU's is the token path)."""
    from qatzip_tpu_torch.parallel.dispatch import CudaEngine
    monkeypatch.setattr(CudaEngine, "packs_on_device",
                        lambda self, s, algorithm="deflate": True)


def test_stream_batch_and_async_on_card_match_cpu(card, device_pack):
    """A stream, a batch and async requests give the card the CPU's bytes
    on the same route, and each request its ``compress`` output."""
    import threading
    import time
    import qatzip_tpu_torch as qz
    reqs = _slice_requests()
    data = b"".join(reqs)
    outs = {}
    for device in ("cpu", "cuda"):
        sess = _device_pack_session(device)
        strm = qz.QzStream(sess, strm_buff_sz=3 * 16384)
        blob = b"".join(strm.compress(data[o:o + 10000])
                        for o in range(0, len(data), 10000))
        blob += strm.compress(b"", last=True)
        assert strm.crc_32 == zlib.crc32(data)
        batch = sess.compress_batch(reqs)
        assert batch == [sess.compress(r, with_crc=True) for r in reqs]
        assert qz.aqz_init(num_threads=2) == qz.QZ_OK
        try:
            got, done = {}, threading.Event()

            def cb(external, src, dest, rc, crc):
                got[external] = (rc, dest)
                if len(got) == len(reqs):
                    done.set()
            asess = qz.AQzSession(session=sess)
            for i, r in enumerate(reqs):
                while asess.compress(r, cb, external=i) == qz.AQZ_NO_SPACE:
                    time.sleep(0.001)
            assert done.wait(120)
        finally:
            qz.aqz_stop()
        assert [got[i] for i in range(len(reqs))] == [(qz.QZ_OK, o)
                                                      for o, _c in batch]
        outs[device] = (blob, batch)
    assert outs["cpu"] == outs["cuda"]
    import gzip
    assert gzip.decompress(outs["cuda"][0]) == data


def test_two_threads_share_one_card_session(card):
    """Two threads compressing through one CUDA session (one engine) at
    once give each request its single-thread bytes."""
    import threading
    reqs = _slice_requests()[:6] * 3
    sess = _device_pack_session("cuda", hw=65536)
    want = [sess.compress(r) for r in reqs]
    got = [None] * len(reqs)
    errors = []

    def work(idx):
        try:
            for i in idx:
                got[i] = sess.compress(reqs[i])
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)
    threads = [threading.Thread(target=work, args=(range(k, len(reqs), 2),))
               for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert got == want


# ---------------------------------------------------------------------------
# the device LZ4 decode and the device CRC32
# ---------------------------------------------------------------------------

def lz4_ref_planes(rows, n):
    """(B, n) int32 reference planes of the rows' LZ4 blocks (the host
    parse of the device decode), -1 padded."""
    from qatzip_tpu_torch import native
    lib = native.get_lib()
    refs = np.full((len(rows), n), -1, np.int32)
    for i, r in enumerate(rows):
        assert lib.lz4_ref_block(lib.lz4_compress_block(r), refs[i], n) \
            == len(r)
    return refs


def _resolve_rows(kind, n):
    from corpus import make_corpus
    rng = np.random.default_rng(17)
    if kind == "A * n":
        return [b"A" * n] * 3
    if kind == "all literals":
        return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()] * 3
    if kind == "corpus, B = 1":
        return [make_corpus()["text"][:n]]
    if kind == "corpus, B = 3":
        c = make_corpus()
        return [c["text"][:n], c["json"][:n // 2], c["runs"][:n - 7]]
    if kind == "300,001 bytes":
        return [b"Z" * 300001]
    raise ValueError(kind)


@pytest.mark.parametrize("kind,n", [
    ("A * n", 65536), ("all literals", 65536), ("corpus, B = 1", 65536),
    ("corpus, B = 3", 65536), ("300,001 bytes", 524288)])
def test_lz4_resolve_refs_kernel_matches_plain(card, kind, n):
    """Bytes and flag bit for bit at the decode's rounds, on chains of
    depth n - 1, rows of literals only, 1 and 3 rows (the chunk kernel,
    which leaves the plane as it was) and a 300,001-byte block at
    n = 524288 (the wide kernel, which jumps the plane in place)."""
    from qatzip_tpu_torch.ops import lz4_decode as ld
    host = torch.from_numpy(lz4_ref_planes(_resolve_rows(kind, n), n))
    rounds = (n - 1).bit_length() + 1
    on_card = host.to(card)
    before = cuda_pack.LAUNCHES["lz4_resolve_refs"]
    got, flag = ld.resolve_refs(on_card, rounds)
    assert cuda_pack.LAUNCHES["lz4_resolve_refs"] == before + 1
    want, want_flag = ld.resolve_refs_ref(host.clone(), rounds)
    assert not bool(flag) and not bool(want_flag)
    assert torch.equal(got.cpu(), want)
    if n <= 65536:
        assert torch.equal(on_card.cpu(), host)
    else:
        assert (on_card < 0).all()


@pytest.mark.parametrize("rounds", [0, 1, 3, 8])
def test_lz4_resolve_refs_kernel_too_few_rounds(card, rounds):
    """With too few rounds the shared-memory kernel (n = 65536) runs the
    plain version's synchronous rounds: the same flag and the same bytes
    (a valid plane holds no index past the row), in at most ``rounds``
    rounds."""
    from qatzip_tpu_torch.ops import lz4_decode as ld
    host = torch.from_numpy(lz4_ref_planes(_resolve_rows("corpus, B = 3",
                                                         65536), 65536))
    want, want_flag = ld.resolve_refs_ref(host.clone(), rounds)
    got, flag = ld.resolve_refs(host.to(card), rounds)
    assert bool(flag) == bool(want_flag)
    assert torch.equal(got.cpu(), want)
    if rounds == 0:
        assert bool(flag)
    print(f"rounds {rounds}: unresolved {bool(flag)}")


@pytest.mark.parametrize("n", [4, 32, 2048, 16384, 32768, 65536])
@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_lz4_resolve_refs_kernel_at_the_jax_rounds(card, n, extra):
    """At (n - 1).bit_length() rounds, the fewest with which the plain
    version resolves any valid row, one fewer and one more: a chain of
    depth n - 1 ([lit, 0, 1, ...]) and b"A" * n, bytes and flag bit for
    bit. Rows within one chunk of 16384 take the shared-memory rounds
    there (the chunks would need one pass more), wider rows the chunks."""
    from qatzip_tpu_torch.ops import lz4_decode as ld
    rounds = max((n - 1).bit_length() + extra, 0)
    chain = np.arange(-1, n - 1, dtype=np.int32)[None, :]
    chain[0, 0] = -1 - ord("A")
    host = torch.from_numpy(np.concatenate(
        [chain, lz4_ref_planes([b"A" * n], n)]))
    want, want_flag = ld.resolve_refs_ref(host.clone(), rounds)
    got, flag = ld.resolve_refs(host.to(card), rounds)
    assert bool(flag) == bool(want_flag)
    assert torch.equal(got.cpu(), want)
    if extra >= 0:
        assert not bool(flag)


@pytest.mark.parametrize("rounds", [0, 1, 3, 8])
def test_lz4_resolve_refs_wide_kernel_too_few_rounds(card, rounds):
    """With too few rounds the wide kernel (n = 131072) runs at most
    ``rounds`` passes, jumping in place, so every entry is at least as far
    along its chain as after the plain version's rounds: each entry the
    plain version resolved holds the same literal, and where the plain
    version resolves every entry the kernel gives its bytes. It may
    resolve where the plain version does not."""
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from corpus import make_corpus
    n = 131072
    c = make_corpus()
    host = torch.from_numpy(lz4_ref_planes(
        [(c["text"] * 2)[:n], b"A" * 100000], n))
    plain_plane = host.clone()
    want, want_flag = ld.resolve_refs_ref(plain_plane, rounds)
    plane = host.to(card)
    got, flag = ld.resolve_refs(plane, rounds)
    plane = plane.cpu()
    done = plain_plane < 0
    assert torch.equal(plane[done], plain_plane[done])
    if not bool(want_flag):
        assert not bool(flag) and torch.equal(got.cpu(), want)
    if rounds == 0:
        assert bool(flag) and bool(want_flag)
        assert torch.equal(plane, host)


def _odd_plane(case, n):
    """A plane with entries no LZ4 parse makes: forward references (to a
    resolving entry and a two-cycle), a self reference, or indices past
    the row (the JAX function clips them), over a valid corpus plane."""
    from corpus import make_corpus
    c = make_corpus()
    ref = lz4_ref_planes([c["text"][:n], b"B" * n, c["json"][:n]], n)
    if case == "forward and self":
        ref[0, 100] = n - 5
        ref[1, 777] = 777
        ref[2, 3], ref[2, 4] = 4, 3
    elif case == "forward only":
        ref[0, 100] = n - 5
        ref[2, 40] = 41
    else:
        ref[0, 50] = n + 1000
        ref[1, 0] = 1 << 30
    return torch.from_numpy(ref)


@pytest.mark.parametrize("n", [65536, 131072])
@pytest.mark.parametrize("case", ["forward and self", "forward only",
                                  "past the row"])
def test_lz4_resolve_refs_kernel_odd_references(card, case, n):
    """Forward and self references and indices past the row: the flag of
    the plain version (the JAX function's rounds) at the decode's rounds,
    and its bytes at every entry it resolved (every byte where every
    entry resolves)."""
    from qatzip_tpu_torch.ops import lz4_decode as ld
    host = _odd_plane(case, n)
    rounds = (n - 1).bit_length() + 1
    plain_plane = host.clone()
    want, want_flag = ld.resolve_refs_ref(plain_plane, rounds)
    got, flag = ld.resolve_refs(host.to(card), rounds)
    got = got.cpu()
    assert bool(flag) == bool(want_flag) == (case == "forward and self")
    done = plain_plane < 0
    assert torch.equal(got[done], want[done])
    if case != "forward and self":
        assert torch.equal(got, want)


def test_lz4_device_decode_leg_on_card(card, monkeypatch):
    """An LZ4 session on the card held on the device decode leg decodes
    its own frames and a concatenated pair, through lz4_resolve_refs, to
    what the host leg gives."""
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.parallel.dispatch import CudaEngine
    from corpus import make_corpus
    c = make_corpus()
    data = c["text"][:300000] + c["noise"][:70000] + c["binary"][:100000]
    sess = qz.QzSession(device="cuda")
    sess.setup_lz4()
    frame = sess.compress(data)
    pair = frame + sess.compress(data[:70000])
    host = [sess.decompress(f) for f in (frame, pair)]
    monkeypatch.setattr(CudaEngine, "decodes_on_device", lambda self: True)
    cuda_pack.reset_launch_counts()
    got = [sess.decompress(f) for f in (frame, pair)]
    assert got == host == [data, data + data[:70000]]
    assert cuda_pack.LAUNCHES["lz4_resolve_refs"] >= 3


@pytest.mark.parametrize("kind,n", [
    ("random", 65536), ("zero", 65536), ("ff", 65536), ("random", 2048),
    ("random", 8192), ("random", 131072), ("random", 300001),
    ("random", 70000), ("random", 1000), ("random", 65544),
    ("unaligned", 4096), ("unaligned", 65536), ("random", 2049),
    ("random", 16)])
def test_crc32_rows_kernel_matches_plain_and_zlib(card, kind, n):
    """Every row's crc equals the plain version's and zlib's, for 5 rows
    (a group of 16 rows mostly empty): random, zero and 0xFF rows; rows
    shorter than a 2 KiB block (1000, 16); one, four, 32, 64 and 147
    blocks (2048, 8192, 65536, 131072, 300001); a front block mostly
    padding (2049, 70000, 65544); n not a multiple of 16 and rows off
    their 16-byte alignment (the byte loads)."""
    from qatzip_tpu_torch.ops import crc32_mxu as cm
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (5, n + 1), dtype=np.uint8)
    if kind == "zero":
        data[:] = 0
    elif kind == "ff":
        data[:] = 0xFF
    flat = torch.from_numpy(data.reshape(-1)).to(card)
    if kind == "unaligned":
        rows = flat[1:1 + 5 * n].reshape(5, n)
    else:
        rows = flat[:5 * n].reshape(5, n)
    host = rows.cpu()
    got = cm.crc32_batch_device(rows, n=n)
    assert got.dtype == torch.int64
    assert torch.equal(got.cpu(), cm.crc32_batch_ref(host, n=n))
    assert got.tolist() == [zlib.crc32(r.numpy().tobytes()) for r in host]


@pytest.mark.parametrize("b", [1, 3, 256, 1024])
def test_crc32_rows_kernel_batch_sizes(card, b):
    """B = 1, 3, 256 and 1024 rows of 64 KiB: every crc equals the plain
    version's and zlib's, and a second launch on the same rows, right
    after the first, gives the same crcs (a launch leaves no state)."""
    from qatzip_tpu_torch.ops import crc32_mxu as cm
    n = 65536
    rng = np.random.default_rng(b)
    host = torch.from_numpy(rng.integers(0, 256, (b, n), dtype=np.uint8))
    rows = host.to(card)
    first = cm.crc32_batch_device(rows, n=n)
    second = cm.crc32_batch_device(rows, n=n)
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), cm.crc32_batch_ref(rows, n=n).cpu())
    assert first.tolist() == [zlib.crc32(r.numpy().tobytes()) for r in host]


def test_device_crc_on_the_dynamic_device_pack(card, monkeypatch):
    """A dynamic session on the card (the dynamic device pack) with the
    device CRC held: crc32_rows runs, every member's crc and the
    session's equal zlib's, and the bytes equal the host-crc run's (the
    engine held on the host crc, which launches no crc32_rows)."""
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.parallel.dispatch import CudaEngine
    from corpus import make_corpus
    c = make_corpus()
    data = c["text"][:400000] + c["json"][:100000] + c["text"][:3333]
    monkeypatch.setattr(CudaEngine, "crc_on_device", lambda self: False)
    cuda_pack.reset_launch_counts()
    sess = qz.QzSession(device="cuda")
    sess.setup_deflate()
    host = sess.compress(data)
    assert cuda_pack.LAUNCHES["crc32_rows"] == 0
    monkeypatch.setattr(CudaEngine, "crc_on_device", lambda self: True)
    cuda_pack.reset_launch_counts()
    sess2 = qz.QzSession(device="cuda")
    sess2.setup_deflate()
    got = sess2.compress(data)
    assert cuda_pack.LAUNCHES["crc32_rows"] >= 1
    assert cuda_pack.LAUNCHES["pack_rows"] >= 1
    assert got == host
    assert sess2.crc32 == zlib.crc32(data)
    d = zlib.decompressobj(31)
    assert d.decompress(got) == data[:65536]


# ---------------------------------------------------------------------------
# the engine and the mesh functions over several devices
# ---------------------------------------------------------------------------

def _mesh_request():
    """1 MiB of the corpus and a ragged tail, in 64 KiB chunks."""
    from corpus import make_silesia_like
    return make_silesia_like(1) + make_silesia_like(1)[:61001]


@pytest.mark.parametrize("kind,held", [
    ("dynamic", None), ("lz4", None), ("static", None), ("dynamic", False)])
def test_engine_over_two_devices_matches_one(card, monkeypatch, kind, held):
    """The engine over ["cuda:0", "cuda:0"] (each share on its own thread
    and stream) gives the one-card engine's bytes: the main path (the
    dynamic device pack), the LZ4 device pack, the static device pack and
    the token path, each launching its kernels."""
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.parallel.dispatch import CudaEngine, MeshEngine
    if held is not None:
        monkeypatch.setattr(CudaEngine, "packs_on_device",
                            lambda self, s, algorithm="deflate": held)
    data = _mesh_request()
    outs = []
    for device in ("cuda:0", ["cuda:0", "cuda:0"]):
        sess = qz.QzSession(device=device)
        if kind == "lz4":
            assert sess.setup_lz4() == qz.QZ_OK
        else:
            p = qz.SessionParamsDeflate()
            if kind == "static":
                p.huffman_hdr = qz.HuffmanHdr.STATIC_HDR
            assert sess.setup_deflate(p) == qz.QZ_OK
        cuda_pack.reset_launch_counts()
        outs.append(sess.compress(data))
        launched = dict(cuda_pack.LAUNCHES)
        assert sess.decompress(outs[-1]) == data
    assert type(sess._engine) is MeshEngine
    assert sess.devices == (card, card)
    assert outs[0] == outs[1]
    want = {"dynamic": ("symbol_histogram", "huffman_lookup", "pack_rows"),
            "lz4": ("lz4_pack_rows",), "static": ("pack_rows",)}
    # 17 rows: one tile a share, each kernel of the path once a tile
    for k in (("parse_scan", "crc32_rows")
              + (want[kind] if held is None else ("candidate_search",))):
        assert launched[k] == 2, (k, launched)


def test_mesh_functions_on_card_match_cpu(card):
    """The four mesh functions over ["cuda:0", "cuda:0"] give their
    results over two CPU devices."""
    from qatzip_tpu_torch.graft_entry import _example_batch
    from qatzip_tpu_torch.parallel import mesh
    from qatzip_tpu_torch.parallel.dispatch import plan_tile
    n, b = 2048, 4
    data, lengths = _example_batch(b, n)
    got = {}
    for devs in (["cpu", "cpu"], ["cuda:0", "cuda:0"]):
        m = mesh.make_mesh(devs)
        toks = mesh.mesh_tokenize(m, data, lengths, n=n)
        pack = mesh.mesh_pack_device(m, data, lengths, n=n)
        hist, *planes = mesh.mesh_analyze_hist(m, data, lengths, n=n)
        assert all(s.device == m.devices[0] for s in planes[0].shards)
        packs, dpacks, _hdrs, hbits = plan_tile(hist, b)
        dyn = mesh.mesh_pack_dynamic(m, data, *planes, packs, dpacks,
                                     hbits, n=n)
        got[devs[0]] = [*toks, *pack, hist, *dyn]
    assert len(got["cpu"]) == 8
    for a, c in zip(got["cpu"], got["cuda:0"]):
        assert np.array_equal(a, c)


def test_dryrun_multichip_on_card(card):
    from qatzip_tpu_torch.graft_entry import dryrun_multichip, entry
    got = dryrun_multichip(2)
    assert got["rows"] == 4
    assert got["distinct"] == min(2, torch.cuda.device_count())
    fn, args = entry()
    toks, ntok = fn(*args)
    assert toks.shape == (4, 16384) and toks.device == card


def test_runtime_close_on_card(card):
    """qzClose on the card: the pool's engine goes, the next session
    builds a new one with the same bytes, and the device memory in use
    after a close stays where the first close left it."""
    import gc
    import weakref

    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.runtime import get_runtime
    rt = get_runtime()
    data = bytes(range(256)) * 1024
    want, used = None, []
    for _ in range(3):
        s = qz.QzSession("cuda")
        s.setup_deflate()
        got = s.compress(data)
        assert want is None or got == want
        want = got
        engine = weakref.ref(s._engine)
        del s
        assert rt.close() == qz.QZ_OK
        gc.collect()
        torch.cuda.synchronize()
        assert engine() is None
        used.append(torch.cuda.memory_allocated())
    assert used[2] <= used[1]
    import gzip
    assert gzip.decompress(want) == data


def test_forked_child_refuses_cuda_and_runs_cpu(card):
    """A child forked after CUDA came up: QZ_NOSW_NO_HW for a CUDA
    session (naming the spawn start method), the parent's bytes on a CPU
    session held on the card's route."""
    import os
    import time

    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.runtime import get_runtime
    data = bytes(range(256)) * 300
    sess = qz.QzSession("cuda")
    sess.setup_deflate()
    want = sess.compress(data)
    route = sess._engine.packs_on_device(False, "deflate")
    pid = os.fork()
    if pid == 0:
        code = 2
        try:
            torch.set_num_threads(1)
            code = 3
            assert get_runtime().init("cuda") == qz.QZ_NO_HW
            try:
                qz.QzSession("cuda")
                code = 4
            except qz.QzError as e:
                code = 0 if (e.rc == qz.QZ_NOSW_NO_HW
                             and "spawn" in str(e)) else 5
            if code == 0:
                child = qz.QzSession("cpu")
                child._engine.packs_on_device = lambda *_a, **_k: route
                child.setup_deflate()
                code = 0 if child.compress(data) == want else 6
        finally:
            os._exit(code)
    deadline = time.monotonic() + 120
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        if time.monotonic() > deadline:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
            pytest.fail("the forked child hung")
        time.sleep(0.02)
    assert os.waitstatus_to_exitcode(status) == 0


# ---------------------------------------------------------------------------
# compress-and-verify (CnV) on the card
# ---------------------------------------------------------------------------

_CNV_REC = b"".join(b"rec%05d;" % i for i in range(5000))
_CNV_SPLIT = b"".join(b"split row %d; " % i for i in range(30000))
_CNV_DEFLATE = [(b"inject %d " % i) * 400 for i in range(4)]
_CNV_LZ4 = [b"engine path " * 3000,
            np.random.default_rng(8).integers(0, 256, 50000,
                                              dtype=np.uint8).tobytes(),
            b"R" * 40000, b"", _CNV_REC + _CNV_REC[:20000]]
_CNV_SPLIT_CHUNKS = [_CNV_SPLIT[:262144], _CNV_SPLIT[5000:105000]]
# route -> (algorithm, huffman_static, held on the device pack, chunks,
#           the first bytes of the rows a fault corrupts, the chunks whose
#           payload it changes, the function the fault follows)
CNV_ROUTES = {
    "token-mode0": ("deflate", False, False, _CNV_DEFLATE, (), (), None),
    "token-mode1": ("deflate", True, False, _CNV_DEFLATE, (), (), None),
    "static-device-pack": ("deflate", True, True, _CNV_DEFLATE,
                           (b"inject 1 ", b"inject 2 "), (1, 2),
                           "deflate_pack_device"),
    "dynamic-device-pack": ("deflate", False, True, _CNV_DEFLATE,
                            (b"inject 0 ", b"inject 3 "), (0, 3),
                            "deflate_pack_dynamic"),
    "split-token": ("deflate", False, False, _CNV_SPLIT_CHUNKS, (), (),
                    None),
    "split-dynamic-device-pack": ("deflate", False, True, _CNV_SPLIT_CHUNKS,
                                  (_CNV_SPLIT[65536:65568],), (0,),
                                  "deflate_pack_dynamic"),
    "lz4-token": ("lz4", False, False, _CNV_LZ4, (), (), None),
    "lz4-device-pack": ("lz4", False, True, _CNV_LZ4,
                        (b"engine path", b"rec00000;"), (0, 4),
                        "lz4_pack_device"),
    "lz4s": ("lz4s", False, False, _CNV_LZ4, (), (), None),
}


def _cnv_flip(dd, words, used, heads, per_word, ok=None):
    """``words`` with a byte flipped in the middle of the used words of
    the rows of ``dd`` that start with one of ``heads`` (and are ok)."""
    rows = dd.cpu().numpy()
    used = used.cpu().numpy()
    words = words.clone()
    for i, row in enumerate(rows):
        if row.tobytes().startswith(heads) and (ok is None or bool(ok[i])):
            words[i, int(used[i]) // per_word] ^= 0x00FF0000
    return words


def _cnv_inject(monkeypatch, route):
    """Corrupt the device words of the route's chosen rows after the
    kernels that made them."""
    from qatzip_tpu_torch.parallel import dispatch
    heads, where = CNV_ROUTES[route][4], CNV_ROUTES[route][6]
    real = getattr(dispatch, where)
    if where == "lz4_pack_device":
        def fault(dd, ll, *, n):
            words, nbytes, ok = real(dd, ll, n=n)
            return _cnv_flip(dd, words, nbytes, heads, 8, ok), nbytes, ok
    else:
        def fault(dd, *args, **kw):
            words, nbits = real(dd, *args, **kw)
            return _cnv_flip(dd, words, nbits, heads, 64), nbits
    monkeypatch.setattr(dispatch, where, fault)


def _cnv_compress(device, route, cnv):
    from qatzip_tpu_torch.parallel.dispatch import CudaEngine
    algorithm, static, _dp, chunks, _h, _c, _w = CNV_ROUTES[route]
    return CudaEngine(device).compress_chunks(
        chunks, level=1, algorithm=algorithm, huffman_static=static,
        cnv=cnv)


def _cnv_hold(monkeypatch, route):
    from qatzip_tpu_torch.parallel.dispatch import CudaEngine
    dp = CNV_ROUTES[route][2]
    monkeypatch.setattr(CudaEngine, "packs_on_device",
                        lambda self, s, algorithm="deflate": dp)


def cnv_keeps_the_bytes(device, monkeypatch, route):
    """``cnv=True`` gives the ``cnv=False`` bytes on ``device`` and the
    CPU's, with no fallback."""
    from qatzip_tpu_torch.utils.debug import get_counters
    _cnv_hold(monkeypatch, route)

    def fallbacks():
        return sum(c.get("cnv_fallback", 0)
                   for c in get_counters().snapshot().values())
    before = fallbacks()
    got = _cnv_compress(device, route, True)
    assert got == _cnv_compress(device, route, False)
    assert got == _cnv_compress("cpu", route, False)
    assert fallbacks() == before


def cnv_recovers_a_device_fault(device, monkeypatch, route):
    """A byte flipped in the chosen rows' device words: ``cnv=False``
    ships it in exactly those chunks, ``cnv=True`` codes exactly those
    again (the host engine's stock zlib; the native LZ4 block coder on
    the LZ4 device pack) and every chunk decodes."""
    from qatzip_tpu_torch import native
    from qatzip_tpu_torch.engines import host_engine
    algorithm, _s, _dp, chunks, _h, corrupted, _w = CNV_ROUTES[route]
    _cnv_hold(monkeypatch, route)
    clean = _cnv_compress(device, route, False)
    _cnv_inject(monkeypatch, route)
    bad = _cnv_compress(device, route, False)
    assert [i for i, (b, c) in enumerate(zip(bad, clean)) if b != c] == \
        list(corrupted)
    got = _cnv_compress(device, route, True)
    lib = native.get_lib()
    for i, chunk in enumerate(chunks):
        if i not in corrupted:
            assert got[i] == clean[i]
            continue
        assert got[i][1] == clean[i][1]
        if algorithm == "lz4":
            assert got[i][0] == lib.lz4_compress_block(chunk)
        else:
            assert got[i][0] == host_engine.compress_chunks(
                [chunk], level=1, sw_coder="zlib")[0][0]
    for chunk, (payload, _crc) in zip(chunks, got):
        if algorithm == "lz4":
            assert lib.lz4_decompress_block(payload, len(chunk)) == chunk
        else:
            assert zlib.decompressobj(-15).decompress(payload) == chunk


@pytest.mark.parametrize("route", sorted(CNV_ROUTES))
def test_cnv_on_card_keeps_the_bytes(card, monkeypatch, route):
    cnv_keeps_the_bytes(card, monkeypatch, route)


@pytest.mark.parametrize("route", sorted(r for r, v in CNV_ROUTES.items()
                                         if v[6]))
def test_cnv_on_card_recovers_a_device_fault(card, monkeypatch, route):
    cnv_recovers_a_device_fault(card, monkeypatch, route)


# ---------------------------------------------------------------------------
# the stage kernels around the search and the parse, and the dynamic
# pack's symbol planes
# ---------------------------------------------------------------------------

STAGE_KINDS = ("random", "zero", "A", "periodic", "corpus")
STAGE_WIDTHS = (256, 4096, 8192, 65536)
#: (lz4_rules, max_match): DEFLATE, the LZ4 device pack, LZ4 and LZ4s on
#: the token path
STAGE_RULES = ((False, 258), (True, 273), (True, 32767), (False, 32767))


def stage_rows(kind, n, seed=0):
    """(data, lengths) CPU tensors: nine rows of ``kind`` zeroed past the
    ragged lengths 0, 1, 3, 4, 11, 12, 13, n - 1 and n."""
    from corpus import make_silesia_like   # tests/ is on sys.path
    rng = np.random.default_rng(seed)
    lengths = np.array([0, 1, 3, 4, 11, 12, 13, n - 1, n], np.int32)
    b = len(lengths)
    if kind == "random":
        data = rng.integers(0, 256, (b, n), dtype=np.uint8)
    elif kind == "zero":
        data = np.zeros((b, n), np.uint8)
    elif kind == "A":
        data = np.full((b, n), 65, np.uint8)
    elif kind == "periodic":
        unit = rng.integers(0, 256, 37, dtype=np.uint8)
        data = np.tile(unit, (b, n // 37 + 1))[:, :n].copy()
    elif kind == "corpus":
        blob = make_silesia_like(max(1, b * n >> 20))
        data = np.frombuffer(blob[:b * n], np.uint8).reshape(b, n).copy()
    else:
        raise ValueError(kind)
    for i, ln in enumerate(lengths):
        data[i, ln:] = 0
    return torch.from_numpy(data), torch.from_numpy(lengths)


def _searches(n):
    """The search_seg values whose windows the kernel serves at n: the
    level-1 8K windows over rows wider than 8192, else the whole row."""
    return (8192,) if n > lz77.MAX_WINDOW else (0, 8192)


@pytest.mark.parametrize("kind", STAGE_KINDS)
@pytest.mark.parametrize("n", STAGE_WIDTHS)
def test_search_inputs_kernel_matches_plain(card, n, kind):
    data, lengths = stage_rows(kind, n, seed=n)
    for ctx_words in (3, 4):
        for ss in _searches(n):
            kw = dict(n=n, min_match=4, window=32768, ctx_words=ctx_words,
                      search_seg=ss, search_overlap=896)
            want = lz77._search_inputs(data, lengths, **kw)
            before = cuda_pack.LAUNCHES["search_inputs"]
            got = lz77._search_inputs(data.to(card), lengths.to(card), **kw)
            torch.cuda.synchronize()
            assert cuda_pack.LAUNCHES["search_inputs"] == before + 1
            assert got[2:] == want[2:]
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("kind", STAGE_KINDS)
@pytest.mark.parametrize("n", STAGE_WIDTHS)
def test_parse_inputs_kernel_matches_plain(card, n, kind):
    """Both candidate forms (the search kernel's windows, the full-row
    search's rows), ctx_words 3 and 4, every route's rules; the launches
    are those of ``parse_inputs_launches``."""
    data, lengths = stage_rows(kind, n, seed=n + 1)
    dd, ll = data.to(card), lengths.to(card)
    for ctx_words in (3, 4):
        for ss in (0, 8192):
            cand = lz77._candidates(dd, ll, n=n, min_match=4, window=32768,
                                    ctx_words=ctx_words, probes=7,
                                    search_seg=ss, search_overlap=896)
            host = {k: v.cpu() if torch.is_tensor(v) else v
                    for k, v in cand.items()}
            for lz4_rules, max_match in STAGE_RULES:
                kw = dict(n=n, min_match=4, max_match=max_match,
                          ctx_bytes=4 * ctx_words, parse_seg=8192,
                          lz4_rules=lz4_rules)
                want = lz77.parse_inputs_ref(lengths, **host, **kw)
                before = cuda_pack.LAUNCHES["parse_inputs"]
                got = lz77.parse_inputs(ll, **cand, **kw)
                torch.cuda.synchronize()
                assert cuda_pack.LAUNCHES["parse_inputs"] == before + len(
                    lz77.parse_inputs_launches(n=n, max_match=max_match,
                                               ctx_bytes=4 * ctx_words))
                assert all(torch.equal(g.cpu(), w)
                           for g, w in zip(got, want)), (ctx_words, ss,
                                                         max_match)


@pytest.mark.parametrize("kind", STAGE_KINDS)
@pytest.mark.parametrize("n", STAGE_WIDTHS)
def test_symbol_planes_kernel_matches_plain(card, n, kind):
    """Both modes on the level-1 parse's planes of the rows, and on odd
    planes (lengths and distances outside DEFLATE's, overlapping taken
    and lit)."""
    data, lengths = stage_rows(kind, n, seed=n + 2)
    ss, ov, _cs, ctx_words, probes = _tok_knobs(1, n)
    planes = dp._analyze_planes(data.to(card), lengths.to(card), n=n,
                                parse_seg=8192, ctx_words=ctx_words,
                                probes=probes, search_seg=ss,
                                search_overlap=ov)
    rng = np.random.default_rng(n)
    b = data.shape[0]
    odd = [torch.from_numpy(rng.integers(-40000, 70000, (b, n)).astype(
        np.int32)), torch.from_numpy(rng.integers(-5, 1 << 25, (b, n)).astype(
            np.int32)), torch.from_numpy(rng.random((b, n)) < 0.4),
        torch.from_numpy(rng.random((b, n)) < 0.4)]
    for p in (list(planes), odd):
        host = [data] + [t.cpu() for t in p]
        on_card = [data.to(card)] + [t.to(card) for t in p]
        for mode in (1, 2):
            want = dp.symbol_planes_ref(*host, mode=mode)
            before = cuda_pack.LAUNCHES["symbol_planes"]
            got = dp.symbol_planes(*on_card, mode=mode)
            torch.cuda.synchronize()
            assert cuda_pack.LAUNCHES["symbol_planes"] == before + 1
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def _plain_glue_refused(monkeypatch):
    """Make every plain version of the three stage kernels, and the torch
    stages they stand for, raise when it meets a CUDA tensor."""
    def guard(fn):
        def call(*args, **kwargs):
            if any(torch.is_tensor(a) and a.is_cuda
                   for a in (*args, *kwargs.values())):
                raise AssertionError(f"{fn.__name__} ran on the card")
            return fn(*args, **kwargs)
        return call
    for mod, name in ((lz77, "search_inputs_ref"),
                      (lz77, "parse_inputs_ref"), (lz77, "_parse_inputs"),
                      (lz77, "_extend_matches"), (lz77, "_unwindow"),
                      (dp, "symbol_planes_ref"), (dp, "hist_symbols"),
                      (dp, "lookup_symbols")):
        monkeypatch.setattr(mod, name, guard(getattr(mod, name)))


@pytest.mark.parametrize("mib", [0, 64], ids=["64k", "64m"])
@pytest.mark.parametrize("route", ["dynamic", "static", "lz4"])
def test_stage_kernels_on_the_device_packs(card, monkeypatch, route, mib):
    """A 64 KiB and a 64 MiB request on each device pack: no plain stage
    runs on the card, ``search_inputs`` and ``parse_inputs`` launch once
    a tile (the LZ4 pack's full-row search takes no windows) and
    ``symbol_planes`` twice a dynamic tile, and the bytes equal those of
    the same request with the plain stages on the card."""
    import qatzip_tpu_torch as qz
    from corpus import make_silesia_like   # tests/ is on sys.path
    from qatzip_tpu_torch.parallel import dispatch
    data = make_silesia_like(max(mib, 1))[:(mib << 20) or 65536]
    monkeypatch.setattr(dispatch.CudaEngine, "packs_on_device",
                        lambda self, s, algorithm="deflate": True)

    def compress():
        sess = qz.QzSession(device="cuda")
        if route == "lz4":
            sess.setup_lz4()
        else:
            p = qz.SessionParamsDeflate()
            if route == "static":
                p.huffman_hdr = qz.HuffmanHdr.STATIC_HDR
            sess.setup_deflate(p)
        out = sess.compress(data)
        torch.cuda.synchronize()
        assert sess.decompress(out) == data
        return out

    with monkeypatch.context() as m:
        _plain_glue_refused(m)
        cuda_pack.reset_launch_counts()
        out = compress()
        launches = dict(cuda_pack.LAUNCHES)
    tiles = -(-(len(data) // 65536) // dispatch.TILE_B)
    assert launches["pack_rows" if route != "lz4" else "lz4_pack_rows"] \
        == tiles
    assert launches["search_inputs"] == (0 if route == "lz4" else tiles)
    assert launches["parse_inputs"] == tiles
    assert launches["symbol_planes"] == (2 * tiles if route == "dynamic"
                                         else 0)
    with monkeypatch.context() as m:
        m.setattr(lz77, "search_inputs", lz77.search_inputs_ref)
        m.setattr(lz77, "parse_inputs", lz77.parse_inputs_ref)
        m.setattr(dp, "symbol_planes", dp.symbol_planes_ref)
        cuda_pack.reset_launch_counts()
        plain = compress()
        assert cuda_pack.LAUNCHES["parse_inputs"] == 0
    assert plain == out
