"""The port's full-device DEFLATE packers against the JAX package, on the CPU.

``qatzip_tpu_torch.ops.deflate_pack`` runs the plain versions of its
kernels on the CPU; every plane here is an integer bitstream, so the
tolerance is 0 throughout:

  * the symbol and emission functions over every match length, a spread
    of distances and every byte;
  * the plain versions of k3 ``huffman_lookup`` and k4
    ``symbol_histogram`` against the TPU kernels in Pallas interpret mode,
    as tests/test_pallas_kernels.py runs them;
  * the row bit-packer's plain version ``pack_rows_ref`` against the JAX
    package's route through TPU kernel k1 (its emission functions, a
    cumsum, the group pack and k1 in interpret mode), static and dynamic,
    on real parse planes and on planes hard for the packer; stock zlib
    inflates every row;
  * the static packer, and the dynamic packer's two passes with the host
    tree build between them, against the JAX package's ``pallas="scatter"``
    route, words and bit counts; stock zlib decodes every stream;
  * a match at distance 20000 whose static emission takes 31 bits, packed
    from hand-made planes, against the JAX packers.

Few row shapes (JAX-CPU compiles each route once per shape).
"""

import ctypes
import functools
import gc
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qatzip_tpu.ops import deflate_pack as jdp
from qatzip_tpu.ops import pallas_pack as jpk
from qatzip_tpu_torch.ops import cuda_pack
from qatzip_tpu_torch.ops import deflate_pack as dp
from qatzip_tpu_torch.parallel.dispatch import plan_tile
from test_torch_cuda import PACK_PLANES, _max_words, pack_args, pack_plane

from tests.reference_native import one_intra_op_thread


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Give what this module held back to the system when it ends: the
    test runner keeps each worker process for many files, JAX keeps every
    compiled program, and glibc keeps freed pages (a file's several GB
    would pile up)."""
    with one_intra_op_thread():
        yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


N = 2048


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def batch():
    """Rows of text, noise, DNA (short length), records, then empty,
    one byte, all byte values, and a long run."""
    rng = np.random.default_rng(7)
    rec = bytes(rng.integers(0, 256, 333, dtype=np.uint8))
    rows = [(b"the quick brown fox " * (N // 16 + 2))[:N],
            rng.integers(0, 256, N, dtype=np.uint8).tobytes(),
            rng.choice(np.frombuffer(b"ACGT", np.uint8), N - 700).tobytes(),
            (rec * (N // 333 + 2))[:N], b"", b"x", bytes(range(256)) * 8,
            b"A" * 1500]
    data = np.zeros((len(rows), N), np.uint8)
    lengths = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        data[i, :len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    return data, lengths, rows


def _inflate(stream: bytes) -> bytes:
    d = zlib.decompressobj(-15)
    out = d.decompress(stream)
    assert d.eof
    return out


# ---------------------------------------------------------------------------
# symbol and emission functions
# ---------------------------------------------------------------------------

DISTS = np.array(sorted({*range(1, 40), 63, 64, 65, 127, 128, 129, 255,
                         256, 257, 1024, 1025, 2048, 4096, 4097, 8192, 8193,
                         16384, 16385, 20000, 24576, 24577, 32767, 32768}),
                 np.int32)


def test_symbol_and_emission_functions_match_jax():
    ml, dist = np.meshgrid(np.arange(3, 259, dtype=np.int32), DISTS,
                           indexing="ij")
    ml, dist = np.ascontiguousarray(ml), np.ascontiguousarray(dist)
    for got, want in zip(dp._len_symbol(_t(ml)),
                         jdp._len_symbol(jnp.asarray(ml))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(dp._dist_symbol(_t(dist)),
                         jdp._dist_symbol(jnp.asarray(dist))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    v, nb = dp._match_emission(_t(ml), _t(dist))
    jv, jnb = jdp._match_emission(jnp.asarray(ml), jnp.asarray(dist))
    assert np.array_equal(v.numpy(), np.asarray(jv).astype(np.int64))
    assert np.array_equal(nb.numpy(), np.asarray(jnb))
    assert int(nb.max()) == 31 and int(v.max()) >= 1 << 30
    byte = np.arange(256, dtype=np.uint8)
    v, nb = dp._lit_emission(_t(byte))
    jv, jnb = jdp._lit_emission(jnp.asarray(byte))
    assert np.array_equal(v.numpy(), np.asarray(jv).astype(np.int64))
    assert np.array_equal(nb.numpy(), np.asarray(jnb))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the TPU kernels (interpret mode)
# ---------------------------------------------------------------------------

def test_huffman_lookup_ref_matches_k3():
    rng = np.random.default_rng(3)
    b, n = 3, 1024
    lit = rng.integers(0, 1 << 16, (b, 286)).astype(np.uint32)
    dist = rng.integers(0, 1 << 16, (b, 30)).astype(np.uint32)
    sym = rng.integers(0, 287, (b, n)).astype(np.int32)
    sym[:, :40] = 286                        # emits nothing: reads 0
    dsym = rng.integers(0, 30, (b, n)).astype(np.int32)
    wl, wd = jpk.huffman_lookup(jnp.asarray(lit), jnp.asarray(dist),
                                jnp.asarray(sym), jnp.asarray(dsym), n=n,
                                interpret=True)
    gl, gd = cuda_pack.huffman_lookup(_t(lit.astype(np.int32)),
                                      _t(dist.astype(np.int32)), _t(sym),
                                      _t(dsym))
    assert np.array_equal(_u32(gl), np.asarray(wl))
    assert np.array_equal(_u32(gd), np.asarray(wd))
    assert not gl[:, :40].any() and gl.any()


def _hist_inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    sym = rng.integers(-3, 330, (b, n)).astype(np.int32)
    sym[0, : n // 2] = 65                     # one hot bin
    dsym = rng.integers(270, 330, (b, n)).astype(np.int32)
    return sym, dsym


def test_symbol_histogram_ref_matches_k4():
    sym, dsym = _hist_inputs(3, 2048, seed=4)
    want = np.asarray(jpk.symbol_histogram(jnp.asarray(sym),
                                           jnp.asarray(dsym), n=2048,
                                           interpret=True))
    got = cuda_pack.symbol_histogram(_t(sym), _t(dsym))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_symbol_histogram_takes_any_row_length():
    """n = 1000 (the TPU kernel needs n % 1024 == 0): a numpy count."""
    sym, dsym = _hist_inputs(2, 1000, seed=5)
    want = np.zeros((2, 316), np.int32)
    for r in range(2):
        s = sym[r][(sym[r] >= 0) & (sym[r] < 316)]
        d = dsym[r][(dsym[r] >= 284) & (dsym[r] < 316)]
        np.add.at(want[r], s, 1)
        np.add.at(want[r], d, 1)
    got = cuda_pack.symbol_histogram(_t(sym), _t(dsym))
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the row bit-packer against the JAX package's route through k1
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("max_words",))
def _jax_static_route(data, ml, dist, taken, lit, base, *, max_words):
    """The JAX static packer's stages after the parse, k1 interpreted."""
    mv, mn = jdp._match_emission(ml, dist)
    lv, ln = jdp._lit_emission(data)
    bits = jnp.where(taken, mv, jnp.where(lit, lv, jnp.uint32(0)))
    nbits = jnp.where(taken, mn, jnp.where(lit, ln, 0))
    csum = jnp.cumsum(nbits, axis=1, dtype=jnp.int32)
    b, n = data.shape
    words = jdp._group_pack_assemble(bits, nbits, base[:, None] + csum - nbits,
                                     b, n, max_words, group_w=jdp.GROUP_W,
                                     pallas="interpret")
    return words, base + csum[:, -1]


@pytest.fixture(scope="module")
def batch_planes(batch):
    """The batch's level-1 parse planes, as numpy (data, ml, dist, taken,
    lit)."""
    data, lengths, _rows = batch
    planes = dp._analyze_planes(_t(data), _t(lengths), n=N, parse_seg=8192,
                                ctx_words=4, probes=6, search_seg=0,
                                search_overlap=1024)
    return (data,) + tuple(p.numpy() for p in planes)


def _expand(planes, r, zdict: bytes) -> bytes:
    """Row r of the planes decoded by hand, after the dictionary."""
    data, ml, dist, taken, lit = (a[r] for a in planes)
    out = bytearray(zdict)
    for p in np.nonzero(taken | lit)[0]:
        if taken[p]:
            for _ in range(ml[p]):
                out.append(out[-int(dist[p])])
        else:
            out.append(data[p])
    return bytes(out[len(zdict):])


def _dyn_prefix(hdr: bytes, hbits: int, base: int) -> bytes:
    """The bits before the emissions of a final dynamic block whose header
    takes ``hbits`` and whose emissions start at ``base``: (base - hbits)
    / 10 empty static blocks (BTYPE 01, then the 7-bit EOB), then the
    header with BFINAL set."""
    k, rest = divmod(base - hbits, 10)
    assert rest == 0
    v = sum(1 << (10 * i + 1) for i in range(k))
    v |= (int.from_bytes(hdr, "little") | 1) << (10 * k)
    return v.to_bytes((base + 7) // 8, "little")


PACK_CASES = [(mode, kind) for kind in ("batch", *PACK_PLANES)
              for mode in ("static", "dynamic")] + [("dynamic", "base-2300")]


@pytest.mark.parametrize("mode,kind", PACK_CASES,
                         ids=[f"{m}-{k}" for m, k in PACK_CASES])
def test_pack_rows_ref_matches_jax_k1_route(batch_planes, mode, kind):
    dynamic = mode == "dynamic"
    planes = (batch_planes if kind in ("batch", "base-2300")
              else pack_plane(kind, 4, N, seed=11))
    args, kw, plan = pack_args(kind, planes, dynamic)
    max_words = _max_words(N, dynamic)
    if kind == "base-2300":
        # emissions from ~2300 bits on: empty static blocks fill the gap
        hbits = args[4].numpy()
        args[4] = _t(hbits + (2300 - hbits) // 10 * 10)
    words, end = dp.pack_rows_ref(*args, max_words=max_words, **kw)
    again = dp.pack_rows(*args, max_words=max_words, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, (words, end)))

    data, ml, dist, taken, lit = (jnp.asarray(a) for a in planes)
    base = jnp.asarray(args[4].numpy())
    if dynamic:
        packs, dpacks, hdrs, _hbits = plan
        jw, jend = jdp.deflate_pack_dynamic(
            data, ml, dist, taken, lit, jnp.asarray(packs.astype(np.uint32)),
            jnp.asarray(dpacks.astype(np.uint32)), base, n=N,
            pallas="interpret")
    else:
        jw, jend = _jax_static_route(data, ml, dist, taken, lit, base,
                                     max_words=max_words)
    assert np.array_equal(_u32(words), np.asarray(jw))
    assert np.array_equal(end.numpy(), np.asarray(jend))

    rng = np.random.default_rng(1)
    zdict = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    w = _u32(words).copy()
    for r in range(len(w)):
        if dynamic:
            packs, _dpacks, hdrs, hbits = plan
            stream = dp.finish_stream_dynamic(
                w[r], int(end[r]), _dyn_prefix(hdrs[r], int(hbits[r]),
                                               int(args[4][r])),
                int(packs[r][256]), final=False)
        else:
            w[r, 0] |= 0b010
            stream = dp.finish_stream(w[r], int(end[r]) + dp.EOB_BITS,
                                      final=True)
        d = zlib.decompressobj(-15, zdict=zdict)
        assert d.decompress(stream) == _expand(planes, r, zdict)
        assert d.eof


# ---------------------------------------------------------------------------
# the packers
# ---------------------------------------------------------------------------

def test_static_pack_matches_jax(batch):
    data, lengths, rows = batch
    jw, jn = jdp.deflate_pack_device(jnp.asarray(data), jnp.asarray(lengths),
                                     n=N, pallas="scatter")
    jw, jn = np.asarray(jw), np.asarray(jn)
    w, nb = dp.deflate_pack_device(_t(data), _t(lengths), n=N)
    assert np.array_equal(_u32(w), jw)
    assert np.array_equal(nb.numpy(), jn)
    for i, row in enumerate(rows):
        assert _inflate(dp.finish_stream(_u32(w)[i], int(nb[i]),
                                         final=True)) == row


def test_dynamic_pack_matches_jax(batch):
    data, lengths, rows = batch
    dd, ll = jnp.asarray(data), jnp.asarray(lengths)
    jh, jml, jdist, jtaken, jlit = jdp.deflate_analyze_hist(
        dd, ll, n=N, pallas="scatter")
    hist, ml, dist, taken, lit = dp.deflate_analyze_hist(
        _t(data), _t(lengths), n=N)
    assert np.array_equal(hist.numpy(), np.asarray(jh))
    taken_np = taken.numpy()
    assert np.array_equal(taken_np, np.asarray(jtaken))
    assert np.array_equal(lit.numpy(), np.asarray(jlit))
    assert np.array_equal(ml.numpy(), np.asarray(jml))
    # dist is defined only where a match is taken
    assert np.array_equal(dist.numpy()[taken_np], np.asarray(jdist)[taken_np])
    assert taken_np.any()

    packs, dpacks, hdrs, hbits = plan_tile(hist.numpy(), len(rows))
    jw, jn = jdp.deflate_pack_dynamic(
        dd, jml, jdist, jtaken, jlit, jnp.asarray(packs.astype(np.uint32)),
        jnp.asarray(dpacks.astype(np.uint32)), jnp.asarray(hbits), n=N,
        pallas="scatter")
    jw, jn = np.asarray(jw), np.asarray(jn)
    w, nb = dp.deflate_pack_dynamic(
        _t(data), ml, dist, taken, lit, _t(packs.astype(np.int32)),
        _t(dpacks.astype(np.int32)), _t(hbits), n=N)
    assert np.array_equal(_u32(w), jw)
    assert np.array_equal(nb.numpy(), jn)
    for i, row in enumerate(rows):
        args = (int(nb[i]), hdrs[i], int(packs[i][256]))
        got = dp.finish_stream_dynamic(_u32(w)[i], *args, final=True)
        assert got == jdp.finish_stream_dynamic(jw[i], *args, final=True)
        assert _inflate(got) == row


def test_far_distance_full_width_emission_matches_jax():
    """A 220-byte match at distance 20000: its static emission takes 31
    bits (8 + 5 length, 5 + 13 distance), so its high part straddles into
    the next word; a sign-extended shift there would corrupt it. Both
    packers run from hand-made planes against the JAX package."""
    n = 32768
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (1, n), dtype=np.uint8)
    base[0, 20000:20220] = base[0, 0:220]
    ml = np.zeros((1, n), np.int32)
    dist = np.ones((1, n), np.int32)
    taken = np.zeros((1, n), bool)
    ml[0, 20000], dist[0, 20000], taken[0, 20000] = 220, 20000, True
    lit = np.ones((1, n), bool)
    lit[0, 20000:20220] = False
    want_row = base[0].tobytes()

    # static: the row bit-packer, against the JAX group pack and assembly
    bits, nbits = dp.static_emissions(_t(base), _t(ml), _t(dist), _t(taken),
                                      _t(lit))
    assert int(nbits[0, 20000]) == 31
    off, end = dp._offsets(nbits, dp.HDR_BITS)
    max_words = (n * 9 + dp.HDR_BITS + dp.EOB_BITS + 31) // 32 + 2
    w, end = dp.pack_rows(_t(ml), _t(dist), _t(taken), _t(lit),
                          torch.full((1,), dp.HDR_BITS, dtype=torch.int32),
                          max_words=max_words, data=_t(base))
    jbits = jnp.asarray(bits.numpy().astype(np.uint32))
    jnb = jnp.asarray(nbits.numpy().astype(np.int32))
    jw = np.asarray(jdp._group_pack_assemble(
        jbits, jnb, jnp.asarray(off.numpy().astype(np.int32)), 1, n,
        max_words, group_w=jdp.GROUP_W, pallas="scatter"))
    assert np.array_equal(_u32(w), jw)
    words = _u32(w).copy()
    words[0, 0] |= 0b010
    assert _inflate(dp.finish_stream(words[0], int(end[0]) + dp.EOB_BITS,
                                     final=True)) == want_row

    # dynamic: pass-1 histogram of the planes, host plan, pass 2
    sym, dsym = dp.hist_symbols(_t(base), _t(ml), _t(dist), _t(taken),
                                _t(lit))
    packs, dpacks, hdrs, hbits = plan_tile(
        cuda_pack.symbol_histogram(sym, dsym).numpy(), 1)
    w, nb = dp.deflate_pack_dynamic(
        _t(base), _t(ml), _t(dist), _t(taken), _t(lit),
        _t(packs.astype(np.int32)), _t(dpacks.astype(np.int32)), _t(hbits),
        n=n)
    jw, jn = jdp.deflate_pack_dynamic(
        jnp.asarray(base), jnp.asarray(ml), jnp.asarray(dist),
        jnp.asarray(taken), jnp.asarray(lit),
        jnp.asarray(packs.astype(np.uint32)),
        jnp.asarray(dpacks.astype(np.uint32)), jnp.asarray(hbits), n=n,
        pallas="scatter")
    assert np.array_equal(_u32(w), np.asarray(jw))
    assert np.array_equal(nb.numpy(), np.asarray(jn))
    assert _inflate(dp.finish_stream_dynamic(
        _u32(w)[0], int(nb[0]), hdrs[0], int(packs[0][256]),
        final=True)) == want_row
