"""The port's kernel modules against the JAX package, on the CPU.

On the CPU each wrapper of ``qatzip_tpu_torch.ops.cuda_pack`` runs its
plain PyTorch version; these tests hold that version bit for bit
(tolerance 0: every plane is an integer plane) against the JAX package:

  * ``candidate_search`` against TPU kernel k2 in Pallas interpret mode,
    as tests/test_pallas_kernels.py runs it;
  * ``parse_scan`` against the jitted ``lz77._parse_scan``;

each on random inputs and on the adversarial planes and windows of
tests/test_torch_cuda.py, which the card holds its kernels to.

The CUDA kernels themselves are compared with their plain versions on
the card by tests/test_torch_cuda.py.
"""

import ctypes
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qatzip_tpu.ops.lz77 import _parse_scan
from qatzip_tpu.ops.pallas_pack import candidate_search as jax_k2
from qatzip_tpu_torch.ops import cuda_pack
from qatzip_tpu_torch.ops.lz77 import HASH_MUL, _hash
from test_torch_cuda import PARSE_PLANES, k2_window, parse_plane

# one jit for every parse test, so each (seg, nseg, b) compiles once
_jax_parse_scan = jax.jit(_parse_scan, static_argnums=(2, 3, 4))


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Give what this module held back to the system when it ends: the
    test runner keeps each worker process for many files, JAX keeps every
    compiled program, and glibc keeps freed pages (a file's several GB
    would pile up)."""
    yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def _k2_inputs(w, rows, ctx_words, seed):
    """Keys with a few hash buckets, the overflow bucket at 1 << hb (so
    bit 31 is set at w = 8192), and context words over a tiny alphabet
    with bit 31 set at random, so words >= 2^31 and partial-byte matches
    both occur."""
    rng = np.random.default_rng(seed)
    pbits = (w - 1).bit_length()
    hb = min(18, 31 - pbits)
    h = rng.integers(0, max(4, w // 64), (rows, w)).astype(np.uint64)
    h[:, -200:] = 1 << hb
    key = ((h << np.uint64(pbits)) | np.arange(w, dtype=np.uint64))
    key = key.astype(np.uint32)
    sym = rng.integers(0, 3, (ctx_words, rows, w)).astype(np.uint64)
    top = rng.integers(0, 2, (ctx_words, rows, w)).astype(np.uint64) << 31
    lowb = rng.integers(0, 2, (ctx_words, rows, w)).astype(np.uint64)
    ctx = (sym * 0x00010101 + lowb + top).astype(np.uint32)
    return key, ctx, pbits


@pytest.mark.parametrize("w,rows,ctx_words,probes", [
    (1024, 2, 3, 7), (1024, 2, 4, 6), (8192, 1, 3, 7), (8192, 1, 4, 6)])
def test_candidate_search_ref_matches_k2(w, rows, ctx_words, probes):
    key, ctx, pbits = _k2_inputs(w, rows, ctx_words, seed=w + ctx_words)
    assert (key >= 2**31).any() == (pbits == 13)
    assert (ctx >= 2**31).any()
    want = np.asarray(jax_k2(
        jnp.asarray(key), [jnp.asarray(c) for c in ctx], w=w, probes=probes,
        ctx_words=ctx_words, min_match=4, pbits=pbits, interpret=True))
    got = cuda_pack.candidate_search(
        torch.from_numpy(key.view(np.int32)),
        torch.from_numpy(ctx.view(np.int32)), probes=probes, min_match=4,
        pbits=pbits).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    ml = (want >> 13) & 0x1F
    assert (ml > 0).mean() > 0.2 and (ml % 4 != 0).any()


@pytest.mark.parametrize("seg", [512, 8192])
def test_parse_scan_ref_matches_jax(seg):
    rng = np.random.default_rng(seg)
    b, nseg = 3, 2
    n = seg * nseg
    im = rng.random((b, n)) < 0.3
    ml = np.where(im, rng.integers(4, 40, (b, n)), 0).astype(np.int32)
    want_t, want_l = _jax_parse_scan(jnp.asarray(im), jnp.asarray(ml),
                                     seg, nseg, b)
    got_t, got_l = cuda_pack.parse_scan(torch.from_numpy(im),
                                        torch.from_numpy(ml), seg)
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_t.any() and got_l.any()


@pytest.mark.parametrize("seg", [512, 8192])
@pytest.mark.parametrize("kind", PARSE_PLANES)
def test_parse_scan_ref_adversarial_matches_jax(kind, seg):
    """The card tests' adversarial planes, at the shapes above (3 rows of
    2 segments): the plain version equals the JAX scan on each."""
    im, ml = parse_plane(kind, 3, 2, seg, seed=seg)
    want_t, want_l = _jax_parse_scan(jnp.asarray(im), jnp.asarray(ml),
                                     seg, 2, 3)
    got_t, got_l = cuda_pack.parse_scan(torch.from_numpy(im),
                                        torch.from_numpy(ml), seg)
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))


def test_parse_scan_raises_past_max_seg():
    """The kernel stages one segment in shared memory, so the wrapper
    takes at most 8192 positions a segment, on every device."""
    im = torch.zeros((1, 16384), dtype=torch.bool)
    ml = torch.zeros((1, 16384), dtype=torch.int32)
    with pytest.raises(ValueError, match="parse segment"):
        cuda_pack.parse_scan(im, ml, 16384)
    with pytest.raises(ValueError, match="parse segment"):
        cuda_pack.parse_scan(im, ml, 0)
    taken, lit = cuda_pack.parse_scan(im, ml, cuda_pack.MAX_PARSE_SEG)
    assert lit.all() and not taken.any()


@pytest.mark.parametrize("kind,w,rows,ctx_words,probes", [
    ("one-bucket", 1024, 2, 1, 7), ("one-bucket", 1024, 2, 2, 7),
    ("one-bucket", 1024, 2, 3, 7), ("one-bucket", 8192, 1, 4, 6),
    ("overflow", 8192, 1, 3, 7), ("reverse", 8192, 1, 3, 7)])
def test_candidate_search_ref_adversarial_matches_k2(kind, w, rows,
                                                     ctx_words, probes):
    """The card tests' adversarial windows against TPU kernel k2 in
    interpret mode."""
    key, ctx, pbits = k2_window(kind, w, rows, ctx_words, seed=w)
    want = np.asarray(jax_k2(
        jnp.asarray(key), [jnp.asarray(c) for c in ctx], w=w, probes=probes,
        ctx_words=ctx_words, min_match=4, pbits=pbits, interpret=True))
    got = cuda_pack.candidate_search(
        torch.from_numpy(key.view(np.int32)),
        torch.from_numpy(ctx.view(np.int32)), probes=probes, min_match=4,
        pbits=pbits).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    assert ((want >> 13) & 0x1F).any()


def test_hash_matches_uint32_arithmetic():
    """The split multiply equals uint32 wrap-around, words >= 2^31 too."""
    rng = np.random.default_rng(5)
    w4 = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                         np.array([0, 2**31, 2**32 - 1], np.uint64)])
    for hb in (15, 18):
        want = ((w4 * np.uint64(HASH_MUL)) & np.uint64(0xFFFFFFFF)) \
            >> np.uint64(32 - hb)
        got = _hash(torch.from_numpy(w4.astype(np.int64)), hb).numpy()
        assert np.array_equal(got, want.astype(np.int64))


def test_wrappers_check_their_inputs():
    key = torch.zeros((2, 1024), dtype=torch.int32)
    ctx = torch.zeros((3, 2, 1024), dtype=torch.int32)
    kw = dict(probes=7, min_match=4, pbits=10)
    with pytest.raises(TypeError):
        cuda_pack.candidate_search(key.to(torch.int64), ctx, **kw)
    with pytest.raises(ValueError):
        cuda_pack.candidate_search(key[:, :1000], ctx[:, :, :1000], **kw)
    with pytest.raises(ValueError):
        cuda_pack.candidate_search(key, ctx[:, :1], **kw)
    with pytest.raises(ValueError):
        cuda_pack.candidate_search(key, ctx, probes=7, min_match=4, pbits=9)
    im = torch.zeros((2, 1024), dtype=torch.bool)
    with pytest.raises(ValueError):
        cuda_pack.parse_scan(im, torch.zeros((2, 1024), dtype=torch.int32),
                             1000)
    with pytest.raises(TypeError):
        cuda_pack.parse_scan(im, torch.zeros((2, 1024), dtype=torch.int64),
                             512)
    before = dict(cuda_pack.LAUNCHES)
    cuda_pack.parse_scan(im, torch.zeros((2, 1024), dtype=torch.int32), 512)
    assert cuda_pack.LAUNCHES == before      # the plain version ran
