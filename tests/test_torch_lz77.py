"""The port's tokenizer against the JAX package's, on the CPU.

``qatzip_tpu_torch.ops.lz77.lz77_tokenize`` (plain versions of the
kernels) against JAX ``lz77_tokenize(pallas="scatter")``, the lax.sort
route that TPU kernel k2 matches bit for bit: ``tokens`` and ``ntok``
must be identical (tolerance 0), and so must ``ml`` from ``_analyze``,
and ``dist`` wherever ``ml > 0`` (the JAX sort route leaves other values
in ``dist`` where nothing matched).

Four shapes, each compiled once by JAX:
  * n = 16384 segmented: 8K windows, overlap 896, compaction segments of
    512, ctx 3, probes 7 (the level-1 knobs of 64 KiB chunks);
  * n = 4096 full row: ctx 4, probes 6 (the knobs of small chunks),
    through the candidate kernel's plain version;
  * n = 16384 and n = 65536 full row: ctx 4, probes 6, compaction segments
    of 512 (the knobs of levels >= 6), through the full-row search, on
    rows that add an all-zero row (one hash bucket) to the others (among
    them a 37-byte and an empty row: nearly every position in the
    overflow bucket, and lengths that are not powers of two).
"""

import ctypes
import gc
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qatzip_tpu.ops import lz77 as jlz
from qatzip_tpu_torch.ops import lz77 as tlz

from tests.corpus import json_like, text_like


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


SHAPES = {
    "seg16k": (16384, dict(search_seg=8192, search_overlap=896,
                           compact_seg=512, ctx_words=3, probes=7)),
    "row4k": (4096, dict(ctx_words=4, probes=6)),
    "fullrow16k": (16384, dict(compact_seg=512, ctx_words=4, probes=6)),
    "fullrow64k": (65536, dict(compact_seg=512, ctx_words=4, probes=6)),
}


def _batch(n, zero_row=False):
    """_mixed_batch-style rows (repeats, noise, DNA, records) plus two
    corpus rows; a short row and an empty row exercise the length edges;
    ``zero_row`` adds a full row of zero bytes."""
    rng = np.random.default_rng(7)
    rec = bytes(rng.integers(0, 256, 333, dtype=np.uint8))
    rows = [
        np.frombuffer((b"the quick brown fox " * (n // 16 + 2))[:n], np.uint8),
        rng.integers(0, 256, n, dtype=np.uint8),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), n),
        np.frombuffer((rec * (n // 333 + 2))[:n], np.uint8),
        np.frombuffer(text_like(n + 64, seed=3)[:n], np.uint8),
        np.frombuffer(json_like(n + 64, seed=5)[:n], np.uint8),
    ]
    data = np.zeros((8 + zero_row, n), np.uint8)
    data[:6] = np.stack(rows)
    lengths = np.array([n, n, n - 700, n, n, n - 1, 37, 0] + [n] * zero_row,
                       np.int32)
    for i, ln in enumerate(lengths):
        data[i, ln:] = 0
    return data, lengths


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    """JAX's tokens and analysis planes for one shape, computed once."""
    n, kw = SHAPES[request.param]
    data, lengths = _batch(n, zero_row=request.param.startswith("fullrow"))
    seg = min(8192, n)
    akw = {k: v for k, v in kw.items() if k != "compact_seg"}

    def tokens_and_planes(d, ln):
        # one program for both: XLA shares the analysis, one compile
        return (jlz.lz77_tokenize(d, ln, n=n, parse_seg=seg,
                                  pallas="scatter", **kw),
                jlz._analyze(d, ln, n=n, min_match=4, max_match=258,
                             window=32768, parse_seg=seg, pallas="scatter",
                             **akw))

    (toks, ntok), planes = jax.jit(tokens_and_planes)(
        jnp.asarray(data), jnp.asarray(lengths))
    planes = [np.asarray(x) for x in planes]
    return dict(n=n, kw=kw, akw=akw, seg=seg, data=data, lengths=lengths,
                toks=np.asarray(toks), ntok=np.asarray(ntok), planes=planes)


def test_tokens_match_jax(case):
    toks, ntok = tlz.lz77_tokenize(
        torch.from_numpy(case["data"]), torch.from_numpy(case["lengths"]),
        n=case["n"], parse_seg=case["seg"], **case["kw"])
    assert toks.dtype == torch.int32
    assert np.array_equal(ntok.numpy(), case["ntok"])
    assert np.array_equal(toks.numpy().view(np.uint32), case["toks"])
    assert (case["toks"] >= 2**31).any()       # match tokens have bit 31


def test_analysis_planes_match_jax(case):
    _iota, ml, dist, taken, lit, valid = tlz._analyze(
        torch.from_numpy(case["data"]), torch.from_numpy(case["lengths"]),
        n=case["n"], min_match=4, max_match=258, window=32768,
        parse_seg=case["seg"], **case["akw"])
    _, jml, jdist, jtaken, jlit, jvalid = case["planes"]
    assert np.array_equal(ml.numpy(), jml)
    hit = jml > 0
    assert hit.any()
    assert np.array_equal(dist.numpy()[hit], jdist[hit])
    assert np.array_equal(taken.numpy(), jtaken)
    assert np.array_equal(lit.numpy(), jlit)
    assert np.array_equal(valid.numpy(), jvalid)


def test_tokens_rebuild_and_pack(case):
    """Every row's tokens rebuild its bytes and pack to a zlib stream."""
    from qatzip_tpu_torch import native
    lib = native.get_lib()
    n = case["n"]
    cs = case["kw"].get("compact_seg", 0) or n
    for i, ln in enumerate(case["lengths"]):
        src = case["data"][i, :ln].tobytes()
        row = case["toks"][i]
        toks = tlz.merge_segment_tokens(row, case["ntok"][i], cs)
        assert tlz.tokens_to_bytes(toks, len(toks), src) == src
        payload = lib.deflate_pack(src, toks, len(toks))
        assert zlib.decompress(payload, -15) == src


def test_level6_full_row_search_is_refused():
    """The candidate kernel's windows refuse a whole row over 8192: such
    rows (levels >= 6, the LZ4 device pack) take the full-row search."""
    data = torch.zeros((1, 16384), dtype=torch.uint8)
    lengths = torch.tensor([16384], dtype=torch.int32)
    with pytest.raises(ValueError):
        tlz._search_inputs(data, lengths, n=16384, min_match=4,
                           window=32768, ctx_words=4)
    toks, ntok = tlz.lz77_tokenize(data, lengths, n=16384)
    src = bytes(16384)
    assert tlz.tokens_to_bytes(toks[0].numpy().view(np.uint32),
                               int(ntok[0]), src) == src
