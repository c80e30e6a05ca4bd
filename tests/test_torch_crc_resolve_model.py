"""The host-side arithmetic of the two redesigned kernels, on the CPU.

``crc32_rows`` (csrc/crc32_rows.cu) runs the JAX package's GF(2) product
on the binary tensor cores: mma m16n8k256 .b1 with AND and popcount, 16
rows and a 2 KiB block a CTA, V's fragments laid out by
``ops/crc32_mxu.py`` (``mma_fragments``), each block moved to its row's
end by a shift from ``_tails``. ``kernel_crc`` below places each lane's
A words and B fragments where the PTX ISA says the mma reads them and
gathers the parities from c0-c3 as the kernel does; it must give
zlib.crc32 at widths that are and are not multiples of a block.

``lz4_resolve_refs`` resolves rows up to 65536 wide in shared memory
(csrc/lz4_resolve.cu): with enough rounds chunk by chunk
(``resolve_kernel_chunks``), a row with forward or self references or
indices past the row by the in-place loop of ``resolve_kernel_wide``;
with fewer as (clipped 16-bit index, done bit, literal byte) per position
in synchronous rounds (``resolve_kernel_smem``). ``kernel_resolve`` below
does all three in numpy, each pass in lockstep (every read before every
write: the most passes the card's threads can take); it must give the
JAX function's flag for any plane and its bytes wherever an entry
resolved.
"""

from __future__ import annotations

import ctypes
import gc
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qatzip_tpu.ops import lz4_decode as jdec
from qatzip_tpu_torch import native
from qatzip_tpu_torch.ops import crc32_mxu as cm
from qatzip_tpu_torch.ops import lz4_decode as ld

from tests.corpus import make_corpus


@pytest.fixture(scope="module", autouse=True)
def _return_freed_memory():
    """Give what this module held back to the system when it ends (see
    test_torch_session.py)."""
    yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


# -- crc32_rows ------------------------------------------------------------

def linear(seg: bytes) -> int:
    """L(seg): the CRC register's update from 0 with no final xor."""
    return zlib.crc32(seg) ^ zlib.crc32(b"\0" * len(seg))


def _bits(words: np.ndarray) -> np.ndarray:
    return (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1


def kernel_crc(rows: np.ndarray) -> list:
    """crc32 of each row of ``rows`` (B, n) uint8 as crc32_rows computes
    it: the rows zero-padded at their front to whole blocks and to whole
    groups of 16; in each step, lane (g, q) holds words 2 ks and 2 ks + 1
    of its 32 bytes of rows g and g + 8 as a0 / a2 (row g, k = 32 q + i
    and 128 + 32 q + i) and a1 / a3 (row g + 8), and its fragments as b0
    / b1 (column g, the same k); c0-c3 hold rows g / g + 8, columns 2 q
    and 2 q + 1; each block's parities shifted by _tails, xored, and
    crc(0^n) added."""
    frag = cm.mma_fragments()
    b_rows, n = rows.shape
    nb = -(-n // cm.BLOCK)
    groups = -(-b_rows // 16)
    padded = np.zeros((groups * 16, nb * cm.BLOCK), np.uint8)
    padded[:b_rows, nb * cm.BLOCK - n:] = rows
    tails = cm._tails(nb)
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    k_lo = 32 * q[:, None] + np.arange(32)
    crc = [zlib.crc32(b"\0" * n)] * b_rows
    for grp in range(groups):
        for b in range(nb):
            counts = np.zeros((4, 16, 8), np.int64)   # n-tile, row, column
            for step in range(cm.BLOCK // 128):
                at = b * cm.BLOCK + step * 128 + k_lo
                w0 = padded[grp * 16 + g[:, None], at].view(np.uint32)
                w1 = padded[grp * 16 + 8 + g[:, None], at].view(np.uint32)
                for ks in range(4):
                    a = np.zeros((16, 256), np.int64)
                    a[g[:, None], k_lo] = _bits(w0[:, 2 * ks])
                    a[g[:, None] + 8, k_lo] = _bits(w1[:, 2 * ks])
                    a[g[:, None], 128 + k_lo] = _bits(w0[:, 2 * ks + 1])
                    a[g[:, None] + 8, 128 + k_lo] = _bits(w1[:, 2 * ks + 1])
                    for j in range(4):
                        bm = np.zeros((256, 8), np.int64)
                        w = (ks * 4 + j) * 2
                        bm[k_lo, g[:, None]] = _bits(frag[step, :, w])
                        bm[128 + k_lo, g[:, None]] = _bits(
                            frag[step, :, w + 1])
                        counts[j] += a @ bm
            for r in range(min(16, b_rows - grp * 16)):
                l = sum(int(counts[j, r, c] & 1) << (8 * j + c)
                        for j in range(4) for c in range(8))
                crc[grp * 16 + r] ^= (cm.multmodp(l, int(tails[nb - 1 - b]))
                                      if l else 0)
    return crc


@pytest.mark.parametrize("k", [0, 1, 3, 128, 32768, 262144])
def test_x_pow_shifts_like_trailing_zeros(k):
    """L(M) * x^(8k) = L(M || 0^k): the products by x_pow move a value
    past k zero bytes."""
    msg = np.random.default_rng(k).integers(0, 256, 200, np.uint8).tobytes()
    assert cm.multmodp(linear(msg), cm.x_pow(8 * k)) == \
        linear(msg + b"\0" * k)


@pytest.mark.parametrize("blocks", [1, 2, 5, 33])
def test_tails_table(blocks):
    """Entry m of _tails is x^(8 BLOCK m), the shift past m blocks."""
    tails = cm._tails(blocks)
    assert tails.dtype == np.uint32 and tails.shape == (blocks,)
    for m in sorted({0, min(1, blocks - 1), blocks - 1}):
        assert int(tails[m]) == cm.x_pow(8 * cm.BLOCK * m)


@pytest.mark.parametrize("s,lane,ks,j,r,i", [
    (0, 0, 0, 0, 0, 0), (3, 17, 2, 1, 1, 13), (15, 31, 3, 3, 1, 31),
    (7, 6, 1, 2, 0, 8)])
def test_mma_fragments_hold_v(s, lane, ks, j, r, i):
    """A fragment bit is the bit of V its place names: bit 8 j + g of
    L(bit i % 8 of byte 128 s + 32 q + 8 ks + 4 r + i // 8) over a block,
    L taken from zlib."""
    frag = cm.mma_fragments()
    assert frag.dtype == np.uint32
    assert frag.shape == (cm.BLOCK // 128, 32, 32)
    g, q = lane >> 2, lane & 3
    byte = 128 * s + 32 * q + 8 * ks + 4 * r + i // 8
    msg = bytearray(cm.BLOCK)
    msg[byte] = 1 << (i % 8)
    want = (linear(bytes(msg)) >> (8 * j + g)) & 1
    assert (int(frag[s, lane, (ks * 4 + j) * 2 + r]) >> i) & 1 == want


@pytest.mark.parametrize("b,n", [(16, 2048), (16, 6144), (3, 100),
                                 (20, 2049), (1, 1), (17, 10000), (2, 2047),
                                 (32, 4096), (5, 4097), (16, 16)])
def test_kernel_crc_matches_zlib(b, n):
    """The kernel's product with the module's fragments and tails is
    zlib.crc32, for rows shorter than a block, of whole blocks, of a
    block and a byte, and for row counts that are not a multiple of 16."""
    rows = np.random.default_rng(n).integers(0, 256, (b, n), np.uint8)
    assert kernel_crc(rows) == [zlib.crc32(r.tobytes()) for r in rows]


def test_kernel_crc_matches_zlib_on_text_and_runs():
    """Text and long runs (zero and 0xFF blocks) give zlib.crc32."""
    c = make_corpus()
    n = 4096
    rows = np.stack([np.frombuffer(r, np.uint8) for r in (
        c["text"][:n], b"\0" * 3000 + c["json"][:n - 3000], b"\xff" * n)])
    assert kernel_crc(rows) == [zlib.crc32(r.tobytes()) for r in rows]


# -- lz4_resolve_refs ------------------------------------------------------

CHUNK = 64    # the kernel's chunks are 16384 positions; the rows here 256


def chunk_rounds(n: int, chunk: int = CHUNK) -> int:
    """The fewest rounds for which qz_lz4_resolve_refs takes the chunks:
    the JAX rounds for any chain of the row, and the chunks' own passes
    for a chain inside a chunk (one more than the JAX rounds)."""
    return max((n - 1).bit_length(), (min(n, chunk) - 1).bit_length() + 1)


def kernel_resolve(ref: np.ndarray, max_rounds: int):
    """lz4_resolve_refs for rows up to 65536 in numpy: (bytes,
    unresolved). With fewer than chunk_rounds, resolve_kernel_smem: the
    JAX rounds on (clipped index, done bit, literal byte). Else
    resolve_kernel_chunks: a valid row (every reference earlier than its
    entry) chunk by chunk, an index before the chunk taking that
    position's final byte and the chunk's own chains jumped in lockstep,
    an entry closing in the pass after it lands on a root; any other row
    the in-place loop over the whole row."""
    out = np.empty(ref.shape, np.uint8)
    left = False
    n = ref.shape[1]
    enough = max_rounds >= chunk_rounds(n)
    for b, row in enumerate(ref):
        is_ref = row >= 0
        if not enough:
            s = np.where(is_ref, np.minimum(row, n - 1), np.arange(n))
            done = ~is_ref
            lit = (~row).astype(np.uint8)
            for _ in range(max_rounds):
                if done.all():
                    break
                j = s.copy()
                s = np.where(done, s, s[j])     # all reads, then all writes
                done = np.where(done, done, done[j])
            out[b] = np.where(done, lit[s], (~s).astype(np.uint8))
            left |= not done.all()
        elif (is_ref & (row >= np.arange(n))).any():
            r = row.astype(np.int64)
            for _ in range(max_rounds):
                for i in np.flatnonzero(r >= 0):
                    r[i] = r[min(r[i], n - 1)]
                if not (r >= 0).any():
                    break
            out[b] = (~r).astype(np.uint8)
            left |= bool((r >= 0).any())
        else:
            lit = np.zeros(n, np.uint8)
            for base in range(0, n, CHUNK):
                length = min(CHUNK, n - base)
                v = row[base:base + length]
                s = np.arange(length)
                open_ = v >= base
                for c in np.flatnonzero(~open_):
                    lit[base + c] = ~v[c] if v[c] < 0 else lit[v[c]]
                s[open_] = v[open_] - base
                refs = open_.copy()
                for _ in range(max_rounds):
                    if not open_.any():
                        break
                    idx = np.flatnonzero(open_)
                    j = s[idx]
                    t = s[j]                    # all reads, then all writes
                    open_[idx[t == j]] = False  # j is a root
                    s[idx[t != j]] = t[t != j]
                for c in np.flatnonzero(refs):
                    lit[base + c] = (~(base + s[c]) if open_[c]
                                     else lit[base + s[c]])
                left |= bool(open_.any())
            out[b] = lit
    return out, left


def _planes(rows, n):
    lib = native.get_lib()
    refs = np.full((len(rows), n), -1, np.int32)
    for i, r in enumerate(rows):
        assert lib.lz4_ref_block(lib.lz4_compress_block(r), refs[i], n) \
            == len(r)
    return refs


def _resolve_cases():
    rng = np.random.default_rng(5)
    n = 256
    c = make_corpus()
    valid = _planes([c["text"][:n], b"A" * n, c["runs"][:n - 9]], n)
    lits = -1 - rng.integers(0, 256, (2, n), dtype=np.int32)
    fwd = valid.copy()
    fwd[0, 10] = 200                     # forward to a resolved entry
    fwd[1, 7] = 7                        # a self reference
    fwd[2, 3], fwd[2, 4] = 4, 3          # a two-cycle
    past = valid.copy()
    past[0, 50] = n + 1000               # clipped to n - 1
    past[1, 0] = 1 << 30
    return {"valid": valid, "literals": lits, "forward and self": fwd,
            "past the row": past}


@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 5, 8, 9])
@pytest.mark.parametrize("case", ["valid", "literals", "forward and self",
                                  "past the row"])
def test_kernel_resolve_matches_jax(case, rounds):
    """The kernels' resolution gives the JAX function's flag, and its
    bytes at every entry it resolved; every byte for valid rows, and with
    too few rounds (the JAX rounds themselves) wherever no index lies
    past the row. The port's plain version agrees with the JAX function."""
    ref = _resolve_cases()[case]
    want, want_left = jdec.resolve_refs(jnp.asarray(ref), max_rounds=rounds)
    want = np.asarray(want)
    jax_plane = ref.copy()
    for _ in range(rounds):              # the JAX rounds, to see what resolved
        if not (jax_plane >= 0).any():
            break
        chased = np.take_along_axis(
            jax_plane, np.clip(jax_plane, 0, ref.shape[1] - 1), 1)
        jax_plane = np.where(jax_plane >= 0, chased, jax_plane)
    got, left = kernel_resolve(ref, rounds)
    assert left == bool(want_left)
    resolved = jax_plane < 0
    assert np.array_equal(got[resolved], want[resolved])
    few = rounds < 8                     # the JAX rounds themselves
    if case in ("valid", "literals") or (few and case != "past the row"):
        assert np.array_equal(got, want)
    plain, plain_left = ld.resolve_refs_ref(torch.from_numpy(ref.copy()),
                                            rounds)
    assert np.array_equal(plain.numpy(), want)
    assert bool(plain_left) == bool(want_left)


def _lit(byte: int) -> int:
    return -1 - byte


@pytest.mark.parametrize("n", [2, 4, 32, 64, 128, 256])
@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_kernel_resolve_at_the_jax_rounds(n, extra):
    """At (n - 1).bit_length() rounds, the fewest with which the JAX
    function resolves any valid row, and one fewer and one more: chains
    of depth n - 1 ([lit, 0, 1, ...]) and b"A" * n give the JAX flag and
    bytes. A row within one chunk needs one pass more than the JAX rounds
    when its passes run in lockstep, so it takes the JAX rounds there."""
    rounds = max((n - 1).bit_length() + extra, 0)
    chain = np.arange(-1, n - 1, dtype=np.int32)[None, :]
    chain[0, 0] = _lit(ord("A"))
    ref = np.concatenate([chain, _planes([b"A" * n], n)])
    want, want_left = jdec.resolve_refs(jnp.asarray(ref), max_rounds=rounds)
    got, left = kernel_resolve(ref, rounds)
    assert left == bool(want_left)
    assert np.array_equal(got, np.asarray(want))
    if extra >= 0:
        assert not left


def test_chunk_rounds_rule():
    """The rule of qz_lz4_resolve_refs at the card's chunk of 16384: a
    row within one chunk takes the chunks from one round past the JAX
    rounds, a wider row from the JAX rounds (its chains inside a chunk
    are shallower than the row's)."""
    assert [chunk_rounds(n, 16384) for n in (2, 4, 32, 2048, 16384)] == \
        [2, 3, 6, 12, 15]
    assert [chunk_rounds(n, 16384) for n in (16385, 32768, 65536)] == \
        [15, 15, 16]
