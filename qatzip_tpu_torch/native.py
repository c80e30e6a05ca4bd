"""ctypes bindings to the port's copy of the host C++ runtime.

Counterpart of ``qatzip_tpu/native.py``. The source is the repository's
``csrc/qztpu_native.cpp``, shared with the JAX package, but the port
builds its own library under ``build/qatzip_tpu_torch/`` (never the JAX
package's ``_qztpu_native.so``, so two test workers never race on one
file). It compiles against the zstd declarations under
``csrc/zstd_shim/`` (the machines that run the port may carry zstd's
runtime library but not its headers) and links zstd by its soname,
``-l:libzstd.so.1``, where the library is installed. Where it is not,
the zstd functions stay unresolved (they are declared weak) and every
zstd wrapper raises; nothing else depends on them. Only the entry points
the port calls are wrapped. A build or link failure raises.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

import numpy as np

from .ops._build import CSRC_DIR, REPO_DIR, build_library

_SRC = os.path.join(REPO_DIR, "csrc", "qztpu_native.cpp")
_SHIM = os.path.join(CSRC_DIR, "zstd_shim")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
#: the oldest zstd whose parameter values the declarations carry
ZSTD_MIN_VERSION = 10500
#: what the native zstd calls return for ZSTD_error_dstSize_tooSmall (70)
ZSTD_DST_TOO_SMALL_RC = -2070


def _u8(data) -> np.ndarray:
    """Non-empty uint8 view of ``data`` (ctypes needs a valid pointer)."""
    a = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    return a if len(a) else np.zeros(1, np.uint8)


def _ptr(a: np.ndarray, typ=_u8p):
    return a.ctypes.data_as(typ)


class NativeLib:
    """Typed wrappers over the C ABI (the entry points the port calls)."""

    def __init__(self, path: str):
        L = self._lib = ctypes.CDLL(path)
        L.qz_crc32.restype = ctypes.c_uint32
        L.qz_crc32.argtypes = [_u8p, ctypes.c_int64, ctypes.c_uint32]
        L.qz_crc32_combine_many.restype = ctypes.c_uint32
        L.qz_crc32_combine_many.argtypes = [_u32p, _i64p, ctypes.c_int32,
                                            ctypes.c_uint32]
        L.qz_scan_gzipext.restype = ctypes.c_int64
        L.qz_scan_gzipext.argtypes = [_u8p, ctypes.c_int64, _i64p, _i64p,
                                      _i64p, _u32p, ctypes.c_int64, _i64p]
        L.qz_inflate_batch.restype = None
        L.qz_inflate_batch.argtypes = [_u8p, _i64p, _i64p, _u8p, _i64p,
                                       _i64p, _i64p, _u32p, ctypes.c_int32,
                                       ctypes.c_int32, _i64p]
        L.qz_deflate_pack.restype = ctypes.c_int64
        L.qz_deflate_pack.argtypes = [_u8p, ctypes.c_int64, _u32p,
                                      ctypes.c_int64, _u8p, ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_int32]
        L.qz_deflate_compress_batch.restype = None
        L.qz_deflate_compress_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), _i64p, _u8p, ctypes.c_int32,
            ctypes.c_int32, _u8p, _i64p, _i64p, _i64p, _u32p,
            ctypes.c_int32, ctypes.c_int32]
        L.qz_lz77_host.restype = ctypes.c_int64
        L.qz_lz77_host.argtypes = [_u8p, ctypes.c_int64, _u32p,
                                   ctypes.c_int64, ctypes.c_int32]
        L.qz_dyn_plan.restype = ctypes.c_int64
        L.qz_dyn_plan.argtypes = [_u32p, _u32p, ctypes.c_int32, _u16p,
                                  _u16p, _u8p, ctypes.c_int64]
        L.qz_xxh32.restype = ctypes.c_uint32
        L.qz_xxh32.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_uint32]
        L.qz_crc64_tables.restype = None
        L.qz_crc64_tables.argtypes = [ctypes.c_uint64, ctypes.c_int32, _u64p]
        L.qz_crc64.restype = ctypes.c_uint64
        L.qz_crc64.argtypes = [_u8p, ctypes.c_int64, _u64p, ctypes.c_uint64,
                               ctypes.c_int32]
        L.qz_lz4_pack.restype = ctypes.c_int64
        L.qz_lz4_pack.argtypes = [_u8p, ctypes.c_int64, _u32p,
                                  ctypes.c_int64, _u8p, ctypes.c_int64]
        L.qz_lz4s_pack.restype = ctypes.c_int64
        L.qz_lz4s_pack.argtypes = [_u8p, ctypes.c_int64, _u32p,
                                   ctypes.c_int64, _u8p, ctypes.c_int64,
                                   ctypes.c_int32]
        L.qz_lz4_compress_block.restype = ctypes.c_int64
        L.qz_lz4_compress_block.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                            ctypes.c_int64, ctypes.c_int32]
        L.qz_lz4s_compress_block.restype = ctypes.c_int64
        L.qz_lz4s_compress_block.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                             ctypes.c_int64, ctypes.c_int32,
                                             ctypes.c_int32]
        L.qz_lz4_compress_batch.restype = None
        L.qz_lz4_compress_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), _i64p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _u8p, _i64p, _i64p, _i64p,
            _u32p, ctypes.c_int32, ctypes.c_int32]
        L.qz_lz4_decompress_block.restype = ctypes.c_int64
        L.qz_lz4_decompress_block.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                              ctypes.c_int64]
        L.qz_lz4_ref_block.restype = ctypes.c_int64
        L.qz_lz4_ref_block.argtypes = [_u8p, ctypes.c_int64, _i32p,
                                       ctypes.c_int64]
        L.qz_lz4_decompress_batch.restype = None
        L.qz_lz4_decompress_batch.argtypes = [
            _u8p, _i64p, _i64p, _u8p, _i64p, _i64p, _i64p, ctypes.c_int32,
            ctypes.c_int32, _u32p, _u32p]
        L.qz_zstd_post_process.restype = ctypes.c_int64
        L.qz_zstd_post_process.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                           ctypes.c_int64, ctypes.c_int32,
                                           _u8p, ctypes.c_int64,
                                           ctypes.c_int32]
        L.qz_zstd_compress.restype = ctypes.c_int64
        L.qz_zstd_compress.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                       ctypes.c_int64, ctypes.c_int32]
        L.qz_zstd_decompress.restype = ctypes.c_int64
        L.qz_zstd_decompress.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                         ctypes.c_int64]
        L.qz_zstd_compress_bound.restype = ctypes.c_uint64
        L.qz_zstd_compress_bound.argtypes = [ctypes.c_uint64]
        # resolved through the library's own dependencies, so only when
        # the build linked libzstd.so.1
        version = getattr(L, "ZSTD_versionNumber", None)
        if version is not None:
            version.restype = ctypes.c_uint
            version.argtypes = []
        self.zstd_version = int(version()) if version is not None else 0

    @property
    def has_zstd(self) -> bool:
        """Whether the library reaches a zstd it can drive (1.5 or later)."""
        return self.zstd_version >= ZSTD_MIN_VERSION

    def _require_zstd(self) -> None:
        if not self.has_zstd:
            found = (f"zstd {self.zstd_version}" if self.zstd_version
                     else "no libzstd.so.1")
            raise RuntimeError(f"the native library was linked with "
                               f"{found}; the zstd calls need libzstd.so.1 "
                               f"of zstd >= 1.5")

    @staticmethod
    def _threads() -> int:
        return min(2 * (os.cpu_count() or 4), 32)

    def crc32(self, data, crc: int = 0) -> int:
        """zlib-compatible crc32 (PCLMUL folding in the C++ runtime)."""
        return int(self._lib.qz_crc32(_ptr(_u8(data)), len(data),
                                      crc & 0xFFFFFFFF))

    def crc64_tables(self, poly: int, reflected: bool) -> np.ndarray:
        """The 8 x 256 slicing tables of CRC64 ``poly`` (reflected or
        not)."""
        tbl = np.empty(8 * 256, np.uint64)
        self._lib.qz_crc64_tables(poly & 0xFFFFFFFFFFFFFFFF,
                                  1 if reflected else 0, _ptr(tbl, _u64p))
        return tbl

    def crc64(self, data, tbl: np.ndarray, crc: int, reflected: bool) -> int:
        """The CRC64 register after ``data``, from ``crc``, with the
        tables of ``crc64_tables`` (slicing-by-8)."""
        return int(self._lib.qz_crc64(
            _ptr(_u8(data)), len(data), _ptr(tbl, _u64p),
            crc & 0xFFFFFFFFFFFFFFFF, 1 if reflected else 0))

    def crc32_combine_many(self, crcs, lens, init: int = 0) -> int:
        c = np.ascontiguousarray(crcs, np.uint32)
        ln = np.ascontiguousarray(lens, np.int64)
        return int(self._lib.qz_crc32_combine_many(
            _ptr(c, _u32p), _ptr(ln, _i64p), len(c), init & 0xFFFFFFFF))

    def deflate_pack(self, src, tokens: np.ndarray, ntok: int,
                     final: bool = True, mode: int = 0) -> bytes:
        """Pack packed-u32 tokens into a raw deflate stream. ``mode``: 0 =
        best of stored/static/dynamic, 1 = static, 2 = dynamic."""
        n = len(src)
        toks = np.ascontiguousarray(tokens[:ntok], np.uint32)
        if toks.dtype != np.uint32:
            raise TypeError("tokens must be uint32")
        cap = n + n // 8 + 1024
        dst = np.empty(cap, np.uint8)
        r = self._lib.qz_deflate_pack(
            _ptr(_u8(src)), n, _ptr(toks, _u32p), ntok, _ptr(dst), cap,
            1 if final else 0, mode)
        if r < 0:
            raise RuntimeError("deflate pack overflow")
        return dst[:r].tobytes()

    def lz77_host(self, src, chain: int = 8) -> np.ndarray:
        """Host hash-chain LZ77 tokenizer (same token format)."""
        n = len(src)
        cap = n // 2 + 64
        toks = np.empty(cap, np.uint32)
        r = self._lib.qz_lz77_host(_ptr(_u8(src)), n, _ptr(toks, _u32p),
                                   cap, chain)
        if r < 0:
            raise RuntimeError("lz77_host token overflow")
        return toks[:int(r)]

    def dyn_plan(self, lfreq: np.ndarray, dfreq: np.ndarray,
                 limit: int = 12):
        """One chunk's dynamic-Huffman plan from its (286,) lit/len and
        (30,) distance histograms (the caller counts the EOB in
        lfreq[256]): both trees optimal and length-limited to ``limit``.

        Returns (lit_pack (286,) u16 = revcode | len << 12, dist_pack
        (30,) u16, header bytes, header bits)."""
        lf = np.ascontiguousarray(lfreq, np.uint32)
        df = np.ascontiguousarray(dfreq, np.uint32)
        if lf.shape != (286,) or df.shape != (30,):
            raise ValueError("dyn_plan expects (286,) lit/len and (30,) "
                             "distance histograms")
        lit_pack = np.empty(286, np.uint16)
        dist_pack = np.empty(30, np.uint16)
        hdr = np.zeros(512, np.uint8)
        r = self._lib.qz_dyn_plan(_ptr(lf, _u32p), _ptr(df, _u32p), limit,
                                  _ptr(lit_pack, _u16p),
                                  _ptr(dist_pack, _u16p), _ptr(hdr),
                                  len(hdr))
        if r < 0:
            raise RuntimeError("dyn_plan failed")
        return lit_pack, dist_pack, hdr[:(int(r) + 7) // 8].tobytes(), int(r)

    def deflate_compress_batch(self, chunks, finals, chain: int = 4,
                               mode: int = 0):
        """Matcher + packer + crc32 for a whole chunk batch in one
        GIL-free call. Returns (payloads, crcs) or None when any chunk
        overflowed its output bound."""
        n = len(chunks)
        srcs = (ctypes.c_void_p * n)()
        lens = np.empty(n, np.int64)
        views = []
        for i, ch in enumerate(chunks):
            a = np.frombuffer(ch, np.uint8)
            views.append(a)
            srcs[i] = a.ctypes.data
            lens[i] = len(a)
        caps = lens + (lens >> 3) + 1024
        dst_off = np.zeros(n, np.int64)
        np.cumsum(caps[:-1], out=dst_off[1:])
        dst = np.empty(max(int(caps.sum()), 1), np.uint8)
        out_len = np.empty(n, np.int64)
        crcs = np.empty(n, np.uint32)
        fin = np.ascontiguousarray(finals, np.uint8)
        self._lib.qz_deflate_compress_batch(
            srcs, _ptr(lens, _i64p), _ptr(fin), chain, mode, _ptr(dst),
            _ptr(dst_off, _i64p), _ptr(caps, _i64p), _ptr(out_len, _i64p),
            _ptr(crcs, _u32p), n, self._threads())
        if (out_len < 0).any():
            return None
        mv = memoryview(dst)
        payloads = [bytes(mv[int(o):int(o + ln)])
                    for o, ln in zip(dst_off, out_len)]
        return payloads, crcs

    def scan_gzipext(self, data):
        """Walk strict QZ-ext gzip members. Returns (pay_off, pay_len,
        src_sz, crcs, consumed), or None if any member is not strict
        QZ-ext."""
        n = len(data)
        cap = max(n // 34, 1)          # 34 = smallest framed member
        pay_off = np.empty(cap, np.int64)
        pay_len = np.empty(cap, np.int64)
        src_sz = np.empty(cap, np.int64)
        crcs = np.empty(cap, np.uint32)
        consumed = np.zeros(1, np.int64)
        cnt = self._lib.qz_scan_gzipext(
            _ptr(_u8(data)), n, _ptr(pay_off, _i64p), _ptr(pay_len, _i64p),
            _ptr(src_sz, _i64p), _ptr(crcs, _u32p), cap,
            _ptr(consumed, _i64p))
        if cnt < 0:
            return None
        c = int(cnt)
        return (pay_off[:c], pay_len[:c], src_sz[:c], crcs[:c],
                int(consumed[0]))

    def inflate_batch_bytes(self, data, in_offs, in_lens, out_sizes,
                            nthreads: int = 0):
        """Decode a member batch into one contiguous buffer on a native
        pool of ``nthreads`` threads (0: ``_threads()``). Returns (out
        bytes, member crcs, member output lengths (-1 = malformed),
        member input bytes used)."""
        n = len(in_offs)
        in_offs = np.ascontiguousarray(in_offs, np.int64)
        in_lens = np.ascontiguousarray(in_lens, np.int64)
        caps = np.ascontiguousarray(out_sizes, np.int64)
        out_offs = np.zeros(n, np.int64)
        np.cumsum(caps[:-1], out=out_offs[1:])
        total = int(caps.sum())
        dst = np.empty(max(total, 1), np.uint8)
        out_lens = np.empty(n, np.int64)
        in_used = np.empty(n, np.int64)
        crcs = np.empty(n, np.uint32)
        self._lib.qz_inflate_batch(
            _ptr(_u8(data)), _ptr(in_offs, _i64p), _ptr(in_lens, _i64p),
            _ptr(dst), _ptr(out_offs, _i64p), _ptr(caps, _i64p),
            _ptr(out_lens, _i64p), _ptr(crcs, _u32p), n,
            nthreads if nthreads > 0 else self._threads(),
            _ptr(in_used, _i64p))
        return dst[:total].tobytes(), crcs, out_lens, in_used

    # -- LZ4 / LZ4s ------------------------------------------------------------

    def xxh32(self, data, seed: int = 0) -> int:
        """XXH32 of ``data`` (LZ4 frame checksums)."""
        return int(self._lib.qz_xxh32(_ptr(_u8(data)), len(data),
                                      seed & 0xFFFFFFFF))

    def _pack_tokens(self, fn, src, tokens, ntok, *extra) -> bytes:
        n = len(src)
        toks = np.ascontiguousarray(tokens[:ntok], np.uint32)
        cap = n + n // 128 + 1024
        dst = np.empty(cap, np.uint8)
        r = fn(_ptr(_u8(src)), n, _ptr(_u32(toks), _u32p), ntok, _ptr(dst),
               cap, *extra)
        if r <= 0:
            raise RuntimeError("lz4 token pack overflow or bad token")
        return dst[:r].tobytes()

    def lz4_pack(self, src, tokens: np.ndarray, ntok: int) -> bytes:
        """Pack packed-u32 tokens into an LZ4 block (the end-of-block
        rules applied: no match in the last 12 bytes, 5 trailing
        literals)."""
        return self._pack_tokens(self._lib.qz_lz4_pack, src, tokens, ntok)

    def lz4s_pack(self, src, tokens: np.ndarray, ntok: int,
                  mini_match: int = 3) -> bytes:
        """Pack packed-u32 tokens into an LZ4s block (stored match length
        len - (mini_match - 1))."""
        return self._pack_tokens(self._lib.qz_lz4s_pack, src, tokens, ntok,
                                 mini_match)

    def lz4_compress_block(self, src, max_distance: int = 65535) -> bytes:
        """The host LZ4 block coder."""
        n = len(src)
        cap = n + n // 255 + 64
        dst = np.empty(cap, np.uint8)
        r = self._lib.qz_lz4_compress_block(_ptr(_u8(src)), n, _ptr(dst), cap,
                                            max_distance)
        if r <= 0:
            raise RuntimeError(f"lz4 compress failed rc={r}")
        return dst[:r].tobytes()

    def lz4s_compress_block(self, src, mini_match: int = 3,
                            max_distance: int = 32768) -> bytes:
        """The host LZ4s block coder."""
        n = len(src)
        cap = n + n // 255 + 64
        dst = np.empty(cap, np.uint8)
        r = self._lib.qz_lz4s_compress_block(_ptr(_u8(src)), n, _ptr(dst),
                                             cap, mini_match, max_distance)
        if r <= 0:
            raise RuntimeError(f"lz4s compress failed rc={r}")
        return dst[:r].tobytes()

    def lz4_compress_batch(self, chunks, fmt: str = "lz4",
                           mini_match: int = 3, max_distance: int = 32768):
        """LZ4 (or LZ4s) block coder + crc32 for a whole chunk batch in
        one GIL-free call. Returns (payloads, crcs) or None when a chunk
        failed."""
        n = len(chunks)
        srcs = (ctypes.c_void_p * n)()
        lens = np.empty(n, np.int64)
        views = []
        for i, ch in enumerate(chunks):
            a = np.frombuffer(ch, np.uint8)
            views.append(a)
            srcs[i] = a.ctypes.data
            lens[i] = len(a)
        caps = lens + lens // 255 + 64
        dst_off = np.zeros(n, np.int64)
        np.cumsum(caps[:-1], out=dst_off[1:])
        dst = np.empty(max(int(caps.sum()), 1), np.uint8)
        out_len = np.empty(n, np.int64)
        crcs = np.empty(n, np.uint32)
        self._lib.qz_lz4_compress_batch(
            srcs, _ptr(lens, _i64p), 1 if fmt == "lz4s" else 0, mini_match,
            max_distance, _ptr(dst), _ptr(dst_off, _i64p), _ptr(caps, _i64p),
            _ptr(out_len, _i64p), _ptr(crcs, _u32p), n, self._threads())
        if (out_len <= 0).any():
            return None
        mv = memoryview(dst)
        payloads = [bytes(mv[int(o):int(o + ln)])
                    for o, ln in zip(dst_off, out_len)]
        return payloads, crcs

    def lz4_decompress_block(self, src, out_cap: int) -> bytes:
        """Decode one LZ4 block of at most ``out_cap`` bytes; raises
        ValueError on a malformed block."""
        dst = np.empty(max(out_cap, 1), np.uint8)
        r = self._lib.qz_lz4_decompress_block(_ptr(_u8(src)), len(src),
                                              _ptr(dst), out_cap)
        if r < 0:
            raise ValueError("malformed LZ4 block")
        return dst[:r].tobytes()

    def lz4_ref_block(self, payload, ref_row: np.ndarray, cap: int) -> int:
        """Parse one LZ4 block into ``ref_row`` (a contiguous int32 array
        of at least ``cap`` entries): ``-(byte + 1)`` at a literal's output
        position, the earlier output index it copies at a match's. Returns
        the decoded size, or -1 for a malformed block or one over ``cap``
        bytes; positions past the decoded size keep their values."""
        if (ref_row.dtype != np.int32 or not ref_row.flags.c_contiguous
                or len(ref_row) < cap):
            raise ValueError("ref_row must be a contiguous int32 array of "
                             f"at least {cap} entries")
        return int(self._lib.qz_lz4_ref_block(
            _ptr(_u8(payload)), len(payload), _ptr(ref_row, _i32p), cap))

    def lz4_batch_bytes(self, data, in_offs, in_lens, out_caps,
                        want_xxh: bool = False, xxh_seed: int = 0):
        """Decode a block batch into one buffer on a native thread pool
        (``in_lens[i] < 0``: a stored block of ``-in_lens[i]`` bytes).
        Returns (out bytes of sum(out_caps), decoded size per block (-1 =
        malformed), crc32 per block, XXH32 of the whole output when
        ``want_xxh`` and the blocks allowed it, else None)."""
        n = len(in_offs)
        offs = np.ascontiguousarray(in_offs, np.int64)
        lens = np.ascontiguousarray(in_lens, np.int64)
        caps = np.ascontiguousarray(out_caps, np.int64)
        out_offs = np.zeros(n, np.int64)
        np.cumsum(caps[:-1], out=out_offs[1:])
        total = int(caps.sum())
        dst = np.empty(max(total, 1), np.uint8)
        out_lens = np.empty(n, np.int64)
        crcs = np.empty(n, np.uint32)
        xxh = np.array([xxh_seed & 0xFFFFFFFF, 0], np.uint32)
        self._lib.qz_lz4_decompress_batch(
            _ptr(_u8(data)), _ptr(offs, _i64p), _ptr(lens, _i64p), _ptr(dst),
            _ptr(out_offs, _i64p), _ptr(caps, _i64p), _ptr(out_lens, _i64p),
            n, self._threads(), _ptr(crcs, _u32p),
            _ptr(xxh, _u32p) if want_xxh else None)
        xh = int(xxh[0]) if want_xxh and xxh[1] else None
        return dst[:total].tobytes(), out_lens, crcs, xh

    # -- zstd (raise unless the library was linked with libzstd.so.1) ------

    def zstd_post_process(self, src, lz4s_blocks, mini_match: int = 3,
                          level: int = 0) -> bytes:
        """Re-emit an LZ4s block stream of ``src`` as zstd frames
        (ZSTD_compressSequences with explicit block delimiters)."""
        self._require_zstd()
        cap = int(self._lib.qz_zstd_compress_bound(len(src))) + 4096
        dst = np.empty(cap, np.uint8)
        r = self._lib.qz_zstd_post_process(
            _ptr(_u8(src)), len(src), _ptr(_u8(lz4s_blocks)),
            len(lz4s_blocks), mini_match, _ptr(dst), cap, level)
        if r < 0:
            raise RuntimeError(f"zstd post-process failed rc={r}")
        return dst[:r].tobytes()

    def zstd_compress(self, src, level: int = 3) -> bytes:
        self._require_zstd()
        cap = int(self._lib.qz_zstd_compress_bound(len(src))) + 64
        dst = np.empty(cap, np.uint8)
        r = self._lib.qz_zstd_compress(_ptr(_u8(src)), len(src), _ptr(dst),
                                       cap, level)
        if r < 0:
            raise RuntimeError(f"zstd compress failed rc={r}")
        return dst[:r].tobytes()

    def zstd_decompress(self, src, out_cap: int) -> bytes:
        """Decode the zstd frames of ``src`` (one shot, at most
        ``out_cap`` bytes); raises BufferError when they do not fit,
        RuntimeError when they are malformed."""
        self._require_zstd()
        dst = np.empty(max(out_cap, 1), np.uint8)
        r = self._lib.qz_zstd_decompress(_ptr(_u8(src)), len(src), _ptr(dst),
                                         out_cap)
        if r == ZSTD_DST_TOO_SMALL_RC:
            raise BufferError(f"zstd output over {out_cap} bytes")
        if r < 0:
            raise RuntimeError(f"zstd decompress failed rc={r}")
        return dst[:r].tobytes()


def _u32(a: np.ndarray) -> np.ndarray:
    """Non-empty uint32 array (ctypes needs a valid pointer)."""
    return a if len(a) else np.zeros(1, np.uint32)


def zstd_link_args():
    """The linker flags that bind libzstd.so.1 by its soname, or none
    where the library is not installed (the zstd calls then raise).
    ``--no-as-needed`` keeps it: the declarations are weak, and the
    linker would otherwise drop a library no strong reference needs."""
    if ctypes.util.find_library("zstd") is None:
        return []
    return ["-Wl,--no-as-needed", "-l:libzstd.so.1"]


_lock = threading.Lock()
# another thread may hold it when the process forks
os.register_at_fork(after_in_child=_lock._at_fork_reinit)
_lib = None


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("model name")), "")
    except OSError:
        return ""


def library_path() -> str:
    """Build (or find) the port's native library and return its path. It
    is built with -march=native, so the CPU model selects it too."""
    return build_library(
        "qztorch_native", [_SRC],
        [os.path.join(_SHIM, f) for f in sorted(os.listdir(_SHIM))],
        lambda src, obj: ["g++", "-O3", "-fPIC", "-std=c++17",
                          "-march=native", "-I", _SHIM, "-c", "-o", obj,
                          src],
        lambda out, objs: ["g++", "-shared", "-o", out, *objs,
                           *zstd_link_args()],
        tag=_cpu_model())


def get_lib() -> NativeLib:
    """The loaded native library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = NativeLib(library_path())
        return _lib
