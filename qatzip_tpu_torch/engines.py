"""The host (software) chunk engine and the shared host worker pool.

Counterpart of ``qatzip_tpu/engines.py`` for deflate, LZ4 and LZ4s.
``HostEngine`` serves the reference's size gate: a request shorter than
``input_sz_thrshold`` is compressed in software (src/qatzip.c:2098-2116).
It is not a fallback for a missing or failing device. It also decodes
the LZ4 blocks of frames the codec's batched decode does not take.
"""

from __future__ import annotations

import concurrent.futures as _fut
import os
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

from .constants import effective_deflate_sw_level
from .ops.checksum import crc32

_pool_lock = threading.Lock()
_pool: Optional[_fut.ThreadPoolExecutor] = None


def host_pool() -> _fut.ThreadPoolExecutor:
    """Shared worker pool for the host packer; the native calls release
    the GIL, so threads scale across cores."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = _fut.ThreadPoolExecutor(
                max_workers=max(4, os.cpu_count() or 8))
        return _pool


class HostEngine:
    """Software engine: for deflate the native hash-chain matcher and
    packer at levels 1-5 (the JAX package's default software coder), zlib
    above; for LZ4 and LZ4s the native block coders."""

    name = "host"

    def compress_chunks(self, chunks: Sequence[bytes], *, level: int,
                        algorithm: str = "deflate",
                        final_flags: Optional[Sequence[bool]] = None,
                        mini_match: int = 3, huffman_static: bool = False,
                        ) -> List[Tuple[bytes, int]]:
        """Each chunk to an independent payload + its crc32. A deflate
        payload is a complete raw stream when its final flag is set, else
        a full-flushed segment; an LZ4 or LZ4s payload is one block.
        ``huffman_static`` is accepted for interface parity; the software
        coder picks its own block type, as in the JAX package."""
        from . import native
        zlevel = effective_deflate_sw_level(level)
        finals = final_flags or [True] * len(chunks)
        lib = native.get_lib()
        use_native = zlevel <= 5 and algorithm == "deflate"
        chain = 4 if zlevel <= 3 else 16
        if algorithm not in ("deflate", "lz4", "lz4s"):
            raise ValueError(f"unknown algorithm {algorithm}")

        def one(args):
            chunk, final = args
            if algorithm == "lz4":
                return lib.lz4_compress_block(chunk, 32768), crc32(chunk)
            if algorithm == "lz4s":
                return lib.lz4s_compress_block(chunk, mini_match), crc32(chunk)
            if use_native and len(chunk):
                toks = lib.lz77_host(chunk, chain=chain)
                payload = lib.deflate_pack(chunk, toks, len(toks),
                                           final=final, mode=0)
            else:
                co = zlib.compressobj(zlevel, zlib.DEFLATED, -15)
                payload = co.compress(chunk) + co.flush(
                    zlib.Z_FINISH if final else zlib.Z_FULL_FLUSH)
            return payload, crc32(chunk)

        items = list(zip(chunks, finals))
        if len(items) <= 1:
            return [one(a) for a in items]
        if use_native and all(len(c) for c in chunks):
            batched = lib.deflate_compress_batch(
                chunks, [1 if f else 0 for f in finals], chain=chain, mode=0)
            if batched is not None:
                payloads, crcs = batched
                return [(p, int(c)) for p, c in zip(payloads, crcs)]
        if algorithm != "deflate" and all(len(c) for c in chunks):
            batched = lib.lz4_compress_batch(chunks, fmt=algorithm,
                                             mini_match=mini_match)
            if batched is not None:
                payloads, crcs = batched
                return [(p, int(c)) for p, c in zip(payloads, crcs)]
        return list(host_pool().map(one, items))

    def decompress_chunks(self, payloads: Sequence[bytes],
                          expected_sizes: Sequence[int], *,
                          algorithm: str) -> List[bytes]:
        """Decode independent LZ4 blocks on the host pool, in order, each
        of at most its expected size, with the native block decoder. A
        malformed block raises QZ_DATA_ERROR."""
        from . import native
        from .constants import QZ_DATA_ERROR, QzError
        if algorithm != "lz4":
            raise ValueError(f"the host engine decodes LZ4 blocks, not "
                             f"{algorithm}")
        lib = native.get_lib()

        def one(args):
            payload, sz = args
            try:
                return lib.lz4_decompress_block(payload, sz)
            except ValueError as e:
                raise QzError(QZ_DATA_ERROR, str(e)) from None

        items = list(zip(payloads, expected_sizes))
        if len(items) <= 1:
            return [one(a) for a in items]
        return list(host_pool().map(one, items))


host_engine = HostEngine()
