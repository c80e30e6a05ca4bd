"""Each kernel's roofline count against chip_smoke.py's at PERF.md's
kernel table's shapes: the same bytes and operations, and so the same
"bound ms" (0.1127, 0.0351, 0.0607 / 0.0977, 0.0802, 0.0402, 0.0651,
0.0050)."""

import pytest

from qzbench import harness

HBM, OPS = 3.35e12, 67e12
TILE_B, N = 256, 65536


def _max_words():
    from qatzip_tpu_torch.ops import deflate_pack as dp, lz4_pack as lp
    return ((N * 9 + dp.HDR_BITS + dp.EOB_BITS + 31) // 32 + 2,
            (N * dp.DYN_LIMIT + 4096 + 31) // 32 + 2, lp.lz4_max_words(N))


def cases():
    mw_static, mw_dyn, mw_lz4 = _max_words()
    pos = TILE_B * N
    # (kernel, launch args, chip_smoke.py's bytes, its bound ms in PERF.md)
    return [
        ("candidate_search", (1, 2, 3, 2304, 8192, 13, 3, 7, 4, 0),
         2304 * 8192 * 4 * (2 + 3), 0.1127),
        ("parse_scan", (1, 2, 3, 4, 2048, 8192, 0), 2048 * 8192 * 7, 0.0351),
        ("pack_rows", (1, 2, 3, 4, 5, 0, 0, 8, 9, 10, TILE_B, N, mw_static, 0),
         pos * 11 + TILE_B * (mw_static + 2) * 4, 0.0607),
        ("pack_rows", (0, 2, 3, 4, 5, 6, 7, 8, 9, 10, TILE_B, N, mw_dyn, 0),
         pos * 18 + TILE_B * (mw_dyn + 2) * 4, 0.0977),
        ("huffman_lookup", (1, 2, 3, 4, 5, 6, TILE_B, N, 0),
         pos * 16 + TILE_B * 316 * 4, 0.0802),
        ("symbol_histogram", (1, 2, 3, TILE_B, N, 0),
         pos * 8 + TILE_B * 316 * 4, 0.0402),
        ("lz4_pack_rows", (1, 2, 3, 4, 5, 6, 7, 8, TILE_B, N, mw_lz4, 0),
         pos * 11 + TILE_B * (mw_lz4 * 4 + 5), 0.0651),
        ("crc32_rows", (1, 2, 3, 4, TILE_B, N, 0, 0), pos + TILE_B * 4, 0.0050),
    ]


@pytest.mark.parametrize("i", range(8))
def test_counts_and_bounds_equal_chip_smoke(i):
    kernel, args, want_bytes, bound_ms = cases()[i]
    mod = harness.rooflines()[kernel]
    nbytes, ops = mod.count(args)
    assert nbytes == want_bytes
    ms = max(nbytes / HBM, ops / OPS) * 1e3
    assert round(ms, 4) == bound_ms
    assert nbytes / HBM >= ops / OPS        # bound by bytes, as PERF.md says


def test_every_route_kernel_has_a_roofline_and_the_profiler_names_match():
    from qatzip_tpu_torch.ops import cuda_pack
    rls = harness.rooflines()
    assert set(rls) <= set(cuda_pack.LAUNCHES)
    for cfg in ("deflate_l1", "lz4_l1", "deflate_l1_x4"):
        import json
        import os
        c = json.load(open(os.path.join(harness.HERE, "configs", f"{cfg}.json")))
        assert set(c["route_kernels"]) <= set(rls)
    assert rls["pack_rows"].matches("pack_rows_kernel(Planes, int const*)")
    assert not rls["pack_rows"].matches("lz4_pack_rows_kernel(Planes)")
    assert rls["lz4_pack_rows"].matches("void lz4_pack_rows_kernel<4>(x)")
    assert rls["crc32_rows"].matches("qz::crc_kernel(unsigned char const*)")
