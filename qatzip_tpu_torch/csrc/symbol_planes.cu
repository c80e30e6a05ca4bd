// The dynamic DEFLATE pack's symbol planes, for both of its passes.
//
// Replaces the plain-torch stages deflate_pack.py hist_symbols and
// lookup_symbols (the length and distance symbols of _len_symbol and
// _dist_symbol), which XLA fused on the TPU (qatzip_tpu/ops/deflate_pack.py
// _len_symbol / _dist_symbol inside _deflate_analyze_hist and
// _deflate_pack_dynamic; no Pallas kernel there). Per position, from the
// parse's planes:
//   lsym = 257 + ml - 3 below a length of 11, 285 at 258, else
//          257 + 4 (e + 1) + ((ml - 3) >> e) & 3 with e = bitlen(ml - 3) - 3;
//   dsym = dist - 1 below 5, else 2 (e + 1) + ((dist - 1) >> e) & 1 with
//          e = bitlen(dist - 1) - 2;
// bitlen taken, as the plain version takes it, from the exponent of the
// value rounded to float32. Mode 1 (pass 1, as symbol_histogram counts):
// sym = lsym where taken, the byte where lit, else 320; dsym = 286 + dsym
// where taken, else 320. Mode 2 (pass 2, as huffman_lookup reads): sym =
// lsym where taken, the byte where lit, else 286; dsym everywhere.
//
// Bounds on the H100: 11 bytes in (data, ml, dist, taken, lit) and 8 out a
// position, 319 MB at 256 x 64 KiB rows, ~95 us at 3.35 TB/s. The torch
// route ran ~62 operations a pass over int64 planes.
//
// Design: one thread a position over the flat (B, n) planes, neighbouring
// threads on neighbouring positions, so every load and store is coalesced;
// the symbol arithmetic (a float conversion for each bit length, a few
// shifts and selects) stays in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65536 * 8;

// floor(log2(x)) + 1 of x >= 1 rounded to float32: its frexp exponent
__device__ __forceinline__ long long bitlen_f32(long long x) {
  return ((__float_as_int(__ll2float_rn(x)) >> 23) & 0xFF) - 126;
}

__global__ void __launch_bounds__(kThreads)
symbol_planes_kernel(const uint8_t* __restrict__ data,
                     const int32_t* __restrict__ ml,
                     const int32_t* __restrict__ dist,
                     const uint8_t* __restrict__ taken,
                     const uint8_t* __restrict__ lit,
                     int32_t* __restrict__ sym, int32_t* __restrict__ dsym,
                     long long total, int mode) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += step) {
    const int32_t m = ml[i];
    const long long lc = (long long)m - 3;
    const long long e_len = max(bitlen_f32(max(lc, 1LL)) - 3, 0LL);
    const long long lsym = lc < 8 ? 257 + lc
                           : m == 258
                               ? 285
                               : 257 + 4 * (e_len + 1) + ((lc >> e_len) & 3);
    const long long d1 = (long long)dist[i] - 1;
    const long long e_d = max(bitlen_f32(max(d1, 1LL)) - 2, 0LL);
    const long long ds = d1 < 4 ? d1 : 2 * (e_d + 1) + ((d1 >> e_d) & 1);
    const bool tk = taken[i] != 0;
    const long long none = mode == 1 ? 320 : 286;
    sym[i] = (int32_t)(tk ? lsym : lit[i] ? (long long)data[i] : none);
    dsym[i] = (int32_t)(mode == 1 ? (tk ? 286 + ds : 320) : ds);
  }
}

}  // namespace

extern "C" int qz_symbol_planes(const void* data, const void* ml,
                                const void* dist, const void* taken,
                                const void* lit, void* sym, void* dsym,
                                int rows, int n, int mode, void* stream) {
  if (rows <= 0 || n <= 0 || (mode != 1 && mode != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)rows * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return qz::launch(symbol_planes_kernel, (unsigned)blocks, kThreads, 0,
                    stream, (const uint8_t*)data, (const int32_t*)ml,
                    (const int32_t*)dist, (const uint8_t*)taken,
                    (const uint8_t*)lit, (int32_t*)sym, (int32_t*)dsym, total,
                    mode);
}
