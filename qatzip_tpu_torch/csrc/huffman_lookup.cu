// Per-row Huffman code lookup of the dynamic full-device DEFLATE pack.
//
// Replaces the TPU kernel k3, qatzip_tpu/ops/pallas_pack.py
// huffman_lookup / _lookup_kernel: lout[b, p] = lit_pack[b, sym[b, p]]
// and dout[b, p] = dist_pack[b, dsym[b, p]], with 0 for a symbol outside
// its table (sym 286 marks a position that emits nothing), as the TPU
// kernel's zero padding gives.
//
// The TPU kernel split the 286-entry table into three 128-lane subtables
// because a lane gather was its only cheap gather. On the H100 the whole
// table pair (316 words) sits in shared memory: each CTA loads its row's
// tables, then streams SPAN positions of that row with neighbouring
// threads on neighbouring positions, so every load and store of the
// symbol and code planes is coalesced.
//
// Bounds on the H100: 16 bytes of device memory per position (two int32
// symbols in, two code words out), 268 MB per tile of 256 x 64 KiB rows,
// ~80 us at 3.35 TB/s. The table reads hit shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kLit = 286;
constexpr int kDist = 30;
constexpr int kThreads = 256;
constexpr int kSpan = 4096;  // positions per CTA

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const uint32_t* __restrict__ lit, const uint32_t* __restrict__ dist,
              const int32_t* __restrict__ sym, const int32_t* __restrict__ dsym,
              uint32_t* __restrict__ lout, uint32_t* __restrict__ dout, int n,
              int per_row) {
  __shared__ uint32_t tl[kLit];
  __shared__ uint32_t td[kDist];
  const int tid = threadIdx.x;
  const size_t r = blockIdx.x / per_row;
  const int c = blockIdx.x % per_row;
  for (int i = tid; i < kLit; i += kThreads) tl[i] = lit[r * kLit + i];
  for (int i = tid; i < kDist; i += kThreads) td[i] = dist[r * kDist + i];
  __syncthreads();

  const size_t base = r * n;
  const int start = c * kSpan;
  const int end = min(start + kSpan, n);
  for (int p = start + tid; p < end; p += kThreads) {
    const uint32_t s = (uint32_t)sym[base + p];
    const uint32_t d = (uint32_t)dsym[base + p];
    lout[base + p] = s < (uint32_t)kLit ? tl[s] : 0u;
    dout[base + p] = d < (uint32_t)kDist ? td[d] : 0u;
  }
}

}  // namespace

extern "C" int qz_huffman_lookup(const void* lit_pack, const void* dist_pack,
                                 const void* sym, const void* dsym, void* lout,
                                 void* dout, int rows, int n, void* stream) {
  const int per_row = (n + kSpan - 1) / kSpan;
  return qz::launch(lookup_kernel, rows * per_row, kThreads, 0, stream,
                    (const uint32_t*)lit_pack, (const uint32_t*)dist_pack,
                    (const int32_t*)sym, (const int32_t*)dsym,
                    (uint32_t*)lout, (uint32_t*)dout, n, per_row);
}
