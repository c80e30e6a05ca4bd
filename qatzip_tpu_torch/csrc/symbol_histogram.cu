// Per-row DEFLATE symbol histogram, pass 1 of the dynamic full-device
// pack.
//
// Replaces the TPU kernel k4, qatzip_tpu/ops/pallas_pack.py
// symbol_histogram / _hist_kernel, with the same counts: hist[b, v] is
// the number of positions p with sym[b, p] == v for v in [0, 316), plus
// those with dsym[b, p] == v for v in [284, 316) (distance symbols arrive
// as 286 + dsym; anything else is ignored). The TPU kernel needs
// n % 1024 == 0; this one takes any n.
//
// The TPU kernel compared each 1024-position block against all 320 bins
// in VMEM. On the H100 each CTA keeps 316 int bins in shared memory and
// counts SPAN positions of one row with shared-memory atomicAdd, then adds
// its non-zero bins to the row's output with one global atomicAdd each
// (the wrapper zeroes the output). Integer counts do not depend on the
// order of the atomics, so the result is exact.
//
// Bounds on the H100: 8 bytes of device memory per position (two int32
// symbols), 134 MB per tile of 256 x 64 KiB rows, ~40 us at 3.35 TB/s.
// Many positions of one row share a few bins (a run of one byte, one
// length), which serialises their shared-memory atomics; that, not device
// memory, may bound the kernel on such data.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kBins = 316;
constexpr int kDistLo = 284;   // the TPU kernel's 32 distance bins: 284..315
constexpr int kThreads = 256;
constexpr int kSpan = 8192;    // positions per CTA

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* __restrict__ sym, const int32_t* __restrict__ dsym,
            int32_t* __restrict__ hist, int n, int per_row) {
  __shared__ int bins[kBins];
  const int tid = threadIdx.x;
  for (int i = tid; i < kBins; i += kThreads) bins[i] = 0;
  __syncthreads();

  const size_t r = blockIdx.x / per_row;
  const int c = blockIdx.x % per_row;
  const size_t base = r * n;
  const int start = c * kSpan;
  const int end = min(start + kSpan, n);
  for (int p = start + tid; p < end; p += kThreads) {
    const uint32_t s = (uint32_t)sym[base + p];
    if (s < (uint32_t)kBins) atomicAdd(&bins[s], 1);
    const uint32_t d = (uint32_t)dsym[base + p] - (uint32_t)kDistLo;
    if (d < (uint32_t)(kBins - kDistLo)) atomicAdd(&bins[kDistLo + d], 1);
  }
  __syncthreads();

  for (int i = tid; i < kBins; i += kThreads)
    if (bins[i]) atomicAdd(&hist[r * kBins + i], bins[i]);
}

}  // namespace

extern "C" int qz_symbol_histogram(const void* sym, const void* dsym,
                                   void* hist, int rows, int n, void* stream) {
  const int per_row = (n + kSpan - 1) / kSpan;
  return qz::launch(hist_kernel, rows * per_row, kThreads, 0, stream,
                    (const int32_t*)sym, (const int32_t*)dsym, (int32_t*)hist,
                    n, per_row);
}
