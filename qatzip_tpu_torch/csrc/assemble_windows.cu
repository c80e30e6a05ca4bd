// Window assembly of the full-device DEFLATE pack: OR each 256-position
// group's bit window into the output row at the group's word offset.
//
// Replaces the TPU kernel k1, qatzip_tpu/ops/pallas_pack.py
// assemble_windows / _assemble_kernel, bit for bit: out[b, wo[b, g] + j]
// |= grp[b, g, j], and a word at or past max_words is dropped.
//
// One CTA per row. The row image (max_words words: 73.7 KB for the static
// packer and 98.8 KB for the dynamic one at n = 65536) lives in dynamic
// shared memory, which needs the opt-in above 48 KB. Threads stride over
// (group, word) in input order, so neighbouring threads read neighbouring
// words, and atomicOr each non-zero window word into shared memory:
// adjacent windows share their straddle words, and plain stores would
// race there. The bits that two windows give one word are disjoint, so
// the result does not depend on the order of the atomics. The finished
// row is then stored coalesced.
//
// Bounds on the H100: the kernel reads each window word once and writes
// each output word once (19.4 MB in and 18.9 MB out for a static tile of
// 256 x 64 KiB rows; 26 and 25.3 MB dynamic), so it is bound by device
// memory, ~11-15 us at 3.35 TB/s. The shared-memory atomics touch only
// the non-zero words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(1024)
assemble_kernel(const uint32_t* __restrict__ grp,
                const int32_t* __restrict__ wo, uint32_t* __restrict__ out,
                int ngroups, int w, int max_words) {
  extern __shared__ uint32_t row[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t b = blockIdx.x;
  for (int i = tid; i < max_words; i += nt) row[i] = 0u;
  __syncthreads();

  const uint32_t* g = grp + b * ngroups * w;
  const int32_t* o = wo + b * ngroups;
  const int total = ngroups * w;
  for (int i = tid; i < total; i += nt) {
    const uint32_t v = g[i];
    if (v == 0u) continue;
    const int gi = i / w;
    const long long dst = (long long)o[gi] + (i - gi * w);
    if (dst >= 0 && dst < max_words) atomicOr(&row[dst], v);
  }
  __syncthreads();

  uint32_t* dst_row = out + b * max_words;
  for (int i = tid; i < max_words; i += nt) dst_row[i] = row[i];
}

}  // namespace

extern "C" int qz_assemble_windows(const void* grp, const void* wo,
                                   void* out, int rows, int ngroups, int w,
                                   int max_words, void* stream) {
  const size_t smem = (size_t)max_words * sizeof(uint32_t);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(assemble_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  assemble_kernel<<<rows, 1024, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)grp, (const int32_t*)wo, (uint32_t*)out, ngroups, w,
      max_words);
  return (int)cudaGetLastError();
}
