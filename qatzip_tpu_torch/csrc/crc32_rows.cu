// CRC32 of every row of a (B, n) byte tile, for the device CRC.
//
// Replaces qatzip_tpu/ops/crc32_mxu.py crc32_batch_device, which the JAX
// package ran as one XLA dot: the rows' bits, (B, 8n) in bf16, times the
// (8n, 32) GF(2) matrix V, then parity, packing and ^ crc(0^n). On the
// H100 the same product runs on the binary tensor cores, reading each byte
// once: mma.sync m16n8k256 .b1 with .and.popc takes 16 rows x 256 bits of
// the rows (A) and 256 bits x 8 of V's columns (B) and adds the popcounts
// of their ANDs; the parity of the sum is the GF(2) product.
//
// crc(M) = L(M) ^ crc(0^n), where L is the linear part: the register
// update from 0 with no final xor. L is linear, and leading zero bytes do
// not change it, so a row is taken as zero-padded at its front to whole
// blocks of kBlock bytes, and L(A || B) = L(A) * x^(8|B|) ^ L(B) mod P
// (zlib's crc32_combine). Design:
//   * a CTA takes 16 rows x one block: kWarps warps of kSteps 128-byte
//     steps each, all its loads issued at once (a (256, 65536) tile is
//     512 CTAs of 128 threads at 62 registers: one wave; 8 warps of 2
//     steps at 72 registers fit three CTAs an SM, two waves, and took
//     half again as long: chip_smoke.py --crc-variants);
//   * V of a block is the same for every block (L relative to the block's
//     end), so its B fragments come from one 64 KiB array laid out lane by
//     lane (ops/crc32_mxu.py mma_fragments), read through L1; 16 MMAs a
//     step (4 k-steps of 256 bits, 4 n-tiles of 8 of L's 32 bits);
//   * lane (g, q) loads bytes [32 q, 32 q + 32) of each step of rows g and
//     g + 8; register a0 (a2) of k-step ks is its word 2 ks (2 ks + 1),
//     which the MMA pairs with bits k = 32 q + i (128 + 32 q + i) of B, so
//     B's bit i of b0 (b1) is V at byte 32 q + 8 ks (+ 4) + i / 8;
//   * the warps' parities xor to L(block) in shared memory, one product by
//     x^(8 kBlock m) (m: blocks after it; the wrapper's tails) moves it to
//     the row's end, and an atomicXor folds the row's blocks into its
//     int64 crc (zeroed before the launch; block 0 adds crc(0^n)).
// The tables of the design it replaced (slicing by 8, a row over a
// cluster of CTAs) are measured beside it by chip_smoke.py.
//
// Bounds on the H100 at (256, 65536): 16 MiB read, 0.005 ms at 3.35 TB/s;
// the MMAs (131,072 for the tile) are far from the tensor cores' rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;  // reflected CRC-32
constexpr int kWarps = 4;
constexpr int kSteps = 4;                        // 128-byte steps a warp
constexpr int kBlock = 128 * kWarps * kSteps;    // 2 KiB of each row a CTA
constexpr int kRows = 16;                        // rows a CTA: the MMA's M

// a * b mod P in zlib's reflected representation (bit 31 is x^0)
__device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes of a row from its index p (below 0: the front padding, zeros);
// kVec: n % 16 == 0 and a 16-byte aligned tile, so every load is whole and
// wholly padding or wholly row (a separate kernel: the byte loads' code
// would cost the vector kernel registers)
template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* row, long long p) {
  if (kVec)
    return p >= 0 ? __ldg(reinterpret_cast<const uint4*>(row + p))
                  : make_uint4(0, 0, 0, 0);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (p + e >= 0) w[e >> 2] |= (uint32_t)row[p + e] << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
crc_kernel(const uint8_t* __restrict__ data,
           unsigned long long* __restrict__ out,
           const uint4* __restrict__ frag, const uint32_t* __restrict__ tails,
           int rows, int n, uint32_t zero_crc) {
  __shared__ uint32_t part[kWarps][kRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.x, nb = gridDim.x;
  const int r0 = blockIdx.y * kRows + g, r1 = r0 + 8;
  // the first byte of this lane's piece of its first step (below 0: the
  // front padding)
  const long long start = (long long)b * kBlock + warp * kSteps * 128 +
                          32 * q - ((long long)nb * kBlock - n);
  uint4 a[kSteps][4];
#pragma unroll
  for (int t = 0; t < kSteps; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = start + 128 * t + 16 * h;
      a[t][h] = r0 < rows ? load16<kVec>(data + (size_t)r0 * n, p)
                          : make_uint4(0, 0, 0, 0);
      a[t][2 + h] = r1 < rows ? load16<kVec>(data + (size_t)r1 * n, p)
                              : make_uint4(0, 0, 0, 0);
    }
  int c[4][4] = {};
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const uint4* f = frag + ((size_t)(warp * kSteps + t) * 32 + lane) * 8;
    uint32_t bw[32];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const uint4 v = __ldg(f + u);
      bw[4 * u] = v.x;
      bw[4 * u + 1] = v.y;
      bw[4 * u + 2] = v.z;
      bw[4 * u + 3] = v.w;
    }
    // rows g and g + 8: eight words each of this lane's 32 bytes
    const uint32_t w0[8] = {a[t][0].x, a[t][0].y, a[t][0].z, a[t][0].w,
                            a[t][1].x, a[t][1].y, a[t][1].z, a[t][1].w};
    const uint32_t w1[8] = {a[t][2].x, a[t][2].y, a[t][2].z, a[t][2].w,
                            a[t][3].x, a[t][3].y, a[t][3].z, a[t][3].w};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_b1(c[j], w0[2 * ks], w1[2 * ks], w0[2 * ks + 1], w1[2 * ks + 1],
               bw[(ks * 4 + j) * 2], bw[(ks * 4 + j) * 2 + 1]);
  }
  // c[j][0..1]: row g, L's bits 8 j + 2 q and 8 j + 2 q + 1; c[j][2..3]:
  // row g + 8; a row's 32 bits from the 4 lanes of its group
  uint32_t l0 = 0, l1 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int at = 8 * j + 2 * q;
    l0 |= (uint32_t)(c[j][0] & 1) << at | (uint32_t)(c[j][1] & 1) << (at + 1);
    l1 |= (uint32_t)(c[j][2] & 1) << at | (uint32_t)(c[j][3] & 1) << (at + 1);
  }
  l0 |= __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 |= __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 |= __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 |= __shfl_xor_sync(0xffffffffu, l1, 2);
  if (q == 0) {
    part[warp][g] = l0;
    part[warp][g + 8] = l1;
  }
  __syncthreads();
  const int r = blockIdx.y * kRows + threadIdx.x;
  if (threadIdx.x < kRows && r < rows) {
    uint32_t l = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l ^= part[w][threadIdx.x];
    l = l ? multmodp(l, tails[nb - 1 - b]) : 0u;
    if (b == 0) l ^= zero_crc;
    if (l) atomicXor(out + r, (unsigned long long)l);
  }
}

}  // namespace

extern "C" int qz_crc32_rows(const void* data, void* out, const void* frag,
                             const void* tails, int rows, int n, int zero_crc,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)rows * 8, st);
  if (e != cudaSuccess) {
    cudaGetLastError();  // leave no error behind
    return (int)e;
  }
  if (rows == 0 || n == 0) return 0;  // crc32 of nothing is 0
  const bool vec = ((uintptr_t)data % 16 == 0) && (n % 16 == 0);
  const dim3 grid((n + kBlock - 1) / kBlock, (rows + kRows - 1) / kRows);
  return qz::launch(vec ? crc_kernel<true> : crc_kernel<false>, grid,
                    kWarps * 32, 0, stream, (const uint8_t*)data,
                    (unsigned long long*)out, (const uint4*)frag,
                    (const uint32_t*)tails, rows, n, (uint32_t)zero_crc);
}
