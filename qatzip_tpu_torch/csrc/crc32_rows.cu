// CRC32 of every row of a (B, n) byte tile, for the device CRC.
//
// Replaces qatzip_tpu/ops/crc32_mxu.py crc32_batch_device, which the JAX
// package ran as one XLA dot: the rows' bits, (B, 8n) in bf16, times the
// (8n, 32) GF(2) matrix V, then parity, packing and ^ crc(0^n). That
// formulation blows every byte up to 8 bf16 values (256 MiB for a tile of
// 256 x 64 KiB) to use the TPU's matrix unit. On the H100 this kernel
// reads each byte once and uses no matrix product.
//
// crc(M) = L(M) ^ crc(0^n), where L is the linear part: the register
// update from 0 with no final xor. L is linear and leading zero bytes do
// not change it, so a row is taken as zero-padded at its front to whole
// blocks of kBlock bytes, and
//   * each thread takes L of one kSeg-byte segment, slicing by 8 with
//     eight 256-entry tables in shared memory (built by the CTA);
//   * the CTA folds the segments of a block in a log-depth tree:
//     L(A || B) = L(A) * x^(8|B|) ^ L(B) mod P (zlib's crc32_combine),
//     the shifts x^(8 kSeg 2^k) mod P are constants, five levels by warp
//     shuffles and three across the warps;
//   * thread 0 folds the blocks in order (Horner, x^(8 kBlock)) and XORs
//     in crc(0^n), which the caller passes.
// One CTA a row; the output is the uint32 crc in an int32.
//
// Bounds on the H100 at (256, 65536): 16 MiB read, 0.005 ms at 3.35 TB/s.
// The table lookups (one a byte, from shared memory) and the tree's
// carry-less products are the kernel's own work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;  // reflected CRC-32
constexpr int kThreads = 256;
constexpr int kSeg = 256;                   // bytes a thread
constexpr int kBlock = kThreads * kSeg;     // 64 KiB a block
constexpr int kLevels = 8;                  // log2(kThreads)
constexpr int kLoads = kSeg / 16 / 2;       // 16-byte loads a half segment

// x^(8 kSeg 2^k) mod P for each tree level k, and x^(8 kBlock) mod P
struct Shifts {
  uint32_t level[kLevels];
  uint32_t block;
};

// a * b mod P in zlib's reflected representation (bit 31 is x^0)
__host__ __device__ __forceinline__ uint32_t multmodp(uint32_t a,
                                                      uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

__device__ __forceinline__ uint32_t step8(uint32_t (*t)[256],
                                          uint32_t crc, uint32_t lo,
                                          uint32_t hi) {
  lo ^= crc;
  return t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
         t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
         t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
}

__global__ void __launch_bounds__(kThreads)
crc_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
           int n, uint32_t zero_crc, Shifts sh, int vec) {
  __shared__ uint32_t tab[8][256];
  __shared__ uint32_t warp_v[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t c = tid;
#pragma unroll
  for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
  tab[0][tid] = c;
  __syncthreads();
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    c = (c >> 8) ^ tab[0][c & 0xFF];
    tab[k][tid] = c;
  }
  __syncthreads();

  const uint8_t* row = data + (size_t)blockIdx.x * n;
  const int nb = (n + kBlock - 1) / kBlock;
  const long long pad = (long long)nb * kBlock - n;
  uint32_t total = 0;
  for (int b = 0; b < nb; ++b) {
    // this thread's segment, counted from the block's end; its first
    // byte's row index (below 0: the front padding, zeros)
    const long long start =
        (long long)(b + 1) * kBlock - (long long)(tid + 1) * kSeg - pad;
    uint32_t crc = 0;
    if (start + kSeg <= 0) {
      // a segment of front padding only: L = 0 (rows under 64 KiB)
    } else if (vec) {
      // n % 16 == 0 and a 16-byte aligned tile: every load is whole,
      // and wholly padding or wholly row
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint4 w[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const long long p = start + (half * kLoads + u) * 16;
          w[u] = p >= 0 ? __ldg(reinterpret_cast<const uint4*>(row + p))
                        : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          crc = step8(tab, crc, w[u].x, w[u].y);
          crc = step8(tab, crc, w[u].z, w[u].w);
        }
      }
    } else {
      for (int o = 0; o < kSeg; o += 8) {
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long p = start + o + u;
          if (p >= 0) lo |= (uint32_t)row[p] << (8 * u);
          if (p + 4 >= 0) hi |= (uint32_t)row[p + 4] << (8 * u);
        }
        crc = step8(tab, crc, lo, hi);
      }
    }
    // fold the block's segments: at level k, thread t (a multiple of
    // 2^(k+1)) takes in thread t + 2^k's value, 2^k segments further
    // from the end; the other lanes' values are not read again
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const uint32_t other = __shfl_down_sync(0xffffffffu, crc, 1 << k);
      crc ^= multmodp(other, sh.level[k]);
    }
    if (lane == 0) warp_v[tid >> 5] = crc;
    __syncthreads();
    if (tid < 32) {
      uint32_t v = lane < kThreads / 32 ? warp_v[lane] : 0u;
#pragma unroll
      for (int k = 5; k < kLevels; ++k) {
        const uint32_t other = __shfl_down_sync(0xffffffffu, v, 1 << (k - 5));
        v ^= multmodp(other, sh.level[k]);
      }
      if (tid == 0) total = multmodp(total, sh.block) ^ v;
    }
    __syncthreads();   // warp_v is written again for the next block
  }
  if (tid == 0) out[blockIdx.x] = total ^ zero_crc;
}

Shifts make_shifts() {
  // x^(2^j) mod P by squaring, from x^1
  uint32_t x2n[20];
  x2n[0] = 0x40000000u;
  for (int j = 1; j < 20; ++j) x2n[j] = multmodp(x2n[j - 1], x2n[j - 1]);
  static_assert(kSeg == 1 << 8 && kBlock == 1 << 16, "shift exponents");
  Shifts s;
  for (int k = 0; k < kLevels; ++k) s.level[k] = x2n[11 + k];  // 8 kSeg 2^k
  s.block = x2n[19];                                          // 8 kBlock
  return s;
}

}  // namespace

extern "C" int qz_crc32_rows(const void* data, void* out, int rows, int n,
                             int zero_crc, void* stream) {
  static const Shifts shifts = make_shifts();
  const int vec = ((uintptr_t)data % 16 == 0) && (n % 16 == 0);
  return qz::launch(crc_kernel, rows, kThreads, 0, stream,
                    (const uint8_t*)data, (uint32_t*)out, n,
                    (uint32_t)zero_crc, shifts, vec);
}
