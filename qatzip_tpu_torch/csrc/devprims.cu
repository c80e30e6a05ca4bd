// The primitive probes of qatzip_tpu_torch/tools/devprims.py: gathers,
// lane rolls and a 128-lane bitonic sort of 32-bit words.
//
// Replace the Pallas kernels of tools/devprims.py, which timed the TPU
// primitives behind the sort-based Pallas design:
//   lane_gather     pl_gather.go (axis 1), :124 -> :125: out[r, c] =
//                   x[r, idx[r, c]] on (R, 128) and (8192, 1024) planes;
//   sublane_gather  pl_gather.go (axis 0): out[r, c] = x[idx[r, c], c] on
//                   (512, 128);
//   roll_sum        roll_static :158 -> :159 and roll_dyn :178 -> :179:
//                   x + sum over k of roll(x, k, 1) on (4096, 128), with
//                   roll(x, k, 1)[c] = x[(c - k) mod 128] as jnp.roll;
//   bitonic128      bitonic :222 -> :223 (and the spot check at :247): the
//                   28-stage network of bitonic_kern (:196-219) on each
//                   128-lane row, keys compared as uint32, one payload.
//
// On the TPU these were the costs to measure: a lane gather
// (tpu.dynamic_gather), a sublane gather, a lane roll with a static or a
// run-time shift. On Hopper the counterparts are a gather from shared
// memory (bank conflicts of random indices), a gather from L2, and warp
// shuffles. Every kernel here is bound by device memory: each word in and
// out once (lane gathers 12 bytes a position, rolls 8, the bitonic sort
// 16), and the probes' planes are small, so the rolls and the sublane
// gather are bound by the launch.
//
// Design, simple first:
//   lane_gather    one CTA per tile of rows (32 KB of shared memory: 64
//                  rows at width 128, 8 at width 1024), staged with
//                  coalesced loads; idx read and out written coalesced,
//                  smem[idx] read with whatever bank conflicts idx gives;
//   sublane_gather one thread per position, the row read from global
//                  memory: the (512, 128) plane is 256 KB, more than a
//                  CTA's 227 KB of shared memory, and sits in L2;
//   roll_sum       one warp per row, 4 words a thread (column 32 s + lane
//                  in slot s). The static variant's shifts (1, 2, 4, ...,
//                  64) are compile-time constants: a shift k = 32 a + b
//                  reads lane (lane - b) mod 32 of every slot with one
//                  __shfl_sync each, and a thread takes slot (s - a) mod
//                  4, or (s - a - 1) mod 4 where lane < b, picks that the
//                  compiler resolves. The dynamic variant reads its shifts
//                  (mod 128) from a device tensor into shared memory and
//                  stages each warp's row twice over in 256 words of
//                  shared memory (1 KB a warp), so that roll k of column c
//                  is word 128 + c - k with no wrap to work out: a shift
//                  costs a thread one subtraction, four shared loads at
//                  fixed offsets and four adds, no select, in a loop
//                  unrolled to the 32 shifts it may have. Lanes read
//                  consecutive words, which a rotation keeps in 32
//                  distinct banks. Shuffles with run-time picks, the first
//                  design of both, took twice the static variant's device
//                  time with run-time shifts; the staged rows, tried for
//                  the static variant too, made it slower than its
//                  shuffles;
//   bitonic128     8 threads a row (4 rows a warp, 32 a CTA), 16
//                  consecutive columns a thread (column 16 t + r in
//                  register r of thread t), loaded and stored as 16-byte
//                  vectors. The 22 stages with j <= 8 pair two registers of
//                  one thread, and each pair is compared once, by its
//                  owner; only the 6 stages with j = 16, 32, 64 pair a
//                  register with the same register of thread t ^ (j / 16)
//                  (__shfl_xor_sync inside the row's 8 lanes: 192 a thread,
//                  1,536 a row). Keys are complemented in each stage size's
//                  descending blocks, so every compare-exchange runs
//                  ascending (a min, a max and the payload's select on
//                  min != key) with no run-time direction; a strict compare
//                  in the complemented domain is the strict compare of the
//                  other direction, so equal keys never swap, as in the TPU
//                  kernel. The first design (one warp a row, 4 columns a
//                  thread, 25 of the 28 stages shuffled, both partners of a
//                  pair comparing with a direction worked out from their
//                  column) took 0.147 ms of device time at (65536, 128),
//                  27 % of its 0.040 ms memory bound, bound by instruction
//                  issue (~1,300 instructions and 200 shuffles a thread, by
//                  a count of the source). This one issues about a quarter
//                  of the instructions a row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 128;          // the roll and sort rows
constexpr int kGatherWords = 8192;   // 32 KB of staged rows a CTA
constexpr int kMaxShifts = 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const uint32_t* __restrict__ x,
                   const int32_t* __restrict__ idx, uint32_t* __restrict__ out,
                   int rows, int log_c, int rows_per_cta) {
  extern __shared__ uint32_t tile[];
  const int r0 = blockIdx.x * rows_per_cta;
  const int count = min(rows_per_cta, rows - r0) << log_c;
  const size_t base = (size_t)r0 << log_c;
  const int cmask = (1 << log_c) - 1;
  for (int i = threadIdx.x; i < count; i += kThreads) tile[i] = x[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int row_off = i & ~cmask;
    out[base + i] = tile[row_off | (idx[base + i] & cmask)];
  }
}

__global__ void __launch_bounds__(kThreads)
sublane_gather_kernel(const uint32_t* __restrict__ x,
                      const int32_t* __restrict__ idx,
                      uint32_t* __restrict__ out, int log_r, int log_c) {
  const size_t total = (size_t)1 << (log_r + log_c);
  const uint32_t rmask = (1u << log_r) - 1, cmask = (1u << log_c) - 1;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const uint32_t r = (uint32_t)idx[i] & rmask;
    out[i] = __ldg(x + ((size_t)r << log_c) + (i & cmask));
  }
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&t)[4], int j) {
  return j == 0 ? t[0] : j == 1 ? t[1] : j == 2 ? t[2] : t[3];
}

// acc[s] += roll(x, k, 1) at column 32 s + lane, for the row in v; with k
// a compile-time constant the slot picks resolve at compile time.
__device__ __forceinline__ void add_roll(const uint32_t (&v)[4],
                                         uint32_t (&acc)[4], int k,
                                         int lane) {
  const int a = k >> 5, b = k & 31;
  const int src = (lane - b) & 31;
  uint32_t t[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = __shfl_sync(kFull, v[j], src);
  const bool wrap = lane < b;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    acc[s] += pick4(t, wrap ? (s - a - 1) & 3 : (s - a) & 3);
}

template <bool kStatic>
__global__ void __launch_bounds__(kThreads)
roll_sum_kernel(const uint32_t* __restrict__ x,
                const int32_t* __restrict__ shifts, int nshift,
                uint32_t* __restrict__ out, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const size_t base = (size_t)row * kWidth;
  uint32_t acc[4];
  if constexpr (kStatic) {
    if (row >= rows) return;  // a whole warp: one row per warp
    uint32_t v[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[s] = v[s] = x[base + 32 * s + lane];
#pragma unroll
    for (int i = 0; i < 7; ++i) add_roll(v, acc, 1 << i, lane);
  } else {
    __shared__ uint32_t stage[kWarps][2 * kWidth];  // each row twice over
    __shared__ int sh[kMaxShifts];
    if (threadIdx.x < nshift)
      sh[threadIdx.x] = shifts[threadIdx.x] & (kWidth - 1);
    const bool live = row < rows;
    uint32_t* r = stage[threadIdx.x >> 5];
    if (live) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        acc[s] = x[base + 32 * s + lane];
        r[32 * s + lane] = r[kWidth + 32 * s + lane] = acc[s];
      }
    }
    __syncthreads();  // the shifts and the staged rows
    if (!live) return;
    // roll(x, k, 1) at column 32 s + lane is word 128 + 32 s + lane - k
#pragma unroll
    for (int i = 0; i < kMaxShifts; ++i) {
      if (i >= nshift) break;
      const uint32_t* src = r + kWidth + lane - sh[i];
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[s] += src[32 * s];
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) out[base + 32 * s + lane] = acc[s];
}

// The bitonic network of bitonic128 on 8 threads a row, 16 consecutive
// columns a thread: column c = 16 t + r lies in register r of the row's
// thread t (lane & 7; a warp holds 4 rows).
constexpr int kSortThreads = 256;
constexpr int kRowThreads = 8;
constexpr int kCols = kWidth / kRowThreads;            // 16
constexpr int kSortRows = kSortThreads / kRowThreads;  // 32 rows a CTA

// All ones where column c lies in a descending block of stage size s.
__device__ __forceinline__ uint32_t desc(int c, int s) {
  return (c & s) ? kFull : 0u;
}

// One compare-exchange in the ascending (flipped) domain: a, the lower
// column, keeps the smaller key; equal keys never swap.
__device__ __forceinline__ void exchange(uint32_t& ka, uint32_t& kb,
                                         uint32_t& va, uint32_t& vb) {
  const uint32_t lo = min(ka, kb);
  const bool swap = lo != ka;  // kb < ka
  kb = max(ka, kb);
  ka = lo;
  const uint32_t t = swap ? vb : va;
  vb = swap ? va : vb;
  va = t;
}

template <bool kVec>
__device__ __forceinline__ void load16(const uint32_t* p,
                                       uint32_t (&x)[kCols]) {
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      x[4 * i] = q.x; x[4 * i + 1] = q.y; x[4 * i + 2] = q.z;
      x[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) x[i] = p[i];
  }
}

template <bool kVec>
__device__ __forceinline__ void store16(uint32_t* p,
                                        const uint32_t (&x)[kCols]) {
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) p[i] = x[i];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kSortThreads)
bitonic128_kernel(const uint32_t* __restrict__ keys,
                  const uint32_t* __restrict__ vals,
                  uint32_t* __restrict__ kout, uint32_t* __restrict__ vout,
                  int rows) {
  const int t = threadIdx.x & (kRowThreads - 1);
  const int row = blockIdx.x * kSortRows + threadIdx.x / kRowThreads;
  const bool live = row < rows;  // past the end: zeros, still shuffled
  const size_t base = (size_t)row * kWidth + t * kCols;
  uint32_t k[kCols], v[kCols];
#pragma unroll
  for (int r = 0; r < kCols; ++r) k[r] = v[r] = 0u;
  if (live) {
    load16<kVec>(keys + base, k);
    load16<kVec>(vals + base, v);
  }
  // keys in stage size s's domain: complemented in its descending blocks,
  // where every compare-exchange then runs ascending
#pragma unroll
  for (int r = 0; r < kCols; ++r) k[r] ^= desc(kCols * t + r, 2);
#pragma unroll
  for (int s = 2; s <= kWidth; s <<= 1) {
    if (s > 2) {
#pragma unroll
      for (int r = 0; r < kCols; ++r)
        k[r] ^= desc(kCols * t + r, s >> 1) ^ desc(kCols * t + r, s);
    }
#pragma unroll
    for (int j = s >> 1; j >= 1; j >>= 1) {
      if (j >= kCols) {
        // the partner column is the same register of thread t ^ (j / 16)
        const int m = j / kCols;
        const bool lower = (t & m) == 0;
#pragma unroll
        for (int r = 0; r < kCols; ++r) {
          const uint32_t pk = __shfl_xor_sync(kFull, k[r], m);
          const uint32_t pv = __shfl_xor_sync(kFull, v[r], m);
          const uint32_t nk = lower ? min(k[r], pk) : max(k[r], pk);
          if (nk != k[r]) v[r] = pv;  // a strict compare took the partner
          k[r] = nk;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kCols; ++r)
          if ((r & j) == 0) exchange(k[r], k[r | j], v[r], v[r | j]);
      }
    }
  }
  // stage size 128 has no descending block: the keys are plain again
  if (live) {
    store16<kVec>(kout + base, k);
    store16<kVec>(vout + base, v);
  }
}

int warp_row_blocks(int rows) { return (rows + kWarps - 1) / kWarps; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" int qz_lane_gather(const void* x, const void* idx, void* out,
                              int rows, int log_c, void* stream) {
  const int per_cta = kGatherWords >> log_c;
  const int blocks = (rows + per_cta - 1) / per_cta;
  return qz::launch(lane_gather_kernel, blocks, kThreads,
                    kGatherWords * sizeof(uint32_t), stream,
                    (const uint32_t*)x, (const int32_t*)idx, (uint32_t*)out,
                    rows, log_c, per_cta);
}

extern "C" int qz_sublane_gather(const void* x, const void* idx, void* out,
                                 int log_r, int log_c, void* stream) {
  const size_t total = (size_t)1 << (log_r + log_c);
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  return qz::launch(sublane_gather_kernel, blocks, kThreads, 0, stream,
                    (const uint32_t*)x, (const int32_t*)idx, (uint32_t*)out,
                    log_r, log_c);
}

// shifts == nullptr: the static shifts 1, 2, 4, ..., 64.
extern "C" int qz_roll_sum(const void* x, const void* shifts, int nshift,
                           void* out, int rows, void* stream) {
  if (nshift > kMaxShifts) return (int)cudaErrorInvalidValue;
  return qz::launch(shifts == nullptr ? roll_sum_kernel<true>
                                       : roll_sum_kernel<false>,
                    warp_row_blocks(rows), kThreads, 0, stream,
                    (const uint32_t*)x, (const int32_t*)shifts, nshift,
                    (uint32_t*)out, rows);
}

extern "C" int qz_bitonic128(const void* keys, const void* vals, void* kout,
                             void* vout, int rows, void* stream) {
  const int blocks = (rows + kSortRows - 1) / kSortRows;
  const bool vec = aligned16(keys) && aligned16(vals) && aligned16(kout) &&
                   aligned16(vout);
  return qz::launch(vec ? bitonic128_kernel<true> : bitonic128_kernel<false>,
                    blocks, kSortThreads, 0, stream, (const uint32_t*)keys,
                    (const uint32_t*)vals, (uint32_t*)kout, (uint32_t*)vout,
                    rows);
}
