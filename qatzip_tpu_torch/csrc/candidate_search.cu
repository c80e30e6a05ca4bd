// Fused LZ77 candidate search over window rows: sort, probe, unsort.
//
// Replaces the TPU kernel k2, qatzip_tpu/ops/pallas_pack.py
// candidate_search / _candsearch_kernel, bit for bit.
//
// One CTA of 512 threads per window of W <= 8192 positions (a power of
// two), two CTAs per SM:
//   1. each key (hash << pbits) | relpos goes to shared memory at its
//      relpos (the relpos of a row are a permutation of 0..W-1), so the
//      keys stand in relpos order, and a stable LSD radix sort on the
//      hash bits that vary inside the window (none for a window in one
//      bucket; 19 bits in 3 passes of up to 7 on the main path) orders
//      them as a full uint32 sort would: keys are unique, and within a
//      bucket stability keeps relpos order. A pass ranks each warp's
//      digits with one ballot per digit bit against per-warp counts
//      (padded, so the lanes of a warp hit distinct banks), scans the
//      (digit, warp) counts across the CTA and scatters, with four
//      barriers;
//   2. the sorted order is kept as 16-bit relpos with bit 15 set where a
//      hash bucket starts, and the context planes are copied with
//      cp.async, 16 bytes a thread, into the space the sort used;
//   3. one thread per sorted index (consecutive threads on consecutive
//      indices) probes its `probes` nearest predecessors back to its
//      bucket's start: ml is the byte-prefix match over the context
//      words, read from shared memory at both positions (partial bytes
//      counted on every word, word 0 included), a candidate needs
//      dist >= 1 and ml >= min_match, the longest match wins and the
//      nearest wins ties;
//   4. each result (relpos << 18) | (ml << 13) | (dist - 1), 0 in ml and
//      dist where nothing matched, goes to shared memory at relpos (a
//      permutation, which replaces the TPU kernel's second sort), and
//      the window is stored coalesced.
//
// Bounds on the H100: the function moves 16 bytes in and 4 out per
// position at ctx 3, 0.11 ms over device memory for a 16 MB tile (2304
// windows). The first version sorted with a bitonic network of 91
// shared-memory stages, a barrier each, gathered the context and
// scattered its output through device memory (~1.3 ms). With the
// network's strides below 256 in registers and warp shuffles it took
// 0.67 ms, half of it sorting. The radix passes and the probes are
// bound by instructions and barriers, and one CTA's copies would sit
// idle beside them; so a window fits in 112 KB of shared memory at
// ctx 3 (the context after the sort, in the sort's space, and the
// sorted order in 16 bits), and two CTAs share an SM, one copying
// while the other computes. The registers allow 1024 threads per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kPer = 16;         // keys per thread
constexpr int kDigitBits = 7;    // radix digit
constexpr int kDigits = 1 << kDigitBits;
constexpr int kCntStride = kDigits + 1;   // a warp's counts, padded

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool vec) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// words of shared memory region 0: the sort, or the context planes
__host__ __device__ inline int region0_words(int w, int ctx_words, int nw) {
  const int sort = 2 * round4(w) + kCntStride * nw;
  return round4(sort > ctx_words * w ? sort : ctx_words * w);
}

// VEC: w >= 8 and ctx, out 16-byte aligned; CTX: context words
template <bool VEC, int CTX>
__global__ void __launch_bounds__(512, 2)
candsearch_kernel(const uint32_t* __restrict__ key,
                  const uint32_t* __restrict__ ctx,
                  uint32_t* __restrict__ out, int rows, int w, int pbits,
                  int probes, int min_match) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t wsum[32];
  __shared__ uint32_t hash_or, hash_and;
  const int nt = blockDim.x;          // max(32, w / kPer)
  const int nw = nt >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // region 0: the sort (two key buffers and the counts), then the
  // context planes in window order, then the results; region 1: the
  // sorted relpos, bit 15 set where a bucket starts
  uint32_t* src = smem;
  uint32_t* dst = smem + round4(w);
  uint32_t* cnt = smem + 2 * round4(w);             // [warp][digit]
  uint32_t* cx = smem;
  uint16_t* sorted =
      reinterpret_cast<uint16_t*>(smem + region0_words(w, CTX, nw));
  const size_t base = (size_t)blockIdx.x * w;
  const size_t plane = (size_t)rows * w;
  const uint32_t pmask = (1u << pbits) - 1u;

  if (tid == 0) {
    hash_or = 0u;
    hash_and = ~0u;
  }
  __syncthreads();

  // -- 1. keys at their relpos; which hash bits vary --------------------------
  uint32_t h_or = 0u, h_and = ~0u;
  for (int i = tid; i < w; i += nt) {
    const uint32_t k = key[base + i];
    src[k & pmask] = k;
    h_or |= k >> pbits;
    h_and &= k >> pbits;
  }
  h_or = __reduce_or_sync(0xFFFFFFFFu, h_or);
  h_and = __reduce_and_sync(0xFFFFFFFFu, h_and);
  if (lane == 0) {
    atomicOr(&hash_or, h_or);
    atomicAnd(&hash_and, h_and);
  }
  __syncthreads();
  const uint32_t vary = hash_or & ~hash_and;

  // -- 2. stable LSD passes over the varying bits [lo, hi) of the hash --------
  if (vary) {
    const int lo = __ffs(vary) - 1, hi = 32 - __clz(vary);
    const int passes = (hi - lo + kDigitBits - 1) / kDigitBits;
    const int bw = (hi - lo + passes - 1) / passes;
    const uint32_t dmask = (1u << bw) - 1u;
    uint32_t* wcnt = cnt + warp * kCntStride;
    for (int ps = 0; ps < passes; ++ps) {
      const int sh = pbits + lo + ps * bw;
      for (int d = lane; d < kDigits; d += 32) wcnt[d] = 0u;
      __syncwarp();
      // rank within the warp, in element order e = warp * 32 * kPer +
      // r * 32 + lane
      uint32_t rk[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int e = warp * (32 * kPer) + r * 32 + lane;
        const bool valid = e < w;
        const uint32_t dg = valid ? (src[e] >> sh) & dmask : 0u;
        // the lanes with this lane's digit: one ballot per digit bit
        // (cheaper here than __match_any_sync)
        const uint32_t vmask = __ballot_sync(0xFFFFFFFFu, valid);
        uint32_t peers = valid ? vmask : ~vmask;
        for (int b = 0; b < bw; ++b) {
          const bool bit = (dg >> b) & 1u;
          const uint32_t bal = __ballot_sync(0xFFFFFFFFu, bit);
          peers &= bit ? bal : ~bal;
        }
        const uint32_t below = peers & ((1u << lane) - 1u);
        const uint32_t c = valid ? wcnt[dg] : 0u;
        __syncwarp();
        if (valid && below == 0u) wcnt[dg] = c + __popc(peers);
        __syncwarp();
        rk[r] = c + __popc(below);
      }
      __syncthreads();
      // exclusive scan of the counts in (digit, warp) order: entries
      // 4 * tid .. 4 * tid + 3, entry s at cnt[(s % nw) * kCntStride + s / nw]
      {
        uint32_t* slot[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tid * 4 + j;
          slot[j] = cnt + (s % nw) * kCntStride + s / nw;
        }
        const uint32_t v0 = *slot[0], v1 = *slot[1], v2 = *slot[2],
                       v3 = *slot[3];
        const uint32_t s = v0 + v1 + v2 + v3;
        uint32_t incl = s;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
          if (lane >= o) incl += t;
        }
        if (lane == 31) wsum[warp] = incl;
        __syncthreads();
        // every warp scans the warp totals itself: no second barrier
        const uint32_t x = lane < nw ? wsum[lane] : 0u;
        uint32_t y = x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, y, o);
          if (lane >= o) y += t;
        }
        uint32_t run = __shfl_sync(0xFFFFFFFFu, y - x, warp) + incl - s;
        *slot[0] = run;
        run += v0;
        *slot[1] = run;
        run += v1;
        *slot[2] = run;
        *slot[3] = run + v2;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int e = warp * (32 * kPer) + r * 32 + lane;
        if (e < w) {
          const uint32_t k = src[e];
          dst[wcnt[(k >> sh) & dmask] + rk[r]] = k;
        }
      }
      __syncthreads();
      uint32_t* t = src;
      src = dst;
      dst = t;
    }
  }

  // -- 3. sorted relpos with bucket starts; then the context planes ----------
  for (int i = tid; i < w; i += nt) {
    const uint32_t k = src[i];
    const bool start = i == 0 || ((src[i - 1] ^ k) >> pbits) != 0u;
    sorted[i] = (uint16_t)((k & pmask) | (start ? 0x8000u : 0u));
  }
  __syncthreads();
  {
    const int step = VEC ? 4 : 1;
    const int per_plane = w / step;
    for (int q = tid; q < CTX * per_plane; q += nt) {
      const int c = q / per_plane, i = (q - c * per_plane) * step;
      cp_async(cx + c * w + i, ctx + c * plane + base + i, VEC);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // -- 4. probes, sorted index i = tid + m * nt -------------------------------
  uint32_t res[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = tid + m * nt;
    res[m] = 0xFFFFFFFFu;               // no position (padding)
    if (i >= w) continue;
    uint32_t e = sorted[i];
    const int pos = (int)(e & 0x7FFFu);
    uint32_t own[CTX];
#pragma unroll
    for (int c = 0; c < CTX; ++c) own[c] = cx[c * w + pos];
    int best_ml = 0, best_d1 = 0;
    const int lim = min(probes, i);
    // the bucket is a run of the sorted order: probe back until its start
    for (int d = 1; d <= lim && !(e & 0x8000u); ++d) {
      e = sorted[i - d];
      const int ppos = (int)(e & 0x7FFFu);
      int ml = 0;
#pragma unroll
      for (int c = 0; c < CTX; ++c) {
        const uint32_t x = own[c] ^ cx[c * w + ppos];
        if (x) {  // the equal low bytes of the first word that differs
          ml += (__ffs(x) - 1) >> 3;
          break;
        }
        ml += 4;
      }
      const int dist = pos - ppos;
      if (dist >= 1 && ml >= min_match && ml > best_ml) {
        best_ml = ml;
        best_d1 = dist - 1;
      }
    }
    res[m] = ((uint32_t)pos << 18) | ((uint32_t)best_ml << 13) |
             (uint32_t)best_d1;
  }
  __syncthreads();                      // every probe has read cx

  // -- 5. results in window order, stored coalesced ---------------------------
  uint32_t* ob = smem;
#pragma unroll
  for (int m = 0; m < kPer; ++m)
    if (res[m] != 0xFFFFFFFFu) ob[res[m] >> 18] = res[m];
  __syncthreads();
  if (VEC) {
    for (int i = tid * 4; i < w; i += nt * 4)
      *reinterpret_cast<uint4*>(out + base + i) =
          *reinterpret_cast<const uint4*>(ob + i);
  } else {
    for (int i = tid; i < w; i += nt) out[base + i] = ob[i];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <bool VEC, int CTX>
int launch(const void* key, const void* ctx, void* out, int rows, int w,
           int pbits, int probes, int min_match, cudaStream_t stream) {
  const int threads = w / kPer > 32 ? w / kPer : 32;
  const size_t words = (size_t)region0_words(w, CTX, threads / 32) +
                       (size_t)(w + 1) / 2;
  const size_t smem = words * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      candsearch_kernel<VEC, CTX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(candsearch_kernel<VEC, CTX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  return qz::launch(candsearch_kernel<VEC, CTX>, rows, threads, smem, stream,
                    (const uint32_t*)key, (const uint32_t*)ctx,
                    (uint32_t*)out, rows, w, pbits, probes, min_match);
}

template <bool VEC>
int launch_ctx(const void* key, const void* ctx, void* out, int rows, int w,
               int pbits, int ctx_words, int probes, int min_match,
               cudaStream_t s) {
  switch (ctx_words) {
    case 1:
      return launch<VEC, 1>(key, ctx, out, rows, w, pbits, probes,
                            min_match, s);
    case 2:
      return launch<VEC, 2>(key, ctx, out, rows, w, pbits, probes,
                            min_match, s);
    case 3:
      return launch<VEC, 3>(key, ctx, out, rows, w, pbits, probes,
                            min_match, s);
    default:
      return launch<VEC, 4>(key, ctx, out, rows, w, pbits, probes,
                            min_match, s);
  }
}

}  // namespace

extern "C" int qz_candidate_search(const void* key, const void* ctx,
                                   void* out, int rows, int w, int pbits,
                                   int ctx_words, int probes, int min_match,
                                   void* stream) {
  if (w < 2 || w > 8192 || (w & (w - 1)) || ctx_words < 1 || ctx_words > 4 ||
      pbits < 1 || pbits > 13 || (w - 1) >> pbits)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (w >= 8 && aligned16(ctx) && aligned16(out))
    return launch_ctx<true>(key, ctx, out, rows, w, pbits, ctx_words, probes,
                            min_match, s);
  return launch_ctx<false>(key, ctx, out, rows, w, pbits, ctx_words, probes,
                           min_match, s);
}

extern "C" const char* qz_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
