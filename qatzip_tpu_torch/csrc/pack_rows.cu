// Row bit-packer of the full-device DEFLATE pack, static and dynamic
// Huffman: every position's emission, the exclusive bit offsets and the
// placement of each emission in its row's words, in one kernel.
//
// Replaces the TPU kernel k1 (qatzip_tpu/ops/pallas_pack.py:342,
// assemble_windows / _assemble_kernel) together with the stages that fed
// it on the TPU, qatzip_tpu/ops/deflate_pack.py:259-334 (the emission
// planes, the cumsum offsets and the 256-position group pack; the
// dynamic pass 2 does the same at :509-539). Bit for bit what the plain
// version pack_rows_ref (qatzip_tpu_torch/ops/deflate_pack.py) computes:
//
//   static:  a taken match emits its length code and extra bits, then its
//            distance code and extra bits (at most 31 bits); a literal its
//            8- or 9-bit code; every code bit-reversed (RFC 1951 3.2.6);
//   dynamic: a taken match emits its length part (table entry lpack: code
//            | len << 12, then the extra bits) at p and its distance part
//            (dpack, then the extra bits) at p + 1; a literal its lpack
//            code. `taken` at p wins over the distance part of p - 1,
//            which wins over `lit` at p;
//
// each emission ORed into the row at its exclusive bit offset from the
// row's base bit (low part at word off >> 5, the rest in the next word),
// words at or past max_words dropped; end[row] = base + all the bits.
//
// The TPU could not scatter into VMEM, so it built int64-wide emission
// planes, took a cumsum, ORed every 256-position group into a window of
// a fixed worst-case width with a loop of compares, and had k1 place the
// windows. On the H100 one CTA holds a whole row's words in shared
// memory (73.7 KB static, 98.8 KB dynamic at n = 65536; two CTAs per
// SM, so a tile of 256 rows runs in one wave on 132 SMs), so nothing but
// the parse planes and the final words touches device memory:
//
//   * 512 threads walk the row in steps of 2048 positions, 4 a thread,
//     so each int32 plane loads as one 16-byte vector and each byte plane
//     as one 4-byte word; the next step's loads are issued before this
//     step's emissions, so they are in flight across its barrier;
//   * a thread forms its 4 emissions in 32-bit registers (lane 0 reads
//     the distance part of position p0 - 1 itself, the other lanes take
//     it from the lane below by shuffle), then the step's exclusive bit
//     offsets from a warp scan and the per-warp totals in shared memory
//     (one barrier a step, the totals double-buffered), plus the carry of
//     the row so far;
//   * a thread's emissions are contiguous in the row: it assembles them
//     in a 64-bit register and stores each word it fills alone with a
//     plain store, and ORs (atomicOr) only its first and its last word,
//     which it may share with its neighbours;
//   * the finished row goes out 16 bytes a thread: the image sits 0-3
//     words into shared memory so that shared and device words agree
//     modulo 4.
//
// Bounds on the H100: device memory. A tile of 256 x 64 KiB rows reads
// each plane once, 11 bytes a position static (data, ml, dist, taken,
// lit) and 18 dynamic (ml, dist, lpack, dpack, taken, lit), and writes
// 18,435 / 24,706 words a row: 203.4 / 327.3 MB, ~0.061 / ~0.098 ms at
// 3.35 TB/s. The arithmetic (some 40 32-bit operations a position, ~0.01
// ms a tile at the card's rate) and the shared-memory traffic (two
// atomics and a few stores per 4 positions) stay well under that.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kV = 4;                 // positions per thread per step
constexpr int kStep = kThreads * kV;  // positions per step
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Planes {
  const uint8_t* data;    // static
  const int32_t* ml;
  const int32_t* dist;
  const uint8_t* taken;
  const uint8_t* lit;
  const uint32_t* lpack;  // dynamic
  const uint32_t* dpack;  // dynamic
};

// One thread's kV positions of one step, as loaded.
struct Tile {
  int ml[kV], dist[kV];
  uint32_t lp[kV], dp[kV];          // dynamic table entries
  uint32_t bytes, taken, lit;       // one byte per position
  uint32_t prev_taken, prev_dist, prev_dp;  // dynamic, lane 0: p0 - 1
};

template <bool kDyn, bool kVec>
__device__ __forceinline__ void load(Tile& t, const Planes& in, size_t row,
                                     int p0, int n, int lane) {
  const size_t at = row * (size_t)n + p0;
  if (kVec) {
    // n % kV == 0: a thread's positions lie all inside the row or all past
    if (p0 < n) {
      const int4 m = *reinterpret_cast<const int4*>(in.ml + at);
      const int4 d = *reinterpret_cast<const int4*>(in.dist + at);
      t.ml[0] = m.x; t.ml[1] = m.y; t.ml[2] = m.z; t.ml[3] = m.w;
      t.dist[0] = d.x; t.dist[1] = d.y; t.dist[2] = d.z; t.dist[3] = d.w;
      t.taken = *reinterpret_cast<const uint32_t*>(in.taken + at);
      t.lit = *reinterpret_cast<const uint32_t*>(in.lit + at);
      if (kDyn) {
        const uint4 l = *reinterpret_cast<const uint4*>(in.lpack + at);
        const uint4 q = *reinterpret_cast<const uint4*>(in.dpack + at);
        t.lp[0] = l.x; t.lp[1] = l.y; t.lp[2] = l.z; t.lp[3] = l.w;
        t.dp[0] = q.x; t.dp[1] = q.y; t.dp[2] = q.z; t.dp[3] = q.w;
      } else {
        t.bytes = *reinterpret_cast<const uint32_t*>(in.data + at);
      }
    } else {
      t.taken = t.lit = t.bytes = 0u;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        t.ml[j] = t.dist[j] = 0;
        t.lp[j] = t.dp[j] = 0u;
      }
    }
  } else {
    t.taken = t.lit = t.bytes = 0u;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      t.ml[j] = t.dist[j] = 0;
      t.lp[j] = t.dp[j] = 0u;
      if (p0 + j < n) {
        t.ml[j] = in.ml[at + j];
        t.dist[j] = in.dist[at + j];
        t.taken |= (uint32_t)in.taken[at + j] << (8 * j);
        t.lit |= (uint32_t)in.lit[at + j] << (8 * j);
        if (kDyn) {
          t.lp[j] = in.lpack[at + j];
          t.dp[j] = in.dpack[at + j];
        } else {
          t.bytes |= (uint32_t)in.data[at + j] << (8 * j);
        }
      }
    }
  }
  if (kDyn) {
    t.prev_taken = t.prev_dist = t.prev_dp = 0u;
    if (lane == 0 && p0 > 0 && p0 < n) {
      t.prev_taken = in.taken[at - 1];
      t.prev_dist = (uint32_t)in.dist[at - 1];
      t.prev_dp = in.dpack[at - 1];
    }
  }
}

__device__ __forceinline__ uint32_t rev(uint32_t x, int nbits) {
  return __brev(x) >> (32 - nbits);
}

__device__ __forceinline__ int bitlen(uint32_t x) { return 32 - __clz(x); }

// Length symbol 257..285, its extra bit count and value (RFC 1951 3.2.5).
__device__ __forceinline__ void len_symbol(int ml, int& sym, int& ebits,
                                           uint32_t& extra) {
  const int lc = ml - 3;
  if (lc < 8) {
    sym = 257 + lc;
    ebits = 0;
  } else if (ml == 258) {
    sym = 285;
    ebits = 0;
  } else {
    ebits = bitlen(lc) - 3;
    sym = 257 + 4 * (ebits + 1) + ((lc >> ebits) & 3);
  }
  extra = (uint32_t)lc & ((1u << ebits) - 1u);
}

// Distance symbol 0..29, its extra bit count and value.
__device__ __forceinline__ void dist_symbol(int dist, int& sym, int& ebits,
                                            uint32_t& extra) {
  const int d1 = dist - 1;
  if (d1 < 4) {
    sym = d1;
    ebits = 0;
  } else {
    ebits = bitlen(d1) - 2;
    sym = 2 * (ebits + 1) + ((d1 >> ebits) & 1);
  }
  extra = (uint32_t)d1 & ((1u << ebits) - 1u);
}

__device__ __forceinline__ void static_match(int ml, int dist, uint32_t& v,
                                             int& nb) {
  int lsym, el, dsym, ed;
  uint32_t lx, dx;
  len_symbol(ml, lsym, el, lx);
  dist_symbol(dist, dsym, ed, dx);
  const bool short_code = lsym < 280;  // symbols 256-279: 7 bits, else 8
  int sh = short_code ? 7 : 8;
  v = short_code ? rev(lsym - 256, 7) : rev(0xC0 + lsym - 280, 8);
  v |= lx << sh;
  sh += el;
  v |= rev(dsym, 5) << sh;
  sh += 5;
  v |= dx << sh;
  nb = sh + ed;
}

__device__ __forceinline__ void static_lit(uint32_t b, uint32_t& v, int& nb) {
  if (b < 144) {
    v = rev(0x30 + b, 8);
    nb = 8;
  } else {
    v = rev(0x190 + b - 144, 9);
    nb = 9;
  }
}

// A code from its table entry (code | len << 12), then `extra` above it.
__device__ __forceinline__ void table_code(uint32_t pack, int ebits,
                                           uint32_t extra, uint32_t& v,
                                           int& nb) {
  const int clen = (int)(pack >> 12);
  v = (pack & 0xFFFu) | (extra << clen);
  nb = clen + ebits;
}

// The dynamic mode's emissions: the distance part of a match at p + 1.
__device__ __forceinline__ void dynamic_emissions(const Tile& t, int p0,
                                                  int n, int lane,
                                                  uint32_t* v, int* nb) {
  // the distance part of each taken match, emitted at the next position
  uint32_t dv[kV];
  int dn[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    dv[j] = 0u;
    dn[j] = 0;
    if ((t.taken >> (8 * j)) & 0xFFu) {
      int ds, ed;
      uint32_t dx;
      dist_symbol(t.dist[j], ds, ed, dx);
      table_code(t.dp[j], ed, dx, dv[j], dn[j]);
    }
  }
  // position p0 - 1 (its taken flag in bit 8 of the count) from the lane
  // below; lane 0 loaded it itself
  const int last_tk = ((t.taken >> (8 * (kV - 1))) & 0xFFu) ? 256 : 0;
  uint32_t pv = __shfl_up_sync(kFull, dv[kV - 1], 1);
  int pn = __shfl_up_sync(kFull, dn[kV - 1] | last_tk, 1);
  if (lane == 0) {
    pv = 0u;
    pn = 0;
    if (t.prev_taken) {
      int ds, ed;
      uint32_t dx;
      dist_symbol((int)t.prev_dist, ds, ed, dx);
      table_code(t.prev_dp, ed, dx, pv, pn);
      pn |= 256;
    }
  }
  bool prev_tk = (pn & 256) != 0;
  pn &= 255;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const bool tk = ((t.taken >> (8 * j)) & 0xFFu) != 0;
    v[j] = 0u;
    nb[j] = 0;
    if (p0 + j < n) {
      if (tk) {
        int ls, el;
        uint32_t lx;
        len_symbol(t.ml[j], ls, el, lx);
        table_code(t.lp[j], el, lx, v[j], nb[j]);
      } else if (prev_tk) {
        v[j] = pv;
        nb[j] = pn;
      } else if ((t.lit >> (8 * j)) & 0xFFu) {
        table_code(t.lp[j], 0, 0u, v[j], nb[j]);
      }
    }
    prev_tk = tk;
    pv = dv[j];
    pn = dn[j];
  }
}

template <bool kDyn>
__device__ __forceinline__ void emissions(const Tile& t, int p0, int n,
                                          int lane, uint32_t* v, int* nb) {
  if constexpr (!kDyn) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      v[j] = 0u;
      nb[j] = 0;
      if ((t.taken >> (8 * j)) & 0xFFu)
        static_match(t.ml[j], t.dist[j], v[j], nb[j]);
      else if ((t.lit >> (8 * j)) & 0xFFu)
        static_lit((t.bytes >> (8 * j)) & 0xFFu, v[j], nb[j]);
    }
  } else {
    dynamic_emissions(t, p0, n, lane, v, nb);
  }
}

// OR one thread's emissions, contiguous in the row from bit `off`, into
// the row image. The first and the last word it touches may hold a
// neighbour's bits too (atomicOr); the words between are its alone.
__device__ __forceinline__ void put(uint32_t* img, int max_words,
                                    uint32_t off, const uint32_t* v,
                                    const int* nb) {
  uint32_t w = off >> 5;
  int f = (int)(off & 31u);
  unsigned long long acc = 0ull;
  bool first = true;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    acc |= (unsigned long long)v[j] << f;
    f += nb[j];  // < 64: f < 32 before, nb <= 32
    if (f >= 32) {
      if (w < (uint32_t)max_words) {
        if (first)
          atomicOr(&img[w], (uint32_t)acc);
        else
          img[w] = (uint32_t)acc;
      }
      first = false;
      acc >>= 32;
      f -= 32;
      ++w;
    }
  }
  if ((uint32_t)acc != 0u && w < (uint32_t)max_words)
    atomicOr(&img[w], (uint32_t)acc);
}

template <bool kDyn, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
pack_rows_kernel(Planes in, const int32_t* __restrict__ base,
                 uint32_t* __restrict__ words, int32_t* __restrict__ end,
                 int n, int max_words) {
  extern __shared__ uint4 smem4[];
  __shared__ int warp_bits[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  uint32_t* const out_row = words + row * (size_t)max_words;
  // shared word sh + i holds row word i: both agree modulo 4
  const int sh = (int)(((uintptr_t)out_row >> 2) & 3u);
  uint32_t* const img = reinterpret_cast<uint32_t*>(smem4) + sh;
  const int nvec = (sh + max_words + 3) >> 2;
  for (int i = tid; i < nvec; i += kThreads)
    smem4[i] = make_uint4(0u, 0u, 0u, 0u);
  // (the first step's barrier orders the zeroing before any word is put)

  uint32_t carry = (uint32_t)base[row];
  const int nsteps = (n + kStep - 1) / kStep;
  Tile cur, nxt;
  load<kDyn, kVec>(cur, in, row, tid * kV, n, lane);
  for (int s = 0; s < nsteps; ++s) {
    const int p0 = s * kStep + tid * kV;
    if (s + 1 < nsteps) load<kDyn, kVec>(nxt, in, row, p0 + kStep, n, lane);
    uint32_t v[kV];
    int nb[kV];
    emissions<kDyn>(cur, p0, n, lane, v, nb);
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kV; ++j) sum += nb[j];
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_bits[s & 1][warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int b = warp_bits[s & 1][w];
      before += w < warp ? b : 0;
      total += b;
    }
    put(img, max_words, carry + (uint32_t)(before + incl - sum), v, nb);
    carry += (uint32_t)total;
    cur = nxt;
  }
  __syncthreads();
  if (tid == 0) end[row] = (int32_t)carry;

  // the whole 16-byte vectors of the row, then the 0-3 words before and
  // after them one by one
  uint4* const dst4 = reinterpret_cast<uint4*>(out_row - sh);
  const int v0 = (sh + 3) >> 2;
  const int v1 = (sh + max_words) >> 2;
  for (int i = v0 + tid; i < v1; i += kThreads) dst4[i] = smem4[i];
  const int head = min(4 * v0 - sh, max_words);
  if (tid < head) out_row[tid] = img[tid];
  for (int i = max(4 * v1 - sh, head) + tid; i < max_words; i += kThreads)
    out_row[i] = img[i];
}

template <bool kDyn, bool kVec>
int launch(const Planes& in, const int32_t* base, uint32_t* words,
           int32_t* end, int rows, int n, int max_words, cudaStream_t st) {
  // the row image with up to 3 words of shift, in whole 16-byte vectors
  const size_t smem = (size_t)((max_words + 6) / 4) * 16;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (smem + sizeof(int) * 2 * kWarps > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(pack_rows_kernel<kDyn, kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  return qz::launch(pack_rows_kernel<kDyn, kVec>, rows, kThreads, smem, st,
                    in, base, words, end, n, max_words);
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

}  // namespace

// Static mode when lpack is null (data given), dynamic when it is not
// (data null). Planes that are not 16-byte (int32) / 4-byte (byte)
// aligned, or rows whose length is not a multiple of 4, take the kernel's
// scalar loads.
extern "C" int qz_pack_rows(const void* data, const void* ml,
                            const void* dist, const void* taken,
                            const void* lit, const void* lpack,
                            const void* dpack, const void* base, void* words,
                            void* end, int rows, int n, int max_words,
                            void* stream) {
  const Planes in{(const uint8_t*)data,   (const int32_t*)ml,
                  (const int32_t*)dist,   (const uint8_t*)taken,
                  (const uint8_t*)lit,    (const uint32_t*)lpack,
                  (const uint32_t*)dpack};
  const bool dyn = lpack != nullptr;
  const bool vec = n % kV == 0 && aligned(ml, 16) && aligned(dist, 16) &&
                   aligned(taken, 4) && aligned(lit, 4) &&
                   (dyn ? aligned(lpack, 16) && aligned(dpack, 16)
                        : aligned(data, 4));
  const int32_t* b = (const int32_t*)base;
  uint32_t* w = (uint32_t*)words;
  int32_t* e = (int32_t*)end;
  cudaStream_t st = (cudaStream_t)stream;
  if (dyn)
    return vec ? launch<true, true>(in, b, w, e, rows, n, max_words, st)
               : launch<true, false>(in, b, w, e, rows, n, max_words, st);
  return vec ? launch<false, true>(in, b, w, e, rows, n, max_words, st)
             : launch<false, false>(in, b, w, e, rows, n, max_words, st);
}
