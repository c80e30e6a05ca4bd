// Greedy-parse coverage scan over independent segment lanes.
//
// Replaces the stage qatzip_tpu/ops/lz77.py _parse_scan, which XLA fused
// into a fori_loop of column ops on the TPU (no Pallas kernel there).
//
// The greedy parse is a one-state recurrence per lane (a parse segment
// of one chunk, `seg` <= 8192 positions); `reach` is the end of the
// match being emitted, 0 at the start:
//   free  = p >= reach
//   taken = free &&  is_match[p]   (a match token starts at p)
//   lit   = free && !is_match[p]   (p emits its own literal)
//   reach = taken ? p + ml[p] : reach
// The positions where `free` holds form one path through the segment:
// p -> p + step[p], step = is_match ? max(ml, 1) : 1.
//
// Bounds on the H100: the function moves 7 bytes per position (1 + 4 in,
// 2 out), so at 2048 lanes x 8192 it is bound by device memory at
// 0.035 ms. A serial walk per lane is bound by latency instead (8192
// dependent steps). This design keeps the walk short and in shared
// memory:
//   1. one CTA of 256 threads per lane stages the step plane (16 bits,
//      saturated at the segment's end) and an is_match bitmap in shared
//      memory with coalesced 16-byte loads;
//   2. speculate: thread j walks sub-block j (32 positions) from its
//      first position, and records its path bits and its exit, the
//      first path position at or past the next sub-block;
//   3. verify: the true entry of each sub-block follows from the one
//      before it. Where the entry is the sub-block's first position the
//      exit is the speculative one; a sub-block the entry passes is
//      covered whole; otherwise the chain walks until it meets the
//      speculative path (from there both agree) or leaves the sub-block.
//      One thread per group of 32 sub-blocks chains its group from the
//      group's first position, then one thread carries the true entry
//      across the 8 groups and chains a group again only until it meets
//      the group's own chain. On real data entries are mostly
//      speculative ones or meet them within a token, so the serial part
//      is ~32 + 8 shared-memory steps; an adversarial plane (chains
//      offset by 1-3 positions that never meet) degrades to a walk of
//      the whole segment, still in shared memory;
//   4. each thread redoes its sub-block's path from its true entry the
//      same way, and the taken / lit planes are stored 16 bytes a thread.
// The step plane carries one padding word per 32 positions, so the 32
// threads of a warp walking their sub-blocks hit 32 different banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSeg = 8192;
constexpr int kSub = 32;                 // positions per sub-block
constexpr int kBlocks = kMaxSeg / kSub;  // sub-blocks of the widest lane
constexpr int kGroup = 32;               // sub-blocks per verify group,
                                         // one group per warp

__device__ __forceinline__ int slot(int p) { return p + ((p >> 5) << 1); }

// the path's stride at a match of length v, saturated at the segment end
__device__ __forceinline__ int match_step(int v, int rest) {
  return v < 1 ? 1 : (v > rest ? rest : v);
}

// 16 bits -> 16 bytes of 0 / 1, four bits per word
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

__device__ __forceinline__ uint4 bits_to_bytes(uint32_t b) {
  return make_uint4(nibble_bytes(b), nibble_bytes(b >> 4),
                    nibble_bytes(b >> 8), nibble_bytes(b >> 12));
}

// The true entries of sub-blocks j0..j1-1 from entry e into j0: where
// the entry is the sub-block's first position the exit is the
// speculative one; a sub-block the entry passes is covered; otherwise
// walk until the speculative path (from there both agree) or the
// sub-block's end. With `repair`, stop where the entry equals the one
// recorded before, and return `known_exit`, the exit recorded then.
__device__ int chain(const uint16_t* step, const uint32_t* path,
                     const int* exits, int* entry, int j0, int j1, int e,
                     int seg, bool repair, int known_exit) {
  for (int j = j0; j < j1; ++j) {
    if (repair && entry[j] == e) return known_exit;
    entry[j] = e;
    const int s = j * kSub;
    if (e == s) {
      e = exits[j];
      continue;
    }
    const int t = min(s + kSub, seg);
    if (e >= t) continue;              // covered by a match
    const uint32_t spec = path[j];
    int p = e;
    while (p < t && !((spec >> (p - s)) & 1u)) p += step[slot(p)];
    e = p < t ? exits[j] : p;
  }
  return e;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
parse_scan_kernel(const uint8_t* __restrict__ is_match,
                  const int32_t* __restrict__ ml, uint8_t* __restrict__ taken,
                  uint8_t* __restrict__ lit, int seg) {
  __shared__ uint16_t step[kMaxSeg + 2 * kBlocks];
  __shared__ uint32_t mbits[kBlocks];   // is_match, one word per sub-block
  __shared__ uint32_t path[kBlocks];    // speculative, then final path bits
  __shared__ int exits[kBlocks];        // speculative exits
  __shared__ int entry[kBlocks];        // true entries
  __shared__ int gexit[kBlocks / kGroup];  // exits of the group chains
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * seg;
  const int nb = (seg + kSub - 1) / kSub;

  // -- 1. stage the step plane and the is_match bits -----------------------
  if (VEC) {  // seg % 16 == 0, every pointer 16-byte aligned
    for (int q = tid; q < seg / 16; q += kThreads) {
      const int p0 = q * 16;
      const uint4 m4 =
          __ldg(reinterpret_cast<const uint4*>(is_match + base + p0));
      const int4* mlp = reinterpret_cast<const int4*>(ml + base + p0);
      const uint32_t mw[4] = {m4.x, m4.y, m4.z, m4.w};
      uint32_t* dst = reinterpret_cast<uint32_t*>(step + slot(p0));
      uint32_t bits = 0;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int4 v = __ldg(mlp + g);
        const int vs[4] = {v.x, v.y, v.z, v.w};
        int st[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = p0 + 4 * g + b;
          const bool im = (mw[g] >> (8 * b)) & 0xFFu;
          bits |= (uint32_t)im << (4 * g + b);
          st[b] = im ? match_step(vs[b], seg - p) : 1;
        }
        dst[2 * g] = (uint32_t)st[0] | ((uint32_t)st[1] << 16);
        dst[2 * g + 1] = (uint32_t)st[2] | ((uint32_t)st[3] << 16);
      }
      reinterpret_cast<uint16_t*>(mbits)[q] = (uint16_t)bits;
    }
  } else {
    for (int p0 = 0; p0 < seg; p0 += kThreads) {  // uniform over the CTA
      const int p = p0 + tid;
      bool im = false;
      if (p < seg) {
        im = is_match[base + p] != 0;
        step[slot(p)] =
            (uint16_t)(im ? match_step(ml[base + p], seg - p) : 1);
      }
      const uint32_t bal = __ballot_sync(0xFFFFFFFFu, im);
      if ((tid & 31) == 0 && p < seg) mbits[p >> 5] = bal;
    }
  }
  __syncthreads();

  // -- 2. speculate: each sub-block walked from its first position --------
  if (tid < nb) {
    const int s = tid * kSub;
    const int t = min(s + kSub, seg);
    uint32_t bits = 0;
    int p = s;
    while (p < t) {
      bits |= 1u << (p - s);
      p += step[slot(p)];
    }
    path[tid] = bits;
    exits[tid] = p;
  }
  __syncthreads();

  // -- 3. verify: the true entry of every sub-block -------------------------
  //    3a. one thread per group of 32 sub-blocks chains its group from the
  //        group's first position (group 0's is the true entry, 0)
  const int ng = (nb + kGroup - 1) / kGroup;
  if ((tid & 31) == 0 && (tid >> 5) < ng) {
    const int j0 = (tid >> 5) * kGroup;
    gexit[tid >> 5] = chain(step, path, exits, entry, j0,
                            min(j0 + kGroup, nb), j0 * kSub, seg, false, 0);
  }
  __syncthreads();
  //    3b. one thread carries the true entry across the groups, and
  //        chains a group again only until it meets the group's own chain
  if (tid == 0) {
    int e = gexit[0];
    for (int g = 1; g < ng; ++g) {
      const int j0 = g * kGroup;
      e = e == j0 * kSub ? gexit[g]
                         : chain(step, path, exits, entry, j0,
                                 min(j0 + kGroup, nb), e, seg, true, gexit[g]);
    }
  }
  __syncthreads();

  // -- 4. each sub-block's true path ------------------------------------------
  if (tid < nb) {
    const int s = tid * kSub;
    const int e = entry[tid];
    if (e != s) {
      const int t = min(s + kSub, seg);
      const uint32_t spec = path[tid];
      uint32_t bits = 0;
      for (int p = e; p < t; p += step[slot(p)]) {
        if ((spec >> (p - s)) & 1u) {
          bits |= spec & (0xFFFFFFFFu << (p - s));
          break;
        }
        bits |= 1u << (p - s);
      }
      path[tid] = bits;
    }
  }
  __syncthreads();

  // -- 5. taken / lit planes --------------------------------------------------
  if (VEC) {
    for (int q = tid; q < seg / 16; q += kThreads) {
      const int sh = (q & 1) * 16;
      const uint32_t on = (path[q >> 1] >> sh) & 0xFFFFu;
      const uint32_t m = (mbits[q >> 1] >> sh) & 0xFFFFu;
      *reinterpret_cast<uint4*>(taken + base + q * 16) = bits_to_bytes(on & m);
      *reinterpret_cast<uint4*>(lit + base + q * 16) = bits_to_bytes(on & ~m);
    }
  } else {
    for (int p = tid; p < seg; p += kThreads) {
      const uint32_t on = (path[p >> 5] >> (p & 31)) & 1u;
      const uint32_t m = (mbits[p >> 5] >> (p & 31)) & 1u;
      taken[base + p] = (uint8_t)(on & m);
      lit[base + p] = (uint8_t)(on & ~m);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" int qz_parse_scan(const void* is_match, const void* ml,
                             void* taken, void* lit, int lanes, int seg,
                             void* stream) {
  if (seg < 1 || seg > kMaxSeg) return (int)cudaErrorInvalidValue;
  const bool vec = seg % 16 == 0 && aligned16(is_match) && aligned16(ml) &&
                   aligned16(taken) && aligned16(lit);
  return qz::launch(vec ? parse_scan_kernel<true> : parse_scan_kernel<false>,
                    lanes, kThreads, 0, stream, (const uint8_t*)is_match,
                    (const int32_t*)ml, (uint8_t*)taken, (uint8_t*)lit, seg);
}
