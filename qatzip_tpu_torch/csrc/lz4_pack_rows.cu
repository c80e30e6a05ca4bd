// LZ4 block byte packer of the full-device LZ4 pack: every position's
// emission, the exclusive byte offsets and the placement of each emission
// in its row's words, in one kernel.
//
// Replaces the stage the JAX package ran as XLA ops,
// qatzip_tpu/ops/lz4_pack.py:65-143 (the literal-run plane, the next-match
// plane, the emission planes, a cumsum of the byte counts and the
// 256-position group pack with its assembly). Bit for bit what the plain
// version lz4_pack_rows_ref (qatzip_tpu_torch/ops/lz4_pack.py) computes:
//
//   run start p (a literal whose predecessor is not one), run of L
//              literals, next match m (the taken match that ends the
//              run, if any): the token (min(L, 15) << 4 | min(ml[m] - 4,
//              15)), the length bytes (min(L - 15, 255) from L = 15 on,
//              L - 270 at L = 270) and p's own byte;
//   literal:   its byte;
//   match:     its own token (min(ml - 4, 15)) when no literal precedes
//              it, the 2-byte offset, and ml - 19 when ml >= 19;
//
// each emission at most 4 bytes, placed at its exclusive byte offset in
// the row (little-endian words), words at or past max_words dropped;
// nbytes[row] = the row's bytes. A row whose literal runs all hold at most
// 270 literals is ok; a row that is not ok (a longer run: its length
// bytes would not fit one emission) comes out as zero words with the
// nbytes the JAX route gives it, and the host repacks it.
//
// Least time on the H100: device memory's. A tile of 256 x 64 KiB rows reads
// data, ml, dist, taken and lit once (11 bytes a position) and writes
// 32,772 words a row: 218.1 MB, ~0.065 ms at 3.35 TB/s.
//
// The first design (0.219-0.224 ms a tile on the H100, 29 % of the
// bound) held a whole row image (128 KB) in shared memory, so one
// 512-thread CTA ran on an SM and a tile took two waves; its run starts
// loaded the match that ends the run from global memory, a dependent load
// per run; the row image went out only after the walk. This design streams
// the row:
//
//   * one CTA of 512 threads a row, 43 KB of shared memory at n = 65536
//     (the row's literal bitmap, 8 KB, a ring of 8192 output words, the
//     match nibbles of three steps), two CTAs an SM: all 256 rows of a
//     tile are resident at once;
//   * the first two steps' planes are loaded before the bitmap is built,
//     and every step loads the planes of the step two ahead (16-byte
//     vectors for the int32 planes, 4-byte words for the byte planes);
//   * ok is decided from the bitmap before any word is written: a run of
//     271 literals holds at least seven whole all-literal bitmap words, so
//     each streak of whole words is measured with the bits around it. A
//     row that is not ok writes zero words, counts its bytes without a
//     scan or a barrier and loads neither dist nor data after the first
//     two steps;
//   * a step is 2048 positions, 4 a thread. A thread reads the two bitmap
//     words at its first position once; they give its literal bits and,
//     with one find-first-set, the length of any run of up to 32
//     literals (a longer one scans on). No dependent load: each step writes the
//     match nibbles of the step after it (from the planes already in
//     registers) to shared memory, and a run start takes its token's
//     nibble from there;
//   * the exclusive byte offsets come from a warp scan, then, after the
//     step's one barrier, a scan of the 16 warp totals across the lanes;
//     every emission is ORed into the ring while the words that the steps
//     before finished go out coalesced and their ring slots are zeroed
//     (those words and the ones the step touches lie within 8192 words of
//     each other). The words past the block are zeroed 16 bytes a store.
//
// What holds the walk back is instruction issue, not memory: on the H100,
// taking the loops of the run-length scans out of a step, or its 16 reads
// of the warp totals, each made the tile faster, while plain ORs in place
// of the atomics and a walk without its global stores did not.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kV = 4;                 // positions per thread per step
constexpr int kStep = kThreads * kV;  // positions per step
constexpr int kMaxRun = 270;          // longest run an emission holds
constexpr int kRing = 8192;           // output words staged, a power of 2
constexpr uint32_t kRingMask = kRing - 1;
constexpr int kStreak = kMaxRun / 32 + 1;  // so many whole words: too long
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Planes {
  const uint8_t* data;
  const int32_t* ml;
  const int32_t* dist;
  const uint8_t* taken;
  const uint8_t* lit;
};

// One thread's kV positions of one step, as loaded.
struct Tile {
  int ml[kV], dist[kV];
  uint32_t bytes, taken;  // one byte per position
};

// kAll: also dist and data (a row that is not ok needs neither).
template <bool kVec, bool kAll>
__device__ __forceinline__ void load(Tile& t, const Planes& in, size_t at,
                                     int p0, int n) {
  t.taken = t.bytes = 0u;
#pragma unroll
  for (int j = 0; j < kV; ++j) t.ml[j] = t.dist[j] = 0;
  if (kVec) {
    // n % kV == 0: a thread's positions lie all inside the row or all past
    if (p0 < n) {
      const int4 m = *reinterpret_cast<const int4*>(in.ml + at);
      t.ml[0] = m.x; t.ml[1] = m.y; t.ml[2] = m.z; t.ml[3] = m.w;
      t.taken = *reinterpret_cast<const uint32_t*>(in.taken + at);
      if (kAll) {
        const int4 d = *reinterpret_cast<const int4*>(in.dist + at);
        t.dist[0] = d.x; t.dist[1] = d.y; t.dist[2] = d.z; t.dist[3] = d.w;
        t.bytes = *reinterpret_cast<const uint32_t*>(in.data + at);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      if (p0 + j < n) {
        t.ml[j] = in.ml[at + j];
        t.taken |= (uint32_t)in.taken[at + j] << (8 * j);
        if (kAll) {
          t.dist[j] = in.dist[at + j];
          t.bytes |= (uint32_t)in.data[at + j] << (8 * j);
        }
      }
    }
  }
}

// Bits 0-3 set where the 4 bytes of x are not zero.
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// Build the row's literal bitmap (bit p of word p >> 5 = lit[p]); bits at
// and past n stay 0.
template <bool kVec>
__device__ __forceinline__ void lit_bitmap(uint32_t* bm, int nbm,
                                           const uint8_t* lit, int n,
                                           int tid) {
  if (kVec) {
    // n % 16 == 0 and the row 16-byte aligned: a thread turns 16 bytes
    // into 16 bits, and two lanes make a word; four loads in flight
    constexpr int kBatch = 4;
    const int nvec = n >> 4;
    for (int i0 = 0; i0 < nvec; i0 += kBatch * kThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads + tid;
        v[u] = i < nvec ? reinterpret_cast<const uint4*>(lit)[i]
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads + tid;
        const uint32_t half = nonzero4(v[u].x) | (nonzero4(v[u].y) << 4) |
                              (nonzero4(v[u].z) << 8) |
                              (nonzero4(v[u].w) << 12);
        const uint32_t up = __shfl_down_sync(kFull, half, 1);
        if ((tid & 1) == 0 && (i >> 1) < nbm) bm[i >> 1] = half | (up << 16);
      }
    }
  } else {
    for (int w = tid; w < nbm; w += kThreads) {
      uint32_t word = 0u;
      for (int j = 0; j < 32; ++j) {
        const int p = 32 * w + j;
        if (p < n && lit[p]) word |= 1u << j;
      }
      bm[w] = word;
    }
  }
}

// True where this thread finds a run of more than kMaxRun literals. Such
// a run holds at least seven whole all-literal words (and a run without a
// whole word at most 62 literals): at the first word of each streak of
// whole words, the streak (counted up to kStreak words) plus the literal
// bits that end the word before it and begin the word after it.
__device__ __forceinline__ bool long_run_in(const uint32_t* bm, int nbm,
                                            int tid) {
  bool found = false;
  for (int w = tid; w < nbm; w += kThreads) {
    if (bm[w] != kFull || (w > 0 && bm[w - 1] == kFull)) continue;
    int len = w > 0 ? __clz(~bm[w - 1]) : 0;
    int k = 1;
    while (k < kStreak && w + k < nbm && bm[w + k] == kFull) ++k;
    len += 32 * k;
    if (k < kStreak && w + k < nbm) len += __ffs(~bm[w + k]) - 1;
    found |= len > kMaxRun;
  }
  return found;
}

// The run of literals from run start p, whose literals are known up to
// position q: its length, counted up to kMaxRun + 1 (a longer run only
// makes the row not ok).
__device__ __forceinline__ int run_from(const uint32_t* bm, int p, int q,
                                        int n) {
  const int limit = min(n, p + kMaxRun + 1);
  while (q < limit) {
    const uint32_t w = ~bm[q >> 5] >> (q & 31);  // 1 = not a literal
    if (w) return min(q + __ffs(w) - 1, limit) - p;
    q = (q | 31) + 1;
  }
  return limit - p;
}

// The match nibble each of the tile's positions gives the run it ends
// (4 bits a position, 0 where no match is taken).
__device__ __forceinline__ uint32_t nibbles(const Tile& t) {
  uint32_t x = 0u;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const uint32_t nm = (uint32_t)t.ml[j];
    if ((t.taken >> (8 * j)) & 0xFFu)
      x |= min(nm > 4u ? nm - 4u : 0u, 15u) << (4 * j);
  }
  return x;
}

// The thread's kV emissions; returns their bytes. kPlace: also their
// values (little-endian in a u32; a run start's match nibble still 0) and
// byte counts, and in rq[j], for a run start, the position its run ends
// at (whose nibble its token takes), -1 where there is none. The bitmap
// words of p0 and the next one give each position's literal bit and most
// runs' lengths without a loop.
template <bool kPlace>
__device__ __forceinline__ int emissions(const Tile& t, const uint32_t* bm,
                                         int nbm, int p0, int n, uint32_t* v,
                                         int* nb, int* rq) {
  const int wi = p0 >> 5, o = p0 & 31;
  const uint32_t w0 = wi < nbm ? bm[wi] : 0u;
  const uint32_t w1 = wi + 1 < nbm ? bm[wi + 1] : 0u;
  const unsigned long long win = w0 | ((unsigned long long)w1 << 32);
  const uint32_t lit4 = p0 < n ? (uint32_t)(win >> o) & 0xFu : 0u;
  uint32_t prev = o ? (w0 >> (o - 1)) & 1u
                    : (p0 > 0 && p0 <= n ? bm[wi - 1] >> 31 : 0u);
  int rel = 0;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int p = p0 + j;
    const uint32_t lt = (lit4 >> j) & 1u;
    const bool tk = ((t.taken >> (8 * j)) & 0xFFu) != 0u;
    const uint32_t byte = (t.bytes >> (8 * j)) & 0xFFu;
    uint32_t val = 0u;
    int bytes = 0, end = -1;
    if (p < n) {
      if (tk) {
        const uint32_t stored = (uint32_t)max(t.ml[j] - 4, 0);
        const uint32_t off = (uint32_t)t.dist[j];  // 2 bytes, low first
        const bool ext = stored >= 15u;
        if (prev) {            // the run before it carried the token
          val = off | (ext ? (stored - 15u) << 16 : 0u);
          bytes = 2 + ext;
        } else {               // a sequence with no literals: own token
          val = min(stored, 15u) | (off << 8) |
                (ext ? (stored - 15u) << 24 : 0u);
          bytes = 3 + ext;
        }
      } else if (lt && !prev) {
        // the first non-literal after p inside the window (its top bits
        // shift in as literals), else a scan from the window's end
        const unsigned long long rest = ~win >> (o + j + 1);
        const int L = rest ? min(__ffsll((long long)rest),
                                 min(n, p + kMaxRun + 1) - p)
                           : run_from(bm, p, 32 * (wi + 2), n);
        val = (uint32_t)min(L, 15) << 4;
        bytes = 1;
        if (L >= 15) {
          val |= (uint32_t)min(L - 15, 255) << 8;
          ++bytes;
        }
        if (L >= kMaxRun) {
          val |= (uint32_t)(L - kMaxRun) << 16;
          ++bytes;
        }
        val |= byte << (8 * bytes);
        ++bytes;
        if (p + L < n) end = p + L;
      } else if (lt) {
        val = byte;
        bytes = 1;
      }
    }
    if (kPlace) {
      v[j] = val;
      nb[j] = bytes;
      rq[j] = end;
    }
    rel += bytes;
    prev = lt;
  }
  return rel;
}

// OR one thread's emissions, contiguous in the row from byte `off`, into
// the ring (other threads may share its first and last words, and a
// match's nibble may land in any word: every write is an atomicOr).
__device__ __forceinline__ void put(uint32_t* ring, uint32_t off,
                                    const uint32_t* v, const int* nb) {
  uint32_t w = off >> 2;
  int f = 8 * (int)(off & 3u);
  unsigned long long acc = 0ull;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    acc |= (unsigned long long)v[j] << f;
    f += 8 * nb[j];  // < 64: f < 32 before, nb <= 4
    if (f >= 32) {
      if ((uint32_t)acc) atomicOr(&ring[w & kRingMask], (uint32_t)acc);
      acc >>= 32;
      f -= 32;
      ++w;
    }
  }
  if ((uint32_t)acc) atomicOr(&ring[w & kRingMask], (uint32_t)acc);
}

// Zero out[from, to), 16 bytes a store where aligned.
__device__ __forceinline__ void zero_words(uint32_t* out, int from, int to,
                                           int tid) {
  if (from >= to) return;
  const int mis = (int)(((uintptr_t)(out + from) >> 2) & 3u);
  const int head = min((4 - mis) & 3, to - from);
  if (tid < head) out[from + tid] = 0u;
  const int a = from + head;
  const int nvec = (to - a) >> 2;
  uint4* const dst = reinterpret_cast<uint4*>(out + a);
  for (int i = tid; i < nvec; i += kThreads)
    dst[i] = make_uint4(0u, 0u, 0u, 0u);
  const int tail = a + 4 * nvec;
  if (tid < to - tail) out[tail + tid] = 0u;
}

// One CTA's walk over its row. kPlace (an ok row): place every emission
// and write the words; otherwise only count the bytes.
template <bool kVec, bool kPlace>
struct Walk {
  const Planes& in;
  size_t at0;  // the thread's first position in the planes
  int n, nbm, max_words, tid;
  const uint32_t* bm;
  uint32_t* ring;
  int* warp_bytes;       // a step's warp totals, two steps' worth
  uint16_t* nibs;        // the match nibbles of three steps, kThreads each
  uint32_t* out_row;
  uint32_t carry, flushed;  // bytes so far, words written so far
  int mine;                 // counting: this thread's bytes

  // Step s on `cur`, with `nxt` holding step s + 1, after starting the
  // loads of step s + 2 into `slot`.
  __device__ __forceinline__ void step(const Tile& cur, const Tile& nxt,
                                       Tile& slot, int s) {
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int p0 = s * kStep + tid * kV;
    load<kVec, kPlace>(slot, in, at0 + (size_t)(s + 2) * kStep,
                       p0 + 2 * kStep, n);
    uint32_t v[kV];
    int nb[kV], rq[kV];
    const int sum = emissions<kPlace>(cur, bm, nbm, p0, n, v, nb, rq);
    if (!kPlace) {
      mine += sum;
      return;
    }
    // step s + 1's nibbles, for the runs of this step that end there; the
    // three buffers take turns, and a buffer is read by two steps at most
    nibs[((s + 1) % 3) * kThreads + tid] = (uint16_t)nibbles(nxt);
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    int* const totals = warp_bytes + (s & 1) * kWarps;
    if (lane == 31) totals[warp] = incl;
    __syncthreads();  // this step's totals and nibbles; the last step's
                      // emissions are in the ring
    flush(carry);
    // the warp totals scanned across the lanes: lane i holds warps 0-i
    int wsum = totals[lane & (kWarps - 1)];
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(kFull, wsum, d);
      if ((lane & (kWarps - 1)) >= d) wsum += y;
    }
    const int total = __shfl_sync(kFull, wsum, kWarps - 1);
    const int upto = __shfl_sync(kFull, wsum, (warp - 1) & (kWarps - 1));
    const int before = warp ? upto : 0;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      if (rq[j] >= 0) {  // the match nibble of the run's token
        const int q = rq[j];
        v[j] |= (uint32_t)(nibs[((q / kStep) % 3) * kThreads +
                                (q % kStep) / kV] >> (4 * (q % kV))) & 15u;
      }
    }
    put(ring, carry + (uint32_t)(before + incl - sum), v, nb);
    carry += (uint32_t)total;
  }

  // Write out and zero the words wholly below byte `upto`, where the step
  // now placing its emissions begins: the steps before wrote them whole.
  // They lie within kRing words of every word that step touches.
  __device__ __forceinline__ void flush(uint32_t upto) {
    const uint32_t lim = upto >> 2;
    for (uint32_t w = flushed + tid; w < lim; w += kThreads) {
      const uint32_t x = ring[w & kRingMask];
      ring[w & kRingMask] = 0u;
      if (w < (uint32_t)max_words) out_row[w] = x;
    }
    flushed = max(flushed, lim);
  }

  // The row's bytes, after its last words (or after the count).
  __device__ __forceinline__ int finish() {
    if (kPlace) {
      __syncthreads();  // the last step's emissions are in
      const uint32_t used = (carry + 3u) >> 2;
      for (uint32_t w = flushed + tid; w < used; w += kThreads)
        if (w < (uint32_t)max_words) out_row[w] = ring[w & kRingMask];
      zero_words(out_row, (int)min(used, (uint32_t)max_words), max_words,
                 tid);
      return (int)carry;
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) mine += __shfl_xor_sync(kFull, mine, d);
    if ((tid & 31) == 0) warp_bytes[tid >> 5] = mine;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_bytes[w];
    return total;
  }
};

// Walk the row from t0 and t1 (steps 0 and 1, loaded); returns its bytes.
template <bool kVec, bool kPlace>
__device__ __forceinline__ int walk(const Planes& in, size_t row, int n,
                                    int max_words, const uint32_t* bm,
                                    uint32_t* ring, int* warp_bytes,
                                    uint16_t* nibs, uint32_t* out_row,
                                    Tile& t0, Tile& t1, int tid) {
  Walk<kVec, kPlace> w{in, row * (size_t)n + tid * kV, n, (n + 31) >> 5,
                       max_words, tid, bm, ring, warp_bytes, nibs, out_row,
                       0u, 0u, 0};
  if (kPlace) nibs[tid] = (uint16_t)nibbles(t0);  // step 0's, buffer 0
  const int nsteps = (n + kStep - 1) / kStep;
  for (int s = 0; s < nsteps; ++s) {
    Tile t2;
    w.step(t0, t1, t2, s);
    t0 = t1;
    t1 = t2;
  }
  return w.finish();
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
lz4_pack_rows_kernel(Planes in, uint32_t* __restrict__ words,
                     int32_t* __restrict__ nbytes, uint8_t* __restrict__ ok,
                     int n, int max_words) {
  extern __shared__ uint4 smem4[];  // the ring, then the literal bitmap
  __shared__ int warp_bytes[2 * kWarps];
  __shared__ uint16_t nibs[3 * kThreads];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  uint32_t* const ring = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* const bm = ring + kRing;
  uint32_t* const out_row = words + row * (size_t)max_words;
  const int nbm = (n + 31) >> 5;

  // the first two steps' planes in flight while the bitmap is built
  const size_t at0 = row * (size_t)n + tid * kV;
  Tile t0, t1;
  load<kVec, true>(t0, in, at0, tid * kV, n);
  load<kVec, true>(t1, in, at0 + kStep, tid * kV + kStep, n);
  for (int i = tid; i < kRing / 4; i += kThreads)
    smem4[i] = make_uint4(0u, 0u, 0u, 0u);
  lit_bitmap<kVec>(bm, nbm, in.lit + row * (size_t)n, n, tid);
  __syncthreads();
  const bool row_ok = !__syncthreads_or(long_run_in(bm, nbm, tid));

  int total;
  if (row_ok) {
    total = walk<kVec, true>(in, row, n, max_words, bm, ring, warp_bytes,
                             nibs, out_row, t0, t1, tid);
  } else {
    zero_words(out_row, 0, max_words, tid);
    total = walk<kVec, false>(in, row, n, max_words, bm, ring, warp_bytes,
                              nibs, out_row, t0, t1, tid);
  }
  if (tid == 0) {
    nbytes[row] = (int32_t)total;
    ok[row] = row_ok ? 1 : 0;
  }
}

// The ring, the bitmap and the static arrays fit the 48 KB a CTA gets
// without opting in (the wrapper keeps n to that), so a launch makes no
// attribute call.
template <bool kVec>
int launch(const Planes& in, uint32_t* words, int32_t* nbytes, uint8_t* ok,
           int rows, int n, int max_words, cudaStream_t st) {
  const size_t smem = (size_t)kRing * 4 + (size_t)((n + 31) / 32) * 4;
  return qz::launch(lz4_pack_rows_kernel<kVec>, rows, kThreads, smem, st, in,
                    words, nbytes, ok, n, max_words);
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

}  // namespace

// Planes whose rows are not 16-byte aligned (int32 and the literal plane)
// or 4-byte aligned (data, taken), or rows whose length is not a multiple
// of 16, take the kernel's scalar loads.
extern "C" int qz_lz4_pack_rows(const void* data, const void* ml,
                                const void* dist, const void* taken,
                                const void* lit, void* words, void* nbytes,
                                void* ok, int rows, int n, int max_words,
                                void* stream) {
  const Planes in{(const uint8_t*)data, (const int32_t*)ml,
                  (const int32_t*)dist, (const uint8_t*)taken,
                  (const uint8_t*)lit};
  const bool vec = n % 16 == 0 && aligned(ml, 16) && aligned(dist, 16) &&
                   aligned(lit, 16) && aligned(taken, 4) && aligned(data, 4);
  uint32_t* w = (uint32_t*)words;
  int32_t* nb = (int32_t*)nbytes;
  uint8_t* o = (uint8_t*)ok;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch<true>(in, w, nb, o, rows, n, max_words, st)
             : launch<false>(in, w, nb, o, rows, n, max_words, st);
}
