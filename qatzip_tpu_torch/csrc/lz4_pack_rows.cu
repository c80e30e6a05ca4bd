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
// The TPU could not scatter into VMEM, so the JAX route built int64-wide
// planes (run lengths by 16 rounds of doubling, next matches by 10),
// took a cumsum and ORed every 256-position group into a window of 112
// words before the assembly. On the H100 one CTA of 512 threads owns a
// row (the row's words, 128 KB at n = 65536, in opted-in shared memory;
// one CTA per SM):
//
//   * first the row's literal plane becomes a bitmap in shared memory
//     (8 KB at n = 65536); a run start finds its run's length by scanning
//     the bitmap (at most 271 positions, 32 a word, so at most 10 words)
//     and reads the match that ends the run straight from the planes;
//   * then 512 threads walk the row in steps of 2048 positions, 4 a
//     thread: the int32 planes as 16-byte vectors, the byte planes as
//     4-byte words, the next step's loads issued before this step's work;
//     a thread forms its 4 emissions in registers, the step's exclusive
//     byte offsets come from a warp scan and the per-warp totals in shared
//     memory (one barrier a step), plus the carry of the row so far;
//   * a thread's emissions are contiguous: it assembles them in a 64-bit
//     register, stores the words it fills alone and ORs (atomicOr) only
//     its first and last word, which neighbours may share;
//   * the finished row goes out 16 bytes a thread.
//
// Bounds on the H100: device memory. A tile of 256 x 64 KiB rows reads
// data, ml, dist, taken and lit once (11 bytes a position) and writes
// 32,772 words a row: 218.1 MB, ~0.065 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kV = 4;                 // positions per thread per step
constexpr int kStep = kThreads * kV;  // positions per step
constexpr int kMaxRun = 270;          // longest run an emission holds
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

template <bool kVec>
__device__ __forceinline__ void load(Tile& t, const Planes& in, size_t row,
                                     int p0, int n) {
  const size_t at = row * (size_t)n + p0;
  t.taken = t.bytes = 0u;
#pragma unroll
  for (int j = 0; j < kV; ++j) t.ml[j] = t.dist[j] = 0;
  if (kVec) {
    // n % kV == 0: a thread's positions lie all inside the row or all past
    if (p0 < n) {
      const int4 m = *reinterpret_cast<const int4*>(in.ml + at);
      const int4 d = *reinterpret_cast<const int4*>(in.dist + at);
      t.ml[0] = m.x; t.ml[1] = m.y; t.ml[2] = m.z; t.ml[3] = m.w;
      t.dist[0] = d.x; t.dist[1] = d.y; t.dist[2] = d.z; t.dist[3] = d.w;
      t.taken = *reinterpret_cast<const uint32_t*>(in.taken + at);
      t.bytes = *reinterpret_cast<const uint32_t*>(in.data + at);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      if (p0 + j < n) {
        t.ml[j] = in.ml[at + j];
        t.dist[j] = in.dist[at + j];
        t.taken |= (uint32_t)in.taken[at + j] << (8 * j);
        t.bytes |= (uint32_t)in.data[at + j] << (8 * j);
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
    // into 16 bits, and two lanes make a word
    const int nvec = n >> 4;
    const int iters = (nvec + kThreads - 1) / kThreads;
    for (int it = 0; it < iters; ++it) {
      const int i = it * kThreads + tid;
      uint32_t half = 0u;
      if (i < nvec) {
        const uint4 v = reinterpret_cast<const uint4*>(lit)[i];
        half = nonzero4(v.x) | (nonzero4(v.y) << 4) | (nonzero4(v.z) << 8) |
               (nonzero4(v.w) << 12);
      }
      const uint32_t up = __shfl_down_sync(kFull, half, 1);
      if ((tid & 1) == 0 && (i >> 1) < nbm) bm[i >> 1] = half | (up << 16);
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

__device__ __forceinline__ uint32_t lit_at(const uint32_t* bm, int p) {
  return (bm[p >> 5] >> (p & 31)) & 1u;
}

// The run of literals from run start p: its length, counted up to
// kMaxRun + 1 (a longer run only makes the row not ok).
__device__ __forceinline__ int run_length(const uint32_t* bm, int p, int n) {
  const int limit = min(n, p + kMaxRun + 1);
  int q = p + 1;
  while (q < limit) {
    const uint32_t w = ~bm[q >> 5] >> (q & 31);  // 1 = not a literal
    if (w) return min(q + __ffs(w) - 1, limit) - p;
    q = (q | 31) + 1;
  }
  return limit - p;
}

// The thread's kV emissions (value little-endian in a u32, nb in bits).
__device__ __forceinline__ void emissions(const Tile& t, const Planes& in,
                                          const uint32_t* bm, size_t row,
                                          int p0, int n, uint32_t* v,
                                          int* nb, bool& long_run) {
  const uint32_t lit4 = p0 < n ? (bm[p0 >> 5] >> (p0 & 31)) & 0xFu : 0u;
  uint32_t prev = p0 > 0 && p0 <= n ? lit_at(bm, p0 - 1) : 0u;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int p = p0 + j;
    const uint32_t lt = (lit4 >> j) & 1u;
    const bool tk = ((t.taken >> (8 * j)) & 0xFFu) != 0u;
    const uint32_t byte = (t.bytes >> (8 * j)) & 0xFFu;
    uint32_t val = 0u;
    int bytes = 0;
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
        const int L = run_length(bm, p, n);
        uint32_t nm = 0u;
        if (L > kMaxRun) {
          long_run = true;
        } else if (p + L < n) {
          const size_t q = row * (size_t)n + p + L;
          if (in.taken[q]) nm = (uint32_t)in.ml[q];
        }
        const uint32_t mnib = nm > 0u ? min(nm > 4u ? nm - 4u : 0u, 15u) : 0u;
        val = ((uint32_t)min(L, 15) << 4) | mnib;
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
      } else if (lt) {
        val = byte;
        bytes = 1;
      }
    }
    v[j] = val;
    nb[j] = 8 * bytes;
    prev = lt;
  }
}

// OR one thread's emissions, contiguous in the row from bit `off`, into
// the row image. The first and the last word it touches may hold a
// neighbour's bytes too (atomicOr); the words between are its alone.
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

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
lz4_pack_rows_kernel(Planes in, uint32_t* __restrict__ words,
                     int32_t* __restrict__ nbytes, uint8_t* __restrict__ ok,
                     int n, int max_words) {
  extern __shared__ uint4 smem4[];
  __shared__ int warp_bytes[2][kWarps];
  __shared__ int long_run_seen;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  uint32_t* const out_row = words + row * (size_t)max_words;
  // shared word sh + i holds row word i: both agree modulo 4
  const int sh = (int)(((uintptr_t)out_row >> 2) & 3u);
  const int nvec = (max_words + 6) >> 2;
  uint32_t* const img = reinterpret_cast<uint32_t*>(smem4) + sh;
  uint32_t* const bm = reinterpret_cast<uint32_t*>(smem4 + nvec);
  const int nbm = (n + 31) >> 5;
  for (int i = tid; i < nvec; i += kThreads)
    smem4[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) long_run_seen = 0;
  lit_bitmap<kVec>(bm, nbm, in.lit + row * (size_t)n, n, tid);
  __syncthreads();

  bool long_run = false;
  uint32_t carry = 0u;  // bytes so far
  const int nsteps = (n + kStep - 1) / kStep;
  Tile cur, nxt;
  load<kVec>(cur, in, row, tid * kV, n);
  for (int s = 0; s < nsteps; ++s) {
    const int p0 = s * kStep + tid * kV;
    if (s + 1 < nsteps) load<kVec>(nxt, in, row, p0 + kStep, n);
    uint32_t v[kV];
    int nb[kV];
    emissions(cur, in, bm, row, p0, n, v, nb, long_run);
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kV; ++j) sum += nb[j] >> 3;
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_bytes[s & 1][warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int b = warp_bytes[s & 1][w];
      before += w < warp ? b : 0;
      total += b;
    }
    put(img, max_words, 8u * (carry + (uint32_t)(before + incl - sum)), v,
        nb);
    carry += (uint32_t)total;
    cur = nxt;
  }
  if (long_run) long_run_seen = 1;
  __syncthreads();
  const bool row_ok = long_run_seen == 0;
  if (tid == 0) {
    nbytes[row] = (int32_t)carry;
    ok[row] = row_ok ? 1 : 0;
  }

  // the whole 16-byte vectors of the row, then the 0-3 words before and
  // after them one by one; zeros for a row that is not ok
  uint4* const dst4 = reinterpret_cast<uint4*>(out_row - sh);
  const int v0 = (sh + 3) >> 2;
  const int v1 = (sh + max_words) >> 2;
  const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
  for (int i = v0 + tid; i < v1; i += kThreads)
    dst4[i] = row_ok ? smem4[i] : z4;
  const int head = min(4 * v0 - sh, max_words);
  if (tid < head) out_row[tid] = row_ok ? img[tid] : 0u;
  for (int i = max(4 * v1 - sh, head) + tid; i < max_words; i += kThreads)
    out_row[i] = row_ok ? img[i] : 0u;
}

template <bool kVec>
int launch(const Planes& in, uint32_t* words, int32_t* nbytes, uint8_t* ok,
           int rows, int n, int max_words, cudaStream_t st) {
  // the row image with up to 3 words of shift, in whole 16-byte vectors,
  // then the literal bitmap
  const size_t smem = (size_t)((max_words + 6) / 4) * 16 +
                      (size_t)((n + 31) / 32) * 4;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (smem + sizeof(int) * (2 * kWarps + 1) > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(lz4_pack_rows_kernel<kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  lz4_pack_rows_kernel<kVec><<<rows, kThreads, smem, st>>>(
      in, words, nbytes, ok, n, max_words);
  return (int)cudaGetLastError();
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
