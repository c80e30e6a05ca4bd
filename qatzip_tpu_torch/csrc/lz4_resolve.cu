// LZ4 copy-chain resolution of the device LZ4 decode.
//
// Replaces the XLA while_loop of gathers in qatzip_tpu/ops/lz4_decode.py
// resolve_refs: a (B, n) reference plane, where ref[i] < 0 is the literal
// -(byte + 1) and ref[i] >= 0 the output index that position i copies,
// becomes the (B, n) output bytes. The JAX function runs synchronous
// pointer-doubling rounds, ref = ref[clip(ref)] over the whole batch, at
// most max_rounds of them while any entry is >= 0, and returns ~ref as
// bytes (the astype keeps the low 8 bits) and whether an entry is >= 0.
//
// Three kernels, chosen by the row's width and the rounds:
//
// resolve_kernel_chunks (n <= 65536 and at least max((n - 1).bit_length(),
// (min(n, 16384) - 1).bit_length() + 1) rounds, as the decode always
// gives: the JAX function then resolves every chain of a valid row, and
// so do the chunks, as below). A valid row's
// references all point backwards, so the row resolves front to back in
// chunks of 16384 positions. Two CTAs of 512 threads share an SM (96 KiB
// of shared memory each: a chunk's 16-bit indices and the row's bytes),
// so a 224-row tile is one wave and one CTA's loads overlap the other's
// passes. For each chunk a thread loads its 32 references at once, then:
//   * a literal takes its byte; a reference before the chunk takes that
//     position's byte, which is final: both are roots;
//   * the chunk's own chains jump in place (an entry closes in the pass
//     after it lands on a root; two shared-memory reads an open entry a
//     pass), each pass at least a synchronous round's progress, so a
//     chain of depth d closes within 1 + ceil(log2 d) passes, d below
//     min(n, 16384): one pass more than the JAX rounds need, which the
//     rule above pays for (at most max_rounds passes);
//   * each entry takes its root's byte, and the chunk's bytes go out.
// A row with a forward or self reference or an index past the row (no
// LZ4 parse makes one) is noticed at load and takes the in-place loop of
// resolve_kernel_wide over the whole row instead (below), which gives
// the JAX function's flag and its bytes wherever it resolves. Global
// traffic is the bound's: one read of the plane, one write of the bytes.
// The plane is left as it was.
//
// resolve_kernel_smem (n <= 65536, fewer rounds than that): the JAX
// rounds themselves, exactly, in shared memory. No path of the port calls
// with so few rounds (the decode gives (n - 1).bit_length() + 1); it
// keeps the JAX function's result for any max_rounds. One CTA of 1024 threads a row
// (200 KiB) reads the plane once into s[i] (16 bits: the index the entry
// holds, clipped to n - 1 as the JAX gather clips it, or i for a
// literal), a done bit a position (the entry is a literal; so an entry
// that points at itself is open, not a literal) and lit[i] (the
// literal's byte). Every open entry takes (s, done) of the entry it
// points at, all reads before all writes (each thread keeps its up to 64
// new indices in registers across a barrier): after k rounds every entry
// holds what the JAX function's holds, the same flag, the same byte
// wherever the entry resolved, ~index for an entry still open (the JAX
// function's own unless the plane held an index past the row).
//
// resolve_kernel_wide (n > 65536, up to a frame's 4 MiB blocks): one CTA
// of 512 threads a row jumps the pointers in place in global memory, in
// passes over the row (four positions a thread a step, eight loads in
// flight). In-place jumping is safe: every value a thread
// reads or writes is a position on the same chain, or the chain's
// literal, and a target another thread already jumped this pass is only
// further along, so each pass makes at least one synchronous round's
// progress: where the JAX function resolves within max_rounds this
// kernel does too, with the same bytes, in at most max_rounds passes. It
// may resolve with fewer rounds than the JAX function needs. A last pass
// writes ~ref as bytes and the flag.
//
// Bounds on the H100 at the decode's tile (224-256 rows of 65536): one
// read of the plane and the bytes written once, 0.022-0.025 ms at
// 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kSmemThreads = 1024;
constexpr int kSmemMaxN = 65536;
constexpr int kPer = kSmemMaxN / kSmemThreads;  // positions a thread
constexpr int kWideThreads = 512;
constexpr int kUnroll = 4;
constexpr int kChunk = 16384;                       // positions a chunk
constexpr int kChunkPer = kChunk / kWideThreads;    // a thread's in a chunk
// shared memory of resolve_kernel_chunks: a chunk's 16-bit indices and
// the row's bytes (whole 16-byte words)
__host__ __device__ constexpr size_t chunk_smem_bytes(int n) {
  return (size_t)kChunk * 2 + ((n + 15) & ~15);
}

// shared memory of a row of n: s (2 bytes a position, whole words), the
// done bits (whole words), lit (a byte a position)
__host__ __device__ constexpr int s_words(int n) { return (n + 1) / 2; }
__host__ __device__ constexpr int bit_words(int n) { return (n + 31) / 32; }
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return (size_t)(s_words(n) + bit_words(n)) * 4 + n;
}

__global__ void __launch_bounds__(kSmemThreads, 1)
resolve_kernel_smem(const int32_t* __restrict__ ref,
                    uint8_t* __restrict__ out,
                    int32_t* __restrict__ unresolved, int n, int max_rounds) {
  extern __shared__ uint32_t smem[];
  uint16_t* s = reinterpret_cast<uint16_t*>(smem);
  uint32_t* done = smem + s_words(n);
  uint8_t* lit = reinterpret_cast<uint8_t*>(done + bit_words(n));
  const int32_t* r = ref + (size_t)blockIdx.x * n;
  uint8_t* o = out + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // position k * kSmemThreads + tid is this thread's k-th; bit k of open
  // says it is still an index
  uint64_t open = 0;
#pragma unroll 16
  for (int k = 0; k < kPer; ++k) {
    const int i = k * kSmemThreads + tid;
    const int32_t v = i < n ? __ldg(r + i) : -1;
    const bool is_ref = v >= 0;
    if (i < n) {
      s[i] = (uint16_t)(is_ref ? min(v, n - 1) : i);
      lit[i] = (uint8_t)~v;
    }
    const uint32_t lits = __ballot_sync(0xffffffffu, !is_ref);
    if (lane == 0 && k * kSmemThreads + warp * 32 < n)
      done[k * (kSmemThreads / 32) + warp] = lits;
    open |= (uint64_t)is_ref << k;
  }
  // the JAX rounds themselves: all reads, a barrier, all writes
  for (int round = 0; round < max_rounds; ++round) {
    if (!__syncthreads_or(open != 0)) break;
    uint32_t stage[kPer / 2];
    uint64_t now_done = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      uint32_t t = 0;
      if ((open >> k) & 1) {
        const int j = s[k * kSmemThreads + tid];
        t = s[j];
        now_done |= (uint64_t)((done[j >> 5] >> (j & 31)) & 1u) << k;
      }
      if (k & 1)
        stage[k >> 1] |= t << 16;
      else
        stage[k >> 1] = t;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool was_open = (open >> k) & 1;
      if (was_open)
        s[k * kSmemThreads + tid] =
            (uint16_t)(stage[k >> 1] >> (16 * (k & 1)));
      const uint32_t bits =
          __ballot_sync(0xffffffffu, !was_open || ((now_done >> k) & 1));
      if (lane == 0 && k * kSmemThreads + warp * 32 < n)
        done[k * (kSmemThreads / 32) + warp] = bits;
    }
    open &= ~now_done;
  }
  __syncthreads();
  // the bytes, four positions a thread a step where the row allows
  int left = 0;
  if ((n & 3) == 0) {
    for (int q = tid; q < n / 4; q += kSmemThreads) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        const uint32_t si = s[i];
        const bool d = (done[i >> 5] >> (i & 31)) & 1u;
        left |= !d;
        word |= (d ? lit[si] : (~si & 0xFFu)) << (8 * e);
      }
      reinterpret_cast<uint32_t*>(o)[q] = word;
    }
  } else {
    for (int i = tid; i < n; i += kSmemThreads) {
      const uint32_t si = s[i];
      const bool d = (done[i >> 5] >> (i & 31)) & 1u;
      left |= !d;
      o[i] = (uint8_t)(d ? lit[si] : ~si);
    }
  }
  left = __syncthreads_or(left);
  if (tid == 0) unresolved[blockIdx.x] = left != 0;
}

// The in-place loop: the row's pointers jumped in place in device memory by
// kWideThreads threads, at most max_rounds passes, then ~ref written as
// bytes; returns (to every thread) whether an entry is still an index
__device__ int jump_in_place(int32_t* r, uint8_t* o, int n, int max_rounds) {
  const int tid = threadIdx.x;
  for (int round = 0; round < max_rounds; ++round) {
    int open = 0;
    for (int base = tid; base < n; base += kUnroll * kWideThreads) {
      int32_t v[kUnroll];
      int32_t t[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kWideThreads;
        v[u] = i < n ? r[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        t[u] = v[u] >= 0 ? r[min(v[u], n - 1)] : v[u];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v[u] >= 0) {
          r[base + u * kWideThreads] = t[u];
          open |= t[u] >= 0;
        }
      }
    }
    if (!__syncthreads_or(open)) break;
  }
  int open = 0;
  for (int i = tid; i < n; i += kWideThreads) {
    const int32_t v = r[i];
    o[i] = (uint8_t)~v;
    open |= v >= 0;
  }
  return __syncthreads_or(open);
}

__global__ void __launch_bounds__(kWideThreads)
resolve_kernel_wide(int32_t* ref, uint8_t* __restrict__ out,
                    int32_t* __restrict__ unresolved, int n, int max_rounds) {
  const int left = jump_in_place(ref + (size_t)blockIdx.x * n,
                                 out + (size_t)blockIdx.x * n, n, max_rounds);
  if (threadIdx.x == 0) unresolved[blockIdx.x] = left != 0;
}

__global__ void __launch_bounds__(kWideThreads, 2)
resolve_kernel_chunks(int32_t* ref, uint8_t* __restrict__ out,
                      int32_t* __restrict__ unresolved, int n,
                      int max_rounds) {
  extern __shared__ uint32_t smem[];
  uint16_t* s = reinterpret_cast<uint16_t*>(smem);   // the chunk's indices
  uint8_t* lit = reinterpret_cast<uint8_t*>(smem + kChunk / 2);  // the row
  int32_t* r = ref + (size_t)blockIdx.x * n;
  uint8_t* o = out + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;
  int left = 0;
  int odd = 0;
  // chunk position c = k * kWideThreads + tid is this thread's k-th; a
  // thread loads its kChunkPer references of a chunk at once
  for (int base = 0; base < n; base += kChunk) {
    const int len = min(kChunk, n - base);
    int32_t v[kChunkPer];
#pragma unroll
    for (int k = 0; k < kChunkPer; ++k) {
      const int c = base + k * kWideThreads + tid;
      v[k] = c < n ? __ldg(r + c) : -1;
    }
    // a literal, or an index before the chunk (whose byte is final), is a
    // root (s[c] = c) with its byte in lit; bit k of open: an index into
    // the chunk, still to resolve
    uint32_t open = 0;
#pragma unroll
    for (int k = 0; k < kChunkPer; ++k) {
      const int c = k * kWideThreads + tid;
      const int i = base + c;
      if (c < len) {
        if (v[k] >= i) {
          odd = 1;                       // forward, self or past the row
        } else if (v[k] < base) {
          lit[i] = v[k] < 0 ? (uint8_t)~v[k] : lit[v[k]];
          s[c] = (uint16_t)c;
        } else {
          s[c] = (uint16_t)(v[k] - base);
          open |= 1u << k;
        }
      }
    }
    odd = __syncthreads_or(odd);
    if (odd) break;
    for (int round = 0; round < max_rounds; ++round) {
      if (!__syncthreads_or(open != 0)) break;
      for (uint32_t m = open; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const int c = k * kWideThreads + tid;
        const int j = s[c];
        const int t = s[j];
        if (t == j)
          open &= ~(1u << k);            // j is a root
        else
          s[c] = (uint16_t)t;
      }
    }
    __syncthreads();
    // the chunk's bytes: each index takes its root's
#pragma unroll
    for (int k = 0; k < kChunkPer; ++k) {
      const int c = k * kWideThreads + tid;
      if (c < len && s[c] != c) {
        const int root = base + s[c];
        lit[base + c] = (open >> k) & 1 ? (uint8_t)~root : lit[root];
      }
    }
    left |= open != 0;
    __syncthreads();
    if (((uintptr_t)(o + base) & 15) == 0 && (len & 15) == 0) {
      for (int q = tid; q < len / 16; q += kWideThreads)
        reinterpret_cast<uint4*>(o + base)[q] =
            reinterpret_cast<const uint4*>(lit + base)[q];
    } else {
      for (int c = tid; c < len; c += kWideThreads) o[base + c] = lit[base + c];
    }
  }
  // a row the chunks cannot take: the in-place loop over the whole row
  if (odd) left = jump_in_place(r, o, n, max_rounds);
  left = __syncthreads_or(left);
  if (tid == 0) unresolved[blockIdx.x] = left != 0;
}

int bit_length(int v) { return v > 0 ? 32 - __builtin_clz(v) : 0; }

std::atomic<uint64_t> chunks_opted{0}, smem_opted{0};

}  // namespace

extern "C" int qz_lz4_resolve_refs(void* ref, void* out, void* unresolved,
                                   int rows, int n, int max_rounds,
                                   void* stream) {
  if (n > kSmemMaxN)
    return qz::launch(resolve_kernel_wide, rows, kWideThreads, 0, stream,
                      (int32_t*)ref, (uint8_t*)out, (int32_t*)unresolved, n,
                      max_rounds);
  // The chunks resolve every valid row once max_rounds covers both the
  // JAX function's own rounds for any chain, (n - 1).bit_length() (with
  // fewer its flag may say unresolved where the chunks resolve), and
  // their own passes: a chain inside a chunk is at most min(n, kChunk) - 1
  // deep, and an entry closes in the pass after it lands on its root, so
  // in lockstep (a warp's reads before its writes) an entry of depth d
  // takes 1 + ceil(log2 d) passes.
  const int chunk_rounds = std::max(bit_length(n - 1),
                                    bit_length(std::min(n, kChunk) - 1) + 1);
  if (max_rounds >= chunk_rounds) {
    const int rc = qz::opt_in_smem(resolve_kernel_chunks,
                                   chunk_smem_bytes(kSmemMaxN), chunks_opted);
    if (rc) return rc;
    return qz::launch(resolve_kernel_chunks, rows, kWideThreads,
                      chunk_smem_bytes(n), stream, (int32_t*)ref,
                      (uint8_t*)out, (int32_t*)unresolved, n, max_rounds);
  }
  const int rc = qz::opt_in_smem(resolve_kernel_smem, smem_bytes(kSmemMaxN),
                                 smem_opted);
  if (rc) return rc;
  return qz::launch(resolve_kernel_smem, rows, kSmemThreads, smem_bytes(n),
                    stream, (const int32_t*)ref, (uint8_t*)out,
                    (int32_t*)unresolved, n, max_rounds);
}
