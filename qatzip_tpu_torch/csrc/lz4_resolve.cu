// LZ4 copy-chain resolution of the device LZ4 decode.
//
// Replaces the XLA while_loop of gathers in qatzip_tpu/ops/lz4_decode.py
// resolve_refs: a (B, n) reference plane, where ref[i] < 0 is the literal
// -(byte + 1) and ref[i] >= 0 the earlier output index that position i
// copies, becomes the (B, n) output bytes. The JAX function runs
// synchronous pointer-doubling rounds, ref = ref[ref] over the whole
// batch, at most max_rounds of them while any entry is >= 0.
//
// Design on the H100: one CTA a row jumps the pointers in place in global
// memory, in passes over the row. A row of 64 KiB references is 256 KiB
// and stays in L2 between passes. Each thread takes four positions a
// step, loads their references, then their four targets, then stores the
// targets: eight loads in flight a thread. __syncthreads_or ends the
// passes as soon as the row has no reference left, so the row needs no
// host round trip a round. In-place jumping is safe: every value a thread
// reads or writes is a position on the same chain, or the chain's literal,
// and a target another thread has already jumped this pass is only
// further along. So after k passes every entry is at least as far along
// its chain as after k synchronous rounds: where the JAX function
// resolves within max_rounds the kernel does too, with the same bytes
// (each chain ends in one literal). It may resolve in fewer passes, and
// never runs more than max_rounds. A target past the row is clipped to
// its last position, as the JAX function clips it.
//
// A last pass writes each byte, ~ref (= -ref - 1, truncated to 8 bits, as
// the JAX function's astype gives it), and the row's unresolved flag.
//
// Bounds on the H100 at the decode's tile (256 rows of 65536): one read
// of the 64 MiB plane and 16 MiB of bytes written, 0.025 ms at 3.35 TB/s.
// Each pass reads the plane again and gathers its targets, from L2 where
// the rows in flight fit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
resolve_kernel(int32_t* ref, uint8_t* __restrict__ out,
               int32_t* __restrict__ unresolved, int n, int max_rounds) {
  int32_t* r = ref + (size_t)blockIdx.x * n;
  uint8_t* o = out + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;
  for (int round = 0; round < max_rounds; ++round) {
    int open = 0;
    for (int base = tid; base < n; base += kUnroll * kThreads) {
      int32_t v[kUnroll];
      int32_t t[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        v[u] = i < n ? r[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        t[u] = v[u] >= 0 ? r[min(v[u], n - 1)] : v[u];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v[u] >= 0) {
          r[base + u * kThreads] = t[u];
          open |= t[u] >= 0;
        }
      }
    }
    if (!__syncthreads_or(open)) break;
  }
  int open = 0;
  for (int i = tid; i < n; i += kThreads) {
    const int32_t v = r[i];
    o[i] = (uint8_t)~v;
    open |= v >= 0;
  }
  open = __syncthreads_or(open);
  if (tid == 0) unresolved[blockIdx.x] = open != 0;
}

}  // namespace

extern "C" int qz_lz4_resolve_refs(void* ref, void* out, void* unresolved,
                                   int rows, int n, int max_rounds,
                                   void* stream) {
  return qz::launch(resolve_kernel, rows, kThreads, 0, stream,
                    (int32_t*)ref, (uint8_t*)out, (int32_t*)unresolved, n,
                    max_rounds);
}
