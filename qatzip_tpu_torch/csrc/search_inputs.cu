// The candidate search's inputs: window keys and context words.
//
// Replaces the plain-torch stages lz77.py _hashed_context and the window
// layout of _search_inputs, which XLA fused into the front of
// qatzip_tpu/ops/lz77.py _analyze on the TPU (no Pallas kernel there).
// For a (B, n) byte batch and a search over windows of w positions that
// overlap by ov (w = n, ov = 0: the whole row), window k of row b covers
// row positions p = k * (w - ov) - ov + j, j in [0, w), and slot j gets
//   ctx[c][b * nwin + k][j] = little-endian uint32 of bytes p + 4c ..
//                             p + 4c + 3 (zeros past n), c < ctx_words;
//   key[b * nwin + k][j]    = (h << pbits) | j, with
//   h = (ctx word 0 * 2654435761 mod 2^32) >> (32 - hb) where
//       p + min_match <= lengths[b], else the overflow bucket 1 << hb;
// a slot outside the row (the ov-slot lead, the right pad) gets the
// overflow bucket and zero context words, exactly as candidate_search
// takes them.
//
// Bounds on the H100: the function reads each byte of the batch once and
// writes (1 + ctx_words) words a slot. At the level-1 main path (256 x
// 64 KiB rows, w 8192, ov 896, nwin 9, ctx_words 3) that is 302 MB of
// output and 17 MB of input, ~95 us at 3.35 TB/s: device memory bounds it.
// The torch route it replaces ran ~53 operations over int64 planes of the
// row (the three context words alone 403 MB) and the padded window copies.
//
// Design: one CTA of 256 threads a span of 2048 slots of one window row
// stages the span's bytes (and the 15 bytes after it) in shared memory,
// one coalesced byte load a thread and step, zero outside the row; each
// thread then builds its slots' words from shared memory and stores the
// key and the context words with neighbouring threads on neighbouring
// slots, so every store is coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 2048;          // slots per CTA
constexpr int kTail = 15;            // bytes read past a slot: 4 words - 1
constexpr uint32_t kHashMul = 2654435761u;

__global__ void __launch_bounds__(kThreads)
search_inputs_kernel(const uint8_t* __restrict__ data,
                     const int32_t* __restrict__ lengths,
                     uint32_t* __restrict__ key, uint32_t* __restrict__ ctx,
                     int n, int w, int ov, int nwin, int per_win,
                     int ctx_words, int min_match, int pbits, int hb,
                     long long plane) {
  __shared__ uint8_t bytes[kSpan + kTail + 1];
  const int tid = threadIdx.x;
  const int r = blockIdx.x / per_win;            // window row
  const int j0 = (blockIdx.x % per_win) * kSpan;
  const int b = r / nwin;
  const int k = r % nwin;
  const long long p0 = (long long)k * (w - ov) - ov + j0;
  const int cnt = min(kSpan, w - j0);
  const uint8_t* row = data + (size_t)b * n;
  for (int i = tid; i < cnt + kTail; i += kThreads) {
    const long long p = p0 + i;
    bytes[i] = (p >= 0 && p < n) ? row[p] : 0;
  }
  __syncthreads();

  const long long len = lengths[b];
  const uint32_t over = 1u << hb;
  for (int i = tid; i < cnt; i += kThreads) {
    const long long p = p0 + i;
    const int j = j0 + i;
    const size_t o = (size_t)r * w + j;
    uint32_t h = over;
    if (p >= 0 && p < n) {
      for (int c = 0; c < ctx_words; ++c) {
        const uint8_t* s = bytes + i + 4 * c;
        const uint32_t word = (uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                              ((uint32_t)s[2] << 16) | ((uint32_t)s[3] << 24);
        ctx[c * plane + o] = word;
        if (c == 0 && p + min_match <= len)
          h = (word * kHashMul) >> (32 - hb);
      }
    } else {
      for (int c = 0; c < ctx_words; ++c) ctx[c * plane + o] = 0u;
    }
    key[o] = (h << pbits) | (uint32_t)j;
  }
}

}  // namespace

extern "C" int qz_search_inputs(const void* data, const void* lengths,
                                void* key, void* ctx, int rows, int n, int w,
                                int ov, int ctx_words, int min_match,
                                int pbits, int hb, void* stream) {
  if (rows <= 0 || n <= 0 || w <= 0 || ov < 0 || ov >= w || ctx_words < 1 ||
      ctx_words > 4 || hb < 1 || pbits < 0 || hb + pbits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const int own = w - ov;
  const int nwin = (n + own - 1) / own;
  const int per_win = (w + kSpan - 1) / kSpan;
  const long long blocks = (long long)rows * nwin * per_win;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  return qz::launch(search_inputs_kernel, (unsigned)blocks, kThreads, 0,
                    stream, (const uint8_t*)data, (const int32_t*)lengths,
                    (uint32_t*)key, (uint32_t*)ctx, n, w, ov, nwin, per_win,
                    ctx_words, min_match, pbits, hb,
                    (long long)rows * nwin * w);
}
