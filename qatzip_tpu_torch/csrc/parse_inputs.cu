// The parse's inputs from the raw candidates: extension, clamp, lazy
// demotion, parse-segment trim and the LZ4 end rules.
//
// Replaces the plain-torch stages lz77.py _parse_inputs and the unwindow
// and unpack of _candidates, which XLA fused on the TPU
// (qatzip_tpu/ops/lz77.py _analyze, _extend_matches and _analyze_tail up
// to the parse; no Pallas kernel there). From (ml, dist) candidates, in
// one of three forms,
//   windows: candidate_search's (rows * nwin, w) words (relpos << 18 |
//            ml << 13 | dist - 1), position p read from window
//            p / (w - ov) at slot ov + p % (w - ov);
//   rows:    (B, n) ml and dist in row order (the full-row search);
//   packed:  (B, n) ml << 16 | dist - 1, the plane a launch before wrote,
// it runs `rounds` rounds of the saturation-doubling extension from
// `cap` on (cap, 2 cap, ...): a match at exactly the round's cap whose
// continuation cap positions on holds a same-distance match of at least
// min_match grows to min(cap + that length, max_match), every position
// from the plane before the round. Then either it writes the packed
// plane (a later launch goes on) or, with no output plane, it ends the
// stage: ml clamped to the row, a match demoted where the next position
// holds a strictly longer one, matches trimmed at parse-segment ends,
// and with lz4_rules no match starting in the last 12 bytes and none
// reaching into the last 5; it writes is_match, ml and dist for
// parse_scan.
//
// Bounds on the H100: 4 bytes in (the windows' overlap ~12 % more) and 9
// out a position: at 256 x 64 KiB rows ~218 MB, ~65 us at 3.35 TB/s. The
// torch route ran ~117 operations over (B, n) int32 planes, one pass each.
//
// Design: the extension's reach sets it. A position's final length reads
// positions up to the sum of the caps on (DEFLATE at level 1: 12 + 24 +
// 48 + 96 + 192 = 372; the LZ4 device pack 496), plus one for the lazy
// demotion. One CTA of 256 threads owns a span of 4096 positions of one
// row, loads the span and its halo into shared memory once, runs every
// round there between two buffers (each round over the positions that
// later rounds still read), and writes its span's outputs once: one
// launch a tile. Where the halo passes kMaxHalo (LZ4 on the token path,
// max_match 32767: caps to 16384 reach across the row) the wrapper runs
// the rounds whose caps sum to at most kMaxHalo this way, then one launch
// a remaining round over a ping-pong pair of packed planes in device
// memory (extend_round_kernel), the last of them ending the stage.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "qz_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 4096;       // positions a CTA gives out
constexpr int kMaxHalo = 2048;    // positions past its span a CTA reads

enum Form { kWindows = 0, kRows = 1, kPacked = 2 };

struct Source {
  const int32_t* kv;      // windows
  const int32_t* ml;      // rows
  const int32_t* dist;    // rows
  const int32_t* p;       // packed
  int n, w, ov, own, nwin;
};

struct Rules {
  const int32_t* lengths;
  int min_match, max_match, seg, lz4;
};

template <int F>
__device__ __forceinline__ int32_t load_p(const Source& s, int b, int g) {
  if (g >= s.n) return 0;
  if (F == kWindows) {
    const int k = g / s.own;
    const int j = s.ov + (g - k * s.own);
    const uint32_t v = (uint32_t)s.kv[((size_t)b * s.nwin + k) * s.w + j];
    return (int32_t)((((v >> 13) & 0x1Fu) << 16) | (v & 0x1FFFu));
  } else if (F == kRows) {
    const size_t o = (size_t)b * s.n + g;
    return (int32_t)(((uint32_t)s.ml[o] << 16) | ((uint32_t)s.dist[o] - 1u));
  } else {
    return s.p[(size_t)b * s.n + g];
  }
}

// One round at `cap` of position p, `np` the packed word cap positions on.
__device__ __forceinline__ int32_t extend(int32_t p, int32_t np, int cap,
                                          const Rules& r) {
  const int32_t nml = np >> 16;
  const bool cont = (p >> 16) == cap && ((np ^ p) & 0xFFFF) == 0 &&
                    nml >= r.min_match;
  if (!cont) return p;
  const int32_t ext = min(cap + nml, r.max_match);
  return (int32_t)(((uint32_t)ext << 16) | ((uint32_t)p & 0xFFFFu));
}

// ml of a packed word at g clamped to the row, 0 where it is no match.
__device__ __forceinline__ int32_t clamped(int32_t p, int g, int len,
                                           int min_match) {
  const int32_t m = min(p >> 16, len - g);
  return m >= min_match ? m : 0;
}

// The stage's end at g: `p` its final packed word, `pn` the next one
// (0 past the row).
__device__ __forceinline__ void finish(int32_t p, int32_t pn, int b, int g,
                                       int n, const Rules& r,
                                       uint8_t* is_match, int32_t* ml,
                                       int32_t* dist) {
  const int len = r.lengths[b];
  const int mm = r.min_match;
  int32_t m = min(p >> 16, len - g);
  bool im = m >= mm;
  m = im ? m : 0;
  const int32_t mn = g + 1 < n ? clamped(pn, g + 1, len, mm) : 0;
  im = im && !(mn > m);                 // lazy demotion
  m = im ? m : 0;
  m = min(m, r.seg - g % r.seg);        // parse-segment trim
  im = im && m >= mm;
  m = im ? m : 0;
  if (r.lz4) {
    m = min(m, len - 5 - g);
    im = im && g <= len - 12 && m >= mm;
    m = im ? m : 0;
  }
  const size_t o = (size_t)b * n + g;
  is_match[o] = im;
  ml[o] = m;
  dist[o] = (p & 0xFFFF) + 1;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
parse_inputs_kernel(Source s, Rules r, int32_t* __restrict__ p_out,
                    uint8_t* __restrict__ is_match, int32_t* __restrict__ ml,
                    int32_t* __restrict__ dist, int per_row, int span,
                    int cap, int rounds) {
  extern __shared__ int32_t sm[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / per_row;
  const int s0 = (blockIdx.x % per_row) * span;
  const bool ends = p_out == nullptr;
  int reach = cap * ((1 << rounds) - 1) + (ends ? 1 : 0);
  const int width = span + reach;
  int32_t* a = sm;
  int32_t* c = sm + width;
  for (int i = tid; i < width; i += kThreads) a[i] = load_p<F>(s, b, s0 + i);
  __syncthreads();
  for (int k = 0, cp = cap; k < rounds; ++k, cp <<= 1) {
    reach -= cp;
    const int lim = span + reach;
    for (int i = tid; i < lim; i += kThreads)
      c[i] = extend(a[i], a[i + cp], cp, r);
    __syncthreads();
    int32_t* t = a;
    a = c;
    c = t;
  }
  const int cnt = min(span, s.n - s0);
  if (ends) {
    for (int i = tid; i < cnt; i += kThreads)
      finish(a[i], a[i + 1], b, s0 + i, s.n, r, is_match, ml, dist);
  } else {
    int32_t* out = p_out + (size_t)b * s.n + s0;
    for (int i = tid; i < cnt; i += kThreads) out[i] = a[i];
  }
}

// One round at `cap` over a packed plane in device memory; without an
// output plane it also ends the stage.
__global__ void __launch_bounds__(kThreads)
extend_round_kernel(const int32_t* __restrict__ p_in, Rules r,
                    int32_t* __restrict__ p_out,
                    uint8_t* __restrict__ is_match, int32_t* __restrict__ ml,
                    int32_t* __restrict__ dist, int n, long long total,
                    int cap) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += step) {
    const int b = (int)(i / n);
    const int g = (int)(i - (long long)b * n);
    const int32_t p = extend(p_in[i], g + cap < n ? p_in[i + cap] : 0, cap,
                             r);
    if (p_out) {
      p_out[i] = p;
      continue;
    }
    int32_t pn = 0;
    if (g + 1 < n)
      pn = extend(p_in[i + 1], g + 1 + cap < n ? p_in[i + 1 + cap] : 0, cap,
                  r);
    finish(p, pn, b, g, n, r, is_match, ml, dist);
  }
}

}  // namespace

extern "C" int qz_parse_inputs(const void* kv, const void* ml_in,
                               const void* dist_in, const void* p_in,
                               const void* lengths, void* p_out,
                               void* is_match, void* ml, void* dist, int rows,
                               int n, int w, int ov, int cap, int rounds,
                               int min_match, int max_match, int seg,
                               int lz4_rules, void* stream) {
  const int form = kv ? kWindows : ml_in ? kRows : kPacked;
  if (rows <= 0 || n <= 0 || seg <= 0 || rounds < 0 || rounds > 20 ||
      cap < 1 || (form == kWindows && (w <= 0 || ov < 0 || ov >= w)) ||
      (form == kRows && !dist_in) || (form == kPacked && !p_in))
    return static_cast<int>(cudaErrorInvalidValue);
  const int own = form == kWindows ? w - ov : 1;
  const Source s{(const int32_t*)kv, (const int32_t*)ml_in,
                 (const int32_t*)dist_in, (const int32_t*)p_in, n, w, ov,
                 own, (n + own - 1) / own};
  const Rules r{(const int32_t*)lengths, min_match, max_match, seg,
                lz4_rules};
  const bool ends = p_out == nullptr;
  const long long halo = (long long)cap * ((1LL << rounds) - 1) + ends;
  if (halo <= kMaxHalo) {
    const int span = min(kSpan, n);
    const int per_row = (n + span - 1) / span;
    const long long blocks = (long long)rows * per_row;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = 2 * (span + halo) * sizeof(int32_t);
    auto kernel = form == kWindows ? parse_inputs_kernel<kWindows>
                  : form == kRows  ? parse_inputs_kernel<kRows>
                                   : parse_inputs_kernel<kPacked>;
    return qz::launch(kernel, (unsigned)blocks, kThreads, smem, stream, s, r,
                      (int32_t*)p_out, (uint8_t*)is_match, (int32_t*)ml,
                      (int32_t*)dist, per_row, span, cap, rounds);
  }
  if (form != kPacked || rounds != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)rows * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  return qz::launch(extend_round_kernel,
                    (unsigned)(blocks < 65536 * 8 ? blocks : 65536 * 8),
                    kThreads, 0, stream, (const int32_t*)p_in, r,
                    (int32_t*)p_out, (uint8_t*)is_match, (int32_t*)ml,
                    (int32_t*)dist, n, total, cap);
}
