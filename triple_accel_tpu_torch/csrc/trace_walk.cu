// K10 trace_walk: the traceback walk of a traced band batch, from each
// pair's (m, n) back to (0, 0) over the packed argmin codes that K4
// (band_distance.cu, TRACE) wrote.
//
// Replaces no Pallas kernel: the JAX package walks in XLA code,
// triple_accel_tpu/ops/band_scan.py:189 _walk_scan (one lax.scan, reached
// by :285 walk_packed_traceback and :233 band_trace_batch).  The port's
// plain version is ops/band_scan.py walk_packed_traceback, a Python loop
// of small torch ops a step; this kernel takes its place on the card.
//
// The function (exactly the plain version's): pair p starts at (i, j) =
// (m, n); while i > 0 or j > 0, and for at most `steps` steps, the code of
// band cell c = clip(j - i + unit_k, 0, W - 1) of row clip(i - 1, 0,
// rows - 1) (cell c at bits 2 * (c % 16) of word c / 16; a row at i == 0
// is an implicit consume-b step) decides the step:
//   0 diagonal: emits 0 (Match) or 1 (Mismatch) by a[i-1] != b[j-1], i and
//     j down one;  1 consume-b: emits 2, j down one;  2 consume-a: emits 3,
//     i down one;  3 transpose: emits 4, i and j down two.
// Steps past the end of the walk emit -1.  Characters are read at
// clip(i - 1, 0, a_stride - 1) of a's row and clip(unit_k + j - 1, 0,
// b_stride - 1) of b's row (b at byte offset unit_k).
//
// What bounds it on an H100: latency.  Each step's code word depends on
// the step before, so a walk is a chain of dependent loads, one a step,
// about max(m, n) to m + n steps a pair; the bytes (one word and two
// characters a step, one output byte a step) are few.  Design: one thread
// a pair, i and j in registers, the step's code word and both characters
// requested together (the characters do not wait for the code); blocks of
// one warp, so a small batch spreads over the SMs.  The output is written
// step-major, seq_t [steps, B]: at each step the lanes of a warp store 32
// neighbouring bytes, one sector; the wrapper transposes it to [B, steps]
// on the device.  The wrapper fills seq_t with -1 first; the lanes of a
// warp step together until the warp's longest walk has ended (a lane whose
// walk is over stores -1 meanwhile, so every store stays whole), and the
// warp then leaves the loop instead of running on to `steps`, which bounds
// the longest walk the batch could hold (about 2x to 3.5x the walks of
// the chip_smoke.py phases).  All offsets are int64: a batch's codes pass
// 2^31 words.
//
// The per-step body is a plain function, so the host rehearsal
// (host_rehearsal.cpp, -DTA_HOST_REHEARSAL) runs exactly this arithmetic,
// the lanes of a warp in lockstep.

#include "ta_common.cuh"

namespace {

constexpr int TW_CODES_PER_WORD = 16;
constexpr int TW_THREADS = 32;  // threads a block: one warp

struct WalkArgs {
  const uint32_t* codes;  // [B, rows, wpr] packed two-bit codes
  const uint8_t* a;       // [B, a_stride]
  const uint8_t* b;       // [B, b_stride], b at byte offset unit_k
  const int32_t* m;       // [B]
  const int32_t* n;       // [B]
  int8_t* seq_t;          // [steps, B]
  int64_t B, rows, wpr, a_stride, b_stride, steps;
  int32_t unit_k;
};

// The arguments of ta_trace_walk as one struct, or false where the walk
// does not take them (codes a row must be ceil(W / 16) words).
static inline bool trace_walk_args(const void* codes, const void* a,
                                   const void* b, const void* m,
                                   const void* n, void* seq_t, int64_t B,
                                   int64_t rows, int64_t wpr,
                                   int64_t a_stride, int64_t b_stride,
                                   int unit_k, int64_t steps, WalkArgs* g) {
  if (unit_k < 0 || rows < 1 || a_stride < 1 || b_stride < 1 ||
      wpr != (2 * (int64_t)unit_k + 1 + TW_CODES_PER_WORD - 1) /
                 TW_CODES_PER_WORD)
    return false;
  g->codes = (const uint32_t*)codes;
  g->a = (const uint8_t*)a;
  g->b = (const uint8_t*)b;
  g->m = (const int32_t*)m;
  g->n = (const int32_t*)n;
  g->seq_t = (int8_t*)seq_t;
  g->B = B;
  g->rows = rows;
  g->wpr = wpr;
  g->a_stride = a_stride;
  g->b_stride = b_stride;
  g->steps = steps;
  g->unit_k = unit_k;
  return true;
}

static TA_DEV int64_t tw_clip(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One pair's walk in progress: its rows of codes, a and b, and where it
// stands.
struct PairWalk {
  const uint32_t* cp;
  const uint8_t* ap;
  const uint8_t* bp;
  int64_t i, j;
};

// Pair p's walk at (m, n); `live` false (a lane past the batch) gives a
// walk that has already ended.
static TA_DEV PairWalk walk_begin(const WalkArgs& g, int64_t p, bool live) {
  PairWalk w;
  w.cp = g.codes + p * g.rows * g.wpr;
  w.ap = g.a + p * g.a_stride;
  w.bp = g.b + p * g.b_stride;
  w.i = live ? g.m[p] : 0;
  w.j = live ? g.n[p] : 0;
  return w;
}

static TA_DEV bool walk_done(const PairWalk& w) {
  return w.i <= 0 && w.j <= 0;
}

// One step of the walk: its output, -1 once the walk has ended.
static TA_DEV int8_t walk_step(const WalkArgs& g, PairWalk& w) {
  if (walk_done(w)) return -1;
  const int64_t W = 2 * (int64_t)g.unit_k + 1;
  const int64_t i = w.i, j = w.j;
  const int64_t c = tw_clip(j - i + g.unit_k, 0, W - 1);
  const int64_t row = tw_clip(i - 1, 0, g.rows - 1);
  // the three loads of the step leave together
  const uint32_t word = w.cp[row * g.wpr + c / TW_CODES_PER_WORD];
  const uint8_t ach = w.ap[tw_clip(i - 1, 0, g.a_stride - 1)];
  const uint8_t bch = w.bp[tw_clip(g.unit_k + j - 1, 0, g.b_stride - 1)];
  const uint32_t code =
      i == 0 ? 1u : (word >> (2 * (c % TW_CODES_PER_WORD))) & 3u;
  const int64_t two = code == 3 ? 2 : 0;
  w.i -= (int64_t)(code == 0 || code == 2) + two;
  w.j -= (int64_t)(code == 0 || code == 1) + two;
  return code == 0 ? (int8_t)(ach != bch) : (int8_t)(code + 1);
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

__global__ void __launch_bounds__(TW_THREADS)
    trace_walk_kernel(WalkArgs g) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < g.B;
  PairWalk w = walk_begin(g, live ? p : 0, live);
  for (int64_t s = 0; s < g.steps; ++s) {
    if (__all_sync(0xffffffffu, walk_done(w))) break;
    const int8_t v = walk_step(g, w);
    if (live) g.seq_t[s * g.B + p] = v;
  }
}

// Plain C entry point.  All pointers are device pointers; nothing is
// allocated or synchronised here.  codes uint32 [B, rows, wpr] with wpr =
// ceil((2 * unit_k + 1) / 16); a uint8 [B, a_stride]; b uint8 [B,
// b_stride]; m, n int32 [B]; seq_t int8 [steps, B], which the caller has
// filled with -1, receives the walks in reverse walk order (steps past the
// end of a warp's longest walk are not written).  Returns the cudaError_t
// of the launch.
extern "C" int ta_trace_walk(const void* codes, const void* a, const void* b,
                             const void* m, const void* n, void* seq_t,
                             int64_t B, int64_t rows, int64_t wpr,
                             int64_t a_stride, int64_t b_stride, int unit_k,
                             int64_t steps, void* stream) {
  if (B <= 0 || steps <= 0) return 0;
  WalkArgs g;
  const int64_t blocks = (B + TW_THREADS - 1) / TW_THREADS;
  if (!trace_walk_args(codes, a, b, m, n, seq_t, B, rows, wpr, a_stride,
                       b_stride, unit_k, steps, &g) ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  trace_walk_kernel<<<(unsigned)blocks, TW_THREADS, 0,
                      (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

#endif  // TA_HOST_REHEARSAL
