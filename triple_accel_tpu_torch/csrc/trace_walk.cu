// K10 trace_walk: the traceback walk of a traced band batch, from each
// pair's (m, n) back to (0, 0) over the packed argmin codes that K4
// (band_distance.cu, TRACE) wrote, emitted as runs of equal steps.
//
// Replaces no Pallas kernel: the JAX package walks in XLA code,
// triple_accel_tpu/ops/band_scan.py:189 _walk_scan (one lax.scan, reached
// by :285 walk_packed_traceback and :233 band_trace_batch).  The port's
// plain version is ops/trace_walk.py trace_walk_plain: band_scan.py's
// walk_packed_traceback (a Python loop of small torch ops a step) and
// run_length_encode of its steps; this kernel takes its place on the
// card.
//
// The function (exactly the plain version's): pair p starts at (i, j) =
// (m, n); while i > 0 or j > 0, and for at most `steps` steps, the code of
// band cell c = clip(j - i + unit_k, 0, W - 1) of row clip(i - 1, 0,
// rows - 1) (cell c at bits 2 * (c % 16) of word c / 16; a row at i == 0
// is an implicit consume-b step) decides the step:
//   0 diagonal: 0 (Match) or 1 (Mismatch) by a[i-1] != b[j-1], i and j
//     down one;  1 consume-b: 2, j down one;  2 consume-a: 3, i down one;
//   3 transpose: 4, i and j down two.
// Characters are read at clip(i - 1, 0, a_stride - 1) of a's row and
// clip(unit_k + j - 1, 0, b_stride - 1) of b's row (b at byte offset
// unit_k).  The steps, in reverse walk order, are written as runs: int32
// count << 3 | step, a new run where the step changes, counts[p] runs for
// pair p in runs[p * steps ..].  steps < 2^28, so no count wraps.
//
// What bounds it on an H100: latency.  Each step's code word depends on
// the step before, so a walk is a chain of dependent loads, about max(m,
// n) to m + n steps a pair; the bytes (a word and two characters a step,
// a word a run) are few.  From device memory or L2 a step took 350-550 ns
// (the step-major kernel before this one, one thread a pair).  Design: a
// group of `lanes` lanes of a warp a pair.  Lane 0 walks; all lanes
// stage the codes the walk needs next into shared memory with cp.async:
// a tile is `tile_rows` rows of the pair's codes x a window of `window`
// words around the walk's band column, with the bytes of a and b that the
// tile's diagonal steps read.  Two tiles a pair: the walker walks one
// while the next (the rows just below it, the window centred where the
// walk entered the current one) lands.  A diagonal or transposition step
// keeps the band column, a consume-b step moves it left one, a consume-a
// step right one, so a walk whose net gaps stay inside the window over a
// tile never waits; one that leaves it sideways (a long gap run), or
// leaves the next tile's window, refills both tiles at once.  Tiles
// abut: a transposition from a tile's lowest row lands in the next one
// (tile_rows >= 2).  The walker's step is then a shared-memory load and
// 32-bit arithmetic (tile bases stay int64), software-pipelined so that
// the run bookkeeping stays off the chain of dependent loads.  Positions
// the tiles cannot hold (i <= 0, a row past the codes or a, a cell
// clipped to the band's edge: never on a walk over K4's codes but its
// last row-0 run) take the exact global-memory step; the row-0 run of
// consume-b steps is emitted at once.  A second kernel joins the pairs'
// runs at their counts' running sums.  The launch shape is the wrapper's
// (ops/trace_walk.py walk_plan, from benches/band_sweep.py --walk).
//
// The group's body is one function over a "group" type, so the host
// rehearsal (host_rehearsal.cpp, -DTA_HOST_REHEARSAL) runs exactly this
// code, the lanes of a group in turn, each lane's copies landing only at
// its waits.

#include "ta_common.cuh"

namespace {

constexpr int TW_CODES_PER_WORD = 16;
constexpr int TW_MAX_THREADS = 256;  // threads a block, at most
constexpr int64_t TW_MAX_STEPS = 1 << 28;  // a run's count fits 28 bits

struct WalkArgs {
  const uint32_t* codes;  // [B, rows, wpr] packed two-bit codes
  const uint8_t* a;       // [B, a_stride]
  const uint8_t* b;       // [B, b_stride], b at byte offset unit_k
  const int32_t* m;       // [B]
  const int32_t* n;       // [B]
  int32_t* runs;          // [B, steps] packed runs
  int32_t* counts;        // [B] runs a pair
  int64_t B, rows, wpr, a_stride, b_stride, steps;
  int32_t unit_k;
  int32_t lanes, tile_rows, window;  // window: words, at most wpr
  int32_t rows_fast;                 // min(rows, a_stride): rows tiles hold
  int32_t buf_words;                 // one tile's shared memory
};

static inline int32_t tw_buf_words(int32_t tile_rows, int32_t window) {
  // 2 window + 1 words of slack, the codes, then a's bytes and b's bytes
  // of the tile's rows and cells as aligned words (three bytes of slack in
  // front of each): the walker loads the step after a tile's last one
  // before it knows the step has left the tile, so every position one
  // step outside a tile (two rows up, one cell aside) reads inside it
  return (2 * window + 1) + tile_rows * window + (tile_rows / 4 + 2) +
         ((tile_rows + 16 * window) / 4 + 2);
}

// The arguments of ta_trace_walk as one struct, or false where the walk
// does not take them (codes a row must be ceil(W / 16) words, b's rows
// hold a's and the band, fewer than 2^28 steps, a group divides a warp,
// tiles of two rows or more; rows and cells under 2^30, so a tile's
// offsets fit 32 bits).
static inline bool trace_walk_args(
    const void* codes, const void* a, const void* b, const void* m,
    const void* n, void* runs, void* counts, int64_t B, int64_t rows,
    int64_t wpr, int64_t a_stride, int64_t b_stride, int unit_k,
    int64_t steps, int lanes, int tile_rows, int window, WalkArgs* g) {
  const int64_t W = 2 * (int64_t)unit_k + 1;
  if (unit_k < 0 || unit_k >= (1 << 29) || rows < 1 || a_stride < 1 ||
      rows >= (1 << 30) || a_stride >= (1 << 30) ||
      b_stride < a_stride + W - 1 || steps < 1 || steps >= TW_MAX_STEPS ||
      wpr != (W + TW_CODES_PER_WORD - 1) / TW_CODES_PER_WORD ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || tile_rows < 2 ||
      tile_rows > 1024 || window < 1 || window > 256)
    return false;
  g->codes = (const uint32_t*)codes;
  g->a = (const uint8_t*)a;
  g->b = (const uint8_t*)b;
  g->m = (const int32_t*)m;
  g->n = (const int32_t*)n;
  g->runs = (int32_t*)runs;
  g->counts = (int32_t*)counts;
  g->B = B;
  g->rows = rows;
  g->wpr = wpr;
  g->a_stride = a_stride;
  g->b_stride = b_stride;
  g->steps = steps;
  g->unit_k = unit_k;
  g->lanes = lanes;
  g->tile_rows = tile_rows;
  g->window = (int32_t)(window < wpr ? window : wpr);
  g->rows_fast = (int32_t)(rows < a_stride ? rows : a_stride);
  g->buf_words = tw_buf_words(tile_rows, g->window);
  return true;
}

static TA_DEV int64_t tw_clip(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The exact step at any position, from device memory: its output, and i
// and j moved.  The walk must not have ended.
static TA_DEV int32_t walk_step_global(const WalkArgs& g, int64_t p,
                                       int64_t& i, int64_t& j) {
  const int64_t W = 2 * (int64_t)g.unit_k + 1;
  const int64_t c = tw_clip(j - i + g.unit_k, 0, W - 1);
  const int64_t row = tw_clip(i - 1, 0, g.rows - 1);
  const uint32_t word =
      g.codes[(p * g.rows + row) * g.wpr + c / TW_CODES_PER_WORD];
  const uint8_t ach = g.a[p * g.a_stride + tw_clip(i - 1, 0, g.a_stride - 1)];
  const uint8_t bch =
      g.b[p * g.b_stride + tw_clip(g.unit_k + j - 1, 0, g.b_stride - 1)];
  const uint32_t code =
      i == 0 ? 1u : (word >> (2 * (c % TW_CODES_PER_WORD))) & 3u;
  const int64_t two = code == 3 ? 2 : 0;
  i -= (int64_t)(code == 0 || code == 2) + two;
  j -= (int64_t)(code == 0 || code == 1) + two;
  return code == 0 ? (int32_t)(ach != bch) : (int32_t)(code + 1);
}

// The walker's runs: the pair's output row, the runs written, the open
// run (count 0: none yet).
struct WalkRuns {
  int32_t* out;
  int32_t n, step, count;
};

// *p = v where `pred` (on the card a predicated store: no branch)
static TA_DEV void tw_store_if(int32_t* p, int32_t v, bool pred) {
#ifdef TA_HOST_REHEARSAL
  if (pred) *p = v;
#else
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q st.global.b32 [%0], %1;\n\t}"
      :: "l"(p), "r"(v), "r"((int)pred) : "memory");
#endif
}

// k more steps `step`: the open run grows, or is written and a new one
// opens
static TA_DEV void runs_push(WalkRuns& w, int32_t step, int32_t k) {
  const bool flush = step != w.step;
  const bool write = flush && w.count != 0;
  tw_store_if(w.out + w.n, (w.count << 3) | w.step, write);
  w.n += (int32_t)write;
  w.count = flush ? k : w.count + k;
  w.step = step;
}

// A staged tile: code rows lo .. lo + nr - 1 (nr <= 0: none) x band cells
// c0 .. c0 + nc - 1 (words w0 .. w0 + window - 1), a's byte of row r at
// shared byte r + a_off of its area, b's byte of (r, c) at r + c + b_off.
struct WalkTile {
  int32_t lo, nr, c0, nc, w0, a_off, b_off;
};

static TA_DEV bool tile_holds(const WalkTile& t, int64_t r, int64_t c) {
  return r >= t.lo && r < (int64_t)t.lo + t.nr && c >= t.c0 &&
         c < (int64_t)t.c0 + t.nc;
}

static TA_DEV uint32_t* tile_codes(const WalkArgs& g, uint32_t* buf) {
  return buf + 2 * g.window + 1;
}

static TA_DEV uint8_t* tile_a(const WalkArgs& g, uint32_t* buf) {
  return (uint8_t*)(tile_codes(g, buf) + g.tile_rows * g.window);
}

static TA_DEV uint8_t* tile_b(const WalkArgs& g, uint32_t* buf) {
  return tile_a(g, buf) + 4 * (g.tile_rows / 4 + 2);
}

// The tile of rows hi - tile_rows + 1 .. hi (those of 0 .. rows_fast - 1)
// and of the window of words centred on band cell c's word.
static TA_DEV WalkTile tile_at(const WalkArgs& g, int64_t p, int64_t hi,
                               int64_t c) {
  WalkTile t;
  const int64_t lo = hi - g.tile_rows + 1 < 0 ? 0 : hi - g.tile_rows + 1;
  const int64_t top = hi < g.rows_fast - 1 ? hi : g.rows_fast - 1;
  t.lo = (int32_t)(lo < g.rows_fast ? lo : g.rows_fast);
  t.nr = (int32_t)(top >= lo ? top - lo + 1 : 0);
  const int64_t W = 2 * (int64_t)g.unit_k + 1;
  const int32_t w0 = (int32_t)tw_clip(c / TW_CODES_PER_WORD - g.window / 2,
                                      0, g.wpr - g.window);
  t.w0 = w0;
  t.c0 = TW_CODES_PER_WORD * w0;
  t.nc = (int32_t)(W - t.c0 < TW_CODES_PER_WORD * g.window
                       ? W - t.c0 : TW_CODES_PER_WORD * g.window);
  const uintptr_t a0 = (uintptr_t)(g.a + p * g.a_stride + t.lo);
  const uintptr_t b0 = (uintptr_t)(g.b + p * g.b_stride + t.lo + t.c0);
  t.a_off = (int32_t)(a0 & 3) - t.lo;
  t.b_off = (int32_t)(b0 & 3) - t.lo - t.c0;
  return t;
}

// Bytes [s, s + nb) into dst from byte (s & 3) on, as the aligned words
// that hold them; a word not wholly inside [lo, hi) (a tensor's edges)
// byte by byte, so nothing outside the tensor is read.
template <class Grp>
static TA_DEV void bytes_issue(const uint8_t* s, int32_t nb, uintptr_t lo,
                               uintptr_t hi, uint8_t* dst, Grp& grp) {
  const uintptr_t first = (uintptr_t)s & ~(uintptr_t)3;
  const int32_t nw = (int32_t)((((uintptr_t)s & 3) + nb + 3) >> 2);
  for (int32_t k = grp.first(); k < nw; k += grp.stride()) {
    const uintptr_t w = first + 4 * (uintptr_t)k;
    if (w >= lo && w + 4 <= hi) {
      grp.copy4((uint32_t*)(dst + 4 * k), (const uint32_t*)w);
    } else {
      for (int q = 0; q < 4; ++q)
        if (w + q >= lo && w + q < hi)
          dst[4 * k + q] = *(const uint8_t*)(w + q);
    }
  }
}

// This lane's share of tile t's copies into buf.
template <class Grp>
static TA_DEV void tile_issue(const WalkArgs& g, int64_t p, const WalkTile& t,
                              uint32_t* buf, Grp& grp) {
  if (t.nr <= 0) return;
  const int32_t X = g.window;
  const uint32_t* src = g.codes + (p * g.rows + t.lo) * g.wpr + t.w0;
  const int32_t n = t.nr * X;
  int32_t row = grp.first() / X, col = grp.first() - row * X;
  uint32_t* dst = tile_codes(g, buf);
  for (int32_t k = grp.first(); k < n; k += grp.stride()) {
    grp.copy4(dst + k, src + (int64_t)row * g.wpr + col);
    for (col += grp.stride(); col >= X; col -= X) ++row;
  }
  const uintptr_t a_lo = (uintptr_t)g.a, b_lo = (uintptr_t)g.b;
  bytes_issue(g.a + p * g.a_stride + t.lo, t.nr, a_lo,
              a_lo + (uintptr_t)(g.B * g.a_stride), tile_a(g, buf), grp);
  bytes_issue(g.b + p * g.b_stride + t.lo + t.c0, t.nr - 1 + t.nc, b_lo,
              b_lo + (uintptr_t)(g.B * g.b_stride), tile_b(g, buf), grp);
}

// The walker's steps inside tile t (staged in buf) from (i, j), until the
// walk leaves the tile or takes its `steps`-th step.  Software-pipelined:
// a step's code decides the next position, whose loads leave (inside the
// tile's slack if the step left it) before the step's run is kept, so the
// chain from load to load is the code's two bits and the address alone.
static TA_DEV void walk_tile(const WalkArgs& g, const WalkTile& t,
                             uint32_t* buf, int64_t& i, int64_t& j,
                             int64_t& s, WalkRuns& runs) {
  const int32_t lo = t.lo, nr = t.nr, c0 = t.c0, nc = t.nc, X = g.window;
  const uint32_t* cs = tile_codes(g, buf) - (lo * X + t.w0);
  const uint8_t* as = tile_a(g, buf) + t.a_off;
  const uint8_t* bs = tile_b(g, buf) + t.b_off;
  int32_t r = (int32_t)(i - 1), c = (int32_t)(j - i + g.unit_k);
  const int32_t left = (int32_t)(g.steps - s);
  int32_t* out = runs.out + runs.n;  // the next run's place
  int32_t step = runs.step, count = runs.count, k = 0;
  if (left > 0 && (uint32_t)(r - lo) < (uint32_t)nr &&
      (uint32_t)(c - c0) < (uint32_t)nc) {
    uint32_t word = cs[r * X + (c >> 4)];
    bool ne = as[r] != bs[r + c];
    bool in;
    do {
      // the code x: 0 diagonal (r, c) -> (r - 1, c), 1 consume-b (r,
      // c - 1), 2 consume-a (r - 1, c + 1), 3 transpose (r - 2, c)
      const int32_t x = (int32_t)((word >> ((c & 15) << 1)) & 3u);
      const int32_t hi = x >> 1, lo_bit = x & 1;
      const int32_t o = x ? x + 1 : (int32_t)ne;
      r += (lo_bit & ~hi) - (lo_bit & hi) - 1;
      c += hi - lo_bit;
      ++k;
      in = k < left && (uint32_t)(r - lo) < (uint32_t)nr &&
           (uint32_t)(c - c0) < (uint32_t)nc;
      word = cs[r * X + (c >> 4)];
      ne = as[r] != bs[r + c];
      const bool flush = o != step;
      const bool write = flush && count != 0;
      tw_store_if(out, (count << 3) | step, write);
      out += write;
      count = flush ? 1 : count + 1;
      step = o;
    } while (in);
  }
  runs.n = (int32_t)(out - runs.out);
  runs.step = step;
  runs.count = count;
  s += k;
  i = (int64_t)r + 1;
  j = (int64_t)c + r + 1 - g.unit_k;
}

// Pair p's walk by one group: `smem` holds its two tiles.  Every lane runs
// this; Grp says which lane walks, issues and waits for the lane's
// copies, joins the group and hands the walker's position to the others.
template <class Grp>
static TA_DEV void walk_pair(const WalkArgs& g, int64_t p, uint32_t* smem,
                             Grp& grp) {
  const int64_t W = 2 * (int64_t)g.unit_k + 1;
  int64_t i = g.m[p], j = g.n[p], s = 0;
  WalkRuns runs{g.runs + p * g.steps, 0, -1, 0};
  WalkTile cur{0, 0, 0, 0, 0, 0, 0}, nxt = cur;
  // cur is staged in `cb`, nxt in `nb` (the two halves of smem)
  uint32_t *cb = smem, *nb = smem + g.buf_words;
  while ((i > 0 || j > 0) && s < g.steps) {
    const int64_t r = i - 1, c = j - i + g.unit_k;
    if (r < 0 || r >= g.rows_fast || c < 0 || c >= W) {
      if (grp.walker()) {
        if (i == 0) {  // the rest is consume-b steps along row 0
          const int64_t k = j < g.steps - s ? j : g.steps - s;
          runs_push(runs, 2, (int32_t)k);
          j -= k;
          s += k;
        } else {
          runs_push(runs, walk_step_global(g, p, i, j), 1);
          ++s;
        }
      }
      grp.bcast(i, j, s);
      continue;
    }
    if (!tile_holds(cur, r, c)) {
      grp.wait_all();
      grp.sync();
      if (tile_holds(nxt, r, c)) {
        // the next tile has landed: walk it, fetch the one below it
        cur = nxt;
        uint32_t* const swap = cb;
        cb = nb;
        nb = swap;
        nxt = tile_at(g, p, (int64_t)cur.lo - 1, c);
        grp.each_lane([&] {
          tile_issue(g, p, nxt, nb, grp);
          grp.commit();
        });
      } else {
        // the walk left the window sideways (or began): both tiles anew
        cur = tile_at(g, p, r, c);
        nxt = tile_at(g, p, (int64_t)cur.lo - 1, c);
        grp.each_lane([&] {
          tile_issue(g, p, cur, cb, grp);
          grp.commit();
          tile_issue(g, p, nxt, nb, grp);
          grp.commit();
          grp.wait_one();
        });
        grp.sync();
      }
    }
    if (grp.walker()) walk_tile(g, cur, cb, i, j, s, runs);
    grp.bcast(i, j, s);
  }
  grp.wait_all();
  if (grp.walker()) {
    if (runs.count) runs.out[runs.n++] = (runs.count << 3) | runs.step;
    g.counts[p] = runs.n;
  }
}

// Pair p's runs from its row of the run buffer to their place in the
// joined output (after the `ends[p] - counts[p]` runs of pairs 0 .. p-1):
// the lanes first, first + stride, ... of the pair's copy.
static TA_DEV void runs_gather(const int32_t* buf, const int32_t* counts,
                               const int64_t* ends, int32_t* out, int64_t p,
                               int64_t steps, int first, int stride) {
  const int32_t n = counts[p];
  int32_t* dst = out + (ends[p] - n);
  const int32_t* src = buf + p * steps;
  for (int32_t k = first; k < n; k += stride) dst[k] = src[k];
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

namespace {

// The lanes of one group of a warp.
struct DevWalkGroup {
  int lane, size;
  unsigned mask;
  __device__ bool walker() const { return lane == 0; }
  __device__ int first() const { return lane; }
  __device__ int stride() const { return size; }
  __device__ void copy4(uint32_t* dst, const uint32_t* src) const {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
  }
  __device__ void commit() const {
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  __device__ void wait_one() const {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  }
  __device__ void wait_all() const {
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  __device__ void sync() const { __syncwarp(mask); }
  template <class F>
  __device__ void each_lane(F f) const { f(); }
  __device__ void bcast(int64_t& i, int64_t& j, int64_t& s) const {
    i = __shfl_sync(mask, i, 0, size);
    j = __shfl_sync(mask, j, 0, size);
    s = __shfl_sync(mask, s, 0, size);
  }
};

}  // namespace

__global__ void __launch_bounds__(TW_MAX_THREADS)
    trace_walk_kernel(WalkArgs g) {
  extern __shared__ __align__(16) uint32_t tw_smem[];
  const int G = g.lanes;
  const int slot = threadIdx.x / G;
  const int64_t p = (int64_t)blockIdx.x * (blockDim.x / G) + slot;
  if (p >= g.B) return;  // a group leaves whole
  const int wl = threadIdx.x & 31;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (wl & ~(G - 1));
  DevWalkGroup grp{(int)(threadIdx.x & (G - 1)), G, mask};
  walk_pair(g, p, tw_smem + (size_t)slot * 2 * g.buf_words, grp);
}

// A warp a pair joins the pairs' runs.
__global__ void __launch_bounds__(256)
    trace_walk_gather_kernel(const int32_t* buf, const int32_t* counts,
                             const int64_t* ends, int32_t* out, int64_t B,
                             int64_t steps) {
  const int64_t p =
      (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (p < B)
    runs_gather(buf, counts, ends, out, p, steps, threadIdx.x & 31, 32);
}

// Plain C entry point.  All pointers are device pointers; nothing is
// allocated or synchronised here.  codes uint32 [B, rows, wpr] with wpr =
// ceil((2 * unit_k + 1) / 16); a uint8 [B, a_stride]; b uint8 [B,
// b_stride]; m, n int32 [B]; runs int32 [B, steps] receives pair p's runs
// in reverse walk order in its first counts[p] entries (nothing else is
// written); counts int32 [B].  `lanes` lanes a pair (1, 2, ..., 32),
// `tile_rows` rows x `window` words a tile, `threads` threads a block (a
// multiple of 32 and of lanes, at most 256).  Returns the cudaError_t of
// the launch.
extern "C" int ta_trace_walk(const void* codes, const void* a, const void* b,
                             const void* m, const void* n, void* runs,
                             void* counts, int64_t B, int64_t rows,
                             int64_t wpr, int64_t a_stride, int64_t b_stride,
                             int unit_k, int64_t steps, int lanes,
                             int tile_rows, int window, int threads,
                             void* stream) {
  if (B <= 0) return 0;
  WalkArgs g;
  if (!trace_walk_args(codes, a, b, m, n, runs, counts, B, rows, wpr,
                       a_stride, b_stride, unit_k, steps, lanes, tile_rows,
                       window, &g) ||
      threads < 32 || threads > TW_MAX_THREADS || threads % 32 ||
      threads % lanes)
    return (int)cudaErrorInvalidValue;
  const int64_t per_block = threads / lanes;
  const int64_t blocks = (B + per_block - 1) / per_block;
  const size_t smem = (size_t)per_block * 2 * g.buf_words * 4;
  if (blocks > 0x7fffffffLL || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  trace_walk_kernel<<<(unsigned)blocks, threads, smem,
                      (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// The second launch of a walk: buf and counts as ta_trace_walk wrote
// them, ends int64 [B] their inclusive sums; out int32 [ends[B - 1]]
// receives pair 0's runs, then pair 1's, ...  Returns the cudaError_t.
extern "C" int ta_trace_walk_gather(const void* buf, const void* counts,
                                    const void* ends, void* out, int64_t B,
                                    int64_t steps, void* stream) {
  if (B <= 0) return 0;
  const int64_t blocks = (B + 7) / 8;
  if (steps < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  trace_walk_gather_kernel<<<(unsigned)blocks, 256, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)buf, (const int32_t*)counts, (const int64_t*)ends,
      (int32_t*)out, B, steps);
  return (int)cudaGetLastError();
}

#endif  // TA_HOST_REHEARSAL
