// K8 flat_search / K9 flat_distance: row-oriented general-cost search with
// match lengths for needles of ANY length, and the anchored general-cost
// distance of pairs of any length, full or banded.
//
// Replaces two TPU kernels of triple_accel_tpu/ops/pallas/search_flat.py:
//   * _make_flat_kernel (flat_search, flat_search_mins,
//     flat_search_gather_selected): here K8, flat_kernel<true, *, C>;
//   * _make_flat_dist_kernel (flat_distance): here K9,
//     flat_kernel<false, *, C>.
// The function is the plain versions' (ops/search_flat.py): row i of the DP
// (needle / a) over columns j (haystack / b), the vertical affine chain and
// the substitution and transposition from the rows above, the horizontal
// affine chain as an EXCLUSIVE prefix over the row's non-horizontal values
// g = nonh - j*gap (and a = nonl - j for the length) with the (min cost,
// max length on ties) combine, then the oracle's final cascade.  The TPU
// ran column chunks as separate launches and carried the edges through
// HBM; here one block walks its item's strips itself, and the edges of a
// row (D and L at the strip's last two columns, and the prefix through its
// last column, as the chain value that reaches that column) wait in device
// memory for the next strip.  Carrying the prefix itself, and not a seed
// rebuilt from the edge D, makes a search result independent of the strip
// width.  Inside a strip the prefix is kept relative to the strip's left
// edge, g = nonh - (j - j0)*gap, so no coordinate grows with the length.
//
// K9 banded (unit_k >= 0): a strip meets only the rows i with
// |i - j| <= unit_k for one of its columns; rows that enter the window
// start from INF edges (out of the band at the strip's left edge), and the
// two rows just above the window, whose cells inside the strip lie out of
// the band, still hand over their REAL edges at the strip's left edge.  The
// JAX kernel seeds those with INF (search_flat.py:575) and loses a path
// that runs along the band's edge; this kernel does not.
//
// What bounds it on an H100: integer operations, one byte a column.  The
// bounds of chip_smoke.py count the oracle's recurrence at the card's best,
// Hopper's fused add-min (DPX) as one operation: K8 24 a cell with lengths
// (K8_OPS_PER_CELL), 6 more with transpositions; K9 7 a cell
// (K9_OPS_PER_CELL = BAND_OPS_PER_CELL), 3 more with transpositions.
// The design keeps every cell's state in registers and lets the warps of a
// block run a strip as a wavefront:
//   * one block per item (segment or pair), W warps, C columns a lane
//     (a template constant): a strip of RJ = 32 * W * C columns, warp w
//     owns the chunk [32wC, 32(w+1)C) of it;
//   * a lane keeps D and L of rows i-1 and i-2 (i-2 only with
//     transpositions), the vertical chain and the strip's characters of its
//     C columns in registers across the row loop; the values from the left
//     that its first columns need come from the lane to its left by
//     __shfl_up_sync, at lane 0 from the warp to the left;
//   * a row is pass 1 (substitution, vertical chain, transposition, the
//     non-horizontal value of each cell, and, with lengths, what the final
//     cascade needs when the chain ties it), a warp scan of the lanes'
//     combines (shuffles), the carry from the warp to the left, then pass 2
//     (the chain and the cascade, in order, from pass 1's registers;
//     without lengths pass 1 folds the chain from the lane's own columns
//     in, so pass 2's columns are independent);
//   * warp w hands warp w + 1 one slot a row in a ring in shared memory,
//     written as soon as its pass 1 and scan have met the carry from warp
//     w-1: the prefix through its last column of row i and its right edge
//     (D and L at its last two columns) of row i-1.  Warp w + 1 waits for
//     that slot (an acquire / release counter a warp) before its own pass
//     1, so the warps run skewed by one hand-over and overlap on
//     successive rows; the chain across them is one combine a warp a row.
//     No block barrier in the row loop; warp 0 reads the edges the last
//     warp wrote in the previous strip once the last warp has got that far;
//   * every cascade and combine is selects on non-short-circuit compares:
//     a branch there made the lanes of a warp diverge;
//   * Hopper's DPX (__viaddmin_s32, __vimin3_s32) for the min chains.
// The passes and the hand-overs are plain functions over one lane's
// registers, so the host rehearsal (host_rehearsal.cpp,
// -DTA_HOST_REHEARSAL) runs exactly this arithmetic, warps in wavefront
// order and lanes in turn, the shuffles and the ring as arrays.

#include <stddef.h>

#include "ta_common.cuh"

namespace {

constexpr int32_t SF_INF = 1 << 30;
constexpr int SF_EDGE_SEARCH = 8;  // D, L, D2, L2, G, A, -, -
constexpr int SF_EDGE_DIST = 4;    // D, D2, G, -
constexpr int SF_RING = 8;         // handoff slots a warp boundary
constexpr int SF_MAX_WARPS = 32;
// rows and columns of an item (ops/search_flat.py: MAX_ITEM_LEN)
constexpr int64_t SF_MAX_LEN = 1 << 30;

// Threads a block at most, by mode and columns a lane (K8: 4 or 8, K9: 4,
// 8 or 16): the register budget under which no variant spills.  `-Xptxas
// -v` on sm_90a (K8 without / with transpositions): K8 97 / 118 registers
// at 4 columns, 119 / 159 at 8; K9 63 / 64 at 4, 99 / 121 at 8, 128 / 156
// at 16.
constexpr int sf_max_threads(bool search, int c) {
  return search ? (c <= 4 ? 512 : 256) : (c <= 8 ? 512 : 256);
}

static TA_DEV int32_t sf_min(int32_t x, int32_t y) { return x < y ? x : y; }
static TA_DEV int32_t sf_max(int32_t x, int32_t y) { return x > y ? x : y; }
static TA_DEV int32_t sf_sat64(int64_t x) {
  return x > SF_INF ? SF_INF : (int32_t)x;
}

#ifdef TA_HOST_REHEARSAL
static inline int32_t sf_addmin(int32_t a, int32_t b, int32_t c) {
  return sf_min(a + b, c);
}
static inline int32_t sf_min3(int32_t a, int32_t b, int32_t c) {
  return sf_min(sf_min(a, b), c);
}
#else
// Hopper's DPX: min(a + b, c) and min(a, b, c), one instruction each
static __device__ __forceinline__ int32_t sf_addmin(int32_t a, int32_t b,
                                                    int32_t c) {
  return __viaddmin_s32(a, b, c);
}
static __device__ __forceinline__ int32_t sf_min3(int32_t a, int32_t b,
                                                  int32_t c) {
  return __vimin3_s32(a, b, c);
}
#endif

// The (min cost, max length on ties) prefix element; without lengths the
// cost alone (a stays 0).
struct SfPre {
  int32_t g, a;
};

// Written with | and & (no short circuit) and selects, so the compiler
// emits no branch: lanes that disagree would diverge.
static TA_DEV SfPre sf_combine(SfPre x, SfPre y) {
  const bool tx = (x.g < y.g) | ((x.g == y.g) & (x.a > y.a));
  SfPre r;
  r.g = sf_min(x.g, y.g);
  r.a = tx ? x.a : y.a;
  return r;
}

template <bool SEARCH>
static TA_DEV SfPre sf_join(SfPre x, SfPre y) {
  return SEARCH ? sf_combine(x, y) : SfPre{sf_min(x.g, y.g), 0};
}

struct SfArgs {
  // search (K8)
  const uint8_t* hay;
  int64_t iter_len;
  const uint8_t* needle;
  int32_t m;
  int64_t own_len, halo;
  const int64_t* segs;
  int32_t anchored;
  int32_t* out_d;
  int32_t* out_l;
  // distance (K9)
  const uint8_t* a;
  const uint8_t* b;
  const int32_t* m_arr;
  const int32_t* n_arr;
  int64_t a_stride, b_stride;
  int32_t unit_k;
  int32_t* out;
  // both
  int32_t mc, gc, sgc, tc;
  int32_t* edges;  // per item: (rows + 2) x SF_EDGE_* ints
};

// One item: rows 1..m over columns 1..ncols (column j reads text[j - 1]);
// the launchers keep an item's rows and columns under 2^30, so they are
// int32 here.
struct SfItem {
  const uint8_t* text;
  int32_t ncols;
  const uint8_t* needle;
  int32_t m;
  int32_t anchored;
  int32_t uk;            // band half-width, -1: none
  int32_t own_lo, own_hi;  // search: owned columns, out index j - own_lo
  int32_t* out_d;
  int32_t* out_l;
  int32_t* edges;
};

template <bool SEARCH>
static TA_DEV SfItem sf_item(const SfArgs& g, int64_t x) {
  SfItem it;
  if (SEARCH) {
    const int64_t c = g.segs[x];
    const int64_t own0 = c * g.own_len;
    int64_t own_end = own0 + g.own_len;
    if (own_end > g.iter_len) own_end = g.iter_len;
    int64_t col0 = own0 - g.halo;
    if (col0 < 0) col0 = 0;
    it.text = g.hay + col0;
    it.ncols = (int32_t)(own_end - col0);
    it.needle = g.needle;
    it.m = g.m;
    it.anchored = g.anchored;
    it.uk = -1;
    it.own_lo = (int32_t)(own0 + 1 - col0);
    it.own_hi = (int32_t)(own_end - col0);
    it.out_d = g.out_d + x * g.own_len;
    it.out_l = g.out_l + x * g.own_len;
    it.edges = g.edges + x * ((int64_t)g.m + 2) * SF_EDGE_SEARCH;
  } else {
    it.text = g.b + x * g.b_stride;
    it.ncols = g.n_arr[x];
    it.needle = g.a + x * g.a_stride;
    it.m = g.m_arr[x];
    // the lengths live on the device, so the launcher cannot check them:
    // a length past its row is cut here, so nothing is read past a row
    if (it.ncols > g.b_stride) it.ncols = (int32_t)g.b_stride;
    if (it.m > g.a_stride) it.m = (int32_t)g.a_stride;
    it.anchored = 1;
    it.uk = g.unit_k;
    it.own_lo = it.own_hi = it.ncols;
    it.out_d = g.out + x;
    it.out_l = nullptr;
    it.edges = g.edges + x * (g.a_stride + 2) * SF_EDGE_DIST;
  }
  return it;
}

// What an item writes before its rows: INF at the owned positions past the
// haystack (K8), or INF for a pair whose cell no strip meets (K9, banded).
// Items whose DP has no row or no column get row 0 or column 0 and are
// done (returns true).  `t`, `T`: this thread and the block's threads.
template <bool SEARCH>
static TA_DEV bool sf_item_start(const SfItem& it, const SfArgs& g, int t,
                                 int T) {
  if (SEARCH) {
    for (int64_t o = (it.own_hi - it.own_lo + 1) + t; o < g.own_len; o += T) {
      it.out_d[o] = SF_INF;
      it.out_l[o] = 0;
    }
    return false;
  }
  if (it.m > 0 && it.ncols > 0) {
    if (t == 0) it.out_d[0] = SF_INF;
    return false;
  }
  const int64_t len = it.m > 0 ? it.m : it.ncols;
  if (t == 0) it.out_d[0] = len > 0 ? sf_sat64(len * (int64_t)g.gc + g.sgc) : 0;
  return true;
}

// D[0][j]: free (0) unless anchored; INF left of column 0.
static TA_DEV int32_t sf_row0(const SfItem& it, const SfArgs& g, int32_t j) {
  if (j < 0) return SF_INF;
  if (!it.anchored || j == 0) return 0;
  return sf_sat64(j * (int64_t)g.gc + g.sgc);
}

// A row's values at a left edge (column jl): D, L at jl and D2, L2 at
// jl - 1, and, at the strip's left edge, the prefix P through column jl as
// the chain cost (without the start cost) and length that reach it, the
// cost saturated at INF.
struct SfEdge {
  int32_t d, l, d2, l2;
  SfPre p;
};

struct SfStrip {
  int32_t j0;        // the strip's columns are j0 + 1 .. j0 + RJ
  int32_t i_lo, i_hi;  // its rows
  int32_t i_hi_prev;   // the last row of the previous strip's window
  int32_t RJ;
  // the previous strip's first row and row count, and the rows run before
  // it: when the last warp wrote its edges (device only)
  int32_t prev_i_lo, prev_rows, prev_tick0;
};

// Row i at the strip's left edge, as the previous strip left it (warp 0).
template <bool SEARCH>
static TA_DEV SfEdge sf_old_edge(const SfItem& it, const SfArgs& g,
                                 const SfStrip& st, int32_t i) {
  SfEdge e;
  e.l = e.l2 = 0;
  e.p.a = 0;
  if (i < 0 || (st.j0 > 0 && i > st.i_hi_prev)) {
    e.d = e.d2 = e.p.g = SF_INF;
  } else if (i == 0) {
    e.d = sf_row0(it, g, st.j0);
    e.d2 = sf_row0(it, g, st.j0 - 1);
    e.p.g = SF_INF;
  } else if (st.j0 == 0) {  // column 0 is the first origin of the chain
    e.d = e.p.g = sf_sat64(i * (int64_t)g.gc + g.sgc);
    e.d2 = SF_INF;
  } else {
    const int32_t* E =
        it.edges + i * (int64_t)(SEARCH ? SF_EDGE_SEARCH : SF_EDGE_DIST);
    if (SEARCH) {
      e.d = E[0];
      e.l = E[1];
      e.d2 = E[2];
      e.l2 = E[3];
      e.p.g = E[4];
      e.p.a = E[5];
    } else {
      e.d = E[0];
      e.d2 = E[1];
      e.p.g = E[2];
    }
  }
  return e;
}

// Row i (i_lo - 1 or i_lo - 2) at the left edge jl >= 2 of a warp other
// than the first, as a strip starts: row 0 or INF, lengths 0.
static TA_DEV SfEdge sf_inner_edge(const SfItem& it, const SfArgs& g,
                                   int32_t jl, int32_t i) {
  SfEdge e = {};
  e.d = i == 0 ? sf_row0(it, g, jl) : SF_INF;
  e.d2 = i == 0 ? sf_row0(it, g, jl - 1) : SF_INF;
  return e;
}

// The strip's rows: all of them, or those that meet the band.
static TA_DEV void sf_window(const SfItem& it, SfStrip& st) {
  st.i_lo = 1;
  st.i_hi = it.m;
  if (it.uk >= 0) {
    const int64_t lo = (int64_t)st.j0 + 1 - it.uk;
    const int64_t hi = (int64_t)st.j0 + st.RJ + it.uk;
    if (lo > st.i_lo) st.i_lo = (int32_t)lo;
    if (hi < st.i_hi) st.i_hi = (int32_t)hi;
  }
}

// What one row needs besides the registers: its index and characters.
struct SfRow {
  int32_t i;
  int32_t nch, npv;  // a[i - 1], a[i - 2]; -1 outside
};

static TA_DEV SfRow sf_row(const SfItem& it, int32_t i) {
  SfRow R;
  R.i = i;
  R.nch = (int32_t)it.needle[i - 1];
  R.npv = i >= 2 ? (int32_t)it.needle[i - 2] : -1;
  return R;
}

// What a lane's first columns need from its left: D and L of row i-1 at
// column jb - 1, of row i-2 at jb - 1 (d2a) and jb - 2 (d2b).
struct SfLeft {
  int32_t d1, l1, d2a, l2a, d2b, l2b;
};

// At a warp's first lane: from the warp's left edges of rows i-1, i-2.
static TA_DEV SfLeft sf_left_of(const SfEdge& e1, const SfEdge& e2) {
  return SfLeft{e1.d, e1.l, e2.d, e2.l, e2.d2, e2.l2};
}

// One lane's C columns jb .. jb + C - 1 of the strip, in registers.
template <bool SEARCH, bool TRANS, int C>
struct SfLane {
  static_assert(C >= 2, "a lane hands over two columns of row i-2");
  int32_t h[C];       // characters (-2 outside the text)
  int32_t hl;         // the character of column jb - 1
  int32_t dp1[C], lp1[C];  // row i-1 (row i after pass 2)
  int32_t dp2[C], lp2[C];  // row i-2 (transpositions only)
  int32_t vg[C], vgl[C];   // the vertical chain and its length
  // pass 1 -> pass 2: the non-horizontal value and length, and, a bit a
  // column, which steps of the cascade reach nonh when the chain ties it
  // (without lengths nonh already holds min(nonh, the chain from the
  // lane's own columns to the left), and pre the lane's combine)
  int32_t nonh[C], nonl[C];
  uint32_t twon, vtie, stie;
  int32_t pre;
  int32_t jb;
  int32_t q1;  // jb - j0: the strip offset (q + 1) of column jb
};

template <bool SEARCH, bool TRANS, int C>
static TA_DEV void sf_lane_init(SfLane<SEARCH, TRANS, C>& L, const SfItem& it,
                                const SfArgs& g, const SfStrip& st,
                                int32_t jb) {
  L.jb = jb;
  L.q1 = (int32_t)(jb - st.j0);
  L.hl = jb - 1 >= 1 && jb - 1 <= it.ncols ? (int32_t)it.text[jb - 2] : -2;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t j = jb + c;
    L.h[c] = j <= it.ncols ? (int32_t)it.text[j - 1] : -2;
    L.dp1[c] = st.i_lo - 1 == 0 ? sf_row0(it, g, j) : SF_INF;
    L.dp2[c] = st.i_lo - 2 == 0 ? sf_row0(it, g, j) : SF_INF;
    L.vg[c] = SF_INF;
    L.lp1[c] = L.lp2[c] = L.vgl[c] = 0;
  }
}

// What the lane hands to the lane on its right.
template <bool SEARCH, bool TRANS, int C>
static TA_DEV SfLeft sf_lane_right(const SfLane<SEARCH, TRANS, C>& L) {
  return SfLeft{L.dp1[C - 1], L.lp1[C - 1], L.dp2[C - 1],
                L.lp2[C - 1], L.dp2[C - 2], L.lp2[C - 2]};
}

// Pass 1: the vertical chain, the substitution, the transposition and the
// non-horizontal value of each column; returns their combine, starting
// from (INF, 0).
template <bool SEARCH, bool TRANS, int C>
static TA_DEV SfPre sf_pass1(SfLane<SEARCH, TRANS, C>& L, const SfArgs& g,
                             const SfRow& R, const SfLeft& in) {
  SfPre agg = {SF_INF, 0};
  const int32_t vnew = g.sgc + g.gc;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t dl = c == 0 ? in.d1 : L.dp1[c - 1];
    const int32_t sub =
        sf_addmin(dl, L.h[c] == R.nch ? 0 : g.mc, SF_INF);
    const int32_t new_v = sf_addmin(L.dp1[c], vnew, SF_INF);
    const int32_t cont_v = sf_addmin(L.vg[c], g.gc, SF_INF);
    const int32_t vg2 = sf_min(new_v, cont_v);
    bool tcond = false;
    int32_t trans = SF_INF, l2s = 0;
    if (TRANS) {
      const int32_t hj2 = c == 0 ? L.hl : L.h[c - 1];
      tcond = (hj2 == R.nch) & (L.h[c] == R.npv);
      const int32_t d2 = c >= 2 ? L.dp2[c - 2] : (c == 1 ? in.d2a : in.d2b);
      trans = tcond ? sf_addmin(d2, g.tc, SF_INF) : SF_INF;
      if (SEARCH)
        l2s = (c >= 2 ? L.lp2[c - 2] : (c == 1 ? in.l2a : in.l2b)) + 2;
    }
    const int32_t qq = L.q1 + c;
    if (SEARCH) {
      const int32_t lsub = (c == 0 ? in.l1 : L.lp1[c - 1]) + 1;
      const int32_t lp = L.lp1[c], vl = L.vgl[c];
      // selects, not branches: every lane runs the same instructions
      int32_t vgl2 = sf_max(lp, vl);
      vgl2 = new_v > cont_v ? vl : vgl2;
      vgl2 = new_v < cont_v ? lp : vgl2;
      const bool stake = (sub < vg2) | ((sub == vg2) & (lsub > vgl2));
      int32_t nonh = stake ? sub : vg2, nonl = stake ? lsub : vgl2;
      const bool twon = TRANS & tcond & (trans <= nonh);
      nonh = twon ? trans : nonh;
      nonl = twon ? l2s : nonl;
      // the cascade when the chain ties nonh: a transposition that won
      // keeps its own; else the vertical step on a longer length of
      // D[i-1][j], then the substitution on a longer length
      const uint32_t bit = 1u << c;
      if (c == 0) L.twon = L.vtie = L.stie = 0;
      L.twon |= twon ? bit : 0u;
      L.vtie |= !twon & (vg2 == nonh) ? bit : 0u;
      L.stie |= !twon & (sub == nonh) ? bit : 0u;
      L.vgl[c] = vgl2;
      L.nonl[c] = nonl;
      L.nonh[c] = nonh;
      agg = sf_combine(agg, SfPre{nonh - qq * g.gc, nonl - qq});
    } else {
      // the chain from the lane's columns to the left folds in here, so
      // pass 2 has only the carry from the left of the lane to add
      const int32_t nonh = TRANS ? sf_min3(vg2, sub, trans) : sf_min(vg2, sub);
      L.nonh[c] = sf_min(nonh, sf_addmin(agg.g, g.sgc + qq * g.gc, SF_INF));
      agg.g = sf_min(agg.g, nonh - qq * g.gc);
    }
    L.vg[c] = vg2;
  }
  L.pre = agg.g;
  return agg;
}

// Pass 2: `run` is the prefix through column jb - 1, relative to the
// strip's left edge; `l1` is L[i-1][jb-1] (in.l1 of pass 1).  The chain,
// the final cascade in the oracle's order and the rows' rotation; returns
// the prefix through the lane's last column.  Without lengths the columns
// need only the carry into the lane (pass 1 folded the rest into nonh).
template <bool SEARCH, bool TRANS, int C>
static TA_DEV SfPre sf_pass2(SfLane<SEARCH, TRANS, C>& L, const SfArgs& g,
                             SfPre run, int32_t l1) {
  int32_t lleft = l1;  // L[i-1] of the column to the left
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t qq = L.q1 + c;
    const int32_t chainc = sf_addmin(run.g, g.sgc + qq * g.gc, SF_INF);
    const int32_t nonh = L.nonh[c];
    const int32_t d = sf_min(chainc, nonh);
    if (SEARCH) {
      const int32_t chainl = run.a + qq;
      const int32_t nonl = L.nonl[c], lp = L.lp1[c];
      const uint32_t bit = 1u << c;
      // the chain ties: the cascade's later steps on longer lengths, or
      // the transposition that won
      int32_t tie = ((L.vtie & bit) != 0) & (lp > chainl) ? L.vgl[c] : chainl;
      tie = (L.stie & bit) ? sf_max(tie, lleft + 1) : tie;
      tie = (L.twon & bit) ? nonl : tie;
      int32_t ln = chainc == nonh ? tie : nonl;
      ln = chainc < nonh ? chainl : ln;
      run = sf_combine(run, SfPre{nonh - qq * g.gc, nonl - qq});
      lleft = lp;
      if (TRANS) L.lp2[c] = lp;
      L.lp1[c] = ln;
    }
    if (TRANS) L.dp2[c] = L.dp1[c];
    L.dp1[c] = d;
  }
  if (!SEARCH) run.g = sf_min(run.g, L.pre);
  return run;
}

// Row m: the lane's columns of the result, D (and L) as pass 2 left them.
template <bool SEARCH, bool TRANS, int C>
static TA_DEV void sf_emit(const SfLane<SEARCH, TRANS, C>& L,
                           const SfItem& it) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t j = L.jb + c;
    if (SEARCH) {
      if (j >= it.own_lo && j <= it.own_hi) {
        it.out_d[j - it.own_lo] = L.dp1[c];
        it.out_l[j - it.own_lo] = L.lp1[c];
      }
    } else if (j == it.ncols) {
      it.out_d[0] = L.dp1[c];
    }
  }
}

// The last lane of the strip writes row i's right edges for the next
// strip; `run` is the prefix through the strip's last column.
template <bool SEARCH, bool TRANS, int C>
static TA_DEV void sf_write_edge(const SfLane<SEARCH, TRANS, C>& L,
                                 const SfArgs& g, const SfItem& it,
                                 const SfStrip& st, int32_t i, SfPre run) {
  int32_t* E =
      it.edges + i * (int64_t)(SEARCH ? SF_EDGE_SEARCH : SF_EDGE_DIST);
  // the prefix as the chain that reaches the last column
  const int32_t pg = sf_sat64((int64_t)run.g + (int64_t)st.RJ * g.gc);
  if (SEARCH) {
    E[0] = L.dp1[C - 1];
    E[1] = L.lp1[C - 1];
    E[2] = L.dp1[C - 2];
    E[3] = L.lp1[C - 2];
    E[4] = pg;
    E[5] = run.a + st.RJ;
  } else {
    E[0] = L.dp1[C - 1];
    E[1] = L.dp1[C - 2];
    E[2] = pg;
  }
}

// The hand-over from warp w to warp w + 1: a ring of SF_RING slots, slot
// t % SF_RING for the t-th row the block runs, written by warp w's lane 31
// once its pass 1 and scan of that row have met the carry from warp w-1.
// `carry`: the prefix through warp w's last column of the row; d, l, d2,
// l2: D and L of the row before at its last two columns.
struct SfSlot {
  SfPre carry;
  int32_t d, l, d2, l2;
};

static TA_DEV SfEdge sf_slot_edge(const SfSlot& s) {
  SfEdge e;
  e.d = s.d;
  e.l = s.l;
  e.d2 = s.d2;
  e.l2 = s.l2;
  e.p = SfPre{SF_INF, 0};
  return e;
}

template <bool SEARCH, bool TRANS, int C>
static TA_DEV void sf_slot_put_edge(SfSlot& s,
                                    const SfLane<SEARCH, TRANS, C>& L) {
  s.d = L.dp1[C - 1];
  s.l = L.lp1[C - 1];
  s.d2 = L.dp1[C - 2];
  s.l2 = L.lp1[C - 2];
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

namespace {

struct SfRing {
  SfSlot slot[SF_MAX_WARPS][SF_RING];
  // per warp: the rows it has run so far; a warp that hands on counts a
  // row once its slot is written (after pass 1), the last warp once the
  // row is done (after pass 2 and the strip's edges).  Either way warp w
  // has then taken warp w-1's slot of that row.
  int pub[SF_MAX_WARPS];
};

static __device__ __forceinline__ unsigned sf_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ int sf_ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v) : "r"(sf_smem_addr(p)) : "memory");
  return v;
}

static __device__ __forceinline__ void sf_st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;"
               :: "r"(sf_smem_addr(p)), "r"(v) : "memory");
}

// All lanes of the warp, together: spin on acquire loads until the count
// reaches `target`; returns the count seen.
static __device__ __forceinline__ int sf_wait(const int* p, int target) {
  int v;
  while ((v = sf_ld_acquire(p)) < target) {
  }
  return v;
}

// Warp 0 reads row r's edges at the strip's left edge once the last warp
// has written them (it wrote row r of the previous strip as that strip's
// (r - prev_i_lo)-th row).
static __device__ __forceinline__ void sf_wait_old_edge(
    const SfRing& ring, int W, const SfStrip& st, int32_t r) {
  if (st.j0 == 0 || r < 1 || r > st.i_hi_prev) return;
  int32_t k = r - st.prev_i_lo + 1;
  k = k < 0 ? 0 : (k > st.prev_rows ? st.prev_rows : k);
  sf_wait(&ring.pub[W - 1], st.prev_tick0 + k);
}

template <bool SEARCH>
static __device__ __forceinline__ SfPre sf_shfl_up(SfPre v, int off) {
  SfPre r;
  r.g = __shfl_up_sync(0xffffffffu, v.g, off);
  r.a = SEARCH ? __shfl_up_sync(0xffffffffu, v.a, off) : 0;
  return r;
}

}  // namespace

template <bool SEARCH, bool TRANS, int C>
__global__ void __launch_bounds__(sf_max_threads(SEARCH, C))
    flat_kernel(SfArgs g) {
  __shared__ SfRing ring;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int W = blockDim.x >> 5;
  const SfItem it = sf_item<SEARCH>(g, blockIdx.x);
  if (sf_item_start<SEARCH>(it, g, t, blockDim.x)) return;  // the block's
  if (t < SF_MAX_WARPS) ring.pub[t] = 0;
  __syncthreads();  // the only block barrier

  SfLane<SEARCH, TRANS, C> L;
  SfStrip st;
  st.RJ = 32 * W * C;
  st.i_hi_prev = 0;
  st.prev_i_lo = 1;
  st.prev_rows = st.prev_tick0 = 0;
  int tick = 0;   // rows this warp has run
  int taken = 0;  // rows warp w + 1 has taken from the ring, as last seen
  for (st.j0 = 0; st.j0 < it.ncols; st.j0 += st.RJ) {
    sf_window(it, st);
    const int32_t jl = st.j0 + w * 32 * C;  // the warp's left edge
    if (jl >= it.ncols) break;  // past the text (the item's last strip)
    const bool last = w == W - 1 || jl + 32 * C >= it.ncols;
    const bool to_next = w == W - 1 && st.j0 + st.RJ < it.ncols;
    sf_lane_init(L, it, g, st, jl + 1 + lane * C);
    // the warp's left edge of rows i-1, i-2 (lane 0 reads them) and, at
    // warp 0, of row i (its prefix is the warp's carry)
    SfEdge e1, e2, ei = {};
    if (w == 0) {
      // rows i_lo - 2 .. i_lo: the last of them that the previous strip has
      sf_wait_old_edge(ring, W, st,
                       st.i_lo < st.i_hi_prev ? st.i_lo : st.i_hi_prev);
      e1 = sf_old_edge<SEARCH>(it, g, st, st.i_lo - 1);
      e2 = sf_old_edge<SEARCH>(it, g, st, st.i_lo - 2);
      ei = sf_old_edge<SEARCH>(it, g, st, st.i_lo);
    } else {
      e1 = sf_inner_edge(it, g, jl, st.i_lo - 1);
      e2 = sf_inner_edge(it, g, jl, st.i_lo - 2);
    }
    SfRow R = st.i_lo <= st.i_hi ? sf_row(it, st.i_lo) : SfRow{};
    const int tick0 = tick;
    for (int32_t i = st.i_lo; i <= st.i_hi; ++i, ++tick) {
      // the carry into the warp: at warp 0 the strip's left edge, else
      // warp w-1's slot of this row, with its right edge of row i-1
      SfPre cin;
      if (w == 0) {
        cin = ei.p;
      } else {
        sf_wait(&ring.pub[w - 1], tick + 1);
        const SfSlot& in_slot = ring.slot[w - 1][tick % SF_RING];
        cin = in_slot.carry;
        if (i > st.i_lo && lane == 0) {
          e2 = e1;
          e1 = sf_slot_edge(in_slot);
        }
      }
      // the next row's characters and, at warp 0, left edges, ahead
      SfRow Rn = R;
      SfEdge en = {};
      if (i < st.i_hi) {
        Rn = sf_row(it, i + 1);
        if (w == 0) {
          sf_wait_old_edge(ring, W, st, i + 1);
          en = sf_old_edge<SEARCH>(it, g, st, i + 1);
        }
      }
      // from the lane on the left, or at lane 0 from the warp on the left
      const SfLeft own = sf_lane_right(L);
      SfLeft in;
      in.d1 = __shfl_up_sync(0xffffffffu, own.d1, 1);
      in.l1 = SEARCH ? __shfl_up_sync(0xffffffffu, own.l1, 1) : 0;
      in.d2a = TRANS ? __shfl_up_sync(0xffffffffu, own.d2a, 1) : 0;
      in.l2a = SEARCH && TRANS ? __shfl_up_sync(0xffffffffu, own.l2a, 1) : 0;
      in.d2b = TRANS ? __shfl_up_sync(0xffffffffu, own.d2b, 1) : 0;
      in.l2b = SEARCH && TRANS ? __shfl_up_sync(0xffffffffu, own.l2b, 1) : 0;
      if (lane == 0) in = sf_left_of(e1, e2);
      const SfPre agg = sf_pass1(L, g, R, in);
      // inclusive scan of the lanes' combines (a lane below `off` meets
      // its own value: the combine keeps it), then exclusive
      SfPre inc = agg;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        inc = sf_join<SEARCH>(sf_shfl_up<SEARCH>(inc, off), inc);
      const SfPre ex = sf_shfl_up<SEARCH>(inc, 1);
      if (!last) {  // hand on the carry and the right edge of row i-1
        if (taken < tick - SF_RING + 1)
          taken = sf_wait(&ring.pub[w + 1], tick - SF_RING + 1);
        __syncwarp();  // every lane is done with warp w-1's slot
        if (lane == 31) {
          SfSlot& out_slot = ring.slot[w][tick % SF_RING];
          out_slot.carry = sf_join<SEARCH>(cin, inc);
          sf_slot_put_edge(out_slot, L);
          sf_st_release(&ring.pub[w], tick + 1);
        }
      }
      const SfPre run =
          sf_pass2(L, g, lane == 0 ? cin : sf_join<SEARCH>(cin, ex), in.l1);
      if (i == it.m) sf_emit(L, it);
      if (last) {  // the row is done: warp w-1 may reuse its slot, and
                   // warp 0 read these edges in the next strip
        if (to_next && lane == 31) sf_write_edge(L, g, it, st, i, run);
        __syncwarp();
        if (lane == 31) sf_st_release(&ring.pub[w], tick + 1);
      }
      if (w == 0) {
        e2 = e1;
        e1 = ei;
        ei = en;
      }
      R = Rn;
    }
    st.prev_i_lo = st.i_lo;
    st.prev_rows = tick - tick0;
    st.prev_tick0 = tick0;
    st.i_hi_prev = st.i_hi;
  }
}

namespace {

template <bool SEARCH, bool TRANS, int C>
static int launch_flat_c(const SfArgs& g, int64_t items, int threads,
                         cudaStream_t stream) {
  if (threads > sf_max_threads(SEARCH, C)) return (int)cudaErrorInvalidValue;
  flat_kernel<SEARCH, TRANS, C><<<(unsigned)items, threads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <bool SEARCH, bool TRANS>
static int launch_flat(const SfArgs& g, int64_t items, int threads, int cols,
                       cudaStream_t stream) {
  switch (cols) {
    case 4: return launch_flat_c<SEARCH, TRANS, 4>(g, items, threads, stream);
    case 8: return launch_flat_c<SEARCH, TRANS, 8>(g, items, threads, stream);
    case 16:  // K9 only: K8's lengths spill at 16 columns a lane
      return SEARCH ? (int)cudaErrorInvalidValue
                    : launch_flat_c<false, TRANS, 16>(g, items, threads,
                                                      stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

static bool sf_threads_ok(int threads) {
  return threads >= 32 && threads <= 32 * SF_MAX_WARPS && (threads & 31) == 0;
}

}  // namespace

// Plain C entry points.  All pointers are device pointers; nothing is
// allocated or synchronised here.  Each returns the cudaError_t of the
// launch.  threads: a multiple of 32 (warps a block); cols: columns a lane,
// 4 or 8 (K8), 4, 8 or 16 (K9).
//
// K8.  hay: the raw haystack [iter_len]; needle: [m] bytes, m >= 1; segs:
// int64 [items] segment indices; out_d / out_l: int32 [items, own_len]
// (entry (x, o): end position segs[x]*own_len + o + 1; INF past the
// haystack); edges: int32 [items, m + 2, 8] scratch.
extern "C" int ta_flat_search(const void* hay, int64_t iter_len,
                              const void* needle, int m, int64_t own_len,
                              int64_t halo, const void* segs, int64_t items,
                              int anchored, int mc, int gc, int sgc, int tc,
                              int transpose, void* out_d, void* out_l,
                              void* edges, int threads, int cols,
                              void* stream) {
  if (items <= 0) return 0;
  if (m < 1 || m > SF_MAX_LEN || own_len < 1 || halo < 0 || iter_len < 0 ||
      own_len + halo > SF_MAX_LEN || items > 2147483647LL ||
      !sf_threads_ok(threads))
    return (int)cudaErrorInvalidValue;
  SfArgs g = {};
  g.hay = (const uint8_t*)hay;
  g.iter_len = iter_len;
  g.needle = (const uint8_t*)needle;
  g.m = m;
  g.own_len = own_len;
  g.halo = halo;
  g.segs = (const int64_t*)segs;
  g.anchored = anchored;
  g.out_d = (int32_t*)out_d;
  g.out_l = (int32_t*)out_l;
  g.mc = mc;
  g.gc = gc;
  g.sgc = sgc;
  g.tc = tc;
  g.edges = (int32_t*)edges;
  cudaStream_t st = (cudaStream_t)stream;
  return transpose ? launch_flat<true, true>(g, items, threads, cols, st)
                   : launch_flat<true, false>(g, items, threads, cols, st);
}

// K9.  a: [B, a_stride] row strings, b: [B, b_stride] column strings, m / n:
// int32 [B] (cut to the strides); unit_k: the band half-width, -1 for the
// full matrix; out: int32 [B]; edges: int32 [B, a_stride + 2, 4] scratch.
extern "C" int ta_flat_distance(const void* a, const void* b, const void* m,
                                const void* n, int64_t B, int64_t a_stride,
                                int64_t b_stride, int unit_k, int mc, int gc,
                                int sgc, int tc, int transpose, void* out,
                                void* edges, int threads, int cols,
                                void* stream) {
  if (B <= 0) return 0;
  if (a_stride < 1 || b_stride < 1 || a_stride > SF_MAX_LEN ||
      b_stride > SF_MAX_LEN || B > 2147483647LL || unit_k < -1 ||
      !sf_threads_ok(threads))
    return (int)cudaErrorInvalidValue;
  SfArgs g = {};
  g.a = (const uint8_t*)a;
  g.b = (const uint8_t*)b;
  g.m_arr = (const int32_t*)m;
  g.n_arr = (const int32_t*)n;
  g.a_stride = a_stride;
  g.b_stride = b_stride;
  g.unit_k = unit_k;
  g.out = (int32_t*)out;
  g.mc = mc;
  g.gc = gc;
  g.sgc = sgc;
  g.tc = tc;
  g.edges = (int32_t*)edges;
  cudaStream_t st = (cudaStream_t)stream;
  return transpose ? launch_flat<false, true>(g, B, threads, cols, st)
                   : launch_flat<false, false>(g, B, threads, cols, st);
}

#endif  // TA_HOST_REHEARSAL
