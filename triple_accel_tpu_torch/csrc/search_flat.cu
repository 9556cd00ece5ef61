// K8 flat_search / K9 flat_distance: row-oriented general-cost search with
// match lengths for needles of ANY length, and the anchored general-cost
// distance of pairs of any length, full or banded.
//
// Replaces two TPU kernels of triple_accel_tpu/ops/pallas/search_flat.py:
//   * _make_flat_kernel (flat_search, flat_search_mins,
//     flat_search_gather_selected): here K8, flat_kernel<true, *>;
//   * _make_flat_dist_kernel (flat_distance): here K9, flat_kernel<false, *>.
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
// What bounds it on an H100: integer operations, about 30 a cell with
// lengths (K8) and 12 without (K9) at the card's best (chip_smoke.py:
// K8_OPS_*, K9_OPS_*), against one byte a column.  The design (first
// version: right and simple, not yet fast), the band kernel's
// (csrc/band_distance.cu) with fixed columns instead of a sliding band:
//   * one block per item (segment or pair), T threads, 4 columns a thread:
//     a strip of 4T columns whose rows (D, L of three rows, the vertical
//     chain) live in shared memory;
//   * a row is two passes and two block barriers: pass 1 forms the
//     substitution, the vertical chain, the transposition and the
//     non-horizontal value of each cell and each thread's combine of them;
//     a warp scan (shuffles) plus one word pair per warp give each thread
//     its exclusive prefix; pass 2 runs the chain and the cascade in order;
//   * thread 0 holds the left edges of the two rows above in registers,
//     the last thread writes the row's right edges.
// The passes are plain functions over a thread's columns, so the host
// rehearsal (host_rehearsal.cpp, -DTA_HOST_REHEARSAL) runs exactly this
// arithmetic one "thread" at a time.

#include <stddef.h>

#include "ta_common.cuh"

namespace {

constexpr int32_t SF_INF = 1 << 30;
constexpr int SF_CPT = 4;  // columns a thread
constexpr int SF_EDGE_SEARCH = 8;  // D, L, D2, L2, G, A, -, -
constexpr int SF_EDGE_DIST = 4;    // D, D2, G, -
constexpr int SF_SEARCH_MAX_THREADS = 256;

static TA_DEV int32_t sf_min(int32_t x, int32_t y) { return x < y ? x : y; }
static TA_DEV int32_t sf_max(int32_t x, int32_t y) { return x > y ? x : y; }
static TA_DEV int32_t sf_sat64(int64_t x) {
  return x > SF_INF ? SF_INF : (int32_t)x;
}

// The (min cost, max length on ties) prefix element; LEN false: cost only.
struct SfPre {
  int32_t g, a;
};

static TA_DEV SfPre sf_combine(SfPre x, SfPre y) {
  return (x.g < y.g || (x.g == y.g && x.a > y.a)) ? x : y;
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

// One item: rows 1..m over columns 1..ncols (column j reads text[j - 1]).
struct SfItem {
  const uint8_t* text;
  int64_t ncols;
  const uint8_t* needle;
  int32_t m;
  int32_t anchored;
  int64_t uk;            // band half-width, -1: none
  int64_t own_lo, own_hi;  // search: owned columns, out index j - own_lo
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
    it.ncols = own_end - col0;
    it.needle = g.needle;
    it.m = g.m;
    it.anchored = g.anchored;
    it.uk = -1;
    it.own_lo = own0 + 1 - col0;
    it.own_hi = own_end - col0;
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
    if (it.ncols > g.b_stride) it.ncols = g.b_stride;
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

// D[0][j]: free (0) unless anchored; INF left of column 0.
static TA_DEV int32_t sf_row0(const SfItem& it, const SfArgs& g, int64_t j) {
  if (j < 0) return SF_INF;
  if (!it.anchored || j == 0) return 0;
  return sf_sat64(j * (int64_t)g.gc + g.sgc);
}

// A row's edges at the strip's left edge: D, L at column j0 and D2, L2 at
// j0 - 1, and the prefix P through column j0 as the chain cost (without the
// start cost) and length that reach column j0, the cost saturated at INF.
struct SfEdge {
  int32_t d, l, d2, l2;
  SfPre p;
};

struct SfStrip {
  int64_t j0;        // the strip's columns are j0 + 1 .. j0 + RJ
  int64_t i_lo, i_hi;  // its rows
  int64_t i_hi_prev;   // the last row of the previous strip's window
  int RJ;
};

template <bool SEARCH>
static TA_DEV SfEdge sf_old_edge(const SfItem& it, const SfArgs& g,
                                 const SfStrip& st, int64_t i) {
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

// Shared memory of one block: three rows of D (and of L), the vertical
// chain (and its length), the strip's characters with two columns of lead.
struct SfState {
  int32_t *dp2, *dp1, *cur;  // rows i-2, i-1, i
  int32_t *lp2, *lp1, *lcur;
  int32_t *vg, *vgl;
  int32_t* ch;  // ch[q + 2] = column j0 + 1 + q, ch[0..1] = j0 - 1, j0
};

static inline size_t sf_smem_ints(int RJ, bool search) {
  return (size_t)(search ? 8 : 4) * RJ + (RJ + 2) + 2 * 32 + 8;
}

// The rows over `smem` (sf_smem_ints ints); *tot gets the word pair a warp
// of the scan, then one pair for the row's prefix through column j0.
template <bool SEARCH>
static TA_DEV SfState sf_state(int32_t* smem, int RJ, SfPre** tot) {
  SfState S;
  S.dp2 = smem;
  S.dp1 = S.dp2 + RJ;
  S.cur = S.dp1 + RJ;
  S.vg = S.cur + RJ;
  if (SEARCH) {
    S.lp2 = S.vg + RJ;
    S.lp1 = S.lp2 + RJ;
    S.lcur = S.lp1 + RJ;
    S.vgl = S.lcur + RJ;
    S.ch = S.vgl + RJ;
  } else {
    S.lp2 = S.lp1 = S.lcur = S.vgl = nullptr;
    S.ch = S.vg + RJ;
  }
  *tot = reinterpret_cast<SfPre*>(S.ch + RJ + 2);
  return S;
}

// What one row needs besides the shared rows.
struct SfRow {
  int64_t i;
  int32_t nch, npv;       // a[i - 1], a[i - 2]; -1 outside
  SfEdge e1, e2;          // rows i-1, i-2 at the left edge
  SfPre p;                // row i's prefix through column j0
};

// Strip set-up over columns [q_lo, q_hi): characters, rows i_lo - 1 and
// i_lo - 2 inside the strip (INF, or row 0), an empty vertical chain.
template <bool SEARCH>
static TA_DEV void sf_strip_init(const SfItem& it, const SfArgs& g,
                                 const SfStrip& st, const SfState& S,
                                 int q_lo, int q_hi, bool lead) {
  for (int q = q_lo; q < q_hi; ++q) {
    const int64_t j = st.j0 + 1 + q;
    S.ch[q + 2] = j <= it.ncols ? (int32_t)it.text[j - 1] : -2;
    S.dp1[q] = st.i_lo - 1 == 0 ? sf_row0(it, g, j) : SF_INF;
    S.dp2[q] = st.i_lo - 2 == 0 ? sf_row0(it, g, j) : SF_INF;
    S.vg[q] = SF_INF;
    if (SEARCH) {
      S.lp1[q] = S.lp2[q] = 0;
      S.vgl[q] = 0;
    }
  }
  if (lead) {
    S.ch[0] = st.j0 >= 2 && st.j0 - 1 <= it.ncols
                  ? (int32_t)it.text[st.j0 - 2] : -2;
    S.ch[1] = st.j0 >= 1 && st.j0 <= it.ncols
                  ? (int32_t)it.text[st.j0 - 1] : -2;
  }
}

// What pass 1 and pass 2 both form for one cell.
struct SfCell {
  int32_t sub, lsub, trans, l2s;
  bool tcond;
};

template <bool SEARCH, bool TRANS>
static TA_DEV SfCell sf_cell(const SfArgs& g, const SfState& S,
                             const SfRow& R, int q) {
  SfCell c;
  const int32_t hj1 = S.ch[q + 2], hj2 = S.ch[q + 1];
  const int32_t dl = q == 0 ? R.e1.d : S.dp1[q - 1];
  c.sub = sf_min(dl + (hj1 == R.nch ? 0 : g.mc), SF_INF);
  c.lsub = SEARCH ? (q == 0 ? R.e1.l : S.lp1[q - 1]) + 1 : 0;
  c.tcond = false;
  c.trans = SF_INF;
  c.l2s = 0;
  if (TRANS) {
    c.tcond = hj2 == R.nch && hj1 == R.npv;
    if (c.tcond) {
      const int32_t d2 = q >= 2 ? S.dp2[q - 2] : (q == 1 ? R.e2.d : R.e2.d2);
      c.trans = sf_min(d2 + g.tc, SF_INF);
      if (SEARCH)
        c.l2s = (q >= 2 ? S.lp2[q - 2] : (q == 1 ? R.e2.l : R.e2.l2)) + 2;
    }
  }
  return c;
}

// Pass 1 over columns [q_lo, q_hi): the vertical chain into vg / vgl, the
// non-horizontal value and length into cur / lcur; returns their combine.
template <bool SEARCH, bool TRANS>
static TA_DEV SfPre sf_pass1(const SfArgs& g, const SfState& S,
                             const SfRow& R, int q_lo, int q_hi) {
  SfPre agg = {SF_INF, 0};
  for (int q = q_lo; q < q_hi; ++q) {
    const SfCell c = sf_cell<SEARCH, TRANS>(g, S, R, q);
    const int32_t new_v = sf_min(S.dp1[q] + (g.sgc + g.gc), SF_INF);
    const int32_t cont_v = sf_min(S.vg[q] + g.gc, SF_INF);
    const int32_t vg2 = sf_min(new_v, cont_v);
    int32_t nonh = vg2, nonl = 0;
    if (SEARCH) {
      const int32_t lp = S.lp1[q], vl = S.vgl[q];
      const int32_t vgl2 = new_v < cont_v   ? lp
                           : new_v > cont_v ? vl
                                            : sf_max(lp, vl);
      S.vgl[q] = vgl2;
      nonl = vgl2;
      if (c.sub < nonh || (c.sub == nonh && c.lsub > nonl)) {
        nonh = c.sub;
        nonl = c.lsub;
      }
      if (TRANS && c.tcond && c.trans <= nonh) {
        nonh = c.trans;
        nonl = c.l2s;
      }
      S.lcur[q] = nonl;
    } else {
      nonh = sf_min(sf_min(vg2, c.sub), c.trans);
    }
    S.vg[q] = vg2;
    S.cur[q] = nonh;
    const SfPre e = {nonh - (q + 1) * g.gc, nonl - (q + 1)};
    agg = SEARCH ? sf_combine(agg, e) : SfPre{sf_min(agg.g, e.g), 0};
  }
  return agg;
}

// Pass 2 over columns [q_lo, q_hi): `run` is the prefix through column
// j0 + q_lo, relative to column j0.  The chain, the final cascade in the oracle's order, the row's
// right edges and the emission.
template <bool SEARCH, bool TRANS>
static TA_DEV void sf_pass2(const SfArgs& g, const SfItem& it,
                            const SfState& S, const SfStrip& st,
                            const SfRow& R, int q_lo, int q_hi, SfPre run) {
  const int E = SEARCH ? SF_EDGE_SEARCH : SF_EDGE_DIST;
  int32_t* edge = it.edges + R.i * (int64_t)E;
  for (int q = q_lo; q < q_hi; ++q) {
    const int64_t j = st.j0 + 1 + q;
    const int32_t chainc = sf_sat64((int64_t)run.g + g.sgc + (q + 1) * g.gc);
    const int32_t nonh = S.cur[q];
    int32_t d, ln = 0;
    if (SEARCH) {
      const SfCell c = sf_cell<SEARCH, TRANS>(g, S, R, q);
      const int32_t vg2 = S.vg[q], vgl2 = S.vgl[q], lp = S.lp1[q];
      const int32_t nonl = S.lcur[q];
      d = chainc;
      ln = run.a + (q + 1);
      if (vg2 < d || (vg2 == d && lp > ln)) {
        d = vg2;
        ln = vgl2;
      }
      if (c.sub < d || (c.sub == d && c.lsub > ln)) {
        d = c.sub;
        ln = c.lsub;
      }
      if (TRANS && c.tcond && c.trans <= d) {
        d = c.trans;
        ln = c.l2s;
      }
      d = sf_min(d, SF_INF);
      run = sf_combine(run, SfPre{nonh - (q + 1) * g.gc, nonl - (q + 1)});
      S.lcur[q] = ln;
    } else {
      d = sf_min(chainc, nonh);
      run.g = sf_min(run.g, nonh - (q + 1) * g.gc);
    }
    S.cur[q] = d;
    if (q == st.RJ - 2) {
      edge[SEARCH ? 2 : 1] = d;
      if (SEARCH) edge[3] = ln;
    } else if (q == st.RJ - 1) {
      // the prefix as the chain that reaches this column
      const int32_t pg = sf_sat64((int64_t)run.g + (int64_t)st.RJ * g.gc);
      edge[0] = d;
      if (SEARCH) {
        edge[1] = ln;
        edge[4] = pg;
        edge[5] = run.a + st.RJ;
      } else {
        edge[2] = pg;
      }
    }
    if (R.i == it.m) {
      if (SEARCH) {
        if (j >= it.own_lo && j <= it.own_hi) {
          it.out_d[j - it.own_lo] = d;
          it.out_l[j - it.own_lo] = ln;
        }
      } else if (j == it.ncols) {
        it.out_d[0] = d;
      }
    }
  }
}

static TA_DEV void sf_rotate(SfState& S) {
  int32_t* t = S.dp2;
  S.dp2 = S.dp1;
  S.dp1 = S.cur;
  S.cur = t;
  t = S.lp2;
  S.lp2 = S.lp1;
  S.lp1 = S.lcur;
  S.lcur = t;
}

// The strip's rows: all of them, or those that meet the band.
static TA_DEV void sf_window(const SfItem& it, SfStrip& st) {
  st.i_lo = 1;
  st.i_hi = it.m;
  if (it.uk >= 0) {
    const int64_t lo = st.j0 + 1 - it.uk, hi = st.j0 + st.RJ + it.uk;
    if (lo > st.i_lo) st.i_lo = lo;
    if (hi < st.i_hi) st.i_hi = hi;
  }
}

// Items whose DP has no row or no column: row 0 or column 0 is the answer.
template <bool SEARCH>
static TA_DEV bool sf_trivial(const SfItem& it, const SfArgs& g) {
  if (SEARCH || (it.m > 0 && it.ncols > 0)) return false;
  const int64_t len = it.m > 0 ? it.m : it.ncols;
  it.out_d[0] = len > 0 ? sf_sat64(len * (int64_t)g.gc + g.sgc) : 0;
  return true;
}

static TA_DEV SfRow sf_row_start(const SfItem& it, int64_t i,
                                 const SfEdge& e1, const SfEdge& e2) {
  SfRow R;
  R.i = i;
  R.nch = (int32_t)it.needle[i - 1];
  R.npv = i >= 2 ? (int32_t)it.needle[i - 2] : -1;
  R.e1 = e1;
  R.e2 = e2;
  return R;
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

template <bool SEARCH, bool TRANS>
__global__ void __launch_bounds__(SEARCH ? SF_SEARCH_MAX_THREADS : 1024)
    flat_kernel(SfArgs g) {
  extern __shared__ int32_t sf_smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = T >> 5;
  const int RJ = T * SF_CPT;
  const int q_lo = t * SF_CPT, q_hi = q_lo + SF_CPT;
  const SfItem it = sf_item<SEARCH>(g, blockIdx.x);
  if (SEARCH) {  // owned positions past the haystack
    for (int64_t o = (it.own_hi - it.own_lo + 1) + t; o < g.own_len; o += T) {
      it.out_d[o] = SF_INF;
      it.out_l[o] = 0;
    }
  } else if (sf_trivial<SEARCH>(it, g)) {
    return;  // the whole block: the item is the block's
  } else if (t == 0) {
    it.out_d[0] = SF_INF;  // a pair whose cell no strip meets (banded)
  }
  SfPre* tot;  // a pair a warp
  SfState S = sf_state<SEARCH>(sf_smem, RJ, &tot);
  SfPre* prow = tot + 32;  // row i's prefix through column j0

  SfStrip st;
  st.RJ = RJ;
  st.i_hi_prev = 0;
  for (st.j0 = 0; st.j0 < it.ncols; st.j0 += RJ) {
    sf_window(it, st);
    sf_strip_init<SEARCH>(it, g, st, S, q_lo, q_hi, t == 0);
    SfEdge e1 = {}, e2 = {};
    if (t == 0) {
      e1 = sf_old_edge<SEARCH>(it, g, st, st.i_lo - 1);
      e2 = sf_old_edge<SEARCH>(it, g, st, st.i_lo - 2);
    }
    __syncthreads();
    for (int64_t i = st.i_lo; i <= st.i_hi; ++i) {
      SfRow R = sf_row_start(it, i, e1, e2);
      SfEdge ei = {};
      if (t == 0) {
        ei = sf_old_edge<SEARCH>(it, g, st, i);  // read before pass 2
        *prow = ei.p;
      }
      const SfPre agg = sf_pass1<SEARCH, TRANS>(g, S, R, q_lo, q_hi);
      // warp inclusive scan of the threads' combines, then exclusive
      SfPre inc = agg;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        SfPre v;
        v.g = __shfl_up_sync(0xffffffffu, inc.g, off);
        v.a = __shfl_up_sync(0xffffffffu, inc.a, off);
        if (lane >= off) inc = sf_combine(v, inc);
      }
      SfPre ex;
      ex.g = __shfl_up_sync(0xffffffffu, inc.g, 1);
      ex.a = __shfl_up_sync(0xffffffffu, inc.a, 1);
      if (lane == 0) ex = SfPre{SF_INF, 0};
      if (lane == 31) tot[warp] = inc;
      __syncthreads();
      SfPre run = sf_combine(*prow, ex);
      for (int w = 0; w < warp && w < nwarps; ++w) run = sf_combine(run, tot[w]);
      sf_pass2<SEARCH, TRANS>(g, it, S, st, R, q_lo, q_hi, run);
      __syncthreads();
      sf_rotate(S);
      if (t == 0) {
        e2 = e1;
        e1 = ei;
      }
    }
    st.i_hi_prev = st.i_hi;
    __syncthreads();  // the next strip's set-up overwrites the rows
  }
}

template <bool SEARCH, bool TRANS>
static int launch_flat(const SfArgs& g, int64_t items, int threads,
                       cudaStream_t stream) {
  const size_t smem =
      sf_smem_ints(threads * SF_CPT, SEARCH) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flat_kernel<SEARCH, TRANS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flat_kernel<SEARCH, TRANS>
      <<<(unsigned)items, threads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

static bool sf_threads_ok(int threads) {
  return threads >= 64 && threads <= 1024 && (threads & 31) == 0;
}

// Plain C entry points.  All pointers are device pointers; nothing is
// allocated or synchronised here.  Each returns the cudaError_t of the
// launch.
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
                              void* edges, int threads, void* stream) {
  if (items <= 0) return 0;
  if (m < 1 || own_len < 1 || halo < 0 || iter_len < 0 ||
      items > 2147483647LL || !sf_threads_ok(threads) ||
      threads > SF_SEARCH_MAX_THREADS)
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
  return transpose ? launch_flat<true, true>(g, items, threads, st)
                   : launch_flat<true, false>(g, items, threads, st);
}

// K9.  a: [B, a_stride] row strings, b: [B, b_stride] column strings, m / n:
// int32 [B] (cut to the strides); unit_k: the band half-width, -1 for the
// full matrix; out: int32 [B]; edges: int32 [B, a_stride + 2, 4] scratch.
extern "C" int ta_flat_distance(const void* a, const void* b, const void* m,
                                const void* n, int64_t B, int64_t a_stride,
                                int64_t b_stride, int unit_k, int mc, int gc,
                                int sgc, int tc, int transpose, void* out,
                                void* edges, int threads, void* stream) {
  if (B <= 0) return 0;
  if (a_stride < 1 || b_stride < 1 || B > 2147483647LL || unit_k < -1 ||
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
  return transpose ? launch_flat<false, true>(g, B, threads, st)
                   : launch_flat<false, false>(g, B, threads, st);
}

#endif  // TA_HOST_REHEARSAL
