// K3 band_distance / K4 band_trace: banded general-cost edit distance
// (mismatch, affine gap, transposition costs), without and with the argmin
// codes a traceback needs.
//
// Replaces the four TPU kernels of triple_accel_tpu/ops/pallas/lev_band.py:
// _make_kernel and _make_tiled_kernel (band_distance_pallas[_tiled]) become
// the untraced kernels below, _make_trace_kernel and
// _make_tiled_trace_kernel (band_trace_pallas[_tiled]) the traced ones.
// The TPU split "untiled / row-strip tiled" existed because its fast memory
// had to hold the strings; here the characters stream from global memory
// row by row, so a pair of any length runs through the same kernel.
//
// The function (the same the plain version ops/band_scan.py computes): DP
// cell (i, j) over a (rows, m) x b (columns, n), m <= n, restricted to the
// band |j - i| <= unit_k; band cell c in [0, W), W = 2*unit_k + 1, holds
// j = i + c - unit_k.  Per row: substitution from cell c of the previous
// row, vertical affine gap from cell c+1, transposition from cell c two
// rows back, then the horizontal affine chain as an EXCLUSIVE prefix-min of
// dprime - c*gap over the row, and a selection cascade that fixes the
// tie-breaks (sub default, horizontal on <, vertical on <, transpose on
// <=).  The result is row m, cell clip(n - m + unit_k, 0, W - 1); m == 0
// finishes on row 0.  Pads of the string buffers may equal real characters
// (also NUL): every compare a pad could win is masked by the cell's
// validity 0 <= j <= n or meets an infinite predecessor.
//
// What bounds it on an H100: integer operations, not bytes.  A cell needs
// 7 operations at the card's best (10 with transposition, 6 or 7 more for
// the code; chip_smoke.py's BAND_OPS_* list them) against 2 / W bytes of
// strings, and the traced kernel writes 2 bits per cell.
//
// Three regimes, one function (the plan, ops/lev_band.py band_plan, picks):
//   * band_kernel<TRANS, TRACE, C>, every band up to 32 * 17 = 544 cells
//     (all of chip_smoke.py's phases: 65, 129 and 513 cells).  A group of
//     G = 8, 16 or 32 lanes of one warp owns one pair (32 / G pairs a
//     warp), lane l the C consecutive cells [l*C, (l+1)*C) (C = 3, 5, 9 or
//     17, a template constant; cells past W are "ghosts", held at INF).  A
//     lane keeps D of rows i-1 and i-2 (i-2 only with transpositions), the
//     vertical-gap state and b's bytes of its cells in registers across the
//     row loop; the row loop has no block barrier and touches no shared
//     memory.  A row: the lane to the right hands over its first cell of
//     row i-1 (D and gap state, __shfl_down_sync within the group's width);
//     pass 1 forms sub, the vertical gap, the transposition and dprime and
//     runs the horizontal chain over the lane's own cells; a shuffle scan
//     over the group (log2 G steps) gives each lane the chain that enters
//     it; pass 2 runs the chain with that carry and the cascade.  The chain
//     is kept as F[c] = min over c' < c of dprime[c'] + (c - 1 - c')*gap,
//     F[c+1] = min(F[c] + gap, dprime[c]): one fused add-min a cell, and
//     e[c] = F[c] + gap + start.  The band's window moves one byte right a
//     row: a lane's new last byte is the first byte of the lane to its
//     right (__shfl_down_sync), the group's last lane streams it from b, the
//     byte left of its first cell is its old first byte.  Lane 0 of the
//     group streams a.  Codes: a lane packs its C two-bit codes into one
//     word and the group's lanes join them into the row's 32-bit words by
//     shuffles (cell c at bits 2 * (c % 16) of word c / 16, the layout of
//     the plain version), lane w writing word w: one coalesced row.
//   * band_block_kernel<TRANS, TRACE, C, MAXW>, the bands past that up to
//     9,291 cells (the bands the earlier shared-memory body took: every
//     untraced batch past unit_k 256, traced ones from unit_k 272 to
//     4,640, the front door's `levenshtein()` / `rdamerau()` on strings of
//     257 to 4,096 bytes).  The warp regime's lanes over the warps of one
//     block: one pair a block of NW warps, C = 9 or 17 cells a lane, lane
//     gl of the pair the cells [gl*C, (gl+1)*C), so a warp's cells start
//     on a code word.  Inside a warp a row runs as in band_kernel
//     (shuffles, the fused add-min chain, the shuffle min-scan); across
//     warps two slots a warp in shared memory and two block barriers a
//     row: lane 0 of warp w + 1 hands lane 31 of warp w its first cell of
//     row i-1 and its byte (`edge`), and each warp's carry is the min of
//     the totals of the warps on its left (`tot`, one redux.sync).  A
//     traced lane forms sub, the transposition and dprime again in pass 2
//     (the LEAN lane: 4 ints a cell), so 18 warps of 17 cells fit the
//     register file.
//   * band_cluster_kernel<TRANS>, every traced band past that up to
//     unit_k 2^20, for b strings of any length (chip_smoke.py's past_plan
//     phase: unit_k 10,064, 20,129 cells; band_wide case (e): 2 pairs of
//     90,000 bytes at unit_k 5,008): one pair a thread-block cluster, the
//     matrix's columns (not the band's cells: in columns every dependence
//     runs left to right or down) cut into strips of 512, 16 consecutive
//     columns a lane of a warp in registers (cells left of column 0 are
//     not computed: the matrix's cells, not the band's, are the work).
//     A strip runs only over the rows whose band meets it (`cl_first_row`
//     .. `cl_last_row`), and the cluster's G warps take the strips in a
//     ring: warp g strips g, g + G, g + 2G, ..., each over its rows in
//     order, so the state stays on chip whatever the length of b and the
//     plan needs only as many warps as strips meet a row (about W / 512 +
//     1).  D and the chain's input are INF outside the matrix and the
//     band; the band row's cells left of column 0 get their codes from a
//     rule (1 where a[i-1] != b's pad byte, else 0), those right of the
//     strips (past column n + 2) the code 1, which holds while the chain
//     there stays under INF (the plan's `full_band` otherwise: then the
//     strips cover every band column and no rule is needed).  A strip
//     hands the next one, row by row, the chain entering it, D of the row
//     before at its last two columns and its last lane's codes: through a
//     ring in the next warp's shared memory (the next CTA's, by
//     distributed shared memory; acquire / release counts that number the
//     hand-overs across strips, released every 4), and from warp G - 1 to
//     warp 0 (the wrap) through a per-pair buffer in device memory, a slot
//     a row, whose writer never waits.  A lane packs its 16 codes in one
//     register; the word of row i holding its first cell joins the left
//     lane's codes with a funnel shift (the band's cells lie one column
//     further right each row), so a warp writes 32 consecutive words a
//     row.
// Every cascade is selects on non-short-circuit compares (a branch makes
// the lanes of a warp diverge), and the min chains use Hopper's DPX
// (__viaddmin_s32 for min(a + b, c), __vimin3_s32).  The per-lane passes
// and the strips' bookkeeping are plain functions, so the host rehearsal
// (host_rehearsal.cpp, -DTA_HOST_REHEARSAL) runs exactly this arithmetic,
// lanes one at a time, the shuffles as arrays (the block regime: its warps
// round by round between the barriers, the slots arrays; the cluster
// regime: its warps round by round in the ring, the rings and the wrap
// buffer arrays that remember what they hold).

#include <stddef.h>

#include "ta_common.cuh"

namespace {

constexpr int32_t TA_BAND_INF = 1 << 30;
// transposition candidate of a cell without one: loses every compare
constexpr int32_t TA_BAND_NONE = 0x7fffffff;
constexpr int TA_CODES_PER_WORD = 16;
// the warp regime: threads a block at most, and cells a lane at most
constexpr int TA_BAND_WARP_THREADS = 256;
constexpr int TA_BAND_MAX_CELLS = 17;
// the widest traced band (the plan's MAX_TRACE_UNIT_K); the cluster
// regime's intermediates stay in int32 at any band (its chain's offsets
// span one warp's 512 columns, and D, e and the chain stay <= INF)
constexpr int TA_BAND_MAX_TRACE_UNIT_K = 1 << 20;

static TA_DEV int32_t ta_min32(int32_t x, int32_t y) { return x < y ? x : y; }

#ifdef TA_HOST_REHEARSAL
static inline int32_t bd_addmin(int32_t a, int32_t b, int32_t c) {
  return ta_min32(a + b, c);
}
static inline int32_t bd_min3(int32_t a, int32_t b, int32_t c) {
  return ta_min32(ta_min32(a, b), c);
}
#else
// Hopper's DPX: min(a + b, c) and min(a, b, c), one instruction each
static __device__ __forceinline__ int32_t bd_addmin(int32_t a, int32_t b,
                                                    int32_t c) {
  return __viaddmin_s32(a, b, c);
}
static __device__ __forceinline__ int32_t bd_min3(int32_t a, int32_t b,
                                                  int32_t c) {
  return __vimin3_s32(a, b, c);
}
#endif

struct BandCosts {
  int32_t mc, gc, sgc, tc;
};

static TA_DEV int32_t band_final_cell(int32_t m, int32_t n, int32_t unit_k,
                                      int32_t W) {
  int32_t c = n - m + unit_k;
  if (c < 0) c = 0;
  if (c > W - 1) c = W - 1;
  return c;
}

// ---------------------------------------------------------------------------
// the warp regime: one lane's C cells
// ---------------------------------------------------------------------------

// The lane's two-bit codes of a row: 2 * C bits.
template <int C>
struct BandBits {
  typedef uint32_t T;
};
template <>
struct BandBits<17> {
  typedef uint64_t T;
};

// LEAN (the block regime's traced lanes): pass 2 forms sub, the
// transposition candidate and dprime again from D of rows i-1 and i-2 and
// the bytes instead of keeping them from pass 1 (D of row i-2 moves up in
// pass 2), so a traced lane holds 4 ints a cell instead of 7: a block of
// up to 18 warps of 17 cells a lane fits the register file.
template <bool TRANS, bool TRACE, int C, bool LEAN = false>
struct BandLane {
  static_assert(C >= 1 && C <= TA_BAND_MAX_CELLS, "cells a lane");
  static constexpr bool RECOMP = TRACE && LEAN;
  int32_t dp1[C];  // D of row i-1 (row i after pass 2)
  int32_t dp0[C];  // D of row i-2 (transpositions only)
  int32_t bg[C];   // vertical-gap state of row i-1 (row i after pass 1)
  int32_t h[C];    // b[j-1] of the lane's cells at row i
  int32_t hl;      // the byte left of h[0]: b[j-2] of the lane's first cell
  // pass 1 -> pass 2: dprime (masked to INF outside the matrix where the
  // codes need it), and for the cascade of the codes sub and the
  // transposition candidate
  int32_t dpr[RECOMP ? 1 : C];
  int32_t sub[TRACE && !RECOMP ? C : 1], trn[TRACE && !RECOMP ? C : 1];
};

// What a row needs besides the registers.
struct BandRow {
  int32_t ach, apv;  // a[i-1], and a[i-2] (-1 at row 1: no transposition)
  int32_t vhi;       // the lane's last cell inside the matrix and the band:
                     // min(n + unit_k - i, W - 1) - l*C (may be < 0)
  int32_t tlo;       // the lane's first cell with j > 1: 2 + unit_k - i - l*C
};

static TA_DEV BandRow band_row(int32_t i, int32_t ach, int32_t apv,
                               int32_t n, int32_t unit_k, int32_t W,
                               int32_t c0) {
  BandRow R;
  R.ach = ach;
  R.apv = apv;
  const int32_t last = n + unit_k - i;
  R.vhi = (last < W - 1 ? last : W - 1) - c0;
  R.tlo = 2 + unit_k - i - c0;
  return R;
}

// What the lane hands to the lane on its left: D and the gap state of its
// first cell (row i-1), the vertical predecessors of that lane's last cell.
struct BandUp {
  int32_t d, g;
};

template <bool TRANS, bool TRACE, int C, bool LEAN>
static TA_DEV BandUp band_lane_up(const BandLane<TRANS, TRACE, C, LEAN>& L) {
  return BandUp{L.dp1[0], L.bg[0]};
}

// The group's last lane has nothing on its right: cell W (or a ghost).
static TA_DEV BandUp band_up_in(BandUp from_right, bool last_lane) {
  return last_lane ? BandUp{TA_BAND_INF, TA_BAND_INF} : from_right;
}

// Row 0 and the empty history; b_row is the pair's b row (its b at byte
// offset unit_k), b_len its length: cell c reads byte i - 1 + c.
template <bool TRANS, bool TRACE, int C, bool LEAN>
static TA_DEV void band_lane_init(BandLane<TRANS, TRACE, C, LEAN>& L,
                                  const uint8_t* b_row, int64_t b_len,
                                  int32_t n, int32_t unit_k, int32_t W,
                                  int32_t c0, const BandCosts& k) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t cg = c0 + c;
    const int32_t j0 = cg - unit_k;
    const bool in = cg < W && j0 >= 0 && j0 <= n;
    L.dp1[c] = in ? ta_min32(j0 * k.gc + (j0 > 0 ? k.sgc : 0), TA_BAND_INF)
                  : TA_BAND_INF;
    L.dp0[c] = TA_BAND_INF;
    L.bg[c] = TA_BAND_INF;
    L.h[c] = cg < b_len ? (int32_t)b_row[cg] : 0;
  }
  L.hl = c0 >= 1 && c0 - 1 < b_len ? (int32_t)b_row[c0 - 1] : 0;
}

// The transposition candidate of the lane's cell c at row i (TA_BAND_NONE
// where none): b[j-2] is the byte left of b[j-1]; i > 1 is apv != -1, j >
// 1 tlo.  D of row i-2 must not have moved up yet.
template <bool TRANS, bool TRACE, int C, bool LEAN>
static TA_DEV int32_t band_lane_trn(const BandLane<TRANS, TRACE, C, LEAN>& L,
                                    const BandCosts& k, const BandRow& R,
                                    int c) {
  if (!TRANS) return TA_BAND_NONE;
  const int32_t hj2 = c == 0 ? L.hl : L.h[c - 1];
  const bool t = (hj2 == R.ach) & (L.h[c] == R.apv) & (c >= R.tlo);
  return t ? L.dp0[c] + k.tc : TA_BAND_NONE;
}

// Pass 1 of a row: sub, the vertical gap (stored as the row's gap state),
// the transposition and dprime of each cell, and the horizontal chain over
// the lane's own cells from INF.  Returns F after the lane's last cell.
template <bool TRANS, bool TRACE, int C, bool LEAN>
static TA_DEV int32_t band_lane_pass1(BandLane<TRANS, TRACE, C, LEAN>& L,
                                      const BandCosts& k, const BandRow& R,
                                      BandUp up) {
  int32_t f = TA_BAND_INF;
  const int32_t vnew = k.sgc + k.gc;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t d_up = c + 1 < C ? L.dp1[c + 1] : up.d;
    const int32_t g_up = c + 1 < C ? L.bg[c + 1] : up.g;
    const int32_t sub = L.dp1[c] + (L.h[c] == R.ach ? 0 : k.mc);
    // clamped before it is carried, so saturated cells do not creep
    const int32_t bgap =
        bd_addmin(d_up, vnew, bd_addmin(g_up, k.gc, TA_BAND_INF));
    const int32_t trn = band_lane_trn<TRANS>(L, k, R, c);
    if (TRANS && !L.RECOMP) L.dp0[c] = L.dp1[c];
    // bgap <= INF, so dprime needs no clamp
    int32_t dpr = TRANS ? bd_min3(sub, bgap, trn) : ta_min32(sub, bgap);
    // the chain into a cell inside the matrix only meets cells inside it
    // or left of column 0 (INF by construction); the codes of the cells
    // past column n need the plain version's masked chain
    if (TRACE) dpr = c <= R.vhi ? dpr : TA_BAND_INF;
    L.bg[c] = bgap;
    if (!L.RECOMP) L.dpr[c] = dpr;
    if (TRACE && !L.RECOMP) {
      L.sub[c] = sub;
      L.trn[c] = trn;
    }
    f = bd_addmin(f, k.gc, dpr);
  }
  return f;
}

// The scan's element of lane l: F after the lane, less its offset, so that
// the chain across lanes is a plain min-scan.
static TA_DEV int32_t band_lane_key(int32_t f_out, int32_t l, int32_t C,
                                    int32_t gc) {
  return f_out - (l + 1) * C * gc;
}

// F entering lane l from the exclusive min-scan of the keys (lane 0: none).
static TA_DEV int32_t band_lane_carry(int32_t ex, int32_t l, int32_t C,
                                      int32_t gc) {
  return l == 0 ? TA_BAND_INF : ex + l * C * gc;
}

// Pass 2: the chain from `f` (F at the lane's first cell), the cascade,
// the new row of D (INF outside the matrix and the band); returns the
// cells' two-bit codes (traced), cell c at bits 2c.
template <bool TRANS, bool TRACE, int C, bool LEAN>
static TA_DEV typename BandBits<C>::T band_lane_pass2(
    BandLane<TRANS, TRACE, C, LEAN>& L, const BandCosts& k, const BandRow& R,
    int32_t f) {
  typedef typename BandBits<C>::T Bits;
  Bits bits = 0;
  const int32_t hs = k.gc + k.sgc;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    int32_t dpr, sub = 0, trn = TA_BAND_NONE;
    if (L.RECOMP) {  // pass 1's values again, as it formed them
      sub = L.dp1[c] + (L.h[c] == R.ach ? 0 : k.mc);
      trn = band_lane_trn<TRANS>(L, k, R, c);
      if (TRANS) L.dp0[c] = L.dp1[c];
      dpr = TRANS ? bd_min3(sub, L.bg[c], trn) : ta_min32(sub, L.bg[c]);
      dpr = c <= R.vhi ? dpr : TA_BAND_INF;
    } else {
      dpr = L.dpr[c];
      if (TRACE) {
        sub = L.sub[c];
        trn = L.trn[c];
      }
    }
    int32_t d;
    if (TRACE) {
      const int32_t e = bd_addmin(f, hs, TA_BAND_INF);
      const int32_t bgap = L.bg[c];
      const bool te = e < sub;
      int32_t v = ta_min32(e, sub);
      const bool tb = bgap < v;
      v = ta_min32(v, bgap);
      const bool tt = TRANS & (trn <= v);
      d = TRANS ? ta_min32(v, trn) : v;
      uint32_t code = tb ? 2u : (uint32_t)te;
      code = tt ? 3u : code;
      bits |= (Bits)code << (2 * c);
    } else {
      // min(e, dprime), e = min(F + gap + start, INF), dprime <= INF
      d = bd_addmin(f, hs, dpr);
    }
    L.dp1[c] = c <= R.vhi ? d : TA_BAND_INF;
    f = bd_addmin(f, k.gc, dpr);
  }
  return bits;
}

// The byte the lane hands to the lane on its left as the window moves.
template <bool TRANS, bool TRACE, int C, bool LEAN>
static TA_DEV int32_t band_lane_char_out(
    const BandLane<TRANS, TRACE, C, LEAN>& L) {
  return L.h[0];
}

// The window moves one byte right: `in` is b's byte of the lane's new last
// cell.
template <bool TRANS, bool TRACE, int C, bool LEAN>
static TA_DEV void band_lane_slide(BandLane<TRANS, TRACE, C, LEAN>& L,
                                   int32_t in) {
  L.hl = L.h[0];
#pragma unroll
  for (int c = 0; c + 1 < C; ++c) L.h[c] = L.h[c + 1];
  L.h[C - 1] = in;
}

// D of the lane's cell `cell_in_lane` (INF where the lane has no such
// cell).
template <bool TRANS, bool TRACE, int C, bool LEAN>
static TA_DEV int32_t band_lane_pick(const BandLane<TRANS, TRACE, C, LEAN>& L,
                                     int32_t cell_in_lane) {
  int32_t r = TA_BAND_INF;
#pragma unroll
  for (int c = 0; c < C; ++c) r = c == cell_in_lane ? L.dp1[c] : r;
  return r;
}

// Codes of the lane's cells that lie in the band (ghost cells write 0, as
// the plain version's padding does).
template <int C>
static TA_DEV typename BandBits<C>::T band_lane_code_mask(int32_t c0,
                                                          int32_t W) {
  typedef typename BandBits<C>::T Bits;
  int32_t live = W - c0;
  live = live < 0 ? 0 : (live > C ? C : live);
  return live >= (int32_t)(4 * sizeof(Bits)) ? ~(Bits)0
                                             : (((Bits)1 << (2 * live)) - 1);
}

// Rounds of words a lane writes a row: word w = l + r*G, r < this.
template <int C>
static TA_DEV constexpr int band_word_rounds() {
  return (C + TA_CODES_PER_WORD - 1) / TA_CODES_PER_WORD;
}

// Word w of a row (cells 16w .. 16w + 15) from the group's lanes' code
// bits; get(src) returns lane src's bits (the device: a shuffle every lane
// makes, the same number of times; a src past the group is masked here).
template <int C, class Get>
static TA_DEV uint32_t band_word(int32_t w, int32_t G, Get get) {
  typedef typename BandBits<C>::T Bits;
  constexpr int Q = (TA_CODES_PER_WORD - 1) / C + 2;  // lanes a word spans
  const int32_t lo = (TA_CODES_PER_WORD * w) / C;
  uint32_t word = 0u;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int32_t src = lo + q;
    const Bits v = get(src);
    const int32_t s = 2 * src * C - 32 * w;  // the lane's bit 0 in the word
    const Bits part = s >= 0 ? (s < 32 ? (Bits)(v << s) : (Bits)0) : (v >> -s);
    word |= src < G ? (uint32_t)part : 0u;
  }
  return word;
}

// Bytes [0, len) of a buffer at any address read in order, one a call:
// TaStream over the 16-byte aligned address at or below it.
struct BandStream {
  TaStream s;
  int32_t off;
  TA_DEV void start(const uint8_t* p, int64_t len) {
    off = (int32_t)((size_t)p & 15u);
    s.start(p - off, len + off);
  }
  TA_DEV int32_t at(int64_t idx) { return (int32_t)s.at(idx + off); }
};

// The warp regime's lane maps: cells a lane, lanes a pair.
static inline bool band_warp_map_ok(int cells, int lanes, int W) {
  return (cells == 3 || cells == 5 || cells == 9 || cells == 17) &&
         (lanes == 8 || lanes == 16 || lanes == 32) && cells * lanes >= W;
}

// ---------------------------------------------------------------------------
// the block regime: one pair a block of NW warps, the warp regime's lanes
// ---------------------------------------------------------------------------

// The most warps a pair (C cells a lane).  An instantiation's launch bound
// is 16 or 18 warps: an SM's four schedulers each hold a quarter of its
// 65,536 registers and the warps of a block spread over them, so 16 warps
// leave 128 registers a thread and 17 or 18 only 96 (the traced rDamerau
// lane of 17 cells spills 84 bytes there, none at 128).  9 cells a lane
// take up to 16 warps, 17 up to 18 (bands up to 9,792 cells).
template <int C>
struct BandBlockWarps;
template <>
struct BandBlockWarps<9> {
  static constexpr int value = 16;
};
template <>
struct BandBlockWarps<17> {
  static constexpr int value = 18;
};
constexpr int TA_BAND_BLOCK_WARPS = 16;  // the bound of the common case

// What warp w + 1's lane 0 hands warp w's lane 31 across the edge between
// them at the end of row i - 1: D and the gap state of its first cell
// (the vertical predecessors of warp w's last cell at row i) and b's byte
// of that cell (warp w's new last byte as the window moves).
struct BandEdge {
  int32_t d, g, h;
};

// F entering lane `gl` of the pair (`lane` of its warp) from the min of
// the keys over the warps on its left (`left`: INF for warp 0) and the
// warp's exclusive scan over its own lanes (`ex`; lane 0 has none).
static TA_DEV int32_t band_block_carry(int32_t left, int32_t ex, int lane,
                                       int32_t gl, int32_t C, int32_t gc) {
  return band_lane_carry(lane == 0 ? left : ta_min32(left, ex), gl, C, gc);
}

// Warp w's cells, 32 C from cell 32 C w on, are the row's 2C words from
// word 2 C w on: a warp writes whole words.
static TA_DEV int32_t band_block_word0(int32_t w, int32_t C) {
  return 2 * C * w;
}

// b's byte of the pair's cell `x` at row i + 1 (0 past the b row), and
// a[i] (0 past the a row): what the last lane and lane 0 load a row.
static TA_DEV int32_t band_byte(const uint8_t* row, int64_t len, int64_t x) {
  return x < len ? (int32_t)row[x] : 0;
}

// What the launcher takes of the block regime: C = 9 or 17, up to its
// instantiation's warps, holding the band.
static inline bool band_block_ok(int unit_k, int cells, int warps) {
  const int most = cells == 9 ? BandBlockWarps<9>::value
                 : cells == 17 ? BandBlockWarps<17>::value : 0;
  return unit_k >= 0 && warps >= 1 && warps <= most &&
         32 * cells * warps >= 2 * unit_k + 1;
}

// ---------------------------------------------------------------------------
// the cluster regime: one pair a thread-block cluster, the matrix's columns
// in strips of 512 (a warp's lanes, 16 columns each, in registers), the
// cluster's warps taking the strips in a ring
// ---------------------------------------------------------------------------

constexpr int TA_CL_COLS = 16;  // columns a lane: one code word a row
constexpr int TA_CL_STRIP = 32 * TA_CL_COLS;  // columns a strip (a warp)
constexpr int TA_CL_MAX_CTAS = 8;     // CTAs a cluster (the portable size)
constexpr int TA_CL_MAX_WARPS = 20;   // warps a CTA
constexpr int TA_CL_RING = 32;        // hand-over slots a warp boundary
// hand-overs a count is released for, dividing TA_CL_RING / 2 (a release
// waits for the thread's earlier stores; one every 4 rows took a single
// pair 18.0 ms against 19.0 every row, 18.1 every 8: PERF.md)
constexpr int TA_CL_BATCH = 4;
constexpr uint32_t TA_CL_ONES = 0x55555555u;  // 16 codes 1 (consume b)

// One pair as a cluster sees it.  Strip s holds columns [512 s, 512 s +
// 512), lane k of the pair (k = 32 s + lane) columns [16k, 16k + 16); the
// S strips hold columns [0, 16K), K = 32 S lanes: past n + 2 (the codes
// right of them are 1 while the chain stays under INF), or with `full`
// past the band's last column at row m too (then no rule is needed).
struct ClPair {
  int32_t m, n, uk, W, wpr, K, S;
  int32_t jf;  // the final column: band cell clip(n - m + uk, 0, W-1), row m
};

static TA_DEV ClPair cl_pair(int32_t m, int32_t n, int32_t uk, bool full) {
  ClPair P;
  P.m = m;
  P.n = n;
  P.uk = uk;
  P.W = 2 * uk + 1;
  P.wpr = (P.W + TA_CODES_PER_WORD - 1) / TA_CODES_PER_WORD;
  int32_t cols = n + 3;
  if (full && m + uk + 1 > cols) cols = m + uk + 1;
  P.S = (cols + TA_CL_STRIP - 1) / TA_CL_STRIP;
  P.K = 32 * P.S;
  P.jf = band_final_cell(m, n, uk, P.W) + m - uk;
  return P;
}

// The rows strip s runs: from the row before the band reaches it (its
// first row has no band cell: it brings D of that row, which the next row's
// transpositions read, from the strip on the left) to the last row whose
// band meets it; then one step more, row last + 1, writes the codes of its
// last row.  Strip s's columns meet row i's band (columns i - unit_k .. i
// + unit_k) exactly when 512 s - unit_k <= i <= 512 s + 511 + unit_k.
// first <= last + 1 <= m + 1 for every strip of the pair.
static TA_DEV int32_t cl_first_row(int32_t s, const ClPair& P) {
  const int32_t i = s * TA_CL_STRIP - P.uk - 1;
  return i > 1 ? i : 1;
}

static TA_DEV int32_t cl_last_row(int32_t s, const ClPair& P) {
  const int32_t i = s * TA_CL_STRIP + (TA_CL_STRIP - 1) + P.uk;
  return i < P.m ? i : P.m;
}

// The strips that run row i (1 <= i <= m): lo .. hi, at most W / 512 + 2.
static TA_DEV int32_t cl_strip_lo(int32_t i, const ClPair& P) {
  const int32_t x = i - (TA_CL_STRIP - 1) - P.uk;
  return x <= 0 ? 0 : (x + TA_CL_STRIP - 1) / TA_CL_STRIP;
}

static TA_DEV int32_t cl_strip_hi(int32_t i, const ClPair& P) {
  const int32_t s = (i + P.uk + 1) / TA_CL_STRIP;
  return s < P.S - 1 ? s : P.S - 1;
}

// Strip s (s >= 1) takes the hand-overs of rows first(s) .. last(s - 1) + 1
// from strip s - 1: the rows both run, and the last step of s - 1.  Past
// them strip s - 1 lies left of the band, and what it would hand on is
// known: no chain (INF), D of the row before INF at its last columns
// (outside the band), and codes no word reads (`cl_slot_past`).  So strip s
// hands on rows first(s + 1) .. last(s) + 1, in order.
static TA_DEV int32_t cl_in_last(int32_t s, const ClPair& P) {
  return s > 0 ? cl_last_row(s - 1, P) + 1 : 0;
}

static TA_DEV int32_t cl_out_first(int32_t s, const ClPair& P) {
  return s + 1 < P.S ? cl_first_row(s + 1, P) : 0x7fffffff;
}

// What a row needs besides the registers, a bit a column of the lane
// (jb + c at bit c): the columns inside the matrix and the band, [max(0, i
// - unit_k), min(n, i + unit_k)] (D and the chain's input are INF
// elsewhere), and those with j >= 2 (a transposition needs them).
struct ClRow {
  int32_t ach;  // a[i-1]
  uint32_t valid, j2;
};

// Bits [lo, hi] of 16 (none where hi < lo).
static TA_DEV uint32_t cl_bits(int32_t lo, int32_t hi) {
  lo = lo < 0 ? 0 : lo;
  hi = hi > 15 ? 15 : hi;
  return hi < lo ? 0u : ((2u << hi) - 1u) & ~((1u << lo) - 1u);
}

static TA_DEV ClRow cl_row(int32_t i, int32_t ach, const ClPair& P,
                           int32_t jb) {
  ClRow R;
  R.ach = ach;
  const int32_t lo = i - P.uk, hi = i + P.uk;
  R.valid = cl_bits((lo > 0 ? lo : 0) - jb, (hi < P.n ? hi : P.n) - jb);
  R.j2 = cl_bits(2 - jb, 15);
  return R;
}

// What a lane's first columns need from the left: D(i-1, jb-1), D(i-2,
// jb-1) and D(i-2, jb-2).
struct ClLeft {
  int32_t d1, d0a, d0b;
};

template <bool TRANS>
struct ClLane {
  int32_t dp1[TA_CL_COLS];               // D of row i-1 (row i after pass 2)
  int32_t dp0[TRANS ? TA_CL_COLS : 1];   // D of row i-2
  int32_t bg[TA_CL_COLS];  // vertical-gap state of row i-1 (i after pass 1)
  uint32_t h4[TA_CL_COLS / 4];  // b[j-1], the b byte of each column, packed
  int32_t hl;                   // b[jb-2]
  // a bit a column: b[j-1] == a[i-1] (`ma`, row i) and == a[i-2] (`mp`:
  // row i-1's `ma`), and the transposition condition of row i (`tb`)
  uint32_t ma, mp, tb;
};

// 16 bits, bit c set where column jb + c's b byte equals the byte x: four
// bytes a word at once (a byte of v is 0 where it matched; the 0x80 bits
// of `nz` mark the others, then a multiply gathers the four bits).
static TA_DEV uint32_t cl_eq_mask(const uint32_t (&h4)[TA_CL_COLS / 4],
                                  int32_t x) {
  const uint32_t xx = (uint32_t)(x & 0xff) * 0x01010101u;
  uint32_t m = 0u;
#pragma unroll
  for (int q = 0; q < TA_CL_COLS / 4; ++q) {
    const uint32_t v = h4[q] ^ xx;
    const uint32_t nz = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
    const uint32_t eq = (~nz & 0x80808080u) >> 7;
    m |= (((eq * 0x00204081u) >> 21) & 0xfu) << (4 * q);
  }
  return m;
}

// Byte x of the pair's b row (b at offset unit_k), 0 outside it.
static TA_DEV int32_t cl_b_at(const uint8_t* b_row, int64_t b_len,
                              int64_t x) {
  return x >= 0 && x < b_len ? (int32_t)b_row[x] : 0;
}

// Row 0 and the empty history of columns jb .. jb + 15: D(0, j) inside the
// matrix and the band (j <= n, j <= unit_k), INF elsewhere.
template <bool TRANS>
static TA_DEV void cl_lane_init(ClLane<TRANS>& L, const uint8_t* b_row,
                                int64_t b_len, const ClPair& P, int32_t jb,
                                const BandCosts& k) {
#pragma unroll
  for (int c = 0; c < TA_CL_COLS; ++c) {
    const int32_t j = jb + c;
    L.dp1[c] = (j <= P.n && j <= P.uk)
                   ? ta_min32(j * k.gc + (j > 0 ? k.sgc : 0), TA_BAND_INF)
                   : TA_BAND_INF;
    if (TRANS) L.dp0[c] = TA_BAND_INF;
    L.bg[c] = TA_BAND_INF;
  }
#pragma unroll
  for (int q = 0; q < TA_CL_COLS / 4; ++q) {
    uint32_t w = 0u;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w |= (uint32_t)cl_b_at(b_row, b_len,
                             (int64_t)P.uk + jb + 4 * q + r - 1) << (8 * r);
    L.h4[q] = w;
  }
  L.hl = cl_b_at(b_row, b_len, (int64_t)P.uk + jb - 2);
  L.ma = L.mp = L.tb = 0u;
}

// Row i's matches, then its transpositions: b[j-2] == a[i-1] (the match
// bit one column left; b[jb-2] for the first) and b[j-1] == a[i-2] (row
// i-1's match bit: none at row 1), at j >= 2.  Every row, also where the
// warp leaves the cells alone.
template <bool TRANS>
static TA_DEV void cl_lane_masks(ClLane<TRANS>& L, const ClRow& R) {
  L.mp = L.ma;
  L.ma = cl_eq_mask(L.h4, R.ach);
  if (TRANS) L.tb = ((L.ma << 1) | (uint32_t)(L.hl == R.ach)) & L.mp & R.j2;
}

// D and the gap state the lane hands to the lane on its right (row i-1:
// taken before pass 1).
template <bool TRANS>
static TA_DEV ClLeft cl_lane_right(const ClLane<TRANS>& L) {
  return ClLeft{L.dp1[TA_CL_COLS - 1],
                TRANS ? L.dp0[TA_CL_COLS - 1] : TA_BAND_INF,
                TRANS ? L.dp0[TA_CL_COLS - 2] : TA_BAND_INF};
}

// Pass 1 of row i: the vertical gap (stored as the row's gap state), the
// substitution, the transposition and dprime of each column, the chain
// over the lane's own columns from INF; returns F after the lane's last
// column.  In column coordinates every input lies left of the column or
// above it: D(i-1, j-1), D(i-1, j) and the gap state of column j, D(i-2,
// j-2).
template <bool TRANS>
static TA_DEV int32_t cl_lane_pass1(ClLane<TRANS>& L, const BandCosts& k,
                                    const ClRow& R, const ClLeft& in) {
  int32_t f = TA_BAND_INF;
  const int32_t vnew = k.sgc + k.gc;
#pragma unroll
  for (int c = 0; c < TA_CL_COLS; ++c) {
    const int32_t dl = c == 0 ? in.d1 : L.dp1[c - 1];
    const int32_t sub = dl + ((L.ma >> c) & 1u ? 0 : k.mc);
    // clamped before it is carried, so saturated cells do not creep
    const int32_t bgap =
        bd_addmin(L.dp1[c], vnew, bd_addmin(L.bg[c], k.gc, TA_BAND_INF));
    int32_t dpr;
    if (TRANS) {
      const int32_t d0 = c >= 2 ? L.dp0[c - 2] : (c == 1 ? in.d0a : in.d0b);
      dpr = bd_min3(sub, bgap,
                    (L.tb >> c) & 1u ? d0 + k.tc : TA_BAND_NONE);
    } else {
      dpr = ta_min32(sub, bgap);
    }
    // outside the matrix and the band the chain's input is INF, as the
    // plain version masks it
    dpr = (R.valid >> c) & 1u ? dpr : TA_BAND_INF;
    L.bg[c] = bgap;
    f = bd_addmin(f, k.gc, dpr);
  }
  return f;
}

// D of the lane's column jb + c (no dynamic index: the arrays stay in
// registers).
template <bool TRANS>
static TA_DEV int32_t cl_lane_pick(const ClLane<TRANS>& L, int32_t c) {
  int32_t d = TA_BAND_INF;
#pragma unroll
  for (int q = 0; q < TA_CL_COLS; ++q) d = q == c ? L.dp1[q] : d;
  return d;
}

// The scan's element of lane l of a warp: F after the lane less its
// offset, so that the chain across lanes is a plain min-scan.
static TA_DEV int32_t cl_key(int32_t f_out, int32_t l, int32_t gc) {
  return f_out - (l + 1) * TA_CL_COLS * gc;
}

// F entering lane l from F entering the warp (`cin`) and the exclusive
// min-scan of the keys; F leaving the warp from the inclusive scan of its
// last lane (l = 32).
static TA_DEV int32_t cl_carry(int32_t cin, int32_t ex, int32_t l,
                               int32_t gc) {
  return l == 0 ? cin : ta_min32(cin, ex) + l * TA_CL_COLS * gc;
}

// Pass 2 of row i: the chain from `f` (F at the lane's first column), the
// cascade, the new row of D (INF outside the matrix and the band); returns
// the columns' two-bit codes, column c at bits 2c.  The substitution and
// the transposition are formed again from the row i-1 and i-2 values as
// they are rotated out (fewer registers than keeping them from pass 1).
template <bool TRANS>
static TA_DEV uint32_t cl_lane_pass2(ClLane<TRANS>& L, const BandCosts& k,
                                     const ClRow& R, const ClLeft& in,
                                     int32_t f) {
  uint32_t bits = 0u;
  const int32_t hs = k.gc + k.sgc;
  int32_t dl = in.d1;                // D(i-1, j-1)
  int32_t o1 = in.d0a, o2 = in.d0b;  // D(i-2, j-1), D(i-2, j-2)
#pragma unroll
  for (int c = 0; c < TA_CL_COLS; ++c) {
    const int32_t sub = dl + ((L.ma >> c) & 1u ? 0 : k.mc);
    const int32_t bgap = L.bg[c];
    const int32_t trn =
        TRANS && ((L.tb >> c) & 1u) ? o2 + k.tc : TA_BAND_NONE;
    const int32_t e = bd_addmin(f, hs, TA_BAND_INF);
    const bool te = e < sub;
    int32_t v = ta_min32(e, sub);
    const bool tbg = bgap < v;
    v = ta_min32(v, bgap);
    const bool tt = TRANS & (trn <= v);
    const int32_t d = TRANS ? ta_min32(v, trn) : v;
    uint32_t code = tbg ? 2u : (uint32_t)te;
    code = tt ? 3u : code;
    bits |= code << (2 * c);
    const bool valid = (R.valid >> c) & 1u;
    const int32_t dpr =
        valid ? (TRANS ? bd_min3(sub, bgap, trn) : ta_min32(sub, bgap))
              : TA_BAND_INF;
    dl = L.dp1[c];
    if (TRANS) {
      o2 = o1;
      o1 = L.dp0[c];
      L.dp0[c] = L.dp1[c];
    }
    L.dp1[c] = valid ? d : TA_BAND_INF;
    f = bd_addmin(f, k.gc, dpr);
  }
  return bits;
}

// The word of row i that holds lane k's first cell, and its codes: the
// last s codes of the lane on the left, then this lane's first 16 - s
// (s = (unit_k - i) mod 16: band cell c is column c + i - unit_k, one
// column further right each row).
static TA_DEV int32_t cl_word_index(int32_t k, int32_t i, int32_t uk) {
  return k + ((uk - i) >> 4);
}

static TA_DEV uint32_t cl_word(uint32_t left, uint32_t own, int32_t i,
                               int32_t uk) {
  const int32_t s2 = 2 * ((uk - i) & 15);
#ifdef TA_HOST_REHEARSAL
  return s2 == 0 ? own : (own << s2) | (left >> (32 - s2));
#else
  return __funnelshift_l(left, own, s2);
#endif
}

// The band row's last word holds cells past W - 1: 0, as the plain
// version's padding.
static TA_DEV uint32_t cl_word_mask(int32_t w, const ClPair& P) {
  const int32_t live = P.W - TA_CODES_PER_WORD * w;
  return live >= TA_CODES_PER_WORD ? 0xffffffffu
                                   : ((1u << (2 * live)) - 1u);
}

// Codes of the 16 cells from b's byte x0 on at row i, left of column 0:
// there every input is INF (e too), so the cascade takes the chain where
// the substitution misses and meets a[i-1] != b (code 1), else keeps it.
static TA_DEV uint32_t cl_left_word(const uint8_t* b_row, int64_t b_len,
                                    int64_t x0, int32_t ach) {
  uint32_t word = 0u;
#pragma unroll
  for (int q = 0; q < TA_CODES_PER_WORD; ++q)
    word |= (uint32_t)(cl_b_at(b_row, b_len, x0 + q) != ach) << (2 * q);
  return word;
}

// Bit q of a 16-bit mask to bit 2q.
static TA_DEV uint32_t cl_spread(uint32_t x) {
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// The same codes where all 16 bytes lie inside the b row (x0 >= 0, x0 +
// 16 <= b_len, and up to 3 bytes more past them, which the row's pad
// holds): the card reads them as five aligned words and compares four
// bytes at once (`cl_eq_mask`).
static TA_DEV uint32_t cl_left_word_in(const uint8_t* b_row, int64_t x0,
                                       int32_t ach) {
  uint32_t h4[TA_CL_COLS / 4];
#ifdef TA_HOST_REHEARSAL
  for (int q = 0; q < TA_CL_COLS / 4; ++q) {
    h4[q] = 0u;
    for (int r = 0; r < 4; ++r)
      h4[q] |= (uint32_t)b_row[x0 + 4 * q + r] << (8 * r);
  }
#else
  const uint8_t* at = b_row + x0;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(at) & ~(uintptr_t)3);
  const uint32_t sh = 8u * (uint32_t)(reinterpret_cast<uintptr_t>(at) & 3);
  uint32_t v[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) v[q] = __ldg(w + q);
#pragma unroll
  for (int q = 0; q < TA_CL_COLS / 4; ++q)
    h4[q] = __funnelshift_r(v[q], v[q + 1], sh);
#endif
  return cl_spread(~cl_eq_mask(h4, ach) & 0xffffu);
}

// Row i's words that hold no lane's first cell: those left of the first
// lane's, [0, nl), from b's bytes left of column 0, then those right of
// the last lane's straddling word, [r0, wpr), all code 1 (the plan keeps
// the chain there under INF, or covers the band with its strips).  The
// x-th of them: its index, or -1.
static TA_DEV int32_t cl_extra_index(int32_t x, int32_t i, const ClPair& P) {
  const int32_t q = (P.uk - i) >> 4;
  const int32_t nl = q < 0 ? 0 : (q < P.wpr ? q : P.wpr);
  if (x < nl) return x;
  int32_t r0 = q + P.K + 1;
  r0 = r0 > 0 ? r0 : 0;
  const int32_t w = r0 + (x - nl);
  return w < P.wpr ? w : -1;
}

static TA_DEV uint32_t cl_extra_word(int32_t w, int32_t i, int32_t ach,
                                     const uint8_t* b_row, const ClPair& P) {
  // a word left of the first lane's holds bytes i - 1 + 16 w .. + 15 <=
  // unit_k - 2 of b's row: inside it, with its pad after them
  const uint32_t word =
      w < ((P.uk - i) >> 4)
          ? cl_left_word_in(b_row, (int64_t)i - 1 + TA_CODES_PER_WORD * w,
                            ach)
          : TA_CL_ONES;
  return word & cl_word_mask(w, P);
}

// The strips that run row i share its extra words: lane `lane` of strip s
// takes the x-th from x = 32 (s - lo) + lane on, in steps of 32 (hi - lo +
// 1) (lo, hi: `cl_strip_lo`, `cl_strip_hi`).
static TA_DEV int32_t cl_extra_first(int32_t s, int lane, int32_t i,
                                     const ClPair& P) {
  return 32 * (s - cl_strip_lo(i, P)) + lane;
}

static TA_DEV int32_t cl_extra_step(int32_t i, const ClPair& P) {
  return 32 * (cl_strip_hi(i, P) - cl_strip_lo(i, P) + 1);
}

// Codes of columns -16 .. -1 of row i: what lane 0 of strip 0 joins with
// its own in its word.
static TA_DEV uint32_t cl_left_of_zero(const uint8_t* b_row, int64_t b_len,
                                       int32_t uk, int32_t ach) {
  return cl_left_word(b_row, b_len, (int64_t)uk - 17, ach);
}

// The hand-over from a strip to the next, one slot a row i: F entering the
// next strip's first column at row i, D of row i-1 at the strip's last two
// columns, and the codes of its last lane at row i-1.  The strip's last
// step (row last + 1) hands on no chain: F is INF there.
struct ClSlot {
  int32_t f, d1, d2;
  uint32_t v;
};

// What strip s - 1 would hand on at a row i past its last step: no chain,
// D INF (row i - 1 lies left of the band at its columns), and codes that
// no word reads (a word of row i - 1 that holds strip s's first column
// and lies inside the band starts at that column).
static TA_DEV ClSlot cl_slot_past() {
  return ClSlot{TA_BAND_INF, TA_BAND_INF, TA_BAND_INF, 0u};
}

// Whether lane 31 of strip s writes the word past its own first-cell word
// at row i (the rest of it code 1): where strip s + 1 does not run row i,
// right of the band there or past the strips.
static TA_DEV bool cl_writes_next_word(int32_t s, int32_t i,
                                       const ClPair& P) {
  return i < cl_out_first(s, P);
}

// What the launcher takes: the band, the cluster, 0 or 1 for `full`.
static inline bool band_cluster_ok(int unit_k, int ctas, int warps,
                                   int full) {
  return unit_k >= 0 && unit_k <= TA_BAND_MAX_TRACE_UNIT_K && ctas >= 1 &&
         ctas <= TA_CL_MAX_CTAS && warps >= 1 && warps <= TA_CL_MAX_WARPS &&
         (full == 0 || full == 1);
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

#include <cooperative_groups.h>

namespace {

constexpr unsigned TA_BAND_FULL = 0xffffffffu;

template <class T>
static __device__ __forceinline__ T band_shfl(T v, int src, int G) {
  return __shfl_sync(TA_BAND_FULL, v, src, G);
}

}  // namespace

template <bool TRANS, bool TRACE, int C>
__global__ void __launch_bounds__(TA_BAND_WARP_THREADS)
    band_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                int32_t* __restrict__ out, uint32_t* __restrict__ codes,
                int64_t B, int64_t a_stride, int64_t b_stride, int unit_k,
                int64_t code_rows, BandCosts k, int G) {
  typedef typename BandBits<C>::T Bits;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // lane in the pair's group
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t p0 = warp * (32 / G);
  if (p0 >= B) return;  // the whole warp: no shuffle partner is left behind
  const int64_t p = p0 + lane / G;
  const bool live = p < B;
  const int32_t W = 2 * unit_k + 1;
  const int32_t c0 = gl * C;
  // the wrapper's contract is m <= the a row's length (the lengths live on
  // the device, so it cannot check them without a sync): a larger m is cut
  // here so that no row is read, and no code row written, past its end
  const int32_t mm = live ? min(m[p], (int32_t)a_stride) : 0;
  const int32_t nn = live ? n[p] : 0;
  const uint8_t* a_row = a + (live ? p : 0) * a_stride;
  const uint8_t* b_row = b + (live ? p : 0) * b_stride;
  const int32_t cfin = band_final_cell(mm, nn, unit_k, W) - c0;
  const bool owns_fin = live && cfin >= 0 && cfin < C;

  BandLane<TRANS, TRACE, C> L;
  band_lane_init(L, b_row, b_stride, nn, unit_k, W, c0, k);
  if (owns_fin && mm == 0) out[p] = band_lane_pick(L, cfin);
  const int32_t rows = __reduce_max_sync(TA_BAND_FULL, mm);
  const int wpr = (W + TA_CODES_PER_WORD - 1) / TA_CODES_PER_WORD;
  uint32_t* code_out = TRACE ? codes + (live ? p : 0) * code_rows * wpr
                             : nullptr;
  const Bits cmask = band_lane_code_mask<C>(c0, W);
  // the group's last lane streams b (its new last byte each row), the
  // others a (lane 0's byte is the row's character)
  const bool b_lane = gl == G - 1;
  BandStream S;
  S.start(b_lane ? b_row : a_row, b_lane ? b_stride : a_stride);
  const int64_t b_next = (int64_t)G * C - 1;  // + i: the byte row i+1 needs
  int32_t ach = a_row[0], apv = -1;
  for (int32_t i = 1; i <= rows; ++i) {
    const BandRow R = band_row(i, ach, apv, nn, unit_k, W, c0);
    const BandUp own = band_lane_up(L);
    BandUp up;
    up.d = __shfl_down_sync(TA_BAND_FULL, own.d, 1, G);
    up.g = __shfl_down_sync(TA_BAND_FULL, own.g, 1, G);
    up = band_up_in(up, b_lane);
    const int32_t f_out = band_lane_pass1(L, k, R, up);
    // inclusive min-scan of the keys over the group (a lane below `off`
    // meets its own value), then exclusive
    int32_t inc = band_lane_key(f_out, gl, C, k.gc);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      if (off < G) inc = min(inc, __shfl_up_sync(TA_BAND_FULL, inc, off, G));
    const int32_t ex = __shfl_up_sync(TA_BAND_FULL, inc, 1, G);
    Bits bits = band_lane_pass2(L, k, R, band_lane_carry(ex, gl, C, k.gc));
    if (TRACE) {
      bits &= cmask;
#pragma unroll
      for (int r = 0; r < band_word_rounds<C>(); ++r) {
        const int32_t w = gl + r * G;
        const uint32_t word =
            band_word<C>(w, G, [&](int32_t src) { return band_shfl(bits, src, G); });
        if (live && i <= mm && w < wpr)
          code_out[(int64_t)(i - 1) * wpr + w] = word;
      }
    }
    if (owns_fin && i == mm) out[p] = band_lane_pick(L, cfin);
    // the next row's bytes
    const int32_t from_right =
        __shfl_down_sync(TA_BAND_FULL, band_lane_char_out(L), 1, G);
    const int32_t v = S.at(b_lane ? i + b_next : i);
    band_lane_slide(L, b_lane ? v : from_right);
    apv = ach;
    ach = band_shfl(v, 0, G);
  }
}

// One pair a block of NW = blockDim.x / 32 warps: the warp regime's lanes
// (traced: the LEAN lane), lane gl of the pair the C cells from gl * C on,
// so warp w the 32 C cells from 32 C w on.  Inside a warp a row runs as
// in band_kernel; across warps, two slots a warp in shared memory and two
// block barriers a row.  A row: pass 1 (lane 31 takes its right
// neighbour's D and gap state of row i-1 from `edge`), the warp's min-scan
// of the keys, its total into `tot`; barrier; each warp's carry from the
// totals on its left (one redux.sync), pass 2, the codes (a warp's own 2C
// words, one coalesced store), lane 0's first cell of row i and its byte
// into `edge`; barrier; lane 31 takes its new last byte from there (the
// last warp's loads it from b), lane 0 loaded a's next byte.  Every warp
// runs every row, so every warp meets every barrier.
template <bool TRANS, bool TRACE, int C, int MAXW>
__global__ void __launch_bounds__(MAXW * 32)
    band_block_kernel(const uint8_t* __restrict__ a,
                      const uint8_t* __restrict__ b,
                      const int32_t* __restrict__ m,
                      const int32_t* __restrict__ n,
                      int32_t* __restrict__ out,
                      uint32_t* __restrict__ codes, int64_t a_stride,
                      int64_t b_stride, int unit_k, int64_t code_rows,
                      BandCosts k) {
  typedef typename BandBits<C>::T Bits;
  __shared__ BandEdge edge[MAXW];
  __shared__ int32_t tot[MAXW];
  const int NW = blockDim.x >> 5;
  const int gl = threadIdx.x, lane = gl & 31, w = gl >> 5;
  const int64_t p = blockIdx.x;
  const int32_t W = 2 * unit_k + 1;
  const int32_t c0 = gl * C;
  // m is cut to the a row's length, as in band_kernel
  const int32_t mm = min(m[p], (int32_t)a_stride);
  const int32_t nn = n[p];
  const uint8_t* a_row = a + p * a_stride;
  const uint8_t* b_row = b + p * b_stride;
  const int32_t cfin = band_final_cell(mm, nn, unit_k, W) - c0;
  const bool owns_fin = cfin >= 0 && cfin < C;

  BandLane<TRANS, TRACE, C, true> L;
  band_lane_init(L, b_row, b_stride, nn, unit_k, W, c0, k);
  if (owns_fin && mm == 0) out[p] = band_lane_pick(L, cfin);
  const int wpr = (W + TA_CODES_PER_WORD - 1) / TA_CODES_PER_WORD;
  uint32_t* code_out = TRACE ? codes + p * code_rows * wpr : nullptr;
  const Bits cmask = band_lane_code_mask<C>(c0, W);
  const bool last_warp = w == NW - 1;
  const bool b_lane = last_warp && lane == 31;
  const int64_t b_next = (int64_t)NW * 32 * C - 1;  // + i: row i+1's byte
  if (lane == 0) edge[w] = BandEdge{L.dp1[0], L.bg[0], 0};
  __syncthreads();
  int32_t ach = a_row[0], apv = -1;
  for (int32_t i = 1; i <= mm; ++i) {
    // the next row's byte, loaded early: a[i] (lane 0), b's (the last lane)
    const int32_t v = lane == 0 ? band_byte(a_row, a_stride, i)
                      : b_lane  ? band_byte(b_row, b_stride, i + b_next)
                                : 0;
    const BandRow R = band_row(i, ach, apv, nn, unit_k, W, c0);
    const BandUp own = band_lane_up(L);
    BandUp up;
    up.d = __shfl_down_sync(TA_BAND_FULL, own.d, 1);
    up.g = __shfl_down_sync(TA_BAND_FULL, own.g, 1);
    if (lane == 31 && !last_warp) {
      const BandEdge e = edge[w + 1];
      up = BandUp{e.d, e.g};
    }
    up = band_up_in(up, b_lane);
    const int32_t f_out = band_lane_pass1(L, k, R, up);
    // inclusive min-scan of the keys over the warp (a lane below `off`
    // meets its own value), then exclusive
    int32_t inc = band_lane_key(f_out, gl, C, k.gc);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      inc = min(inc, __shfl_up_sync(TA_BAND_FULL, inc, off));
    const int32_t ex = __shfl_up_sync(TA_BAND_FULL, inc, 1);
    if (lane == 31) tot[w] = inc;
    __syncthreads();
    const int32_t left = __reduce_min_sync(
        TA_BAND_FULL, lane < w ? tot[lane] : TA_BAND_INF);
    Bits bits = band_lane_pass2(
        L, k, R, band_block_carry(left, ex, lane, gl, C, k.gc));
    if (TRACE) {
      bits &= cmask;
#pragma unroll
      for (int r = 0; r < band_word_rounds<C>(); ++r) {
        const int32_t wl = lane + 32 * r;
        const uint32_t word = band_word<C>(
            wl, 32, [&](int32_t src) { return band_shfl(bits, src, 32); });
        const int32_t wg = band_block_word0(w, C) + wl;
        if (wl < 2 * C && wg < wpr)
          code_out[(int64_t)(i - 1) * wpr + wg] = word;
      }
    }
    if (owns_fin && i == mm) out[p] = band_lane_pick(L, cfin);
    const int32_t from_right =
        __shfl_down_sync(TA_BAND_FULL, band_lane_char_out(L), 1);
    if (lane == 0)
      edge[w] = BandEdge{L.dp1[0], L.bg[0], band_lane_char_out(L)};
    __syncthreads();
    int32_t in = from_right;
    if (lane == 31) in = last_warp ? v : edge[w + 1].h;
    band_lane_slide(L, in);
    apv = ach;
    ach = __shfl_sync(TA_BAND_FULL, v, 0);
  }
}

namespace {

// Where a warp's hand-overs live: the ring of the warp it receives from is
// in its own CTA's shared memory (the sender writes it, across CTAs through
// the cluster's distributed shared memory); `pub[w]` counts the hand-overs
// put into warp w's ring, `taken[w]` those taken from warp w's outbound
// ring (kept in the sender's CTA, so that the sender polls locally).  The
// cluster's first warp takes its hand-overs from the last (the wrap) out of
// the pair's buffer in device memory, a slot a row, counted in `pub[0]` of
// the first CTA; its writer never waits.
struct ClRing {
  ClSlot slot[TA_CL_MAX_WARPS][TA_CL_RING];
  int pub[TA_CL_MAX_WARPS];
  int taken[TA_CL_MAX_WARPS];
};

// Acquire / release at the narrowest scope that holds both warps: the CTA
// when they share one (an SM's own memory order), the cluster across CTAs
// and at the wrap (its release also waits for the thread's earlier global
// stores to reach the cluster, so it costs about an L2 round trip).
static __device__ __forceinline__ int cl_ld_acquire(const int* p, bool cta) {
  int v;
  if (cta)
    asm volatile("ld.acquire.cta.b32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.cluster.b32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  return v;
}

static __device__ __forceinline__ void cl_st_release(int* p, int v,
                                                     bool cta) {
  if (cta)
    asm volatile("st.release.cta.b32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  else
    asm volatile("st.release.cluster.b32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// All lanes of the warp: spin until the count reaches `target`.
static __device__ __forceinline__ int cl_wait(const int* p, int target,
                                              bool cta) {
  int v;
  while ((v = cl_ld_acquire(p, cta)) < target) {
  }
  return v;
}

// A slot of the wrap's buffer, read from L2 (another SM wrote it; a line
// in L1 may hold the rows next to it from before).
static __device__ __forceinline__ ClSlot cl_ld_wrap(const ClSlot* p) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
  return ClSlot{v.x, v.y, v.z, (uint32_t)v.w};
}

}  // namespace

// One pair a cluster of gridDim-consecutive CTAs (cluster size = the
// launch's), `blockDim.x / 32` warps a CTA: G warps in a ring, warp g
// (CTA rank * warps + warp) running the pair's strips g, g + G, g + 2G,
// ..., each over its rows (`cl_first_row` .. `cl_last_row`, then one step
// for the last row's codes) in order.  A strip takes row i's hand-over
// from the strip on its left once that strip's pass 1 and scan of row i
// are done, and writes row i-1's code words then (its lane 0's word needs
// the left strip's last codes of row i-1, which come with that hand-over);
// its row i goes on to the strip on its right in the same way.
//
// No warp waits on a hand-over that depends on its own later work.  Each
// warp runs its steps (strip s, row i) in lexicographic order, and a step
// waits only for (s - 1, i) (its hand-over) or, at a ring in shared memory,
// for the warp of strip s + 1 to have taken the hand-over 32 before.  Take
// the least waiting step in that order: (s - 1, i) is less, so it is done
// or runs; the warp of s + 1 (another warp: the wrap carries the G = 1
// case) runs its strips before s + 1, whose steps are all less than (s,
// i), and then takes (s + 1, i - 32), which needs only (s, i - 32), done.
// The wrap's writer needs no wait: strip s + G writes row i's slot after
// (s + G, i), which follows (s + 1, i), where that slot was read, through
// the hand-overs of strips s + 2 .. s + G - 1 (of row i, or, where row i
// lies past a strip's last row, of its last step).
// The launch bound, 20 warps, holds the kernel to 96 registers a thread
// (spilling about 90 bytes), so that two CTAs of 10 warps share an SM:
// the `past_plan` cell's 128 pairs then fit the card in one wave (50.6 ms
// against 53.6 at 128 registers and 16 warps; PERF.md).
template <bool TRANS>
__global__ void __launch_bounds__(TA_CL_MAX_WARPS * 32)
    band_cluster_kernel(const uint8_t* __restrict__ a,
                        const uint8_t* __restrict__ b,
                        const int32_t* __restrict__ m,
                        const int32_t* __restrict__ n,
                        int32_t* __restrict__ out,
                        uint32_t* __restrict__ codes, int64_t a_stride,
                        int64_t b_stride, int unit_k, int64_t code_rows,
                        BandCosts k, int full, ClSlot* __restrict__ wrap) {
  namespace cg = cooperative_groups;
  __shared__ ClRing ring;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int NW = blockDim.x >> 5;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int64_t p = blockIdx.x / CS;
  const int32_t G = CS * NW;
  const int32_t g = r * NW + w;  // the warp's place in the ring
  const uint8_t* a_row = a + p * a_stride;
  const uint8_t* b_row = b + p * b_stride;
  // m is cut to the a row's length and the code rows, as in band_kernel
  const int64_t m64 = m[p] < a_stride ? m[p] : a_stride;
  const int32_t mm = (int32_t)(m64 < code_rows ? m64 : code_rows);
  const ClPair P = cl_pair(mm, n[p], unit_k, full != 0);
  uint32_t* code_out = codes + p * code_rows * P.wpr;
  ClSlot* wrap_row = wrap + p * (code_rows + 2);  // the wrap's slot of row i

  if (t < TA_CL_MAX_WARPS) ring.pub[t] = ring.taken[t] = 0;
  cluster.sync();  // no hand-over lands before its counters are set

  // the warp it takes from and the one it hands to; the wrap joins the
  // last to the first
  const int32_t gi = g > 0 ? g - 1 : G - 1, go = g + 1 < G ? g + 1 : 0;
  const bool in_wrap = g == 0, out_wrap = g == G - 1;
  const bool in_cta = !in_wrap && gi / NW == r;
  const bool out_cta = !out_wrap && go / NW == r;
  const ClSlot* in_slots = in_wrap ? wrap_row : ring.slot[w];
  const int* in_pub = &ring.pub[w];
  int* in_taken = nullptr;  // the sender's count of what this warp took
  if (!in_wrap)
    in_taken = in_cta ? &ring.taken[gi % NW]
                      : cluster.map_shared_rank(&ring.taken[gi % NW],
                                                (unsigned)(gi / NW));
  ClSlot* out_slots =
      out_wrap ? wrap_row
               : cluster.map_shared_rank(&ring.slot[go % NW][0],
                                         (unsigned)(go / NW));
  int* out_pub = cluster.map_shared_rank(&ring.pub[go % NW],
                                         (unsigned)(go / NW));
  const int* out_taken = &ring.taken[w];

  int seq_in = 0, seq_out = 0;  // hand-overs taken and given, all strips
  int seen_pub = 0;    // hand-overs put into this warp's ring, as last seen
  int seen_taken = 0;  // hand-overs the receiver has taken, as last seen
  for (int32_t s = g; s < P.S; s += G) {
    const int32_t kl = s * 32 + lane;  // the lane's place in the pair
    const int32_t jb = kl * TA_CL_COLS;
    ClLane<TRANS> L;
    cl_lane_init(L, b_row, b_stride, P, jb, k);
    const int32_t fcol = P.jf - jb;
    if (mm == 0 && fcol >= 0 && fcol < TA_CL_COLS)
      out[p] = cl_lane_pick(L, fcol);
    const int32_t first = cl_first_row(s, P), last = cl_last_row(s, P);
    const int32_t in_last = cl_in_last(s, P), out_first = cl_out_first(s, P);
    // the strip's left edge: D(i-1, jb-1), D(i-1, jb-2) of lane 0 and the
    // same of row i-2 (INF left of column 0 and above the first row)
    int32_t e1a = TA_BAND_INF, e1b = TA_BAND_INF;
    int32_t e2a = TA_BAND_INF, e2b = TA_BAND_INF;
    uint32_t vprev = 0u;  // the lane's codes of row i-1
    int32_t ach = first <= mm ? a_row[first - 1] : 0;
    int32_t apv = first > 1 ? a_row[first - 2] : -1;
    for (int32_t i = first;; ++i) {
      int32_t cin = TA_BAND_INF;
      uint32_t vleft = 0u;  // codes left of lane 0 at row i-1
      if (s == 0) {
        // a[i-2] is apv from row 2 on
        if (i > 1 && lane == 0)
          vleft = cl_left_of_zero(b_row, b_stride, unit_k, apv);
      } else {
        ClSlot sl = cl_slot_past();
        if (i <= in_last) {
          ++seq_in;
          if (seen_pub < seq_in) seen_pub = cl_wait(in_pub, seq_in, in_cta);
          sl = in_wrap ? cl_ld_wrap(in_slots + i)
                       : in_slots[seq_in % TA_CL_RING];
          __syncwarp();
          if (!in_wrap && lane == 0 &&
              (seq_in % TA_CL_BATCH == 0 || i == in_last))
            cl_st_release(in_taken, seq_in, in_cta);
        }
        cin = sl.f;
        vleft = sl.v;
        e2a = e1a;
        e2b = e1b;
        e1a = sl.d1;
        e1b = sl.d2;
      }
      // row i-1's words: each lane the word of its first cell, the last
      // lane also the next one where strip s + 1 does not run row i-1
      const uint32_t from_left = __shfl_up_sync(0xffffffffu, vprev, 1);
      const uint32_t left = lane == 0 ? vleft : from_left;
      auto store_words = [&]() {
        if (i == first) return;  // the strip ran no row i-1
        const int32_t wi = cl_word_index(kl, i - 1, unit_k);
        if (wi >= 0 && wi < P.wpr)
          code_out[(int64_t)(i - 2) * P.wpr + wi] =
              cl_word(left, vprev, i - 1, unit_k) & cl_word_mask(wi, P);
        if (lane == 31 && cl_writes_next_word(s, i - 1, P) && wi + 1 >= 0 &&
            wi + 1 < P.wpr)
          code_out[(int64_t)(i - 2) * P.wpr + wi + 1] =
              cl_word(vprev, TA_CL_ONES, i - 1, unit_k) &
              cl_word_mask(wi + 1, P);
      };
      // hand on row i: the chain into the next strip, D of row i-1 at the
      // strip's last two columns, the last lane's codes of row i-1
      auto hand_on = [&](int32_t f, bool release) {
        ++seq_out;
        if (!out_wrap && seen_taken < seq_out - TA_CL_RING)
          seen_taken = cl_wait(out_taken, seq_out - TA_CL_RING, out_cta);
        __syncwarp();
        if (lane == 31) {
          const ClSlot v{f, L.dp1[TA_CL_COLS - 1], L.dp1[TA_CL_COLS - 2],
                         vprev};
          if (out_wrap)
            out_slots[i] = v;
          else
            out_slots[seq_out % TA_CL_RING] = v;
          if (release || seq_out % TA_CL_BATCH == 0)
            cl_st_release(out_pub, seq_out, out_cta);
        }
      };
      if (i > last) {  // the strip's last step: row `last`'s codes, done
        if (i >= out_first) hand_on(TA_BAND_INF, true);
        store_words();
        break;
      }
      // from the lane on the left, or at lane 0 from the strip on the left
      const ClLeft own = cl_lane_right(L);
      ClLeft in;
      in.d1 = __shfl_up_sync(0xffffffffu, own.d1, 1);
      in.d0a = TRANS ? __shfl_up_sync(0xffffffffu, own.d0a, 1) : 0;
      in.d0b = TRANS ? __shfl_up_sync(0xffffffffu, own.d0b, 1) : 0;
      if (lane == 0) in = ClLeft{e1a, e2a, e2b};
      const ClRow R = cl_row(i, ach, P, jb);
      const int32_t an = i < mm ? a_row[i] : 0;  // the next row's character
      cl_lane_masks(L, R);
      const int32_t f_out = cl_lane_pass1(L, k, R, in);
      // inclusive min-scan of the keys over the warp, then exclusive
      int32_t inc = cl_key(f_out, lane, k.gc);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t v = __shfl_up_sync(0xffffffffu, inc, off);
        inc = lane >= off ? ta_min32(inc, v) : inc;
      }
      const int32_t ex = __shfl_up_sync(0xffffffffu, inc, 1);
      if (i >= out_first) hand_on(cl_carry(cin, inc, 32, k.gc), false);
      // the code words go out after the hand-over's release (which waits
      // for this thread's earlier stores) and drain during pass 2: row
      // i-1's lane words, and row i's words that no lane's first cell lies
      // in, shared by the strips that run row i
      store_words();
      for (int32_t x = cl_extra_first(s, lane, i, P),
                   dx = cl_extra_step(i, P);; x += dx) {
        const int32_t wx = cl_extra_index(x, i, P);
        if (wx < 0) break;
        code_out[(int64_t)(i - 1) * P.wpr + wx] =
            cl_extra_word(wx, i, ach, b_row, P);
      }
      vprev = cl_lane_pass2(L, k, R, in, cl_carry(cin, ex, lane, k.gc));
      // the final column lies inside the band at row m: its strip runs it
      if (i == mm && fcol >= 0 && fcol < TA_CL_COLS)
        out[p] = cl_lane_pick(L, fcol);
      apv = ach;
      ach = an;
    }
  }
  cluster.sync();  // no CTA leaves while a hand-over may still reach it
}

namespace {

struct BandLaunch {
  const uint8_t* a;
  const uint8_t* b;
  const int32_t* m;
  const int32_t* n;
  int32_t* out;
  uint32_t* codes;
  int64_t B, a_stride, b_stride;
  int unit_k;
  int64_t code_rows;
  BandCosts costs;
  int threads, cells, lanes;
  cudaStream_t stream;
};

template <bool TRANS, bool TRACE, int C>
static int launch_warp_c(const BandLaunch& g) {
  const int64_t warps = (g.B * g.lanes + 31) / 32;
  const int64_t blocks = (warps * 32 + g.threads - 1) / g.threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  band_kernel<TRANS, TRACE, C><<<(unsigned)blocks, g.threads, 0, g.stream>>>(
      g.a, g.b, g.m, g.n, g.out, g.codes, g.B, g.a_stride, g.b_stride,
      g.unit_k, g.code_rows, g.costs, g.lanes);
  return (int)cudaGetLastError();
}

template <bool TRANS, bool TRACE, int C, int MAXW>
static int launch_block_c(const BandLaunch& g, int warps) {
  band_block_kernel<TRANS, TRACE, C, MAXW>
      <<<(unsigned)g.B, warps * 32, 0, g.stream>>>(
          g.a, g.b, g.m, g.n, g.out, g.codes, g.a_stride, g.b_stride,
          g.unit_k, g.code_rows, g.costs);
  return (int)cudaGetLastError();
}

// 17 cells a lane past 16 warps take the 18-warp bound (96 registers)
template <bool TRANS, bool TRACE>
static int launch_block(const BandLaunch& g, int cells, int warps) {
  constexpr int W16 = TA_BAND_BLOCK_WARPS;
  if (cells == 9) return launch_block_c<TRANS, TRACE, 9, W16>(g, warps);
  return warps <= W16
             ? launch_block_c<TRANS, TRACE, 17, W16>(g, warps)
             : launch_block_c<TRANS, TRACE, 17, BandBlockWarps<17>::value>(
                   g, warps);
}

template <bool TRANS>
static int launch_cluster(const BandLaunch& g, int ctas, int warps, int full,
                          ClSlot* wrap) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.B * ctas), 1, 1);
  cfg.blockDim = dim3((unsigned)(warps * 32), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = g.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, band_cluster_kernel<TRANS>, g.a, g.b, g.m, g.n, g.out, g.codes,
      g.a_stride, g.b_stride, g.unit_k, g.code_rows, g.costs, full, wrap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool TRANS, bool TRACE>
static int launch_band(const BandLaunch& g) {
  switch (g.cells) {
    case 3: return launch_warp_c<TRANS, TRACE, 3>(g);
    case 5: return launch_warp_c<TRANS, TRACE, 5>(g);
    case 9: return launch_warp_c<TRANS, TRACE, 9>(g);
    case 17: return launch_warp_c<TRANS, TRACE, 17>(g);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point.  All pointers are device pointers; nothing is
// allocated or synchronised here.  `codes` null: distances only; else
// uint32 [B, code_rows, ceil(W / 16)] receives the packed argmin codes of
// rows 1..m of every pair (rows past m are left as they were).  The warp
// regime: `cells` cells a lane (3, 5, 9 or 17), `lanes` lanes a pair (8, 16
// or 32), cells * lanes >= W, `threads` a multiple of 32 up to 256.
// Returns the cudaError_t of the launch.
extern "C" int ta_band_distance(const void* a, const void* b, const void* m,
                                const void* n, void* out, void* codes,
                                int64_t B, int64_t a_stride, int64_t b_stride,
                                int unit_k, int64_t code_rows, int mc, int gc,
                                int sgc, int tc, int transpose, int threads,
                                int cells, int lanes, void* stream) {
  if (B <= 0) return 0;
  if (unit_k < 0 || threads < 32 || threads > TA_BAND_WARP_THREADS ||
      (threads & 31) || B > 0x7fffffffLL || a_stride < 1 ||
      b_stride < a_stride || !band_warp_map_ok(cells, lanes, 2 * unit_k + 1))
    return (int)cudaErrorInvalidValue;
  BandLaunch g;
  g.a = (const uint8_t*)a;
  g.b = (const uint8_t*)b;
  g.m = (const int32_t*)m;
  g.n = (const int32_t*)n;
  g.out = (int32_t*)out;
  g.codes = (uint32_t*)codes;
  g.B = B;
  g.a_stride = a_stride;
  g.b_stride = b_stride;
  g.unit_k = unit_k;
  g.code_rows = code_rows;
  g.costs = BandCosts{mc, gc, sgc, tc};
  g.threads = threads;
  g.cells = cells;
  g.lanes = lanes;
  g.stream = (cudaStream_t)stream;
  if (g.codes == nullptr)
    return transpose ? launch_band<true, false>(g) : launch_band<false, false>(g);
  return transpose ? launch_band<true, true>(g) : launch_band<false, true>(g);
}

// The block regime: one pair a block of `warps` warps, `cells` (9 or 17)
// cells a lane, 32 * cells * warps >= W, up to 16 warps at 9 cells and 18
// at 17.  Other arguments as ta_band_distance's.  Returns the cudaError_t
// of the launch.
extern "C" int ta_band_block(const void* a, const void* b, const void* m,
                             const void* n, void* out, void* codes,
                             int64_t B, int64_t a_stride, int64_t b_stride,
                             int unit_k, int64_t code_rows, int mc, int gc,
                             int sgc, int tc, int transpose, int cells,
                             int warps, void* stream) {
  if (B <= 0) return 0;
  if (!band_block_ok(unit_k, cells, warps) || B > 0x7fffffffLL ||
      a_stride < 1 || b_stride < a_stride)
    return (int)cudaErrorInvalidValue;
  BandLaunch g = {};
  g.a = (const uint8_t*)a;
  g.b = (const uint8_t*)b;
  g.m = (const int32_t*)m;
  g.n = (const int32_t*)n;
  g.out = (int32_t*)out;
  g.codes = (uint32_t*)codes;
  g.B = B;
  g.a_stride = a_stride;
  g.b_stride = b_stride;
  g.unit_k = unit_k;
  g.code_rows = code_rows;
  g.costs = BandCosts{mc, gc, sgc, tc};
  g.stream = (cudaStream_t)stream;
  if (g.codes == nullptr)
    return transpose ? launch_block<true, false>(g, cells, warps)
                     : launch_block<false, false>(g, cells, warps);
  return transpose ? launch_block<true, true>(g, cells, warps)
                   : launch_block<false, true>(g, cells, warps);
}

// The cluster regime of the traced kernel: `ctas` CTAs a pair (a cluster,
// 1 to 8) of `warps` warps (1 to 20), 16 columns a lane, the warps a ring
// over strips of 512 columns, any b length; `full` 0: the strips end past
// column n + 2 and the band's cells right of them are coded 1, which needs
// the chain's values there under INF (the plan: 255 * (rows + unit_k + 3)
// < INF); 1: the strips cover every band column.  `wrap`: B * (code_rows +
// 2) slots of 16 bytes in device memory, 16-byte aligned (the hand-overs
// from the last warp to the first; any contents).  Arguments as
// ta_band_distance's; `codes` must not be null.  Returns the cudaError_t
// of the launch.
extern "C" int ta_band_trace_cluster(const void* a, const void* b,
                                     const void* m, const void* n, void* out,
                                     void* codes, int64_t B, int64_t a_stride,
                                     int64_t b_stride, int unit_k,
                                     int64_t code_rows, int mc, int gc,
                                     int sgc, int tc, int transpose, int ctas,
                                     int warps, int full, void* wrap,
                                     void* stream) {
  if (B <= 0) return 0;
  if (codes == nullptr || wrap == nullptr || ((uintptr_t)wrap & 15) ||
      !band_cluster_ok(unit_k, ctas, warps, full) ||
      B * ctas > 0x7fffffffLL || a_stride < 1 || b_stride < a_stride ||
      code_rows < 1)
    return (int)cudaErrorInvalidValue;
  BandLaunch g = {};
  g.a = (const uint8_t*)a;
  g.b = (const uint8_t*)b;
  g.m = (const int32_t*)m;
  g.n = (const int32_t*)n;
  g.out = (int32_t*)out;
  g.codes = (uint32_t*)codes;
  g.B = B;
  g.a_stride = a_stride;
  g.b_stride = b_stride;
  g.unit_k = unit_k;
  g.code_rows = code_rows;
  g.costs = BandCosts{mc, gc, sgc, tc};
  g.stream = (cudaStream_t)stream;
  ClSlot* ring_wrap = (ClSlot*)wrap;
  return transpose ? launch_cluster<true>(g, ctas, warps, full, ring_wrap)
                   : launch_cluster<false>(g, ctas, warps, full, ring_wrap);
}

#endif  // TA_HOST_REHEARSAL
