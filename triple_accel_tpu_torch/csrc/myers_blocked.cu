// K5 blocked_distance / K6 blocked_search: unit-cost and restricted-Damerau
// Myers bit vectors over a needle of ANY length.
//
// Replaces three TPU kernels:
//   * triple_accel_tpu/ops/pallas/myers_chunked.py:_make_distance_kernel
//     (blocked_distance_chunked): exact distance D[m][n] of pairs of any
//     length, the anchored form (D[0][j] = j) with the score captured at the
//     pair's own n.  Here: K5, the distance mode of blocked_kernel.
//   * triple_accel_tpu/ops/pallas/search_myers.py:_make_blocked_kernel
//     (blocked_search_pallas) and myers_chunked.py:_make_search_kernel
//     (blocked_search_chunked): D[m][j] at every end position j for needles
//     of any length, anchored or not, any halo.  Here: K6, the search mode.
//     The TPU needed two of them because its fast memory had to hold a
//     whole text segment (blocked) or not (chunked); here the text streams
//     from global memory, so one engine serves every needle length and
//     every halo, and it writes K2's plain global layout
//     out[needle][j], j in [0, iter_len], from the RAW haystack (segments
//     as in csrc/myers_search.cu: segment c owns (c*own_len, (c+1)*own_len],
//     segment 0 also owns 0, and starts `halo` bytes earlier, or at byte 0).
//
// The function per column is K2's (csrc/myers_search.cu): the Myers adder
// step with the restricted-Damerau seeds, over ceil(m / 64) words.  A word
// hands the word above it five boundary bits at the same column (the five
// of myers_chunked.py:24-29): the adder carry, the top bits of Ph and Mh,
// the top bit of Eq and, for the seeds, the top bit of NOT(D0) of the
// PREVIOUS column (kept by the sender, so the receiver needs no history).
// Row 0: distance mode and anchored search inject Ph = 1 below word 0,
// unanchored search injects nothing; word 0 gets Eq and NOT(D0) bits of 0,
// as in K2 (myers_chunked.py:65-66, _PREFILL_ANCHORED).  Bits above row
// m - 1 never reach rows below it, so they need no mask.
//
// What bounds it on an H100: integer operations.  Per column and 32 needle
// bits the function needs about 11 operations (15 with the seeds) against
// one text byte, so bytes never bind past a 1-word needle; chip_smoke.py
// counts both (K5_OPS_*, K6_OPS_*).  What the design has to beat is the
// carry chain: within a column the words are strictly serial, and a pair
// has only one column at a time.  The design (first version: right and
// simple, not yet fast):
//   * one warp per work item (pair or segment), a block each.  Lane l holds
//     words [l*WPT, (l+1)*WPT) of a strip of 32*WPT words (WPT in
//     {1, 2, 4, 6, 10}: the 20,000-char pairs of the main path fit ONE
//     strip of 10 words a lane), all state in registers;
//   * a diagonal wavefront over the columns: at step s lane l runs column
//     s - l + 1, and the boundary bits go one lane up with one
//     __shfl_up_sync a step, the column's character code riding along in
//     the same word.  The fill costs 31 steps against thousands of columns;
//   * needles longer than a strip run strip after strip in the same warp,
//     the top lane writing each column's boundary bits to a byte row in
//     global memory that lane 0 reads back in the next strip;
//   * the match table Peq cannot hold 256 characters at this length (at
//     20,000 chars 640 KB against the 227 KB a block may use), so each
//     needle gets a compact alphabet: code 0 for bytes it lacks (a zero
//     row), 1..sigma for the bytes it holds (the wrapper computes the map,
//     any byte value, NUL included).  Peq is (sigma + 1) rows of the
//     strip's words in shared memory, laid out [code][word of lane][lane],
//     so a step's 32 lookups fall into 32 banks (13 KB at 4 letters and 10
//     words a lane; a full-byte needle takes WPT <= 2, 132 KB);
//   * lane 0 alone reads the text, 16 bytes at a time with the next 16 in
//     flight, maps the byte to its code and sends it up the wavefront; the
//     lane holding row m - 1 keeps the score, and in search mode writes
//     four owned columns at a time in one 16-byte store, as K2 does.
// The per-lane step, the table build, the streams and the store path are
// plain functions, so the host rehearsal (host_rehearsal.cpp,
// -DTA_HOST_REHEARSAL) runs exactly this arithmetic, lane by lane, with the
// shuffle replaced by an array.

#include <stddef.h>

#include "ta_common.cuh"

namespace {

constexpr int BLK_LANES = 32;
constexpr int BLK_CODES = 256;
constexpr uint32_t BLK_BITS = 31u;  // the five boundary bits, bits 0..4
constexpr uint32_t BLK_PH_IN = 2u;  // boundary word of row 0, anchored

struct BlkArgs {
  const uint8_t* needles;  // distance: a rows; search: num x m bytes
  int64_t needle_stride;   // bytes between two needles
  const int32_t* m_arr;    // distance: per pair (nullptr in search mode)
  int32_t m;               // search: the needle length
  const int16_t* codes;    // [needles, 256] byte -> code, 0 = not in it
  int32_t rows;            // table rows: largest code + 1
  const uint8_t* text;     // distance: b rows; search: the haystack
  int64_t text_stride;     // distance: row stride, a multiple of 16
  const int32_t* n_arr;    // distance: per pair
  int64_t text_len;        // search: iter_len
  int64_t own_len, halo;   // search
  int64_t nseg;            // search: segments per needle
  int32_t anchored, search;
  int32_t* out;            // distance: [B]; search: [num, out_stride]
  int64_t out_stride;
  uint8_t* scratch;        // boundary bits between strips, a row an item
  int64_t scratch_stride;
};

// One work item: a pair (distance) or a (needle, segment) (search).
struct BlkItem {
  const uint8_t* needle;
  int32_t m;
  const int16_t* codes;
  const uint8_t* text;
  int64_t text_len;       // readable bytes from `text`
  int64_t col0, ncols;    // columns t = 1..ncols read byte col0 + t - 1
  int64_t own0, own_end;  // search: owned end positions (own0, own_end]
  int32_t* out_row;
  uint8_t* scratch;
};

static TA_DEV BlkItem blk_item(const BlkArgs& g, int64_t x, int64_t y) {
  BlkItem it;
  if (g.search) {
    it.needle = g.needles + y * g.needle_stride;
    it.m = g.m;
    it.codes = g.codes + y * BLK_CODES;
    it.text = g.text;
    it.text_len = g.text_len;
    it.own0 = x * g.own_len;
    it.own_end = it.own0 + g.own_len;
    if (it.own_end > g.text_len) it.own_end = g.text_len;
    it.col0 = it.own0 - g.halo;
    if (it.col0 < 0) it.col0 = 0;
    it.ncols = it.own_end > it.col0 ? it.own_end - it.col0 : 0;
    it.out_row = g.out + y * g.out_stride;
    it.scratch = g.scratch ? g.scratch + (y * g.nseg + x) * g.scratch_stride
                           : nullptr;
  } else {
    it.needle = g.needles + x * g.needle_stride;
    it.m = g.m_arr[x];
    it.codes = g.codes + x * BLK_CODES;
    it.text = g.text + x * g.text_stride;
    it.text_len = g.text_stride;
    it.col0 = 0;
    it.ncols = g.n_arr[x];
    it.own0 = it.own_end = 0;
    it.out_row = nullptr;
    it.scratch = g.scratch ? g.scratch + x * g.scratch_stride : nullptr;
  }
  return it;
}

// Where a needle of m chars lies in strips of 32 * WPT words.
struct BlkGeom {
  int64_t ns;            // strips
  int lane_S, i_S, offS;  // row m - 1: lane, word of the lane, bit
};

template <int WPT>
static TA_DEV BlkGeom blk_geom(int32_t m) {
  const int64_t strip_words = (int64_t)BLK_LANES * WPT;
  const int64_t nw = ((int64_t)m + 63) / 64;
  const int64_t wS = ((int64_t)m - 1) / 64;
  BlkGeom geo;
  geo.ns = (nw + strip_words - 1) / strip_words;
  geo.lane_S = (int)((wS % strip_words) / WPT);
  geo.i_S = (int)(wS % WPT);
  geo.offS = (int)(((int64_t)m - 1) & 63);
  return geo;
}

template <int WPT, bool DAM>
struct BlkLane {
  uint64_t Pv[WPT], Mv[WPT];
  uint64_t EqP[DAM ? WPT : 1], D0P[DAM ? WPT : 1];
  int32_t S;  // D[m][column], kept by the lane that holds row m - 1
};

template <int WPT, bool DAM>
static TA_DEV void blk_reset(BlkLane<WPT, DAM>& L, int32_t m) {
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    L.Pv[i] = ~0ull;
    L.Mv[i] = 0ull;
    if constexpr (DAM) {
      L.EqP[i] = 0ull;
      L.D0P[i] = 0ull;
    }
  }
  L.S = m;
}

// One column for one lane's WPT words.  eq: the lane's entry of the table
// row of this column's character, word i at eq[i * BLK_LANES].  bits: the
// boundary bits from the word below.  score_i: the lane's word holding row
// m - 1, or -1.  Returns the boundary bits for the word above.
template <int WPT, bool DAM>
static TA_DEV uint32_t blk_column(BlkLane<WPT, DAM>& L, const uint64_t* eq,
                                  uint32_t bits, int score_i, int offS) {
  uint64_t carry = bits & 1u;        // adder carry into word i
  uint64_t ph_c = (bits >> 1) & 1u;  // top bit of Ph, word i - 1
  uint64_t mh_c = (bits >> 2) & 1u;  // top bit of Mh, word i - 1
  uint64_t eq_c = (bits >> 3) & 1u;  // top bit of Eq, word i - 1
  uint64_t nd_c = (bits >> 4) & 1u;  // top bit of ~D0P, word i - 1
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const uint64_t Eq = eq[i * BLK_LANES];
    uint64_t seeds = Eq;
    if constexpr (DAM) {
      // a transposition at (r, t) seeds a zero diagonal when p[r] =
      // txt[t-1], p[r-1] = txt[t] and the previous column's diagonal
      // delta at row r-1 was +1
      const uint64_t nd = ~L.D0P[i];
      seeds |= L.EqP[i] & ((Eq << 1) | eq_c) & ((nd << 1) | nd_c);
      eq_c = Eq >> 63;
      nd_c = nd >> 63;
    }
    const uint64_t pv = L.Pv[i], mv = L.Mv[i];
    const uint64_t x = seeds & pv;
    const uint64_t s1 = x + pv;
    const uint64_t c1 = s1 < x ? 1ull : 0ull;
    const uint64_t s2 = s1 + carry;
    const uint64_t c2 = s2 < s1 ? 1ull : 0ull;
    carry = c1 | c2;
    const uint64_t Xh = (s2 ^ pv) | seeds;
    const uint64_t Ph = mv | ~(Xh | pv);
    const uint64_t Mh = pv & Xh;
    if (i == score_i)
      L.S += (int32_t)((Ph >> offS) & 1ull) - (int32_t)((Mh >> offS) & 1ull);
    const uint64_t PhS = (Ph << 1) | ph_c;
    const uint64_t MhS = (Mh << 1) | mh_c;
    ph_c = Ph >> 63;
    mh_c = Mh >> 63;
    // mv still holds the previous column's VN here
    const uint64_t D0 = DAM ? (Xh | mv) : (Eq | mv);
    L.Pv[i] = MhS | ~(D0 | PhS);
    L.Mv[i] = PhS & D0;
    if constexpr (DAM) {
      L.EqP[i] = Eq;
      L.D0P[i] = D0;
    }
  }
  return (uint32_t)(carry | (ph_c << 1) | (mh_c << 2) | (eq_c << 3) |
                    (nd_c << 4));
}

// Lane `lane`'s words of strip `strip` of the match table:
// tab[(code * WPT + i) * 32 + lane], bit b of word i set iff needle char
// (strip * 32 * WPT + lane * WPT + i) * 64 + b exists and has that code.
template <int WPT>
static TA_DEV void blk_build(uint64_t* tab, int rows, const BlkItem& it,
                             int64_t strip, int lane) {
  for (int r = 0; r < rows; ++r)
    for (int i = 0; i < WPT; ++i)
      tab[((int64_t)r * WPT + i) * BLK_LANES + lane] = 0ull;
  for (int i = 0; i < WPT; ++i) {
    const int64_t p0 =
        ((strip * BLK_LANES + lane) * WPT + i) * (int64_t)64;
    for (int b = 0; b < 64 && p0 + b < it.m; ++b) {
      const int c = it.codes[it.needle[p0 + b]];
      tab[((int64_t)c * WPT + i) * BLK_LANES + lane] |= 1ull << b;
    }
  }
}

using BlkStream = TaStream;  // ta_common.cuh

// Search mode: the owned scores of one segment, four columns in one
// aligned 16-byte store where the segment owns all four (row stride a
// multiple of 4 ints), as in csrc/myers_search.cu.
struct BlkSink {
  int32_t sbuf[4];

  TA_DEV void put(const BlkItem& it, int64_t j, int32_t S) {
    sbuf[j & 3] = S;
    if ((j & 3) == 3) {
      if (j - 3 > it.own0) {
        ta_store4(it.out_row + (j - 3), sbuf);
      } else {
        for (int64_t jj = it.own0 + 1; jj <= j; ++jj)
          it.out_row[jj] = sbuf[jj & 3];
      }
    }
  }
  TA_DEV void flush(const BlkItem& it) {  // the last, partial group of four
    int64_t jj = it.own_end & ~(int64_t)3;
    if (jj <= it.own0) jj = it.own0 + 1;
    if ((it.own_end & 3) != 3)
      for (; jj <= it.own_end; ++jj) it.out_row[jj] = sbuf[jj & 3];
  }
};

struct BlkStrip {
  const uint64_t* tab;
  bool first, last;
  BlkGeom geo;
};

// Wavefront step s of lane `lane`: column t = s - lane + 1 of the strip.
// `in` is what the lane below returned at step s - 1 (lane 0: ignored, it
// reads the text and the boundary bits itself).  Returns what the lane
// above takes at step s + 1: the boundary bits and the character code.
template <int WPT, bool DAM>
static TA_DEV uint32_t blk_step(const BlkArgs& g, const BlkItem& it,
                                const BlkStrip& sp, BlkLane<WPT, DAM>& L,
                                BlkStream& txt, BlkStream& bits,
                                BlkSink& sink, int lane, int64_t s,
                                uint32_t in) {
  const int64_t t = s - lane + 1;
  if (lane == 0 && t <= it.ncols) {
    const uint32_t ch = txt.at(it.col0 + t - 1);
    const uint32_t b =
        sp.first ? (g.anchored ? BLK_PH_IN : 0u) : bits.at(t - 1);
    in = b | ((uint32_t)it.codes[ch] << 8);
  }
  if (t < 1 || t > it.ncols) return 0u;
  const uint64_t* eq =
      sp.tab + (int64_t)(in >> 8) * (WPT * BLK_LANES) + lane;
  const bool score = sp.last && lane == sp.geo.lane_S;
  const uint32_t out = blk_column<WPT, DAM>(
      L, eq, in & BLK_BITS, score ? sp.geo.i_S : -1, sp.geo.offS);
  if (score && g.search) {
    const int64_t j = it.col0 + t;  // end position of column t
    if (j > it.own0) sink.put(it, j, L.S);
  }
  if (!sp.last && lane == BLK_LANES - 1) it.scratch[t - 1] = (uint8_t)out;
  return out | (in & ~BLK_BITS);
}

// Steps of a strip's wavefront: the last strip stops once the lane of row
// m - 1 has run the last column.
static TA_DEV int64_t blk_steps(const BlkItem& it, const BlkStrip& sp) {
  return it.ncols + (sp.last ? sp.geo.lane_S : BLK_LANES - 1);
}

// Shared memory of one block: the code map, then the table.
static inline size_t blk_smem_bytes(int rows, int wpt) {
  return (size_t)BLK_CODES * sizeof(int16_t) +
         (size_t)rows * wpt * BLK_LANES * sizeof(uint64_t);
}

// What the launchers take: a table of 1..257 rows, a word count a lane
// the kernel is built for, and the shared memory a block may use.
static inline bool blk_plan_ok(int rows, int wpt) {
  return rows >= 1 && rows <= BLK_CODES + 1 &&
         (wpt == 1 || wpt == 2 || wpt == 4 || wpt == 6 || wpt == 10) &&
         blk_smem_bytes(rows, wpt) <= 232448;
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

template <int WPT, bool DAM>
__global__ void __launch_bounds__(BLK_LANES) blocked_kernel(BlkArgs g) {
  extern __shared__ uint64_t blk_smem[];
  int16_t* codes = reinterpret_cast<int16_t*>(blk_smem);
  uint64_t* tab = blk_smem + BLK_CODES * sizeof(int16_t) / sizeof(uint64_t);
  const int lane = threadIdx.x;
  BlkItem it = blk_item(g, blockIdx.x, blockIdx.y);
  if (it.m == 0) {  // distance mode only: D[0][n] is the caller's (n)
    if (lane == 0) g.out[blockIdx.x] = 0;
    return;
  }
  if (g.search && blockIdx.x == 0 && lane == 0) it.out_row[0] = it.m;
  for (int e = lane; e < BLK_CODES; e += BLK_LANES) codes[e] = it.codes[e];
  it.codes = codes;
  __syncwarp();
  BlkStrip sp;
  sp.tab = tab;
  sp.geo = blk_geom<WPT>(it.m);
  BlkLane<WPT, DAM> L;
  BlkStream txt, bits;
  BlkSink sink;
  for (int64_t strip = 0; strip < sp.geo.ns; ++strip) {
    sp.first = strip == 0;
    sp.last = strip == sp.geo.ns - 1;
    blk_build<WPT>(tab, g.rows, it, strip, lane);
    blk_reset(L, it.m);
    txt.start(it.text, it.text_len);
    bits.start(it.scratch, it.ncols);
    __syncwarp();  // the table, and the previous strip's boundary bits
    const int64_t steps = blk_steps(it, sp);
    uint32_t in = 0u;
    for (int64_t s = 0; s < steps; ++s) {
      const uint32_t out = blk_step<WPT, DAM>(g, it, sp, L, txt, bits, sink,
                                              lane, s, in);
      in = __shfl_up_sync(0xffffffffu, out, 1);
    }
    __syncwarp();
  }
  if (lane == sp.geo.lane_S) {
    if (g.search)
      sink.flush(it);
    else
      g.out[blockIdx.x] = L.S;
  }
}

template <int WPT, bool DAM>
static int launch_blocked(const BlkArgs& g, int64_t gx, int64_t gy,
                          cudaStream_t stream) {
  const size_t smem = blk_smem_bytes(g.rows, WPT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked_kernel<WPT, DAM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  blocked_kernel<WPT, DAM>
      <<<dim3((unsigned)gx, (unsigned)gy), BLK_LANES, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <bool DAM>
static int launch_wpt(int wpt, const BlkArgs& g, int64_t gx, int64_t gy,
                      cudaStream_t st) {
  switch (wpt) {
    case 1: return launch_blocked<1, DAM>(g, gx, gy, st);
    case 2: return launch_blocked<2, DAM>(g, gx, gy, st);
    case 4: return launch_blocked<4, DAM>(g, gx, gy, st);
    case 6: return launch_blocked<6, DAM>(g, gx, gy, st);
    case 10: return launch_blocked<10, DAM>(g, gx, gy, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Plain C entry points.  All pointers are device pointers; nothing is
// allocated or synchronised here.  Each returns the cudaError_t of the
// launch.
//
// K5.  a: [B, a_stride] needle rows, b: [B, b_stride] text rows (b_stride
// a multiple of 16, base 16-byte aligned), m / n: int32 [B], codes: int16
// [B, 256], out: int32 [B] (D[m][n]; 0 where m == 0).  scratch: [B,
// scratch_stride] bytes (stride >= max n, a multiple of 16) when a needle
// spans more than one strip, else unused.
extern "C" int ta_blocked_distance(const void* a, const void* b,
                                   const void* m, const void* n,
                                   const void* codes, int rows, int wpt,
                                   void* out, int64_t B, int64_t a_stride,
                                   int64_t b_stride, void* scratch,
                                   int64_t scratch_stride, int damerau,
                                   void* stream) {
  if (B <= 0) return 0;
  if (!blk_plan_ok(rows, wpt) || B > 2147483647LL || (b_stride & 15) ||
      (scratch_stride & 15))
    return (int)cudaErrorInvalidValue;
  BlkArgs g = {};
  g.needles = (const uint8_t*)a;
  g.needle_stride = a_stride;
  g.m_arr = (const int32_t*)m;
  g.codes = (const int16_t*)codes;
  g.rows = rows;
  g.text = (const uint8_t*)b;
  g.text_stride = b_stride;
  g.n_arr = (const int32_t*)n;
  g.anchored = 1;
  g.search = 0;
  g.out = (int32_t*)out;
  g.scratch = (uint8_t*)scratch;
  g.scratch_stride = scratch_stride;
  cudaStream_t st = (cudaStream_t)stream;
  return damerau ? launch_wpt<true>(wpt, g, B, 1, st)
                 : launch_wpt<false>(wpt, g, B, 1, st);
}

// K6.  hay: the raw haystack, 16-byte aligned; needles: [num, m]; codes:
// int16 [num, 256]; out: int32 [num, out_stride] as for ta_myers_search.
// scratch: [num * nseg, scratch_stride] bytes (stride >= halo + own_len, a
// multiple of 16) when the needle spans more than one strip.
extern "C" int ta_blocked_search(const void* hay, int64_t iter_len,
                                 const void* needles, int num, int m,
                                 const void* codes, int rows, int wpt,
                                 int64_t own_len, int64_t halo, int64_t nseg,
                                 int anchored, int damerau, void* out,
                                 int64_t out_stride, void* scratch,
                                 int64_t scratch_stride, void* stream) {
  if (num <= 0) return 0;
  if (!blk_plan_ok(rows, wpt) || m < 1 || own_len < 1 || halo < 0 ||
      nseg < 1 || nseg > 2147483647LL || num > 65535 ||
      out_stride < iter_len + 1 || (out_stride & 3) ||
      (scratch_stride & 15))
    return (int)cudaErrorInvalidValue;
  BlkArgs g = {};
  g.needles = (const uint8_t*)needles;
  g.needle_stride = m;
  g.m = m;
  g.codes = (const int16_t*)codes;
  g.rows = rows;
  g.text = (const uint8_t*)hay;
  g.text_len = iter_len;
  g.own_len = own_len;
  g.halo = halo;
  g.nseg = nseg;
  g.anchored = anchored;
  g.search = 1;
  g.out = (int32_t*)out;
  g.out_stride = out_stride;
  g.scratch = (uint8_t*)scratch;
  g.scratch_stride = scratch_stride;
  cudaStream_t st = (cudaStream_t)stream;
  return damerau ? launch_wpt<true>(wpt, g, nseg, num, st)
                 : launch_wpt<false>(wpt, g, nseg, num, st);
}

#endif  // TA_HOST_REHEARSAL
