// K5 blocked_distance / K6 blocked_search: unit-cost and restricted-Damerau
// Myers bit vectors over a needle of ANY length.
//
// Replaces three TPU kernels:
//   * triple_accel_tpu/ops/pallas/myers_chunked.py:_make_distance_kernel
//     (blocked_distance_chunked): exact distance D[m][n] of pairs of any
//     length, the anchored form (D[0][j] = j) with the score read at the
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
// step with the restricted-Damerau seeds, over ceil(m / 32) words of 32
// bits.  A word hands the word above it five boundary bits at the same
// column (the five of myers_chunked.py:24-29): the adder carry, the top
// bits of Ph and Mh, the top bit of Eq and, for the seeds, the top bit of
// NOT(D0) of the PREVIOUS column (kept by the sender, so the receiver needs
// no history).  Row 0: distance mode and anchored search inject Ph = 1
// below word 0, unanchored search injects nothing; word 0 gets Eq and
// NOT(D0) bits of 0, as in K2.  Bits above row m - 1 never reach rows
// below it, so they need no mask.
//
// What bounds it on an H100: integer operations.  Per column and 32 needle
// bits the function needs about 11 operations (15 with the seeds) against
// one text byte, so bytes never bind past a 1-word needle; chip_smoke.py
// counts both (K5_OPS_*, K6_OPS_*).  Within a column the words are
// strictly serial (the carry), and one item has one column at a time, so
// the design keeps every lane on useful words and every issue slot on the
// recurrence:
//   * a GROUP of G lanes (4, 8, 16 or 32, a warp holding 32 / G groups)
//     runs one work item (a segment; a pair in distance mode, G = 32).
//     Group lane l holds the W consecutive 32-bit words [l*W, (l+1)*W) of
//     a strip of G*W words (W in {1, 2, 3, 4, 6, 8, 12, 20}, a template
//     constant): the plan takes the map whose G*W slots cover the needle
//     with the least left over (3,000 chars = 94 words: 32 x 3, 16 x 6 or
//     8 x 12, not 64-bit words' 32 x 2 = 128);
//   * the adder is one add.cc / addc.cc chain over the lane's words
//     (ta_add_chain), the shifts with carry-in are funnel shifts;
//   * a diagonal wavefront over the columns: at step s group lane l runs
//     column s - d - l + 1 (d: the segment's first byte's offset in its
//     16-byte chunk), and ONE 32-bit word goes one lane up each step
//     (__shfl_up_sync of width G): the five boundary bits (bits 27-31) and
//     the byte offset of the column's row of the match table (bits 7-26).
//     Before its first column a lane sees code 0 (a zero row) and no
//     boundary bits, under which the initial state is a fixed point, so
//     the fill needs no branch and no predicate;
//   * group lane 0 reads the text 16 bytes at a time: every lane of the
//     group loads its group's chunk every 16 steps (a warp-uniform
//     condition: the stagger d puts every segment's chunk edges on the
//     same steps), the 16 steps of a chunk are unrolled so a step's byte
//     is a constant shift, and the byte -> table-row map sits in shared
//     memory;
//   * in search mode a block of 1 to 8 warps runs consecutive segments of
//     ONE needle and builds the byte map and the strip's match table once
//     for all of them, two block barriers a strip and none in the column
//     loop; the table is [code][word of lane][32 lane slots] (the group's
//     words repeated for each group of the warp), so a step's 32 lookups
//     fall into 32 banks.  Distance mode keeps one pair a block (a warp);
//   * needles longer than a strip run strip after strip, the group's top
//     lane writing each column's boundary bits to a byte row in global
//     memory that group lane 0 reads back, as a chunk stream, in the next
//     strip;
//   * search mode: the lane holding row m - 1 keeps the score and writes
//     four owned columns at a time in one predicated 16-byte store (the
//     four scores in registers named by the step's place in the chunk).
//     Distance mode keeps no score in the loop: at its column n each lane
//     adds its words' vertical deltas (popcount of Pv minus Mv over rows
//     < m) and the group sums them at the end: D[m][n] = n + that sum.
// The per-lane step, the table build and the store path are plain
// functions, so the host rehearsal (host_rehearsal.cpp, -DTA_HOST_REHEARSAL)
// runs exactly this arithmetic, lane by lane and warp by warp, with the
// shuffle replaced by an array.

#include <stddef.h>

#include "ta_common.cuh"

namespace {

constexpr int BLK_LANES = 32;
constexpr int BLK_CODES = 256;
constexpr int BLK_MAX_WARPS = 8;  // search mode: warps a block
constexpr int BLK_CHUNK = 16;     // text bytes a chunk, steps a chunk
// One table row's word i, all 32 lane slots: 128 bytes.
constexpr int BLK_ROW_WORD_BYTES = BLK_LANES * 4;
// The word a lane hands the lane above: the five boundary bits (the adder
// carry at bit 31, then the top bits below) and the byte offset of the
// column's table row.
constexpr uint32_t BLK_PH = 1u << 30;
constexpr uint32_t BLK_MH = 1u << 29;
constexpr uint32_t BLK_EQ = 1u << 28;
constexpr uint32_t BLK_ND = 1u << 27;
constexpr uint32_t BLK_OFF = 0x07FFFF80u;

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
  int32_t anchored;
  int32_t lanes;           // G: lanes a work item
  int32_t* out;            // distance: [B]; search: [num, out_stride]
  int64_t out_stride;
  uint8_t* scratch;        // boundary bits between strips, a row an item
  int64_t scratch_stride;
};

// One work item: a pair (distance) or a (needle, segment) (search).
struct BlkItem {
  const uint8_t* needle;
  const int16_t* codes;
  const uint8_t* text;  // 16-byte aligned: byte q is column q - d + 1
  int64_t text_len;     // readable bytes from `text`
  int32_t m;
  int32_t d;       // steps before column 1: the first byte's place in its chunk
  int32_t ncols;   // columns t = 1..ncols
  int32_t own_lo;  // search: owned columns (own_lo, ncols]
  int64_t col0;      // search: the segment's first byte
  int32_t* out_row;  // search: out_row[t] is end position col0 + t
  uint8_t* scratch;  // byte s - G + 1 of a strip: column t's boundary bits
};

template <bool SEARCH>
static TA_DEV BlkItem blk_item(const BlkArgs& g, int64_t x, int64_t y) {
  BlkItem it;
  if (SEARCH) {
    it.needle = g.needles + y * g.needle_stride;
    it.m = g.m;
    it.codes = g.codes + y * BLK_CODES;
    // x past the last segment: a group of a partly empty block, no columns
    const bool valid = x < g.nseg;
    const int64_t own0 = valid ? x * g.own_len : 0;
    int64_t own_end = own0 + g.own_len;
    if (own_end > g.text_len) own_end = g.text_len;
    int64_t col0 = own0 - g.halo;
    if (col0 < 0) col0 = 0;
    it.d = (int32_t)(col0 & (BLK_CHUNK - 1));
    it.text = g.text + (col0 - it.d);
    it.text_len = valid ? g.text_len - (col0 - it.d) : 0;
    it.ncols = valid && own_end > col0 ? (int32_t)(own_end - col0) : 0;
    it.own_lo = (int32_t)(own0 - col0);
    it.col0 = col0;
    it.out_row = g.out + y * g.out_stride + col0;
    it.scratch = g.scratch && valid
                     ? g.scratch + (y * g.nseg + x) * g.scratch_stride
                     : nullptr;
  } else {
    it.needle = g.needles + x * g.needle_stride;
    it.m = g.m_arr[x];
    it.codes = g.codes + x * BLK_CODES;
    it.text = g.text + x * g.text_stride;
    it.text_len = g.text_stride;
    it.d = 0;
    it.ncols = g.n_arr[x];
    it.own_lo = 0;
    it.col0 = 0;
    it.out_row = nullptr;
    it.scratch = g.scratch ? g.scratch + x * g.scratch_stride : nullptr;
  }
  return it;
}

// Where a needle of m chars lies in strips of G * W words.
struct BlkGeom {
  int32_t ns;                 // strips
  int32_t lane_S, i_S, offS;  // row m - 1 in the last strip: lane, word, bit
};

static TA_DEV BlkGeom blk_geom(int32_t m, int W, int G) {
  const int64_t strip_words = (int64_t)G * W;
  const int64_t nw = ((int64_t)m + 31) / 32;
  BlkGeom geo;
  geo.ns = (int32_t)((nw + strip_words - 1) / strip_words);
  const int64_t loc = nw - 1 - (int64_t)(geo.ns - 1) * strip_words;
  geo.lane_S = (int32_t)(loc / W);
  geo.i_S = (int32_t)(loc % W);
  geo.offS = (m - 1) & 31;
  return geo;
}

template <int W, bool DAM>
struct BlkLane {
  uint32_t Pv[W], Mv[W];
  uint32_t EqP[DAM ? W : 1], D0P[DAM ? W : 1];
  int32_t S;      // search: D[m][column], kept by the lane of row m - 1
  int32_t acc;    // distance: vertical deltas at column n, strips so far
  int32_t sb[4];  // search: the scores of steps s = 4q .. 4q + 3, slot s & 3
};

template <int W, bool DAM>
static TA_DEV void blk_reset(BlkLane<W, DAM>& L) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    L.Pv[i] = ~0u;
    L.Mv[i] = 0u;
    if constexpr (DAM) {
      L.EqP[i] = 0u;
      L.D0P[i] = 0u;
    }
  }
}

// One column for one lane's W words.  eq: the lane's entries of the table
// row of this column's character, word i at eq[i * BLK_LANES].  in: the
// word from the lane below (boundary bits 27-31).  Returns the boundary
// bits for the lane above; *ph / *mh get word score_i's Ph and Mh when
// SCORE.
template <int W, bool DAM, bool SCORE>
static TA_DEV uint32_t blk_column(BlkLane<W, DAM>& L, const uint32_t* eq,
                                  uint32_t in, int score_i, uint32_t* ph,
                                  uint32_t* mh) {
  uint32_t Eq[W], seeds[W], x[W], sum[W];
  uint32_t eq_lo = in << 3, nd_lo = in << 4;  // bit 31: the word below's
#pragma unroll
  for (int i = 0; i < W; ++i) {
    Eq[i] = eq[i * BLK_LANES];
    seeds[i] = Eq[i];
    if constexpr (DAM) {
      // a transposition at (r, t) seeds a zero diagonal when p[r] =
      // txt[t-1], p[r-1] = txt[t] and the previous column's diagonal
      // delta at row r-1 was +1
      const uint32_t nd = ~L.D0P[i];
      seeds[i] |= L.EqP[i] & ta_fshl1(eq_lo, Eq[i]) & ta_fshl1(nd_lo, nd);
      eq_lo = Eq[i];
      nd_lo = nd;
    }
    x[i] = seeds[i] & L.Pv[i];
  }
  const uint32_t carry = ta_add_chain<W>(sum, x, L.Pv, in);
  uint32_t ph_lo = in << 1, mh_lo = in << 2;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t pv = L.Pv[i], mv = L.Mv[i];
    const uint32_t Xh = (sum[i] ^ pv) | seeds[i];
    const uint32_t Ph = mv | ~(Xh | pv);
    const uint32_t Mh = pv & Xh;
    if constexpr (SCORE) {
      if (i == score_i) {
        *ph = Ph;
        *mh = Mh;
      }
    }
    const uint32_t PhS = ta_fshl1(ph_lo, Ph);
    const uint32_t MhS = ta_fshl1(mh_lo, Mh);
    ph_lo = Ph;
    mh_lo = Mh;
    // mv still holds the previous column's VN here
    const uint32_t D0 = DAM ? (Xh | mv) : (Eq[i] | mv);
    L.Pv[i] = MhS | ~(D0 | PhS);
    L.Mv[i] = PhS & D0;
    if constexpr (DAM) {
      L.EqP[i] = Eq[i];
      L.D0P[i] = D0;
    }
  }
  uint32_t out = (carry << 31) | ((ph_lo >> 1) & BLK_PH) |
                 ((mh_lo >> 2) & BLK_MH);
  if constexpr (DAM) out |= ((eq_lo >> 3) & BLK_EQ) | ((nd_lo >> 4) & BLK_ND);
  return out;
}

// Distance mode: the sum of the lane's vertical deltas over rows < m,
// the lane's word 0 starting at needle row row0.
template <int W, bool DAM>
static TA_DEV int32_t blk_vsum(const BlkLane<W, DAM>& L, int32_t m,
                               int64_t row0) {
  int32_t v = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int64_t left = (int64_t)m - (row0 + 32 * i);
    const uint32_t mk = left >= 32 ? ~0u
                        : left <= 0 ? 0u
                                    : (1u << (uint32_t)left) - 1u;
    v += ta_popc32(L.Pv[i] & mk) - ta_popc32(L.Mv[i] & mk);
  }
  return v;
}

// Lane slot l's words of strip `strip` of the match table, every code:
// tab[(code * W + i) * 32 + l], bit b set iff needle char
// ((strip * G + l % G) * W + i) * 32 + b exists and has that code.  The
// thread that calls it owns these entries (no other thread writes them).
template <int W>
static TA_DEV void blk_build_slot(uint32_t* tab, int rows, const BlkItem& it,
                                  int32_t strip, int G, int i, int l) {
  for (int r = 0; r < rows; ++r) tab[(r * W + i) * BLK_LANES + l] = 0u;
  const int64_t p0 =
      (((int64_t)strip * G + (l & (G - 1))) * W + i) * (int64_t)32;
  for (int b = 0; b < 32 && p0 + b < it.m; ++b) {
    const int c = it.codes[it.needle[p0 + b]];
    tab[(c * W + i) * BLK_LANES + l] |= 1u << b;
  }
}

// What the lanes of one strip share.
struct BlkStrip {
  const int32_t* map;       // byte -> byte offset of its table row
  const uint32_t* tab;      // the strip's table
  int G;
  bool first;
  uint32_t row0;            // first strip: boundary bits of row 0
  int32_t lane_S, i_S, offS;
  int phase;                // search: r at which the score lane stores
  int64_t scratch_len;      // bytes of a scratch row
};

// A lane's two chunk streams: the text (group lane 0's bytes; every lane
// of the group loads the same chunk) and the boundary bits of the strip
// below (strips after the first).
struct BlkIo {
  TaChunks txt, bits;
};

// Step s of group lane gl, byte k = s & 15 of the current chunks, r =
// s & 3.  `up` is what the lane below returned at step s - 1 (group lane
// 0 makes its own input).  Returns what the lane above takes at step
// s + 1.
template <int W, bool DAM, bool SEARCH, bool LAST>
static TA_DEV uint32_t blk_step(const BlkItem& it, const BlkStrip& sp,
                                BlkLane<W, DAM>& L, const BlkIo& io, int gl,
                                int lane, int64_t row0, int32_t s, int k,
                                int r, uint32_t up) {
  const int32_t t = s - it.d - gl + 1;  // this lane's column
  const bool live = (uint32_t)(t - 1) < (uint32_t)it.ncols;
  // group lane 0: the column's table row and the bits of row 0 or of the
  // strip below; nothing before its first column and after its last
  const uint32_t off = (uint32_t)sp.map[ta_byte_of(io.txt.cur, k)];
  const uint32_t b0 =
      sp.first ? sp.row0 : ta_byte_of(io.bits.cur, k) << 24;
  const uint32_t own0 = live ? (off | b0) : 0u;
  const uint32_t in = gl == 0 ? own0 : up;
  const uint32_t* eq = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(sp.tab + lane) + (in & BLK_OFF));
  uint32_t ph = 0u, mh = 0u;
  const uint32_t out =
      blk_column<W, DAM, SEARCH && LAST>(L, eq, in, sp.i_S, &ph, &mh) |
      (in & BLK_OFF);
  if constexpr (SEARCH && LAST) {
    const int32_t dS = (int32_t)((ph >> sp.offS) & 1u) -
                       (int32_t)((mh >> sp.offS) & 1u);
    L.S += live ? dS : 0;
    L.sb[r] = live ? L.S : L.sb[r];
    // four owned columns end here: one 16-byte store
    const bool at = gl == sp.lane_S && live && r == sp.phase;
    if (at && t - 3 > it.own_lo)
      ta_store4v(it.out_row + (t - 3), L.sb[(r + 1) & 3], L.sb[(r + 2) & 3],
                 L.sb[(r + 3) & 3], L.sb[r]);
    if (at && t - 3 <= it.own_lo && t > it.own_lo) {  // the segment's head
      if (t - 2 > it.own_lo) it.out_row[t - 2] = L.sb[(r + 2) & 3];
      if (t - 1 > it.own_lo) it.out_row[t - 1] = L.sb[(r + 3) & 3];
      it.out_row[t] = L.sb[r];
    }
  } else {
    if constexpr (!SEARCH) {
      if (t == it.ncols) L.acc += blk_vsum(L, it.m, row0);
    }
    if constexpr (!LAST) {
      if (live && gl == sp.G - 1)
        it.scratch[s - (sp.G - 1)] = (uint8_t)(out >> 24);
    }
  }
  return out;
}

// Search mode, after the last strip: the score lane's owned columns past
// its last four-column store (the segment's ragged tail).
template <int W, bool DAM>
static TA_DEV void blk_flush(const BlkItem& it, const BlkLane<W, DAM>& L,
                             int32_t lane_S) {
  // the last column t <= ncols with (col0 + t) % 4 == 3
  const int32_t tq = it.ncols - (int32_t)((it.col0 + it.ncols + 1) & 3);
  for (int32_t t = (tq > it.own_lo ? tq : it.own_lo) + 1; t <= it.ncols;
       ++t) {
    const int slot = (t + it.d + lane_S - 1) & 3;
    it.out_row[t] = slot == 0 ? L.sb[0]
                    : slot == 1 ? L.sb[1]
                    : slot == 2 ? L.sb[2]
                                : L.sb[3];
  }
}

// Steps a warp runs on a strip: its groups' longest stream, plus the fill
// up to the lane of row m - 1 (last strip) or the top lane.
static TA_DEV int32_t blk_steps(int32_t span, const BlkStrip& sp, bool last) {
  return span + (last ? sp.lane_S : sp.G - 1);
}

// Shared memory of a block: the byte map, then the table.
static inline size_t blk_smem_bytes(int rows, int wpt) {
  return (size_t)BLK_CODES * sizeof(int32_t) +
         (size_t)rows * wpt * BLK_LANES * sizeof(uint32_t);
}

static inline bool blk_wpt_ok(int wpt) {
  return wpt == 1 || wpt == 2 || wpt == 3 || wpt == 4 || wpt == 6 ||
         wpt == 8 || wpt == 12 || wpt == 20;
}

// What the launchers take: a table of 1..257 rows, a lane map the kernel
// is built for, the warps a block, and the shared memory a block may use.
static inline bool blk_plan_ok(int rows, int wpt, int lanes, int warps) {
  return rows >= 1 && rows <= BLK_CODES + 1 && blk_wpt_ok(wpt) &&
         (lanes == 4 || lanes == 8 || lanes == 16 || lanes == 32) &&
         warps >= 1 && warps <= BLK_MAX_WARPS &&
         blk_smem_bytes(rows, wpt) <= 232448;
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

// Four steps of one lane, r = 0..3 constants (the score slots); k0: the
// first step's byte in the chunk.
template <int W, bool DAM, bool SEARCH, bool LAST>
static __device__ __forceinline__ uint32_t blk_quad(
    const BlkItem& it, const BlkStrip& sp, BlkLane<W, DAM>& L,
    const BlkIo& io, int gl, int lane, int64_t row0, int32_t s, int k0,
    uint32_t up) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t out = blk_step<W, DAM, SEARCH, LAST>(
        it, sp, L, io, gl, lane, row0, s + r, k0 + r, r, up);
    up = __shfl_up_sync(0xffffffffu, out, 1, sp.G);
  }
  return up;
}

template <int W, bool DAM, bool SEARCH, bool LAST>
static __device__ __forceinline__ void blk_run_strip(
    const BlkItem& it, const BlkStrip& sp, BlkLane<W, DAM>& L, int gl,
    int lane, int64_t row0, int32_t steps) {
  BlkIo io;
  io.txt.start(it.text, it.text_len);
  if (!sp.first) io.bits.start(it.scratch, it.scratch ? sp.scratch_len : 0);
  uint32_t up = 0u;
  for (int32_t s0 = 0; s0 < steps; s0 += BLK_CHUNK) {
    io.txt.advance();
    if (!sp.first) io.bits.advance();
    if constexpr (W <= 6) {  // a step's byte a constant shift
#pragma unroll
      for (int k0 = 0; k0 < BLK_CHUNK; k0 += 4)
        up = blk_quad<W, DAM, SEARCH, LAST>(it, sp, L, io, gl, lane, row0,
                                            s0 + k0, k0, up);
    } else {  // long bodies: four steps unrolled
#pragma unroll 1
      for (int k0 = 0; k0 < BLK_CHUNK; k0 += 4)
        up = blk_quad<W, DAM, SEARCH, LAST>(it, sp, L, io, gl, lane, row0,
                                            s0 + k0, k0, up);
    }
  }
}

template <int W, bool DAM, bool SEARCH>
__global__ void __launch_bounds__(SEARCH ? BLK_LANES * BLK_MAX_WARPS
                                         : BLK_LANES)
    blocked_kernel(BlkArgs g) {
  extern __shared__ uint32_t blk_smem[];
  int32_t* map = reinterpret_cast<int32_t*>(blk_smem);
  uint32_t* tab = blk_smem + BLK_CODES;
  const int tid = threadIdx.x, lane = tid & 31;
  const int G = SEARCH ? g.lanes : BLK_LANES;
  const int gl = lane & (G - 1);
  const int64_t x = SEARCH ? (int64_t)blockIdx.x * (blockDim.x / G) + tid / G
                           : (int64_t)blockIdx.x;
  const int64_t y = blockIdx.y;
  BlkItem it = blk_item<SEARCH>(g, x, y);
  if (!SEARCH && it.m == 0) {  // D[0][n] is the caller's (n); one warp
    if (tid == 0) g.out[x] = 0;
    return;
  }
  for (int e = tid; e < BLK_CODES; e += blockDim.x)
    map[e] = it.codes[e] * (W * BLK_ROW_WORD_BYTES);
  if (SEARCH && x == 0 && gl == 0) it.out_row[0] = it.m;
  const BlkGeom geo = blk_geom(it.m, W, G);
  BlkStrip sp;
  sp.map = map;
  sp.tab = tab;
  sp.G = G;
  sp.row0 = g.anchored || !SEARCH ? BLK_PH : 0u;
  sp.lane_S = geo.lane_S;
  sp.i_S = geo.i_S;
  sp.offS = geo.offS;
  sp.phase = (geo.lane_S + 2) & 3;
  sp.scratch_len = g.scratch_stride;
  BlkLane<W, DAM> L;
  L.S = it.m;
  L.acc = 0;
  L.sb[0] = L.sb[1] = L.sb[2] = L.sb[3] = 0;
  const int32_t span =
      (int32_t)__reduce_max_sync(0xffffffffu, (unsigned)(it.d + it.ncols));
  for (int32_t strip = 0; strip < geo.ns; ++strip) {
    const bool last = strip == geo.ns - 1;
    sp.first = strip == 0;
    __syncthreads();  // the map is written; the last strip's table is read
    for (int e = tid; e < W * BLK_LANES; e += blockDim.x)
      blk_build_slot<W>(tab, g.rows, it, strip, G, e / BLK_LANES,
                        e % BLK_LANES);
    __syncthreads();
    blk_reset(L);
    const int64_t row0 = ((int64_t)strip * G + gl) * W * 32;
    if (!SEARCH && it.ncols == 0) L.acc += blk_vsum(L, it.m, row0);
    const int32_t steps = blk_steps(span, sp, last);
    if (last)
      blk_run_strip<W, DAM, SEARCH, true>(it, sp, L, gl, lane, row0, steps);
    else
      blk_run_strip<W, DAM, SEARCH, false>(it, sp, L, gl, lane, row0, steps);
  }
  if (SEARCH) {
    if (gl == geo.lane_S)
      blk_flush(it, L, geo.lane_S);
  } else {
    int32_t v = L.acc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tid == 0) g.out[x] = it.ncols + v;
  }
}

template <int W, bool DAM, bool SEARCH>
static int launch_blocked(const BlkArgs& g, int64_t gx, int64_t gy,
                          int threads, cudaStream_t stream) {
  const size_t smem = blk_smem_bytes(g.rows, W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked_kernel<W, DAM, SEARCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  blocked_kernel<W, DAM, SEARCH>
      <<<dim3((unsigned)gx, (unsigned)gy), threads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <bool DAM, bool SEARCH>
static int launch_wpt(int wpt, const BlkArgs& g, int64_t gx, int64_t gy,
                      int threads, cudaStream_t st) {
  switch (wpt) {
#define TA_BLK_CASE(WW) \
  case WW:              \
    return launch_blocked<WW, DAM, SEARCH>(g, gx, gy, threads, st);
    TA_BLK_CASE(1)
    TA_BLK_CASE(2)
    TA_BLK_CASE(3)
    TA_BLK_CASE(4)
    TA_BLK_CASE(6)
    TA_BLK_CASE(8)
    TA_BLK_CASE(12)
    TA_BLK_CASE(20)
#undef TA_BLK_CASE
    default:
      return (int)cudaErrorInvalidValue;
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
// spans more than one strip, else unused.  One pair a block, 32 lanes.
extern "C" int ta_blocked_distance(const void* a, const void* b,
                                   const void* m, const void* n,
                                   const void* codes, int rows, int wpt,
                                   void* out, int64_t B, int64_t a_stride,
                                   int64_t b_stride, void* scratch,
                                   int64_t scratch_stride, int damerau,
                                   void* stream) {
  if (B <= 0) return 0;
  if (!blk_plan_ok(rows, wpt, BLK_LANES, 1) || B > 2147483647LL ||
      (b_stride & 15) || (scratch_stride & 15))
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
  g.lanes = BLK_LANES;
  g.out = (int32_t*)out;
  g.scratch = (uint8_t*)scratch;
  g.scratch_stride = scratch_stride;
  cudaStream_t st = (cudaStream_t)stream;
  return damerau ? launch_wpt<true, false>(wpt, g, B, 1, BLK_LANES, st)
                 : launch_wpt<false, false>(wpt, g, B, 1, BLK_LANES, st);
}

// K6.  hay: the raw haystack, 16-byte aligned; needles: [num, m]; codes:
// int16 [num, 256]; out: int32 [num, out_stride] as for ta_myers_search.
// lanes: G, lanes a segment; warps: warps a block (a block runs
// warps * 32 / G consecutive segments of one needle).  A segment reads at
// most own_len + halo < 2^31 - 16 bytes.  scratch: [num * nseg,
// scratch_stride] bytes (stride >= halo + own_len + 15, a multiple of 16)
// when the needle spans more than one strip.
extern "C" int ta_blocked_search(const void* hay, int64_t iter_len,
                                 const void* needles, int num, int m,
                                 const void* codes, int rows, int wpt,
                                 int lanes, int warps, int64_t own_len,
                                 int64_t halo, int64_t nseg, int anchored,
                                 int damerau, void* out, int64_t out_stride,
                                 void* scratch, int64_t scratch_stride,
                                 void* stream) {
  if (num <= 0) return 0;
  if (!blk_plan_ok(rows, wpt, lanes, warps) || m < 1 || own_len < 1 ||
      halo < 0 || own_len + halo > 2147483647LL - 16 || nseg < 1 ||
      num > 65535 || out_stride < iter_len + 1 || (out_stride & 3) ||
      (scratch_stride & 15) || ((uintptr_t)hay & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)warps * (BLK_LANES / lanes);
  const int64_t gx = (nseg + per_block - 1) / per_block;
  if (gx > 2147483647LL) return (int)cudaErrorInvalidValue;
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
  g.lanes = lanes;
  g.out = (int32_t*)out;
  g.out_stride = out_stride;
  g.scratch = (uint8_t*)scratch;
  g.scratch_stride = scratch_stride;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = warps * BLK_LANES;
  return damerau ? launch_wpt<true, true>(wpt, g, gx, num, threads, st)
                 : launch_wpt<false, true>(wpt, g, gx, num, threads, st);
}

#endif  // TA_HOST_REHEARSAL
