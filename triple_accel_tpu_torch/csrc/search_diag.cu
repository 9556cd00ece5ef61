// K7 search_diag: general-cost approximate search (mismatch, affine gap and
// transposition costs) with the reference's match lengths, for needles of
// up to 512 chars.
//
// Replaces the TPU kernel triple_accel_tpu/ops/pallas/search_kernel.py:
// _make_kernel (search_pallas, search_pallas_block_mins).  The TPU kernel
// kept four diagonals of the whole needle axis in rings of VMEM scratch, a
// layout its compiler forced; the function is what counts, and it is the
// plain version's, ops/search_scan.py: for every end position of every
// haystack segment, D[m][i] and the longest match length L[m][i] under the
// scalar search core's tie rules (reference levenshtein.rs:1723-1779).
// Segments are K2's (csrc/myers_search.cu): segment c owns the end
// positions (c*own_len, (c+1)*own_len] (segment 0 also owns 0) and reads the
// RAW haystack from `halo` bytes before them, or from byte 0, with a fresh
// row 0 (free, or (col0 + i)*gap + start_gap when anchored); the outputs
// are int32 dist[iter_len + 1] and len[iter_len + 1] in global order.
//
// What bounds it on an H100: integer operations.  A cell needs about 24 of
// them (two affine chains with their lengths, the substitution, the
// cascade; chip_smoke.py counts K7_OPS_*) against one haystack byte a
// column and 8 output bytes a column, so bytes bind only for needles of a
// few chars.  A cell needs the cell above it in the same column, so the
// needle runs down the lanes as a wavefront, and the design keeps every
// lane on needle rows and every issue slot on the cells:
//   * a GROUP of G lanes (4, 8, 16 or 32; a warp holds 32 / G groups, each
//     its own segment) runs one segment; group lane l holds the R
//     consecutive needle rows [l*R + 1, l*R + R] (R in {1, 2, 3, 4, 6, 8,
//     12, 16}, a template constant; the plan takes the map whose G*R rows
//     cover the needle with the least left over: 24 chars = 8 x 3, no idle
//     lane) and keeps D and L of the last columns and the horizontal
//     (needle-gap) chain of each row in registers;
//   * a diagonal wavefront over the columns: at step s group lane l runs
//     column s - e - l (e: the segment's first byte's place in its 16-byte
//     chunk, plus 15), its rows top to bottom, and hands the lane above
//     only what its first row needs: its last row's D, L and vertical
//     chain with its length, and the column's character (five
//     __shfl_up_sync of width G a step, R cells; with transpositions also
//     its second-to-last row's D and L: seven);
//   * the cells are selects and Hopper's DPX (min(a + b, c) in one
//     instruction for the chains' continuations), so the row loop has no
//     conditional branch in its cells; before its first column a lane sees
//     INF from below, under which its state stays INF (lengths past INF
//     are never read), so the fill needs no predicate either;
//   * group lane 0 makes row 0 (0 unanchored; anchored the saturated
//     start_gap + column * gap, kept by one fused add-min a step) and reads
//     the haystack 16 bytes at a time: every lane of the group loads its
//     group's chunk every 16 steps, on steps common to every segment (the
//     stagger e), and for R <= 4 the chunk's 16 steps are unrolled so a
//     step's byte is a constant shift;
//   * the lane holding row m writes its (D, L) four owned columns at a
//     time in predicated 16-byte stores, the four values in registers named
//     by the step's place in the chunk; a block holds 1 to 8 warps of
//     consecutive segments and no shared memory.
// The per-lane step and the store path are plain functions, so the host
// rehearsal (host_rehearsal.cpp, -DTA_HOST_REHEARSAL) runs exactly this
// arithmetic, lane by lane and warp by warp, with the shuffles replaced by
// arrays.

#include <stddef.h>

#include "ta_common.cuh"

namespace {

constexpr int32_t SD_INF = 1 << 30;
constexpr int SD_LANES = 32;
constexpr int SD_MAX_WARPS = 8;  // warps a block
constexpr int SD_CHUNK = 16;     // haystack bytes a chunk, steps a chunk
constexpr int SD_MAX_ROWS = 16;  // rows a lane: 512 chars at 32 lanes

static TA_DEV int32_t sd_min(int32_t x, int32_t y) { return x < y ? x : y; }
static TA_DEV int32_t sd_max(int32_t x, int32_t y) { return x > y ? x : y; }

#ifdef TA_HOST_REHEARSAL
static inline int32_t sd_addmin(int32_t a, int32_t b, int32_t c) {
  return sd_min(a + b, c);
}
#else
// Hopper's DPX: min(a + b, c) in one instruction
static __device__ __forceinline__ int32_t sd_addmin(int32_t a, int32_t b,
                                                    int32_t c) {
  return __viaddmin_s32(a, b, c);
}
#endif

struct SdArgs {
  const uint8_t* hay;
  int64_t iter_len;
  const uint8_t* needle;
  int32_t m;
  int64_t own_len, halo, nseg;
  int32_t anchored;
  int32_t mc, gc, sgc, tc;
  int32_t lanes;  // G
  int32_t* out_d;
  int32_t* out_l;
};

// Segment x: columns c = 0..ncols, column c >= 1 reading byte col0 + c - 1;
// owned end positions col0 + c for c in [c_lo, ncols].
struct SdSeg {
  const uint8_t* text;  // 16-byte aligned: the chunk of byte col0
  int64_t text_len;     // readable bytes from `text`
  int64_t col0;
  int32_t e;      // group lane 0 runs column c at step c + e
  int32_t ncols;  // -1: a group past the last segment
  int32_t c_lo;
  int32_t* od;    // od[c], ol[c]: end position col0 + c
  int32_t* ol;
};

static TA_DEV SdSeg sd_seg(const SdArgs& g, int64_t x) {
  SdSeg s;
  const bool valid = x < g.nseg;
  const int64_t own0 = valid ? x * g.own_len : 0;
  int64_t own_end = own0 + g.own_len;
  if (own_end > g.iter_len) own_end = g.iter_len;
  s.col0 = own0 - g.halo;
  if (s.col0 < 0) s.col0 = 0;
  const int32_t d = (int32_t)(s.col0 & (SD_CHUNK - 1));
  s.e = d + SD_CHUNK - 1;
  s.text = g.hay + (s.col0 - d);
  s.text_len = valid ? g.iter_len - (s.col0 - d) : 0;
  s.ncols = valid ? (int32_t)(own_end - s.col0) : -1;
  s.c_lo = (int32_t)((x == 0 ? 0 : own0 + 1) - s.col0);
  s.od = g.out_d + s.col0;
  s.ol = g.out_l + s.col0;
  return s;
}

// What a lane hands the lane above: row j0 - 1 (D, L, vertical chain and
// its length) and row j0 - 2 (D, L; transpositions only) of its last rows
// at column c, and the column's character (-1 before column 1).
struct SdMsg {
  int32_t d, l, hg, hgl, d2, l2, ch;
};

static TA_DEV SdMsg sd_inf_msg() {
  SdMsg v;
  v.d = v.hg = v.d2 = SD_INF;
  v.l = v.hgl = v.l2 = 0;
  v.ch = -1;
  return v;
}

template <int R, bool TRANS>
struct SdLane {
  int32_t D1[R], L1[R];  // column c - 1
  int32_t D0[TRANS ? R : 1], L0[TRANS ? R : 1];  // column c - 2
  int32_t NG[R], NGL[R];     // horizontal chain into column c - 1
  int32_t nch[R], nprev[R];  // needle[j - 1], needle[j - 2]; -1 outside
  // what came from below: row j0 - 1 at columns c - 1, c - 2; row j0 - 2
  // at columns c - 1, c - 2; the character of column c - 1
  int32_t uD1, uL1, uD0, uL0, u2D1, u2L1, u2D0, u2L0, chp;
  int32_t rz;  // group lane 0, anchored: the row-0 cost of this step's column
  int32_t bd[4], bl[4];  // the score lane's last four cells, slot s & 3
};

template <int R, bool TRANS>
static TA_DEV void sd_reset(SdLane<R, TRANS>& L, const SdArgs& g,
                            const SdSeg& s, int gl) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    L.D1[r] = L.NG[r] = SD_INF;
    L.L1[r] = L.NGL[r] = 0;
    if constexpr (TRANS) {
      L.D0[r] = SD_INF;
      L.L0[r] = 0;
    }
    const int j = gl * R + r + 1;
    L.nch[r] = j <= g.m ? (int32_t)g.needle[j - 1] : -1;
    L.nprev[r] = (j >= 2 && j <= g.m) ? (int32_t)g.needle[j - 2] : -1;
  }
  L.uD1 = L.uD0 = L.u2D1 = L.u2D0 = SD_INF;
  L.uL1 = L.uL0 = L.u2L1 = L.u2L0 = 0;
  L.chp = -1;
  // step s: start_gap + (s - e) * gap, saturated at INF by the update
  L.rz = g.sgc - s.e * g.gc;
  L.bd[0] = L.bd[1] = L.bd[2] = L.bd[3] = 0;
  L.bl[0] = L.bl[1] = L.bl[2] = L.bl[3] = 0;
}

// Column c of the lane's rows, given row j0 - 1 and j0 - 2 at column c in
// `in`.  Returns what the lane above takes; (*od, *ol) get row rm's cell.
template <int R, bool TRANS>
static TA_DEV SdMsg sd_column(SdLane<R, TRANS>& L, const SdArgs& g,
                              const SdMsg& in, int rm, int32_t* od,
                              int32_t* ol) {
  const int32_t gc = g.gc, sg = g.sgc + g.gc, big = SD_INF + g.gc;
  int32_t pD = in.d, pL = in.l, pHG = in.hg, pHGL = in.hgl;  // (j-1, c)
  int32_t qD = L.uD1, qL = L.uL1;                            // (j-1, c-1)
  // (j-2, c-2) for rows r, r + 1
  int32_t t0D = L.u2D0, t0L = L.u2L0, t1D = L.uD0, t1L = L.uL0;
  int32_t p2D = in.d2, p2L = in.l2;  // (j-2, c)
  int32_t rd = 0, rl = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t d1 = L.D1[r], l1 = L.L1[r];
    // needle gap (consume haystack): (j, c-1); min(NG, INF) + gap
    const int32_t new_g = d1 + sg;
    const int32_t cont_g = sd_addmin(L.NG[r], gc, big);
    const int32_t ng2 = sd_min(new_g, cont_g);
    const int32_t ngl_t = sd_max(l1, L.NGL[r]);
    const int32_t ngl2 =
        (new_g < cont_g ? l1 : new_g > cont_g ? L.NGL[r] : ngl_t) + 1;
    // haystack gap (consume needle): (j-1, c)
    const int32_t new_h = pD + sg;
    const int32_t cont_h = sd_addmin(pHG, gc, big);
    const int32_t hg2 = sd_min(new_h, cont_h);
    const int32_t hgl_t = sd_max(pL, pHGL);
    const int32_t hgl2 = new_h < cont_h ? pL : new_h > cont_h ? pHGL : hgl_t;
    // substitution: (j-1, c-1)
    const int32_t sub = qD + (L.nch[r] == in.ch ? 0 : g.mc);
    const int32_t lsub = qL + 1;
    // the cascade, as selects: the vertical chain on a lower cost or, at
    // equal cost, a longer (j-1, c) match; then the substitution
    const bool c1 = hg2 < ng2 || (hg2 == ng2 && pL > ngl2);
    int32_t d = c1 ? hg2 : ng2;
    int32_t ln = c1 ? hgl2 : ngl2;
    const bool c2 = sub < d || (sub == d && lsub > ln);
    d = c2 ? sub : d;
    ln = c2 ? lsub : ln;
    if constexpr (TRANS) {
      // (j-2, c-2): needle[j-1] == hay[c-1] and needle[j-2] == hay[c]
      // (1-based columns); chp is -1 up to column 1 and nprev -1 at row
      // 1, so no needle row and column can meet the condition there
      const int32_t tcand = t0D + g.tc;
      const bool c3 = L.nch[r] == L.chp && L.nprev[r] == in.ch &&
                      tcand <= d;
      d = c3 ? tcand : d;
      ln = c3 ? t0L + 2 : ln;
    }
    d = sd_min(d, SD_INF);
    rd = r == rm ? d : rd;
    rl = r == rm ? ln : rl;
    // shift the pipelines one row down
    if constexpr (TRANS) {
      t0D = t1D;
      t0L = t1L;
      t1D = L.D0[r];
      t1L = L.L0[r];
      L.D0[r] = d1;
      L.L0[r] = l1;
      p2D = pD;
      p2L = pL;
    }
    qD = d1;
    qL = l1;
    pD = d;
    pL = ln;
    pHG = hg2;
    pHGL = hgl2;
    L.D1[r] = d;
    L.L1[r] = ln;
    L.NG[r] = ng2;
    L.NGL[r] = ngl2;
  }
  *od = rd;
  *ol = rl;
  if constexpr (TRANS) {
    L.u2D0 = L.u2D1;
    L.u2L0 = L.u2L1;
    L.u2D1 = in.d2;
    L.u2L1 = in.l2;
    L.uD0 = L.uD1;
    L.uL0 = L.uL1;
  }
  L.uD1 = in.d;
  L.uL1 = in.l;
  L.chp = in.ch;
  SdMsg out;
  out.d = pD;
  out.l = pL;
  out.hg = pHG;
  out.hgl = pHGL;
  out.d2 = p2D;
  out.l2 = p2L;
  out.ch = in.ch;
  return out;
}

// What the lanes of a launch share.
struct SdPlan {
  int G;
  int lane_m, rm;  // row m: group lane, row of the lane
  int phase;       // r at which the score lane stores
};

// Step s of group lane gl, byte k = s & 15 of the chunk, r = s & 3.  `up`
// is what the lane below returned at step s - 1 (group lane 0 makes row 0
// itself).  Returns what the lane above takes at step s + 1.
template <int R, bool TRANS>
static TA_DEV SdMsg sd_step(const SdArgs& g, const SdSeg& s, const SdPlan& p,
                            SdLane<R, TRANS>& L, const uint4& chunk, int gl,
                            int32_t step, int k, int r, const SdMsg& up) {
  const int32_t c = step - s.e - gl;  // this lane's column
  // group lane 0: row 0 (and row -1) at column c, the column's character
  SdMsg z;
  const int32_t rz = L.rz;
  L.rz = sd_addmin(L.rz, g.gc, SD_INF);
  z.d = c < 0 ? SD_INF : (g.anchored && c >= 1 ? rz : 0);
  z.l = z.hgl = z.l2 = 0;
  z.hg = z.d2 = SD_INF;
  const int32_t byte = (int32_t)ta_byte_of(chunk, k);
  z.ch = c >= 1 ? byte : -1;
  // field by field: a select of whole messages makes the compiler address
  // them in local memory
  const bool own = gl == 0;
  SdMsg in;
  in.d = own ? z.d : up.d;
  in.l = own ? z.l : up.l;
  in.hg = own ? z.hg : up.hg;
  in.hgl = own ? z.hgl : up.hgl;
  in.d2 = own ? z.d2 : up.d2;
  in.l2 = own ? z.l2 : up.l2;
  in.ch = own ? z.ch : up.ch;
  int32_t od, ol;
  const SdMsg out = sd_column<R, TRANS>(L, g, in,
                                        gl == p.lane_m ? p.rm : -1, &od, &ol);
  // the score lane: four owned columns a 16-byte store each
  const bool in_seg = c >= 0 && c <= s.ncols;
  L.bd[r] = in_seg ? od : L.bd[r];
  L.bl[r] = in_seg ? ol : L.bl[r];
  const bool at = gl == p.lane_m && in_seg && r == p.phase;
  if (at && c - 3 >= s.c_lo) {
    ta_store4v(s.od + (c - 3), L.bd[(r + 1) & 3], L.bd[(r + 2) & 3],
               L.bd[(r + 3) & 3], L.bd[r]);
    ta_store4v(s.ol + (c - 3), L.bl[(r + 1) & 3], L.bl[(r + 2) & 3],
               L.bl[(r + 3) & 3], L.bl[r]);
  }
  if (at && c - 3 < s.c_lo && c >= s.c_lo) {  // the segment's head
    if (c - 2 >= s.c_lo) {
      s.od[c - 2] = L.bd[(r + 2) & 3];
      s.ol[c - 2] = L.bl[(r + 2) & 3];
    }
    if (c - 1 >= s.c_lo) {
      s.od[c - 1] = L.bd[(r + 3) & 3];
      s.ol[c - 1] = L.bl[(r + 3) & 3];
    }
    s.od[c] = L.bd[r];
    s.ol[c] = L.bl[r];
  }
  return out;
}

// The score lane's owned columns past its last four-column store.
template <int R, bool TRANS>
static TA_DEV void sd_flush(const SdSeg& s, const SdPlan& p,
                            const SdLane<R, TRANS>& L) {
  // the last column c <= ncols with (col0 + c) % 4 == 3
  const int32_t cq = s.ncols - (int32_t)((s.col0 + s.ncols + 1) & 3);
  for (int32_t c = (cq >= s.c_lo ? cq + 1 : s.c_lo); c <= s.ncols; ++c) {
    const int slot = (c + s.e + p.lane_m) & 3;
    s.od[c] = slot == 0 ? L.bd[0] : slot == 1 ? L.bd[1]
              : slot == 2 ? L.bd[2] : L.bd[3];
    s.ol[c] = slot == 0 ? L.bl[0] : slot == 1 ? L.bl[1]
              : slot == 2 ? L.bl[2] : L.bl[3];
  }
}

static TA_DEV SdPlan sd_plan(const SdArgs& g, int R) {
  SdPlan p;
  p.G = g.lanes;
  p.lane_m = (g.m - 1) / R;
  p.rm = (g.m - 1) - p.lane_m * R;
  p.phase = (p.lane_m + 2) & 3;
  return p;
}

// Steps a warp runs: its groups' longest segment up to the score lane's
// last column.
static TA_DEV int32_t sd_steps(int32_t span, const SdPlan& p) {
  return span + p.lane_m + 1;
}

static inline bool sd_rows_ok(int R) {
  return R == 1 || R == 2 || R == 3 || R == 4 || R == 6 || R == 8 ||
         R == 12 || R == 16;
}

// What the launcher takes: a lane map that holds the needle, the warps a
// block, segments of at most 2^31 - 32 columns.
static inline bool sd_plan_ok(int m, int rows, int lanes, int warps,
                              int64_t own_len, int64_t halo) {
  return m >= 1 && sd_rows_ok(rows) &&
         (lanes == 4 || lanes == 8 || lanes == 16 || lanes == 32) &&
         rows * lanes >= m && warps >= 1 && warps <= SD_MAX_WARPS &&
         own_len >= 1 && halo >= 0 && own_len + halo <= 2147483647LL - 32;
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

template <int R, bool TRANS>
static __device__ __forceinline__ SdMsg sd_shfl_up(const SdMsg& v, int G) {
  SdMsg o;
  o.d = __shfl_up_sync(0xffffffffu, v.d, 1, G);
  o.l = __shfl_up_sync(0xffffffffu, v.l, 1, G);
  o.hg = __shfl_up_sync(0xffffffffu, v.hg, 1, G);
  o.hgl = __shfl_up_sync(0xffffffffu, v.hgl, 1, G);
  o.ch = __shfl_up_sync(0xffffffffu, v.ch, 1, G);
  if constexpr (TRANS) {
    o.d2 = __shfl_up_sync(0xffffffffu, v.d2, 1, G);
    o.l2 = __shfl_up_sync(0xffffffffu, v.l2, 1, G);
  } else {
    o.d2 = SD_INF;
    o.l2 = 0;
  }
  return o;
}

// Four steps, r = 0..3 constants (the score slots); k0: the first step's
// byte in the chunk.
template <int R, bool TRANS>
static __device__ __forceinline__ SdMsg sd_quad(const SdArgs& g,
                                                const SdSeg& s,
                                                const SdPlan& p,
                                                SdLane<R, TRANS>& L,
                                                const uint4& chunk, int gl,
                                                int32_t step, int k0,
                                                SdMsg up) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    up = sd_shfl_up<R, TRANS>(
        sd_step<R, TRANS>(g, s, p, L, chunk, gl, step + r, k0 + r, r, up),
        p.G);
  return up;
}

template <int R, bool TRANS>
__global__ void __launch_bounds__(SD_LANES * SD_MAX_WARPS)
    search_diag_kernel(SdArgs g) {
  const int tid = threadIdx.x, lane = tid & 31;
  const SdPlan p = sd_plan(g, R);
  const int gl = lane & (p.G - 1);
  const int64_t x = (int64_t)blockIdx.x * (blockDim.x / p.G) + tid / p.G;
  const SdSeg s = sd_seg(g, x);
  SdLane<R, TRANS> L;
  sd_reset(L, g, s, gl);
  TaChunks txt;
  txt.start(s.text, s.text_len);
  const int32_t span =
      (int32_t)__reduce_max_sync(0xffffffffu, (unsigned)(s.ncols + s.e));
  const int32_t steps = sd_steps(span, p);
  SdMsg up = sd_inf_msg();
  for (int32_t s0 = 0; s0 < steps; s0 += SD_CHUNK) {
    // chunk s0 / 16 - 1: group lane 0's bytes of this block of 16 steps
    if (s0 > 0) txt.advance();
    if constexpr (R <= 4) {  // a step's byte a constant shift
#pragma unroll
      for (int k0 = 0; k0 < SD_CHUNK; k0 += 4)
        up = sd_quad<R, TRANS>(g, s, p, L, txt.cur, gl, s0 + k0, k0, up);
    } else {  // long bodies: four steps unrolled
#pragma unroll 1
      for (int k0 = 0; k0 < SD_CHUNK; k0 += 4)
        up = sd_quad<R, TRANS>(g, s, p, L, txt.cur, gl, s0 + k0, k0, up);
    }
  }
  if (gl == p.lane_m) sd_flush(s, p, L);
}

template <int R, bool TRANS>
static int launch_sd(const SdArgs& g, int warps, cudaStream_t stream) {
  const int64_t per_block = (int64_t)warps * (SD_LANES / g.lanes);
  const int64_t blocks = (g.nseg + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  search_diag_kernel<R, TRANS>
      <<<(unsigned)blocks, SD_LANES * warps, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <bool TRANS>
static int launch_sd_rows(int rows, const SdArgs& g, int warps,
                          cudaStream_t st) {
  switch (rows) {
#define TA_SD_CASE(RR) \
  case RR:             \
    return launch_sd<RR, TRANS>(g, warps, st);
    TA_SD_CASE(1)
    TA_SD_CASE(2)
    TA_SD_CASE(3)
    TA_SD_CASE(4)
    TA_SD_CASE(6)
    TA_SD_CASE(8)
    TA_SD_CASE(12)
    TA_SD_CASE(16)
#undef TA_SD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Plain C entry point.  hay: the raw haystack, 16-byte aligned; needle:
// [m] bytes, 1 <= m <= 512; out_d / out_l: int32 [iter_len + 1], 16-byte
// aligned, every entry written.  rows / lanes: the lane map (R rows a
// lane, G lanes a segment, G * R >= m); warps: warps a block.  All
// pointers are device pointers; nothing is allocated or synchronised here.
// Returns the cudaError_t of the launch.
extern "C" int ta_search_diag(const void* hay, int64_t iter_len,
                              const void* needle, int m, int64_t own_len,
                              int64_t halo, int64_t nseg, int anchored, int mc,
                              int gc, int sgc, int tc, int transpose,
                              int rows, int lanes, int warps, void* out_d,
                              void* out_l, void* stream) {
  if (!sd_plan_ok(m, rows, lanes, warps, own_len, halo) ||
      m > SD_LANES * SD_MAX_ROWS || nseg < 1 || iter_len < 0 ||
      ((uintptr_t)hay & 15) || ((uintptr_t)out_d & 15) ||
      ((uintptr_t)out_l & 15))
    return (int)cudaErrorInvalidValue;
  SdArgs g;
  g.hay = (const uint8_t*)hay;
  g.iter_len = iter_len;
  g.needle = (const uint8_t*)needle;
  g.m = m;
  g.own_len = own_len;
  g.halo = halo;
  g.nseg = nseg;
  g.anchored = anchored;
  g.mc = mc;
  g.gc = gc;
  g.sgc = sgc;
  g.tc = tc;
  g.lanes = lanes;
  g.out_d = (int32_t*)out_d;
  g.out_l = (int32_t*)out_l;
  cudaStream_t st = (cudaStream_t)stream;
  return transpose ? launch_sd_rows<true>(rows, g, warps, st)
                   : launch_sd_rows<false>(rows, g, warps, st);
}

#endif  // TA_HOST_REHEARSAL
