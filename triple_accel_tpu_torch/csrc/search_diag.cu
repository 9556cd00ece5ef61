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
// What bounds it on an H100: integer operations.  A cell needs about 25 of
// them (two affine chains with their lengths, the substitution, the
// cascade; chip_smoke.py counts K7_OPS_*) against one haystack byte a
// column and 8 output bytes a column, so bytes bind only for needles of a
// few chars.  What the design has to beat is the recurrence's chain: a cell
// needs the cell above it in the same column.  The design (first version:
// right and simple, not yet fast):
//   * one warp per segment, four segments a block, no shared memory.  Lane
//     l holds needle rows [l*R + 1, l*R + R], R in {1, 2, 4, 8, 16} the
//     least with 32 * R >= m, and six ints a row in registers: D and L of
//     the last two columns and the horizontal (needle-gap) chain;
//   * a diagonal wavefront over the columns: at step s lane l runs column
//     s - l, its rows top to bottom, and hands the lane below its last
//     row's D, L, vertical chain and length, its second-to-last row's D and
//     L (for the transposition two rows down) and the column's character:
//     seven __shfl_up_sync a step.  Lane 0 makes row 0 itself and reads
//     the haystack 16 bytes at a time;
//   * the lane holding row m writes its (D, L) four owned columns at a
//     time in 16-byte stores where it owns all four.
// The per-lane step and the store path are plain functions, so the host
// rehearsal (host_rehearsal.cpp, -DTA_HOST_REHEARSAL) runs exactly this
// arithmetic, lane by lane, with the shuffle replaced by an array.

#include <stddef.h>

#include "ta_common.cuh"

namespace {

constexpr int32_t SD_INF = 1 << 30;
constexpr int SD_LANES = 32;
constexpr int SD_WARPS = 4;  // segments (warps) a block

static TA_DEV int32_t sd_min(int32_t x, int32_t y) { return x < y ? x : y; }
static TA_DEV int32_t sd_max(int32_t x, int32_t y) { return x > y ? x : y; }

struct SdArgs {
  const uint8_t* hay;
  int64_t iter_len;
  const uint8_t* needle;
  int32_t m;
  int64_t own_len, halo, nseg;
  int32_t anchored;
  int32_t mc, gc, sgc, tc;
  int32_t* out_d;
  int32_t* out_l;
};

// Segment c: columns i = 1..ncols read byte col0 + i - 1; owned end
// positions [lo, own_end] (lo = 0 for segment 0, else own0 + 1).
struct SdSeg {
  int64_t col0, ncols, lo, own_end;
};

static TA_DEV SdSeg sd_seg(const SdArgs& g, int64_t c) {
  SdSeg s;
  const int64_t own0 = c * g.own_len;
  s.own_end = own0 + g.own_len;
  if (s.own_end > g.iter_len) s.own_end = g.iter_len;
  s.col0 = own0 - g.halo;
  if (s.col0 < 0) s.col0 = 0;
  s.ncols = s.own_end - s.col0;
  s.lo = c == 0 ? 0 : own0 + 1;
  return s;
}

// What a lane hands the lane below: row j0 - 1 (D, L, vertical chain and
// its length) and row j0 - 2 (D, L) of the lane below at column c, and the
// column's character.
struct SdMsg {
  int32_t d, l, hg, hgl, d2, l2, ch;
};

template <int R>
struct SdLane {
  int32_t D1[R], L1[R];  // column c - 1
  int32_t D0[R], L0[R];  // column c - 2
  int32_t NG[R], NGL[R];  // horizontal chain into column c - 1
  int32_t nch[R], nprev[R];  // needle[j - 1], needle[j - 2]; -1 outside
  // what came from above: row j0 - 1 at columns c - 1, c - 2; row j0 - 2
  // at columns c - 1, c - 2; the character of column c - 1
  int32_t uD1, uL1, uD0, uL0, u2D1, u2L1, u2D0, u2L0, chp;
};

template <int R>
static TA_DEV void sd_reset(SdLane<R>& L, const SdArgs& g, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    L.D1[r] = L.D0[r] = L.NG[r] = SD_INF;
    L.L1[r] = L.L0[r] = L.NGL[r] = 0;
    const int j = lane * R + r + 1;
    L.nch[r] = j <= g.m ? (int32_t)g.needle[j - 1] : -1;
    L.nprev[r] = (j >= 2 && j <= g.m) ? (int32_t)g.needle[j - 2] : -1;
  }
  L.uD1 = L.uD0 = L.u2D1 = L.u2D0 = SD_INF;
  L.uL1 = L.uL0 = L.u2L1 = L.u2L0 = 0;
  L.chp = -1;
}

// Column c of the lane's rows, given row j0 - 1 and j0 - 2 at column c in
// `in`.  Returns what the lane below takes; (*od, *ol) get row m's cell
// when the lane holds it (rm = its index in the lane, else -1).
template <int R, bool TRANS>
static TA_DEV SdMsg sd_column(SdLane<R>& L, const SdArgs& g, int lane,
                              int64_t c, const SdMsg& in, int rm,
                              int32_t* od, int32_t* ol) {
  const int32_t gc = g.gc, sg = g.sgc + g.gc;
  int32_t pD = in.d, pL = in.l, pHG = in.hg, pHGL = in.hgl;  // (j-1, c)
  int32_t qD = L.uD1, qL = L.uL1;                            // (j-1, c-1)
  // (j-2, c-2) for rows r, r + 1
  int32_t t0D = L.u2D0, t0L = L.u2L0, t1D = L.uD0, t1L = L.uL0;
  int32_t p2D = in.d2, p2L = in.l2;  // (j-2, c): row R-2's when R == 1
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t d1 = L.D1[r], l1 = L.L1[r], d0 = L.D0[r], l0 = L.L0[r];
    // needle gap (consume haystack): (j, c-1)
    const int32_t new_g = d1 + sg;
    const int32_t cont_g = sd_min(L.NG[r], SD_INF) + gc;
    const int32_t ng2 = sd_min(new_g, cont_g);
    const int32_t ngl2 = new_g < cont_g   ? l1 + 1
                         : new_g > cont_g ? L.NGL[r] + 1
                                          : sd_max(l1, L.NGL[r]) + 1;
    // haystack gap (consume needle): (j-1, c)
    const int32_t new_h = pD + sg;
    const int32_t cont_h = sd_min(pHG, SD_INF) + gc;
    const int32_t hg2 = sd_min(new_h, cont_h);
    const int32_t hgl2 = new_h < cont_h   ? pL
                         : new_h > cont_h ? pHGL
                                          : sd_max(pL, pHGL);
    // substitution: (j-1, c-1)
    const int32_t sub = qD + (L.nch[r] == in.ch ? 0 : g.mc);
    const int32_t lsub = qL + 1;
    int32_t d = ng2, ln = ngl2;
    if (hg2 < d || (hg2 == d && pL > ln)) {
      d = hg2;
      ln = hgl2;
    }
    if (sub < d || (sub == d && lsub > ln)) {
      d = sub;
      ln = lsub;
    }
    if (TRANS) {
      // (j-2, c-2): needle[j-1] == hay[c-1] and needle[j-2] == hay[c]
      // (1-based columns); the sentinels stop it at j = 1 and c = 1
      const bool tcond = c > 1 && L.nch[r] == L.chp && L.nprev[r] == in.ch &&
                         L.nprev[r] >= 0;
      if (tcond && t0D + g.tc <= d) {
        d = t0D + g.tc;
        ln = t0L + 2;
      }
    }
    d = sd_min(d, SD_INF);
    if (r == rm) {
      *od = d;
      *ol = ln;
    }
    // shift the pipelines one row down
    t0D = t1D;
    t0L = t1L;
    t1D = d0;
    t1L = l0;
    qD = d1;
    qL = l1;
    p2D = pD;
    p2L = pL;
    pD = d;
    pL = ln;
    pHG = hg2;
    pHGL = hgl2;
    L.D0[r] = d1;
    L.L0[r] = l1;
    L.D1[r] = d;
    L.L1[r] = ln;
    L.NG[r] = ng2;
    L.NGL[r] = ngl2;
  }
  L.u2D0 = L.u2D1;
  L.u2L0 = L.u2L1;
  L.u2D1 = in.d2;
  L.u2L1 = in.l2;
  L.uD0 = L.uD1;
  L.uL0 = L.uL1;
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

// The owned (D, L) of one segment, four columns in one aligned 16-byte
// store each where the segment owns all four.
struct SdSink {
  int32_t bd[4], bl[4];

  TA_DEV void put(const SdArgs& g, const SdSeg& s, int64_t p, int32_t d,
                  int32_t l) {
    bd[p & 3] = d;
    bl[p & 3] = l;
    if ((p & 3) == 3) {
      if (p - 3 >= s.lo) {
        ta_store4(g.out_d + (p - 3), bd);
        ta_store4(g.out_l + (p - 3), bl);
      } else {
        for (int64_t q = s.lo; q <= p; ++q) {
          g.out_d[q] = bd[q & 3];
          g.out_l[q] = bl[q & 3];
        }
      }
    }
  }
  TA_DEV void flush(const SdArgs& g, const SdSeg& s) {
    if ((s.own_end & 3) == 3) return;
    int64_t q = s.own_end & ~(int64_t)3;
    if (q < s.lo) q = s.lo;
    for (; q <= s.own_end; ++q) {
      g.out_d[q] = bd[q & 3];
      g.out_l[q] = bl[q & 3];
    }
  }
};

// Row 0 (and row -1) at column c, and the column's character: what lane 0
// takes instead of a message.
static TA_DEV SdMsg sd_row0(const SdArgs& g, const SdSeg& s, int64_t c,
                            TaStream& txt) {
  SdMsg in;
  int64_t b = 0;
  if (g.anchored && c > 0) {
    b = (s.col0 + c) * (int64_t)g.gc + g.sgc;
    if (b > SD_INF) b = SD_INF;
  }
  in.d = (int32_t)b;
  in.l = 0;
  in.hg = SD_INF;
  in.hgl = 0;
  in.d2 = SD_INF;
  in.l2 = 0;
  in.ch = c >= 1 ? (int32_t)txt.at(s.col0 + c - 1) : -1;
  return in;
}

// Step s of lane `lane` (column c = s - lane): `in` is what the lane above
// returned at step s - 1 (lane 0 makes row 0 itself).  Returns what the
// lane below takes at step s + 1.
template <int R, bool TRANS>
static TA_DEV SdMsg sd_step(const SdArgs& g, const SdSeg& s, SdLane<R>& L,
                            TaStream& txt, SdSink& sink, int lane,
                            int lane_m, int64_t step, SdMsg in) {
  const int64_t c = step - lane;
  if (c < 0 || c > s.ncols || lane > lane_m) return in;
  if (lane == 0) in = sd_row0(g, s, c, txt);
  const int rm = lane == lane_m ? (g.m - 1) - lane * R : -1;
  int32_t od = 0, ol = 0;
  const SdMsg out = sd_column<R, TRANS>(L, g, lane, c, in, rm, &od, &ol);
  if (rm >= 0) {
    const int64_t p = s.col0 + c;
    if (p >= s.lo) sink.put(g, s, p, od, ol);
  }
  return out;
}

static inline int sd_rows_per_lane(int m) {
  int R = 1;
  while (SD_LANES * R < m) R *= 2;
  return R;
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

template <int R, bool TRANS>
__global__ void __launch_bounds__(SD_LANES * SD_WARPS)
    search_diag_kernel(SdArgs g) {
  const int lane = threadIdx.x & 31;
  const int64_t seg = (int64_t)blockIdx.x * SD_WARPS + (threadIdx.x >> 5);
  if (seg >= g.nseg) return;  // the whole warp leaves together
  const SdSeg s = sd_seg(g, seg);
  const int lane_m = (g.m - 1) / R;
  SdLane<R> L;
  sd_reset<R>(L, g, lane);
  TaStream txt;
  txt.start(g.hay, g.iter_len);
  SdSink sink;
  SdMsg in = {};
  const int64_t steps = s.ncols + lane_m + 1;
  for (int64_t step = 0; step < steps; ++step) {
    const SdMsg out =
        sd_step<R, TRANS>(g, s, L, txt, sink, lane, lane_m, step, in);
    in.d = __shfl_up_sync(0xffffffffu, out.d, 1);
    in.l = __shfl_up_sync(0xffffffffu, out.l, 1);
    in.hg = __shfl_up_sync(0xffffffffu, out.hg, 1);
    in.hgl = __shfl_up_sync(0xffffffffu, out.hgl, 1);
    in.d2 = __shfl_up_sync(0xffffffffu, out.d2, 1);
    in.l2 = __shfl_up_sync(0xffffffffu, out.l2, 1);
    in.ch = __shfl_up_sync(0xffffffffu, out.ch, 1);
  }
  if (lane == lane_m) sink.flush(g, s);
}

template <int R, bool TRANS>
static int launch_sd(const SdArgs& g, cudaStream_t stream) {
  const int64_t blocks = (g.nseg + SD_WARPS - 1) / SD_WARPS;
  search_diag_kernel<R, TRANS>
      <<<(unsigned)blocks, SD_LANES * SD_WARPS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <bool TRANS>
static int launch_sd_rows(const SdArgs& g, cudaStream_t st) {
  switch (sd_rows_per_lane(g.m)) {
    case 1: return launch_sd<1, TRANS>(g, st);
    case 2: return launch_sd<2, TRANS>(g, st);
    case 4: return launch_sd<4, TRANS>(g, st);
    case 8: return launch_sd<8, TRANS>(g, st);
    case 16: return launch_sd<16, TRANS>(g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Plain C entry point.  hay: the raw haystack, 16-byte aligned; needle:
// [m] bytes, 1 <= m <= 512; out_d / out_l: int32 [iter_len + 1], 16-byte
// aligned, every entry written.  All pointers are device pointers; nothing
// is allocated or synchronised here.  Returns the cudaError_t of the
// launch.
extern "C" int ta_search_diag(const void* hay, int64_t iter_len,
                              const void* needle, int m, int64_t own_len,
                              int64_t halo, int64_t nseg, int anchored, int mc,
                              int gc, int sgc, int tc, int transpose,
                              void* out_d, void* out_l, void* stream) {
  if (m < 1 || m > SD_LANES * 16 || own_len < 1 || halo < 0 || nseg < 1 ||
      (nseg + SD_WARPS - 1) / SD_WARPS > 2147483647LL || iter_len < 0 ||
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
  g.out_d = (int32_t*)out_d;
  g.out_l = (int32_t*)out_l;
  cudaStream_t st = (cudaStream_t)stream;
  return transpose ? launch_sd_rows<true>(g, st) : launch_sd_rows<false>(g, st);
}

#endif  // TA_HOST_REHEARSAL
