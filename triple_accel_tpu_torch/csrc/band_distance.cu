// K3 band_distance / K4 band_trace: banded general-cost edit distance
// (mismatch, affine gap, transposition costs), without and with the argmin
// codes a traceback needs.  One pair per thread block, the band in shared
// memory, the rows walked in a loop with the pair's own trip count.
//
// Replaces the four TPU kernels of triple_accel_tpu/ops/pallas/lev_band.py:
// _make_kernel and _make_tiled_kernel (band_distance_pallas[_tiled]) become
// band_kernel<*, false>, _make_trace_kernel and _make_tiled_trace_kernel
// (band_trace_pallas[_tiled]) become band_kernel<*, true>.  The TPU split
// "untiled / row-strip tiled" existed because its fast memory had to hold
// the strings; here the characters stream from global memory row by row, so
// a pair of any length runs through the same kernel.
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
// about 14 operations at the card's best (20 with transposition, 6 or 7
// more for the code; chip_smoke.py lists them) against 2 / W bytes of
// strings, and the traced kernel writes 2 bits per cell.
// The design (first version: right and simple, not yet fast):
//   * one pair per block, T threads (a multiple of 32, chosen by the
//     wrapper from W), each thread a contiguous run of ceil(W / T) cells;
//   * band state in shared memory: three rotating rows of D (two rows back,
//     previous, current), two of the vertical-gap state, one scratch row
//     for the transposition candidate: 6 * W ints, so W <= 8193 fits the
//     227 KB a block may use;
//   * a row is two passes with two block barriers: pass 1 forms sub, the
//     vertical gap, the transposition and each thread's min of
//     dprime - c*gap; a warp scan plus one word per warp turns those into
//     each thread's exclusive prefix; pass 2 runs the chain and the
//     cascade serially inside the thread's run;
//   * codes leave as 16 two-bit codes per 32-bit word, packed with shifts
//     and ORs from a byte row in shared memory, pair-major
//     codes[(p * rows + i - 1) * words_per_row + c / 16].
// The row passes are plain functions over [c_lo, c_hi) so that the host
// rehearsal (host_rehearsal.cpp, -DTA_HOST_REHEARSAL) runs exactly this
// arithmetic one "thread" at a time.

#include <stddef.h>

#include "ta_common.cuh"

namespace {

constexpr int32_t TA_BAND_INF = 1 << 30;
constexpr int TA_CODES_PER_WORD = 16;

static TA_DEV int32_t ta_min32(int32_t x, int32_t y) { return x < y ? x : y; }

struct BandCosts {
  int32_t mc, gc, sgc, tc;
};

struct BandPair {
  const uint8_t* a;  // m chars
  const uint8_t* b;  // the pair's b at byte offset unit_k of its row
  int32_t m, n, unit_k, W;
  BandCosts k;
};

struct BandState {
  int32_t* dp0;    // row i-2
  int32_t* dp1;    // row i-1
  int32_t* cur;    // row i: sub after pass 1, D after pass 2
  int32_t* bg;     // vertical-gap state of row i-1
  int32_t* bgcur;  // vertical-gap state of row i
  int32_t* tr;     // transposition candidate of row i, -1 where none
  uint8_t* code;   // argmin codes of row i, one byte a cell
};

// What a cell knows before the row's horizontal chain is resolved.
struct BandCellPre {
  int32_t sub, bgap2, dprime;
};

// `trans` is the transposition candidate, TA_BAND_INF where tcond is false.
static TA_DEV BandCellPre band_cell_pre(int32_t dp1_c, int32_t dp1_up,
                                        int32_t bgap_up, bool chars_equal,
                                        int32_t trans, bool valid,
                                        const BandCosts& k) {
  BandCellPre r;
  r.sub = dp1_c + (chars_equal ? 0 : k.mc);
  // clamped before it is carried, so saturated cells do not creep
  r.bgap2 = ta_min32(ta_min32(dp1_up + (k.sgc + k.gc), bgap_up + k.gc),
                     TA_BAND_INF);
  int32_t d = ta_min32(ta_min32(r.sub, r.bgap2), trans);
  r.dprime = valid ? ta_min32(d, TA_BAND_INF) : TA_BAND_INF;
  return r;
}

struct BandCellOut {
  int32_t dp2;
  uint32_t code;
};

// The selection cascade.  `mins_prev` is the exclusive prefix-min of
// dprime - c*gc over the cells left of c (TA_BAND_INF at c == 0).
static TA_DEV BandCellOut band_cell_post(int32_t sub, int32_t bgap2,
                                         int32_t trans, bool tcond, bool valid,
                                         int32_t c, int32_t mins_prev,
                                         const BandCosts& k) {
  const int32_t e = ta_min32(mins_prev + c * k.gc + k.sgc, TA_BAND_INF);
  BandCellOut r;
  r.dp2 = sub;
  r.code = 0u;
  if (e < r.dp2) {
    r.dp2 = e;
    r.code = 1u;
  }
  if (bgap2 < r.dp2) {
    r.dp2 = bgap2;
    r.code = 2u;
  }
  if (tcond && trans <= r.dp2) {
    r.dp2 = trans;
    r.code = 3u;
  }
  r.dp2 = valid ? ta_min32(r.dp2, TA_BAND_INF) : TA_BAND_INF;
  return r;
}

// Row 0 and the empty history, cells [c_lo, c_hi).
static TA_DEV void band_init_row(const BandPair& P, const BandState& S,
                                 int c_lo, int c_hi) {
  for (int c = c_lo; c < c_hi; ++c) {
    const int32_t j0 = c - P.unit_k;
    S.dp0[c] = TA_BAND_INF;
    S.bg[c] = TA_BAND_INF;
    S.dp1[c] = (j0 >= 0 && j0 <= P.n)
                   ? ta_min32(j0 * P.k.gc + (j0 > 0 ? P.k.sgc : 0), TA_BAND_INF)
                   : TA_BAND_INF;
  }
}

// Pass 1 of row i over cells [c_lo, c_hi): leaves sub in cur, the vertical
// gap in bgcur, the transposition candidate in tr, and returns the min of
// dprime - c*gc over these cells (TA_BAND_INF for an empty run).
template <bool TRANS>
static TA_DEV int32_t band_row_pass1(const BandPair& P, const BandState& S,
                                     int i, int c_lo, int c_hi) {
  int32_t cmin = TA_BAND_INF;
  if (c_lo >= c_hi) return cmin;
  const uint8_t a_char = P.a[i - 1];
  const uint8_t a_prev = (TRANS && i > 1) ? P.a[i - 2] : (uint8_t)0;
  const uint8_t* bw = P.b + (i - 1);  // bw[c] = b[j-1] of band cell c
  for (int c = c_lo; c < c_hi; ++c) {
    const int32_t j = i + c - P.unit_k;
    const bool valid = j >= 0 && j <= P.n;
    const uint8_t bc = bw[c];
    const bool last = c + 1 >= P.W;
    const int32_t dp1_up = last ? TA_BAND_INF : S.dp1[c + 1];
    const int32_t bgap_up = last ? TA_BAND_INF : S.bg[c + 1];
    int32_t trans = TA_BAND_INF;
    if (TRANS) {
      // b[j-2] is one byte left of b[j-1]; both need i > 1 and j > 1
      const bool tcond =
          i > 1 && j > 1 && a_char == bw[c - 1] && a_prev == bc;
      if (tcond) trans = S.dp0[c] + P.k.tc;
      S.tr[c] = tcond ? trans : -1;
    }
    const BandCellPre r = band_cell_pre(S.dp1[c], dp1_up, bgap_up,
                                        a_char == bc, trans, valid, P.k);
    S.cur[c] = r.sub;
    S.bgcur[c] = r.bgap2;
    cmin = ta_min32(cmin, r.dprime - c * P.k.gc);
  }
  return cmin;
}

// Pass 2 of row i over cells [c_lo, c_hi).  `carry` is the exclusive
// prefix-min of dprime - c*gc over all cells left of c_lo.
template <bool TRANS, bool TRACE>
static TA_DEV void band_row_pass2(const BandPair& P, const BandState& S, int i,
                                  int c_lo, int c_hi, int32_t carry) {
  int32_t run = carry;
  for (int c = c_lo; c < c_hi; ++c) {
    const int32_t j = i + c - P.unit_k;
    const bool valid = j >= 0 && j <= P.n;
    const int32_t sub = S.cur[c];
    const int32_t bgap2 = S.bgcur[c];
    bool tcond = false;
    int32_t trans = TA_BAND_INF;
    if (TRANS) {
      const int32_t t = S.tr[c];
      tcond = t >= 0;
      if (tcond) trans = t;
    }
    const BandCellOut o =
        band_cell_post(sub, bgap2, trans, tcond, valid, c, run, P.k);
    S.cur[c] = o.dp2;
    if (TRACE) S.code[c] = (uint8_t)o.code;
    const int32_t d = ta_min32(ta_min32(sub, bgap2), trans);
    const int32_t dprime = valid ? ta_min32(d, TA_BAND_INF) : TA_BAND_INF;
    run = ta_min32(run, dprime - c * P.k.gc);
  }
}

// Packed word w of a row of W code bytes: cell c at bits 2 * (c % 16).
static TA_DEV uint32_t band_pack_word(const uint8_t* code, int w, int W) {
  uint32_t word = 0u;
  const int base = w * TA_CODES_PER_WORD;
  for (int q = 0; q < TA_CODES_PER_WORD; ++q) {
    const int c = base + q;
    if (c < W) word |= (uint32_t)(code[c] & 3u) << (2 * q);
  }
  return word;
}

static TA_DEV void band_rotate(BandState& S) {
  int32_t* t = S.dp0;
  S.dp0 = S.dp1;
  S.dp1 = S.cur;
  S.cur = t;
  t = S.bg;
  S.bg = S.bgcur;
  S.bgcur = t;
}

static TA_DEV int32_t band_final_cell(const BandPair& P) {
  int32_t c = P.n - P.m + P.unit_k;
  if (c < 0) c = 0;
  if (c > P.W - 1) c = P.W - 1;
  return c;
}

// ints of band state per pair (6 rows of W) and the bytes that follow them
static inline size_t band_state_bytes(int W) {
  return (size_t)(6 * W + 32) * sizeof(int32_t) + (size_t)((W + 3) & ~3);
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

template <bool TRANS, bool TRACE>
__global__ void band_kernel(const uint8_t* __restrict__ a,
                            const uint8_t* __restrict__ b,
                            const int32_t* __restrict__ m,
                            const int32_t* __restrict__ n,
                            int32_t* __restrict__ out,
                            uint32_t* __restrict__ codes, int64_t a_stride,
                            int64_t b_stride, int unit_k, int64_t code_rows,
                            BandCosts costs) {
  extern __shared__ int32_t ta_band_smem[];
  const int W = 2 * unit_k + 1;
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int cpt = (W + T - 1) / T;
  const int c_lo = min(t * cpt, W), c_hi = min(c_lo + cpt, W);
  const int64_t p = blockIdx.x;

  BandState S;
  S.dp0 = ta_band_smem;
  S.dp1 = S.dp0 + W;
  S.cur = S.dp1 + W;
  S.bg = S.cur + W;
  S.bgcur = S.bg + W;
  S.tr = S.bgcur + W;
  int32_t* wmin = S.tr + W;  // one word per warp
  S.code = reinterpret_cast<uint8_t*>(wmin + 32);

  BandPair P;
  P.a = a + p * a_stride;
  P.b = b + p * b_stride;
  // the wrapper's contract is m <= the a row's length (the lengths live on
  // the device, so it cannot check them without a sync): a larger m is
  // cut here so that no row is read, and no code row written, past its end
  P.m = min(m[p], (int32_t)a_stride);
  P.n = n[p];
  P.unit_k = unit_k;
  P.W = W;
  P.k = costs;

  const int wpr = (W + TA_CODES_PER_WORD - 1) / TA_CODES_PER_WORD;
  uint32_t* code_out = TRACE ? codes + p * code_rows * wpr : nullptr;

  band_init_row(P, S, c_lo, c_hi);
  __syncthreads();
  for (int i = 1; i <= P.m; ++i) {
    const int32_t cmin = band_row_pass1<TRANS>(P, S, i, c_lo, c_hi);
    // inclusive scan of the threads' mins inside the warp, then the
    // exclusive value of this thread
    int32_t inc = cmin;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t v = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc = min(inc, v);
    }
    int32_t carry = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) carry = TA_BAND_INF;
    if (lane == 31) wmin[warp] = inc;
    __syncthreads();
    for (int w = 0; w < warp; ++w) carry = min(carry, wmin[w]);
    band_row_pass2<TRANS, TRACE>(P, S, i, c_lo, c_hi, carry);
    __syncthreads();
    if (TRACE) {
      for (int w = t; w < wpr; w += T)
        code_out[(int64_t)(i - 1) * wpr + w] = band_pack_word(S.code, w, W);
    }
    band_rotate(S);
  }
  if (t == 0) out[p] = S.dp1[band_final_cell(P)];
}

template <bool TRANS, bool TRACE>
static int launch_band(const uint8_t* a, const uint8_t* b, const int32_t* m,
                       const int32_t* n, int32_t* out, uint32_t* codes,
                       int64_t B, int64_t a_stride, int64_t b_stride,
                       int unit_k, int64_t code_rows, BandCosts costs,
                       int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_kernel<TRANS, TRACE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  band_kernel<TRANS, TRACE><<<(unsigned)B, threads, smem, stream>>>(
      a, b, m, n, out, codes, a_stride, b_stride, unit_k, code_rows, costs);
  return (int)cudaGetLastError();
}

// Plain C entry point.  All pointers are device pointers; nothing is
// allocated or synchronised here.  `codes` null: distances only; else
// uint32 [B, code_rows, ceil(W / 16)] receives the packed argmin codes of
// rows 1..m of every pair (rows past m are left as they were).  Returns
// the cudaError_t of the launch.
extern "C" int ta_band_distance(const void* a, const void* b, const void* m,
                                const void* n, void* out, void* codes,
                                int64_t B, int64_t a_stride, int64_t b_stride,
                                int unit_k, int64_t code_rows, int mc, int gc,
                                int sgc, int tc, int transpose, int threads,
                                void* stream) {
  if (B <= 0) return 0;
  if (unit_k < 0 || threads < 32 || threads > 1024 || (threads & 31) ||
      B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int W = 2 * unit_k + 1;
  const size_t smem = band_state_bytes(W);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const uint8_t* ap = (const uint8_t*)a;
  const uint8_t* bp = (const uint8_t*)b;
  const int32_t* mp = (const int32_t*)m;
  const int32_t* np_ = (const int32_t*)n;
  int32_t* op = (int32_t*)out;
  uint32_t* cp = (uint32_t*)codes;
  const BandCosts costs{mc, gc, sgc, tc};
  cudaStream_t st = (cudaStream_t)stream;
  if (cp == nullptr) {
    return transpose
               ? launch_band<true, false>(ap, bp, mp, np_, op, cp, B, a_stride,
                                          b_stride, unit_k, code_rows, costs,
                                          threads, smem, st)
               : launch_band<false, false>(ap, bp, mp, np_, op, cp, B,
                                           a_stride, b_stride, unit_k,
                                           code_rows, costs, threads, smem, st);
  }
  return transpose
             ? launch_band<true, true>(ap, bp, mp, np_, op, cp, B, a_stride,
                                       b_stride, unit_k, code_rows, costs,
                                       threads, smem, st)
             : launch_band<false, true>(ap, bp, mp, np_, op, cp, B, a_stride,
                                        b_stride, unit_k, code_rows, costs,
                                        threads, smem, st);
}

#endif  // TA_HOST_REHEARSAL
