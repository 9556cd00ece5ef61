// Host rehearsal of the CUDA kernels' bodies: the per-pair and per-segment
// functions of myers_distance.cu and myers_search.cu and the row passes of
// band_distance.cu, compiled for the CPU and run one "thread" at a time, so
// their arithmetic can be held against the plain PyTorch versions where
// there is no CUDA compiler and no card.
//
//   g++ -std=c++17 -O1 -shared -fPIC -I triple_accel_tpu_torch/csrc \
//       triple_accel_tpu_torch/csrc/host_rehearsal.cpp -o libta_rehearsal.so
//
// tests/test_torch_host_rehearsal.py builds and drives it.  Not part of the
// GPU library (utils/build.py compiles the .cu files only).

#define TA_HOST_REHEARSAL 1
#include <vector>

#include "band_distance.cu"
#include "myers_distance.cu"
#include "myers_search.cu"

template <int NW>
static void rehearse_distance(const uint8_t* a, const uint8_t* b,
                              const int32_t* m, const int32_t* dlen,
                              const int32_t* ukl, int32_t* out, int64_t B,
                              int64_t a_stride, int64_t b_stride) {
  std::vector<uint64_t> tab(32 * NW);
  for (int64_t p = 0; p < B; ++p) {
    RingTables<NW> ring{tab.data(), 1};
    out[p] = distance_pair<NW>(a + p * a_stride, b + p * b_stride, m[p],
                               dlen[p], ukl[p], ring);
  }
}

// Same arguments as ta_myers_distance, host pointers, no stream.
extern "C" int ta_rehearse_distance(const void* a, const void* b,
                                    const void* m, const void* dlen,
                                    const void* ukl, void* out, int64_t B,
                                    int64_t a_stride, int64_t b_stride,
                                    int nw) {
  const uint8_t* ap = (const uint8_t*)a;
  const uint8_t* bp = (const uint8_t*)b;
  const int32_t* mp = (const int32_t*)m;
  const int32_t* dp = (const int32_t*)dlen;
  const int32_t* up = (const int32_t*)ukl;
  int32_t* op = (int32_t*)out;
  switch (nw) {
    case 1:
      rehearse_distance<1>(ap, bp, mp, dp, up, op, B, a_stride, b_stride);
      return 0;
    case 2:
      rehearse_distance<2>(ap, bp, mp, dp, up, op, B, a_stride, b_stride);
      return 0;
    case 3:
      rehearse_distance<3>(ap, bp, mp, dp, up, op, B, a_stride, b_stride);
      return 0;
    default:
      return 1;
  }
}

// Same arguments as ta_myers_search, host pointers, no stream.
extern "C" int ta_rehearse_search(const void* hay, int64_t iter_len,
                                  const void* needles, int num, int m,
                                  int64_t own_len, int64_t halo, int64_t nseg,
                                  int anchored, int damerau, void* out,
                                  int64_t out_stride) {
  if (m < 1 || m > 1280 || out_stride < iter_len + 1 || (out_stride & 3))
    return 1;
  SearchArgs g;
  g.hay = (const uint8_t*)hay;
  g.iter_len = iter_len;
  g.m = m;
  g.nw = (m + 63) / 64;
  g.own_len = own_len;
  g.halo = halo;
  g.anchored = anchored;
  g.damerau = damerau;
  g.out_stride = out_stride;
  const uint8_t* nd = (const uint8_t*)needles;
  for (int i = 0; i < num; ++i) {
    std::vector<uint64_t> peq((int64_t)256 * g.nw, 0ull);
    for (int t = 0; t < m; ++t)
      peq[(int64_t)nd[(int64_t)i * m + t] * g.nw + t / 64] |= 1ull << (t % 64);
    int32_t* row = (int32_t*)out + (int64_t)i * out_stride;
    for (int64_t c = 0; c < nseg; ++c) {
      if (g.nw == 1)
        search_segment<1>(g, peq.data(), c, row);
      else if (g.nw == 2)
        search_segment<2>(g, peq.data(), c, row);
      else
        search_segment<20>(g, peq.data(), c, row);
    }
  }
  return 0;
}

// One pair after the other; inside a pair, `threads` "threads" take their
// runs of band cells in turn, pass 1, then the exclusive prefix over the
// threads' mins that the device gets from a warp scan, then pass 2.
template <bool TRANS, bool TRACE>
static void rehearse_band(const uint8_t* a, const uint8_t* b, const int32_t* m,
                          const int32_t* n, int32_t* out, uint32_t* codes,
                          int64_t B, int64_t a_stride, int64_t b_stride,
                          int unit_k, int64_t code_rows, BandCosts costs,
                          int threads) {
  const int W = 2 * unit_k + 1;
  const int T = threads;
  const int cpt = (W + T - 1) / T;
  const int wpr = (W + TA_CODES_PER_WORD - 1) / TA_CODES_PER_WORD;
  std::vector<int32_t> state((size_t)6 * W);
  std::vector<uint8_t> code(W);
  std::vector<int32_t> cmin(T);
  for (int64_t p = 0; p < B; ++p) {
    BandState S;
    S.dp0 = state.data();
    S.dp1 = S.dp0 + W;
    S.cur = S.dp1 + W;
    S.bg = S.cur + W;
    S.bgcur = S.bg + W;
    S.tr = S.bgcur + W;
    S.code = code.data();
    BandPair P;
    P.a = a + p * a_stride;
    P.b = b + p * b_stride;
    P.m = m[p];
    P.n = n[p];
    P.unit_k = unit_k;
    P.W = W;
    P.k = costs;
    auto lo = [&](int t) { return t * cpt < W ? t * cpt : W; };
    auto hi = [&](int t) { return lo(t) + cpt < W ? lo(t) + cpt : W; };
    for (int t = 0; t < T; ++t) band_init_row(P, S, lo(t), hi(t));
    for (int i = 1; i <= P.m; ++i) {
      for (int t = 0; t < T; ++t)
        cmin[t] = band_row_pass1<TRANS>(P, S, i, lo(t), hi(t));
      int32_t carry = TA_BAND_INF;
      for (int t = 0; t < T; ++t) {
        band_row_pass2<TRANS, TRACE>(P, S, i, lo(t), hi(t), carry);
        carry = ta_min32(carry, cmin[t]);
      }
      if (TRACE)
        for (int w = 0; w < wpr; ++w)
          codes[(p * code_rows + (i - 1)) * wpr + w] =
              band_pack_word(S.code, w, W);
      band_rotate(S);
    }
    out[p] = S.dp1[band_final_cell(P)];
  }
}

// Same arguments as ta_band_distance, host pointers, no stream.
extern "C" int ta_rehearse_band(const void* a, const void* b, const void* m,
                                const void* n, void* out, void* codes,
                                int64_t B, int64_t a_stride, int64_t b_stride,
                                int unit_k, int64_t code_rows, int mc, int gc,
                                int sgc, int tc, int transpose, int threads) {
  if (unit_k < 0 || threads < 32 || threads > 1024 || (threads & 31)) return 1;
  if (band_state_bytes(2 * unit_k + 1) > 232448) return 1;
  const uint8_t* ap = (const uint8_t*)a;
  const uint8_t* bp = (const uint8_t*)b;
  const int32_t* mp = (const int32_t*)m;
  const int32_t* np_ = (const int32_t*)n;
  int32_t* op = (int32_t*)out;
  uint32_t* cp = (uint32_t*)codes;
  const BandCosts costs{mc, gc, sgc, tc};
  if (cp == nullptr) {
    if (transpose)
      rehearse_band<true, false>(ap, bp, mp, np_, op, cp, B, a_stride,
                                 b_stride, unit_k, code_rows, costs, threads);
    else
      rehearse_band<false, false>(ap, bp, mp, np_, op, cp, B, a_stride,
                                  b_stride, unit_k, code_rows, costs, threads);
  } else {
    if (transpose)
      rehearse_band<true, true>(ap, bp, mp, np_, op, cp, B, a_stride,
                                b_stride, unit_k, code_rows, costs, threads);
    else
      rehearse_band<false, true>(ap, bp, mp, np_, op, cp, B, a_stride,
                                 b_stride, unit_k, code_rows, costs, threads);
  }
  return 0;
}
