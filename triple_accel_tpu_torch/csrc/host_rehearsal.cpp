// Host rehearsal of the CUDA kernels' bodies: the per-pair and per-segment
// functions of myers_distance.cu and myers_search.cu, compiled for the CPU
// and run one "thread" at a time, so their arithmetic can be held against
// the plain PyTorch versions where there is no CUDA compiler and no card.
//
//   g++ -std=c++17 -O1 -shared -fPIC -I triple_accel_tpu_torch/csrc \
//       triple_accel_tpu_torch/csrc/host_rehearsal.cpp -o libta_rehearsal.so
//
// tests/test_torch_host_rehearsal.py builds and drives it.  Not part of the
// GPU library (utils/build.py compiles the .cu files only).

#define TA_HOST_REHEARSAL 1
#include <vector>

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
