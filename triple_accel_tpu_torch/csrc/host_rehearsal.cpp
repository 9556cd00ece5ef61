// Host rehearsal of the CUDA kernels' bodies: the per-pair and per-segment
// functions of myers_distance.cu and myers_search.cu, the lanes of
// band_distance.cu's warp, block and cluster regimes (the cluster's warps
// round by round in their ring),
// the walk of trace_walk.cu (the lanes of a pair's group in turn, their
// copies landing at their waits),
// the per-lane wavefront steps of myers_blocked.cu and search_diag.cu (the
// lanes of a group in turn, the warps of a block in order) and the lanes
// and warps of search_flat.cu,
// compiled for the CPU and run one "thread" at a time, so their arithmetic
// can be held against the plain PyTorch versions where there is no CUDA
// compiler and no card.
//
//   g++ -std=c++17 -O1 -shared -fPIC -I triple_accel_tpu_torch/csrc \
//       triple_accel_tpu_torch/csrc/host_rehearsal.cpp -o libta_rehearsal.so
//
// tests/test_torch_host_rehearsal.py builds and drives it.  Not part of the
// GPU library (utils/build.py compiles the .cu files only).

#define TA_HOST_REHEARSAL 1
#include <cstring>
#include <vector>

#include "band_distance.cu"
#include "myers_blocked.cu"
#include "myers_distance.cu"
#include "myers_search.cu"
#include "search_diag.cu"
#include "search_flat.cu"
#include "trace_walk.cu"

template <int NW>
static void rehearse_distance(const uint8_t* a, const uint8_t* b,
                              const int32_t* m, const int32_t* dlen,
                              const int32_t* ukl, int32_t* out, int64_t B,
                              int64_t a_stride, int64_t b_stride) {
  // one "thread" of a table laid out for 16 (its column 0), garbage
  // between pairs as on the card (nothing is cleared but what the kernel
  // clears)
  constexpr int TS = 16;
  std::vector<uint32_t> tab((size_t)MD_ENTRIES * md_slots<NW> * TS,
                            0xA5A5A5A5u);
  for (int64_t p = 0; p < B; ++p)
    out[p] = distance_pair<NW, TS>(a + p * a_stride, b + p * b_stride, m[p],
                                   dlen[p], ukl[p], tab.data(), 0);
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
  if ((a_stride & 15) || (b_stride & 15)) return 1;
  switch (nw) {  // the plan's 64-bit words: 2 * nw words of 32 bits
    case 1:
      rehearse_distance<2>(ap, bp, mp, dp, up, op, B, a_stride, b_stride);
      return 0;
    case 2:
      rehearse_distance<4>(ap, bp, mp, dp, up, op, B, a_stride, b_stride);
      return 0;
    case 3:
      rehearse_distance<6>(ap, bp, mp, dp, up, op, B, a_stride, b_stride);
      return 0;
    default:
      return 1;
  }
}

// One needle of K2: its table, then the warps of 32 consecutive segments
// one after the other; inside a warp, each chunk's 16 steps lane by lane,
// then the store phase lane by lane (the staging area an array), as the
// card runs them between its two __syncwarp.
template <int NW, bool DAM>
static void rehearse_search_needle(const SearchArgs& g, const uint8_t* needle,
                                   int32_t* out_row) {
  std::vector<uint32_t> peq((size_t)NW * MS_ROW, 0u);
  for (int t = 0; t < g.m; ++t)
    peq[(t >> 5) * MS_ROW + needle[t]] |= 1u << (t & 31);
  out_row[0] = g.m;
  std::vector<uint4> stage(MS_STAGE_PIECES);
  std::vector<MsLane<NW, DAM>> L(MS_LANES);
  std::vector<MsStore> st(MS_LANES);
  const uint32_t ph_in = g.anchored ? 1u : 0u;
  const int wS = ms_score_word<NW>(g.m), offS = (g.m - 1) & 31;
  for (int64_t c_warp = 0; c_warp < g.nseg; c_warp += MS_LANES) {
    int32_t chunks = 0;
    bool guard = false;
    for (int lane = 0; lane < MS_LANES; ++lane) {
      const MsSeg sg = ms_seg(g, c_warp + lane);
      chunks = sg.chunks > chunks ? sg.chunks : chunks;
      guard = guard || sg.d > 0;
      ms_lane_start(L[lane], g, sg);
      st[lane] = ms_store_plan(g, out_row, c_warp, lane);
    }
    for (int32_t k = 0; k < chunks; ++k) {
      for (int lane = 0; lane < MS_LANES; ++lane) {
        uint4* row = stage.data() + 4 * lane;
        if (k < 2 && guard)
          ms_chunk<NW, DAM, true>(L[lane], peq.data(), k, row, ms_swz(lane),
                                  ph_in, wS, offS);
        else
          ms_chunk<NW, DAM, false>(L[lane], peq.data(), k, row,
                                   ms_swz(lane), ph_in, wS, offS);
      }
      for (int lane = 0; lane < MS_LANES; ++lane)
        ms_store(st[lane], stage.data(), lane, k);
    }
  }
}

template <bool DAM>
static int rehearse_search_words(int nw, const SearchArgs& g,
                                 const uint8_t* needle, int32_t* out_row) {
  switch (nw) {
#define TA_MS_CASE(NN)                                   \
  case NN:                                               \
    rehearse_search_needle<NN, DAM>(g, needle, out_row); \
    return 0;
    TA_MS_CASE(1)
    TA_MS_CASE(2)
    TA_MS_CASE(3)
    TA_MS_CASE(4)
    TA_MS_CASE(6)
    TA_MS_CASE(8)
    TA_MS_CASE(12)
    TA_MS_CASE(16)
    TA_MS_CASE(24)
    TA_MS_CASE(40)
#undef TA_MS_CASE
    default:
      return 1;
  }
}

// Same arguments as ta_myers_search but the warps a block (they share the
// table only), host pointers, no stream.
extern "C" int ta_rehearse_search(const void* hay, int64_t iter_len,
                                  const void* needles, int num, int m,
                                  int64_t own_len, int64_t halo, int64_t nseg,
                                  int anchored, int damerau, void* out,
                                  int64_t out_stride, int nw) {
  if (m < 1 || m > 1280 || 32 * nw < m || (nw <= 2 && 32 * nw - 32 >= m) ||
      own_len < 1 || halo < 0 || nseg < 1 || out_stride < iter_len + 1 ||
      (out_stride & 3))
    return 1;
  SearchArgs g;
  g.hay = (const uint8_t*)hay;
  g.iter_len = iter_len;
  g.m = m;
  g.own_len = own_len;
  g.halo = halo;
  g.nseg = nseg;
  g.anchored = anchored;
  g.out_stride = out_stride;
  const uint8_t* nd = (const uint8_t*)needles;
  for (int i = 0; i < num; ++i) {
    int32_t* row = (int32_t*)out + (int64_t)i * out_stride;
    const int rc = damerau
                       ? rehearse_search_words<true>(nw, g, nd + (int64_t)i * m, row)
                       : rehearse_search_words<false>(nw, g, nd + (int64_t)i * m, row);
    if (rc) return rc;
  }
  return 0;
}

// The warp regime: one warp after the other (32 / G pairs, one group of G
// lanes each), the lanes of a warp running each step of a row in turn.
// What the device gets from a shuffle comes from an array of the lanes'
// values, with the device's rules: __shfl_down_sync / __shfl_up_sync by
// `off` inside a group return the caller's own value where the source lies
// outside the group, __shfl_sync reads lane src % G of the group.
template <bool TRANS, bool TRACE, int C>
static void rehearse_band_warp(const uint8_t* a, const uint8_t* b,
                               const int32_t* m, const int32_t* n,
                               int32_t* out, uint32_t* codes, int64_t B,
                               int64_t a_stride, int64_t b_stride, int unit_k,
                               int64_t code_rows, BandCosts k, int G) {
  typedef typename BandBits<C>::T Bits;
  const int32_t W = 2 * unit_k + 1;
  const int wpr = (W + TA_CODES_PER_WORD - 1) / TA_CODES_PER_WORD;
  const int64_t b_next = (int64_t)G * C - 1;
  std::vector<BandLane<TRANS, TRACE, C>> L(32);
  std::vector<BandStream> S(32);
  int32_t mm[32], nn[32], cfin[32], ach[32], apv[32], f_out[32], inc[32];
  int32_t tmp[32], v[32], chr[32];
  bool live[32];
  int64_t pp[32];
  BandUp own[32];
  Bits bits[32], cmask[32];
  // group lane of l, the lane `off` to the right / left inside l's group
  auto gl_of = [&](int l) { return l % G; };
  auto down = [&](int l, int off) { return gl_of(l) + off < G ? l + off : l; };
  auto upl = [&](int l, int off) { return gl_of(l) >= off ? l - off : l; };
  for (int64_t p0 = 0; p0 < B; p0 += 32 / G) {
    int32_t rows = 0;
    for (int l = 0; l < 32; ++l) {
      const int gl = gl_of(l);
      const int32_t c0 = gl * C;
      pp[l] = p0 + l / G;
      live[l] = pp[l] < B;
      const int64_t p = live[l] ? pp[l] : 0;
      mm[l] = live[l] ? (m[p] < a_stride ? m[p] : (int32_t)a_stride) : 0;
      nn[l] = live[l] ? n[p] : 0;
      cfin[l] = band_final_cell(mm[l], nn[l], unit_k, W) - c0;
      band_lane_init(L[l], b + p * b_stride, b_stride, nn[l], unit_k, W, c0,
                     k);
      if (live[l] && cfin[l] >= 0 && cfin[l] < C && mm[l] == 0)
        out[pp[l]] = band_lane_pick(L[l], cfin[l]);
      rows = rows > mm[l] ? rows : mm[l];
      cmask[l] = band_lane_code_mask<C>(c0, W);
      const bool b_lane = gl == G - 1;
      S[l].start(b_lane ? b + p * b_stride : a + p * a_stride,
                 b_lane ? b_stride : a_stride);
      ach[l] = a[p * a_stride];
      apv[l] = -1;
    }
    for (int32_t i = 1; i <= rows; ++i) {
      BandRow R[32];
      for (int l = 0; l < 32; ++l) {
        R[l] = band_row(i, ach[l], apv[l], nn[l], unit_k, W, gl_of(l) * C);
        own[l] = band_lane_up(L[l]);
      }
      for (int l = 0; l < 32; ++l) {
        const BandUp up = band_up_in(own[down(l, 1)], gl_of(l) == G - 1);
        f_out[l] = band_lane_pass1(L[l], k, R[l], up);
        inc[l] = band_lane_key(f_out[l], gl_of(l), C, k.gc);
      }
      for (int off = 1; off < G; off <<= 1) {
        for (int l = 0; l < 32; ++l) tmp[l] = inc[upl(l, off)];
        for (int l = 0; l < 32; ++l) inc[l] = ta_min32(inc[l], tmp[l]);
      }
      for (int l = 0; l < 32; ++l) {
        const int32_t ex = inc[upl(l, 1)];
        bits[l] = band_lane_pass2(L[l], k, R[l],
                                  band_lane_carry(ex, gl_of(l), C, k.gc));
        bits[l] &= cmask[l];
      }
      if (TRACE)
        for (int l = 0; l < 32; ++l)
          for (int r = 0; r < band_word_rounds<C>(); ++r) {
            const int32_t w = gl_of(l) + r * G;
            const int base = l - gl_of(l);
            const uint32_t word = band_word<C>(
                w, G, [&](int32_t src) { return bits[base + src % G]; });
            if (live[l] && i <= mm[l] && w < wpr)
              codes[(pp[l] * code_rows + (i - 1)) * wpr + w] = word;
          }
      for (int l = 0; l < 32; ++l) {
        if (live[l] && cfin[l] >= 0 && cfin[l] < C && i == mm[l])
          out[pp[l]] = band_lane_pick(L[l], cfin[l]);
        chr[l] = band_lane_char_out(L[l]);
        v[l] = S[l].at(gl_of(l) == G - 1 ? i + b_next : i);
      }
      for (int l = 0; l < 32; ++l) {
        band_lane_slide(L[l], gl_of(l) == G - 1 ? v[l] : chr[down(l, 1)]);
        apv[l] = ach[l];
        ach[l] = v[l - gl_of(l)];
      }
    }
  }
}

template <bool TRANS, bool TRACE>
static int rehearse_band(const uint8_t* a, const uint8_t* b, const int32_t* m,
                         const int32_t* n, int32_t* out, uint32_t* codes,
                         int64_t B, int64_t a_stride, int64_t b_stride,
                         int unit_k, int64_t code_rows, BandCosts k,
                         int cells, int lanes) {
  switch (cells) {
#define TA_BAND_CASE(CC)                                                  \
  case CC:                                                                \
    rehearse_band_warp<TRANS, TRACE, CC>(a, b, m, n, out, codes, B,       \
                                         a_stride, b_stride, unit_k,      \
                                         code_rows, k, lanes);            \
    return 0;
    TA_BAND_CASE(3)
    TA_BAND_CASE(5)
    TA_BAND_CASE(9)
    TA_BAND_CASE(17)
#undef TA_BAND_CASE
    default:
      return 1;
  }
}

// Same arguments as ta_band_distance, host pointers, no stream; refuses
// what the launcher refuses.
extern "C" int ta_rehearse_band(const void* a, const void* b, const void* m,
                                const void* n, void* out, void* codes,
                                int64_t B, int64_t a_stride, int64_t b_stride,
                                int unit_k, int64_t code_rows, int mc, int gc,
                                int sgc, int tc, int transpose, int threads,
                                int cells, int lanes) {
  if (unit_k < 0 || threads < 32 || threads > TA_BAND_WARP_THREADS ||
      (threads & 31) || a_stride < 1 || b_stride < a_stride ||
      !band_warp_map_ok(cells, lanes, 2 * unit_k + 1))
    return 1;
  if (B <= 0) return 0;
  const uint8_t* ap = (const uint8_t*)a;
  const uint8_t* bp = (const uint8_t*)b;
  const int32_t* mp = (const int32_t*)m;
  const int32_t* np_ = (const int32_t*)n;
  int32_t* op = (int32_t*)out;
  uint32_t* cp = (uint32_t*)codes;
  const BandCosts k{mc, gc, sgc, tc};
  if (cp == nullptr)
    return transpose ? rehearse_band<true, false>(ap, bp, mp, np_, op, cp, B,
                                                  a_stride, b_stride, unit_k,
                                                  code_rows, k, cells, lanes)
                     : rehearse_band<false, false>(ap, bp, mp, np_, op, cp, B,
                                                   a_stride, b_stride, unit_k,
                                                   code_rows, k, cells,
                                                   lanes);
  return transpose ? rehearse_band<true, true>(ap, bp, mp, np_, op, cp, B,
                                               a_stride, b_stride, unit_k,
                                               code_rows, k, cells, lanes)
                   : rehearse_band<false, true>(ap, bp, mp, np_, op, cp, B,
                                                a_stride, b_stride, unit_k,
                                                code_rows, k, cells, lanes);
}

// The block regime of band_distance.cu: one pair after the other; the
// pair's NW warps run round by round, a round being what a warp runs
// between two block barriers, the lanes of a warp in turn (the shuffles
// arrays, the device's rules as in rehearse_band_warp at G = 32).  The
// slots in shared memory (`edge`, `tot`) are arrays that start as garbage;
// each remembers the row it holds, the round that wrote it and the last
// round that read it.  A read of a slot that no earlier round wrote, or
// that holds another row than the reader needs, fails the rehearsal, and
// so does a write in a round in which a warp read the slot (the barriers
// order nothing inside a round).  The warps of a round run first to last
// (`order` 0) or last to first (1).
template <class T>
struct HostSlot {
  T v;
  int32_t row;
  int64_t wrote, read;
};

template <class T>
static bool slot_get(HostSlot<T>& s, int32_t row, int64_t round, T* v) {
  if (s.wrote >= round || s.row != row) return false;
  s.read = round;
  *v = s.v;
  return true;
}

template <class T>
static bool slot_put(HostSlot<T>& s, const T& v, int32_t row, int64_t round) {
  if (s.read == round) return false;
  s.v = v;
  s.row = row;
  s.wrote = round;
  return true;
}

template <bool TRANS, bool TRACE, int C>
static int rehearse_band_block(const uint8_t* a, const uint8_t* b,
                               const int32_t* m, const int32_t* n,
                               int32_t* out, uint32_t* codes, int64_t B,
                               int64_t a_stride, int64_t b_stride,
                               int unit_k, int64_t code_rows, BandCosts k,
                               int NW, int order) {
  typedef typename BandBits<C>::T Bits;
  typedef BandLane<TRANS, TRACE, C, true> Lane;
  const int32_t W = 2 * unit_k + 1;
  const int wpr = (W + TA_CODES_PER_WORD - 1) / TA_CODES_PER_WORD;
  const int64_t b_next = (int64_t)NW * 32 * C - 1;
  const int T = NW * 32;
  std::vector<Lane> L(T);
  std::vector<BandRow> R(T);
  std::vector<int32_t> ex(T), chr(T), v(T), ach(NW), apv(NW);
  std::vector<HostSlot<BandEdge>> edge(NW);
  std::vector<HostSlot<int32_t>> tot(NW);
  auto warp_at = [&](int x) { return order == 0 ? x : NW - 1 - x; };
  for (int64_t p = 0; p < B; ++p) {
    std::memset(edge.data(), 0xA5, edge.size() * sizeof(edge[0]));
    std::memset(tot.data(), 0xA5, tot.size() * sizeof(tot[0]));
    for (int w = 0; w < NW; ++w) {
      edge[w].row = tot[w].row = -1;
      edge[w].wrote = edge[w].read = tot[w].wrote = tot[w].read = -1;
    }
    const int32_t mm = m[p] < a_stride ? m[p] : (int32_t)a_stride;
    const int32_t nn = n[p];
    const uint8_t* a_row = a + p * a_stride;
    const uint8_t* b_row = b + p * b_stride;
    uint32_t* code_out = TRACE ? codes + p * code_rows * wpr : nullptr;
    const int32_t cfin = band_final_cell(mm, nn, unit_k, W);
    int64_t round = 0;
    // the round before the first barrier
    for (int gl = 0; gl < T; ++gl) {
      band_lane_init(L[gl], b_row, b_stride, nn, unit_k, W, gl * C, k);
      if (mm == 0 && cfin - gl * C >= 0 && cfin - gl * C < C)
        out[p] = band_lane_pick(L[gl], cfin - gl * C);
    }
    for (int w = 0; w < NW; ++w) {
      slot_put(edge[w], BandEdge{L[32 * w].dp1[0], L[32 * w].bg[0], 0}, 0,
               round);
      ach[w] = a_row[0];
      apv[w] = -1;
    }
    for (int32_t i = 1; i <= mm + 1; ++i) {
      ++round;  // the previous row's slide, then pass 1 and the scan
      for (int x = 0; x < NW; ++x) {
        const int w = warp_at(x);
        const bool last_warp = w == NW - 1;
        BandEdge e{TA_BAND_INF, TA_BAND_INF, 0};
        if (!last_warp && !slot_get(edge[w + 1], i - 1, round, &e)) return 2;
        if (i > 1) {
          for (int l = 0; l < 32; ++l) {
            const int gl = 32 * w + l;
            band_lane_slide(L[gl], l < 31 ? chr[gl + 1]
                                   : last_warp ? v[gl] : e.h);
          }
          apv[w] = ach[w];
          ach[w] = v[32 * w];
        }
        if (i > mm) continue;  // the loop ends after the last slide
        BandUp own[32];
        int32_t inc[32], tmp[32];
        for (int l = 0; l < 32; ++l) {
          const int gl = 32 * w + l;
          R[gl] = band_row(i, ach[w], apv[w], nn, unit_k, W, gl * C);
          own[l] = band_lane_up(L[gl]);
        }
        for (int l = 0; l < 32; ++l) {
          const int gl = 32 * w + l;
          BandUp up = l < 31 ? own[l + 1] : BandUp{e.d, e.g};
          up = band_up_in(up, last_warp && l == 31);
          inc[l] = band_lane_key(band_lane_pass1(L[gl], k, R[gl], up), gl, C,
                                 k.gc);
        }
        for (int off = 1; off < 32; off <<= 1) {
          for (int l = 0; l < 32; ++l)
            tmp[l] = l >= off ? inc[l - off] : inc[l];
          for (int l = 0; l < 32; ++l) inc[l] = ta_min32(inc[l], tmp[l]);
        }
        for (int l = 0; l < 32; ++l)
          ex[32 * w + l] = l >= 1 ? inc[l - 1] : inc[l];
        if (!slot_put(tot[w], inc[31], i, round)) return 2;
      }
      if (i > mm) break;
      ++round;  // the carry, pass 2, the codes and the hand-over
      for (int x = 0; x < NW; ++x) {
        const int w = warp_at(x);
        int32_t left = TA_BAND_INF;
        for (int q = 0; q < w; ++q) {
          int32_t t;
          if (!slot_get(tot[q], i, round, &t)) return 2;
          left = ta_min32(left, t);
        }
        Bits bits[32];
        for (int l = 0; l < 32; ++l) {
          const int gl = 32 * w + l;
          bits[l] = band_lane_pass2(
              L[gl], k, R[gl],
              band_block_carry(left, ex[gl], l, gl, C, k.gc));
          bits[l] &= band_lane_code_mask<C>(gl * C, W);
        }
        if (TRACE)
          for (int l = 0; l < 32; ++l)
            for (int r = 0; r < band_word_rounds<C>(); ++r) {
              const int32_t wl = l + 32 * r;
              const uint32_t word = band_word<C>(
                  wl, 32, [&](int32_t src) { return bits[src % 32]; });
              const int32_t wg = band_block_word0(w, C) + wl;
              if (wl < 2 * C && wg < wpr)
                code_out[(int64_t)(i - 1) * wpr + wg] = word;
            }
        for (int l = 0; l < 32; ++l) {
          const int gl = 32 * w + l;
          if (i == mm && cfin - gl * C >= 0 && cfin - gl * C < C)
            out[p] = band_lane_pick(L[gl], cfin - gl * C);
          chr[gl] = band_lane_char_out(L[gl]);
          v[gl] = l == 0 ? band_byte(a_row, a_stride, i)
                  : (w == NW - 1 && l == 31)
                      ? band_byte(b_row, b_stride, i + b_next)
                      : 0;
        }
        const Lane& L0 = L[32 * w];
        if (!slot_put(edge[w], BandEdge{L0.dp1[0], L0.bg[0],
                                        band_lane_char_out(L0)},
                      i, round))
          return 2;
      }
    }
  }
  return 0;
}

// Same arguments as ta_band_block, host pointers, no stream, and the
// warps' `order` (see rehearse_band_block); refuses what the launcher
// refuses, returns 2 where a warp reads a slot no earlier round wrote.
extern "C" int ta_rehearse_band_block(const void* a, const void* b,
                                      const void* m, const void* n,
                                      void* out, void* codes, int64_t B,
                                      int64_t a_stride, int64_t b_stride,
                                      int unit_k, int64_t code_rows, int mc,
                                      int gc, int sgc, int tc, int transpose,
                                      int cells, int warps, int order) {
  if (!band_block_ok(unit_k, cells, warps) || a_stride < 1 ||
      b_stride < a_stride)
    return 1;
  if (B <= 0) return 0;
  const BandCosts k{mc, gc, sgc, tc};
  const uint8_t* ap = (const uint8_t*)a;
  const uint8_t* bp = (const uint8_t*)b;
  const int32_t* mp = (const int32_t*)m;
  const int32_t* np_ = (const int32_t*)n;
  int32_t* op = (int32_t*)out;
  uint32_t* cp = (uint32_t*)codes;
#define TA_BLOCK_RUN(TR, TC, CC)                                            \
  return rehearse_band_block<TR, TC, CC>(ap, bp, mp, np_, op, cp, B,      \
                                         a_stride, b_stride, unit_k,      \
                                         code_rows, k, warps, order)
#define TA_BLOCK_CELLS(TR, TC) \
  if (cells == 9) TA_BLOCK_RUN(TR, TC, 9); \
  TA_BLOCK_RUN(TR, TC, 17)
  if (cp == nullptr) {
    if (transpose) { TA_BLOCK_CELLS(true, false); }
    TA_BLOCK_CELLS(false, false);
  }
  if (transpose) { TA_BLOCK_CELLS(true, true); }
  TA_BLOCK_CELLS(false, true);
#undef TA_BLOCK_CELLS
#undef TA_BLOCK_RUN
}

// The cluster regime of band_distance.cu: one pair after the other; the
// pair's G = ctas * warps warps in their ring, each running its steps
// (strip, row) in order with its 32 lanes in turn (the shuffles arrays).
// The rings of the CTAs' distributed shared memory and the wrap's buffer
// in device memory are arrays of slots that start as garbage and remember
// the hand-over they hold (its number) and whether it was taken; the counts
// are released as the kernel releases them (every TA_CL_BATCH hand-overs,
// and at a strip's last).  The warps run round by round and see the counts
// as they stood when the round began, so a slot is read only in a round
// after the one that wrote it: `order` 0, one step a warp a round; 1, as
// many steps as a warp can run before it would wait (so every ring
// fills).  A warp that would wait (a hand-over not yet released to it, or
// a ring slot not yet taken) sits out the rest of its round; a round in
// which no warp runs is a deadlock and fails the rehearsal (2), and so
// does a read of a slot that does not hold the hand-over the reader counts
// (one that no earlier round wrote, or another), or a write over one not
// yet taken (3): at the wrap that is the claim that its writer needs no
// wait.
struct ClHostSlot {
  ClSlot v;
  int seq;     // the hand-over it holds (-1: garbage)
  bool taken;  // read by its receiver
};

template <bool TRANS>
struct ClWarpHost {
  ClLane<TRANS> L[32];
  uint32_t vprev[32];
  int32_t e1a, e1b, e2a, e2b, ach, apv;
  int32_t s, i;  // its strip (>= S: done) and the strip's next row
  int32_t first, last, in_last, out_first;
  ClHostSlot ring[TA_CL_RING];  // what it takes from the warp on its left
  int pub;        // hand-overs released to it (the first warp: the wrap's)
  int out_taken;  // its hand-overs the warp on its right released as taken
  int seq_in, seq_out;
};

template <bool TRANS>
static void rehearse_cluster_strip(ClWarpHost<TRANS>& H, const ClPair& P,
                                   const uint8_t* a_row, const uint8_t* b_row,
                                   int64_t b_len, int32_t* out,
                                   const BandCosts& k) {
  const int32_t s = H.s;
  for (int l = 0; l < 32; ++l) {
    const int32_t jb = (s * 32 + l) * TA_CL_COLS;
    cl_lane_init(H.L[l], b_row, b_len, P, jb, k);
    H.vprev[l] = 0u;
    if (P.m == 0 && P.jf - jb >= 0 && P.jf - jb < TA_CL_COLS)
      *out = cl_lane_pick(H.L[l], P.jf - jb);
  }
  H.first = cl_first_row(s, P);
  H.last = cl_last_row(s, P);
  H.in_last = cl_in_last(s, P);
  H.out_first = cl_out_first(s, P);
  H.e1a = H.e1b = H.e2a = H.e2b = TA_BAND_INF;
  H.ach = H.first <= P.m ? a_row[H.first - 1] : 0;
  H.apv = H.first > 1 ? a_row[H.first - 2] : -1;
  H.i = H.first;
}

// One step of warp g: 0 ran, 1 would wait, 3 a slot that breaks the
// protocol.  `pub0` / `taken0`: the counts as the round began.
template <bool TRANS>
static int rehearse_cluster_step(std::vector<ClWarpHost<TRANS>>& wp,
                                 std::vector<ClHostSlot>& wrap,
                                 const std::vector<int>& pub0,
                                 const std::vector<int>& taken0, int g,
                                 const ClPair& P, const uint8_t* a_row,
                                 const uint8_t* b_row, int64_t b_len,
                                 uint32_t* code_out, int32_t* out,
                                 const BandCosts& k) {
  ClWarpHost<TRANS>& H = wp[g];
  const int G = (int)wp.size();
  const bool in_wrap = g == 0, out_wrap = g == G - 1;
  const int32_t s = H.s, i = H.i, uk = P.uk;
  const bool take = s > 0 && i <= H.in_last, send = i >= H.out_first;
  // where the kernel would wait: for its hand-over, and for a ring slot
  if ((take && pub0[g] < H.seq_in + 1) ||
      (send && !out_wrap && H.seq_out + 1 - TA_CL_RING > taken0[g]))
    return 1;
  int32_t cin = TA_BAND_INF;
  uint32_t vleft = 0u;
  if (s == 0) {
    if (i > 1) vleft = cl_left_of_zero(b_row, b_len, uk, H.apv);
  } else {
    ClSlot sl = cl_slot_past();
    if (take) {
      const int q = ++H.seq_in;
      ClHostSlot& hs = in_wrap ? wrap[i] : H.ring[q % TA_CL_RING];
      if (hs.seq != q || hs.taken) return 3;
      hs.taken = true;
      sl = hs.v;
      if (!in_wrap && (q % TA_CL_BATCH == 0 || i == H.in_last))
        wp[g - 1].out_taken = q;
    }
    cin = sl.f;
    vleft = sl.v;
    H.e2a = H.e1a;
    H.e2b = H.e1b;
    H.e1a = sl.d1;
    H.e1b = sl.d2;
  }
  auto hand_on = [&](int32_t f, bool release) {
    const int q = ++H.seq_out;
    ClHostSlot& hs = out_wrap ? wrap[i] : wp[g + 1].ring[q % TA_CL_RING];
    if (hs.seq >= 0 && !hs.taken) return 3;
    hs.v = ClSlot{f, H.L[31].dp1[TA_CL_COLS - 1],
                  H.L[31].dp1[TA_CL_COLS - 2], H.vprev[31]};
    hs.seq = q;
    hs.taken = false;
    if (release || q % TA_CL_BATCH == 0) wp[out_wrap ? 0 : g + 1].pub = q;
    return 0;
  };
  if (i > H.first) {  // row i-1's words
    for (int l = 0; l < 32; ++l) {
      const int32_t kl = s * 32 + l;
      const uint32_t left = l == 0 ? vleft : H.vprev[l - 1];
      const int32_t wi = cl_word_index(kl, i - 1, uk);
      if (wi >= 0 && wi < P.wpr)
        code_out[(int64_t)(i - 2) * P.wpr + wi] =
            cl_word(left, H.vprev[l], i - 1, uk) & cl_word_mask(wi, P);
      if (l == 31 && cl_writes_next_word(s, i - 1, P) && wi + 1 >= 0 &&
          wi + 1 < P.wpr)
        code_out[(int64_t)(i - 2) * P.wpr + wi + 1] =
            cl_word(H.vprev[l], TA_CL_ONES, i - 1, uk) &
            cl_word_mask(wi + 1, P);
    }
  }
  if (i > H.last) {  // the strip's last step
    if (send && hand_on(TA_BAND_INF, true)) return 3;
    H.s += G;
    if (H.s < P.S) rehearse_cluster_strip(H, P, a_row, b_row, b_len, out, k);
    return 0;
  }
  ClLeft in[32];
  ClRow R[32];
  int32_t inc[32], tmp[32];
  for (int l = 0; l < 32; ++l) {
    in[l] = l == 0 ? ClLeft{H.e1a, H.e2a, H.e2b} : cl_lane_right(H.L[l - 1]);
    R[l] = cl_row(i, H.ach, P, (s * 32 + l) * TA_CL_COLS);
  }
  for (int l = 0; l < 32; ++l) {
    cl_lane_masks(H.L[l], R[l]);
    inc[l] = cl_key(cl_lane_pass1(H.L[l], k, R[l], in[l]), l, k.gc);
  }
  for (int off = 1; off < 32; off <<= 1) {
    for (int l = 0; l < 32; ++l) tmp[l] = l >= off ? inc[l - off] : inc[l];
    for (int l = 0; l < 32; ++l) inc[l] = ta_min32(inc[l], tmp[l]);
  }
  if (send && hand_on(cl_carry(cin, inc[31], 32, k.gc), false)) return 3;
  for (int l = 0; l < 32; ++l) {
    for (int32_t x = cl_extra_first(s, l, i, P), dx = cl_extra_step(i, P);;
         x += dx) {
      const int32_t wx = cl_extra_index(x, i, P);
      if (wx < 0) break;
      code_out[(int64_t)(i - 1) * P.wpr + wx] =
          cl_extra_word(wx, i, H.ach, b_row, P);
    }
  }
  for (int l = 0; l < 32; ++l) {
    const int32_t ex = l >= 1 ? inc[l - 1] : inc[l];
    H.vprev[l] =
        cl_lane_pass2(H.L[l], k, R[l], in[l], cl_carry(cin, ex, l, k.gc));
    const int32_t fcol = P.jf - (s * 32 + l) * TA_CL_COLS;
    if (i == P.m && fcol >= 0 && fcol < TA_CL_COLS)
      *out = cl_lane_pick(H.L[l], fcol);
  }
  H.apv = H.ach;
  H.ach = i < P.m ? a_row[i] : 0;
  H.i = i + 1;
  return 0;
}

template <bool TRANS>
static int rehearse_cluster(const uint8_t* a, const uint8_t* b,
                            const int32_t* m, const int32_t* n, int32_t* out,
                            uint32_t* codes, int64_t B, int64_t a_stride,
                            int64_t b_stride, int unit_k, int64_t code_rows,
                            BandCosts k, int ctas, int warps, int full,
                            int order) {
  const int G = ctas * warps;
  for (int64_t p = 0; p < B; ++p) {
    const int64_t m64 = m[p] < a_stride ? m[p] : a_stride;
    const int32_t mm = (int32_t)(m64 < code_rows ? m64 : code_rows);
    const ClPair P = cl_pair(mm, n[p], unit_k, full != 0);
    const uint8_t* a_row = a + p * a_stride;
    const uint8_t* b_row = b + p * b_stride;
    uint32_t* code_out = codes + p * code_rows * P.wpr;
    ClHostSlot garbage;
    std::memset(&garbage, 0xA5, sizeof(garbage));
    garbage.seq = -1;
    garbage.taken = false;
    std::vector<ClHostSlot> wrap((size_t)code_rows + 2, garbage);
    std::vector<ClWarpHost<TRANS>> wp(G);
    for (int g = 0; g < G; ++g) {
      ClWarpHost<TRANS>& H = wp[g];
      for (int q = 0; q < TA_CL_RING; ++q) H.ring[q] = garbage;
      H.pub = H.out_taken = H.seq_in = H.seq_out = 0;
      H.s = g;
      if (g < P.S)
        rehearse_cluster_strip(H, P, a_row, b_row, b_stride, out + p, k);
    }
    std::vector<int> pub0(G), taken0(G);
    for (;;) {
      bool busy = false, ran = false;
      for (int g = 0; g < G; ++g) {
        pub0[g] = wp[g].pub;
        taken0[g] = wp[g].out_taken;
        busy |= wp[g].s < P.S;
      }
      if (!busy) break;
      for (int g = 0; g < G; ++g) {
        for (int r = 0; wp[g].s < P.S && (order == 1 || r < 1); ++r) {
          const int rc = rehearse_cluster_step(wp, wrap, pub0, taken0, g, P,
                                               a_row, b_row, b_stride,
                                               code_out, out + p, k);
          if (rc == 1) break;
          if (rc) return rc;
          ran = true;
        }
      }
      if (!ran) return 2;  // every warp waits: a deadlock
    }
  }
  return 0;
}

// Same arguments as ta_band_trace_cluster, host pointers, no stream and no
// wrap buffer (the rehearsal keeps its own), and the warps' `order` (see
// rehearse_cluster); refuses what the launcher refuses.
extern "C" int ta_rehearse_band_cluster(const void* a, const void* b,
                                        const void* m, const void* n,
                                        void* out, void* codes, int64_t B,
                                        int64_t a_stride, int64_t b_stride,
                                        int unit_k, int64_t code_rows, int mc,
                                        int gc, int sgc, int tc,
                                        int transpose, int ctas, int warps,
                                        int full, int order) {
  if (codes == nullptr || !band_cluster_ok(unit_k, ctas, warps, full) ||
      a_stride < 1 || b_stride < a_stride || code_rows < 1)
    return 1;
  if (B <= 0) return 0;
  const BandCosts k{mc, gc, sgc, tc};
  auto run = transpose ? rehearse_cluster<true> : rehearse_cluster<false>;
  return run((const uint8_t*)a, (const uint8_t*)b, (const int32_t*)m,
             (const int32_t*)n, (int32_t*)out, (uint32_t*)codes, B, a_stride,
             b_stride, unit_k, code_rows, k, ctas, warps, full, order);
}

// The lanes of one group of trace_walk.cu, run in turn: a lane's copies
// are queued when it issues them and land only at that lane's waits
// (cp.async.wait_group 1: all but its last committed group; wait_all:
// all), so a tile the walker reads before its copies have landed holds
// what the buffer held before (other tiles, or the 0xA5 fill).  The host
// thread is the walker; the hand-over of its position is the identity.
struct HostWalkGroup {
  struct Copy {
    uint32_t* dst;
    const uint32_t* src;
  };
  int size, lane = 0;
  std::vector<std::vector<Copy>> open;
  std::vector<std::vector<std::vector<Copy>>> committed;
  explicit HostWalkGroup(int g) : size(g), open(g), committed(g) {}
  bool walker() const { return true; }
  int first() const { return lane; }
  int stride() const { return size; }
  void copy4(uint32_t* dst, const uint32_t* src) {
    open[lane].push_back({dst, src});
  }
  void commit() {
    committed[lane].push_back(open[lane]);
    open[lane].clear();
  }
  void land(int l, size_t keep) {
    auto& q = committed[l];
    while (q.size() > keep) {
      for (const Copy& c : q.front()) std::memcpy(c.dst, c.src, 4);
      q.erase(q.begin());
    }
  }
  void wait_one() { land(lane, 1); }
  void wait_all() {  // every lane's copies, committed or not
    for (int l = 0; l < size; ++l) {
      committed[l].push_back(open[l]);
      open[l].clear();
      land(l, 0);
    }
  }
  void sync() {}
  template <class F>
  void each_lane(F f) {
    for (lane = 0; lane < size; ++lane) f();
    lane = 0;
  }
  void bcast(int64_t&, int64_t&, int64_t&) {}
};

// Same arguments as ta_trace_walk, host pointers, no stream, no block
// shape: the pairs one after the other, each pair's group of `lanes` lanes
// in turn over two tile buffers that start as 0xA5 bytes and are not
// cleared between pairs.
extern "C" int ta_rehearse_trace_walk(const void* codes, const void* a,
                                      const void* b, const void* m,
                                      const void* n, void* runs,
                                      void* counts, int64_t B, int64_t rows,
                                      int64_t wpr, int64_t a_stride,
                                      int64_t b_stride, int unit_k,
                                      int64_t steps, int lanes,
                                      int tile_rows, int window) {
  if (B <= 0) return 0;
  WalkArgs g;
  if (!trace_walk_args(codes, a, b, m, n, runs, counts, B, rows, wpr,
                       a_stride, b_stride, unit_k, steps, lanes, tile_rows,
                       window, &g))
    return 1;
  std::vector<uint32_t> smem(2 * (size_t)g.buf_words, 0xA5A5A5A5u);
  HostWalkGroup grp(lanes);
  for (int64_t p = 0; p < B; ++p) walk_pair(g, p, smem.data(), grp);
  return 0;
}

// Same arguments as ta_trace_walk_gather, host pointers: the pairs one
// after the other, a warp's 32 lanes in turn.
extern "C" int ta_rehearse_trace_walk_gather(const void* buf,
                                             const void* counts,
                                             const void* ends, void* out,
                                             int64_t B, int64_t steps) {
  if (B <= 0) return 0;
  if (steps < 1) return 1;
  for (int64_t p = 0; p < B; ++p)
    for (int lane = 0; lane < 32; ++lane)
      runs_gather((const int32_t*)buf, (const int32_t*)counts,
                  (const int64_t*)ends, (int32_t*)out, p, steps, lane, 32);
  return 0;
}

// One block of myers_blocked.cu: its warps one after the other on each
// strip (the table built first, as between the block's two barriers), and
// inside a warp the 32 lanes running each step in turn.  What lane l
// returns at step s is what lane l + 1 takes at step s + 1 when both lie
// in one group of G lanes (the device's __shfl_up_sync of width G; group
// lane 0 makes its own input).
template <int W, bool DAM, bool SEARCH, bool LAST>
static void rehearse_blocked_warp(const BlkItem* it, const BlkStrip& sp,
                                  BlkLane<W, DAM>* L, const int64_t* row0,
                                  int32_t steps) {
  const int G = sp.G;
  BlkIo io[BLK_LANES];
  uint32_t up[BLK_LANES] = {}, out[BLK_LANES];
  for (int l = 0; l < BLK_LANES; ++l) {
    io[l].txt.start(it[l].text, it[l].text_len);
    if (!sp.first)
      io[l].bits.start(it[l].scratch, it[l].scratch ? sp.scratch_len : 0);
  }
  for (int32_t s0 = 0; s0 < steps; s0 += BLK_CHUNK) {
    for (int l = 0; l < BLK_LANES; ++l) {
      io[l].txt.advance();
      if (!sp.first) io[l].bits.advance();
    }
    for (int k = 0; k < BLK_CHUNK; ++k) {
      for (int l = 0; l < BLK_LANES; ++l)
        out[l] = blk_step<W, DAM, SEARCH, LAST>(it[l], sp, L[l], io[l],
                                                l & (G - 1), l, row0[l],
                                                s0 + k, k, k & 3, up[l]);
      for (int l = 0; l < BLK_LANES; ++l)
        up[l] = (l & (G - 1)) ? out[l - 1] : out[l];
    }
  }
}

template <int W, bool DAM, bool SEARCH>
static void rehearse_blocked_block(const BlkArgs& g, int64_t bx, int64_t y,
                                   int warps) {
  const int G = SEARCH ? g.lanes : BLK_LANES;
  const int T = (SEARCH ? warps : 1) * BLK_LANES;
  std::vector<BlkItem> it(T);
  std::vector<int64_t> xs(T), row0(T);
  for (int tid = 0; tid < T; ++tid) {
    xs[tid] = SEARCH ? bx * (T / G) + tid / G : bx;
    it[tid] = blk_item<SEARCH>(g, xs[tid], y);
  }
  if (!SEARCH && it[0].m == 0) {
    g.out[bx] = 0;
    return;
  }
  std::vector<int32_t> map(BLK_CODES);
  std::vector<uint32_t> tab((size_t)g.rows * W * BLK_LANES);
  for (int e = 0; e < BLK_CODES; ++e)
    map[e] = it[0].codes[e] * (W * BLK_ROW_WORD_BYTES);
  for (int tid = 0; tid < T; ++tid)
    if (SEARCH && xs[tid] == 0 && (tid & (G - 1)) == 0)
      it[tid].out_row[0] = it[tid].m;
  const BlkGeom geo = blk_geom(it[0].m, W, G);
  BlkStrip sp;
  sp.map = map.data();
  sp.tab = tab.data();
  sp.G = G;
  sp.row0 = g.anchored || !SEARCH ? BLK_PH : 0u;
  sp.lane_S = geo.lane_S;
  sp.i_S = geo.i_S;
  sp.offS = geo.offS;
  sp.phase = (geo.lane_S + 2) & 3;
  sp.scratch_len = g.scratch_stride;
  std::vector<BlkLane<W, DAM>> L(T);
  std::vector<int32_t> span(T / BLK_LANES, 0);
  for (int tid = 0; tid < T; ++tid) {
    L[tid].S = it[tid].m;
    L[tid].acc = 0;
    L[tid].sb[0] = L[tid].sb[1] = L[tid].sb[2] = L[tid].sb[3] = 0;
    const int32_t v = it[tid].d + it[tid].ncols;
    span[tid / BLK_LANES] = span[tid / BLK_LANES] > v ? span[tid / BLK_LANES]
                                                      : v;
  }
  for (int32_t strip = 0; strip < geo.ns; ++strip) {
    const bool last = strip == geo.ns - 1;
    sp.first = strip == 0;
    for (int e = 0; e < W * BLK_LANES; ++e)
      blk_build_slot<W>(tab.data(), g.rows, it[0], strip, G, e / BLK_LANES,
                        e % BLK_LANES);
    for (int tid = 0; tid < T; ++tid) {
      blk_reset(L[tid]);
      row0[tid] = ((int64_t)strip * G + (tid & (G - 1))) * W * 32;
      if (!SEARCH && it[tid].ncols == 0)
        L[tid].acc += blk_vsum(L[tid], it[tid].m, row0[tid]);
    }
    for (int w = 0; w < T / BLK_LANES; ++w) {
      const int32_t steps = blk_steps(span[w], sp, last);
      const int o = w * BLK_LANES;
      if (last)
        rehearse_blocked_warp<W, DAM, SEARCH, true>(&it[o], sp, &L[o],
                                                    &row0[o], steps);
      else
        rehearse_blocked_warp<W, DAM, SEARCH, false>(&it[o], sp, &L[o],
                                                     &row0[o], steps);
    }
  }
  if (SEARCH) {
    for (int tid = 0; tid < T; ++tid)
      if ((tid & (G - 1)) == geo.lane_S) blk_flush(it[tid], L[tid], geo.lane_S);
  } else {
    int32_t v = 0;
    for (int tid = 0; tid < T; ++tid) v += L[tid].acc;
    g.out[bx] = it[0].ncols + v;
  }
}

template <bool DAM, bool SEARCH>
static int rehearse_blocked(const BlkArgs& g, int wpt, int64_t nx,
                            int64_t ny, int warps) {
  for (int64_t y = 0; y < ny; ++y)
    for (int64_t x = 0; x < nx; ++x) switch (wpt) {
#define TA_BLK_REH(WW)                                         \
  case WW:                                                     \
    rehearse_blocked_block<WW, DAM, SEARCH>(g, x, y, warps);   \
    break;
        TA_BLK_REH(1)
        TA_BLK_REH(2)
        TA_BLK_REH(3)
        TA_BLK_REH(4)
        TA_BLK_REH(6)
        TA_BLK_REH(8)
        TA_BLK_REH(12)
        TA_BLK_REH(20)
#undef TA_BLK_REH
        default:
          return 1;
      }
  return 0;
}

// Same arguments as ta_blocked_distance, host pointers, no stream.
extern "C" int ta_rehearse_blocked_distance(
    const void* a, const void* b, const void* m, const void* n,
    const void* codes, int rows, int wpt, void* out, int64_t B,
    int64_t a_stride, int64_t b_stride, void* scratch,
    int64_t scratch_stride, int damerau) {
  if (!blk_plan_ok(rows, wpt, BLK_LANES, 1) || (b_stride & 15) ||
      (scratch_stride & 15))
    return 1;
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
  return damerau ? rehearse_blocked<true, false>(g, wpt, B, 1, 1)
                 : rehearse_blocked<false, false>(g, wpt, B, 1, 1);
}

// Same arguments as ta_blocked_search, host pointers, no stream.
extern "C" int ta_rehearse_blocked_search(
    const void* hay, int64_t iter_len, const void* needles, int num, int m,
    const void* codes, int rows, int wpt, int lanes, int warps,
    int64_t own_len, int64_t halo, int64_t nseg, int anchored, int damerau,
    void* out, int64_t out_stride, void* scratch, int64_t scratch_stride) {
  if (!blk_plan_ok(rows, wpt, lanes, warps) || m < 1 || own_len < 1 ||
      halo < 0 || own_len + halo > 2147483647LL - 16 || nseg < 1 ||
      out_stride < iter_len + 1 || (out_stride & 3) || (scratch_stride & 15))
    return 1;
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
  const int64_t per_block = (int64_t)warps * (BLK_LANES / lanes);
  const int64_t gx = (nseg + per_block - 1) / per_block;
  return damerau ? rehearse_blocked<true, true>(g, wpt, gx, num, warps)
                 : rehearse_blocked<false, true>(g, wpt, gx, num, warps);
}

// One block of search_diag.cu: its warps one after the other, and inside
// a warp the 32 lanes running each step in turn; what lane l returns at
// step s is what lane l + 1 takes at step s + 1 inside a group of G lanes.
template <int R, bool TRANS>
static void rehearse_sd_block(const SdArgs& g, int64_t bx, int warps) {
  const SdPlan p = sd_plan(g, R);
  const int T = warps * SD_LANES;
  for (int w = 0; w < warps; ++w) {
    SdSeg s[SD_LANES];
    std::vector<SdLane<R, TRANS>> L(SD_LANES);
    TaChunks txt[SD_LANES];
    SdMsg up[SD_LANES], out[SD_LANES];
    int32_t span = 0;
    for (int l = 0; l < SD_LANES; ++l) {
      const int tid = w * SD_LANES + l;
      s[l] = sd_seg(g, bx * (T / p.G) + tid / p.G);
      sd_reset(L[l], g, s[l], l & (p.G - 1));
      txt[l].start(s[l].text, s[l].text_len);
      up[l] = sd_inf_msg();
      span = span > s[l].ncols + s[l].e ? span : s[l].ncols + s[l].e;
    }
    const int32_t steps = sd_steps(span, p);
    for (int32_t s0 = 0; s0 < steps; s0 += SD_CHUNK) {
      if (s0 > 0)
        for (int l = 0; l < SD_LANES; ++l) txt[l].advance();
      for (int k = 0; k < SD_CHUNK; ++k) {
        for (int l = 0; l < SD_LANES; ++l) {
          out[l] = sd_step<R, TRANS>(g, s[l], p, L[l], txt[l].cur,
                                     l & (p.G - 1), s0 + k, k, k & 3, up[l]);
          if (!TRANS) {  // the device does not hand these over
            out[l].d2 = SD_INF;
            out[l].l2 = 0;
          }
        }
        for (int l = 0; l < SD_LANES; ++l)
          up[l] = (l & (p.G - 1)) ? out[l - 1] : out[l];
      }
    }
    for (int l = 0; l < SD_LANES; ++l)
      if ((l & (p.G - 1)) == p.lane_m) sd_flush(s[l], p, L[l]);
  }
}

template <bool TRANS>
static int rehearse_sd(const SdArgs& g, int rows, int warps) {
  const int64_t per_block = (int64_t)warps * (SD_LANES / g.lanes);
  const int64_t blocks = (g.nseg + per_block - 1) / per_block;
  for (int64_t b = 0; b < blocks; ++b) switch (rows) {
#define TA_SD_REH(RR)                                  \
  case RR:                                             \
    rehearse_sd_block<RR, TRANS>(g, b, warps);         \
    break;
      TA_SD_REH(1)
      TA_SD_REH(2)
      TA_SD_REH(3)
      TA_SD_REH(4)
      TA_SD_REH(6)
      TA_SD_REH(8)
      TA_SD_REH(12)
      TA_SD_REH(16)
#undef TA_SD_REH
      default:
        return 1;
    }
  return 0;
}

// Same arguments as ta_search_diag, host pointers, no stream.
extern "C" int ta_rehearse_search_diag(const void* hay, int64_t iter_len,
                                       const void* needle, int m,
                                       int64_t own_len, int64_t halo,
                                       int64_t nseg, int anchored, int mc,
                                       int gc, int sgc, int tc, int transpose,
                                       int rows, int lanes, int warps,
                                       void* out_d, void* out_l) {
  if (!sd_plan_ok(m, rows, lanes, warps, own_len, halo) ||
      m > SD_LANES * SD_MAX_ROWS || nseg < 1 || iter_len < 0)
    return 1;
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
  return transpose ? rehearse_sd<true>(g, rows, warps)
                   : rehearse_sd<false>(g, rows, warps);
}

// One item of search_flat.cu: the warps of the block run each row in
// wavefront order (warp w after warp w - 1), and inside a warp the lanes
// run pass 1 in turn, then pass 2 in turn.  What the device gets from
// __shfl_up_sync (the left values, the warp scan) comes from arrays, the
// hand-over ring between warps is the same ring as a plain array, and the
// scan is a sequential one (the combine is a minimum under a total order,
// so every order gives the same prefix).
template <bool SEARCH, bool TRANS, int C>
static void rehearse_flat_item(const SfArgs& g, int64_t x, int W) {
  const SfItem it = sf_item<SEARCH>(g, x);
  for (int t = 0; t < 32 * W; ++t)
    if (sf_item_start<SEARCH>(it, g, t, 32 * W)) return;
  std::vector<SfLane<SEARCH, TRANS, C>> lanes(32 * W);
  std::vector<SfEdge> e1(W), e2(W);
  std::vector<SfSlot> ring((size_t)W * SF_RING);
  SfLeft in[32];
  SfPre inc[32];
  SfStrip st;
  st.RJ = 32 * W * C;
  st.i_hi_prev = 0;
  int tick = 0;
  for (st.j0 = 0; st.j0 < it.ncols; st.j0 += st.RJ) {
    sf_window(it, st);
    // warps past the text sit out the item's last strip
    int nw = 0;
    while (nw < W && st.j0 + nw * 32 * C < it.ncols) ++nw;
    const bool to_next = st.j0 + st.RJ < it.ncols;
    for (int w = 0; w < nw; ++w) {
      const int32_t jl = st.j0 + w * 32 * C;
      for (int l = 0; l < 32; ++l)
        sf_lane_init(lanes[w * 32 + l], it, g, st, jl + 1 + l * C);
      e1[w] = w == 0 ? sf_old_edge<SEARCH>(it, g, st, st.i_lo - 1)
                     : sf_inner_edge(it, g, jl, st.i_lo - 1);
      e2[w] = w == 0 ? sf_old_edge<SEARCH>(it, g, st, st.i_lo - 2)
                     : sf_inner_edge(it, g, jl, st.i_lo - 2);
    }
    for (int32_t i = st.i_lo; i <= st.i_hi; ++i, ++tick) {
      const SfRow R = sf_row(it, i);
      for (int w = 0; w < nw; ++w) {
        SfLane<SEARCH, TRANS, C>* L = &lanes[w * 32];
        const bool last = w == nw - 1;
        SfEdge ei = {};
        SfPre cin;
        if (w == 0) {
          ei = sf_old_edge<SEARCH>(it, g, st, i);
          cin = ei.p;
        } else {  // warp w-1's slot of this row: the carry, the edge of i-1
          const SfSlot& in_slot = ring[(w - 1) * SF_RING + tick % SF_RING];
          cin = in_slot.carry;
          if (i > st.i_lo) {
            e2[w] = e1[w];
            e1[w] = sf_slot_edge(in_slot);
          }
        }
        in[0] = sf_left_of(e1[w], e2[w]);
        for (int l = 1; l < 32; ++l) in[l] = sf_lane_right(L[l - 1]);
        for (int l = 0; l < 32; ++l) {
          inc[l] = sf_pass1(L[l], g, R, in[l]);
          if (l > 0) inc[l] = sf_join<SEARCH>(inc[l - 1], inc[l]);
        }
        if (!last) {
          SfSlot& out_slot = ring[w * SF_RING + tick % SF_RING];
          out_slot.carry = sf_join<SEARCH>(cin, inc[31]);
          sf_slot_put_edge(out_slot, L[31]);
        }
        SfPre run = cin;
        for (int l = 0; l < 32; ++l) {
          run = sf_pass2(L[l], g,
                         l == 0 ? cin : sf_join<SEARCH>(cin, inc[l - 1]),
                         in[l].l1);
          if (i == it.m) sf_emit(L[l], it);
        }
        if (last && w == W - 1 && to_next)
          sf_write_edge(L[31], g, it, st, i, run);
        if (w == 0) {
          e2[0] = e1[0];
          e1[0] = ei;
        }
      }
    }
    st.i_hi_prev = st.i_hi;
  }
}

template <bool SEARCH, bool TRANS>
static int rehearse_flat(const SfArgs& g, int64_t items, int threads,
                         int cols) {
  if (threads < 32 || threads > 32 * SF_MAX_WARPS || (threads & 31))
    return 1;
  const int W = threads / 32;
  for (int64_t x = 0; x < items; ++x) switch (cols) {
      case 4: rehearse_flat_item<SEARCH, TRANS, 4>(g, x, W); break;
      case 8: rehearse_flat_item<SEARCH, TRANS, 8>(g, x, W); break;
      case 16:  // K9 only, as on the device
        if (SEARCH) return 1;
        rehearse_flat_item<false, TRANS, 16>(g, x, W);
        break;
      default: return 1;
    }
  return 0;
}

// Same arguments as ta_flat_search, host pointers, no stream.
extern "C" int ta_rehearse_flat_search(
    const void* hay, int64_t iter_len, const void* needle, int m,
    int64_t own_len, int64_t halo, const void* segs, int64_t items,
    int anchored, int mc, int gc, int sgc, int tc, int transpose, void* out_d,
    void* out_l, void* edges, int threads, int cols) {
  if (m < 1 || m > SF_MAX_LEN || own_len < 1 || halo < 0 ||
      own_len + halo > SF_MAX_LEN)
    return 1;
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
  return transpose ? rehearse_flat<true, true>(g, items, threads, cols)
                   : rehearse_flat<true, false>(g, items, threads, cols);
}

// Same arguments as ta_flat_distance, host pointers, no stream.
extern "C" int ta_rehearse_flat_distance(
    const void* a, const void* b, const void* m, const void* n, int64_t B,
    int64_t a_stride, int64_t b_stride, int unit_k, int mc, int gc, int sgc,
    int tc, int transpose, void* out, void* edges, int threads, int cols) {
  if (a_stride < 1 || b_stride < 1 || a_stride > SF_MAX_LEN ||
      b_stride > SF_MAX_LEN || unit_k < -1)
    return 1;
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
  return transpose ? rehearse_flat<false, true>(g, B, threads, cols)
                   : rehearse_flat<false, false>(g, B, threads, cols);
}
