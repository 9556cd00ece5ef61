// K1 myers_distance: banded unit-cost Levenshtein distance, one pair per
// thread, Myers bit-vector wavefront over an asymmetric k+1 band.
//
// Replaces the TPU kernel triple_accel_tpu/ops/pallas/lev_myers.py:_make_kernel
// (wrapper myers_distance_pallas).  It computes the same function: row i of
// the DP holds the horizontal deltas of columns j = i - ukL + p, p in
// [0, Wp), as a Wp-bit vector; out-of-band deltas shifted in at the top are
// +1; virtual columns j <= 0 force both deltas to +1 after clearing Eq;
// the score is anchored at the window's left edge and row m is read out
// with a masked popcount.  The result is exact wherever the true distance
// is <= the pair's threshold and never below the truth otherwise.
//
// What bounds it on an H100: integer operations, not bytes.  Every input
// byte is read once (a: m, b: m + Wp per pair).  Counted as the card would
// issue it (3-input logic, funnel shifts, add with carry), a row needs 12
// 32-bit operations per 32 band bits plus 3 for the anchor and 1 for Eq:
// 28 at the main path's 33-bit band.  At the card's peak rates (3.35 TB/s,
// 16.75 T int32 op/s) the operations of a 1000-row pair then take about
// 2.7 times as long as its 2 KB of strings.  The kernel issues several
// times that count (the ring upkeep and the rotate are not in it).  The design
// therefore spends little on the memory side (row-major strings, one
// 16-byte load per 16 rows and thread, no staging) and works on making
// the row cheap:
//   * 64-bit words, Wp = 64 * NW with NW in {1, 2, 3} (k <= 191): the
//     whole band of the main path (k = 32) is ONE register pair, carries
//     across words are a plain sequential loop;
//   * one pair per thread, so the serial chain needs no cross-lane
//     traffic and 32 pairs advance per warp instruction;
//   * the Eq word is not rebuilt by k+1 byte compares per row.  The window
//     of b slides one byte per row, so its match masks are kept
//     incrementally in a ring: two 16-entry tables per thread in shared
//     memory, indexed by the high and the low nibble of a character, hold
//     for every nibble value the Wp-bit mask of window positions carrying
//     it (bit x mod Wp for buffer index x).  A row clears one bit and sets
//     one bit in each table (the byte that leaves and the byte that
//     enters share a ring position) and Eq = rotate(hi[a>>4] & lo[a&15]).
//     256 * NW bytes of shared memory per thread instead of a 256-entry
//     table per thread.
// Rows past a pair's own length are never run (per-thread trip count), so
// padding costs nothing.

#include "ta_common.cuh"

namespace {

// Table layout: entry e in [0, 32) (0..15 high nibble, 16..31 low nibble),
// word w, thread t  ->  tab[(e * NW + w) * tstride + t]; tab already points
// at this thread's column.
template <int NW>
struct RingTables {
  uint64_t* tab;
  int tstride;
  TA_DEV uint64_t& at(int e, int w) { return tab[(e * NW + w) * tstride]; }
  TA_DEV void clear_all() {
    for (int e = 0; e < 32; ++e)
      for (int w = 0; w < NW; ++w) at(e, w) = 0ull;
  }
  TA_DEV void set(uint32_t c, int w, uint64_t bit) {
    at(c >> 4, w) |= bit;
    at(16 + (c & 15), w) |= bit;
  }
  TA_DEV void clear(uint32_t c, int w, uint64_t bit) {
    at(c >> 4, w) &= ~bit;
    at(16 + (c & 15), w) &= ~bit;
  }
  TA_DEV uint64_t match(uint32_t c, int w) {
    return at(c >> 4, w) & at(16 + (c & 15), w);
  }
};

// One pair.  a: m chars (row stride multiple of 16, 0 pads up to a multiple
// of 16); b: the pair's b chars placed at byte offset ukl in a zero-filled
// row of at least roundup16(m) + 64 * NW bytes.
template <int NW>
TA_DEV int32_t distance_pair(const uint8_t* a, const uint8_t* b, int m,
                             int dlen, int ukl, RingTables<NW> ring) {
  constexpr int WP = 64 * NW;
  uint64_t Ph[NW], Mh[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    Ph[w] = ~0ull;
    Mh[w] = 0ull;
  }
  int32_t A = -ukl - 1;  // A_0 = D[0, -ukL-1] on the virtual row 0

  if (m > 0) {
    // initial window: buffer indices [0, WP)
    ring.clear_all();
    for (int q = 0; q < WP / 16; ++q) {
      const uint4 v = ta_load16(b + 16 * q);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int x = 16 * q + r;
        ring.set(ta_byte_of(v, r), x >> 6, 1ull << (x & 63));
      }
    }
    int pos = 0;  // ring position of the window's first byte, r0 mod WP
    const int nblk = (m + 15) / 16;
    for (int q = 0; q < nblk; ++q) {
      const uint4 av = ta_load16(a + 16 * q);
      const uint4 bout = ta_load16(b + 16 * q);
      const uint4 bin = ta_load16(b + 16 * q + WP);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int r0 = 16 * q + r;  // 0-based row, i = r0 + 1
        if (r0 < m) {
          const int i = r0 + 1;
          const uint32_t ac = ta_byte_of(av, r);
          const int pw = pos >> 6, pb = pos & 63;

          // Eq: window bit p  <->  ring bit (pos + p) mod WP
          uint64_t Eq[NW];
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            int i0 = pw + w;
            if (i0 >= NW) i0 -= NW;
            int i1 = i0 + 1;
            if (i1 >= NW) i1 -= NW;
            const uint64_t lo = ring.match(ac, i0) >> pb;
            const uint64_t hi =
                pb ? (ring.match(ac, i1) << (64 - pb)) : 0ull;
            Eq[w] = lo | hi;
          }

          // anchor: A_i = D[i, i-ukL-1] = D[i-1, (i-1)-ukL] + 1
          A += (int32_t)(Ph[0] & 1ull) - (int32_t)(Mh[0] & 1ull) + 1;

          uint64_t PhI[NW], MhI[NW], vmask[NW];
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const uint64_t pin = (w + 1 < NW) ? (Ph[w + 1] << 63) : (1ull << 63);
            const uint64_t min_ = (w + 1 < NW) ? (Mh[w + 1] << 63) : 0ull;
            PhI[w] = (Ph[w] >> 1) | pin;
            MhI[w] = (Mh[w] >> 1) | min_;
            // virtual columns j <= 0  <->  bits p <= ukL - i
            vmask[w] = ta_low_mask(ukl + 1 - i - 64 * w);
            Eq[w] &= ~vmask[w];
          }

          uint64_t Pv[NW], Mv[NW], Xh[NW];
          uint64_t carry = 0ull;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const uint64_t x = Eq[w] & PhI[w];
            const uint64_t s1 = x + PhI[w];
            const uint64_t c1 = s1 < x ? 1ull : 0ull;
            const uint64_t s2 = s1 + carry;
            const uint64_t c2 = s2 < s1 ? 1ull : 0ull;
            carry = c1 | c2;
            const uint64_t X = (s2 ^ PhI[w]) | Eq[w];
            Xh[w] = Eq[w] | MhI[w];
            Pv[w] = (MhI[w] | ~(X | PhI[w])) | vmask[w];
            Mv[w] = (PhI[w] & X) & ~vmask[w];
          }
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const uint64_t PvS = (Pv[w] << 1) | (w ? (Pv[w - 1] >> 63) : 1ull);
            const uint64_t MvS = (Mv[w] << 1) | (w ? (Mv[w - 1] >> 63) : 0ull);
            Ph[w] = (MvS | ~(Xh[w] | PvS)) | vmask[w];
            Mh[w] = (PvS & Xh[w]) & ~vmask[w];
          }

          // slide the window: buffer index r0 leaves, r0 + WP enters; both
          // live at ring position pos
          const uint64_t bit = 1ull << pb;
          ring.clear(ta_byte_of(bout, r), pw, bit);
          ring.set(ta_byte_of(bin, r), pw, bit);
          pos = (pos + 1 == WP) ? 0 : pos + 1;
        }
      }
    }
  }

  // D[m, n] = A_m + sum of dh[m] over bits p in [0, dlen + ukL]
  int32_t res = A;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint64_t sel = ta_low_mask(dlen + ukl + 1 - 64 * w);
    res += ta_popcll(Ph[w] & sel) - ta_popcll(Mh[w] & sel);
  }
  return res;
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

template <int NW>
__global__ void myers_distance_kernel(const uint8_t* __restrict__ a,
                                      const uint8_t* __restrict__ b,
                                      const int32_t* __restrict__ m,
                                      const int32_t* __restrict__ dlen,
                                      const int32_t* __restrict__ ukl,
                                      int32_t* __restrict__ out, int64_t B,
                                      int64_t a_stride, int64_t b_stride) {
  extern __shared__ uint64_t ta_ring_smem[];
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  RingTables<NW> ring{ta_ring_smem + threadIdx.x, (int)blockDim.x};
  out[p] = distance_pair<NW>(a + p * a_stride, b + p * b_stride, m[p],
                             dlen[p], ukl[p], ring);
}

template <int NW>
static int launch_distance(const uint8_t* a, const uint8_t* b,
                           const int32_t* m, const int32_t* dlen,
                           const int32_t* ukl, int32_t* out, int64_t B,
                           int64_t a_stride, int64_t b_stride,
                           cudaStream_t stream) {
  // 32 KB of ring tables per block at every NW (256 * NW bytes a thread)
  const int threads = NW == 1 ? 128 : (NW == 2 ? 64 : 32);
  const size_t smem = (size_t)32 * NW * threads * sizeof(uint64_t);
  const int64_t blocks = (B + threads - 1) / threads;
  myers_distance_kernel<NW><<<(unsigned)blocks, threads, smem, stream>>>(
      a, b, m, dlen, ukl, out, B, a_stride, b_stride);
  return (int)cudaGetLastError();
}

// Plain C entry point.  All pointers are device pointers; nothing is
// allocated or synchronised here.  Returns the cudaError_t of the launch.
extern "C" int ta_myers_distance(const void* a, const void* b, const void* m,
                                 const void* dlen, const void* ukl, void* out,
                                 int64_t B, int64_t a_stride, int64_t b_stride,
                                 int nw, void* stream) {
  if (B <= 0) return 0;
  const uint8_t* ap = (const uint8_t*)a;
  const uint8_t* bp = (const uint8_t*)b;
  const int32_t* mp = (const int32_t*)m;
  const int32_t* dp = (const int32_t*)dlen;
  const int32_t* up = (const int32_t*)ukl;
  int32_t* op = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nw) {
    case 1:
      return launch_distance<1>(ap, bp, mp, dp, up, op, B, a_stride, b_stride, st);
    case 2:
      return launch_distance<2>(ap, bp, mp, dp, up, op, B, a_stride, b_stride, st);
    case 3:
      return launch_distance<3>(ap, bp, mp, dp, up, op, B, a_stride, b_stride, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ta_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // TA_HOST_REHEARSAL
