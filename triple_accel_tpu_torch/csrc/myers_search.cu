// K2 myers_search: column-oriented Myers bit-vector approximate search,
// D[m][j] for every end position j of every needle, unit costs or the
// restricted-Damerau preset, anchored or not.
//
// Replaces the TPU kernel
// triple_accel_tpu/ops/pallas/search_myers.py:_make_kernel (wrapper
// myers_search_pallas).  Same function, another shape: the kernel reads the
// RAW haystack.  Segment c owns the end positions (c*own_len, (c+1)*own_len]
// (segment 0 also owns 0), starts `halo` bytes before its first owned
// column with a fresh unanchored state (or at byte 0, whichever is later:
// segment 0 sees no synthetic pad bytes), and writes only owned columns,
// in plain global order out[needle][j], j in [0, iter_len].  A cost-<=k
// match ending in an owned column spans at most `halo` bytes, so every
// value <= k is exact and no value is below the truth.
//
// What bounds it on an H100: bytes, for needles of up to 32 chars (the
// main path's 24).  A column moves 1 haystack byte in and 4 bytes out
// (0.20 ms for 128 MiB at 3.35 TB/s).  Counted as the card would issue it
// at its narrowest (32-bit words, 3-input logic): 10 logic/shift/add
// operations and one table lookup per word, 4 for the score per column,
// i.e. 15 per column at one word (0.12 ms at 16.75 T int32 op/s), 19 with
// the transposition seeds; from the second 32-bit word on, operations
// bind.  This kernel works in 64-bit words, so it issues about twice
// that.  What it actually loses time to is neither: the chain of one
// segment is strictly serial, so the only parallelism is the number of
// segments in flight, and every thread writes its own distant stretch of
// the output, so the store path sees scattered small writes.  The design:
//   * one thread per segment, blockIdx.y over needles; the wrapper picks
//     own_len so that a large haystack yields tens of thousands of
//     segments while halo / own_len stays small;
//   * the classic Peq[256][NW] match table of the block's needle in shared
//     memory (2 KB at one word, 40 KB at 20 words = 1280 chars), built
//     once per block, read with one lookup per column and word;
//   * haystack bytes fetched 16 at a time per thread (aligned uint4), so a
//     thread touches each 32-byte sector twice instead of 32 times;
//   * owned scores leave four columns at a time in one aligned 16-byte
//     store (rows are padded to a multiple of 4 ints): per-column 4-byte
//     stores from threads that sit own_len * 4 bytes apart made the store
//     path, not the chain, the limit;
//   * 64-bit words; state arrays are sized by the template parameter, so
//     the one- and two-word kernels keep everything in registers.

#include "ta_common.cuh"

namespace {

struct SearchArgs {
  const uint8_t* hay;   // raw haystack, 16-byte aligned
  int64_t iter_len;     // columns searched (bytes of hay that are read)
  int32_t m;            // needle length
  int32_t nw;           // words: ceil(m / 64)
  int64_t own_len;      // owned columns per segment
  int64_t halo;         // warm-up bytes before the first owned column
  int32_t anchored;     // D[0][j] = j instead of 0
  int32_t damerau;      // restricted-Damerau transposition seeds
  int64_t out_stride;   // ints per output row, a multiple of 4
};

// One (needle, segment).  peq: 256 * nw words, entry (ch, w) at peq[ch*nw+w].
template <int MAXW>
TA_DEV void search_segment(const SearchArgs& g, const uint64_t* peq,
                           int64_t c, int32_t* out_row) {
  const int nw = MAXW <= 2 ? MAXW : g.nw;
  const int wS = (g.m - 1) >> 6, offS = (g.m - 1) & 63;
  const int64_t own0 = c * g.own_len;  // owns (own0, own_end]
  int64_t own_end = own0 + g.own_len;
  if (own_end > g.iter_len) own_end = g.iter_len;
  if (c == 0) out_row[0] = g.m;  // D[m][0] = m, both modes
  if (own0 >= own_end) return;
  int64_t j0 = own0 - g.halo;  // 0-based byte index of the first column read
  if (j0 < 0) j0 = 0;

  uint64_t Pv[MAXW], Mv[MAXW], EqP[MAXW], D0P[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    Pv[w] = ~0ull;
    Mv[w] = 0ull;
    EqP[w] = 0ull;
    D0P[w] = 0ull;
  }
  int32_t S = g.m;
  int32_t sbuf[4] = {0, 0, 0, 0};  // scores of the current group of 4 columns
  const uint64_t ph_in = g.anchored ? 1ull : 0ull;

  while (j0 < own_end) {
    const int64_t base = j0 & ~(int64_t)15;
    uint4 v;
    if (base + 16 <= g.iter_len) {
#ifdef TA_HOST_REHEARSAL
      __builtin_memcpy(&v, g.hay + base, 16);
#else
      v = *reinterpret_cast<const uint4*>(g.hay + base);
#endif
    } else {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
      for (int r = 0; r < 16 && base + r < g.iter_len; ++r)
        wd[r >> 2] |= (uint32_t)g.hay[base + r] << (8 * (r & 3));
      v.x = wd[0];
      v.y = wd[1];
      v.z = wd[2];
      v.w = wd[3];
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int64_t jb = base + r;  // byte index; column j = jb + 1
      if (jb >= j0 && jb < own_end) {
        const uint64_t* eqp = peq + (int64_t)ta_byte_of(v, r) * nw;
        uint64_t carry = 0ull;  // adder carry into word w
        uint64_t eq_c = 0ull;   // bit 63 of Eq, word w-1
        uint64_t nd_c = 0ull;   // bit 63 of ~D0P, word w-1
        uint64_t ph_c = ph_in;  // bit 63 of Ph, word w-1 (bit-0 fill at w=0)
        uint64_t mh_c = 0ull;   // bit 63 of Mh, word w-1
#pragma unroll
        for (int w = 0; w < MAXW; ++w) {
          if (w < nw) {
            const uint64_t Eq = eqp[w];
            uint64_t seeds = Eq;
            if (g.damerau) {
              // a transposition at (i, t) seeds a zero diagonal when
              // p[i] = txt[t-1], p[i-1] = txt[t] and the previous column's
              // diagonal delta at row i-1 was +1
              const uint64_t nd = ~D0P[w];
              seeds |= EqP[w] & ((Eq << 1) | eq_c) & ((nd << 1) | nd_c);
              eq_c = Eq >> 63;
              nd_c = nd >> 63;
            }
            const uint64_t pv = Pv[w], mv = Mv[w];
            const uint64_t x = seeds & pv;
            const uint64_t s1 = x + pv;
            const uint64_t c1 = s1 < x ? 1ull : 0ull;
            const uint64_t s2 = s1 + carry;
            const uint64_t c2 = s2 < s1 ? 1ull : 0ull;
            carry = c1 | c2;
            const uint64_t Xh = (s2 ^ pv) | seeds;
            const uint64_t Ph = mv | ~(Xh | pv);
            const uint64_t Mh = pv & Xh;
            if (w == wS)
              S += (int32_t)((Ph >> offS) & 1ull) - (int32_t)((Mh >> offS) & 1ull);
            const uint64_t PhS = (Ph << 1) | ph_c;
            const uint64_t MhS = (Mh << 1) | mh_c;
            ph_c = Ph >> 63;
            mh_c = Mh >> 63;
            // mv still holds the previous column's VN here
            const uint64_t D0 = g.damerau ? (Xh | mv) : (Eq | mv);
            Pv[w] = MhS | ~(D0 | PhS);
            Mv[w] = PhS & D0;
            if (g.damerau) {
              EqP[w] = Eq;
              D0P[w] = D0;
            }
          }
        }
        if (jb >= own0) {
          // owned column j = jb + 1: four columns leave in one 16-byte
          // store when this segment owns all four (the row stride is a
          // multiple of 4 ints, so column 4q is 16-byte aligned)
          const int64_t j = jb + 1;
          sbuf[j & 3] = S;
          if ((j & 3) == 3) {
            if (j - 3 > own0) {
              ta_store4(out_row + (j - 3), sbuf);
            } else {
              for (int64_t jj = own0 + 1; jj <= j; ++jj)
                out_row[jj] = sbuf[jj & 3];
            }
          }
        }
      }
    }
    j0 = base + 16;
  }
  // the last, partial group of four
  int64_t jj = own_end & ~(int64_t)3;
  if (jj <= own0) jj = own0 + 1;
  if ((own_end & 3) != 3)
    for (; jj <= own_end; ++jj) out_row[jj] = sbuf[jj & 3];
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

template <int MAXW>
__global__ void myers_search_kernel(SearchArgs g,
                                    const uint8_t* __restrict__ needles,
                                    int64_t nseg, int32_t* __restrict__ out) {
  extern __shared__ uint64_t ta_peq_smem[];
  const int nw = g.nw;
  const uint8_t* needle = needles + (int64_t)blockIdx.y * g.m;
  // Peq of this block's needle: thread t builds the rows of chars t, t+T, ..
  for (int ch = threadIdx.x; ch < 256; ch += blockDim.x) {
    for (int w = 0; w < nw; ++w) {
      uint64_t bits = 0ull;
      const int lim = min(64, g.m - 64 * w);
      for (int t = 0; t < lim; ++t)
        bits |= (uint64_t)(needle[64 * w + t] == ch) << t;
      ta_peq_smem[ch * nw + w] = bits;
    }
  }
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nseg) return;
  search_segment<MAXW>(g, ta_peq_smem, c,
                       out + (int64_t)blockIdx.y * g.out_stride);
}

template <int MAXW>
static int launch_search(const SearchArgs& g, const uint8_t* needles, int num,
                         int64_t nseg, int32_t* out, cudaStream_t stream) {
  const int threads = 128;
  const size_t smem = (size_t)256 * g.nw * sizeof(uint64_t);
  dim3 grid((unsigned)((nseg + threads - 1) / threads), (unsigned)num);
  myers_search_kernel<MAXW><<<grid, threads, smem, stream>>>(g, needles, nseg,
                                                            out);
  return (int)cudaGetLastError();
}

// Plain C entry point.  All pointers are device pointers; nothing is
// allocated or synchronised here.  out is int32 [num, out_stride] with
// out_stride >= iter_len + 1 a multiple of 4 and a 16-byte aligned base;
// columns past iter_len are not written.
// Returns the cudaError_t of the launch.
extern "C" int ta_myers_search(const void* hay, int64_t iter_len,
                               const void* needles, int num, int m,
                               int64_t own_len, int64_t halo, int64_t nseg,
                               int anchored, int damerau, void* out,
                               int64_t out_stride, void* stream) {
  if (num <= 0) return 0;
  if (m < 1 || m > 1280 || own_len < 1 || halo < 0 || nseg < 1 ||
      num > 65535 || out_stride < iter_len + 1 || (out_stride & 3))
    return (int)cudaErrorInvalidValue;
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
  int32_t* op = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (g.nw == 1) return launch_search<1>(g, nd, num, nseg, op, st);
  if (g.nw == 2) return launch_search<2>(g, nd, num, nseg, op, st);
  return launch_search<20>(g, nd, num, nseg, op, st);
}

#endif  // TA_HOST_REHEARSAL
