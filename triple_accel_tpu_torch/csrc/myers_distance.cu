// K1 myers_distance: banded unit-cost Levenshtein distance, one pair per
// thread, Myers bit-vector wavefront over an asymmetric window of Wp
// diagonals.
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
// 28 at the main path's window of 64 bits.  At the card's peak rates
// (3.35 TB/s, 16.75 T int32 op/s) the operations of a 1000-row pair take
// about 2.7 times as long as its 2 KB of strings.  So the design spends
// little on the memory side (row-major strings, one 16-byte load of a, of
// the leaving and of the entering bytes of b per 16 rows and thread,
// requested a chunk ahead, no staging) and works on making the row cheap:
//   * one pair per thread: the serial chain of rows needs no cross-lane
//     traffic and 32 pairs advance per warp instruction;
//   * 32-bit words, NW = Wp / 32 in {2, 4, 6} (Wp = 64, 128, 192: the
//     window the plan gives k <= 63, 127, 191; the main path's k = 32 is
//     two words), the adder one PTX add.cc / addc.cc chain
//     (ta_add_chain), the one-bit shifts across words funnel shifts;
//   * the Eq word is not rebuilt by Wp byte compares per row.  The window
//     of b slides one byte per row, so its match masks are kept
//     incrementally in a ring in shared memory: 32 entries per thread (16
//     for the high nibble of a character, 16 for the low one), each the
//     Wp-bit mask of the window positions whose byte has that nibble,
//     position x at bit x % 32 of ring word (x / 32) % NW.  A row clears
//     the leaving byte's bit and sets the entering byte's bit (they share a
//     ring position), and Eq = funnel(hi[a >> 4] & lo[a & 15]) at the
//     window's offset: NW loads per entry, one 32-bit word a lane, so a
//     warp access is one shared-memory wavefront;
//   * the ring's word order needs no select: rows run in groups of 32,
//     during which the window starts in the same ring word `base`, and a
//     thread reads the NW words base .. base + NW - 1 at fixed offsets from
//     a group pointer.  Physical slots NW .. 2 NW - 2 are twins of slots 0
//     .. NW - 2, refreshed once a group (when a ring word is complete), so
//     that base + j never wraps.  A row's top word takes the bits below the
//     window offset from slot `base` itself (the entering bytes);
//   * rows run 16 at a time (one 16-byte load of each string), whole
//     chunks without a guard: the virtual-column masks (rows i <= ukL) and
//     the row guard (the last chunk) live in the chunks that need them
//     only, so the body has neither.
// Rows past a pair's own length are never run (per-thread trip count), so
// padding costs nothing.

#include "ta_common.cuh"

namespace {

constexpr int MD_ENTRIES = 32;  // 16 high-nibble + 16 low-nibble masks

// Physical ring slots of NW words: NW primaries and NW - 1 twins.
template <int NW>
constexpr int md_slots = 2 * NW - 1;

// A thread's ring: entry e (0..15 high nibble, 16..31 low nibble), slot s
// of thread t at word (e * SLOTS + s) * TS + t of the table; TS is the
// threads sharing the table (the block on the card, 16 in the host
// rehearsal, whose one thread uses column 0), so a warp's access to one
// (entry, slot) of 32 threads is 128 consecutive bytes.  Addresses are
// byte offsets from the table's start, and a character arrives as its two
// nibbles pre-scaled, hi16 = c & 0xF0 and lo = c & 15, so an entry's
// offset is one multiply-add from the slot's.
template <int NW, int TS>
struct MdRing {
  static constexpr int SLOTS = md_slots<NW>;
  static constexpr uint32_t E = 4u * SLOTS * TS;  // bytes between entries
  static_assert(E % 16 == 0, "hi16 * (E / 16) must be exact");
  TA_DEV static uint32_t hi(uint32_t hi16, uint32_t slot) {
    return slot + hi16 * (E / 16);
  }
  TA_DEV static uint32_t lo(uint32_t lo, uint32_t slot) {
    return slot + (16 + lo) * E;
  }
};

// The table's word at byte offset off.
static TA_DEV uint32_t& md_at(uint32_t* tab, uint32_t off) {
  return *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(tab) + off);
}

// Byte r of a word, in bits 0-7 (one byte-permute on the card).
static TA_DEV uint32_t md_byte(uint32_t w, int r) {
#ifdef TA_HOST_REHEARSAL
  return (w >> (8 * r)) & 0xFFu;
#else
  return __byte_perm(w, 0u, 0x4440u | (uint32_t)r);
#endif
}

// A 16-byte chunk split into high nibbles (c & 0xF0) and low nibbles.
struct MdNibbles {
  uint32_t hi[4], lo[4];
  TA_DEV explicit MdNibbles(const uint4& v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = w[i] & 0xF0F0F0F0u;
      lo[i] = w[i] & 0x0F0F0F0Fu;
    }
  }
  TA_DEV uint32_t hi16(int r) const { return md_byte(hi[r >> 2], r & 3); }
  TA_DEV uint32_t lo4(int r) const { return md_byte(lo[r >> 2], r & 3); }
};

// 32-bit mask of the low n bits, n clipped to [0, 32].
static TA_DEV uint32_t md_low32(int n) {
  return n <= 0 ? 0u : n >= 32 ? ~0u : (1u << n) - 1u;
}

// State of one pair between rows, held shifted for the next row: PhI =
// Ph >> 1 with the out-of-band +1 at the top, MhI = Mh >> 1.
template <int NW>
struct MdState {
  uint32_t PhI[NW], MhI[NW];
  // anchor D[i, i-ukL-1] - i + (Ph[0] - Mh[0] of row i): the next row's
  // step, less its +1 (the +1 of every row is added up front)
  int32_t A;
};

// Row r0 (0-based; i = r0 + 1) of one pair.  `slot`: the byte offset of
// this group's slot `base` in tab; pb = r0 % 32, the window's offset in
// it, and bit = 1 << pb; (ah, al), (lh, ll),
// (eh, el): the nibbles of a[r0], of the leaving b[r0] and of the entering
// b[r0 + Wp].  CAREFUL rows apply the virtual-column masks (bits p <=
// ukL - i) and run the plain version's steps; the others fold the shifts:
// with PvS = Pv << 1 | 1 and MvS = Mv << 1, the next row's PhI = (MvS |
// ~(Xh | PvS)) >> 1 | top = Mv | ~((Xh >> 1) | Pv) | top and MhI = Pv &
// (Xh >> 1), and the new Ph[0] - Mh[0] is -Xh[0]: one shift of Xh a word.
template <int NW, int TS, bool CAREFUL>
static TA_DEV void md_row(MdState<NW>& S, uint32_t* tab, uint32_t slot,
                          int pb, uint32_t bit, uint32_t ah, uint32_t al,
                          uint32_t lh, uint32_t ll, uint32_t eh, uint32_t el,
                          int ukl_i) {
  using Ring = MdRing<NW, TS>;
  // Eq: window bit p <-> ring position r0 + p
  const uint32_t h = Ring::hi(ah, slot);
  const uint32_t l = Ring::lo(al, slot);
  uint32_t W[NW], Eq[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j)
    W[j] = md_at(tab, h + 4 * j * TS) & md_at(tab, l + 4 * j * TS);
#pragma unroll
  for (int j = 0; j < NW; ++j)
    Eq[j] = ta_fshr(W[j], W[j + 1 < NW ? j + 1 : 0], pb);

  uint32_t vm[NW];
  if (CAREFUL) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      // virtual columns j <= 0  <->  bits p <= ukL - i: clear Eq first
      vm[j] = md_low32(ukl_i + 1 - 32 * j);
      Eq[j] &= ~vm[j];
    }
  }
  uint32_t x[NW], sum[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) x[j] = Eq[j] & S.PhI[j];
  ta_add_chain<NW>(sum, x, S.PhI, 0u);
  uint32_t Pv[NW], Mv[NW], Xh[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t X = (sum[j] ^ S.PhI[j]) | Eq[j];
    Xh[j] = Eq[j] | S.MhI[j];
    Pv[j] = S.MhI[j] | ~(X | S.PhI[j]);
    Mv[j] = S.PhI[j] & X;
  }
  if (CAREFUL) {
    uint32_t Ph[NW], Mh[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      Pv[j] |= vm[j];
      Mv[j] &= ~vm[j];
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint32_t PvS = ta_fshl1(j ? Pv[j - 1] : 0x80000000u, Pv[j]);
      const uint32_t MvS = ta_fshl1(j ? Mv[j - 1] : 0u, Mv[j]);
      Ph[j] = (MvS | ~(Xh[j] | PvS)) | vm[j];
      Mh[j] = (PvS & Xh[j]) & ~vm[j];
    }
    S.A += (int32_t)(Ph[0] & 1u) - (int32_t)(Mh[0] & 1u);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      S.PhI[j] = ta_fshr(Ph[j], j + 1 < NW ? Ph[j + 1] : 1u, 1);
      S.MhI[j] = ta_fshr(Mh[j], j + 1 < NW ? Mh[j + 1] : 0u, 1);
    }
  } else {
    S.A -= (int32_t)(Xh[0] & 1u);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint32_t XhR = ta_fshr(Xh[j], j + 1 < NW ? Xh[j + 1] : 0u, 1);
      S.PhI[j] = Mv[j] | ~(XhR | Pv[j]);
      S.MhI[j] = Pv[j] & XhR;
    }
    S.PhI[NW - 1] |= 0x80000000u;
  }

  // slide the window: b[r0] leaves, b[r0 + Wp] enters, both at bit pb of
  // slot base.  The four entries are read before any is written, so the
  // loads need not wait for each other's stores; where the leaving and the
  // entering byte share an entry, the set (stored last, from the same
  // value) wins over the clear, as it must.
  uint32_t& lhw = md_at(tab, Ring::hi(lh, slot));
  uint32_t& llw = md_at(tab, Ring::lo(ll, slot));
  uint32_t& ehw = md_at(tab, Ring::hi(eh, slot));
  uint32_t& elw = md_at(tab, Ring::lo(el, slot));
  const uint32_t vlh = lhw, vll = llw, veh = ehw, vel = elw;
  lhw = vlh & ~bit;
  llw = vll & ~bit;
  ehw = veh | bit;
  elw = vel | bit;
}

// A chunk's 16 bytes of a, of the leaving and of the entering b.
struct MdChunk {
  uint4 a, bout, bin;
};

template <int NW>
static TA_DEV MdChunk md_load(const uint8_t* a, const uint8_t* b, int q) {
  return MdChunk{ta_load16(a + 16 * q), ta_load16(b + 16 * q),
                 ta_load16(b + 16 * q + 32 * NW)};
}

// The 16 rows of chunk q (rows 16q .. 16q + 15), its bytes in c.  CAREFUL
// chunks hold a row i <= ukL or the pair's last row: they mask and guard
// each row.
template <int NW, int TS, bool CAREFUL>
static TA_DEV void md_chunk(MdState<NW>& S, uint32_t* tab, uint32_t slot,
                            const MdChunk& c, int q, int m, int ukl) {
  const MdNibbles av(c.a);
  const MdNibbles bout(c.bout);
  const MdNibbles bin(c.bin);
  const int pb0 = (q & 1) << 4;
  const uint32_t bit0 = 1u << pb0;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int r0 = 16 * q + r;
    if (!CAREFUL || r0 < m)
      md_row<NW, TS, CAREFUL>(S, tab, slot, pb0 + r, bit0 << r, av.hi16(r),
                              av.lo4(r), bout.hi16(r), bout.lo4(r),
                              bin.hi16(r), bin.lo4(r), ukl - r0 - 1);
  }
}

// One pair.  a: m chars (row stride a multiple of 16, 0 pads up to a
// multiple of 16); b: the pair's b chars placed at byte offset ukl in a
// zero-filled row of at least roundup16(m) + 32 * NW bytes.  tab: the
// table of TS threads; t: this thread's column.
template <int NW, int TS>
TA_DEV int32_t distance_pair(const uint8_t* a, const uint8_t* b, int m,
                             int dlen, int ukl, uint32_t* tab, int t) {
  constexpr int WP = 32 * NW;
  using Ring = MdRing<NW, TS>;
  MdState<NW> S;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    S.PhI[j] = ~0u;  // row 0: Ph all +1, Mh none
    S.MhI[j] = 0u;
  }
  // A_0 = D[0, -ukL-1], the +1 of each row, and row 0's Ph[0] = 1
  S.A = -ukl - 1 + m + 1;

  if (m > 0) {
    // the first window, buffer indices [0, WP): ring word w in slot w (the
    // twins are written when their primaries are complete)
    for (int e = 0; e < MD_ENTRIES; ++e)
#pragma unroll
      for (int s = 0; s < NW; ++s) tab[(e * Ring::SLOTS + s) * TS + t] = 0u;
    for (int q = 0; q < WP / 16; ++q) {
      const MdNibbles v(ta_load16(b + 16 * q));
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int x = 16 * q + r;
        const uint32_t slot = 4u * ((x >> 5) * TS + t);
        md_at(tab, Ring::hi(v.hi16(r), slot)) |= 1u << (x & 31);
        md_at(tab, Ring::lo(v.lo4(r), slot)) |= 1u << (x & 31);
      }
    }
    int base = 0;  // ring word of the window's first byte, (r0 / 32) % NW
    const int nq = (m + 15) >> 4;
    // the next chunk's bytes are requested while this one runs (the last
    // chunk requests itself again: nothing past the pair's rows is read)
    MdChunk next = md_load<NW>(a, b, 0);
    for (int q = 0; q < nq; ++q) {
      const MdChunk cur = next;
      next = md_load<NW>(a, b, q + 1 < nq ? q + 1 : q);
      if (q && !(q & 1)) {
        // a group of 32 rows ended: slot base now holds ring word g + NW
        // complete; its twin serves the groups that read past slot NW - 1
        if (base < NW - 1)
          for (int e = 0; e < MD_ENTRIES; ++e)
            tab[(e * Ring::SLOTS + base + NW) * TS + t] =
                tab[(e * Ring::SLOTS + base) * TS + t];
        base = base + 1 == NW ? 0 : base + 1;
      }
      const uint32_t slot = 4u * (base * TS + t);
      if (16 * q < ukl || 16 * q + 16 > m)
        md_chunk<NW, TS, true>(S, tab, slot, cur, q, m, ukl);
      else
        md_chunk<NW, TS, false>(S, tab, slot, cur, q, m, ukl);
    }
  }

  // D[m, n] = A_m + sum of dh[m] over bits p in [0, dlen + ukL]: bit 0 is
  // in A already, bits 1.. are bits 0.. of the shifted state
  int32_t res = S.A;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t sel = md_low32(dlen + ukl - 32 * j);
    res += ta_popc32(S.PhI[j] & sel) - ta_popc32(S.MhI[j] & sel);
  }
  return res;
}

// Threads a block at NW words: as many resident warps an SM as the ring's
// shared memory allows (NW = 2: 24 KB a block, 9 blocks, 18 warps an SM).
template <int NW>
constexpr int md_threads = NW == 2 ? 64 : 32;

template <int NW>
constexpr size_t md_smem_bytes =
    (size_t)MD_ENTRIES * md_slots<NW> * md_threads<NW> * sizeof(uint32_t);

}  // namespace

#ifndef TA_HOST_REHEARSAL

template <int NW>
__global__ void __launch_bounds__(md_threads<NW>)
    myers_distance_kernel(const uint8_t* __restrict__ a,
                          const uint8_t* __restrict__ b,
                          const int32_t* __restrict__ m,
                          const int32_t* __restrict__ dlen,
                          const int32_t* __restrict__ ukl,
                          int32_t* __restrict__ out, int64_t B,
                          int64_t a_stride, int64_t b_stride) {
  constexpr int TS = md_threads<NW>;
  extern __shared__ __align__(16) uint32_t md_ring_smem[];
  const int64_t p = (int64_t)blockIdx.x * TS + threadIdx.x;
  if (p >= B) return;
  out[p] = distance_pair<NW, TS>(a + p * a_stride, b + p * b_stride, m[p],
                                 dlen[p], ukl[p], md_ring_smem,
                                 (int)threadIdx.x);
}

template <int NW>
static int launch_distance(const uint8_t* a, const uint8_t* b,
                           const int32_t* m, const int32_t* dlen,
                           const int32_t* ukl, int32_t* out, int64_t B,
                           int64_t a_stride, int64_t b_stride,
                           cudaStream_t stream) {
  constexpr int threads = md_threads<NW>;
  const int64_t blocks = (B + threads - 1) / threads;
  myers_distance_kernel<NW><<<(unsigned)blocks, threads, md_smem_bytes<NW>,
                              stream>>>(a, b, m, dlen, ukl, out, B, a_stride,
                                        b_stride);
  return (int)cudaGetLastError();
}

// Plain C entry point.  All pointers are device pointers; nothing is
// allocated or synchronised here.  nw: the plan's 64-bit word count (1, 2
// or 3; the window is 64 * nw bits, run as 2 * nw words of 32 bits).
// Returns the cudaError_t of the launch.
extern "C" int ta_myers_distance(const void* a, const void* b, const void* m,
                                 const void* dlen, const void* ukl, void* out,
                                 int64_t B, int64_t a_stride, int64_t b_stride,
                                 int nw, void* stream) {
  if (B <= 0) return 0;
  if ((a_stride & 15) || (b_stride & 15) || ((uintptr_t)a & 15) ||
      ((uintptr_t)b & 15))
    return (int)cudaErrorInvalidValue;
  const uint8_t* ap = (const uint8_t*)a;
  const uint8_t* bp = (const uint8_t*)b;
  const int32_t* mp = (const int32_t*)m;
  const int32_t* dp = (const int32_t*)dlen;
  const int32_t* up = (const int32_t*)ukl;
  int32_t* op = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nw) {
    case 1:
      return launch_distance<2>(ap, bp, mp, dp, up, op, B, a_stride, b_stride, st);
    case 2:
      return launch_distance<4>(ap, bp, mp, dp, up, op, B, a_stride, b_stride, st);
    case 3:
      return launch_distance<6>(ap, bp, mp, dp, up, op, B, a_stride, b_stride, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ta_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // TA_HOST_REHEARSAL
