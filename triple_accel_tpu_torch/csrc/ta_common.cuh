// Shared helpers of the hand-written CUDA kernels.
//
// The per-pair / per-segment bodies are plain functions, so a host-only
// build (-DTA_HOST_REHEARSAL, any C++17 compiler) can run exactly the code
// the device runs, one "thread" at a time; that build exists only to
// rehearse the arithmetic where no CUDA compiler is at hand.
// host_rehearsal.cpp is that build's C interface, and
// tests/test_torch_host_rehearsal.py holds it against the plain versions.
#pragma once

#include <stdint.h>

#ifdef TA_HOST_REHEARSAL
#define TA_DEV inline
struct uint4 {
  uint32_t x, y, z, w;
};
static inline int ta_popcll(uint64_t x) { return __builtin_popcountll(x); }
#else
#include <cuda_runtime.h>
#define TA_DEV __device__ __forceinline__
static __device__ __forceinline__ int ta_popcll(uint64_t x) {
  return __popcll(x);
}
#endif

// byte r (0..15) of a 16-byte chunk loaded as four little-endian words
static TA_DEV uint32_t ta_byte_of(const uint4& v, int r) {
  const uint32_t w = (r & 8) ? ((r & 4) ? v.w : v.z) : ((r & 4) ? v.y : v.x);
  return (w >> (8 * (r & 3))) & 0xFFu;
}

// 16 bytes from a 16-byte aligned address
static TA_DEV uint4 ta_load16(const uint8_t* p) {
#ifdef TA_HOST_REHEARSAL
  uint4 v;
  __builtin_memcpy(&v, p, 16);
  return v;
#else
  return *reinterpret_cast<const uint4*>(p);
#endif
}

// 16 bytes from a 16-byte aligned address, cached in L2 only (a stream
// that is read once: no L1 line is allocated for it)
static TA_DEV uint4 ta_load16_cg(const uint8_t* p) {
#ifdef TA_HOST_REHEARSAL
  return ta_load16(p);
#else
  return __ldcg(reinterpret_cast<const uint4*>(p));
#endif
}

// four ints given one by one to a 16-byte aligned address in one
// streaming store (written once, evicted first)
static TA_DEV void ta_store4_cs(int32_t* p, int32_t a, int32_t b, int32_t c,
                                int32_t d) {
#ifdef TA_HOST_REHEARSAL
  const int32_t v[4] = {a, b, c, d};
  __builtin_memcpy(p, v, 16);
#else
  __stcs(reinterpret_cast<int4*>(p), make_int4(a, b, c, d));
#endif
}

// four ints to a 16-byte aligned address in one store
static TA_DEV void ta_store4(int32_t* p, const int32_t* v) {
#ifdef TA_HOST_REHEARSAL
  __builtin_memcpy(p, v, 16);
#else
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
#endif
}

// four ints given one by one to a 16-byte aligned address in one store
static TA_DEV void ta_store4v(int32_t* p, int32_t a, int32_t b, int32_t c,
                              int32_t d) {
  const int32_t v[4] = {a, b, c, d};
  ta_store4(p, v);
}

// low `nbits` bits set, nbits clipped to [0, 64]
static TA_DEV uint64_t ta_low_mask(int nbits) {
  if (nbits <= 0) return 0ull;
  if (nbits >= 64) return ~0ull;
  return (1ull << nbits) - 1ull;
}

// 32-bit words of multi-word bit vectors (the Myers kernels).
//   ta_fshl1(lo, hi): (hi << 1) | (lo >> 31), one funnel shift: a word
//     shifted left by one with the top bit of the word below it;
//   ta_fshr(lo, hi, s): the low word of (hi:lo) >> s, s in [0, 31], one
//     funnel shift: a word shifted right with the low bits of the word
//     above it;
//   ta_add_chain<N>(s, x, y, cw): s = x + y + carry over N words, low word
//     first, the carry-in being bit 31 of cw; returns the carry out (0 or
//     1).  On the card a PTX add.cc / addc.cc chain: one instruction a
//     word, the carry in the condition code (CC.CF), as multi-precision
//     libraries chain it: a CC-writing instruction is one of these asm
//     statements only, and volatile keeps them in order.
#ifdef TA_HOST_REHEARSAL
static inline uint32_t ta_fshl1(uint32_t lo, uint32_t hi) {
  return (hi << 1) | (lo >> 31);
}
static inline uint32_t ta_fshr(uint32_t lo, uint32_t hi, int s) {
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
static inline int ta_popc32(uint32_t x) { return __builtin_popcount(x); }
template <int N>
static inline uint32_t ta_add_chain(uint32_t* s, const uint32_t* x,
                                    const uint32_t* y, uint32_t cw) {
  uint64_t c = cw >> 31;
  for (int i = 0; i < N; ++i) {
    const uint64_t v = (uint64_t)x[i] + y[i] + c;
    s[i] = (uint32_t)v;
    c = v >> 32;
  }
  return (uint32_t)c;
}
#else
static __device__ __forceinline__ uint32_t ta_fshl1(uint32_t lo,
                                                    uint32_t hi) {
  return __funnelshift_l(lo, hi, 1);
}
static __device__ __forceinline__ uint32_t ta_fshr(uint32_t lo, uint32_t hi,
                                                   int s) {
  return __funnelshift_r(lo, hi, s);
}
static __device__ __forceinline__ int ta_popc32(uint32_t x) {
  return __popc(x);
}
template <int N>
static __device__ __forceinline__ uint32_t ta_add_chain(uint32_t* s,
                                                        const uint32_t* x,
                                                        const uint32_t* y,
                                                        uint32_t cw) {
  uint32_t dummy, cout;
  // CC.CF = bit 31 of cw: cw + 2^31 overflows exactly when it is set
  asm volatile("add.cc.u32 %0, %1, 0x80000000;" : "=r"(dummy) : "r"(cw));
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("addc.cc.u32 %0, %1, %2;"
                 : "=r"(s[i])
                 : "r"(x[i]), "r"(y[i]));
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(cout));
  return cout;
}
#endif

// 16-byte chunks of a buffer [0, len), advanced one chunk a call, the next
// chunk already requested; bytes at or past `len` read as 0.
struct TaChunks {
  const uint8_t* base;
  int64_t len;
  int64_t c;  // chunk held in `cur`
  uint4 cur, nxt;

  TA_DEV uint4 load(int64_t q) const {
    if (q * 16 + 16 <= len) return ta_load16(base + q * 16);
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
    for (int r = 0; r < 16 && q * 16 + r < len; ++r)
      wd[r >> 2] |= (uint32_t)base[q * 16 + r] << (8 * (r & 3));
    uint4 v;
    v.x = wd[0];
    v.y = wd[1];
    v.z = wd[2];
    v.w = wd[3];
    return v;
  }
  TA_DEV void start(const uint8_t* b, int64_t l) {
    base = b;
    len = l;
    c = -1;
    cur.x = cur.y = cur.z = cur.w = 0u;
    nxt = load(0);
  }
  TA_DEV void advance() {
    cur = nxt;
    ++c;
    nxt = load(c + 1);
  }
};

// Bytes [0, len) of a 16-byte aligned buffer read in order, one a call,
// 16 at a time with the next 16 already requested.
struct TaStream {
  const uint8_t* base;
  int64_t len;
  int64_t q;  // chunk held in `cur`
  uint4 cur, nxt;

  TA_DEV void start(const uint8_t* b, int64_t l) {
    base = b;
    len = l;
    q = -2;
  }
  TA_DEV uint4 load(int64_t c) const {
    if (c * 16 + 16 <= len) return ta_load16(base + c * 16);
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
    for (int r = 0; r < 16 && c * 16 + r < len; ++r)
      wd[r >> 2] |= (uint32_t)base[c * 16 + r] << (8 * (r & 3));
    uint4 v;
    v.x = wd[0];
    v.y = wd[1];
    v.z = wd[2];
    v.w = wd[3];
    return v;
  }
  TA_DEV uint32_t at(int64_t idx) {
    const int64_t c = idx >> 4;
    if (c != q) {
      cur = (c == q + 1) ? nxt : load(c);
      q = c;
      nxt = load(c + 1);
    }
    return ta_byte_of(cur, (int)(idx & 15));
  }
};
