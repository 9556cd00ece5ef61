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

// four ints to a 16-byte aligned address in one store
static TA_DEV void ta_store4(int32_t* p, const int32_t* v) {
#ifdef TA_HOST_REHEARSAL
  __builtin_memcpy(p, v, 16);
#else
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
#endif
}

// low `nbits` bits set, nbits clipped to [0, 64]
static TA_DEV uint64_t ta_low_mask(int nbits) {
  if (nbits <= 0) return 0ull;
  if (nbits >= 64) return ~0ull;
  return (1ull << nbits) - 1ull;
}

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
