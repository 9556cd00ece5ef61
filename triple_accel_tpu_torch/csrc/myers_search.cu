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
// (32-bit words, 3-input logic, add with carry, funnel shifts): 10
// logic/shift/add operations and one table lookup per word, 4 for the
// score per column, i.e. 15 per column at one word (0.12 ms at 16.75 T
// int32 op/s), 19 with the transposition seeds; from the second word on,
// operations bind.  A segment's chain of columns is strictly serial, so
// the only parallelism is the number of segments in flight, and every
// segment writes its own distant stretch of the output.  The design:
//   * one lane per segment, a warp 32 consecutive segments, a block 1 to 8
//     warps of one needle (blockIdx.y over needles); the plan's halo is the
//     window span rounded up to 32 and own_len a multiple of 32, so every
//     segment starts on a sector while halo / own_len stays a few
//     percent;
//   * 32-bit words, NW in {1, 2, 3, 4, 6, 8, 12, 16, 24, 40} (a template
//     constant: one word up to 32 chars), the adder one PTX add.cc /
//     addc.cc chain, shifts across words funnel shifts, the state in
//     registers; rows above m - 1 (words past the needle) never reach
//     lower rows and are left unmasked;
//   * the match table Peq[word][257] of the block's needle in shared
//     memory, built once per block (row 256 is all zero);
//   * the warp's lanes step in lockstep over 16-column chunks: step s of a
//     lane reads byte B + s of its segment, B its first byte rounded down
//     to 32, so every lane's chunk edges fall on the same steps.  Steps
//     before a lane's first byte (fewer than 32, the first two chunks
//     only) look up the zero row, under which the fresh state is a fixed
//     point: no other step has a guard.  A lane loads its bytes a whole
//     32-byte sector at a time (two 16-byte loads) and has requested the
//     next sector before it starts on the current one (a register double
//     buffer): one DRAM sector a request, and 16 to 32 columns of work
//     between a load and its use.  The loads are cached in L2 only
//     (`ld.global.cg`) and the scores leave as streaming stores (below):
//     with tens of thousands of streams in flight the pair ran a launch
//     of 32 warps an SM 16% faster and left the plan's 16 as they were
//     (PERF.md);
//   * stores leave in whole 64-byte runs: a lane's 16 scores of one
//     aligned group of 16 columns go to its row of a per-warp staging
//     area in shared memory (four 16-byte stores, XOR-swizzled so neither
//     side conflicts), and after the chunk the warp writes the 32 runs as
//     coalesced 16-byte stores, 8 segments' runs per instruction.  Columns
//     a segment does not own (its head, the short last segment, lanes past
//     the last segment) are masked at that store, by plain stores where a
//     16-byte piece is only partly owned.  The scores are written once and
//     never read here: streaming stores (`st.global.cs`).  The output's
//     512 MiB at the main path leave from 64 Ki segments at once, scattered
//     by own_len; they, not the columns, take most of the time (PERF.md).
// The per-lane chunk, the table build and the store phase are plain
// functions, so the host rehearsal (host_rehearsal.cpp,
// -DTA_HOST_REHEARSAL) runs exactly this arithmetic, the lanes of a warp
// in turn with the staging area an array.

#include "ta_common.cuh"

namespace {

constexpr int MS_LANES = 32;
constexpr int MS_CHUNK = 16;       // bytes a chunk, steps a chunk
constexpr int MS_SECTOR = 32;      // bytes a load: two chunks
constexpr int MS_ROW = 257;        // a table word's entries: 256 bytes + zero
constexpr uint32_t MS_ZERO = 256;  // the all-zero entry
constexpr int MS_MAX_WARPS = 8;
// a lane's staging row: 16 scores = 4 pieces of 16 bytes
constexpr int MS_STAGE_PIECES = MS_LANES * 4;

struct SearchArgs {
  const uint8_t* hay;  // raw haystack, 16-byte aligned
  int64_t iter_len;    // columns searched (bytes of hay that are read)
  int32_t m;           // needle length
  int64_t own_len;     // owned columns per segment
  int64_t halo;        // warm-up bytes before the first owned column
  int64_t nseg;        // segments per needle
  int32_t anchored;    // D[0][j] = j instead of 0
  int64_t out_stride;  // ints per output row, a multiple of 4
};

// Where segment c lies.  Step s of its lane reads byte B + s (column
// B + s + 1); the segment's first byte is B + d, B a multiple of 32.
struct MsSeg {
  int64_t B;
  int32_t d;
  int32_t chunks;         // chunks up to the store of its last owned column
  int64_t own0, own_end;  // owned columns (own0, own_end]; empty past nseg
};

static TA_DEV MsSeg ms_seg(const SearchArgs& g, int64_t c) {
  MsSeg sg;
  sg.own0 = sg.own_end = 0;
  if (c < g.nseg) {
    sg.own0 = c * g.own_len;
    sg.own_end = sg.own0 + g.own_len;
    if (sg.own_end > g.iter_len) sg.own_end = g.iter_len;
  }
  int64_t b0 = sg.own0 - g.halo;
  if (b0 < 0) b0 = 0;
  sg.B = b0 & ~(int64_t)(MS_SECTOR - 1);
  sg.d = (int32_t)(b0 - sg.B);
  // column j is stored after chunk (j >> 4) - (B >> 4)
  sg.chunks = sg.own_end > sg.own0
                  ? (int32_t)((sg.own_end >> 4) - (sg.B >> 4)) + 1
                  : 0;
  return sg;
}

// A segment's bytes from B on, a 32-byte sector (two 16-byte loads,
// cached in L2 only) at a time, the next sector requested before the
// current one is used; bytes at or past the end read as 0.
struct MsText {
  TaChunks src;  // its base and length, and load() for the ragged end
  int64_t sec;   // the sector held in cur
  uint4 cur[2], nxt[2];
  TA_DEV uint4 load(int64_t q) const {
    return q * 16 + 16 <= src.len ? ta_load16_cg(src.base + q * 16)
                                  : src.load(q);
  }
  TA_DEV void start(const uint8_t* b, int64_t len) {
    src.base = b;
    src.len = len;
    sec = -1;
    nxt[0] = load(0);
    nxt[1] = load(1);
  }
  TA_DEV void advance() {
    cur[0] = nxt[0];
    cur[1] = nxt[1];
    ++sec;
    nxt[0] = load(2 * sec + 2);
    nxt[1] = load(2 * sec + 3);
  }
};

template <int NW, bool DAM>
struct MsLane {
  uint32_t Pv[NW], Mv[NW];
  uint32_t EqP[DAM ? NW : 1], D0P[DAM ? NW : 1];
  int32_t S;      // D[m][column]
  int32_t sb[4];  // the scores of column slots 4q .. 4q + 3, slot & 3
  int32_t d;      // steps before the segment's first byte
  MsText txt;     // the segment's bytes from B on, one sector ahead
};

template <int NW, bool DAM>
static TA_DEV void ms_lane_start(MsLane<NW, DAM>& L, const SearchArgs& g,
                                 const MsSeg& sg) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    L.Pv[w] = ~0u;
    L.Mv[w] = 0u;
    if (DAM) {
      L.EqP[w] = 0u;
      L.D0P[w] = 0u;
    }
  }
  L.S = g.m;
  L.sb[0] = L.sb[1] = L.sb[2] = L.sb[3] = 0;
  L.d = sg.d;
  // lanes without an owned column read nothing
  L.txt.start(g.hay + sg.B, sg.chunks ? g.iter_len - sg.B : 0);
}

// One column.  eq: the column's table entry, word w at eq[w * MS_ROW];
// ph_in: 1 when row 0 takes Ph = 1 (anchored), else 0; the score is read
// at bit offS of word wS.
template <int NW, bool DAM>
static TA_DEV void ms_step(MsLane<NW, DAM>& L, const uint32_t* eq,
                           uint32_t ph_in, int wS, int offS) {
  uint32_t Eq[NW], seeds[NW], x[NW], sum[NW];
  uint32_t eq_lo = 0u, nd_lo = 0u;  // bit 31: the word below's top bit
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    Eq[w] = eq[w * MS_ROW];
    seeds[w] = Eq[w];
    if (DAM) {
      // a transposition at (i, t) seeds a zero diagonal when
      // p[i] = txt[t-1], p[i-1] = txt[t] and the previous column's
      // diagonal delta at row i-1 was +1
      const uint32_t nd = ~L.D0P[w];
      seeds[w] |= L.EqP[w] & ta_fshl1(eq_lo, Eq[w]) & ta_fshl1(nd_lo, nd);
      eq_lo = Eq[w];
      nd_lo = nd;
    }
    x[w] = seeds[w] & L.Pv[w];
  }
  ta_add_chain<NW>(sum, x, L.Pv, 0u);
  uint32_t ph_lo = 0u, mh_lo = 0u, phs = 0u, mhs = 0u;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint32_t pv = L.Pv[w], mv = L.Mv[w];
    const uint32_t Xh = (sum[w] ^ pv) | seeds[w];
    const uint32_t Ph = mv | ~(Xh | pv);
    const uint32_t Mh = pv & Xh;
    if (w == wS) {
      phs = Ph;
      mhs = Mh;
    }
    const uint32_t PhS = w ? ta_fshl1(ph_lo, Ph) : (Ph << 1) | ph_in;
    const uint32_t MhS = ta_fshl1(mh_lo, Mh);
    ph_lo = Ph;
    mh_lo = Mh;
    // mv still holds the previous column's VN here
    const uint32_t D0 = DAM ? (Xh | mv) : (Eq[w] | mv);
    L.Pv[w] = MhS | ~(D0 | PhS);
    L.Mv[w] = PhS & D0;
    if (DAM) {
      L.EqP[w] = Eq[w];
      L.D0P[w] = D0;
    }
  }
  L.S += (int32_t)((phs >> offS) & 1u) - (int32_t)((mhs >> offS) & 1u);
}

// Four steps of a chunk whose bytes are v, bytes 4 * q .. 4 * q + 3 of
// it (q a constant where the chunk is unrolled).  After the third step
// the four column slots 4q .. 4q + 3 are complete (slot 4q came from the
// step before) and go to the lane's staging row as one 16-byte store.
// GUARD: the first two chunks, whose steps r < dk (before the segment's
// first byte) see the zero entry.
template <int NW, bool DAM, bool GUARD>
static TA_DEV void ms_quad(MsLane<NW, DAM>& L, const uint32_t* peq,
                           const uint4& v, int dk, uint4* stage_row, int swz,
                           int q, uint32_t ph_in, int wS, int offS) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int r = 4 * q + rr;
    uint32_t c = ta_byte_of(v, r);
    if (GUARD && r < dk) c = MS_ZERO;
    ms_step<NW, DAM>(L, peq + c, ph_in, wS, offS);
    L.sb[(rr + 1) & 3] = L.S;  // column slot r + 1
    if (rr == 2) {
      uint4 v;
      v.x = (uint32_t)L.sb[0];
      v.y = (uint32_t)L.sb[1];
      v.z = (uint32_t)L.sb[2];
      v.w = (uint32_t)L.sb[3];
      stage_row[q ^ swz] = v;
    }
  }
}

// Chunk k of one lane: its 16 steps, on half k & 1 of the current
// sector (an even chunk moves to the next sector and requests the one
// after it).
template <int NW, bool DAM, bool GUARD>
static TA_DEV void ms_chunk(MsLane<NW, DAM>& L, const uint32_t* peq,
                            int32_t k, uint4* stage_row, int swz,
                            uint32_t ph_in, int wS, int offS) {
  if (!(k & 1)) L.txt.advance();
  const uint4 v = (k & 1) ? L.txt.cur[1] : L.txt.cur[0];
  const int dk = L.d - MS_CHUNK * k;
  if (NW <= 4) {  // a step's byte a constant shift
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ms_quad<NW, DAM, GUARD>(L, peq, v, dk, stage_row, swz, q, ph_in, wS,
                              offS);
  } else {  // long bodies: four steps unrolled
#pragma unroll 1
    for (int q = 0; q < 4; ++q)
      ms_quad<NW, DAM, GUARD>(L, peq, v, dk, stage_row, swz, q, ph_in, wS,
                              offS);
  }
}

// The store phase of one lane after chunk k of its warp: round p writes
// piece lane & 3 of segment 8p + lane / 4 of the warp (columns relative to
// ptr[p]: 16k .. 16k + 3; owned: (lo[p], hi[p]]).
struct MsStore {
  int32_t* ptr[4];
  int32_t lo[4], hi[4];
};

static TA_DEV MsStore ms_store_plan(const SearchArgs& g, int32_t* out_row,
                                    int64_t c_warp, int lane) {
  MsStore st;
  const int i = lane & 3;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const MsSeg sg = ms_seg(g, c_warp + 8 * p + (lane >> 2));
    st.ptr[p] = out_row + sg.B + 4 * i;
    st.lo[p] = (int32_t)(sg.own0 - sg.B - 4 * i);
    st.hi[p] = (int32_t)(sg.own_end - sg.B - 4 * i);
  }
  return st;
}

// The staging row of lane l: 4 pieces, piece q at uint4 index
// 4l + (q ^ ((l >> 1) & 3)): a quarter-warp's stores (8 lanes, one piece)
// and loads (2 segments, 4 pieces each) fall into 8 distinct bank groups.
static TA_DEV int ms_swz(int lane) { return (lane >> 1) & 3; }

static TA_DEV void ms_store(const MsStore& st, const uint4* stage, int lane,
                            int32_t k) {
  const int i = lane & 3;
  const int32_t c0 = MS_CHUNK * k;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int s = 8 * p + (lane >> 2);
    const uint4 v = stage[4 * s + (i ^ ms_swz(s))];
    if (c0 > st.lo[p] && c0 + 3 <= st.hi[p]) {
      ta_store4_cs(st.ptr[p] + c0, (int32_t)v.x, (int32_t)v.y, (int32_t)v.z,
                   (int32_t)v.w);
    } else if (c0 + 3 > st.lo[p] && c0 <= st.hi[p]) {  // partly owned
      const int32_t e[4] = {(int32_t)v.x, (int32_t)v.y, (int32_t)v.z,
                            (int32_t)v.w};
      for (int t = 0; t < 4; ++t)
        if (c0 + t > st.lo[p] && c0 + t <= st.hi[p]) st.ptr[p][c0 + t] = e[t];
    }
  }
}

// The score's word at NW words: NW <= 2 are chosen for needles of exactly
// NW words, so the last; larger NW hold shorter needles too.
template <int NW>
static TA_DEV int ms_score_word(int m) {
  return NW <= 2 ? NW - 1 : (m - 1) >> 5;
}

}  // namespace

#ifndef TA_HOST_REHEARSAL

template <int NW, bool DAM>
__global__ void __launch_bounds__(MS_LANES * MS_MAX_WARPS)
    myers_search_kernel(SearchArgs g, const uint8_t* __restrict__ needles,
                        int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t ms_smem[];
  uint32_t* peq = ms_smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint4* stage = reinterpret_cast<uint4*>(ms_smem + ((NW * MS_ROW + 3) & ~3)) +
                 warp * MS_STAGE_PIECES;
  const uint8_t* needle = needles + (int64_t)blockIdx.y * g.m;
  int32_t* out_row = out + (int64_t)blockIdx.y * g.out_stride;

  // Peq of this block's needle
  for (int e = tid; e < NW * MS_ROW; e += blockDim.x) peq[e] = 0u;
  __syncthreads();
  for (int t = tid; t < g.m; t += blockDim.x)
    atomicOr(&peq[(t >> 5) * MS_ROW + needle[t]], 1u << (t & 31));
  __syncthreads();

  const int64_t c_warp = (int64_t)blockIdx.x * blockDim.x + warp * MS_LANES;
  const MsSeg sg = ms_seg(g, c_warp + lane);
  if (c_warp + lane == 0) out_row[0] = g.m;  // D[m][0] = m, both modes
  const int32_t chunks =
      (int32_t)__reduce_max_sync(0xffffffffu, (unsigned)sg.chunks);
  if (chunks == 0) return;
  MsLane<NW, DAM> L;
  ms_lane_start(L, g, sg);
  const MsStore st = ms_store_plan(g, out_row, c_warp, lane);
  const uint32_t ph_in = g.anchored ? 1u : 0u;
  const int wS = ms_score_word<NW>(g.m), offS = (g.m - 1) & 31;
  uint4* stage_row = stage + 4 * lane;
  const int swz = ms_swz(lane);
  // a lane's steps before its first byte (d < 32) lie in chunks 0 and 1
  const int32_t guarded = __any_sync(0xffffffffu, sg.d > 0) ? 2 : 0;
  for (int32_t k = 0; k < chunks; ++k) {
    if (k < guarded)
      ms_chunk<NW, DAM, true>(L, peq, k, stage_row, swz, ph_in, wS, offS);
    else
      ms_chunk<NW, DAM, false>(L, peq, k, stage_row, swz, ph_in, wS, offS);
    __syncwarp();
    ms_store(st, stage, lane, k);
    __syncwarp();
  }
}

static inline size_t ms_smem_bytes(int nw, int warps) {
  return (size_t)((nw * MS_ROW + 3) & ~3) * sizeof(uint32_t) +
         (size_t)warps * MS_STAGE_PIECES * 16;
}

template <int NW, bool DAM>
static int launch_search(const SearchArgs& g, const uint8_t* needles, int num,
                         int warps, int32_t* out, cudaStream_t stream) {
  const size_t smem = ms_smem_bytes(NW, warps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        myers_search_kernel<NW, DAM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t per_block = (int64_t)warps * MS_LANES;
  dim3 grid((unsigned)((g.nseg + per_block - 1) / per_block), (unsigned)num);
  myers_search_kernel<NW, DAM>
      <<<grid, warps * MS_LANES, smem, stream>>>(g, needles, out);
  return (int)cudaGetLastError();
}

template <bool DAM>
static int launch_words(int nw, const SearchArgs& g, const uint8_t* needles,
                        int num, int warps, int32_t* out, cudaStream_t st) {
  switch (nw) {
#define TA_MS_CASE(NN) \
  case NN:             \
    return launch_search<NN, DAM>(g, needles, num, warps, out, st);
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
      return (int)cudaErrorInvalidValue;
  }
}

// Plain C entry point.  All pointers are device pointers; nothing is
// allocated or synchronised here.  out is int32 [num, out_stride] with
// out_stride >= iter_len + 1 a multiple of 4 and a 16-byte aligned base
// (rows 128-byte aligned store whole lines); columns past iter_len are not
// written.  nw: 32-bit words, one of the built counts, at least
// ceil(m / 32) (exactly that at 1 and 2 words: the score word is then the
// last); warps: warps a block (1..8).  A segment reads at most
// own_len + halo < 2^31 - 16 bytes.
// Returns the cudaError_t of the launch.
extern "C" int ta_myers_search(const void* hay, int64_t iter_len,
                               const void* needles, int num, int m,
                               int64_t own_len, int64_t halo, int64_t nseg,
                               int anchored, int damerau, void* out,
                               int64_t out_stride, int nw, int warps,
                               void* stream) {
  if (num <= 0) return 0;
  if (m < 1 || m > 1280 || 32 * nw < m || (nw <= 2 && 32 * nw - 32 >= m) ||
      own_len < 1 || halo < 0 ||
      own_len + halo > 2147483647LL - 16 || nseg < 1 || num > 65535 ||
      out_stride < iter_len + 1 || (out_stride & 3) || warps < 1 ||
      warps > MS_MAX_WARPS || ((uintptr_t)hay & 15) || ((uintptr_t)out & 15) ||
      (nseg + (int64_t)warps * MS_LANES - 1) / ((int64_t)warps * MS_LANES) >
          2147483647LL)
    return (int)cudaErrorInvalidValue;
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
  int32_t* op = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  return damerau ? launch_words<true>(nw, g, nd, num, warps, op, st)
                 : launch_words<false>(nw, g, nd, num, warps, op, st);
}

#endif  // TA_HOST_REHEARSAL
