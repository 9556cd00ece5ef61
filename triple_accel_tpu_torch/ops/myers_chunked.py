"""Unit-cost and restricted-Damerau Myers bit vectors over a needle of any
length: kernels K5 `blocked_distance` and K6 `blocked_search`.

Counterpart of the JAX package's ops/pallas/myers_chunked.py plus the
blocked half of ops/pallas/search_myers.py.  One module holds the plan, the
host prep of pairs and needles, the plain PyTorch versions, the wrappers of
the CUDA kernels (csrc/myers_blocked.cu, one `__global__` in two modes)
with their launch counters, and the bridge from the JAX package's layouts.

The functions (the same the TPU kernels compute):
* K5, distance mode: the exact unit-cost or restricted-Damerau distance
  D[m][n] of every pair, of any length, the anchored form of search
  (D[0][j] = j) with the score read at the pair's own n; 0 where m == 0
  (the caller knows D[0][n] = n), as the JAX kernel returns it.
* K6, search mode: K2's function (ops/myers_search.py) for a needle of any
  length, anchored or not, any halo, in K2's plain global layout
  int32 [num, iter_len + 1] read from the RAW haystack.  So the search path
  reuses `collect_hits`, the Best-mode filter, the host replays and
  `_postprocess_sparse` as they are; the chunked layout's t-offset
  (myers_chunked.py:543-546) and `_correct_chunk0_nul_hits` have no
  counterpart, because segment 0 starts at byte 0 with a fresh state and
  sees no synthetic pad.  K6's plain version IS K2's: `myers_search_plain`
  has no length cap (the 1280-char cap belongs to K2's kernel).

The plan is Hopper's, not the TPU's: the 1280-char strips, 1024-column
chunks and the blocked / chunked choice sized to VMEM have no counterpart.
A group of G lanes of a warp runs one work item (pair or segment) as a
wavefront, each lane holding W 32-bit words (`blocked_plan`: the map whose
G * W words cover the needle with the least left over; a pair always takes
the whole warp), and a needle longer than a strip of G * W words runs as
strips chained through a byte row of boundary bits a column.  In search
mode a block of several warps runs consecutive segments of one needle and
shares one match table.  The table is per needle over a compact alphabet,
so its size, and with it the W that fits a block's shared memory, depends
on how many distinct bytes the needle holds.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import bitwords as bw
from .myers_search import _aligned, _check_inputs, myers_search_plain
from .search_common import seg_count

__all__ = [
    "WORD",
    "LANES",
    "WPT_CHOICES",
    "LANE_CHOICES",
    "blocked_plan",
    "suggest_own_len_blocked",
    "alphabet_codes",
    "prepare_blocked_distance_inputs",
    "from_reference_distance_inputs",
    "from_reference_strip_needles",
    "blocked_distance",
    "blocked_distance_plain",
    "blocked_search",
    "blocked_search_plain",
]

WORD = 32  # bits a word of the kernel
LANES = 32  # a warp
WPT_CHOICES = (1, 2, 3, 4, 6, 8, 12, 20)  # words a lane the kernel is built for
LANE_CHOICES = (4, 8, 16, 32)  # lanes a work item (search mode)
MAX_WARPS = 8  # warps a block (search mode)
CODES = 256
SMEM_BYTES = 232_448  # shared memory one block may use on an H100

_SMS = 132  # SMs of an H100 SXM
# segments wanted in flight on a large haystack
_TARGET_SEGMENTS = _SMS * 32

# The search plan's choices, from benches/search_sweep.py --blocked
# (NVIDIA H100 80GB HBM3, 700 W; 128 MiB, needle 3,000 = 94 words, halos
# 3,328 and 4,096): among maps of equally few slots, lanes a segment in
# this order (8 x 12 at 32,000 owned columns 16.86 ms unit, 21.59
# rDamerau; at their best owned length 16 x 6 17.20 / 23.07, 32 x 3
# 20.25 / 25.56), and the warps a block (2 and 4 within 3% of each other, 8
# 17-26% slower at 13,312 and 26,624 owned columns, halo 3,328).
SEARCH_LANES_ORDER = (8, 16, 32, 4)
SEARCH_WARPS = 4

# needle chars a strip of the JAX package's long-needle layouts (64 words
# of 20 bits)
_JAX_STRIP_CHARS = 1280

# K6's plain version is K2's: the same recurrence for any word count
blocked_search_plain = myers_search_plain


def _smem_bytes(rows: int, wpt: int) -> int:
    """Shared memory of one block: the byte -> table-row map and the
    table of `rows` codes x (LANES * wpt) 32-bit words."""
    return 4 * CODES + rows * wpt * LANES * 4


def _least_lanes(nw: int, wpt: int) -> int:
    """The fewest lanes of LANE_CHOICES whose `wpt` words a lane hold `nw`
    words (32 when none does: strips)."""
    return next((g for g in LANE_CHOICES if g * wpt >= nw), LANES)


def _check_plan(plan: dict, nw: int, rows: int, search: bool) -> None:
    """A plan handed to a wrapper (blocked_plan's, or one a sweep made) is
    one the kernel takes: a built word count, a lane count of
    LANE_CHOICES (32 for pairs), 1..MAX_WARPS warps (1 for pairs), a table
    that fits a block's shared memory, and, for a one-strip map, no lane
    beyond the needle's: the fewest lanes that hold it at that word
    count."""
    w, g, warps = plan["words_per_lane"], plan["lanes"], plan["warps"]
    ok = (w in WPT_CHOICES and g in LANE_CHOICES
          and 1 <= warps <= MAX_WARPS
          and _smem_bytes(rows, w) <= SMEM_BYTES
          and (search or (g == LANES and warps == 1))
          and (g * w < nw or g == _least_lanes(nw, w)))
    if not ok:
        raise ValueError(f"the blocked kernel does not take the plan {plan} "
                         f"for {nw} words and {rows} table rows")


def blocked_plan(needle_len: int, rows: int = CODES + 1, *,
                 search: bool = False, segments: Optional[int] = None,
                 plan: Optional[dict] = None) -> Optional[dict]:
    """How the blocked kernel runs a needle of `needle_len` chars whose
    match table has `rows` rows (distinct bytes + 1); None for an empty
    needle.  {"words_per_lane": W, "lanes": G, "warps": warps a block,
    "strips": strips}.

    A pair (distance mode) takes the whole warp: the fewest words a lane
    that hold the needle in one strip, else the most that fit a block's
    shared memory, in strips.  A search takes, of the maps (G, W) whose
    G * W words hold the needle in one strip, one with the fewest words
    (ties: the fewest lanes holding no word, then SEARCH_LANES_ORDER, or,
    for a launch of fewer `segments` than the card has SMs, the most
    lanes: a lone segment is latency-bound, and fewer words a lane make a
    shorter step), and SEARCH_WARPS warps a block (fewer when the
    segments do not fill them); a needle no map holds runs in strips at
    32 lanes and the most words that fit.
    `plan`: a map to take instead (a sweep's), checked; its strips are
    recomputed."""
    if needle_len < 1:
        return None
    nw = -(-needle_len // WORD)
    if plan is not None:
        _check_plan(plan, nw, rows, search)
        w, g = plan["words_per_lane"], plan["lanes"]
        return {"words_per_lane": w, "lanes": g, "warps": plan["warps"],
                "strips": -(-nw // (g * w))}
    fits = [w for w in WPT_CHOICES if _smem_bytes(rows, w) <= SMEM_BYTES]
    if search:
        # fewest words, then fewest lanes without a word, then the order
        few = segments is not None and segments < _SMS
        maps = [(g * w, g - -(-nw // w),
                 -g if few else SEARCH_LANES_ORDER.index(g), g, w)
                for g in LANE_CHOICES for w in fits
                if g * w >= nw and g == _least_lanes(nw, w)]
        g, w = min(maps)[3:] if maps else (LANES, fits[-1])
        warps = SEARCH_WARPS
        if segments is not None:  # no warp a block without a segment
            warps = max(1, min(warps, -(-segments * g // LANES)))
    else:
        g, warps = LANES, 1
        w = next((w for w in fits if LANES * w >= nw), fits[-1])
    return {"words_per_lane": w, "lanes": g, "warps": warps,
            "strips": -(-nw // (g * w))}


def suggest_own_len_blocked(iter_len: int, halo: int) -> int:
    """Owned end positions per segment for K6: about 4,224 segments (132
    SMs x 32) for a large haystack, i.e. at the plan's 8 lanes a segment
    about 8 warps an SM in one wave, while the halo re-read stays at most
    an eighth of a segment's owned length; a multiple of 256, at least
    1024.  Measured by benches/search_sweep.py --blocked on an NVIDIA H100
    80GB HBM3 at 700 W over 128 MiB (needle 3,000) at two halos, 8 lanes x
    12 words, 4 warps a block: halo 3,328, the 32,000 this picks 16.86 /
    21.59 ms unit / rDamerau (kernel_ab), 13,312: 18.28 / 24.22 (1.2
    waves), 26,624: 20.70 / 26.74, 53,248: 26.28 / 33.22 (too few warps);
    halo 4,096, the 32,768 this picks 17.07 / 22.20, 16,384: 18.64 /
    23.61, 65,536: 18.97 / 22.42."""
    per_target = -(-max(iter_len, 1) // _TARGET_SEGMENTS)
    own = max(per_target, 8 * halo, 1024)
    return -(-own // 256) * 256


def alphabet_codes(rows: torch.Tensor,
                   lengths: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The compact alphabet of each needle: int16 [N, 256] mapping a byte
    to 1..sigma (the needle's distinct bytes, in byte order) or 0 (absent),
    and the table rows one launch needs: the largest sigma + 1.  `rows`:
    uint8 [N, W] needles, `lengths`: their lengths (bytes past them are
    pads, NUL or not)."""
    n, w = rows.shape
    dev = rows.device
    valid = (torch.arange(w, device=dev)[None, :]
             < lengths.to(torch.int64)[:, None])
    idx = torch.where(valid, rows.to(torch.int64), CODES)
    present = torch.zeros((n, CODES + 1), dtype=torch.bool, device=dev)
    present.scatter_(1, idx, True)
    present = present[:, :CODES]
    codes = torch.where(present, present.cumsum(1), 0).to(torch.int16)
    sigma = int(present.sum(1).max()) if n else 0
    return codes.contiguous(), sigma + 1


def prepare_blocked_distance_inputs(a_list: Sequence[np.ndarray],
                                    b_list: Sequence[np.ndarray], *,
                                    device):
    """Pack a batch (len(a) <= len(b) per pair, any lengths) into K5's
    tensors on `device`: uint8 a [B, Wa], uint8 b [B, Wb] (0 pads, rows a
    multiple of 16 bytes), int32 m [B] and n [B].  One boolean-mask scatter
    a buffer, no per-pair row writes."""
    B = len(a_list)
    arrs_a = [np.asarray(x, dtype=np.uint8) for x in a_list]
    arrs_b = [np.asarray(x, dtype=np.uint8) for x in b_list]
    la = np.fromiter((x.size for x in arrs_a), np.int64, B)
    lb = np.fromiter((x.size for x in arrs_b), np.int64, B)
    wa = -(-max(int(la.max(initial=0)), 1) // 16) * 16
    wb = -(-max(int(lb.max(initial=0)), 1) // 16) * 16
    a_rows = np.zeros((B, wa), dtype=np.uint8)
    b_rows = np.zeros((B, wb), dtype=np.uint8)
    if B:
        a_rows[np.arange(wa)[None, :] < la[:, None]] = np.concatenate(arrs_a)
        b_rows[np.arange(wb)[None, :] < lb[:, None]] = np.concatenate(arrs_b)
    dev = torch.device(device)
    return (torch.from_numpy(a_rows).to(dev), torch.from_numpy(b_rows).to(dev),
            torch.from_numpy(la.astype(np.int32)).to(dev),
            torch.from_numpy(lb.astype(np.int32)).to(dev))


def from_reference_distance_inputs(nchar: np.ndarray, seg: np.ndarray,
                                   m_row: np.ndarray, n_row: np.ndarray, *,
                                   device):
    """Bridge from the JAX package's pair layout: the first four results of
    `myers_chunked.prepare_blocked_distance_inputs` (row-major uint8 needle
    and text rows with 0 pads, [1, B] int32 lengths; B padded to lanes with
    empty pairs).  Returns K5's (a, b, m, n) on `device`, every lane kept."""
    dev = torch.device(device)
    a = np.ascontiguousarray(nchar, dtype=np.uint8)
    b = np.ascontiguousarray(seg, dtype=np.uint8)
    if b.shape[1] % 16:
        raise ValueError("reference text rows must be a multiple of 16")
    return (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            torch.from_numpy(np.asarray(m_row, np.int32)[0].copy()).to(dev),
            torch.from_numpy(np.asarray(n_row, np.int32)[0].copy()).to(dev))


def from_reference_strip_needles(nchar: np.ndarray, needle_len: int,
                                 num: int, *, strip_major: bool) -> np.ndarray:
    """Bridge from the JAX package's long-needle layouts: `nchar` is
    `search_myers.prepare_blocked_needles`' [num * n_strips * 1280, 128]
    (needle-major, strip_major=False) or
    `myers_chunked.prepare_chunked_needles`' [n_strips * num * 1280, 128]
    (strip-major) int32 array, -1 padded, replicated across the lanes.
    Returns uint8 [num, needle_len] for `prepare_myers_needles`."""
    col = np.asarray(nchar)[:, 0]
    n_strips = col.size // (num * _JAX_STRIP_CHARS)
    if strip_major:
        flat = col.reshape(n_strips, num, _JAX_STRIP_CHARS).transpose(1, 0, 2)
    else:
        flat = col.reshape(num, n_strips, _JAX_STRIP_CHARS)
    chars = flat.reshape(num, n_strips * _JAX_STRIP_CHARS)[:, :needle_len]
    if (chars < 0).any() or (chars > 255).any():
        raise ValueError("reference needle rows hold pad values")
    return chars.astype(np.uint8)


def _check_distance_inputs(a, b, m, n) -> None:
    if a.dtype != torch.uint8 or a.dim() != 2:
        raise TypeError("a must be uint8 [B, Wa]")
    if b.dtype != torch.uint8 or b.dim() != 2:
        raise TypeError("b must be uint8 [B, Wb]")
    B = a.shape[0]
    for x, name in ((m, "m"), (n, "n")):
        if x.dtype != torch.int32 or x.shape != (B,):
            raise TypeError(f"{name} must be int32 [B]")
    if b.shape[0] != B or len({a.device, b.device, m.device, n.device}) != 1:
        raise ValueError("a, b, m, n must share the batch and the device")
    if b.shape[1] % 16:
        raise ValueError("b rows must be a multiple of 16 bytes")
    if B and (int(m.min()) < 0 or int(n.min()) < 0
              or int(m.max()) > a.shape[1] or int(n.max()) > b.shape[1]):
        raise ValueError("a length lies outside its row")


def _pair_peq(a: torch.Tensor, mm: torch.Tensor, nw32: int) -> torch.Tensor:
    """Peq[B, 256, nw32] int64: bit t of word w of entry (p, ch) is set iff
    a[p, 32 * w + t] == ch and 32 * w + t < m[p]."""
    B, wa = a.shape
    L = min(wa, nw32 * bw.WORD32)
    i = torch.arange(L, dtype=torch.int64, device=a.device)
    valid = i[None, :] < mm[:, None]
    idx = a[:, :L].to(torch.int64) * nw32 + (i // bw.WORD32)[None, :]
    val = (torch.ones_like(i) << (i % bw.WORD32))[None, :].expand(B, L)
    peq = torch.zeros((B, CODES * nw32), dtype=torch.int64, device=a.device)
    peq.scatter_add_(1, torch.where(valid, idx, 0), torch.where(valid, val, 0))
    return peq.view(B, CODES, nw32)


def blocked_distance_plain(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor,
                           n: torch.Tensor, *,
                           damerau: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel K5: the recurrence of
    `myers_search_plain` in its anchored form (D[0][j] = j), vectorised over
    the pairs, a Python loop over the longest pair's columns, each pair's
    score frozen after its own n.  int32 [B]; 0 where m == 0."""
    _check_distance_inputs(a, b, m, n)
    dev = a.device
    B = a.shape[0]
    mm = m.to(torch.int64)
    nn = n.to(torch.int64)
    max_m = int(mm.max()) if B else 0
    max_n = int(nn.max()) if B else 0
    nw32 = max(1, -(-max_m // bw.WORD32))
    peq = _pair_peq(a, mm, nw32)
    pairs = torch.arange(B, device=dev)
    last = (mm - 1).clamp(min=0)
    wS = (last // bw.WORD32)[:, None]
    offS = last % bw.WORD32

    shape = (B, nw32)
    Pv = torch.full(shape, bw.M32, dtype=torch.int64, device=dev)
    Mv = torch.zeros(shape, dtype=torch.int64, device=dev)
    EqP = torch.zeros(shape, dtype=torch.int64, device=dev)
    D0P = torch.zeros(shape, dtype=torch.int64, device=dev)
    S = mm.clone()
    for t in range(1, max_n + 1):
        Eq = peq[pairs, b[:, t - 1].to(torch.int64)]  # [B, nw32]
        seeds = Eq
        if damerau:
            seeds = Eq | (EqP & bw.shl1(Eq, 0) & bw.shl1(bw.bnot(D0P), 0))
        Xh = (bw.add_words(seeds & Pv, Pv) ^ Pv) | seeds
        Ph = Mv | bw.bnot(Xh | Pv)
        Mh = Pv & Xh
        dS = (((Ph.gather(1, wS)[:, 0] >> offS) & 1)
              - ((Mh.gather(1, wS)[:, 0] >> offS) & 1))
        S = torch.where(nn >= t, S + dS, S)
        PhS = bw.shl1(Ph, 1)  # row 0: D[0][j] - D[0][j-1] = +1
        MhS = bw.shl1(Mh, 0)
        D0 = (Xh | Mv) if damerau else (Eq | Mv)  # Mv: previous column's VN
        Pv = MhS | bw.bnot(D0 | PhS)
        Mv = PhS & D0
        if damerau:
            EqP, D0P = Eq, D0
    return torch.where(mm == 0, 0, S).to(torch.int32)


def _scratch(items: int, cols: int, n_strips: int, dev):
    """Boundary-bit rows between strips (uint8 [items, cols rounded up to
    16]); none for one-strip needles."""
    if n_strips == 1:
        return None, 0
    stride = -(-max(cols, 1) // 16) * 16
    return torch.empty((items, stride), dtype=torch.uint8, device=dev), stride


def blocked_distance(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor,
                     n: torch.Tensor, *, damerau: bool = False) -> torch.Tensor:
    """Exact unit-cost (or, with `damerau`, restricted-Damerau) distance
    D[m_p][n_p] of every pair of `prepare_blocked_distance_inputs`' tensors,
    int32 [B]; 0 where m_p == 0 (the caller's fix-up: n_p).

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch in `blocked_distance.launches`; a build or launch
    failure raises.  CPU tensors, and only those, take the plain PyTorch
    version.
    """
    _check_distance_inputs(a, b, m, n)
    if a.device.type == "cpu":
        return blocked_distance_plain(a, b, m, n, damerau=damerau)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    B = a.shape[0]
    a, b = a.contiguous(), _aligned(b)
    m, n = m.contiguous(), n.contiguous()
    codes, rows = alphabet_codes(a, m)
    pl = blocked_plan(max(int(m.max()) if B else 1, 1), rows)
    scratch, sstride = _scratch(B, int(n.max()) if B else 0, pl["strips"],
                                a.device)
    out = torch.empty(B, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ta_blocked_distance(
            a.data_ptr(), b.data_ptr(), m.data_ptr(), n.data_ptr(),
            codes.data_ptr(), rows, pl["words_per_lane"], out.data_ptr(), B,
            a.stride(0),
            b.stride(0), 0 if scratch is None else scratch.data_ptr(),
            sstride, int(damerau), stream,
        )
    check_launch(lib, code, "blocked_distance")
    if B:
        blocked_distance.launches += 1
    return out


blocked_distance.launches = 0


def blocked_search(hay: torch.Tensor, needles: torch.Tensor, *, own_len: int,
                   halo: int, anchored: bool = False, damerau: bool = False,
                   plan: Optional[dict] = None) -> torch.Tensor:
    """`myers_search` for needles of any length: D[m][j] for every end
    position j in [0, len(hay)] of every needle, int32 [num, len(hay) + 1],
    the same segments, halo and layout.

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch in `blocked_search.launches`; a build or launch
    failure raises.  CPU tensors, and only those, take the plain PyTorch
    version.  An anchored search must run as one segment (own_len >=
    len(hay), halo = 0).  `plan`: a map for `blocked_plan` to check and
    take (`search=True`).
    """
    m = _check_inputs(hay, needles, own_len, halo, anchored)
    if hay.device.type == "cpu":
        return blocked_search_plain(hay, needles, own_len=own_len, halo=halo,
                                    anchored=anchored, damerau=damerau)
    if hay.device.type != "cuda":
        raise ValueError(f"unsupported device {hay.device}")
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    n = hay.shape[0]
    hay = _aligned(hay)
    needles = needles.contiguous()
    num = needles.shape[0]
    codes, rows = alphabet_codes(
        needles, torch.full((num,), m, dtype=torch.int64, device=hay.device))
    nseg = seg_count(n, own_len)
    pl = blocked_plan(m, rows, search=True, segments=num * nseg, plan=plan)
    # a segment's boundary bits sit at its byte's place in a 16-byte chunk
    scratch, sstride = _scratch(num * nseg, halo + own_len + 15,
                                pl["strips"], hay.device)
    # rows padded to a multiple of 4 ints: four columns leave in one
    # 16-byte store; the pad columns are never written
    stride = -(-(n + 1) // 4) * 4
    out = torch.empty((num, stride), dtype=torch.int32, device=hay.device)
    with torch.cuda.device(hay.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ta_blocked_search(
            hay.data_ptr(), n, needles.data_ptr(), num, m, codes.data_ptr(),
            rows, pl["words_per_lane"], pl["lanes"], pl["warps"], own_len,
            halo, nseg, int(anchored), int(damerau),
            out.data_ptr(), stride,
            0 if scratch is None else scratch.data_ptr(), sstride, stream,
        )
    check_launch(lib, code, "blocked_search")
    if num:
        blocked_search.launches += 1
    return out[:, : n + 1]


blocked_search.launches = 0
