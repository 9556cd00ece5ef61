"""Row-oriented general-cost search and distance of any length: kernels K8
`flat_search` and K9 `flat_distance`.

Counterpart of the JAX package's ops/pallas/search_flat.py.  One module
holds the plans, the host prep, the plain PyTorch versions and the wrappers
of the CUDA kernel (csrc/search_flat.cu, one `__global__` in two modes)
with their launch counters.

The recurrence (cell-exact with the scalar oracle; i = needle / a row,
j = haystack / b column):

  vertical (consume needle): the affine chain down column j from row i-1;
  substitution: (i-1, j-1); transposition: (i-2, j-2), taken on <=;
  horizontal (consume haystack): one run within row i, resolved as an
    EXCLUSIVE prefix scan over the row's non-horizontal values g = nonh -
    j*gap, a = nonl - j with the (min cost, max length on ties) combine;
    column 0, D[i][0] = i*gap + start_gap with length 0, is its first
    origin.

Then the final cascade in the oracle's order: horizontal by default,
vertical on < or on == when the length of D[i-1][j] is longer,
substitution on < or on == with a longer length, transposition on <=.

* K8, search mode: D[m][j] and the match length L[m][j] of every end
  position of a haystack segment (segments as in ops/myers_search.py: c owns
  (c*own_len, (c+1)*own_len] and reads from `halo` bytes before them, or
  from byte 0), for needles of any length; row 0 is free (unanchored) or
  j*gap + start_gap (anchored, one segment).  `segments=` runs only the
  listed segments: the device length resolution of dense hit streams.
  Output [S, own_len]: entry (x, o) is end position segments[x]*own_len +
  o + 1.  The end-0 candidate (D[m][0] = m*gap + start_gap, length 0) lies
  in the virtual column 0; the caller adds it.
* K9, distance mode: the anchored distance D[m][n] of every pair (a rows,
  b columns), no lengths, over the full matrix or, with `unit_k`, over the
  rows each column strip of the kernel meets inside |i - j| <= unit_k.
  Exact for every pair within its threshold.  Unlike the JAX kernel
  (search_flat.py:575, which seeds the row above a banded strip with INF),
  a strip reads the real edges of the two rows above its window, so a path
  that runs along the band's edge is kept.

Across the kernel's column strips a row carries its D and length at the
strip's last two columns and the horizontal prefix itself, so a search
result does not depend on the strip width; `flat_search_plain` runs each
segment as one row.  The band does depend on it (which cells a strip
meets), so `flat_distance_plain` walks the same strips.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import to_bytes_array
from .band_scan import INF
from .myers_search import _aligned
from .search_common import seg_count

__all__ = [
    "SEARCH_SHAPES",
    "DIST_COLS",
    "DIST_MAX_THREADS",
    "max_threads",
    "flat_threads",
    "suggest_own_len_flat",
    "prepare_flat_needle",
    "prepare_flat_distance_inputs",
    "flat_search_plain",
    "flat_search",
    "flat_distance_plain",
    "flat_distance",
]

CostsT = Tuple[int, int, int, int, bool]

# A block runs one segment or pair: its warps run a strip of 32 x warps x
# C columns as a wavefront, C columns a lane (K8: 4 or 8; K9: 4, 8 or 16),
# the rows in a loop.  The launch shapes are measured ones
# (benches/search_sweep.py --flat, PERF.md).  K8, by kernel variant
# (False: lengths, True: lengths and transpositions, whose registers leave
# fewer blocks resident): threads a block, columns a lane, and the blocks
# an SM that its segments ask for, so a large haystack runs in one wave.
SEARCH_SHAPES = {False: (256, 8, 2), True: (512, 4, 1)}
# K9: columns a lane, and threads a block at most.
DIST_COLS = 16
DIST_MAX_THREADS = 256
_SMS = 132  # the H100's SMs
# Rows and columns of one item (segment or pair): the kernel keeps them in
# int32 and refuses more.
MAX_ITEM_LEN = 1 << 30
# The per-row edges one launch keeps in device memory: a larger batch
# runs in several launches.
EDGE_BYTES_CAP = 1 << 30
_SEARCH_EDGE_INTS = 8  # D, L at the last column, D, L one before, G, A
_DIST_EDGE_INTS = 4  # D at the last column, D one before, G


def max_threads(search: bool, cols: int) -> int:
    """Threads a block the kernel takes at most for `cols` columns a lane
    (csrc/search_flat.cu: sf_max_threads); 0 where it takes none (K8 at 16
    columns a lane)."""
    if search:
        return {4: 512, 8: 256}.get(cols, 0)
    return {4: 512, 8: 512, 16: 256}.get(cols, 0)


def flat_threads(max_cols: int) -> int:
    """Threads of a K9 block: a lane for every DIST_COLS columns of the
    widest pair, in whole warps, 64 to DIST_MAX_THREADS."""
    t = -(-max(max_cols, 1) // DIST_COLS)
    return min(DIST_MAX_THREADS, max(64, -(-t // 32) * 32))


def suggest_own_len_flat(iter_len: int, halo: int,
                         transpose: bool = False) -> int:
    """Owned end positions per K8 segment, for the kernel variant with or
    without transpositions: the halo re-read under an eighth of the owned
    length, and at most the variant's blocks an SM for each of the card's
    132 SMs, so a large haystack runs in one wave; a multiple of the
    variant's strip width."""
    threads, cols, per_sm = SEARCH_SHAPES[bool(transpose)]
    rj = threads * cols
    own = max(8 * halo, -(-max(iter_len, 1) // (per_sm * _SMS)), rj)
    return -(-own // rj) * rj


def prepare_flat_needle(needle, *, device) -> torch.Tensor:
    """The needle as uint8 [m] on `device`, for K7 and K8 alike (the
    kernels read it as it is; the JAX package's lane-replicated rows have
    no counterpart)."""
    return torch.from_numpy(to_bytes_array(needle).copy()).to(
        torch.device(device))


def prepare_flat_distance_inputs(a_list: Sequence[np.ndarray],
                                 b_list: Sequence[np.ndarray], *, device):
    """Pair buffers for flat_distance: (a_t uint8 [B, max_m], b_t uint8
    [B, max_n], m, n int32 [B]), rows at least 1 wide, 0 pads (the kernel
    never reads past a pair's own lengths)."""
    a_list = [to_bytes_array(x) for x in a_list]
    b_list = [to_bytes_array(x) for x in b_list]
    B = len(a_list)
    la = np.fromiter((len(x) for x in a_list), np.int64, B)
    lb = np.fromiter((len(x) for x in b_list), np.int64, B)
    a_rows = np.zeros((B, max(int(la.max(initial=1)), 1)), np.uint8)
    b_rows = np.zeros((B, max(int(lb.max(initial=1)), 1)), np.uint8)
    for p in range(B):
        a_rows[p, :la[p]] = a_list[p]
        b_rows[p, :lb[p]] = b_list[p]
    dev = torch.device(device)
    return (torch.from_numpy(a_rows).to(dev), torch.from_numpy(b_rows).to(dev),
            torch.from_numpy(la.astype(np.int32)).to(dev),
            torch.from_numpy(lb.astype(np.int32)).to(dev))


def _check_costs(costs_t: CostsT) -> None:
    mc, gc, sgc, tc, _ = costs_t
    if not (0 < mc <= 255 and 0 < gc <= 255 and 0 <= sgc <= 255
            and 0 <= tc <= 255):
        raise ValueError(f"costs {costs_t} outside the u8 range")


def _sat(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, max=INF)


def _take_min_long(g1, a1, g2, a2):
    """The (min cost, max length on ties) combine: where element 1 wins."""
    return (g1 < g2) | ((g1 == g2) & (a1 > a2))


def _scan_min_long(g: torch.Tensor, a: torch.Tensor):
    """Inclusive prefix over the last axis with the (min cost, max length)
    combine, Hillis-Steele."""
    W = g.shape[-1]
    off = 1
    while off < W:
        gs = torch.cat([torch.full_like(g[..., :off], INF), g[..., :-off]],
                       dim=-1)
        as_ = torch.cat([torch.zeros_like(a[..., :off]), a[..., :-off]],
                        dim=-1)
        take = _take_min_long(gs, as_, g, a)
        g = torch.where(take, gs, g)
        a = torch.where(take, as_, a)
        off <<= 1
    return g, a


def _segments(n: int, own_len: int, halo: int, segments, dev):
    if segments is None:
        segs = torch.arange(seg_count(n, own_len), dtype=torch.int64,
                            device=dev)
    else:
        segs = torch.as_tensor(segments).to(dev).to(torch.int64)
        if segs.dim() != 1:
            raise ValueError("segments must be a 1-D list of indices")
        if segs.numel() and (int(segs.min()) < 0
                             or int(segs.max()) >= seg_count(n, own_len)):
            raise ValueError("a segment index lies outside the haystack")
    return segs


def _check_search(hay, needle, own_len: int, halo: int, costs_t: CostsT,
                  anchored: bool) -> int:
    if hay.dtype != torch.uint8 or hay.dim() != 1:
        raise TypeError("hay must be uint8 [iter_len]")
    if needle.dtype != torch.uint8 or needle.dim() != 1:
        raise TypeError("needle must be uint8 [m]")
    if needle.device != hay.device:
        raise ValueError("hay and needle lie on different devices")
    m = needle.shape[0]
    if m < 1:
        raise ValueError("needle length must be >= 1")
    if own_len < 1 or halo < 0:
        raise ValueError("own_len must be >= 1 and halo >= 0")
    if m > MAX_ITEM_LEN or own_len + halo > MAX_ITEM_LEN:
        raise ValueError("a segment reads at most 2**30 columns (own_len + "
                         "halo) of a needle of at most 2**30 bytes")
    if anchored and (halo != 0 or own_len < hay.shape[0]):
        raise ValueError("an anchored search runs as ONE segment, halo 0")
    _check_costs(costs_t)
    return m


def flat_search_plain(hay: torch.Tensor, needle: torch.Tensor, *,
                      own_len: int, halo: int, costs_t: CostsT,
                      anchored: bool = False, segments=None):
    """Plain PyTorch version of K8: the row recurrence with the exclusive
    (min cost, max length) prefix combine, vectorised over the segments,
    each segment one row of halo + own_len columns, a Python loop over the
    needle rows.  (dist, length) int32 [S, own_len]."""
    mc, gc, sgc, tc, allow_transpose = costs_t
    dev = hay.device
    i32 = torch.int32
    n = hay.shape[0]
    m = needle.shape[0]
    segs = _segments(n, own_len, halo, segments, dev)
    S = segs.numel()
    own0 = segs * own_len
    col0 = torch.clamp(own0 - halo, min=0)
    ncols = torch.clamp(own0 + own_len, max=n) - col0
    W = max(int(ncols.max()) if S else 0, 1)  # the widest segment read
    q = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    if n:
        chars = hay.to(i32)[(col0[:, None] + q).clamp(max=n - 1)]
    else:
        chars = torch.zeros((S, W), dtype=i32, device=dev)
    hj1 = torch.where(q < ncols[:, None], chars, -2)  # column j = q + 1
    hj2 = torch.cat([torch.full((S, 1), -2, dtype=i32, device=dev),
                     hj1[:, :-1]], dim=1)
    nd = needle.to(i32).tolist()
    # the prefix runs in int64: j * gap may pass int32 on a long segment
    j = torch.arange(1, W + 1, dtype=torch.int64, device=dev)[None, :]
    # columns 0..W of the rows above: row 0, then row -1
    if anchored:
        row0 = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                          _sat(j[0] * gc + sgc).to(i32)]).expand(S, W + 1)
    else:
        row0 = torch.zeros((S, W + 1), dtype=i32, device=dev)
    Dp, Lp = row0, torch.zeros((S, W + 1), dtype=i32, device=dev)
    Dp2 = torch.full((S, W + 1), INF, dtype=i32, device=dev)
    Lp2 = torch.zeros((S, W + 1), dtype=i32, device=dev)
    VG = torch.full((S, W), INF, dtype=i32, device=dev)
    VGL = torch.zeros((S, W), dtype=i32, device=dev)
    inf_col = torch.full((S, 1), INF, dtype=i32, device=dev)
    zero_col = torch.zeros((S, 1), dtype=i32, device=dev)
    for i in range(1, m + 1):
        nch = nd[i - 1]
        npv = nd[i - 2] if i > 1 else -1
        d0 = min(i * gc + sgc, INF)  # D[i][0]
        sub = _sat(Dp[:, :-1] + torch.where(hj1 == nch, 0, mc).to(i32))
        lsub = Lp[:, :-1] + 1
        new_v = _sat(Dp[:, 1:] + (sgc + gc))
        cont_v = _sat(VG + gc)
        vg2 = torch.minimum(new_v, cont_v)
        lp = Lp[:, 1:]
        vgl2 = torch.where(new_v < cont_v, lp,
                           torch.where(new_v > cont_v, VGL,
                                       torch.maximum(lp, VGL)))
        nonh, nonl = vg2, vgl2
        take = (sub < nonh) | ((sub == nonh) & (lsub > nonl))
        nonh = torch.where(take, sub, nonh)
        nonl = torch.where(take, lsub, nonl)
        if allow_transpose:
            tcond = (hj2 == nch) & (hj1 == npv)
            d2s = torch.cat([inf_col, Dp2[:, :-2]], dim=1)  # D[i-2][j-2]
            l2s = torch.cat([zero_col, Lp2[:, :-2]], dim=1) + 2
            trans = torch.where(tcond, _sat(d2s + tc), INF).to(i32)
            take = tcond & (trans <= nonh)
            nonh = torch.where(take, trans, nonh)
            nonl = torch.where(take, l2s, nonl)
        # exclusive chain: column 0's D is the first origin
        G = torch.cat([torch.full((S, 1), d0, dtype=torch.int64, device=dev),
                       nonh - j * gc], dim=1)
        A = torch.cat([zero_col.to(torch.int64), nonl - j], dim=1)
        G, A = _scan_min_long(G, A)
        chainc = _sat(G[:, :-1] + sgc + j * gc).to(i32)
        chainl = (A[:, :-1] + j).to(i32)
        d, ln = chainc, chainl
        take = (vg2 < d) | ((vg2 == d) & (lp > ln))
        d = torch.where(take, vg2, d)
        ln = torch.where(take, vgl2, ln)
        take = (sub < d) | ((sub == d) & (lsub > ln))
        d = torch.where(take, sub, d)
        ln = torch.where(take, lsub, ln)
        if allow_transpose:
            take = tcond & (trans <= d)
            d = torch.where(take, trans, d)
            ln = torch.where(take, l2s, ln)
        d = _sat(d)
        Dp2, Lp2 = Dp, Lp
        Dp = torch.cat([torch.full((S, 1), d0, dtype=i32, device=dev), d],
                       dim=1)
        Lp = torch.cat([zero_col, ln], dim=1)
        VG, VGL = vg2, vgl2
    # owned end position own0 + o + 1 is local column own0 + o + 1 - col0
    o = torch.arange(own_len, dtype=torch.int64, device=dev)[None, :]
    col = own0[:, None] + o + 1 - col0[:, None]
    ok = own0[:, None] + o + 1 <= n
    colc = col.clamp(max=W)
    dist = torch.where(ok, Dp.gather(1, colc), INF).to(i32)
    length = torch.where(ok, Lp.gather(1, colc), 0).to(i32)
    return dist, length


def flat_search(hay: torch.Tensor, needle: torch.Tensor, *, own_len: int,
                halo: int, costs_t: CostsT, anchored: bool = False,
                segments=None):
    """(D[m][j], L[m][j]) at the owned end positions of every segment, or
    of the `segments` listed: int32 [S, own_len] each, entry (x, o) for end
    position segments[x]*own_len + o + 1 (D = INF past the haystack).

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch a batch of segments in `flat_search.launches`; a
    build or launch failure raises.  CPU tensors, and only those, take the
    plain PyTorch version.  An anchored search runs as one segment
    (own_len >= len(hay), halo 0)."""
    _check_search(hay, needle, own_len, halo, costs_t, anchored)
    if hay.device.type == "cpu":
        return flat_search_plain(hay, needle, own_len=own_len, halo=halo,
                                 costs_t=costs_t, anchored=anchored,
                                 segments=segments)
    if hay.device.type != "cuda":
        raise ValueError(f"unsupported device {hay.device}")
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    m = needle.shape[0]
    hay, needle = _aligned(hay), needle.contiguous()
    segs = _segments(hay.shape[0], own_len, halo, segments,
                     hay.device).contiguous()
    S = segs.numel()
    dist = torch.empty((S, own_len), dtype=torch.int32, device=hay.device)
    length = torch.empty((S, own_len), dtype=torch.int32, device=hay.device)
    step = max(1, EDGE_BYTES_CAP // ((m + 2) * _SEARCH_EDGE_INTS * 4))
    edges = torch.empty((min(step, max(S, 1)), m + 2, _SEARCH_EDGE_INTS),
                        dtype=torch.int32, device=hay.device)
    mc, gc, sgc, tc, allow_transpose = costs_t
    threads, cols, _ = SEARCH_SHAPES[bool(allow_transpose)]
    with torch.cuda.device(hay.device):
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, S, step):
            hi = min(S, lo + step)
            code = lib.ta_flat_search(
                hay.data_ptr(), hay.shape[0], needle.data_ptr(), m, own_len,
                halo, segs[lo:hi].data_ptr(), hi - lo, int(anchored),
                mc, gc, sgc, tc, int(bool(allow_transpose)),
                dist[lo:hi].data_ptr(), length[lo:hi].data_ptr(),
                edges.data_ptr(), threads, cols, stream)
            check_launch(lib, code, "flat_search")
            flat_search.launches += 1
    return dist, length


flat_search.launches = 0


def _check_distance(a_t, b_t, m, n, costs_t: CostsT,
                    unit_k: Optional[int]) -> None:
    if a_t.dtype != torch.uint8 or b_t.dtype != torch.uint8:
        raise TypeError("a_t and b_t must be uint8")
    if a_t.dim() != 2 or b_t.dim() != 2 or a_t.shape[0] != b_t.shape[0]:
        raise ValueError("a_t and b_t must be [B, len] with the same B")
    if a_t.shape[1] < 1 or b_t.shape[1] < 1:
        raise ValueError("rows must be at least 1 wide")
    if max(a_t.shape[1], b_t.shape[1]) > MAX_ITEM_LEN:
        raise ValueError("strings of at most 2**30 bytes")
    B = a_t.shape[0]
    for t in (m, n):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError("m and n must be int32 [B]")
    devs = {t.device for t in (a_t, b_t, m, n)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    if unit_k is not None and unit_k < 0:
        raise ValueError("unit_k must be >= 0 or None")
    _check_costs(costs_t)


def flat_distance_plain(a_t: torch.Tensor, b_t: torch.Tensor,
                        m: torch.Tensor, n: torch.Tensor, *, costs_t: CostsT,
                        unit_k: Optional[int] = None,
                        rj: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K9: the same column strips of `rj` columns
    (default: the kernel's, from `flat_threads` and DIST_COLS) and the
    same row window a strip meets, vectorised over the pairs, Python loops
    over strips and rows.  int32 [B]."""
    mc, gc, sgc, tc, allow_transpose = costs_t
    dev = a_t.device
    i32 = torch.int32
    B, max_m = a_t.shape
    max_n = b_t.shape[1]
    if rj is None:
        rj = flat_threads(max_n) * DIST_COLS
    m64, n64 = m.to(torch.int64), n.to(torch.int64)
    qa = torch.arange(max_m, device=dev)[None, :]
    a_ch = torch.where(qa < m64[:, None], a_t.to(i32), -1)
    qb = torch.arange(max_n, device=dev)[None, :]
    b_ch = torch.where(qb < n64[:, None], b_t.to(i32), -2)
    n_strips = -(-max_n // rj)
    b_ch = torch.cat([torch.full((B, 2), -2, dtype=i32, device=dev), b_ch,
                      torch.full((B, n_strips * rj - max_n), -2, dtype=i32,
                                 device=dev)], dim=1)  # column j at j + 1
    res = torch.full((B,), INF, dtype=i32, device=dev)
    # edges of rows -1..max_m at index row + 1: D at the strip's last column
    # (eD), one before (eD2), and the horizontal prefix through it (eG)
    rows = torch.arange(-1, max_m + 1, dtype=torch.int64, device=dev)
    col0_d = _sat(rows * gc + sgc)
    eD = torch.where(rows < 0, INF, torch.where(rows == 0, 0, col0_d))
    eD = eD.to(i32)[None, :].expand(B, -1).clone()
    eD2 = torch.full_like(eD, INF)
    eG = eD.to(torch.int64)  # in int64: j * gap may pass int32
    eG[:, 0] = INF
    inf_col = torch.full((B, 1), INF, dtype=i32, device=dev)
    i_hi_prev = max_m
    for s in range(n_strips):
        j0 = s * rj
        if unit_k is None:
            i_lo, i_hi = 1, max_m
        else:
            i_lo = max(1, j0 + 1 - unit_k)
            i_hi = min(max_m, j0 + rj + unit_k)
        if s:
            # rows entering the window: out of the band at column j0
            eD[:, i_hi_prev + 2:] = INF
            eD2[:, i_hi_prev + 2:] = INF
            eG[:, i_hi_prev + 2:] = INF
        # row 0 at this strip's edge columns and inside it
        if j0:
            eD[:, 1] = min(j0 * gc + sgc, INF)
            eD2[:, 1] = 0 if j0 == 1 else min((j0 - 1) * gc + sgc, INF)
        oD, oD2, oG = eD.clone(), eD2.clone(), eG.clone()
        jj = torch.arange(j0 + 1, j0 + rj + 1, dtype=torch.int64,
                          device=dev)[None, :]
        row0 = _sat(jj * gc + sgc).to(i32).expand(B, rj)
        inf_row = torch.full((B, rj), INF, dtype=i32, device=dev)

        def strip_row(r):
            if r == 0:
                return row0
            return inf_row

        Dp = strip_row(i_lo - 1)
        Dp2 = strip_row(i_lo - 2) if i_lo >= 2 else inf_row
        VG = inf_row
        hj1 = b_ch[:, j0 + 2: j0 + rj + 2]
        hj2 = b_ch[:, j0 + 1: j0 + rj + 1]
        for i in range(i_lo, i_hi + 1):
            nch = a_ch[:, i - 1: i]
            npv = a_ch[:, i - 2: i - 1] if i > 1 else torch.full_like(nch, -1)
            # D of row i-1 at columns j0 .. j0+rj-1, row i-2 at j0-1 ..
            dp_left = torch.cat([oD[:, i - 1 + 1: i + 1], Dp[:, :-1]], dim=1)
            sub = _sat(dp_left + torch.where(hj1 == nch, 0, mc).to(i32))
            vg2 = torch.minimum(_sat(Dp + (sgc + gc)), _sat(VG + gc))
            nonh = torch.minimum(vg2, sub)
            if allow_transpose:
                d2s = torch.cat([oD2[:, i - 2 + 1: i - 1 + 1],
                                 oD[:, i - 2 + 1: i - 1 + 1], Dp2[:, :-2]],
                                dim=1) if i >= 2 else inf_row
                tcond = (hj2 == nch) & (hj1 == npv)
                trans = torch.where(tcond, _sat(d2s + tc), INF).to(i32)
                nonh = torch.minimum(nonh, trans)
            g = nonh - jj * gc
            g = torch.cummin(torch.cat([oG[:, i + 1: i + 2], g], dim=1),
                             dim=1).values
            chainc = _sat(g[:, :-1] + sgc + jj * gc)
            d = _sat(torch.minimum(chainc, nonh)).to(i32)
            eD[:, i + 1] = d[:, -1]
            eD2[:, i + 1] = d[:, -2] if rj > 1 else oD[:, i + 1]
            eG[:, i + 1] = g[:, -1]
            hit = (m64 == i) & (n64 > j0) & (n64 <= j0 + rj)
            if bool(hit.any()):
                qn = (n64 - j0 - 1).clamp(0, rj - 1)[:, None]
                res = torch.where(hit, d.gather(1, qn)[:, 0], res)
            Dp2, Dp, VG = Dp, d, vg2
        i_hi_prev = i_hi
    d_m0 = torch.where(n64 > 0, _sat(n64 * gc + sgc), 0)  # m == 0: row 0
    d_n0 = torch.where(m64 > 0, _sat(m64 * gc + sgc), 0)  # n == 0: col 0
    res = torch.where(m64 == 0, d_m0, torch.where(n64 == 0, d_n0, res))
    return res.to(i32)


def flat_distance(a_t: torch.Tensor, b_t: torch.Tensor, m: torch.Tensor,
                  n: torch.Tensor, *, costs_t: CostsT,
                  unit_k: Optional[int] = None) -> torch.Tensor:
    """Anchored general-cost distances D[m][n], int32 [B] in pair order,
    over the full matrix, or banded by `unit_k` (exact for every pair
    whose distance is within the threshold `unit_k` was derived from;
    others come back at or above their true distance).

    CUDA tensors launch the hand-written kernel and count one launch a
    batch in `flat_distance.launches` (a batch whose per-row edges pass
    EDGE_BYTES_CAP runs in several); CPU tensors, and only those, take the
    plain PyTorch version."""
    _check_distance(a_t, b_t, m, n, costs_t, unit_k)
    if a_t.device.type == "cpu":
        return flat_distance_plain(a_t, b_t, m, n, costs_t=costs_t,
                                   unit_k=unit_k)
    if a_t.device.type != "cuda":
        raise ValueError(f"unsupported device {a_t.device}")
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    B, max_m = a_t.shape
    max_n = b_t.shape[1]
    threads = flat_threads(max_n)
    a_t, b_t, m, n = (t.contiguous() for t in (a_t, b_t, m, n))
    out = torch.empty(B, dtype=torch.int32, device=a_t.device)
    per_pair = (max_m + 2) * _DIST_EDGE_INTS * 4
    step = max(1, EDGE_BYTES_CAP // per_pair)
    mc, gc, sgc, tc, allow_transpose = costs_t
    edges = torch.empty((min(step, max(B, 1)), max_m + 2, _DIST_EDGE_INTS),
                        dtype=torch.int32, device=a_t.device)
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, B, step):
            hi = min(B, lo + step)
            code = lib.ta_flat_distance(
                a_t[lo:hi].data_ptr(), b_t[lo:hi].data_ptr(),
                m[lo:hi].data_ptr(), n[lo:hi].data_ptr(), hi - lo, max_m,
                max_n, -1 if unit_k is None else unit_k, mc, gc, sgc, tc,
                int(bool(allow_transpose)), out[lo:hi].data_ptr(),
                edges.data_ptr(), threads, DIST_COLS, stream)
            check_launch(lib, code, "flat_distance")
            flat_distance.launches += 1
    return out


flat_distance.launches = 0
