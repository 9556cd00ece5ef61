"""General-cost approximate search for short needles: kernel K7.

Counterpart of the JAX package's ops/pallas/search_kernel.py.  One module
holds the plan (`K7_MAX_NEEDLE`, `diag_plan`, `suggest_own_len_diag`), the
plain PyTorch version read from the raw haystack, and the wrapper of the
CUDA kernel (csrc/search_diag.cu) with its launch counter.

The function: for every end position j of the haystack, the least cost
D[m][j] of matching the whole needle against a substring that ends after j
characters (unanchored: starting anywhere; anchored: row 0 charges
j*gap + start_gap for the skipped prefix), under any (mismatch, gap,
start_gap, transpose) costs, with the match length L[m][j] that the
reference's tie rules give (ops/search_scan.py).  The haystack runs as
segments, as in ops/myers_search.py: segment c owns the end positions
(c*own_len, (c+1)*own_len] (segment 0 also owns 0), reads from `halo`
bytes before them, or from byte 0, with a fresh row 0, and emits only what
it owns.  With halo >= the window span of a cost-<=k match every value <= k
and its length are exact.

Output: (dist, length), int32 [iter_len + 1] each, in plain global order.
The TPU kernel's two-phase block-minima fetch (`search_pallas_block_mins`,
`search_gather_blocks`, `SBLOCK`) has no counterpart: hits are picked on
the device with `torch.nonzero`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .myers_search import _aligned
from .search_common import seg_count
from .search_scan import search_scan

__all__ = [
    "K7_MAX_NEEDLE",
    "ROW_CHOICES",
    "LANE_CHOICES",
    "diag_plan",
    "suggest_own_len_diag",
    "search_diag_plain",
    "search_diag",
]

CostsT = Tuple[int, int, int, int, bool]

# The kernel runs a segment on a group of G lanes of a warp, R needle rows
# a lane, at most 32 lanes x 16 rows kept in registers: 512 chars.  A
# needle of a given length takes the same engine on the CPU and the card.
ROW_CHOICES = (1, 2, 3, 4, 6, 8, 12, 16)  # rows a lane the kernel is built for
LANE_CHOICES = (4, 8, 16, 32)  # lanes a segment
MAX_WARPS = 8  # warps a block
K7_MAX_NEEDLE = LANE_CHOICES[-1] * ROW_CHOICES[-1]

# The plan's choices, from benches/search_sweep.py --diag (NVIDIA H100
# 80GB HBM3, 700 W; 128 MiB, needle 24, k = 6 and 30, both general cost
# models; at 2048 owned columns and 2 to 8 warps a block): among maps of
# equally few rows, the fewest lanes first (4 x 6: 6.77-7.02 ms affine,
# 7.76-7.89 with transpositions; 8 x 3: 6.98-7.22 / 8.14-8.45; 16 x 2:
# 10.24-10.49 / 11.63-11.83; 32 x 1: 13.15-13.42 / 15.01-15.33), and 8
# warps a block (2, 4 and 8 within 3%).
LANES_ORDER = (4, 8, 16, 32)
WARPS = 8


def _least_lanes(m: int, rows: int) -> int:
    """The fewest lanes of LANE_CHOICES whose `rows` rows a lane hold the
    needle (None when none does)."""
    return next((g for g in LANE_CHOICES if g * rows >= m), None)


def diag_plan(m: int, plan: Optional[dict] = None) -> dict:
    """How K7 runs a needle of `m` chars (1..K7_MAX_NEEDLE):
    {"rows_per_lane": R, "lanes": G, "warps": warps a block}.  Of the maps
    (G, R) whose G * R rows hold the needle with the fewest lanes for that
    R, one with the fewest rows (ties: the fewest lanes holding no row,
    then LANES_ORDER), WARPS warps a block.
    `plan`: a map to take instead (a sweep's), checked: a built row count,
    the fewest lanes that hold the needle at it (no lane beyond the
    needle's rows but the last one's), 1..MAX_WARPS warps."""
    if plan is not None:
        r, g, w = plan["rows_per_lane"], plan["lanes"], plan["warps"]
        if not (r in ROW_CHOICES and g in LANE_CHOICES
                and g == _least_lanes(m, r) and 1 <= w <= MAX_WARPS):
            raise ValueError(f"K7 does not take the plan {plan} for a "
                             f"needle of {m} chars")
        return {"rows_per_lane": r, "lanes": g, "warps": w}
    maps = [(g * r, g - -(-m // r), LANES_ORDER.index(g), g, r)
            for r in ROW_CHOICES for g in LANE_CHOICES
            if g == _least_lanes(m, r)]
    g, r = min(maps)[3:]
    return {"rows_per_lane": r, "lanes": g, "warps": WARPS}


def suggest_own_len_diag(iter_len: int, halo: int) -> int:
    """Owned end positions per segment of K7: a group's fill (at most 31
    steps, 15 more for the chunk stagger) and the halo re-read stay under
    a sixteenth of the owned length, at least 2048 columns; a multiple of
    256.  Measured by benches/search_sweep.py --diag on an NVIDIA H100
    80GB HBM3 at 700 W over the 128 MiB headline haystack, needle 24, at
    four halos (26 and 38 with transpositions, 28 and 52 without; k = 6
    and 30): at the plan's map (4 lanes x 6 rows, 8 warps a block) 2048
    owned columns lie within 2.1% of the best of 1024, 2048, 4096 and
    8192 at every halo (6.77 / 6.98 ms affine, 7.81 / 7.76 with
    transpositions; the best 6.77 / 6.84 and 7.67 / 7.67)."""
    own = max(16 * (halo + 32), 2048)
    return min(-(-own // 256) * 256, -(-max(iter_len, 1) // 256) * 256)


def _check_inputs(hay, needle, own_len: int, halo: int, costs_t: CostsT,
                  anchored: bool) -> int:
    if hay.dtype != torch.uint8 or hay.dim() != 1:
        raise TypeError("hay must be uint8 [iter_len]")
    if needle.dtype != torch.uint8 or needle.dim() != 1:
        raise TypeError("needle must be uint8 [m]")
    if needle.device != hay.device:
        raise ValueError("hay and needle lie on different devices")
    m = needle.shape[0]
    if m < 1 or m > K7_MAX_NEEDLE:
        raise ValueError(f"needle length {m} outside [1, {K7_MAX_NEEDLE}]: "
                         "search_flat.flat_search takes any length")
    if own_len < 1 or halo < 0:
        raise ValueError("own_len must be >= 1 and halo >= 0")
    if anchored and (halo != 0 or own_len < hay.shape[0]):
        raise ValueError("an anchored search runs as ONE segment, halo 0")
    mc, gc, sgc, tc, _ = costs_t
    if not (0 < mc <= 255 and 0 < gc <= 255 and 0 <= sgc <= 255
            and 0 <= tc <= 255):
        raise ValueError(f"costs {costs_t} outside the u8 range")
    return m


def search_diag_plain(hay: torch.Tensor, needle: torch.Tensor, *,
                      own_len: int, halo: int, costs_t: CostsT,
                      anchored: bool = False):
    """Plain PyTorch version of K7: the segments gathered from the raw
    haystack on its device, `search_scan` over all of them, and the owned
    positions stitched into global order.  (dist, length) int32
    [iter_len + 1] each."""
    m = needle.shape[0]
    dev = hay.device
    n = hay.shape[0]
    C = seg_count(n, own_len)
    c = torch.arange(C, dtype=torch.int64, device=dev)
    col0 = torch.clamp(c * own_len - halo, min=0)
    own_end = torch.clamp((c + 1) * own_len, max=n)
    seg_n = own_end - col0
    seg_len = int(seg_n.max())  # the widest segment read
    q = torch.arange(seg_len, dtype=torch.int64, device=dev)[None, :]
    idx = col0[:, None] + q
    chars = torch.where(q < seg_n[:, None],
                        hay.to(torch.int32)[idx.clamp(max=max(n - 1, 0))]
                        if n else torch.zeros_like(idx, dtype=torch.int32),
                        -1)
    seg_pad = torch.full((C, seg_len + 2 * m + 2), -1, dtype=torch.int32,
                         device=dev)
    seg_pad[:, m + 1: m + 1 + seg_len] = chars
    dist_seg, len_seg = search_scan(
        needle.to(torch.int32), seg_pad, seg_n.to(torch.int32),
        col0.to(torch.int32), seg_len=seg_len, costs_t=costs_t,
        anchored=anchored)
    g = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    owner = (g - 1) // own_len
    local = g - col0[owner]
    dist = torch.empty(n + 1, dtype=torch.int32, device=dev)
    length = torch.empty(n + 1, dtype=torch.int32, device=dev)
    dist[0], length[0] = dist_seg[0, 0], len_seg[0, 0]
    dist[1:] = dist_seg[owner, local]
    length[1:] = len_seg[owner, local]
    return dist, length


def search_diag(hay: torch.Tensor, needle: torch.Tensor, *, own_len: int,
                halo: int, costs_t: CostsT, anchored: bool = False,
                plan: Optional[dict] = None):
    """(D[m][j], L[m][j]) for every end position j in [0, len(hay)], int32
    [len(hay) + 1] each; D >= INF (1 << 30) where no alignment reaches.

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch in `search_diag.launches`; a build or launch failure
    raises.  CPU tensors, and only those, take the plain PyTorch version.
    An anchored search runs as one segment (own_len >= len(hay), halo 0).
    Needles of 1..K7_MAX_NEEDLE chars (search_flat.flat_search takes
    longer ones).  `plan`: a map for `diag_plan` to check and take."""
    m = _check_inputs(hay, needle, own_len, halo, costs_t, anchored)
    pl = diag_plan(m, plan)
    if hay.device.type == "cpu":
        return search_diag_plain(hay, needle, own_len=own_len, halo=halo,
                                 costs_t=costs_t, anchored=anchored)
    if hay.device.type != "cuda":
        raise ValueError(f"unsupported device {hay.device}")
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    n = hay.shape[0]
    hay = _aligned(hay)
    needle = needle.contiguous()
    # every end position is owned by one segment, which writes it
    dist = torch.empty(n + 1, dtype=torch.int32, device=hay.device)
    length = torch.empty(n + 1, dtype=torch.int32, device=hay.device)
    mc, gc, sgc, tc, allow_transpose = costs_t
    with torch.cuda.device(hay.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ta_search_diag(
            hay.data_ptr(), n, needle.data_ptr(), m, own_len, halo,
            seg_count(n, own_len), int(anchored), mc, gc, sgc, tc,
            int(bool(allow_transpose)), pl["rows_per_lane"], pl["lanes"],
            pl["warps"], dist.data_ptr(), length.data_ptr(), stream)
    check_launch(lib, code, "search_diag")
    search_diag.launches += 1
    return dist, length


search_diag.launches = 0
