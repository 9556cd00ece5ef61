"""General-cost approximate search for short needles: kernel K7.

Counterpart of the JAX package's ops/pallas/search_kernel.py.  One module
holds the plan (`K7_MAX_NEEDLE`, `suggest_own_len_diag`), the plain PyTorch
version read from the raw haystack, and the wrapper of the CUDA kernel
(csrc/search_diag.cu) with its launch counter.

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

from typing import Tuple

import torch

from .myers_search import _aligned
from .search_common import seg_count
from .search_scan import search_scan

__all__ = [
    "K7_MAX_NEEDLE",
    "suggest_own_len_diag",
    "search_diag_plain",
    "search_diag",
]

CostsT = Tuple[int, int, int, int, bool]

# The kernel runs a segment on one warp, needle rows over the 32 lanes, at
# most 16 rows a lane kept in registers (six ints a row): 512 chars.  A
# needle of a given length takes the same engine on the CPU and the card.
K7_MAX_NEEDLE = 32 * 16


def suggest_own_len_diag(iter_len: int, halo: int) -> int:
    """Owned end positions per segment of K7: the warp's fill (31 steps)
    and the halo re-read stay under a sixteenth of the owned length, at
    least 2048 columns; a multiple of 256.  ONE measured point: on an H100
    at the 128 MiB headline haystack, needle 24, k = 6 (halos 26 and 28),
    2048 owned columns timed best under both general cost models of
    benches/search_sweep.py --diag, 0.8% ahead of 4096 and 1024; 32768
    lost 15% (too few segments)."""
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
                halo: int, costs_t: CostsT, anchored: bool = False):
    """(D[m][j], L[m][j]) for every end position j in [0, len(hay)], int32
    [len(hay) + 1] each; D >= INF (1 << 30) where no alignment reaches.

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch in `search_diag.launches`; a build or launch failure
    raises.  CPU tensors, and only those, take the plain PyTorch version.
    An anchored search runs as one segment (own_len >= len(hay), halo 0).
    Needles of 1..K7_MAX_NEEDLE chars (search_flat.flat_search takes
    longer ones)."""
    m = _check_inputs(hay, needle, own_len, halo, costs_t, anchored)
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
            int(bool(allow_transpose)), dist.data_ptr(), length.data_ptr(),
            stream)
    check_launch(lib, code, "search_diag")
    search_diag.launches += 1
    return dist, length


search_diag.launches = 0
