"""Banded general-cost edit distance as a row recurrence over a [B, W] band.

Counterpart of the JAX package's ops/band_scan.py, in plain PyTorch ops.
This module is the plain version of the band kernels of
csrc/band_distance.cu (wrappers in ops/lev_band.py): what `device="cpu"`
runs, and what the kernels are held against on the card.

Coordinates: DP cell (i, j) over a (rows, len m) x b (cols, len n), m <= n.
The band keeps |j - i| <= unit_k; band cell c in [0, W), W = 2*unit_k + 1,
holds j = i + c - unit_k.  In these coordinates

    substitution  (i-1, j-1) -> same cell c of the previous row
    vertical gap  (i-1, j  ) -> cell c+1 of the previous row (consume a)
    horizontal    (i,   j-1) -> cell c-1 of the same row     (consume b)
    transpose     (i-2, j-2) -> same cell c two rows back

and the within-row affine horizontal chain is one exclusive prefix-min:

    E[c] = start_gap + c*gap + min_{c'<c} (D'[c'] - c'*gap)

Numeric contract (equal to the scalar oracle): tie priority sub >
horizontal > vertical, transpose wins on <=; argmin codes {0: sub,
1: consume-b, 2: consume-a, 3: transpose}.

Layouts (the port's own).  Strings are pair-major rows: `a_t` [B, max_m],
`b_t` [B, max_m + W] with each pair's b at offset unit_k, so row i reads
its band window at b_t[:, i-1 : i-1+W].  Pads may hold anything, also a
byte that equals a real character: every comparison a pad could win is
masked by the cell's validity (0 <= j <= n) or lands on an infinite
predecessor.  Argmin codes are packed 16 two-bit codes to a 32-bit word,
`codes` int32 [B, max_m, ceil(W / 16)], cell c of row i at word c // 16 of
row i - 1, bits 2*(c % 16).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..types import Edit, EditType

__all__ = [
    "INF",
    "CODES_PER_WORD",
    "code_words",
    "pack_codes",
    "unpack_codes",
    "band_scan_distance",
    "band_trace_batch",
    "walk_steps",
    "walk_packed_traceback",
    "RUN_COUNT_LIMIT",
    "run_length_encode",
    "decode_walked_batch",
    "prepare_band_inputs",
    "decode_traceback",
]

INF = 1 << 30  # +infinity sentinel; all real costs stay far below
CODES_PER_WORD = 16  # two-bit argmin codes per packed 32-bit word
# a walk's runs are int32 `count << 3 | step`: counts below 2^28
RUN_COUNT_LIMIT = 1 << 28

CostsT = Tuple[int, int, int, int, bool]


def code_words(W: int) -> int:
    """Packed 32-bit words per DP row of a W-cell band."""
    return -(-W // CODES_PER_WORD)


def pack_codes(code: torch.Tensor) -> torch.Tensor:
    """[B, W] codes in 0..3 -> int32 [B, ceil(W / 16)] packed words (the
    bit pattern of the unsigned word; code 3 in the top slot sets the
    sign)."""
    B, W = code.shape
    wpr = code_words(W)
    pad = wpr * CODES_PER_WORD - W
    c64 = code.to(torch.int64)
    if pad:
        c64 = torch.cat([c64, c64.new_zeros((B, pad))], dim=1)
    shifts = 2 * torch.arange(CODES_PER_WORD, dtype=torch.int64,
                              device=code.device)
    words = (c64.reshape(B, wpr, CODES_PER_WORD) << shifts).sum(dim=2)
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32)


def unpack_codes(words: torch.Tensor, W: int) -> torch.Tensor:
    """Inverse of `pack_codes` over the last axis: int32 [..., ceil(W/16)]
    -> uint8 [..., W]."""
    shifts = 2 * torch.arange(CODES_PER_WORD, dtype=torch.int64,
                              device=words.device)
    c = (words.to(torch.int64).unsqueeze(-1) >> shifts) & 3
    return c.reshape(*words.shape[:-1], -1)[..., :W].to(torch.uint8)


def band_scan_distance(
    a_t: torch.Tensor,  # [B, max_m] integer chars
    b_t: torch.Tensor,  # [B, max_m + W], b at offset unit_k
    m: torch.Tensor,  # [B] len(a), m <= n
    n: torch.Tensor,  # [B] len(b)
    *,
    unit_k: int,
    costs_t: CostsT,
    trace_on: bool,
):
    """Batched banded edit distance, a Python loop over the DP rows.

    Returns (dist [B] int32, codes int32 [B, max(max_m, 1), ceil(W/16)] or
    None).  dist is >= INF when the pair's final cell was never reached
    (the caller turns values above max_k into -1).  Code rows past a
    pair's own m hold the recurrence run on over pads; nothing reads them.
    """
    mc, gc, sgc, tc, allow_transpose = costs_t
    W = 2 * unit_k + 1
    B = a_t.shape[0]
    dev = a_t.device
    i32 = torch.int32
    if b_t.shape[1] < a_t.shape[1] + W - 1:
        raise ValueError("b_t must be at least max_m + W - 1 wide")
    c_arr = torch.arange(W, dtype=i32, device=dev)
    m32 = m.to(i32)
    n_col = n.to(i32)[:, None]
    j0 = (c_arr - unit_k)[None, :]

    # row 0: D[0][j] = j*gap + (j>0)*start_gap for valid j, else INF
    dp1 = torch.where(
        (j0 >= 0) & (j0 <= n_col), j0 * gc + (j0 > 0).to(i32) * sgc, INF
    ).to(i32)
    # final cell of pair p lives at band cell c_fin = n - m + unit_k
    c_fin = torch.clamp(n_col[:, 0] - m32 + unit_k, 0, W - 1).to(torch.int64)
    d0 = dp1.gather(1, c_fin[:, None])[:, 0]
    result = torch.where(m32 == 0, d0, torch.full_like(d0, INF))
    dp0 = torch.full((B, W), INF, dtype=i32, device=dev)
    bgap = torch.full((B, W), INF, dtype=i32, device=dev)
    inf_col = torch.full((B, 1), INF, dtype=i32, device=dev)
    codes = None
    if trace_on:
        codes = torch.zeros((B, max(a_t.shape[1], 1), code_words(W)),
                            dtype=i32, device=dev)
    cgc = (c_arr * gc)[None, :]
    n_rows = int(m32.max()) if B else 0
    for i in range(1, n_rows + 1):
        a_char = a_t[:, i - 1:i]
        bwin = b_t[:, i - 1:i - 1 + W]  # b[j-1] of every band cell
        j = j0 + i
        valid = (j >= 0) & (j <= n_col)

        # substitution from (i-1, j-1): same cell of the previous row
        sub = dp1 + (a_char != bwin).to(i32) * mc
        # vertical gap (consume a) from cell c+1 of the previous row;
        # clamped before it is carried, so saturated cells do not creep
        dp1_up = torch.cat([dp1[:, 1:], inf_col], dim=1)
        bgap_up = torch.cat([bgap[:, 1:], inf_col], dim=1)
        bgap2 = torch.clamp(
            torch.minimum(dp1_up + (sgc + gc), bgap_up + gc), max=INF)
        dprime = torch.minimum(sub, bgap2)

        if allow_transpose:
            if i > 1:
                bwin2 = b_t[:, i - 2:i - 2 + W]  # b[j-2]
                a_prev = a_t[:, i - 2:i - 1]
                tcond = (j > 1) & (a_char == bwin2) & (a_prev == bwin)
            else:
                tcond = torch.zeros((B, W), dtype=torch.bool, device=dev)
            trans = torch.where(tcond, dp0 + tc, INF)
            dprime = torch.minimum(dprime, trans)

        dprime = torch.where(valid, torch.clamp(dprime, max=INF), INF)

        # horizontal (consume b) affine chain: EXCLUSIVE prefix min
        g = dprime - cgc
        mins = torch.cummin(g, dim=1).values
        mins_prev = torch.cat([inf_col, mins[:, :-1]], dim=1)
        e = torch.clamp(mins_prev + cgc + sgc, max=INF)

        # selection cascade, the scalar banded core's order (reference
        # levenshtein.rs:493-532): sub default, horizontal on <, vertical
        # on <, transpose on <=
        take_e = e < sub
        dp2 = torch.where(take_e, e, sub)
        take_b = bgap2 < dp2
        dp2 = torch.where(take_b, bgap2, dp2)
        if allow_transpose:
            take_t = tcond & (trans <= dp2)
            dp2 = torch.where(take_t, trans, dp2)
        dp2 = torch.where(valid, torch.clamp(dp2, max=INF), INF)

        if trace_on:
            code = take_e.to(i32)
            code = torch.where(take_b, 2, code)
            if allow_transpose:
                code = torch.where(take_t, 3, code)
            codes[:, i - 1, :] = pack_codes(code)

        d_at = dp2.gather(1, c_fin[:, None])[:, 0]
        result = torch.where(m32 == i, d_at, result)
        dp0, dp1, bgap = dp1, dp2, bgap2
    return result, codes


def walk_steps(max_m: int, unit_k: int) -> int:
    """Steps of a traced batch's walk output: 2 * max_m + unit_k + 1 bounds
    every walk, since n <= m + unit_k and every step takes one character
    or more off a pair."""
    return 2 * max_m + unit_k + 1


def walk_packed_traceback(
    codes: torch.Tensor,  # int32 [B, rows, ceil(W/16)] packed argmin codes
    a_t: torch.Tensor,  # [B, max_m]
    b_t: torch.Tensor,  # [B, max_m + W]
    m: torch.Tensor,  # [B]
    n: torch.Tensor,  # [B]
    *,
    unit_k: int,
):
    """Batched traceback walk from (m, n) back to (0, 0) over the packed
    codes, every pair at once, on the device the codes lie on.

    Returns (seq [B, steps] int8, steps).  seq is in REVERSE walk order:
    0 Match, 1 Mismatch, 2 consume-b, 3 consume-a, 4 Transpose, -1 done;
    `steps = 2*max_m + unit_k + 1` bounds every walk since n <= m + unit_k.
    A pair walks while i > 0 or j > 0, for at most `steps` steps, as the
    JAX package's `_walk_scan` does; the loop stops once no pair walks,
    and the rest of seq stays -1.  All gather indices are int64, so no
    batch size overflows them.  With `run_length_encode`, the plain
    version of kernel K10 (ops/trace_walk.py `trace_walk_plain`; the
    kernel, csrc/trace_walk.cu, emits the same runs on the card).
    """
    W = 2 * unit_k + 1
    B, max_m = a_t.shape
    bw = b_t.shape[1]
    rows, wpr = codes.shape[1], codes.shape[2]
    steps = walk_steps(max_m, unit_k)
    dev = codes.device
    i64 = torch.int64
    seq_t = torch.full((steps, B), -1, dtype=torch.int8, device=dev)
    if B == 0:
        return seq_t.t().contiguous(), steps
    p_arr = torch.arange(B, dtype=i64, device=dev)
    codes_flat = codes.reshape(-1)
    a_flat = a_t.reshape(-1)
    b_flat = b_t.reshape(-1)
    i = m.to(i64).clone()
    j = n.to(i64).clone()
    for s in range(steps):
        active = (i > 0) | (j > 0)
        if not bool(active.any()):
            break
        at_top = i == 0  # row-0 cells are implicit consume-b steps
        c = torch.clamp(j - i + unit_k, 0, W - 1)
        row = torch.clamp(i - 1, 0, rows - 1)
        word = codes_flat[(p_arr * rows + row) * wpr + c // CODES_PER_WORD]
        code = (word.to(i64) >> (2 * (c % CODES_PER_WORD))) & 3
        code = torch.where(at_top, 1, code)
        a_ch = a_flat[p_arr * max_m + torch.clamp(i - 1, 0, max_m - 1)] \
            if max_m else torch.zeros_like(code)
        b_ch = b_flat[p_arr * bw + torch.clamp(unit_k + j - 1, 0, bw - 1)]
        out = torch.where(
            code == 0,
            (a_ch != b_ch).to(i64),
            code + 1,  # 1->2 consume-b, 2->3 consume-a, 3->4 transpose
        )
        seq_t[s] = torch.where(active, out, -1).to(torch.int8)
        di = ((code == 0) | (code == 2)).to(i64) + 2 * (code == 3).to(i64)
        dj = ((code == 0) | (code == 1)).to(i64) + 2 * (code == 3).to(i64)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
    return seq_t.t().contiguous(), steps


def run_length_encode(seq: torch.Tensor):
    """The runs of walked step streams: seq int8 [B, steps] (reverse walk
    order, -1 past each walk's end) -> (runs int32 [total], counts int32
    [B]), pair p's counts[p] runs after the runs of pairs 0 .. p - 1, each
    `count << 3 | step`, in the same (reverse) order.  Counts must stay
    below RUN_COUNT_LIMIT, so a stream may be at most that long."""
    B, steps = seq.shape
    if steps >= RUN_COUNT_LIMIT:
        raise ValueError(f"walks of {steps} steps: a run's count must stay "
                         f"below 2^28 = {RUN_COUNT_LIMIT}")
    dev = seq.device
    i64 = torch.int64
    live = seq >= 0
    prev = torch.cat([torch.full((B, 1), -2, dtype=seq.dtype, device=dev),
                      seq[:, :-1]], dim=1)
    start = live & (seq != prev)
    counts = start.sum(dim=1).to(torch.int32)
    at = torch.nonzero(start.reshape(-1)).reshape(-1)  # pair-major order
    # a run ends at the next run's start or at its pair's walk's end (a
    # walk is a prefix of its row)
    walk_end = torch.arange(B, dtype=i64, device=dev) * steps \
        + live.sum(dim=1)
    nxt = torch.cat([at[1:], torch.full((1,), B * steps, dtype=i64,
                                        device=dev)])[:at.numel()]
    end = torch.minimum(nxt, walk_end[at // max(steps, 1)])
    step = seq.reshape(-1)[at].to(i64)
    return (((end - at) << 3) | step).to(torch.int32), counts


def band_trace_batch(
    a_t: torch.Tensor,
    b_t: torch.Tensor,
    m: torch.Tensor,
    n: torch.Tensor,
    *,
    unit_k: int,
    costs_t: CostsT,
):
    """Plain banded distance WITH the batched traceback walk: the row
    recurrence emits packed argmin codes, then `walk_packed_traceback`
    walks every pair back at once.  Returns (dist [B] int32,
    seq [B, steps] int8, steps); `run_length_encode` makes its runs, which
    `decode_walked_batch` decodes."""
    dist, codes = band_scan_distance(
        a_t, b_t, m, n, unit_k=unit_k, costs_t=costs_t, trace_on=True)
    seq, steps = walk_packed_traceback(codes, a_t, b_t, m, n, unit_k=unit_k)
    return dist, seq, steps


# a run's step (its low three bits) -> the edit of an unswapped pair; a
# swapped pair's steps 2 and 3 trade places first
_RUN_EDITS = (EditType.Match, EditType.Mismatch, EditType.AGap,
              EditType.BGap, EditType.Transpose)


def decode_walked_batch(
    runs: np.ndarray,  # int32 [total], `count << 3 | step`, reverse order
    counts: np.ndarray,  # int32 [B], runs a pair
    swaps: List[bool],
    keep: Optional[np.ndarray] = None,  # bool [B]: pairs to decode
) -> List[Optional[List[Edit]]]:
    """Edit lists of walked runs (K10, `trace_walk.trace_walk`): each pair's
    runs reversed into forward order, steps 2 / 3 mapped to AGap / BGap by
    the pair's swap.  Pairs outside `keep` give None.  One `Edit` per
    distinct (edit, count), shared by every list that holds it (`Edit` is
    frozen), so Python builds objects only for the distinct runs."""
    counts = np.asarray(counts, dtype=np.int64)
    B = counts.shape[0]
    keep = np.ones(B, dtype=bool) if keep is None else \
        np.asarray(keep, dtype=bool)
    runs = np.asarray(runs, dtype=np.int64)[np.repeat(keep, counts)]
    kc = counts[keep]
    pair = np.repeat(np.arange(kc.shape[0]), kc)
    step = runs & 7
    flip = np.asarray(swaps, dtype=bool)[keep][pair] & ((step == 2)
                                                        | (step == 3))
    runs = runs ^ flip
    # forward order: pair q's runs reversed in place
    ends = np.cumsum(kc)
    fwd = runs[(ends - kc)[pair] + ends[pair] - 1
               - np.arange(runs.shape[0])]
    distinct, inverse = np.unique(fwd, return_inverse=True)
    edits = np.empty(distinct.shape[0], dtype=object)
    edits[:] = [Edit(edit=_RUN_EDITS[v & 7], count=v >> 3)
                for v in distinct.tolist()]
    flat = edits[inverse.reshape(-1)]
    out: List[Optional[List[Edit]]] = [None] * B
    lo = 0
    for p, hi in zip(np.flatnonzero(keep).tolist(), ends.tolist()):
        out[p] = flat[lo:hi].tolist()
        lo = hi
    return out


def prepare_band_inputs(
    a_list: List[np.ndarray],
    b_list: List[np.ndarray],
    unit_k: int,
    max_m: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a batch of (a, b) byte arrays (each with len(a) <= len(b)) into
    fixed-shape int32 buffers with -1 pads: the JAX package's input layout
    of `band_scan_distance`, which the port's takes as it is (numpy, on the
    host)."""
    W = 2 * unit_k + 1
    B = len(a_list)
    a_pad = np.full((B, max_m), -1, dtype=np.int32)
    b_pad = np.full((B, max_m + W), -1, dtype=np.int32)
    m = np.zeros(B, dtype=np.int32)
    n = np.zeros(B, dtype=np.int32)
    for p, (a, b) in enumerate(zip(a_list, b_list)):
        m[p] = len(a)
        n[p] = len(b)
        a_pad[p, : len(a)] = a
        b_pad[p, unit_k : unit_k + len(b)] = b
    return a_pad, b_pad, m, n


def decode_traceback(
    codes: np.ndarray,  # [max_m, W] uint8 for ONE pair (see unpack_codes)
    a: np.ndarray,
    b: np.ndarray,
    unit_k: int,
    swap: bool,
) -> List[Edit]:
    """Walk one pair's traceback codes back from (m, n) on the host,
    RLE-encoding edits; the scalar counterpart of `walk_packed_traceback`
    + `decode_walked_batch`, which the tests hold those against.

    Mirrors the scalar banded walk (reference levenshtein.rs:558-606):
    code 0 steps diagonally (Match/Mismatch), 1 consumes b (AGap unswapped),
    2 consumes a (BGap unswapped), 3 steps a transpose.  Rows at i == 0 are
    implicit consume-b steps (the init row, reference levenshtein.rs:450-456).
    """
    res: List[Edit] = []
    i, j = len(a), len(b)

    def push(e: EditType) -> None:
        if res and res[-1].edit == e:
            res[-1] = Edit(edit=e, count=res[-1].count + 1)
        else:
            res.append(Edit(edit=e, count=1))

    a_gap = EditType.BGap if swap else EditType.AGap  # consumes b
    b_gap = EditType.AGap if swap else EditType.BGap  # consumes a

    while i > 0 or j > 0:
        if i == 0:
            j -= 1
            push(a_gap)
            continue
        c = j - i + unit_k
        code = int(codes[i - 1, c])
        if code == 0:
            i -= 1
            j -= 1
            push(EditType.Match if a[i] == b[j] else EditType.Mismatch)
        elif code == 1:
            j -= 1
            push(a_gap)
        elif code == 2:
            i -= 1
            push(b_gap)
        else:
            i -= 2
            j -= 2
            push(EditType.Transpose)

    res.reverse()
    return res
