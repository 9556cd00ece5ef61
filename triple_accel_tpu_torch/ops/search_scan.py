"""General-cost approximate search as an anti-diagonal wavefront, in plain
PyTorch ops: the plain version of kernel K7 (csrc/search_diag.cu).

Counterpart of the JAX package's ops/search_scan.py.  The DP matrix is the
needle (rows j, length m) against a haystack segment (columns i); row 0 is
free for unanchored searches, so matches may start anywhere, and cell
(m, i) yields the candidate match ending after i segment characters with
its cost and its haystack span (ties: the longest).

The wavefront walks anti-diagonals t = i + j; on diagonal t, lane j holds
cell (j, i = t - j), so every predecessor is a lane shift of carried state:

    needle gap   (j,   i-1) -> same lane of diagonal t-1 (consumes haystack)
    haystack gap (j-1, i  ) -> lane j-1 of diagonal t-1  (consumes needle)
    substitution (j-1, i-1) -> lane j-1 of diagonal t-2
    transpose    (j-2, i-2) -> lane j-2 of diagonal t-4

vectorised over a batch of haystack segments (the leading axis).  The tie
contract is the scalar search core's, in its exact comparison order
(reference levenshtein.rs:1723-1779): the haystack gap replaces on < or on
== when the cell one row up is longer; substitution on < or on == with a
longer length; transposition on <= even with a shorter length; the gap
chains keep the longer length on a tie.

`chunk_haystack` is kept for the tests only: the card path reads segments
straight from the raw haystack (ops/search_diag.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .band_scan import INF

__all__ = ["search_scan", "chunk_haystack"]

CostsT = Tuple[int, int, int, int, bool]


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x[:, j] <- x[:, j-1] along the lane axis, `fill` into lane 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def search_scan(
    needle: torch.Tensor,  # [m] int32 (or uint8)
    seg_pad: torch.Tensor,  # [C, seg_len + 2m + 2] int32, see chunk_haystack
    seg_n: torch.Tensor,  # [C] int32: valid chars in each segment
    seg_off: torch.Tensor,  # [C] int32: global offset of each segment start
    *,
    seg_len: int,
    costs_t: CostsT,
    anchored: bool,
):
    """Batched search wavefront over haystack segments.

    `seg_pad` holds segment char q at column q + m + 1 and -1 elsewhere.
    Returns (dist, length), int32 [C, seg_len + 1]: entry i is the DP
    result for the match ending after i segment chars (dist >= INF where
    out of range)."""
    mc, gc, sgc, tc, allow_transpose = costs_t
    dev = seg_pad.device
    m = int(needle.shape[0])
    lanes = m + 1
    C = seg_pad.shape[0]
    i32 = torch.int32
    j_arr = torch.arange(lanes, dtype=i32, device=dev)[None, :]
    npad = torch.cat([torch.full((2,), -1, dtype=i32, device=dev),
                      needle.to(i32)])
    nchar = npad[1: 1 + lanes][None, :]
    nprev = npad[0:lanes][None, :]
    n_col = seg_n.to(i32)[:, None]
    off_col = seg_off.to(i32)[:, None]
    seg_pad = seg_pad.to(i32)

    def full(v):
        return torch.full((C, lanes), v, dtype=i32, device=dev)

    dp1 = torch.where(j_arr == 0, 0, INF).to(i32).expand(C, lanes).clone()
    dp2, dp3, dp4 = full(INF), full(INF), full(INF)
    len1, len2, len3, len4 = full(0), full(0), full(0), full(0)
    ng, ngl, hg, hgl = full(INF), full(0), full(INF), full(0)

    steps = m + seg_len
    dists = torch.empty((steps, C), dtype=i32, device=dev)
    lens = torch.empty((steps, C), dtype=i32, device=dev)
    for t in range(1, steps + 1):
        # reversed haystack windows: w1[j] = seg[t-1-j], w2[j] = seg[t-2-j]
        w1 = seg_pad[:, t: t + lanes].flip(1)
        w2 = seg_pad[:, t - 1: t - 1 + lanes].flip(1)
        i_vec = t - j_arr
        valid = (i_vec >= 0) & (i_vec <= n_col)

        # needle gap (consume haystack char): same lane, diagonal t-1
        new_g = dp1 + (sgc + gc)
        cont_g = torch.clamp(ng, max=INF) + gc
        ng2 = torch.minimum(new_g, cont_g)
        ngl2 = torch.where(
            new_g < cont_g, len1 + 1,
            torch.where(new_g > cont_g, ngl + 1,
                        torch.maximum(len1, ngl) + 1))

        # haystack gap (consume needle char): lane j-1, diagonal t-1
        dp1s = _shift_down(dp1, INF)
        hgs = _shift_down(hg, INF)
        len1s = _shift_down(len1, 0)
        hgls = _shift_down(hgl, 0)
        new_h = dp1s + (sgc + gc)
        cont_h = torch.clamp(hgs, max=INF) + gc
        hg2 = torch.minimum(new_h, cont_h)
        hgl2 = torch.where(
            new_h < cont_h, len1s,
            torch.where(new_h > cont_h, hgls, torch.maximum(len1s, hgls)))

        # substitution: lane j-1, diagonal t-2
        sub = _shift_down(dp2, INF) + torch.where(nchar == w1, 0, mc).to(i32)
        lsub = _shift_down(len2, 0) + 1

        # selection cascade, reference order (levenshtein.rs:1752-1779)
        dp, ln = ng2, ngl2
        take = (hg2 < dp) | ((hg2 == dp) & (len1s > ln))
        dp = torch.where(take, hg2, dp)
        ln = torch.where(take, hgl2, ln)
        take = (sub < dp) | ((sub == dp) & (lsub > ln))
        dp = torch.where(take, sub, dp)
        ln = torch.where(take, lsub, ln)
        if allow_transpose:
            # (j-2, i-2): four diagonals back, two lanes down
            dp4ss = _shift_down(_shift_down(dp4, INF), INF)
            len4ss = _shift_down(_shift_down(len4, 0), 0)
            tcond = ((i_vec > 1) & (j_arr > 1) & (nchar == w2)
                     & (nprev == w1))
            trans = dp4ss + tc
            take = tcond & (trans <= dp)
            dp = torch.where(take, trans, dp)
            ln = torch.where(take, len4ss + 2, ln)

        dp = torch.where(valid, torch.clamp(dp, max=INF), INF).to(i32)
        ln = torch.where(valid, ln, 0).to(i32)

        # boundary row j = 0: free (unanchored) or the global shift cost
        if anchored:  # in int64: the offset may be large
            boundary = torch.clamp((off_col.to(torch.int64) + t) * gc + sgc,
                                   max=INF)
        else:
            boundary = torch.zeros((C, 1), dtype=i32, device=dev)
        brow = torch.where(t <= n_col, boundary, INF).to(i32)
        dp[:, :1] = brow
        ln[:, :1] = 0
        ng2[:, :1] = brow
        ngl2[:, :1] = 0
        hg2[:, :1] = INF
        hgl2[:, :1] = 0

        dists[t - 1] = dp[:, m]
        lens[t - 1] = ln[:, m]
        dp4, dp3, dp2, dp1 = dp3, dp2, dp1, dp
        len4, len3, len2, len1 = len3, len2, len1, ln
        ng, ngl, hg, hgl = ng2, ngl2, hg2, hgl2

    # cell (m, i) lies on diagonal t = m + i, row t - 1 of `dists`; i = 0
    # (the end-0 candidate) is the initial column, computed at t = m
    dist_out = torch.cat(
        [dists[m - 1:], torch.full((m, C), INF, dtype=i32, device=dev)]
    )[: seg_len + 1].T.contiguous()
    len_out = torch.cat(
        [lens[m - 1:], torch.zeros((m, C), dtype=i32, device=dev)]
    )[: seg_len + 1].T.contiguous()
    return dist_out, len_out


def chunk_haystack(haystack: np.ndarray, needle_len: int, halo: int,
                   own_len: int):
    """Split a haystack into overlapping segments (the JAX package's
    layout, for the tests): segment c owns end positions (c*own_len,
    (c+1)*own_len] and sees `halo` chars before them.  Returns (seg_pad,
    seg_n, seg_off, own_start, seg_len) with seg_pad int32 [C, seg_len +
    2*needle_len + 2], chars at offset needle_len + 1, -1 elsewhere."""
    n = len(haystack)
    num = max(1, -(-n // own_len))
    seg_len = halo + own_len
    pad_l = needle_len + 1
    seg_pad = np.full((num, seg_len + 2 * needle_len + 2), -1, np.int32)
    seg_n = np.zeros(num, np.int32)
    seg_off = np.zeros(num, np.int32)
    own_start = np.zeros(num, np.int32)
    for c in range(num):
        o = c * own_len
        s0 = max(0, o - halo)
        seg = haystack[s0: min(n, o + own_len)]
        seg_pad[c, pad_l: pad_l + len(seg)] = seg
        seg_n[c] = len(seg)
        seg_off[c] = s0
        own_start[c] = o
    return seg_pad, seg_n, seg_off, own_start, seg_len
