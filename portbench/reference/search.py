"""Plain PyTorch approximate search: the reference of the scan cells.

The crate's scalar search (`levenshtein_search_naive_with_opts`,
unanchored, no transpositions): a column a haystack byte, a row a needle
byte, row 0 free, each cell's cost and match length updated in the crate's
own order and with its own tie rules (maximise length on equal cost, with
its quirk of comparing the length of the cell above).  Here the cells of
one anti-diagonal (i + j = t) depend only on diagonals t - 1 and t - 2, so
a diagonal is one step, vectorised over its cells and over many windows
side by side.  Each statement below is the crate's statement for one cell.

Which windows.  A needle of m bytes within cost k of a substring has at
most `_max_touched` of its pieces touched by an edit (a substitution
touches one piece, a run of inserted haystack bytes one, a run of L
deleted needle bytes at most min(L, (L - 1) // p + 2) of pieces of p
bytes), so cutting it into `filter_pieces` > that many pieces leaves one piece
that occurs exactly, at the match's own place.  Every exact occurrence of
a piece's first q <= 31 bytes (2-bit codes, compared whole) opens a window
that holds every end such a match can have; the windows start `halo`
columns further left, fresh (D = j*gap + start_gap), and only ends past
the halo are kept.  The halo, twice the longest match of cost <= k plus
start_gap, covers every path that can reach a kept cell's state, so a
kept end's cost and length are the whole haystack's.  Ends outside every
window cost more than k.

The candidates (every end of cost <= k, in order) then take the crate's
Best streaming and filter, or All.

Imports neither the program nor JAX.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["search_matches", "filter_pieces"]

_INF = 1 << 30
_CODE = np.full(256, 255, np.uint8)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def _max_touched(k: int, costs: dict, p: int, m: int) -> int:
    """The most pieces of p bytes that edits of total cost <= k touch."""
    mc, gc, sgc = (costs["mismatch_cost"], costs["gap_cost"],
                   costs["start_gap_cost"])
    ratios = [1 / mc, 1 / (sgc + gc)]
    ratios += [min(L, (L - 1) // p + 2) / (sgc + gc * L)
               for L in range(1, m + 1)]
    return int(k * max(ratios) + 1e-9)


def filter_pieces(m: int, k: int, costs: dict) -> int:
    """The fewest pieces a needle of m bytes is cut into so that a match
    of cost <= k leaves one untouched; raises where no cut does."""
    for P in range(1, m + 1):
        if _max_touched(k, costs, m // P, m) < P:
            return P
    raise ValueError(f"no exact filter for a needle of {m} bytes at k={k}")


def _codes(hay: torch.Tensor, q: int) -> torch.Tensor:
    """The 2-bit code of every q-byte window of `hay` (codes 0..3)."""
    c = hay[: hay.numel() - q + 1].to(torch.int64)
    for t in range(1, q):
        c = (c << 2) | hay[t: hay.numel() - q + 1 + t].to(torch.int64)
    return c


def _seed_windows(needles, hay_codes_t, n: int, k: int, costs: dict):
    """(needle index, first column, last column + 1, halo) of every window
    of every needle, merged where they overlap."""
    gc, sgc = costs["gap_cost"], costs["start_gap_cost"]
    max_ins = max(0, k - sgc) // gc if k >= sgc + gc else 0
    seeds = {}  # q -> list of (code, needle, offset)
    halos = {}
    for ni, nd in enumerate(needles):
        m = len(nd)
        P = filter_pieces(m, k, costs)
        p = m // P
        q = min(p, 31)
        halos[ni] = 2 * (m + max_ins) + sgc + 2
        cn = _CODE[nd].astype(np.int64)
        for r in range(P):
            off = r * p
            code = 0
            for x in cn[off: off + q].tolist():
                code = (code << 2) | x
            seeds.setdefault(q, []).append((code, ni, off))
    wins = []
    for q, lst in seeds.items():
        if n < q:
            continue
        codes = _codes(hay_codes_t, q)
        arr = np.array(lst, np.int64)
        uq, inv = np.unique(arr[:, 0], return_inverse=True)
        uq_t = torch.from_numpy(uq).to(codes.device)
        (pos,) = torch.nonzero(torch.isin(codes, uq_t), as_tuple=True)
        which = torch.searchsorted(uq_t, codes[pos])
        pos, which = pos.cpu().numpy(), which.cpu().numpy()
        # every (seed, occurrence) pair whose codes agree
        order = np.argsort(inv, kind="stable")
        starts = np.searchsorted(inv[order], np.arange(len(uq)))
        counts = np.bincount(inv, minlength=len(uq))
        rep = counts[which]
        occ = np.repeat(pos, rep)
        first = np.repeat(starts[which], rep)
        within = np.arange(rep.sum()) - np.repeat(np.cumsum(rep) - rep, rep)
        sel = arr[order[first + within]]
        for ni in np.unique(sel[:, 1]).tolist():
            mine = sel[:, 1] == ni
            m = len(needles[ni])
            base = occ[mine] - sel[mine, 2]
            c0 = base - max_ins - halos[ni]
            c1 = base + m + max_ins + 1
            wins.append(np.stack([np.full(base.size, ni), c0, c1], 1))
    if not wins:
        return np.empty((0, 4), np.int64)
    w = np.concatenate(wins)
    w = w[np.lexsort((w[:, 1], w[:, 0]))]
    merged = []
    for ni, c0, c1 in w.tolist():
        if merged and merged[-1][0] == ni and c0 <= merged[-1][2]:
            merged[-1][2] = max(merged[-1][2], c1)
        else:
            merged.append([ni, c0, c1, halos[ni]])
    out = np.array(merged, np.int64)
    # a window that starts at the haystack's first byte is exact from it
    out[:, 3] = np.where(out[:, 1] <= 0, 0, out[:, 3])
    out[:, 1] = np.maximum(out[:, 1], 0)
    out[:, 2] = np.minimum(out[:, 2], n)
    return out


def _dp(hay_w: torch.Tensor, ndl: torch.Tensor, mrow: torch.Tensor,
        costs: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cost and length at row mrow[b] of every column of window b, by
    anti-diagonals.  hay_w [B, W] and ndl [B, M] are byte codes; a pad of
    either matches nothing."""
    mc, gc, sgc = (int(costs["mismatch_cost"]), int(costs["gap_cost"]),
                   int(costs["start_gap_cost"]))
    B, W = hay_w.shape
    M = ndl.shape[1]
    dev = hay_w.device
    i32 = torch.int32
    jr = torch.arange(1, M + 1, device=dev)
    init = (torch.arange(M + 1, device=dev, dtype=i32) * gc + sgc)
    zeros = torch.zeros((B, M + 1), dtype=i32, device=dev)
    D2, L2 = zeros.clone(), zeros.clone()
    D1, L1 = zeros.clone(), zeros.clone()
    NG1 = torch.full_like(zeros, _INF)
    NGL1 = zeros.clone()
    HG1 = torch.full_like(zeros, _INF)
    HGL1 = zeros.clone()
    outD = torch.full((B, W + 1), _INF, dtype=i32, device=dev)
    outL = torch.zeros((B, W + 1), dtype=i32, device=dev)
    mrow_c = mrow[:, None].to(torch.int64)
    for t in range(W + M):
        ch = hay_w[:, (t - jr).clamp(0, W - 1)]
        # substitution from (i-1, j-1): diagonal t-2
        sub = D2[:, :-1] + mc * (ndl != ch).to(i32)
        ls = L2[:, :-1] + 1
        # gap in the needle (a haystack byte consumed) from (i-1, j)
        Dl, Ll = D1[:, 1:], L1[:, 1:]
        new = Dl + (sgc + gc)
        cont = (NG1[:, 1:] + gc).clamp_max(_INF)
        ngd = torch.minimum(new, cont)
        ngl = torch.where(new < cont, Ll + 1, torch.where(
            new > cont, NGL1[:, 1:] + 1, torch.maximum(Ll, NGL1[:, 1:]) + 1))
        # gap in the haystack (a needle byte consumed) from (i, j-1)
        Du, Lu = D1[:, :-1], L1[:, :-1]
        new = Du + (sgc + gc)
        cont = (HG1[:, :-1] + gc).clamp_max(_INF)
        hgd = torch.minimum(new, cont)
        hgl = torch.where(new < cont, Lu, torch.where(
            new > cont, HGL1[:, :-1], torch.maximum(Lu, HGL1[:, :-1])))
        # the crate's cascade: needle gap, then haystack gap on < or on ==
        # with the cell above longer, then substitution on < or on == with
        # a longer length
        take = (hgd < ngd) | ((hgd == ngd) & (Lu > ngl))
        d = torch.where(take, hgd, ngd)
        ln = torch.where(take, hgl, ngl)
        take = (sub < d) | ((sub == d) & (ls > ln))
        d = torch.where(take, sub, d).clamp_max(_INF)
        ln = torch.where(take, ls, ln)
        Dn = torch.empty_like(zeros)
        Ln = torch.empty_like(zeros)
        NGn = torch.empty_like(zeros)
        NGLn = torch.empty_like(zeros)
        HGn = torch.empty_like(zeros)
        HGLn = torch.empty_like(zeros)
        Dn[:, 0], Ln[:, 0], NGn[:, 0], NGLn[:, 0] = 0, 0, _INF, 0
        HGn[:, 0], HGLn[:, 0] = _INF, 0
        Dn[:, 1:], Ln[:, 1:] = d, ln
        NGn[:, 1:], NGLn[:, 1:] = ngd, ngl
        HGn[:, 1:], HGLn[:, 1:] = hgd, hgl
        if t + 1 <= M:  # column -1: the fresh start of the window
            Dn[:, t + 1] = init[t + 1]
            Ln[:, t + 1], NGn[:, t + 1], NGLn[:, t + 1] = 0, _INF, 0
        col = t - mrow_c
        col = torch.where((col >= 0) & (col < W), col, W)
        outD.scatter_(1, col, Dn.gather(1, mrow_c))
        outL.scatter_(1, col, Ln.gather(1, mrow_c))
        D2, L2 = D1, L1
        D1, L1, NG1, NGL1, HG1, HGL1 = Dn, Ln, NGn, NGLn, HGn, HGLn
    return outD[:, :W], outL[:, :W]


def _candidates(needles, hay_codes_t, n: int, k: int, costs: dict,
                max_cells: int) -> List[dict]:
    """{end: (cost, length)} of every end of cost <= k of each needle."""
    dev = hay_codes_t.device
    wins = _seed_windows(needles, hay_codes_t, n, k, costs)
    found: List[dict] = [dict() for _ in needles]
    if not len(wins):
        return found
    M = max(len(nd) for nd in needles)
    width = int((wins[:, 2] - wins[:, 1]).max())
    ndl_all = np.full((len(needles), M), 5, np.uint8)  # 5: matches nothing
    for ni, nd in enumerate(needles):
        ndl_all[ni, :len(nd)] = _CODE[nd]
    hay_pad = torch.cat([hay_codes_t, torch.full(
        (width,), 4, dtype=hay_codes_t.dtype, device=dev)])
    per = max(1, max_cells // ((M + 1) * 24 + width * 2))
    cols = torch.arange(width, device=dev)
    for lo in range(0, len(wins), per):
        w = wins[lo: lo + per]
        c0 = torch.from_numpy(w[:, 1]).to(dev)
        hay_w = hay_pad[c0[:, None] + cols[None, :]]
        ndl = torch.from_numpy(ndl_all[w[:, 0]]).to(dev)
        mrow = torch.from_numpy(np.array([len(needles[i])
                                          for i in w[:, 0]])).to(dev)
        outD, outL = _dp(hay_w, ndl, mrow, costs)
        gcol = c0[:, None] + cols[None, :]
        ex0 = torch.from_numpy(w[:, 1] + w[:, 3]).to(dev)
        ok = ((outD <= k) & (gcol >= ex0[:, None])
              & (gcol < torch.from_numpy(w[:, 2]).to(dev)[:, None]))
        b, c = torch.nonzero(ok, as_tuple=True)
        ends = (gcol[b, c] + 1).cpu().numpy()
        dd = outD[b, c].cpu().numpy()
        ll = outL[b, c].cpu().numpy()
        for ni, e, d, ln in zip(w[b.cpu().numpy(), 0].tolist(),
                                ends.tolist(), dd.tolist(), ll.tolist()):
            prev = found[ni].get(e)
            if prev is not None and prev != (d, ln):
                raise AssertionError(
                    f"needle {ni}: two windows disagree at end {e}")
            found[ni][e] = (d, ln)
    return found


def _postprocess(cands: dict, k: int, best: bool) -> List[Tuple[int, int, int]]:
    """The crate's streaming of candidates in end order: Best keeps the
    running minimum as its threshold, replaces the previous match when a
    later one starts at or before it, and keeps the final minimum's."""
    curr_k = k
    emitted = []
    for e in sorted(cands):
        d, ln = cands[e]
        if d <= curr_k:
            if best:
                curr_k = d
            emitted.append((e - ln, e, d))
    if not best:
        return emitted
    res: List[Tuple[int, int, int]] = []
    for mt in emitted:
        if res and mt[0] <= res[-1][0]:
            res[-1] = mt
        else:
            res.append(mt)
    return [mt for mt in res if mt[2] == curr_k]


def search_matches(needles: Sequence[np.ndarray], haystack: np.ndarray,
                   k: int, costs: dict, best: bool, *, device="cpu",
                   max_cells: int = 1 << 28) -> List[List[Tuple[int, int, int]]]:
    """Each needle's (start, end, cost) matches over the ACGT `haystack`,
    unanchored, as the crate's search returns them (Best when `best`,
    else All)."""
    if costs.get("transpose_cost"):
        raise ValueError("the reference has no transpositions")
    hay = np.asarray(haystack, np.uint8)
    needles = [np.asarray(nd, np.uint8) for nd in needles]
    codes = _CODE[hay]
    if (codes == 255).any() or any((_CODE[nd] == 255).any()
                                   for nd in needles):
        raise ValueError("the search reference takes ACGT bytes only")
    if any(len(nd) == 0 for nd in needles):
        raise ValueError("the search reference takes no empty needle")
    n = len(hay)
    hay_t = torch.from_numpy(codes).to(device)
    found = _candidates(needles, hay_t, n, k, costs, max_cells)
    out = []
    for nd, cands in zip(needles, found):
        d0 = len(nd) * costs["gap_cost"] + costs["start_gap_cost"]
        if d0 <= k:  # end 0: every needle byte skipped
            cands = dict(cands)
            cands[0] = (d0, 0)
        out.append(_postprocess(cands, k, best))
    return out
