"""Plain PyTorch gap-affine distance: the reference of the distance cells.

The crate's full dynamic programme (`levenshtein_naive_with_opts`, no
traceback): rows over the longer string b, columns over the shorter a,
D[0][j] = j*gap + start_gap (j > 0), D[i][0] = i*gap + start_gap, and in
row i

    V[j] = min(D[i-1][j] + start_gap + gap, V[j] + gap)          (a gap)
    S[j] = D[i-1][j-1] + (a[j-1] != b[i-1]) * mismatch
    T[j] = min(S[j], V[j]);  T[0] = D[i][0]
    H[j] = min(D[i][j-1] + start_gap + gap, H[j-1] + gap)         (b gap)
    D[i][j] = min(T[j], H[j])

The b-gap chain runs along the row.  Unrolled, it is H[j] = start_gap +
gap*j + min over j' < j of (T[j'] - gap*j'): a gap opened from a b-gap
cell costs more than the gap it continues, so only T cells open one.  That
is one running minimum a row (`torch.cummin`), the same number as the
crate's chain.  Every pair of a block runs side by side, padded; a
pair's distance is read at its own (len b, len a).

`band` (the control, never the reference): cells farther than `band`
diagonals from the straight line from (0, 0) to (len b, len a) are
forbidden, a fixed narrow band of the kind an adaptive-band heuristic
would cut to.  The answer is then no longer exact.

Imports neither the program nor JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["gap_affine_distances"]

_INF = 1 << 30


def _block(a_list, b_list, costs: dict, band: Optional[int],
           device) -> np.ndarray:
    mc, gc, sgc = (int(costs["mismatch_cost"]), int(costs["gap_cost"]),
                   int(costs["start_gap_cost"]))
    P = len(a_list)
    la = np.array([len(x) for x in a_list], np.int64)
    lb = np.array([len(x) for x in b_list], np.int64)
    ma, mb = int(la.max(initial=0)), int(lb.max(initial=0))
    a_pad = np.zeros((P, max(ma, 1)), np.int16) - 1  # pads match nothing
    b_pad = np.zeros((P, max(mb, 1)), np.int16) - 2
    for p in range(P):
        a_pad[p, :la[p]] = a_list[p]
        b_pad[p, :lb[p]] = b_list[p]
    A = torch.from_numpy(a_pad).to(device)
    B = torch.from_numpy(b_pad).to(device)
    a_len = torch.from_numpy(la).to(device)
    b_len = torch.from_numpy(lb).to(device)
    j = torch.arange(ma + 1, device=device, dtype=torch.int64)
    D = (j * gc + sgc).expand(P, ma + 1).clone()
    D[:, 0] = 0
    V = torch.full_like(D, _INF)
    if band is not None:
        D = torch.where(j[None, :] > band, _INF, D)
    dist = D.gather(1, a_len[:, None])[:, 0]
    for i in range(1, mb + 1):
        S = D[:, :-1] + mc * (A != B[:, i - 1: i])
        V = torch.minimum(D + (sgc + gc), V + gc).clamp_max(_INF)
        T = torch.empty_like(D)
        T[:, 0] = i * gc + sgc
        T[:, 1:] = torch.minimum(S, V[:, 1:])
        if band is not None:
            centre = (i * a_len) // torch.clamp(b_len, min=1)
            out = (j[None, :] - centre[:, None]).abs() > band
            T = torch.where(out, _INF, T)
        C = torch.cummin(T - gc * j, dim=1).values
        D = T.clone()
        D[:, 1:] = torch.minimum(T[:, 1:], sgc + gc * j[1:] + C[:, :-1])
        D = D.clamp_max(_INF)
        if band is not None:
            D = torch.where(out, _INF, D)
        dist = torch.where(b_len == i, D.gather(1, a_len[:, None])[:, 0],
                           dist)
    return dist.cpu().numpy().astype(np.int64)


def gap_affine_distances(a_list: Sequence[np.ndarray],
                         b_list: Sequence[np.ndarray], costs: dict, *,
                         device="cpu", block: int = 256,
                         band: Optional[int] = None) -> np.ndarray:
    """The crate's gap-affine distance of every pair (no threshold), int64,
    computed `block` pairs at a time on `device`.  Transpositions are not
    part of this reference."""
    if costs.get("transpose_cost"):
        raise ValueError("the reference has no transpositions")
    a_s, b_s = [], []
    for a, b in zip(a_list, b_list):
        a = np.asarray(a, np.uint8)
        b = np.asarray(b, np.uint8)
        if len(a) > len(b):  # rows over the longer string, as the crate
            a, b = b, a
        a_s.append(a)
        b_s.append(b)
    out = [_block(a_s[lo: lo + block], b_s[lo: lo + block], costs, band,
                  device) for lo in range(0, len(a_s), block)]
    return np.concatenate(out) if out else np.empty(0, np.int64)
