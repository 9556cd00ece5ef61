"""Bit-parallel banded Levenshtein distance (unit costs): kernel K1.

Counterpart of the JAX package's ops/pallas/lev_myers.py.  One module holds
the plan, the host prep, the plain PyTorch version, the wrapper of the CUDA
kernel (csrc/myers_distance.cu) with its launch counter, and the bridge
from the JAX package's input layout.

The function (the same the TPU kernel `lev_myers.py:_make_kernel` computes):
for every pair (a, b) with len(a) <= len(b) and a per-pair threshold
k_pair, the unit-cost Levenshtein distance restricted to the asymmetric
band j - i in [-ukL, Wp - 1 - ukL], ukL = (k_pair - (len(b) - len(a))) // 2,
as a Myers bit-vector wavefront: row i holds the horizontal deltas of Wp
columns, out-of-band deltas shifted in at the top are +1, virtual columns
j <= 0 force both deltas to +1 after clearing Eq, the score is anchored at
the window's left edge and row m is read out with a masked popcount.
Exact wherever the true distance is <= k_pair, never below the truth
otherwise.

What bounds the kernel on an H100 is integer operations, not bytes (see
the note at the top of csrc/myers_distance.cu); the window is Wp = 64 * NW
bits, NW in {1, 2, 3}, so the plan covers k <= 191.  The kernel runs the
window as 2 * NW words of 32 bits, one pair a thread, the window's match
masks a ring in shared memory.

Layout (the port's own, pair order, no grouping): `a_t` uint8
[B, max_m16], `b_t` uint8 [B, max_m16 + Wp] with each pair's b at byte
offset ukL and 0 pads, `m`, `dlen`, `ukl` int32 [B]; max_m16 is max_m
rounded up to 16 so a thread loads 16 rows' characters at once.  Pads
carry no sentinel: a 0 pad may equal a real NUL character, and the
virtual-column Eq clearing is what keeps that exact.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import bitwords as bw

__all__ = [
    "WORD",
    "MAX_NW",
    "myers_plan",
    "prepare_myers_inputs",
    "myers_distance",
    "myers_distance_plain",
    "from_reference_batch",
]

WORD = 64  # DP cells per kernel word
MAX_NW = 3  # words per band: k + 1 <= 192


def myers_plan(k: int) -> Optional[Tuple[int, int]]:
    """(NW words, Wp = 64 * NW window bits) for threshold k; None when the
    k + 1 band exceeds the kernel's three words (k > 191)."""
    if k < 0:
        return None
    nw = max(-(-(k + 1) // WORD), 1)
    if nw > MAX_NW:
        return None
    return nw, nw * WORD


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def prepare_myers_inputs(a_list: Sequence[np.ndarray],
                         b_list: Sequence[np.ndarray], k: int, max_m: int,
                         ks=None, *, device):
    """Pack a batch (len(a) <= len(b) <= len(a) + k_pair per pair) into the
    kernel's tensors on `device`.

    `ks` optionally gives a per-pair threshold <= k (defaults to k); the
    pair's band is ukL = (k_pair - delta) // 2 columns left of the diagonal
    and the rest of the window right of it.

    Returns (a_t, b_t, m, dlen, ukl): uint8 [B, max_m16], uint8
    [B, max_m16 + Wp], int32 [B] x 3, all in pair order.
    """
    plan = myers_plan(k)
    if plan is None:
        raise ValueError(f"k={k} exceeds the Myers distance plan (k <= 191)")
    _, wp = plan
    B = len(a_list)
    mm = _round_up(max(max_m, 1), 16)
    a_rows = np.zeros((B, mm), dtype=np.uint8)
    b_rows = np.zeros((B, mm + wp), dtype=np.uint8)
    la = np.fromiter((len(x) for x in a_list), np.int64, B)
    lb = np.fromiter((len(x) for x in b_list), np.int64, B)
    kp = (np.full(B, k, np.int64) if ks is None
          else np.minimum(np.asarray(ks, np.int64)[:B], k))
    delta = lb - la
    if not np.all((0 <= delta) & (delta <= kp) & (la <= max_m)):
        raise ValueError(
            "every pair needs len(a) <= len(b) <= len(a) + k_pair and "
            "len(a) <= max_m")
    u_l = (kp - delta) // 2
    # contiguous per-pair row writes: a fancy-index scatter of every char
    # would build index arrays several times the size of the strings
    for p, (a, b, off) in enumerate(zip(a_list, b_list, u_l.tolist())):
        a_rows[p, :len(a)] = a
        b_rows[p, off:off + len(b)] = b
    dev = torch.device(device)
    return (
        torch.from_numpy(a_rows).to(dev),
        torch.from_numpy(b_rows).to(dev),
        torch.from_numpy(la.astype(np.int32)).to(dev),
        torch.from_numpy(delta.astype(np.int32)).to(dev),
        torch.from_numpy(u_l.astype(np.int32)).to(dev),
    )


def from_reference_batch(a_t: np.ndarray, b_t: np.ndarray, m: np.ndarray,
                         dlen: np.ndarray, ukl: np.ndarray, *, k: int,
                         max_m: int, device):
    """Bridge from the JAX package's upload layout to the port's.

    Takes the numpy arrays `lev_myers.prepare_myers_inputs` returns —
    row-major `a_t` [G, BG, max_m] and `b_t` [G, BG, max_m + WIN] uint8 (b
    already at its ukL byte offset), `m`/`dlen`/`ukl` [8, BG] int32 expanded
    onto SG = 8 // G subgroup rows — and returns
    ((a_t, b_t, m, dlen, ukl) in the port's layout on `device`, decode),
    where decode(dist) reorders the [G * BG] results to the JAX package's
    pair order (pair p at [u, g*128 + lane], p = (g*G + u)*128 + lane);
    the caller keeps the first B.
    """
    plan = myers_plan(k)
    if plan is None:
        raise ValueError(f"k={k} exceeds the Myers distance plan (k <= 191)")
    _, wp = plan
    G, BG = a_t.shape[0], a_t.shape[1]
    sg = 8 // G
    mm = _round_up(max(max_m, 1), 16)
    a_rows = np.zeros((G * BG, mm), dtype=np.uint8)
    a_rows[:, :max_m] = np.asarray(a_t).reshape(G * BG, max_m)
    b_src = np.asarray(b_t).reshape(G * BG, -1)
    b_rows = np.zeros((G * BG, mm + wp), dtype=np.uint8)
    w = min(b_src.shape[1], b_rows.shape[1])
    if b_src[:, w:].any():
        raise ValueError("reference b rows do not fit the port's window")
    b_rows[:, :w] = b_src[:, :w]

    def per_pair(x):
        return np.ascontiguousarray(
            np.asarray(x)[::sg][:G].reshape(G * BG).astype(np.int32))

    dev = torch.device(device)
    tensors = tuple(
        torch.from_numpy(x).to(dev)
        for x in (a_rows, b_rows, per_pair(m), per_pair(dlen), per_pair(ukl))
    )

    def decode(dist) -> np.ndarray:
        d = np.asarray(dist.cpu() if isinstance(dist, torch.Tensor) else dist)
        d = d.reshape(G, BG // 128, 128)
        return np.transpose(d, (1, 0, 2)).reshape(-1)

    return tensors, decode


def _check_inputs(a_t, b_t, m, dlen, ukl, k: int) -> Tuple[int, int]:
    plan = myers_plan(k)
    if plan is None:
        raise ValueError(f"k={k} exceeds the Myers distance plan (k <= 191)")
    nw, wp = plan
    B = a_t.shape[0]
    if a_t.dtype != torch.uint8 or b_t.dtype != torch.uint8:
        raise TypeError("a_t and b_t must be uint8")
    if a_t.dim() != 2 or b_t.dim() != 2 or b_t.shape[0] != B:
        raise ValueError("a_t and b_t must be [B, len] with the same B")
    if a_t.shape[1] % 16 or b_t.shape[1] != a_t.shape[1] + wp:
        raise ValueError(
            "row lengths must be max_m16 (a multiple of 16) and "
            f"max_m16 + {wp}")
    for t in (m, dlen, ukl):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError("m, dlen, ukl must be int32 [B]")
    devs = {t.device for t in (a_t, b_t, m, dlen, ukl)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    return nw, wp


def myers_distance_plain(a_t: torch.Tensor, b_t: torch.Tensor,
                         m: torch.Tensor, dlen: torch.Tensor,
                         ukl: torch.Tensor, *, k: int) -> torch.Tensor:
    """Plain PyTorch version of kernel K1: the same recurrence, vectorised
    over the batch, a Python loop over the rows.  int32 [B]."""
    nw, wp = _check_inputs(a_t, b_t, m, dlen, ukl, k)
    nw32 = wp // bw.WORD32
    B = a_t.shape[0]
    dev = a_t.device
    m64 = m.to(torch.int64)
    ukl64 = ukl.to(torch.int64)
    dlen64 = dlen.to(torch.int64)
    woff = bw.WORD32 * torch.arange(nw32, dtype=torch.int64, device=dev)

    Ph = torch.full((B, nw32), bw.M32, dtype=torch.int64, device=dev)
    Mh = torch.zeros((B, nw32), dtype=torch.int64, device=dev)
    A = -ukl64 - 1  # A_0 = D[0, -ukL-1] on the virtual row 0
    rP, rM, rA = Ph.clone(), Mh.clone(), A.clone()  # latched at i == m
    rows = int(m64.max()) if B else 0
    for i in range(1, rows + 1):
        r0 = i - 1
        Eq = bw.pack_bits(b_t[:, r0:r0 + wp] == a_t[:, r0:r0 + 1])
        # anchor: A_i = D[i, i-ukL-1] = D[i-1, (i-1)-ukL] + 1
        A = A + (Ph[:, 0] & 1) - (Mh[:, 0] & 1) + 1
        PhI = bw.shr1(Ph, 1)
        MhI = bw.shr1(Mh, 0)
        # virtual columns j <= 0  <->  bits p <= ukL - i: clear Eq FIRST
        # (a 0 pad can equal a real NUL character), then force the deltas
        vmask = bw.low_mask(ukl64[:, None] + 1 - i - woff[None, :])
        nvmask = bw.bnot(vmask)
        Eq = Eq & nvmask
        Xh = Eq | MhI
        X = (bw.add_words(Eq & PhI, PhI) ^ PhI) | Eq
        Pv = (MhI | bw.bnot(X | PhI)) | vmask
        Mv = (PhI & X) & nvmask
        PvS = bw.shl1(Pv, 1)
        MvS = bw.shl1(Mv, 0)
        Ph = (MvS | bw.bnot(Xh | PvS)) | vmask
        Mh = (PvS & Xh) & nvmask
        at_m = m64 == i
        rP = torch.where(at_m[:, None], Ph, rP)
        rM = torch.where(at_m[:, None], Mh, rM)
        rA = torch.where(at_m, A, rA)
    # D[m, n] = A_m + sum of dh[m] over bits p in [0, dlen + ukL]
    sel = bw.low_mask((dlen64 + ukl64 + 1)[:, None] - woff[None, :])
    pops = bw.popcount32(rP & sel) - bw.popcount32(rM & sel)
    return (rA + pops.sum(dim=1)).to(torch.int32)


def myers_distance(a_t: torch.Tensor, b_t: torch.Tensor, m: torch.Tensor,
                   dlen: torch.Tensor, ukl: torch.Tensor, *,
                   k: int) -> torch.Tensor:
    """Banded unit-cost distances, int32 [B] in pair order.

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch in `myers_distance.launches`; a build or launch
    failure raises.  CPU tensors — and only those — take the plain PyTorch
    version.
    """
    nw, _ = _check_inputs(a_t, b_t, m, dlen, ukl, k)
    if a_t.device.type == "cpu":
        return myers_distance_plain(a_t, b_t, m, dlen, ukl, k=k)
    if a_t.device.type != "cuda":
        raise ValueError(f"unsupported device {a_t.device}")
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    tensors = [t.contiguous() for t in (a_t, b_t, m, dlen, ukl)]
    for t in tensors[:2]:
        if t.data_ptr() % 16:
            raise ValueError("string buffers must be 16-byte aligned")
    B = a_t.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=a_t.device)
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ta_myers_distance(
            *(t.data_ptr() for t in tensors), out.data_ptr(), B,
            tensors[0].shape[1], tensors[1].shape[1], nw, stream,
        )
    check_launch(lib, code, "myers_distance")
    if B:
        myers_distance.launches += 1
    return out


myers_distance.launches = 0
