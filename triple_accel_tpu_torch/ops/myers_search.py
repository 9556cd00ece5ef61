"""Bit-parallel approximate search (unit / restricted-Damerau): kernel K2.

Counterpart of the JAX package's ops/pallas/search_myers.py, subgroup
engine only.  One module holds the plan, the needle prep, the plain PyTorch
version, the wrapper of the CUDA kernel (csrc/myers_search.cu) with its
launch counter, the hit collection, and the bridge from the JAX package's
needle layout.

The function (the same the TPU kernel `search_myers.py:_make_kernel`
computes): the column-oriented Myers bit-vector search, D[m][j] = the
least cost of matching the whole needle against a haystack substring that
ends after j characters (unanchored: starting anywhere; anchored: starting
at 0), for unit costs or with the restricted-Damerau transposition seed.
The haystack is cut into segments: segment c owns the end positions
(c*own_len, (c+1)*own_len] (segment 0 also owns 0), starts `halo` bytes
before its first owned column — or at byte 0 if that comes later — with a
fresh state, and emits only owned columns.  With halo >= the widest window
a cost-<=k match can span, every value <= k is exact and no value is below
the truth.  The kernel reads the RAW haystack: no halo-duplicated windows
are built, and segment 0 sees no synthetic pad bytes.

Output: int32 [num, iter_len + 1] in plain global order.  On an H100 bytes
bound the function for needles of up to 32 chars, operations beyond.  The
kernel (csrc/myers_search.cu) runs a segment a lane in 32-bit words, a
warp's lanes in lockstep over 16-byte chunks, and stages its scores in
shared memory so they leave in whole 64-byte runs; the plan here gives it
a halo on a sector edge (`search_halo`) and owned lengths that are whole
sectors (`suggest_own_len`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import bitwords as bw
from .search_common import seg_count

__all__ = [
    "WORD",
    "WORD_CHOICES",
    "MAX_NW",
    "MAX_NEEDLE",
    "WARPS",
    "ROUTE_MAX_NEEDLE",
    "myers_search_plan",
    "search_halo",
    "suggest_own_len",
    "prepare_myers_needles",
    "from_reference_needles",
    "myers_search",
    "myers_search_plain",
    "collect_hits",
]

WORD = 32
# 32-bit words a lane the kernel is built for; a needle takes the fewest
# that hold it (words past the needle are rows no lower row sees)
WORD_CHOICES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 40)
MAX_NW = WORD_CHOICES[-1]
MAX_NEEDLE = MAX_NW * WORD  # 1280 chars, the TPU kernel's ceiling too
# Warps a block (the segments of a block share the needle's table).
# benches/search_sweep.py, 128 MiB, needle 24, k = 3, halo 32, own_len
# 2048 (NVIDIA H100 80GB HBM3, 700 W), unit / rDamerau ms: 2 warps 0.3774
# / 0.3819, 4: 0.3774 / 0.3611, 8: 0.3691 / 0.4184.
WARPS = 4
# The longest needle the search dispatch gives K2 rather than K6
# (ops/myers_chunked.py), by cost model (False: unit, True: rDamerau).
# benches/search_sweep.py --long, 16 MiB ACGT at k = m / 8, each kernel at
# its own plan (NVIDIA H100 80GB HBM3, 700 W), K2 against K6 in ms: unit
# 320 chars 0.7775 / 0.8155, 352: 0.8081 / 0.8435, 384: 0.8964 / 0.8647,
# 448: 1.2765 / 0.923; rDamerau 288: 0.9116 / 0.9273, 320: 0.9975 /
# 0.9884, 352: 1.1284 / 0.9227.  K2 itself takes needles up to
# MAX_NEEDLE.
ROUTE_MAX_NEEDLE = {False: 352, True: 288}

# Segments wanted on a large haystack: about 16 warps an SM.
# benches/search_sweep.py at 128 MiB (needle 24, k = 3, halo 32, 4 warps
# a block; NVIDIA H100 80GB HBM3, 700 W), unit / rDamerau ms by own_len:
# 1024 (128 Ki segments) 0.4095 / 0.4437, 2048 (64 Ki) 0.3774 / 0.3611,
# 4096 (32 Ki) 0.4167 / 0.4619.  Measured at that one haystack size; for
# others the count is an extrapolation.
_TARGET_SEGMENTS = 64 * 1024


def myers_search_plan(needle_len: int) -> Optional[Tuple[int]]:
    """(NW 32-bit words,) the kernel runs a needle of `needle_len` chars
    with; None when the needle is empty or longer than 1280 chars."""
    if needle_len < 1 or needle_len > MAX_NEEDLE:
        return None
    need = -(-needle_len // WORD)
    return (next(w for w in WORD_CHOICES if w >= need),)


def search_halo(span: int, iter_len: int) -> int:
    """Warm-up bytes before a segment's first owned column: the widest
    window a cost-<=k match can span, rounded up to 32 (with an owned
    length that is a multiple of 32, every segment then starts on the
    32-byte sector the kernel loads), at most the haystack.  Any halo at
    or above the span is exact.  The JAX package's quantum of 256 only
    re-reads more: benches/search_sweep.py, 128 MiB, needle 24, k = 3,
    own_len 2048, 4 warps (NVIDIA H100 80GB HBM3, 700 W), unit /
    rDamerau ms: halo 32 0.3774 / 0.3611, halo 256 0.4205 / 0.4019."""
    return min(-(-span // 32) * 32, iter_len)


def suggest_own_len(iter_len: int, halo: int) -> int:
    """Owned end positions per segment: about `_TARGET_SEGMENTS` segments
    on a large haystack (128 MiB: 2048), while the halo re-read stays
    under an eighth of the owned length; a multiple of 32 (whole sectors),
    at least 256."""
    per_target = -(-max(iter_len, 1) // _TARGET_SEGMENTS)
    own = max(per_target, 8 * halo, 256)
    return -(-own // 32) * 32


def prepare_myers_needles(needles: Sequence[np.ndarray], needle_len: int, *,
                          device) -> torch.Tensor:
    """Stack same-length needles into uint8 [num, needle_len] on `device`
    (any length: the host prep of K2 and of K6, ops/myers_chunked.py)."""
    if needle_len < 1:
        raise ValueError("needle length must be >= 1")
    arr = np.zeros((len(needles), needle_len), dtype=np.uint8)
    for i, nd in enumerate(needles):
        nd = np.asarray(nd, dtype=np.uint8)
        if nd.shape != (needle_len,):
            raise ValueError("every needle must have needle_len chars")
        arr[i] = nd
    return torch.from_numpy(arr).to(torch.device(device))


def from_reference_needles(nchar: np.ndarray, needle_len: int) -> np.ndarray:
    """Bridge from the JAX package's needle layout: `nchar` is
    `search_myers.prepare_myers_needles`' [num * WINP, 128] int32 array
    (needle chars on rows, -1 padded, replicated across the 128 lanes,
    WINP = needle_len rounded up to 8).  Returns uint8 [num, needle_len]
    for `prepare_myers_needles`."""
    winp = -(-max(needle_len, 1) // 8) * 8
    nchar = np.asarray(nchar)
    num = nchar.shape[0] // winp
    chars = nchar.reshape(num, winp, -1)[:, :needle_len, 0]
    if (chars < 0).any() or (chars > 255).any():
        raise ValueError("reference needle rows hold pad values")
    return chars.astype(np.uint8)


def _check_inputs(hay, needles, own_len: int, halo: int,
                  anchored: bool) -> int:
    if hay.dtype != torch.uint8 or hay.dim() != 1:
        raise TypeError("hay must be uint8 [iter_len]")
    if needles.dtype != torch.uint8 or needles.dim() != 2:
        raise TypeError("needles must be uint8 [num, m]")
    if needles.device != hay.device:
        raise ValueError("hay and needles lie on different devices")
    m = needles.shape[1]
    if m < 1:
        raise ValueError("needle length must be >= 1")
    if own_len < 1 or halo < 0:
        raise ValueError("own_len must be >= 1 and halo >= 0")
    if anchored and (halo != 0 or own_len < hay.shape[0]):
        raise ValueError("an anchored search runs as ONE segment, halo 0")
    return m


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """`x` contiguous at a 16-byte aligned address (the kernels read it 16
    bytes at a time): a copy where the given view is not."""
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # a fresh allocation is aligned
    if x.data_ptr() % 16:
        raise ValueError("buffer must be 16-byte aligned")
    return x


def _peq_table(needles: torch.Tensor, nw32: int) -> torch.Tensor:
    """Peq[num, 256, nw32] int64: bit t of word w of entry (i, ch) is set
    iff needles[i, 32 * w + t] == ch."""
    num, m = needles.shape
    nd = needles.cpu().numpy()
    peq = np.zeros((num, 256, nw32), dtype=np.int64)
    t = np.arange(m)
    for i in range(num):
        np.bitwise_or.at(
            peq[i], (nd[i], t // bw.WORD32),
            np.int64(1) << (t % bw.WORD32).astype(np.int64))
    return torch.from_numpy(peq).to(needles.device)


def myers_search_plain(hay: torch.Tensor, needles: torch.Tensor, *,
                       own_len: int, halo: int, anchored: bool = False,
                       damerau: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernels K2 and K6 (any needle length): the
    same recurrence and the same segmentation, vectorised over (needle,
    segment), a Python loop over the halo + own_len columns of a segment,
    from the first column any segment reads.  int32 [num, iter_len + 1]."""
    m = _check_inputs(hay, needles, own_len, halo, anchored)
    dev = hay.device
    n = hay.shape[0]
    num = needles.shape[0]
    nw32 = -(-m // bw.WORD32)
    wS, offS = (m - 1) // bw.WORD32, (m - 1) % bw.WORD32
    C = seg_count(n, own_len)
    peq = _peq_table(needles, nw32)
    hay64 = hay.to(torch.int64)
    own0 = own_len * torch.arange(C, dtype=torch.int64, device=dev)

    shape = (num, C, nw32)
    Pv = torch.full(shape, bw.M32, dtype=torch.int64, device=dev)
    Mv = torch.zeros(shape, dtype=torch.int64, device=dev)
    EqP = torch.zeros(shape, dtype=torch.int64, device=dev)
    D0P = torch.zeros(shape, dtype=torch.int64, device=dev)
    S = torch.full((num, C), m, dtype=torch.int64, device=dev)
    owned = torch.zeros((num, C, own_len), dtype=torch.int64, device=dev)

    steps = min(halo + own_len, halo + n) if n else 0
    # the last segment reads from its column halo - own0 + 1 on; no
    # segment reads before it (nor owns a column: owned ones are > halo)
    first = max(1, halo - own_len * (C - 1) + 1)
    for t in range(first, steps + 1):
        jb = own0 - halo + (t - 1)  # byte index read by local column t
        active = (jb >= 0) & (jb < n)
        ch = hay64[jb.clamp(0, n - 1)]
        Eq = peq[:, ch, :]  # [num, C, nw32]
        seeds = Eq
        if damerau:
            # a transposition at (i, t) seeds a zero diagonal when
            # p[i] = txt[t-1], p[i-1] = txt[t] and the previous column's
            # diagonal delta at row i-1 was +1
            seeds = Eq | (EqP & bw.shl1(Eq, 0) & bw.shl1(bw.bnot(D0P), 0))
        Xh = (bw.add_words(seeds & Pv, Pv) ^ Pv) | seeds
        Ph = Mv | bw.bnot(Xh | Pv)
        Mh = Pv & Xh
        S_new = S + ((Ph[..., wS] >> offS) & 1) - ((Mh[..., wS] >> offS) & 1)
        PhS = bw.shl1(Ph, 1 if anchored else 0)
        MhS = bw.shl1(Mh, 0)
        D0 = (Xh | Mv) if damerau else (Eq | Mv)  # Mv: previous column's VN
        Pv_new = MhS | bw.bnot(D0 | PhS)
        Mv_new = PhS & D0
        act = active[None, :, None]
        Pv = torch.where(act, Pv_new, Pv)
        Mv = torch.where(act, Mv_new, Mv)
        S = torch.where(active[None, :], S_new, S)
        if damerau:
            EqP = torch.where(act, Eq, EqP)
            D0P = torch.where(act, D0, D0P)
        if t > halo:
            owned[:, :, t - halo - 1] = S
    out = torch.empty((num, n + 1), dtype=torch.int32, device=dev)
    out[:, 0] = m  # D[m][0] = m, both modes
    out[:, 1:] = owned.reshape(num, C * own_len)[:, :n].to(torch.int32)
    return out


def myers_search(hay: torch.Tensor, needles: torch.Tensor, *, own_len: int,
                 halo: int, anchored: bool = False, damerau: bool = False,
                 warps: Optional[int] = None) -> torch.Tensor:
    """D[m][j] for every end position j in [0, len(hay)] of every needle,
    int32 [num, len(hay) + 1].

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch in `myers_search.launches`; a build or launch failure
    raises.  CPU tensors — and only those — take the plain PyTorch version.
    An anchored search must run as one segment (own_len >= len(hay),
    halo = 0).  Needles of 1..1280 chars: the kernel's shared-memory table
    stops there (ops/myers_chunked.py takes longer ones).  `warps`: warps
    a block (1..8; default `WARPS`), a launch-shape knob for sweeps.
    """
    m = _check_inputs(hay, needles, own_len, halo, anchored)
    plan = myers_search_plan(m)
    if plan is None:
        raise ValueError(f"needle length {m} outside [1, 1280]: "
                         "myers_chunked.blocked_search takes any length")
    warps = WARPS if warps is None else int(warps)
    if not 1 <= warps <= 8:
        raise ValueError(f"warps={warps} outside [1, 8]")
    n = hay.shape[0]
    if hay.device.type == "cpu":
        return myers_search_plain(hay, needles, own_len=own_len, halo=halo,
                                  anchored=anchored, damerau=damerau)
    if hay.device.type != "cuda":
        raise ValueError(f"unsupported device {hay.device}")
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    hay = _aligned(hay)
    needles = needles.contiguous()
    num = needles.shape[0]
    # rows padded to a multiple of 32 ints: the kernel stores 16-byte
    # pieces of 64-byte runs, and 128-byte aligned rows keep a run inside
    # one line; the pad columns are never written
    stride = -(-(n + 1) // 32) * 32
    out = torch.empty((num, stride), dtype=torch.int32, device=hay.device)
    with torch.cuda.device(hay.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ta_myers_search(
            hay.data_ptr(), n, needles.data_ptr(), num, m, own_len, halo,
            seg_count(n, own_len), int(anchored), int(damerau),
            out.data_ptr(), stride, plan[0], warps, stream,
        )
    check_launch(lib, code, "myers_search")
    if num:
        myers_search.launches += 1
    return out[:, : n + 1]


myers_search.launches = 0


def collect_hits(dist: torch.Tensor, k: int):
    """Decoded hits of a distance array: (needle index, global end
    position, distance) int64 numpy arrays for every position with
    distance <= k, sorted by (needle, end position).  Only the hits cross
    to the host."""
    ni, gpos = torch.nonzero(dist <= k, as_tuple=True)
    d = dist[ni, gpos]
    return (
        ni.cpu().numpy().astype(np.int64),
        gpos.cpu().numpy().astype(np.int64),
        d.cpu().numpy().astype(np.int64),
    )
