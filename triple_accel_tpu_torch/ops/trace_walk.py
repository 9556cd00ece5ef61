"""The traceback walk of traced band batches: kernel K10.

The JAX package walks every pair of a traced batch back from (m, n) to
(0, 0) over the band kernel's packed argmin codes in one jitted
`lax.scan` (triple_accel_tpu/ops/band_scan.py:189 `_walk_scan`, reached
by `walk_packed_traceback` and `band_trace_batch`): XLA code, no Pallas
kernel.  The port's plain version of that walk is
`band_scan.walk_packed_traceback`, a Python loop of small torch ops a
step; on the card `trace_walk` launches the hand-written kernel of
csrc/trace_walk.cu instead, one thread a pair.

Inputs are the band kernels' (ops/lev_band.py): codes int32 [B, rows,
ceil(W / 16)] (cell c of row i at bits 2 * (c % 16) of word c // 16 of row
i - 1), `a_t` uint8 [B, max_m], `b_t` uint8 [B, max_m + W] with each
pair's b at byte offset unit_k, `m`, `n` int32 [B].  The output is the
plain version's: (seq int8 [B, steps], steps), steps = 2 * max_m +
unit_k + 1, each row in reverse walk order (0 Match, 1 Mismatch, 2
consume-b, 3 consume-a, 4 Transpose, -1 past the walk's end), for
`band_scan.decode_walked_batch`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .band_scan import code_words, walk_packed_traceback, walk_steps

__all__ = ["trace_walk", "walk_steps"]


def _check_inputs(codes, a_t, b_t, m, n, unit_k: int) -> None:
    if unit_k < 0:
        raise ValueError(f"unit_k={unit_k} is negative")
    W = 2 * unit_k + 1
    if codes.dtype != torch.int32 or codes.dim() != 3:
        raise TypeError("codes must be int32 [B, rows, ceil(W / 16)]")
    if a_t.dtype != torch.uint8 or b_t.dtype != torch.uint8:
        raise TypeError("a_t and b_t must be uint8")
    B = codes.shape[0]
    if a_t.dim() != 2 or b_t.dim() != 2 or a_t.shape[0] != B \
            or b_t.shape[0] != B:
        raise ValueError("codes, a_t and b_t must hold the same B pairs")
    if codes.shape[1] < 1 or codes.shape[2] != code_words(W):
        raise ValueError(f"codes must hold >= 1 row of {code_words(W)} "
                         f"words at band {W}")
    if a_t.shape[1] < 1 or b_t.shape[1] != a_t.shape[1] + W:
        raise ValueError(f"row lengths must be max_m >= 1 and max_m + {W}")
    for t in (m, n):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError("m and n must be int32 [B]")
    devs = {t.device for t in (codes, a_t, b_t, m, n)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")


def _launch(codes, a_t, b_t, m, n, unit_k: int, steps: int) -> torch.Tensor:
    """Launch the CUDA walk; seq_t int8 [steps, B].  The kernel writes
    each warp's steps until the warp's longest walk ends; the -1 fill
    covers the rest."""
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    tensors = [t.contiguous() for t in (codes, a_t, b_t, m, n)]
    B, rows, wpr = codes.shape
    seq_t = torch.full((steps, B), -1, dtype=torch.int8, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ta_trace_walk(
            *(t.data_ptr() for t in tensors), seq_t.data_ptr(), B, rows,
            wpr, a_t.shape[1], b_t.shape[1], unit_k, steps, stream)
    check_launch(lib, code, "trace_walk")
    return seq_t


def trace_walk(codes: torch.Tensor, a_t: torch.Tensor, b_t: torch.Tensor,
               m: torch.Tensor, n: torch.Tensor, *,
               unit_k: int) -> Tuple[torch.Tensor, int]:
    """Walk every pair's traceback: (seq int8 [B, steps], steps), equal to
    `band_scan.walk_packed_traceback` on the same inputs.

    CUDA tensors launch the hand-written kernel (built at first use) and
    count one launch in `trace_walk.launches`; a build or launch failure
    raises.  The kernel writes the walks step-major, so that a warp's
    stores coalesce, and the result is transposed on the device.  CPU
    tensors — and only those — take the plain PyTorch version.
    """
    _check_inputs(codes, a_t, b_t, m, n, unit_k)
    steps = walk_steps(a_t.shape[1], unit_k)
    if codes.device.type == "cpu":
        return walk_packed_traceback(codes, a_t, b_t, m, n, unit_k=unit_k)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    seq_t = _launch(codes, a_t, b_t, m, n, unit_k, steps)
    if codes.shape[0]:
        trace_walk.launches += 1
    return seq_t.t().contiguous(), steps


trace_walk.launches = 0
