"""The CUDA kernels' bodies, compiled for the host, against their plain
PyTorch versions and the oracle.

`csrc/myers_distance.cu` and `csrc/myers_search.cu` keep their per-pair and
per-segment code in plain functions that also compile with a host C++
compiler (`-DTA_HOST_REHEARSAL`); `csrc/host_rehearsal.cpp` wraps them in a
C interface that runs one "thread" at a time.  So the arithmetic the card
runs is checked here, where no CUDA compiler exists: integer results, exact
equality with the plain versions (the code the kernels are held against on
the card), and the band / halo contract against the oracle.  What this
cannot see is what only the device build has: the launch geometry, the
shared-memory layout across threads and the vector load/store instructions.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from triple_accel_tpu_torch.ops import myers_distance as md
from triple_accel_tpu_torch.ops import myers_search as ms
from triple_accel_tpu_torch.ops.search_common import seg_count, window_span
from triple_accel_tpu_torch.oracle import (
    levenshtein_naive_k_with_opts,
    levenshtein_search_naive_with_opts,
)
from triple_accel_tpu_torch.types import (
    LEVENSHTEIN_COSTS,
    RDAMERAU_COSTS,
    SearchType,
)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "triple_accel_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    so = str(tmp_path_factory.mktemp("rehearsal") / "libta_rehearsal.so")
    res = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
         os.path.join(CSRC, "host_rehearsal.cpp"), "-o", so],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(so)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ta_rehearse_distance.restype = ctypes.c_int
    lib.ta_rehearse_distance.argtypes = [vp] * 6 + [i64, i64, i64, i32]
    lib.ta_rehearse_search.restype = ctypes.c_int
    lib.ta_rehearse_search.argtypes = [
        vp, i64, vp, i32, i32, i64, i64, i64, i32, i32, vp, i64]
    return lib


def _pairs(rng, n_pairs, max_m, k, nul):
    a_list, b_list = [], []
    while len(a_list) < n_pairs:
        m = int(rng.integers(0, max_m + 1))
        a = rng.integers(65, 70, m).astype(np.uint8)
        if nul and m:
            a[rng.integers(0, m, 2)] = 0  # NUL chars: pads are 0 too
        b = list(a)
        for _ in range(int(rng.integers(0, max(k, 1) * 2))):
            op = rng.integers(0, 3)
            if op == 0 and b:
                b[rng.integers(0, len(b))] = rng.integers(65, 70)
            elif op == 1:
                b.insert(int(rng.integers(0, len(b) + 1)),
                         int(rng.integers(65, 70)))
            elif op == 2 and b:
                del b[rng.integers(0, len(b))]
        b = np.array(b, dtype=np.uint8)
        if len(a) > len(b):
            a, b = b, a
        if len(b) - len(a) > k or len(a) > max_m:
            continue
        a_list.append(a)
        b_list.append(b)
    a_list[0] = b_list[0] = np.empty(0, np.uint8)  # the empty pair
    return a_list, b_list


# thresholds at both sides of every word boundary of the band (k + 1 = 64,
# 128, 192) and the widest the plan holds
@pytest.mark.parametrize("k,max_m", [
    (0, 16), (4, 16), (32, 64), (63, 64), (64, 64), (127, 64), (128, 48),
    (159, 32), (191, 200),
])
@pytest.mark.parametrize("nul", [False, True], ids=["plainchars", "nul"])
def test_distance_body_equals_plain_version_and_oracle(lib, k, max_m, nul):
    rng = np.random.default_rng(1000 * k + max_m + int(nul))
    a_list, b_list = _pairs(rng, 60, max_m, k, nul)
    ks = np.maximum(rng.integers(0, k + 1, len(a_list)),
                    [len(b) - len(a) for a, b in zip(a_list, b_list)])
    exp = [levenshtein_naive_k_with_opts(a, b, 10**9, False)[0]
           for a, b in zip(a_list, b_list)]
    for per_pair in (None, ks):
        t = md.prepare_myers_inputs(a_list, b_list, k, max_m, ks=per_pair,
                                    device="cpu")
        plain = md.myers_distance_plain(*t, k=k).numpy()
        arrs = [x.numpy() for x in t]
        out = np.full(len(a_list), -7, np.int32)
        rc = lib.ta_rehearse_distance(
            *[x.ctypes.data for x in arrs], out.ctypes.data, len(a_list),
            arrs[0].shape[1], arrs[1].shape[1], md.myers_plan(k)[0])
        assert rc == 0
        assert np.array_equal(out, plain)
        for p, (g, e) in enumerate(zip(out, exp)):
            kp = k if per_pair is None else int(per_pair[p])
            assert g >= e, f"pair {p}: {g} below the truth {e}"
            assert (g == e) if e <= kp else (g > kp), (p, g, e, kp)


# needle lengths at both sides of the 64-bit word boundaries, one in the
# many-word kernel; own_len not a multiple of 4 exercises the scalar edges
# of the four-column stores
@pytest.mark.parametrize("m", [1, 5, 24, 64, 65, 128, 130, 700])
@pytest.mark.parametrize("damerau", [False, True], ids=["unit", "rdamerau"])
@pytest.mark.parametrize("anchored", [False, True],
                         ids=["unanchored", "anchored"])
def test_search_body_equals_plain_version_and_oracle(lib, m, damerau,
                                                     anchored):
    rng = np.random.default_rng(7 * m + 2 * int(damerau) + int(anchored))
    costs = RDAMERAU_COSTS if damerau else LEVENSHTEIN_COSTS
    k = min(m, 6)
    for own_choice in (13, 64, 250):
        n = int(rng.integers(0, 400)) if m < 200 else 900
        needles = np.stack([rng.integers(65, 69, m).astype(np.uint8)
                            for _ in range(2)])
        needles[0, rng.integers(0, m)] = 0  # a NUL needle byte ...
        hay = rng.integers(65, 69, n).astype(np.uint8)
        if n:
            hay[0] = 0  # ... against a haystack that starts with NUL
        if n > m + 5:
            hay[3: 3 + m] = needles[1]
            if m > 4:  # one transposition inside the planted copy
                hay[4], hay[5] = hay[5], hay[4]
        if anchored:
            it, halo = min(m + k, n), 0
            own = max(it, 1)
        else:
            it, halo, own = n, min(window_span(m, k, 1, 0), n), own_choice
        h = hay[:it].copy()
        plain = ms.myers_search_plain(
            torch.from_numpy(h), torch.from_numpy(needles), own_len=own,
            halo=halo, anchored=anchored, damerau=damerau).numpy()
        stride = -(-(it + 1) // 4) * 4
        out = np.full((2, stride), -7, np.int32)
        rc = lib.ta_rehearse_search(
            h.ctypes.data, it, needles.ctypes.data, 2, m, own, halo,
            seg_count(it, own), int(anchored), int(damerau),
            out.ctypes.data, stride)
        assert rc == 0
        assert np.array_equal(out[:, : it + 1], plain)
        assert (out[:, it + 1:] == -7).all()  # pad columns stay unwritten
        for i in range(2):
            ref = {mt.end: mt.k for mt in levenshtein_search_naive_with_opts(
                needles[i], hay, k, SearchType.All, costs, anchored)}
            got = {j: int(out[i, j]) for j in range(it + 1)
                   if out[i, j] <= k}
            assert got == ref
