"""Seeded inputs of the sparse gather check, in numpy alone.

One generator for the port's gather check, shared by its CPU tests
(``tests/test_torch_check_gather.py``), its card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py``'s ``[compare-gather]``
phase, so that the smoke holds the kernel against its plain version on the
very arrays the card tests use.
"""

import numpy as np

EXTREMES = [0, 1, -1, 2**31, -(2**31), 2**32, -(2**32), 2**62, -(2**62),
            2**63 - 1, -(2**63), 123456789012345, -987654321098765]

#: the (K, R) ladder of the gather cells
LADDER = tuple((K, R) for K in (4, 32, 64, 2048) for R in (3, 8, 16, 20))
#: cells past 32 dims, where a record's per-dim masks take two words
WIDE = ((32, 33), (64, 40))


def gather_cell(K: int, R: int, card: bool = False):
    """((P, K, T, R), seed) of the gather cell for K and R: a few pods on
    the CPU, thousands on the card; T at least 2K so every pod can fill its
    K slots with distinct cols."""
    if K == 2048:
        P, T = (200 if card else 24), 2500
    else:
        P, T = (3000 if card else 96), max(2 * K, 64)
    return (P, K, T, R), K * 100 + R


def gather_arrays(rng, P, K, T, R, extremes=False):
    """Seeded raw arrays of the gather check: ThrottleState fields, PodBatch
    fields and [P,K] cols (sorted real cols then -1 pads, some cols of T
    and T + 3; invalid rows and pods). Odd dims carry values past 2^32;
    with ``extremes`` every int64 plane is drawn from the int64 extremes,
    so used + res + pod wraps."""
    scale = np.where(np.arange(R) % 2 == 1, 2**33, 1).astype(np.int64)
    ext = np.array(EXTREMES, dtype=np.int64)
    u = lambda *s: rng.random(s)  # noqa: E731

    def ints(hi, *shape):
        if extremes:
            return rng.choice(ext, shape)
        v = rng.integers(0, hi, shape)
        return v * scale if len(shape) == 2 else v

    state = dict(
        valid=u(T) < 0.85, thr_cnt=ints(60, T), thr_cnt_present=u(T) < 0.5,
        thr_req=ints(2000, T, R), thr_req_present=u(T, R) < 0.7,
        used_cnt=ints(60, T), used_cnt_present=u(T) < 0.8,
        used_req=ints(2200, T, R), used_req_present=u(T, R) < 0.8,
        res_cnt=ints(3, T), res_cnt_present=u(T) < 0.3,
        res_req=ints(200, T, R), res_req_present=u(T, R) < 0.3,
        st_cnt_throttled=u(T) < 0.03, st_req_throttled=u(T, R) < 0.05,
        st_req_flag_present=u(T, R) < 0.5,
    )
    # about 4 requested dims at most, so that wide R leaves slots that fit
    pods = dict(valid=u(P) < 0.9, req=ints(1000, P, R), req_present=u(P, R) < min(0.7, 4 / R))
    cols = np.full((P, K), -1, dtype=np.int32)
    n = rng.integers(0, min(K, T) + 1, P)
    for p in range(P):
        cols[p, : n[p]] = np.sort(rng.choice(T, n[p], replace=False))
    cols[::7, 0] = T
    cols[3::7, -1] = T + 3
    return state, pods, cols
