"""Port parity: ``check_dense`` (the CUDA port of ``pallas_check_pods``).

On the CPU the wrapper computes its plain version; these tests hold that
against the Pallas kernel in interpret mode (as tests/test_pallas_check.py
runs it) on the same grid, against JAX ``fast_check_pods`` at ragged
shapes, and at the int64 extremes. The CUDA kernel itself runs only on a
card: tests/test_torch_cuda.py holds it against the plain version there.
"""

import random

import numpy as np
import pytest
import torch

from kube_throttler_tpu.ops import DimRegistry, encode_pods, encode_throttle_state
from kube_throttler_tpu.ops.fastcheck import fast_check_pods, precompute_check_state
from kube_throttler_tpu.ops.pallas_check import BP, BT, pallas_check_pods
from kube_throttler_tpu.ops.schema import PodBatch as JPodBatch
from kube_throttler_tpu_torch.ops import check_dense as cd
from kube_throttler_tpu_torch.ops.schema import (
    check_precomp_from_arrays,
    pod_batch_from_arrays,
)

from tests.test_check_kernel import _build_objects
from tests.test_torch_ops import _arrays, _assert_same

EXTREMES = np.array(
    [0, 1, -1, 2**31, -(2**31), 2**32, -(2**32), 2**62, -(2**62),
     2**63 - 1, -(2**63), 123456789012345, -987654321098765],
    dtype=np.int64,
)


def _carry(jpre, jpods, device="cpu"):
    return (
        check_precomp_from_arrays(_arrays(jpre), device=device),
        pod_batch_from_arrays(_arrays(jpods), device=device),
    )


@pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
@pytest.mark.parametrize("on_equal", [False, True])
def test_matches_pallas_interpret(kind, on_equal):
    """The grid of test_pallas_check.test_pallas_matches_direct: one
    (BP, BT) block with a random FULL mask, bits over padded pod and
    throttle rows included."""
    rng = random.Random(5)
    throttles, reserved, pods = _build_objects(rng, n_throttles=60, n_pods=40, kind=kind)
    dims = DimRegistry()
    state = encode_throttle_state(throttles, dims, reserved=reserved, capacity=BT)
    batch = encode_pods(pods, dims, capacity=BP)
    mask = np.asarray(rng.choices([True, False], k=BP * BT)).reshape(BP, BT)
    step3 = True if kind == "throttle" else on_equal
    jpre = precompute_check_state(state)
    want = pallas_check_pods(
        jpre, batch, mask, on_equal=on_equal, step3_on_equal=step3, interpret=True
    )
    pre, pods_t = _carry(jpre, batch)
    launches = cd.launches
    got = cd.check_dense(pre, pods_t, torch.from_numpy(mask), on_equal=on_equal,
                         step3_on_equal=step3)
    _assert_same(got, want)
    assert cd.launches == launches  # CPU tensors take the plain version


@pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
@pytest.mark.parametrize("on_equal", [False, True])
@pytest.mark.parametrize("shape", [(37, 19), (5, 1), (1, 33)])
def test_matches_fast_check_ragged(kind, on_equal, shape):
    """Any P and T (the TPU kernel's multiple-of-block rule is not the
    port's): padded capacities past the live rows, ragged edges."""
    P, T = shape
    rng = random.Random(P * 100 + T)
    throttles, reserved, pods = _build_objects(
        rng, n_throttles=max(T - 2, 1), n_pods=max(P - 3, 1), kind=kind
    )
    dims = DimRegistry(capacity=4)
    state = encode_throttle_state(throttles, dims, reserved=reserved, capacity=T)
    batch = encode_pods(pods, dims, capacity=P)
    mask = np.random.default_rng(P + T).random((P, T)) < 0.6
    step3 = True if kind == "throttle" else on_equal
    jpre = precompute_check_state(state)
    want = fast_check_pods(jpre, batch, mask, on_equal=on_equal, step3_on_equal=step3)
    pre, pods_t = _carry(jpre, batch)
    got = cd.check_dense(pre, pods_t, torch.from_numpy(mask), on_equal=on_equal,
                         step3_on_equal=step3)
    _assert_same(got, want)


def _extremes_case():
    """13 pods × 13 throttles, one resource dim: pod i requests
    EXTREMES[i]; throttle j has threshold and residual EXTREMES[j], every
    dim present and no count flags, so steps 1 and 4 reduce to the raw
    s64 compares. Returned as JAX-package (precomp, pods, mask) padded to
    one Pallas block."""
    from kube_throttler_tpu.ops.fastcheck import CheckPrecomp

    n = EXTREMES.size
    T, P, R = BT, BP, 1
    thr = np.zeros((T, R), np.int64)
    thr[:n, 0] = EXTREMES
    present = np.zeros((T, R), bool)
    present[:n] = True
    f = np.zeros(T, bool)
    valid = np.zeros(T, bool)
    valid[:n] = True
    pre = CheckPrecomp(
        valid=valid, thr_req=thr, thr_req_present=present, exceeds_cnt=f,
        st_cnt=f, st_req=np.zeros((T, R), bool), sat_cnt_ge=f, sat_cnt_gt=f,
        sat_req_ge=np.zeros((T, R), bool), sat_req_gt=np.zeros((T, R), bool),
        resid=thr.copy(), over_cnt_ge=f, over_cnt_gt=f,
    )
    req = np.zeros((P, R), np.int64)
    req[:n, 0] = EXTREMES
    pvalid = np.zeros(P, bool)
    pvalid[:n] = True
    pods = JPodBatch(valid=pvalid, req=req, req_present=np.ones((P, R), bool))
    return pre, pods, np.ones((P, T), bool)


@pytest.mark.parametrize("on_equal", [False, True])
def test_int64_extremes(on_equal):
    """The s64 order at the extremes of tests/test_pallas_check.py::
    test_limb_compare_extremes, through the full classification."""
    jpre, jpods, mask = _extremes_case()
    want = np.asarray(
        pallas_check_pods(jpre, jpods, mask, on_equal=on_equal, interpret=True)
    )
    n = EXTREMES.size
    a, b = EXTREMES[:, None], EXTREMES[None, :]
    nz = a != 0
    expect = np.where(nz & (a > b), 3, np.where(nz & ((a >= b) if on_equal else (a > b)), 2, 0))
    np.testing.assert_array_equal(want[:n, :n], expect)
    pre, pods_t = _carry(jpre, jpods)
    got = cd.check_dense(pre, pods_t, torch.from_numpy(mask), on_equal=on_equal)
    _assert_same(got, want)


def test_wrapper_refuses_other_devices():
    jpre, jpods, mask = _extremes_case()
    pre, pods_t = _carry(jpre, jpods)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cd.check_dense(pre, pods_t, torch.from_numpy(mask).to("meta"))
