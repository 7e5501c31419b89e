"""Property tests for the two hot-path ops, on the PyTorch port: the copy
of ``tests/test_hotpath_ops.py`` over ``kube_throttler_tpu_torch``, the
inputs as CPU tensors.

- ``fast_check_pod_indexed`` must agree with the dense residual-form check
  restricted to the gathered rows, for every (on_equal, step3_on_equal)
  variant and under index padding, and ``fast_check_pod_packed`` with it;
- ``apply_pod_deltas_batched`` must equal sequential ``apply_pod_delta``
  application (scatter-adds commute exactly in int64).

Each case is also held against the JAX package's function on the same
numpy inputs, bit for bit and dtype for dtype.
"""

import random

import numpy as np
import pytest
import torch

from kube_throttler_tpu.ops import aggregate as jaggregate
from kube_throttler_tpu.ops import fastcheck as jfast
from kube_throttler_tpu.ops.schema import PodBatch as JPodBatch
from kube_throttler_tpu.ops.schema import ThrottleState as JThrottleState
from kube_throttler_tpu_torch.ops.aggregate import apply_pod_delta, apply_pod_deltas_batched
from kube_throttler_tpu_torch.ops.check import CHECK_NOT_AFFECTED
from kube_throttler_tpu_torch.ops.fastcheck import (
    fast_check_pod_indexed,
    fast_check_pod_packed,
    fast_check_pods,
    pack_check_state,
    precompute_check_state,
)
from kube_throttler_tpu_torch.ops.schema import PodBatch, throttle_state_from_arrays

from tests.test_torch_ops import _assert_same

CPU = "cpu"


def _rand_state(npr, T, R):
    """Random padded ThrottleState arrays with adversarial presence masks."""
    thr_req = npr.integers(0, 2000, (T, R)).astype(np.int64)
    used_req = npr.integers(0, 2000, (T, R)).astype(np.int64)
    res_req = npr.integers(0, 500, (T, R)).astype(np.int64)
    return dict(
        valid=npr.random(T) < 0.9,
        thr_cnt=npr.integers(0, 10, T).astype(np.int64),
        thr_cnt_present=npr.random(T) < 0.8,
        thr_req=thr_req,
        thr_req_present=npr.random((T, R)) < 0.8,
        used_cnt=npr.integers(0, 12, T).astype(np.int64),
        used_cnt_present=npr.random(T) < 0.8,
        used_req=used_req,
        used_req_present=npr.random((T, R)) < 0.8,
        res_cnt=npr.integers(0, 3, T).astype(np.int64),
        res_cnt_present=npr.random(T) < 0.4,
        res_req=res_req,
        res_req_present=npr.random((T, R)) < 0.4,
        st_cnt_throttled=npr.random(T) < 0.3,
        st_req_throttled=npr.random((T, R)) < 0.3,
        st_req_flag_present=npr.random((T, R)) < 0.6,
    )


def _rand_pod(rng, R):
    req = np.zeros(R, dtype=np.int64)
    present = np.zeros(R, dtype=bool)
    for r in range(R):
        if rng.random() < 0.7:
            req[r] = rng.randrange(0, 2000)
            present[r] = True
    return req, present


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("on_equal,s3", [(False, True), (True, True), (False, False)])
def test_indexed_matches_dense(on_equal, s3):
    rng = random.Random(42)
    npr = np.random.default_rng(42)
    for trial in range(20):
        T, R, K = 37, 5, 8
        arrays = _rand_state(npr, T, R)
        pre = precompute_check_state(throttle_state_from_arrays(arrays, device=CPU))
        jpre = jfast.precompute_check_state(JThrottleState(**arrays))
        pod_req, pod_present = _rand_pod(rng, R)

        # K slots: some live rows, some padded (idx_valid=False, idx clamped 0)
        n_live = rng.randrange(0, K + 1)
        idx = np.zeros(K, dtype=np.int32)
        valid = np.zeros(K, dtype=bool)
        idx[:n_live] = npr.integers(0, T, n_live)
        valid[:n_live] = True
        args = (_t(pod_req), _t(pod_present), _t(idx), _t(valid))

        got = fast_check_pod_indexed(pre, *args, on_equal, s3)
        packed = fast_check_pod_packed(pack_check_state(pre), *args, on_equal, s3)
        np.testing.assert_array_equal(packed.numpy(), got.numpy())
        _assert_same(got, jfast.fast_check_pod_indexed(
            jpre, pod_req, pod_present, idx, valid, on_equal, s3), f"indexed {trial}")
        _assert_same(packed, jfast.fast_check_pod_packed(
            jfast.pack_check_state(jpre), pod_req, pod_present, idx, valid, on_equal, s3),
            f"packed {trial}")

        batch = PodBatch(
            valid=torch.ones(1, dtype=torch.bool), req=_t(pod_req[None]),
            req_present=_t(pod_present[None]),
        )
        mask = np.zeros((1, T), dtype=bool)
        mask[0, idx[:n_live]] = True
        dense = fast_check_pods(pre, batch, _t(mask), on_equal, s3)[0]
        jbatch = JPodBatch(
            valid=np.ones(1, dtype=bool), req=pod_req[None], req_present=pod_present[None]
        )
        _assert_same(dense, jfast.fast_check_pods(jpre, jbatch, mask, on_equal, s3)[0],
                     f"dense {trial}")

        got = got.numpy()
        dense = dense.numpy()
        for slot in range(K):
            if valid[slot]:
                assert got[slot] == dense[idx[slot]], (trial, slot)
            else:
                assert got[slot] == CHECK_NOT_AFFECTED


def test_batched_deltas_match_sequential():
    npr = np.random.default_rng(7)
    T, R, N, K = 23, 4, 50, 3
    used_cnt = npr.integers(0, 100, T).astype(np.int64)
    used_req = npr.integers(0, 10_000, (T, R)).astype(np.int64)
    contrib = npr.integers(0, 20, (T, R)).astype(np.int32)

    # pad ~20% of slots out-of-range (row T) — scatter must drop them
    ids = npr.integers(0, T + 1, (N, K)).astype(np.int32)
    signs = npr.choice(np.array([-1, 0, 1], dtype=np.int64), (N, K))
    pod_req = npr.integers(0, 500, (N, R)).astype(np.int64)
    pod_present = npr.random((N, R)) < 0.8

    seq = (_t(used_cnt), _t(used_req), _t(contrib))
    for i in range(N):
        seq = apply_pod_delta(*seq, _t(ids[i]), _t(signs[i]), _t(pod_req[i]),
                              _t(pod_present[i]))

    bat = apply_pod_deltas_batched(
        _t(used_cnt), _t(used_req), _t(contrib), _t(ids), _t(signs), _t(pod_req),
        _t(pod_present),
    )
    want = jaggregate.apply_pod_deltas_batched(
        used_cnt, used_req, contrib, ids, signs, pod_req, pod_present
    )
    for name, got, seq_got, jax_got in zip(("used_cnt", "used_req", "contrib"), bat, seq, want):
        np.testing.assert_array_equal(got.numpy(), seq_got.numpy())
        _assert_same(got, jax_got, name)
