"""Residual-form fast check must be bit-identical to the direct kernel, and
both to the JAX package's fast check on the same objects and mask."""

import random

import numpy as np
import pytest
import torch

from kube_throttler_tpu_torch.ops import DimRegistry, check_pods, encode_pods, encode_throttle_state
from kube_throttler_tpu_torch.ops.fastcheck import (
    fast_check_pods,
    fast_check_pods_compact,
    precompute_check_state,
)
from kube_throttler_tpu_torch.ops.check import check_pods_compact

from kube_throttler_tpu.ops import fastcheck as jfast
from kube_throttler_tpu.ops import schema as jschema

from tests.test_check_kernel import _build_objects
from tests.test_torch_ops import port_objects


@pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
@pytest.mark.parametrize("on_equal", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fast_matches_direct(kind, on_equal, seed):
    rng = random.Random(seed)
    throttles, reserved, pods = _build_objects(rng, n_throttles=40, n_pods=30, kind=kind)
    j_dims = jschema.DimRegistry()
    j_state = jschema.encode_throttle_state(throttles, j_dims, reserved=reserved)
    j_batch = jschema.encode_pods(pods, j_dims)
    # the same objects as the port's own types
    throttles, reserved, pods = port_objects(throttles), port_objects(reserved), port_objects(pods)
    dims = DimRegistry()
    state = encode_throttle_state(throttles, dims, reserved=reserved, device="cpu")
    batch = encode_pods(pods, dims, device="cpu")
    mask = np.asarray(rng.choices([True, False], k=len(pods) * len(throttles))).reshape(
        len(pods), len(throttles)
    )
    mask = torch.as_tensor(mask)
    step3 = True if kind == "throttle" else on_equal

    direct = np.asarray(check_pods(state, batch, mask, on_equal=on_equal, step3_on_equal=step3))
    pre = precompute_check_state(state)
    fast = np.asarray(fast_check_pods(pre, batch, mask, on_equal=on_equal, step3_on_equal=step3))
    np.testing.assert_array_equal(fast, direct)
    # the JAX package's fast check on the same objects and mask
    j_fast = jfast.fast_check_pods(jfast.precompute_check_state(j_state), j_batch, mask.numpy(),
                                   on_equal=on_equal, step3_on_equal=step3)
    np.testing.assert_array_equal(fast, np.asarray(j_fast))

    dc, ds = check_pods_compact(state, batch, mask, on_equal=on_equal, step3_on_equal=step3)
    fc, fs = fast_check_pods_compact(pre, batch, mask, on_equal=on_equal, step3_on_equal=step3)
    np.testing.assert_array_equal(np.asarray(fc), np.asarray(dc))
    np.testing.assert_array_equal(np.asarray(fs), np.asarray(ds))
