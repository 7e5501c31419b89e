"""Card-only tests of the port (marker ``cuda``): they skip without a CUDA
device. This file imports nothing of JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- the dense CUDA kernel ≡ its plain version (ragged shapes, both kinds ×
  both onEqual, the int64 extremes), each launch counted once;
- a launch the card refuses raises ``KernelLaunchError``;
- the main path on ``device="cuda"`` ≡ the same stack on ``device="cpu"``
  (``pre_filter_batch`` verdicts and routes), with the kernel launched.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kube_throttler_tpu_torch.ops import check_dense as cd
from kube_throttler_tpu_torch.ops.fastcheck import precompute_check_state
from kube_throttler_tpu_torch.ops.schema import (
    check_precomp_from_arrays,
    pod_batch_from_arrays,
    throttle_state_from_arrays,
)

EXTREMES = [0, 1, -1, 2**31, -(2**31), 2**32, -(2**32), 2**62, -(2**62),
            2**63 - 1, -(2**63), 123456789012345, -987654321098765]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_case(rng, P, T, R, device):
    """Seeded state/pods/mask arrays through the carry-across; odd dims
    carry values past 2^32."""
    scale = np.where(np.arange(R) % 2 == 1, 2**33, 1).astype(np.int64)
    state = dict(
        valid=rng.random(T) < 0.9,
        thr_cnt=rng.integers(0, 60, T), thr_cnt_present=rng.random(T) < 0.5,
        thr_req=rng.integers(0, 2000, (T, R)) * scale, thr_req_present=rng.random((T, R)) < 0.7,
        used_cnt=rng.integers(0, 60, T), used_cnt_present=rng.random(T) < 0.8,
        used_req=rng.integers(0, 2200, (T, R)) * scale, used_req_present=rng.random((T, R)) < 0.8,
        res_cnt=rng.integers(0, 3, T), res_cnt_present=rng.random(T) < 0.3,
        res_req=rng.integers(0, 200, (T, R)) * scale, res_req_present=rng.random((T, R)) < 0.3,
        st_cnt_throttled=rng.random(T) < 0.03, st_req_throttled=rng.random((T, R)) < 0.05,
        st_req_flag_present=rng.random((T, R)) < 0.5,
    )
    pods = dict(valid=rng.random(P) < 0.95, req=rng.integers(0, 1000, (P, R)) * scale,
                req_present=rng.random((P, R)) < 0.7)
    pre = precompute_check_state(throttle_state_from_arrays(state, device=device))
    return pre, pod_batch_from_arrays(pods, device=device), \
        torch.from_numpy(rng.random((P, T)) < 0.5).to(device)


def _extremes_case(device):
    n = len(EXTREMES)
    v = np.array(EXTREMES, dtype=np.int64)[:, None]
    t, f, fr = np.ones(n, bool), np.zeros(n, bool), np.zeros((n, 1), bool)
    pre = check_precomp_from_arrays(dict(
        valid=t, thr_req=v, thr_req_present=np.ones((n, 1), bool), exceeds_cnt=f,
        st_cnt=f, st_req=fr, sat_cnt_ge=f, sat_cnt_gt=f, sat_req_ge=fr, sat_req_gt=fr,
        resid=v.copy(), over_cnt_ge=f, over_cnt_gt=f,
    ), device=device)
    pods = pod_batch_from_arrays(
        dict(valid=t, req=v.copy(), req_present=np.ones((n, 1), bool)), device=device
    )
    return pre, pods, torch.ones((n, n), dtype=torch.bool, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
@pytest.mark.parametrize("on_equal", [False, True])
def test_kernel_matches_plain(card, kind, on_equal):
    rng = np.random.default_rng(1)
    step3 = True if kind == "throttle" else on_equal
    cases = [_extremes_case(card)] + [
        _random_case(rng, P, T, R, card) for P, T, R in ((37, 19, 3), (1, 33, 8), (300, 700, 8))
    ]
    for pre, pods, mask in cases:
        before = cd.launches
        got = cd.check_dense(pre, pods, mask, on_equal=on_equal, step3_on_equal=step3)
        torch.cuda.synchronize()
        assert cd.launches == before + 1
        want = cd.check_dense_reference(pre, pods, mask, on_equal, step3)
        assert got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(card):
    pre, pods, mask = _random_case(np.random.default_rng(2), 8, 8, 2, card)
    with pytest.raises(ValueError, match="contiguous"):
        cd.check_dense(pre, pods, mask.t().contiguous().t())
    with pytest.raises(TypeError, match="dtype"):
        cd.check_dense(pre, pods, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="is on"):
        cd.check_dense(dataclasses.replace(pre, resid=pre.resid.cpu()), pods, mask)


@pytest.mark.cuda
def test_kernel_launch_failure_raises(card, monkeypatch):
    """A launch the card refuses (2048 threads per block) raises
    KernelLaunchError and counts no launch."""
    pre, pods, mask = _random_case(np.random.default_rng(4), 64, 40, 2, card)
    monkeypatch.setattr(cd, "_block_shape", lambda T: (32, 64))
    before = cd.launches
    with pytest.raises(cd.KernelLaunchError, match="cudaError"):
        cd.check_dense(pre, pods, mask)
    assert cd.launches == before


@pytest.mark.cuda
def test_main_path_on_card_matches_cpu(card):
    """pre_filter_batch on device='cuda' ≡ device='cpu' on one seeded store;
    the ClusterThrottle kind takes the dense route through the kernel."""
    import random

    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.api.types import (
        ClusterThrottle, ClusterThrottleSelector, ClusterThrottleSelectorTerm,
        ClusterThrottleSpec, LabelSelector, ResourceAmount, Throttle,
        ThrottleSelector, ThrottleSelectorTerm, ThrottleSpec,
    )
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

    def stack(device):
        rng = random.Random(3)
        store = Store()
        plugin = KubeThrottler(
            decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
            store, device=device,
        )
        store.create_namespace(Namespace("default"))
        for i in range(200):
            store.create_throttle(Throttle(name=f"t{i}", spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(pod=rng.randrange(10, 80)),
                selector=ThrottleSelector(selector_terms=(ThrottleSelectorTerm(
                    LabelSelector(match_labels={"grp": f"g{i % 50}"})),)))))
        for j in range(4):
            store.create_cluster_throttle(ClusterThrottle(name=f"c{j}", spec=ClusterThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(requests={"cpu": f"{(j + 1) * 60}"}),
                selector=ClusterThrottleSelector(selector_terms=(ClusterThrottleSelectorTerm(
                    pod_selector=LabelSelector(match_labels={"mod": f"m{j}"})),)))))
        for k in range(2000):
            g = rng.randrange(50)
            store.create_pod(make_pod(
                f"p{k}", labels={"grp": f"g{g}", "mod": f"m{g % 4}"},
                requests={"cpu": f"{rng.randrange(1, 8) * 100}m"},
                node_name="node-1" if k % 3 else "", phase="Running" if k % 3 else "Pending",
            ))
        plugin.run_pending_once()
        plugin.device_manager.prewarm()
        return plugin

    want = stack("cpu")
    got = stack(card)
    for plugin in (want, got):
        plugin.verdict_cache = None  # the batch kernels, not the dedupe shortcut
    before = cd.launches
    out = got.pre_filter_batch()
    assert cd.launches > before
    assert got.device_manager.last_batch_routes == {"throttle": "sparse", "clusterthrottle": "dense"}
    assert out == want.pre_filter_batch()
    assert set(out["schedulable"].values()) == {True, False}
    assert got.device_manager.breaker_state() == "closed"
    got.stop()
    want.stop()
