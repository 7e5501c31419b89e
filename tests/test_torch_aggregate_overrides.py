"""Aggregation / streaming-delta / override-resolution kernels vs oracle."""

import random
from datetime import datetime, timedelta, timezone

import numpy as np
import torch

from kube_throttler_tpu_torch.api import ResourceAmount, TemporaryThresholdOverride
from kube_throttler_tpu_torch.api.pod import make_pod
from kube_throttler_tpu_torch.api.types import ThrottleSpecBase, resource_amount_of_pod
from kube_throttler_tpu_torch.ops import DimRegistry, encode_pods
from kube_throttler_tpu_torch.ops.aggregate import (
    aggregate_used,
    apply_pod_delta,
    throttled_flags,
)
from kube_throttler_tpu_torch.ops.overrides import (
    calculate_thresholds,
    encode_override_schedule,
)
from kube_throttler_tpu_torch.quantity import from_milli, to_milli

NOW = datetime(2024, 1, 15, 12, 0, 0, tzinfo=timezone.utc)


def rfc(dt):
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


def ns(dt):
    return int(dt.timestamp() * 1e9)


class TestAggregateUsed:
    def _oracle_used(self, pods, mask, counted, j):
        used = ResourceAmount()
        for i, p in enumerate(pods):
            if counted[i] and mask[i][j]:
                used = used.add(resource_amount_of_pod(p))
        return used

    def test_matches_oracle_accumulation(self):
        rng = random.Random(3)
        pods = []
        for i in range(30):
            reqs = {}
            for r in ["cpu", "memory"]:
                if rng.random() < 0.7:
                    reqs[r] = rng.choice(["100m", "1", "0"])
            pods.append(make_pod(f"p{i}", requests=reqs))
        mask = np.array([[rng.random() < 0.5 for _ in range(8)] for _ in pods])
        counted = np.array([rng.random() < 0.7 for _ in pods])

        dims = DimRegistry()
        batch = encode_pods(pods, dims, device="cpu")
        used_cnt, used_req, contrib = aggregate_used(
            batch, torch.as_tensor(mask), torch.as_tensor(counted)
        )
        used_cnt, used_req, contrib = map(np.asarray, (used_cnt, used_req, contrib))

        for j in range(8):
            want = self._oracle_used(pods, mask, counted, j)
            if want.resource_counts is None:
                assert used_cnt[j] == 0
            else:
                assert used_cnt[j] == want.resource_counts
            assert (used_cnt[j] > 0) == (want.resource_counts is not None)
            for name, q in (want.resource_requests or {}).items():
                r = dims.index_of(name)
                assert from_milli(int(used_req[j, r])) == q
                assert contrib[j, r] > 0
            # dims with zero contributors must read absent
            for r in range(len(dims)):
                name = dims.names[r]
                if want.resource_requests is None or name not in want.resource_requests:
                    assert contrib[j, r] == 0

    def test_streaming_delta_equals_recompute(self):
        rng = random.Random(11)
        pods = [
            make_pod(f"p{i}", requests={"cpu": rng.choice(["100m", "200m"])})
            for i in range(10)
        ]
        mask = np.array([[rng.random() < 0.6 for _ in range(5)] for _ in pods])
        counted = np.ones(len(pods), dtype=bool)
        dims = DimRegistry()
        batch = encode_pods(pods, dims, device="cpu")
        used_cnt, used_req, contrib = aggregate_used(
            batch, torch.as_tensor(mask), torch.as_tensor(counted)
        )

        # remove pod 3 and add a new pod via scatter deltas
        new_pod = make_pod("new", requests={"cpu": "300m", "memory": "1Gi"})
        dims.index_of("memory")
        affected_old = np.where(mask[3])[0].astype(np.int32)
        K = 5
        ids = np.full(K, mask.shape[1], dtype=np.int32)  # pad out-of-range
        ids[: len(affected_old)] = affected_old
        sign = np.zeros(K, dtype=np.int64)
        sign[: len(affected_old)] = -1
        pod_req = np.asarray(batch.req[3])
        pod_present = np.asarray(batch.req_present[3])
        used_cnt, used_req, contrib = apply_pod_delta(
            used_cnt, used_req, contrib, *map(torch.as_tensor, (ids, sign, pod_req, pod_present))
        )

        new_mask_row = np.array([rng.random() < 0.6 for _ in range(5)])
        affected_new = np.where(new_mask_row)[0].astype(np.int32)
        ids = np.full(K, mask.shape[1], dtype=np.int32)
        ids[: len(affected_new)] = affected_new
        sign = np.zeros(K, dtype=np.int64)
        sign[: len(affected_new)] = 1
        R = dims.capacity
        new_req = np.zeros(R, dtype=np.int64)
        new_present = np.zeros(R, dtype=bool)
        from kube_throttler_tpu_torch import resourcelist as rl

        for name, q in rl.pod_request_resource_list(new_pod).items():
            new_req[dims.index_of(name)] = to_milli(q)
            new_present[dims.index_of(name)] = True
        used_cnt, used_req, contrib = apply_pod_delta(
            used_cnt, used_req, contrib, *map(torch.as_tensor, (ids, sign, new_req, new_present))
        )

        # recompute from scratch with pod3 dropped and new pod appended
        pods2 = [p for i, p in enumerate(pods) if i != 3] + [new_pod]
        mask2 = np.vstack([mask[[i for i in range(len(pods)) if i != 3]], new_mask_row])
        batch2 = encode_pods(pods2, dims, device="cpu")
        want_cnt, want_req, want_contrib = aggregate_used(
            batch2, torch.as_tensor(mask2), torch.as_tensor(np.ones(len(pods2), dtype=bool))
        )
        np.testing.assert_array_equal(np.asarray(used_cnt), np.asarray(want_cnt))
        np.testing.assert_array_equal(
            np.asarray(used_req)[:, : len(dims)], np.asarray(want_req)[:, : len(dims)]
        )
        np.testing.assert_array_equal(
            np.asarray(contrib)[:, : len(dims)], np.asarray(want_contrib)[:, : len(dims)]
        )


class TestThrottledFlags:
    def test_matches_oracle(self):
        rng = random.Random(5)
        T, R = 20, 3
        thr_cnt = np.array([rng.randrange(0, 5) for _ in range(T)], dtype=np.int64)
        thr_cnt_present = np.array([rng.random() < 0.7 for _ in range(T)])
        used_cnt = np.array([rng.randrange(0, 5) for _ in range(T)], dtype=np.int64)
        used_cnt_present = np.array([rng.random() < 0.7 for _ in range(T)])
        thr_req = np.array([[rng.randrange(0, 4) * 100 for _ in range(R)] for _ in range(T)], dtype=np.int64)
        thr_req_present = np.array([[rng.random() < 0.7 for _ in range(R)] for _ in range(T)])
        used_req = np.array([[rng.randrange(0, 4) * 100 for _ in range(R)] for _ in range(T)], dtype=np.int64)
        used_req_present = np.array([[rng.random() < 0.7 for _ in range(R)] for _ in range(T)])

        cnt_flag, req_flag, flag_present = throttled_flags(*map(torch.as_tensor, (
            thr_cnt, thr_cnt_present, thr_req, thr_req_present,
            used_cnt, used_cnt_present, used_req, used_req_present,
        )))
        names = ["r0", "r1", "r2"]
        for t in range(T):
            thr = ResourceAmount.of(
                pod=int(thr_cnt[t]) if thr_cnt_present[t] else None,
                requests={names[r]: from_milli(int(thr_req[t, r])) for r in range(R) if thr_req_present[t, r]} if thr_req_present[t].any() else None,
            )
            used = ResourceAmount.of(
                pod=int(used_cnt[t]) if used_cnt_present[t] else None,
                requests={names[r]: from_milli(int(used_req[t, r])) for r in range(R) if used_req_present[t, r]} if used_req_present[t].any() else None,
            )
            want = thr.is_throttled(used, True)
            assert bool(cnt_flag[t]) == want.resource_counts_pod
            for r in range(R):
                if flag_present[t, r]:
                    assert bool(req_flag[t, r]) == want.resource_requests[names[r]]
                else:
                    assert want.resource_requests is None or names[r] not in want.resource_requests


class TestCalculateThresholdsKernel:
    def test_matches_oracle_over_time(self):
        rng = random.Random(9)
        specs = []
        for i in range(25):
            overrides = []
            for k in range(rng.randrange(0, 4)):
                begin = NOW + timedelta(minutes=rng.randrange(-120, 120))
                end = begin + timedelta(minutes=rng.randrange(0, 120))
                threshold = ResourceAmount.of(
                    pod=rng.randrange(0, 5) if rng.random() < 0.6 else None,
                    requests={"cpu": f"{rng.randrange(1, 9)*100}m"} if rng.random() < 0.7 else None,
                )
                overrides.append(
                    TemporaryThresholdOverride(
                        begin=rfc(begin) if rng.random() < 0.8 else "",
                        end=rfc(end) if rng.random() < 0.8 else "",
                        threshold=threshold,
                    )
                )
            if rng.random() < 0.15 and overrides:
                overrides[0] = TemporaryThresholdOverride(begin="garbage", threshold=ResourceAmount.of(pod=1))
            specs.append(
                ThrottleSpecBase(
                    threshold=ResourceAmount.of(pod=3, requests={"cpu": "500m", "memory": "1Gi"}),
                    temporary_threshold_overrides=tuple(overrides),
                )
            )

        dims = DimRegistry()
        sched = encode_override_schedule(specs, dims, device="cpu")
        for probe in [NOW, NOW + timedelta(minutes=30), NOW + timedelta(hours=3)]:
            cnt, cnt_p, req, req_p = map(
                np.asarray, calculate_thresholds(sched, np.int64(ns(probe)))
            )
            for i, spec in enumerate(specs):
                want = spec.calculate_threshold(probe).threshold
                if want.resource_counts is None:
                    assert not cnt_p[i], f"throttle {i} at {probe}"
                else:
                    assert cnt_p[i] and cnt[i] == want.resource_counts, f"throttle {i} at {probe}"
                want_reqs = want.resource_requests or {}
                for r in range(len(dims)):
                    name = dims.names[r]
                    if name in want_reqs:
                        assert req_p[i, r], f"throttle {i} dim {name} at {probe}"
                        assert from_milli(int(req[i, r])) == want_reqs[name]
                    else:
                        assert not req_p[i, r], f"throttle {i} dim {name} at {probe}"


class TestOverrideEncodingRegressions:
    def test_far_future_end_clamps_not_crashes(self):
        spec = ThrottleSpecBase(
            temporary_threshold_overrides=(
                TemporaryThresholdOverride(
                    begin=rfc(NOW - timedelta(hours=1)),
                    end="9999-12-31T23:59:59Z",
                    threshold=ResourceAmount.of(pod=1),
                ),
            )
        )
        dims = DimRegistry()
        sched = encode_override_schedule([spec], dims, device="cpu")
        cnt, cnt_p, _, _ = map(np.asarray, calculate_thresholds(sched, np.int64(ns(NOW))))
        assert cnt_p[0] and cnt[0] == 1  # still active at NOW

    def test_fractional_second_boundary_exact(self):
        from kube_throttler_tpu_torch.ops.overrides import _datetime_to_ns
        from kube_throttler_tpu_torch.api.types import parse_rfc3339

        dt = parse_rfc3339("2024-01-15T12:00:00.000013Z")
        assert int(_datetime_to_ns(dt)) % 10**9 == 13_000

    def test_capacity_overflow_raises(self):
        import pytest

        spec = ThrottleSpecBase(
            temporary_threshold_overrides=tuple(
                TemporaryThresholdOverride(threshold=ResourceAmount.of(pod=i))
                for i in range(3)
            )
        )
        with pytest.raises(ValueError, match="override_capacity"):
            encode_override_schedule([spec], DimRegistry(), override_capacity=2, device="cpu")


class TestDimMismatchGuard:
    def test_actionable_error_on_registry_growth(self):
        import pytest
        from kube_throttler_tpu_torch.api import Throttle, ThrottleSpec
        from kube_throttler_tpu_torch.ops import check_pods, encode_throttle_state

        dims = DimRegistry(capacity=2)
        state = encode_throttle_state(
            [Throttle(name="t", spec=ThrottleSpec(threshold=ResourceAmount.of(requests={"a": "1", "b": "1"})))],
            dims, device="cpu",
        )
        # pod introduces a 3rd dim → capacity doubles → R mismatch
        batch = encode_pods([make_pod("p", requests={"a": "1", "b": "1", "c": "1"})], dims, device="cpu")
        with pytest.raises(ValueError, match="resource-dim mismatch"):
            check_pods(state, batch, torch.as_tensor(np.ones((1, 1), dtype=bool)))
