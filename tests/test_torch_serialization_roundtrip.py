"""Round-trip property test for the manifest serialization layer:
typed object → dict → typed object must be identity for every generated
Throttle/ClusterThrottle shape (selectors incl. matchExpressions,
overrides, thresholds, statuses)."""

import random

import pytest

from kube_throttler_tpu_torch.api.serialization import (
    cluster_throttle_to_dict,
    object_from_dict,
    throttle_to_dict,
)
from kube_throttler_tpu_torch.api.types import ResourceAmount, ThrottleStatus

from tests.test_torch_differential_soak import (
    NOW,
    _rand_overrides,
    _rand_selector,
    _rand_threshold,
)


def _rand_status(rng):
    from kube_throttler_tpu_torch.api.types import CalculatedThreshold

    used = _rand_threshold(rng)
    thr = _rand_threshold(rng)
    return ThrottleStatus(
        used=used,
        throttled=thr.is_throttled(used, True),
        calculated_threshold=CalculatedThreshold(
            threshold=thr, calculated_at=NOW if rng.random() < 0.5 else None,
            messages=("override window active",) if rng.random() < 0.3 else (),
        ),
    )


@pytest.mark.parametrize("seed", range(5))
def test_throttle_roundtrip(seed):
    from kube_throttler_tpu_torch.api.types import Throttle, ThrottleSpec

    rng = random.Random(seed)
    for i in range(20):
        thr = Throttle(
            name=f"t{i}",
            namespace=rng.choice(["default", "ns1"]),
            uid=f"u{i}",
            spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=_rand_threshold(rng),
                temporary_threshold_overrides=_rand_overrides(rng),
                selector=_rand_selector(rng, cluster=False),
            ),
            status=_rand_status(rng),
        )
        back = object_from_dict(throttle_to_dict(thr))
        assert back == thr, f"seed={seed} i={i}"


@pytest.mark.parametrize("seed", range(5))
def test_cluster_throttle_roundtrip(seed):
    from kube_throttler_tpu_torch.api.types import ClusterThrottle, ClusterThrottleSpec

    rng = random.Random(seed + 100)
    for i in range(20):
        ct = ClusterThrottle(
            name=f"ct{i}",
            uid=f"u{i}",
            spec=ClusterThrottleSpec(
                throttler_name="kube-throttler",
                threshold=_rand_threshold(rng),
                temporary_threshold_overrides=_rand_overrides(rng),
                selector=_rand_selector(rng, cluster=True),
            ),
            status=_rand_status(rng),
        )
        back = object_from_dict(cluster_throttle_to_dict(ct))
        assert back == ct, f"seed={seed} i={i}"


def test_reference_field_name_typo_accepted():
    """The reference's `selecterTerms` JSON typo (throttle_selector.go:27)
    must be accepted on input alongside the corrected spelling."""
    base = {
        "apiVersion": "schedule.k8s.everpeace.github.com/v1alpha1",
        "kind": "Throttle",
        "metadata": {"name": "t", "namespace": "default"},
        "spec": {
            "throttlerName": "kt",
            "threshold": {"resourceRequests": {"cpu": "1"}},
        },
    }
    sel = [{"podSelector": {"matchLabels": {"a": "b"}}}]
    d1 = {**base, "spec": {**base["spec"], "selectorTerms": None, "selector": {"selectorTerms": sel}}}
    d2 = {**base, "spec": {**base["spec"], "selector": {"selecterTerms": sel}}}
    t1, t2 = object_from_dict(d1), object_from_dict(d2)
    assert t1.spec.selector == t2.spec.selector
