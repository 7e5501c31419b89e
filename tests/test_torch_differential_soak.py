"""Randomized differential soak: two full stacks — device-kernel-served and
host-oracle — consume an identical random event stream; every pod's
PreFilter verdict and every throttle's reconciled status must agree at
every checkpoint.

This is the strongest end-to-end equivalence artifact: it exercises the
whole pipeline (store → watch events → selector index (native C++ row tier
on one side) → device mirror → packed indexed check kernel) against the
pure-Python reference semantics, over object shapes unit tests don't
enumerate (matchExpressions columns, label moves, unknown namespaces,
overrides straddling the fake clock, reservations, deletes).

Each seed's trace (every reserve's code, every checkpoint's verdicts and
statuses) is also held equal to the JAX package's host stack run through
the same seed: a fault that both of the port's stacks share shows there.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import pytest

from torch_soak import (  # noqa: F401  (the serialization copy imports these)
    NOW,
    _rand_overrides,
    _rand_selector,
    _rand_threshold,
    churn,
    checkpoints,
)


def _reference_kit():
    """The JAX package's API classes, store error and host stack, as a kit
    for ``churn``."""
    from kube_throttler_tpu.api import pod, types
    from kube_throttler_tpu.engine.store import NotFoundError, Store
    from kube_throttler_tpu.plugin import KubeThrottler, decode_plugin_args
    from kube_throttler_tpu.utils.clock import FakeClock

    def stack(use_device: bool):
        store, clock = Store(), FakeClock(NOW)
        plugin = KubeThrottler(
            decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
            store, clock=clock, use_device=use_device,
        )
        return store, plugin, clock

    names = ("ClusterThrottle", "ClusterThrottleSelector", "ClusterThrottleSelectorTerm",
             "ClusterThrottleSpec", "LabelSelector", "LabelSelectorRequirement",
             "ResourceAmount", "TemporaryThresholdOverride", "Throttle", "ThrottleSelector",
             "ThrottleSelectorTerm", "ThrottleSpec")
    return SimpleNamespace(Namespace=pod.Namespace, make_pod=pod.make_pod,
                           NotFoundError=NotFoundError, stack=stack,
                           **{n: getattr(types, n) for n in names})


def _reference_trace(seed):
    kit = _reference_kit()
    return churn(seed, stacks=[kit.stack(False)], kit=kit)


#  seed 20 found the reservation-outlives-throttle-recreation divergence
#  (device under-counted reserved after delete+recreate) — keep it pinned
@pytest.mark.parametrize("seed", [1, 2, 3, 20])
def test_device_and_host_stacks_agree_under_random_churn(seed):
    trace = churn(seed)
    assert checkpoints(trace) == 11
    # the port's trace ≡ the JAX package's host stack on the same stream
    reference = _reference_trace(seed)
    assert len(trace) == len(reference)
    for got, want in zip(trace, reference):
        assert got == want, (seed, got[:2], want[:2])


@pytest.mark.skipif(
    not os.environ.get("KT_SOAK_SEEDS"),
    reason="set KT_SOAK_SEEDS=lo:hi for the wide randomized soak",
)
def test_wide_soak_seed_range():
    """Opt-in wide soak (e.g. KT_SOAK_SEEDS=4:200; seed 20
    found the reservation-outlives-recreation divergence). Each seed is an
    independent 120-step churn differential between the device and host
    stacks."""
    lo, hi = (int(x) for x in os.environ["KT_SOAK_SEEDS"].split(":"))
    for seed in range(lo, hi):
        test_device_and_host_stacks_agree_under_random_churn(seed)
