"""Accel-class resolution on the batch-triage surfaces.

The single-pod path has routed accel-class pods to the class-aware host
oracle; ``pre_filter_batch`` and the sharded tick classified
them against the device planes' BASE thresholds. These pin the regression
contract: batch and single-pod verdicts agree for accel-class pods
whenever any mirrored throttle declares ``accelClassThresholds``.
"""

from __future__ import annotations

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    AccelClassThreshold,
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.plugin.framework import StatusCode


def _throttle(name, pod=None, accel=()):
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(pod=pod),
            accel_class_thresholds=tuple(accel),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(
                        LabelSelector(match_labels={"throttle": name})
                    ),
                )
            ),
        ),
    )


def _build():
    store = Store()
    store.create_namespace(Namespace("default"))
    store.create_throttle(
        _throttle(
            "t1",
            pod=10,
            accel=[AccelClassThreshold("v5e", ResourceAmount.of(pod=0))],
        )
    )
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True, device="cpu",
    )
    store.create_pod(make_pod("plain", labels={"throttle": "t1"}))
    store.create_pod(
        make_pod("accel", labels={"throttle": "t1"}, accel_class="v5e")
    )
    plugin.run_pending_once()
    return store, plugin


class TestAccelClassBatchSurfaces:
    def test_batch_agrees_with_single_pod_for_accel_pods(self):
        store, plugin = _build()
        try:
            per_pod = {
                p.key: plugin.pre_filter(p).code == StatusCode.SUCCESS
                for p in store.list_pods()
            }
            # the single-pod route resolves the v5e pod=0 replacement: the
            # accel pod is blocked, the plain pod is not
            assert per_pod["default/plain"] is True
            assert per_pod["default/accel"] is False

            batch = plugin.pre_filter_batch()["schedulable"]
            assert batch == per_pod
        finally:
            plugin.stop()

    def test_sharded_tick_agrees_for_accel_pods(self):
        store, plugin = _build()
        try:
            out = plugin.full_tick_sharded(n_devices=1)
            assert out["schedulable"]["default/accel"] is False
            assert out["schedulable"]["default/plain"] is True
        finally:
            plugin.stop()

    def test_no_accel_thresholds_means_zero_override_work(self):
        # with no accelClassThresholds mirrored, the override pass is a
        # no-op even for pods carrying an accel class annotation
        store = Store()
        store.create_namespace(Namespace("default"))
        store.create_throttle(_throttle("t1", pod=10))
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            store,
            use_device=True, device="cpu",
        )
        try:
            store.create_pod(
                make_pod("accel", labels={"throttle": "t1"}, accel_class="v5e")
            )
            plugin.run_pending_once()
            batch = plugin.pre_filter_batch()["schedulable"]
            assert batch["default/accel"] is True
        finally:
            plugin.stop()
