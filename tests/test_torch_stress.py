"""Stress tier — the reference's clusterthrottle_stress_test.go:30-88 scale
(50 ClusterThrottles × 10 namespaces × 10 pods, every throttle driven
exactly to its threshold) plus a multi-threaded scheduler soak that the
reference can only run against a kind cluster."""

import random
import threading
from dataclasses import replace
from datetime import datetime, timezone

import pytest

from kube_throttler_tpu_torch.api import (
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    LabelSelector,
    Namespace,
    ResourceAmount,
)
from kube_throttler_tpu_torch.api.pod import make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import (
    KubeThrottler,
    RecordingEventRecorder,
    decode_plugin_args,
)
from kube_throttler_tpu_torch.utils.clock import FakeClock
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

NOW = datetime(2024, 1, 15, 12, 0, 0, tzinfo=timezone.utc)


def _cluster_throttle(i: int, n_pods: int) -> ClusterThrottle:
    return ClusterThrottle(
        name=f"clthr-{i}",
        spec=ClusterThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(
                pod=n_pods, requests={"cpu": f"{n_pods * 100}m"}
            ),
            selector=ClusterThrottleSelector(
                selector_terms=(
                    ClusterThrottleSelectorTerm(
                        pod_selector=LabelSelector(match_labels={"clthr": f"c{i}"}),
                    ),
                )
            ),
        ),
    )


class TestClusterThrottleStress:
    @pytest.mark.parametrize("use_device", [True, False], ids=["device", "oracle"])
    def test_50_throttles_10_ns_10_pods_reach_exact_thresholds(self, use_device):
        """Every throttle is filled to exactly its threshold; the next pod on
        each is blocked (clusterthrottle_stress_test.go semantics)."""
        n_throttles, n_ns, pods_per_throttle = 50, 10, 10
        store = Store()
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler", "controllerThrediness": 1}
            ),
            store,
            event_recorder=RecordingEventRecorder(),
            use_device=use_device, device="cpu",
        )
        for i in range(n_ns):
            store.create_namespace(Namespace(f"ns-{i}"))
        for i in range(n_throttles):
            store.create_cluster_throttle(_cluster_throttle(i, pods_per_throttle))
        plugin.run_pending_once()

        rng = random.Random(0)
        admitted = 0
        for i in range(n_throttles):
            for j in range(pods_per_throttle):
                pod = make_pod(
                    f"p-{i}-{j}",
                    namespace=f"ns-{rng.randrange(n_ns)}",
                    labels={"clthr": f"c{i}"},
                    requests={"cpu": "100m"},
                )
                store.create_pod(pod)
                status = plugin.pre_filter(pod)
                assert status.is_success(), f"pod {pod.key}: {status.message()}"
                plugin.reserve(pod)
                bound = replace(pod, spec=replace(pod.spec, node_name="n1"))
                store.update_pod(bound)
                admitted += 1
        plugin.run_pending_once()
        assert admitted == n_throttles * pods_per_throttle

        # every throttle sits exactly at its threshold and is throttled
        for i in range(n_throttles):
            thr = store.get_cluster_throttle(f"clthr-{i}")
            assert thr.status.used.resource_counts == pods_per_throttle
            assert thr.status.throttled.resource_counts_pod is True
            assert thr.status.throttled.resource_requests["cpu"] is True
            # one more pod is rejected with the reference reason
            extra = make_pod(
                f"extra-{i}", namespace="ns-0", labels={"clthr": f"c{i}"}, requests={"cpu": "100m"}
            )
            store.create_pod(extra)
            status = plugin.pre_filter(extra)
            assert not status.is_success()
            assert f"clusterthrottle[active]=/clthr-{i}" in status.message()


class TestThreadedSchedulerSoak:
    def test_concurrent_scheduling_respects_thresholds(self):
        """N scheduler threads race PreFilter/Reserve/bind against async
        controller workers; reservation accounting must never over-admit."""
        store = Store()
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler", "controllerThrediness": 4, "numKeyMutex": 16}
            ),
            store,
            event_recorder=RecordingEventRecorder(),
            start_workers=True, device="cpu",
        )
        store.create_namespace(Namespace("default"))
        from kube_throttler_tpu_torch.api import Throttle, ThrottleSelector, ThrottleSelectorTerm, ThrottleSpec

        capacity = 20
        store.create_throttle(
            Throttle(
                name="gate",
                spec=ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(requests={"cpu": "1"}),  # 20 x 50m
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(LabelSelector(match_labels={"gate": "g"})),
                        )
                    ),
                ),
            )
        )

        admitted = []
        admit_lock = threading.Lock()

        def scheduler_thread(tid):
            for j in range(10):
                pod = make_pod(
                    f"pod-{tid}-{j}", labels={"gate": "g"}, requests={"cpu": "50m"}
                )
                store.create_pod(pod)
                # PreFilter + Reserve must be serialized per scheduling cycle
                # (kube-scheduler schedules one pod at a time); emulate that
                # with a global cycle lock, binds happen async afterwards.
                with admit_lock:
                    status = plugin.pre_filter(pod)
                    if not status.is_success():
                        continue
                    assert plugin.reserve(pod).is_success()
                    admitted.append(pod.key)
                bound = replace(pod, spec=replace(pod.spec, node_name="n1"))
                store.update_pod(bound)

        threads = [threading.Thread(target=scheduler_thread, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        import time

        deadline = time.time() + 10
        while time.time() < deadline:
            thr = store.get_throttle("default", "gate")
            if thr.status.used.resource_counts == len(admitted):
                break
            time.sleep(0.05)

        # never over capacity, and the reconcile converged on the admitted set
        assert len(admitted) <= capacity
        assert len(admitted) == capacity, f"expected full utilization, got {len(admitted)}"
        thr = store.get_throttle("default", "gate")
        assert thr.status.used.resource_counts == capacity
        assert thr.status.throttled.resource_requests["cpu"] is True
        plugin.stop()


class TestCrashOnlyRecovery:
    """SURVEY §5: the reference is crash-only — informer caches resync on
    restart and reservations are scheduler-cycle-transient. A fresh plugin
    over the same store must reach identical decisions."""

    def test_restart_rebuilds_state(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        args = decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler", "controllerThrediness": 1}
        )
        plugin = KubeThrottler(args, store, event_recorder=RecordingEventRecorder(), device="cpu")
        from kube_throttler_tpu_torch.api import Throttle, ThrottleSelector, ThrottleSelectorTerm, ThrottleSpec

        store.create_throttle(
            Throttle(
                name="t1",
                spec=ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(requests={"cpu": "200m"}),
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                        )
                    ),
                ),
            )
        )
        plugin.run_pending_once()
        pod = make_pod("p1", labels={"throttle": "t1"}, requests={"cpu": "200m"})
        store.create_pod(pod)
        plugin.run_pending_once()
        plugin.pre_filter(pod)
        plugin.reserve(pod)
        bound = replace(pod, spec=replace(pod.spec, node_name="n1"))
        store.update_pod(bound)
        plugin.run_pending_once()

        # "crash": drop the plugin; build a fresh one over the same store
        # (replay=True event handlers play the informer cache resync role)
        plugin2 = KubeThrottler(args, store, event_recorder=RecordingEventRecorder(), device="cpu")
        plugin2.run_pending_once()

        blocked = make_pod("p2", labels={"throttle": "t1"}, requests={"cpu": "100m"})
        store.create_pod(blocked)
        old_status = plugin.pre_filter(blocked)
        new_status = plugin2.pre_filter(blocked)
        assert new_status.code == old_status.code
        assert new_status.reasons == old_status.reasons
        assert "throttle[active]=default/t1" in new_status.message()
        # reservations are cycle-transient: the fresh ledger starts empty
        assert plugin2.throttle_ctr.cache.reserved_pod_keys("default/t1") == set()
