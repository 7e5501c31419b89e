"""End-to-end integration: the reference README walkthrough + burst and
cluster-throttle scenarios, driven through the full stack (store → watch →
controllers → plugin) with a simulated scheduler loop.

Mirrors the reference's integration tier (test/integration/throttle_test.go,
clusterthrottle_test.go) without its kind-cluster dependency: the in-memory
store plays the apiserver, and reconciles run deterministically via
run_pending_once().
"""

from dataclasses import replace
from datetime import datetime, timedelta, timezone

import pytest

from kube_throttler_tpu_torch.api import (
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    LabelSelector,
    Namespace,
    ResourceAmount,
    TemporaryThresholdOverride,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.api.pod import Pod, make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import (
    KubeThrottler,
    RecordingEventRecorder,
    StatusCode,
    decode_plugin_args,
)
from kube_throttler_tpu_torch.utils.clock import FakeClock

NOW = datetime(2024, 1, 15, 12, 0, 0, tzinfo=timezone.utc)


def rfc(dt):
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


class Harness:
    """store + plugin + deterministic scheduler simulator."""

    def __init__(self, use_device=True):
        self.store = Store()
        self.clock = FakeClock(NOW)
        self.recorder = RecordingEventRecorder()
        self.store.create_namespace(Namespace("default"))
        args = decode_plugin_args(
            {
                "name": "kube-throttler",
                "targetSchedulerName": "my-scheduler",
                "controllerThrediness": 1,
            }
        )
        self.plugin = KubeThrottler(
            args,
            self.store,
            clock=self.clock,
            event_recorder=self.recorder,
            use_device=use_device, device="cpu",
        )

    def settle(self, rounds: int = 5):
        for _ in range(rounds):
            if self.plugin.run_pending_once() == 0:
                break

    def schedule_attempt(self, pod: Pod) -> str:
        """One scheduling cycle: PreFilter → Reserve → bind (set nodeName,
        phase Running). Returns the final pre-filter status/reason summary."""
        status = self.plugin.pre_filter(pod)
        if not status.is_success():
            return status.message()
        assert self.plugin.reserve(pod).is_success()
        bound = replace(
            pod,
            spec=replace(pod.spec, node_name="node-1"),
        )
        bound.status.phase = "Running"
        self.store.update_pod(bound)
        self.settle()
        return "scheduled"

    def create_and_schedule(self, pod: Pod) -> str:
        self.store.create_pod(pod)
        self.settle()
        return self.schedule_attempt(pod)


@pytest.fixture(params=[True, False], ids=["device", "oracle"])
def harness(request):
    return Harness(use_device=request.param)


def t1_throttle(threshold_cpu="200m", pod_count=5):
    return Throttle(
        name="t1",
        namespace="default",
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(
                pod=pod_count, requests={"cpu": threshold_cpu, "memory": "1Gi"}
            ),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                )
            ),
        ),
    )


def labeled_pod(name, requests):
    return make_pod(name, labels={"throttle": "t1"}, requests=requests)


class TestReadmeWalkthrough:
    """README.md:202-375 decision sequence."""

    def test_full_sequence(self, harness):
        h = harness
        h.store.create_throttle(t1_throttle())
        h.settle()

        # pod1 (cpu 200m) schedules on the empty throttle
        assert h.create_and_schedule(labeled_pod("pod1", {"cpu": "200m"})) == "scheduled"

        # reconcile marked cpu throttled (used 200m >= threshold 200m)
        thr = h.store.get_throttle("default", "t1")
        assert thr.status.used.resource_counts == 1
        assert thr.status.throttled.resource_requests["cpu"] is True
        assert thr.status.throttled.resource_requests["memory"] is False

        # pod2 (cpu 300m) exceeds the 200m threshold outright
        msg = h.create_and_schedule(labeled_pod("pod2", {"cpu": "300m"}))
        assert "throttle[pod-requests-exceeds-threshold]=default/t1" in msg
        events = h.recorder.events_for("default/pod2")
        assert any(e.reason == "ResourceRequestsExceedsThrottleThreshold" for e in events)

        # pod1m (memory only) sails through — cpu throttle doesn't block it
        assert h.create_and_schedule(labeled_pod("pod1m", {"memory": "512Mi"})) == "scheduled"

        # threshold edit to cpu=700m opens the throttle; pod2 now schedules
        thr = h.store.get_throttle("default", "t1")
        new_spec = replace(
            thr.spec,
            threshold=ResourceAmount.of(pod=5, requests={"cpu": "700m", "memory": "1Gi"}),
        )
        h.store.update_throttle(replace(thr, spec=new_spec))
        h.settle()
        assert h.schedule_attempt(h.store.get_pod("default", "pod2")) == "scheduled"

        # used is now cpu=500m; pod3 (300m) → insufficient (500+300 > 700)
        msg = h.create_and_schedule(labeled_pod("pod3", {"cpu": "300m"}))
        assert "throttle[insufficient]=default/t1" in msg

    def test_pod_count_throttle(self, harness):
        h = harness
        thr = Throttle(
            name="t1",
            spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(pod=2),
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                    )
                ),
            ),
        )
        h.store.create_throttle(thr)
        h.settle()
        assert h.create_and_schedule(labeled_pod("p1", {})) == "scheduled"
        assert h.create_and_schedule(labeled_pod("p2", {})) == "scheduled"
        msg = h.create_and_schedule(labeled_pod("p3", {}))
        assert "throttle[active]=default/t1" in msg

    def test_burst_exactly_20_of_21_fit(self, harness):
        """throttle_test.go:167-197 — reservation double-count prevention:
        21 pods × 50m vs cpu=1; exactly 20 admit BEFORE any reconcile."""
        h = harness
        thr = Throttle(
            name="burst",
            spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(requests={"cpu": "1"}),
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                    )
                ),
            ),
        )
        h.store.create_throttle(thr)
        h.settle()
        admitted = 0
        for i in range(21):
            pod = labeled_pod(f"b{i}", {"cpu": "50m"})
            h.store.create_pod(pod)
            status = h.plugin.pre_filter(pod)
            if status.is_success():
                assert h.plugin.reserve(pod).is_success()
                admitted += 1
            # deliberately NO settle: reservations alone must prevent
            # double-admission within the scheduling cycle window
        assert admitted == 20

    def test_clusterthrottle_burst_exactly_20_of_21_fit(self, harness):
        """clusterthrottle_test.go mirror of the burst: the CLUSTER kind's
        separately-implemented reserve path must prevent double-admission
        inside the scheduling-cycle window just like the namespaced one."""
        h = harness
        ct = ClusterThrottle(
            name="cburst",
            spec=ClusterThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(requests={"cpu": "1"}),
                selector=ClusterThrottleSelector(
                    selector_terms=(
                        ClusterThrottleSelectorTerm(
                            pod_selector=LabelSelector(match_labels={"throttle": "t1"})
                        ),
                    )
                ),
            ),
        )
        h.store.create_cluster_throttle(ct)
        h.settle()
        admitted = 0
        for i in range(21):
            pod = labeled_pod(f"cb{i}", {"cpu": "50m"})
            h.store.create_pod(pod)
            status = h.plugin.pre_filter(pod)
            if status.is_success():
                assert h.plugin.reserve(pod).is_success()
                admitted += 1
            # deliberately NO settle (see the namespaced variant)
        assert admitted == 20

    def test_unreserve_on_bind_failure(self, harness):
        h = harness
        thr = Throttle(
            name="t1",
            spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(requests={"cpu": "100m"}),
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                    )
                ),
            ),
        )
        h.store.create_throttle(thr)
        h.settle()
        pod = labeled_pod("p1", {"cpu": "100m"})
        h.store.create_pod(pod)
        assert h.plugin.pre_filter(pod).is_success()
        h.plugin.reserve(pod)
        # second pod is blocked by the reservation
        pod2 = labeled_pod("p2", {"cpu": "100m"})
        h.store.create_pod(pod2)
        assert not h.plugin.pre_filter(pod2).is_success()
        # bind fails → Unreserve rolls back → pod2 passes again
        h.plugin.unreserve(pod)
        assert h.plugin.pre_filter(pod2).is_success()


class TestTemporaryOverrides:
    def test_override_lifecycle_with_wakeup(self, harness):
        h = harness
        thr = Throttle(
            name="t1",
            spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(requests={"cpu": "100m"}),
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                    )
                ),
                temporary_threshold_overrides=(
                    TemporaryThresholdOverride(
                        begin=rfc(NOW - timedelta(hours=1)),
                        end=rfc(NOW + timedelta(hours=1)),
                        threshold=ResourceAmount.of(requests={"cpu": "1"}),
                    ),
                ),
            ),
        )
        h.store.create_throttle(thr)
        h.settle()
        got = h.store.get_throttle("default", "t1")
        assert got.status.calculated_threshold.threshold == ResourceAmount.of(
            requests={"cpu": "1"}
        )
        # while the override is active a 500m pod fits
        assert h.create_and_schedule(labeled_pod("p1", {"cpu": "500m"})) == "scheduled"

        # advance past the override end; the enqueue_after wakeup fires
        h.clock.advance(timedelta(hours=1, seconds=1))
        import time

        deadline = time.time() + 2
        while time.time() < deadline:
            if h.plugin.run_pending_once() > 0:
                break
            time.sleep(0.01)
        h.settle()
        got = h.store.get_throttle("default", "t1")
        # threshold reverts to spec (100m) and used 500m ≥ 100m → throttled
        assert got.status.calculated_threshold.threshold == ResourceAmount.of(
            requests={"cpu": "100m"}
        )
        assert got.status.throttled.resource_requests["cpu"] is True


class TestClusterThrottle:
    def test_namespace_scoped_matching(self, harness):
        h = harness
        h.store.create_namespace(Namespace("team-a", labels={"team": "a"}))
        h.store.create_namespace(Namespace("team-b", labels={"team": "b"}))
        clthr = ClusterThrottle(
            name="ct1",
            spec=ClusterThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(pod=1),
                selector=ClusterThrottleSelector(
                    selector_terms=(
                        ClusterThrottleSelectorTerm(
                            pod_selector=LabelSelector(match_labels={"throttle": "t1"}),
                            namespace_selector=LabelSelector(match_labels={"team": "a"}),
                        ),
                    )
                ),
            ),
        )
        h.store.create_cluster_throttle(clthr)
        h.settle()

        pod_a = make_pod("p1", namespace="team-a", labels={"throttle": "t1"})
        assert h.create_and_schedule(pod_a) == "scheduled"

        # second pod in the matched namespace is blocked (pod-count 1 reached)
        pod_a2 = make_pod("p2", namespace="team-a", labels={"throttle": "t1"})
        msg = h.create_and_schedule(pod_a2)
        assert "clusterthrottle[active]=/ct1" in msg

        # same labels in an unmatched namespace sail through
        pod_b = make_pod("p3", namespace="team-b", labels={"throttle": "t1"})
        assert h.create_and_schedule(pod_b) == "scheduled"

    def test_missing_namespace_is_error(self, harness):
        h = harness
        pod = make_pod("p1", namespace="ghost", labels={})
        h.store._create("Pod", pod)  # bypass: create pod without namespace object
        status = h.plugin.pre_filter(pod)
        assert status.code == StatusCode.ERROR


class TestLabelMove:
    def test_reservation_moves_on_label_change(self, harness):
        h = harness

        def throttle_for(label):
            return Throttle(
                name=f"t-{label}",
                spec=ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(requests={"cpu": "100m"}),
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": label})),
                        )
                    ),
                ),
            )

        h.store.create_throttle(throttle_for("a"))
        h.store.create_throttle(throttle_for("b"))
        h.settle()
        pod = make_pod("p1", labels={"throttle": "a"}, requests={"cpu": "100m"})
        h.store.create_pod(pod)
        h.plugin.reserve(pod)
        assert h.plugin.throttle_ctr.cache.reserved_pod_keys("default/t-a") == {"default/p1"}

        # bind the pod WITHOUT settling — the reservation is still held, and
        # only scheduled pods pass shouldCountIn in the update handler
        # (throttle_controller.go:453: pending-pod label changes are ignored)
        bound = make_pod(
            "p1", labels={"throttle": "a"}, requests={"cpu": "100m"}, node_name="node-1"
        )
        h.store.update_pod(bound)
        assert h.plugin.throttle_ctr.cache.reserved_pod_keys("default/t-a") == {"default/p1"}

        # label flips a→b on the bound pod while still reserved
        moved = make_pod(
            "p1", labels={"throttle": "b"}, requests={"cpu": "100m"}, node_name="node-1"
        )
        h.store.update_pod(moved)
        assert h.plugin.throttle_ctr.cache.reserved_pod_keys("default/t-a") == set()
        assert h.plugin.throttle_ctr.cache.reserved_pod_keys("default/t-b") == {"default/p1"}
