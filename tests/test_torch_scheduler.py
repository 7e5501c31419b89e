"""The embedded scheduler loop: schedule-one cycle, burst admission with
reservation-based double-count prevention, event-driven requeue of
unschedulable pods (reference integration scenarios throttle_test.go and
the WakeupBackoffPod hint, driven here without a cluster)."""

import threading
import time
from dataclasses import replace

from kube_throttler_tpu_torch.api import (
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.plugin.framework import RecordingEventRecorder
from kube_throttler_tpu_torch.scheduler import Node, Scheduler
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _setup(nodes=None, use_device=False):
    store = Store()
    store.create_namespace(Namespace("default"))
    recorder = RecordingEventRecorder()
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store,
        event_recorder=recorder,
        use_device=use_device,
        device="cpu",
    )
    sched = Scheduler(plugin, store, nodes=nodes)
    return store, plugin, sched, recorder


def _throttle(name, pod=None, cpu=None):
    requests = {"cpu": cpu} if cpu else None
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(pod=pod, requests=requests),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": name})),
                )
            ),
        ),
    )


class TestScheduleOne:
    def test_binds_pending_pod_and_it_counts_into_used(self):
        store, plugin, sched, _ = _setup()
        store.create_throttle(_throttle("t1", pod=5))
        store.create_pod(make_pod("p1", labels={"throttle": "t1"}, requests={"cpu": "100m"}))
        bound = sched.run_until_idle()
        assert bound == 1
        pod = store.get_pod("default", "p1")
        assert pod.spec.node_name == "node-1"
        status = store.get_throttle("default", "t1").status
        assert status.used.resource_counts == 1

    def test_wrong_scheduler_name_ignored(self):
        store, plugin, sched, _ = _setup()
        store.create_pod(make_pod("alien", scheduler_name="other-scheduler"))
        assert sched.run_until_idle() == 0
        assert store.get_pod("default", "alien").spec.node_name == ""

    def test_node_capacity_limits_binding(self):
        store, plugin, sched, recorder = _setup(nodes=[Node("tiny", max_pods=2)])
        for i in range(3):
            store.create_pod(make_pod(f"p{i}"))
        assert sched.run_until_idle() == 2
        assert sched.pending_count() == 1
        assert any(
            e.reason == "FailedScheduling" and "nodes are available" in e.note
            for e in recorder.events
        )

    def test_node_allocatable_limits_binding(self):
        """NodeResourcesFit analog: cpu=1 node fits exactly two 500m pods;
        deleting one frees the capacity and the parked pod binds."""
        store, plugin, sched, recorder = _setup(
            nodes=[Node("small", allocatable={"cpu": "1"})]
        )
        for i in range(3):
            store.create_pod(make_pod(f"p{i}", requests={"cpu": "500m"}))
        assert sched.run_until_idle() == 2
        assert sched.pending_count() == 1
        assert any(
            e.reason == "FailedScheduling" and "nodes are available" in e.note
            for e in recorder.events
        )
        bound = [p for p in store.list_pods() if p.spec.node_name]
        store.delete_pod(bound[0].namespace, bound[0].name)
        assert sched.run_until_idle() == 1  # freed capacity admits the third
        assert sum(1 for p in store.list_pods() if p.spec.node_name) == 2

    def test_undeclared_resource_never_fits(self):
        store, plugin, sched, _ = _setup(
            nodes=[Node("cpu-only", allocatable={"cpu": "64"})]
        )
        store.create_pod(
            make_pod("gpu-pod", requests={"cpu": "100m", "nvidia.com/gpu": "1"})
        )
        assert sched.run_until_idle() == 0
        assert sched.pending_count() == 1

    def test_zero_request_for_undeclared_resource_still_fits(self):
        """NodeResourcesFit skips zero requests: a 0-gpu request must not
        block binding on a cpu-only node."""
        store, plugin, sched, _ = _setup(
            nodes=[Node("cpu-only", allocatable={"cpu": "64"})]
        )
        store.create_pod(
            make_pod("zero-gpu", requests={"cpu": "100m", "nvidia.com/gpu": "0"})
        )
        assert sched.run_until_idle() == 1

    def test_resource_blind_node_still_binds_anything(self):
        store, plugin, sched, _ = _setup(nodes=[Node("blind")])
        store.create_pod(make_pod("big", requests={"cpu": "10000"}))
        assert sched.run_until_idle() == 1


class TestBurstAdmission:
    def test_21_pods_exactly_20_fit_under_1_cpu(self):
        """throttle_test.go:167-197 — the reserve path must prevent
        double-admission inside a burst."""
        store, plugin, sched, recorder = _setup()
        store.create_throttle(_throttle("t1", cpu="1"))
        plugin.run_pending_once()
        for i in range(21):
            store.create_pod(
                make_pod(f"burst-{i:02d}", labels={"throttle": "t1"}, requests={"cpu": "50m"})
            )
        bound = sched.run_until_idle()
        assert bound == 20
        scheduled = [p for p in store.list_pods() if p.is_scheduled()]
        assert len(scheduled) == 20
        assert sched.pending_count() == 1
        status = store.get_throttle("default", "t1").status
        assert status.used.resource_requests["cpu"] == 1
        assert status.throttled.resource_requests["cpu"] is True
        assert any(e.reason == "FailedScheduling" for e in recorder.events)

    def test_pod_count_threshold_burst(self):
        store, plugin, sched, _ = _setup()
        store.create_throttle(_throttle("t1", pod=3))
        plugin.run_pending_once()
        for i in range(5):
            store.create_pod(make_pod(f"p{i}", labels={"throttle": "t1"}))
        assert sched.run_until_idle() == 3
        assert sched.pending_count() == 2


class TestEventDrivenRequeue:
    def test_threshold_edit_wakes_pending_pod(self):
        """README walkthrough: pod2 stays Pending under the old threshold and
        schedules after the threshold edit (a Throttle MODIFIED hint)."""
        store, plugin, sched, _ = _setup()
        store.create_throttle(_throttle("t1", cpu="200m"))
        store.create_pod(make_pod("pod1", labels={"throttle": "t1"}, requests={"cpu": "200m"}))
        assert sched.run_until_idle() == 1
        store.create_pod(make_pod("pod2", labels={"throttle": "t1"}, requests={"cpu": "300m"}))
        assert sched.run_until_idle() == 0
        assert sched.pending_count() == 1

        thr = store.get_throttle("default", "t1")
        new_spec = replace(thr.spec, threshold=ResourceAmount.of(requests={"cpu": "700m"}))
        store.update_throttle_spec(replace(thr, spec=new_spec))
        assert sched.run_until_idle() == 1
        assert store.get_pod("default", "pod2").is_scheduled()

    def test_pod_delete_frees_capacity_and_requeues(self):
        store, plugin, sched, _ = _setup()
        store.create_throttle(_throttle("t1", pod=1))
        store.create_pod(make_pod("p1", labels={"throttle": "t1"}))
        assert sched.run_until_idle() == 1
        store.create_pod(make_pod("p2", labels={"throttle": "t1"}))
        assert sched.run_until_idle() == 0
        store.delete_pod("default", "p1")
        assert sched.run_until_idle() == 1
        assert store.get_pod("default", "p2").is_scheduled()

    def test_node_poke_requeues_backed_off_pod(self):
        """The WakeupBackoffPod hack (util_pod_test.go:206-225): a Node event
        retries unschedulable pods without any throttle change."""
        store, plugin, sched, _ = _setup(nodes=[Node("n1", max_pods=0)])
        store.create_pod(make_pod("p1"))
        assert sched.run_until_idle() == 0
        sched.nodes[0].max_pods = 10  # capacity appears out-of-band
        assert sched.run_until_idle(settle=False) == 0  # nothing requeued it yet
        sched.poke_nodes()
        assert sched.run_until_idle() == 1


class TestNodeOccupancy:
    def test_delete_frees_node_capacity_under_churn(self):
        """Bind/delete churn beyond max_pods must not exhaust the node: the
        slot is freed on pod deletion (occupancy is event-driven, not a
        high-water mark)."""
        store, plugin, sched, _ = _setup(nodes=[Node("n1", max_pods=2)])
        for i in range(6):
            store.create_pod(make_pod(f"churn-{i}"))
            assert sched.run_until_idle() >= 1, f"churn round {i} failed to bind"
            store.delete_pod("default", f"churn-{i}")
        assert sched._bound_per_node["n1"] == 0

    def test_terminal_phase_frees_slot(self):
        store, plugin, sched, _ = _setup(nodes=[Node("n1", max_pods=1)])
        store.create_pod(make_pod("p1"))
        assert sched.run_until_idle() == 1
        p1 = store.get_pod("default", "p1")
        store.update_pod(replace(p1, status=replace(p1.status, phase="Succeeded")))
        assert sched._bound_per_node["n1"] == 0
        store.create_pod(make_pod("p2"))
        assert sched.run_until_idle() == 1

    def test_preexisting_bound_pods_counted_via_replay(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        store.create_pod(make_pod("existing", node_name="n1"))
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            store,
            use_device=False,
            device="cpu",
        )
        sched = Scheduler(plugin, store, nodes=[Node("n1", max_pods=1)])
        assert sched._bound_per_node["n1"] == 1
        store.create_pod(make_pod("p2"))
        assert sched.run_until_idle() == 0  # node already full

    def test_sync_drain_then_realtime_loop_not_stranded(self):
        """A pod parked during an inf-clock sync drain must stay eligible for
        the real-time loop (backoff anchors to the real clock, not inf)."""
        store, plugin, sched, _ = _setup(nodes=[Node("n1", max_pods=0)])
        store.create_pod(make_pod("p1"))
        assert sched.run_until_idle() == 0
        sched.nodes[0].max_pods = 1
        sched.poke_nodes()
        deadline = time.monotonic() + 10
        key = None
        while key is None and time.monotonic() < deadline:
            key = sched.schedule_one()  # real clock
            if key is None:
                time.sleep(0.01)
        assert key == "default/p1"


class TestConcurrentPatch:
    def test_parallel_patches_both_land(self):
        from kube_throttler_tpu_torch.client import new_fake_clientset

        cs = new_fake_clientset()
        api = cs.schedule_v1alpha1().cluster_throttles()
        from kube_throttler_tpu_torch.api import (
            ClusterThrottle,
            ClusterThrottleSpec,
        )

        api.create(ClusterThrottle(name="ct", spec=ClusterThrottleSpec()))
        errs = []

        def patch_many(field, n):
            try:
                for i in range(n):
                    api.patch(
                        "ct", {"spec": {"threshold": {"resourceRequests": {field: str(i + 1)}}}}
                    )
            except Exception as e:  # pragma: no cover
                errs.append(e)

        t1 = threading.Thread(target=patch_many, args=("cpu", 50))
        t2 = threading.Thread(target=patch_many, args=("memory", 50))
        t1.start(), t2.start(), t1.join(), t2.join()
        assert errs == []
        reqs = api.get("ct").spec.threshold.resource_requests
        # both writers' final values survive — no lost updates
        assert reqs["cpu"] == 50 and reqs["memory"] == 50


class TestBackgroundLoop:
    def test_threaded_scheduler_drains_burst(self):
        store, plugin, sched, _ = _setup()
        store.create_throttle(_throttle("t1", pod=10))
        plugin.start()  # controller worker threads
        sched.start()
        try:
            for i in range(10):
                store.create_pod(make_pod(f"p{i}", labels={"throttle": "t1"}))
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if sum(p.is_scheduled() for p in store.list_pods()) == 10:
                    break
                time.sleep(0.02)
            assert sum(p.is_scheduled() for p in store.list_pods()) == 10
        finally:
            sched.stop()
            plugin.stop()


class TestRequeueRaces:
    """Regression tests for the three scheduler findings: delete-wake,
    mid-cycle lost wakeup, and non-atomic bind."""

    def test_pod_delete_frees_slot_and_wakes_parked_pods(self):
        # Node(max_pods=1), NO throttles: p1 binds, p2 parks on "0/1 nodes
        # available". Deleting p1 must requeue p2 without any throttle event.
        store, plugin, sched, _ = _setup(nodes=[Node("n1", max_pods=1)])
        store.create_pod(make_pod("p1", requests={"cpu": "1m"}))
        store.create_pod(make_pod("p2", requests={"cpu": "1m"}))
        assert sched.run_until_idle() == 1
        assert len(sched._unschedulable) == 1
        store.delete_pod("default", "p1")
        # the DELETED handler freed the slot and moved p2 back to active
        assert not sched._unschedulable
        assert sched.run_until_idle() == 1
        assert store.get_pod("default", "p2").is_scheduled()

    def test_wake_during_cycle_keeps_pod_active(self):
        # A requeue hint that fires while the pod is popped (pre-park) must
        # not be lost: the pod re-enters _active instead of _unschedulable.
        store, plugin, sched, _ = _setup()
        store.create_throttle(_throttle("t1", cpu="100m"))
        store.create_pod(make_pod("p1", labels={"throttle": "t1"}, requests={"cpu": "500m"}))
        plugin.run_pending_once()

        orig = plugin.pre_filter

        def pre_filter_with_midcycle_event(pod):
            status = orig(pod)
            # a threshold edit lands while this cycle is in flight
            thr = store.get_throttle("default", "t1")
            store.update_throttle_spec(
                replace(thr, spec=replace(thr.spec, threshold=ResourceAmount.of(requests={"cpu": "1"})))
            )
            return status

        plugin.pre_filter = pre_filter_with_midcycle_event
        assert sched.schedule_one(now=float("inf")) is None  # blocked by stale state
        plugin.pre_filter = orig
        # the mid-cycle wake kept p1 in the active queue
        assert not sched._unschedulable and len(sched._active) == 1
        assert sched.run_until_idle() == 1

    def test_bind_preserves_concurrent_pod_patch(self):
        # A label patch landing between the cycle's read and its bind write
        # must survive the bind (bind sets only spec.nodeName).
        store, plugin, sched, _ = _setup()
        store.create_pod(make_pod("p1", requests={"cpu": "1m"}))

        orig = plugin.pre_filter

        def pre_filter_with_patch(pod):
            status = orig(pod)
            store.mutate(
                "Pod", pod.key,
                lambda cur: replace(cur, labels={**cur.labels, "patched": "yes"}),
            )
            return status

        plugin.pre_filter = pre_filter_with_patch
        assert sched.run_until_idle() == 1
        final = store.get_pod("default", "p1")
        assert final.is_scheduled()
        assert final.labels.get("patched") == "yes"
