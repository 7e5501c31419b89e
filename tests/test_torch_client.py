"""Client layer: typed clientset verbs, watch streams, informers, listers
(parity with pkg/generated/ — SURVEY.md §2.2)."""

import queue
import threading

import pytest

from kube_throttler_tpu_torch.api import (
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.serialization import (
    cluster_throttle_from_dict,
    cluster_throttle_to_dict,
    pod_from_dict,
    pod_to_dict,
    throttle_from_dict,
    throttle_to_dict,
)
from kube_throttler_tpu_torch.client import (
    Clientset,
    SharedInformerFactory,
    ThrottleLister,
    json_merge_patch,
    new_fake_clientset,
)
from kube_throttler_tpu_torch.client.listers import ClusterThrottleLister, PodLister
from kube_throttler_tpu_torch.engine.store import EventType, Store
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _throttle(name, ns="default", cpu="1", pod=5):
    return Throttle(
        name=name,
        namespace=ns,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(pod=pod, requests={"cpu": cpu}),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": name})),
                )
            ),
        ),
    )


def _cluster_throttle(name, cpu="1"):
    return ClusterThrottle(
        name=name,
        spec=ClusterThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(requests={"cpu": cpu}),
            selector=ClusterThrottleSelector(
                selector_terms=(
                    ClusterThrottleSelectorTerm(
                        pod_selector=LabelSelector(match_labels={"ct": name})
                    ),
                )
            ),
        ),
    )


class TestClientsetVerbs:
    def test_create_get_list_delete(self):
        cs = new_fake_clientset(Namespace("default"))
        api = cs.schedule_v1alpha1().throttles("default")
        api.create(_throttle("t1"))
        api.create(_throttle("t2"))
        assert api.get("t1").name == "t1"
        assert sorted(t.name for t in api.list()) == ["t1", "t2"]
        api.delete("t1")
        assert [t.name for t in api.list()] == ["t2"]

    def test_namespace_scoping(self):
        cs = new_fake_clientset(Namespace("default"), Namespace("other"))
        cs.schedule_v1alpha1().throttles("default").create(_throttle("t1"))
        cs.schedule_v1alpha1().throttles("other").create(_throttle("t1", ns="other"))
        assert len(cs.schedule_v1alpha1().throttles("default").list()) == 1
        assert len(cs.store.list_throttles()) == 2
        # create through a namespace-scoped interface forces that namespace
        cs.schedule_v1alpha1().throttles("other").create(_throttle("t2", ns="default"))
        assert cs.store.get_throttle("other", "t2").namespace == "other"

    def test_update_and_update_status(self):
        from dataclasses import replace

        from kube_throttler_tpu_torch.api.types import ThrottleStatus

        cs = new_fake_clientset(_throttle("t1"))
        api = cs.schedule_v1alpha1().throttles("default")
        t = api.get("t1")
        api.update(replace(t, spec=replace(t.spec, threshold=ResourceAmount.of(pod=9))))
        assert api.get("t1").spec.threshold.resource_counts == 9
        api.update_status(t.with_status(ThrottleStatus(used=ResourceAmount.of(pod=2))))
        got = api.get("t1")
        assert got.status.used.resource_counts == 2
        assert got.spec.threshold.resource_counts == 9  # status write keeps spec

    def test_delete_collection_with_predicate(self):
        cs = new_fake_clientset(_throttle("t1"), _throttle("t2"), _throttle("keep"))
        api = cs.schedule_v1alpha1().throttles("default")
        deleted = api.delete_collection(lambda t: t.name.startswith("t"))
        assert sorted(t.name for t in deleted) == ["t1", "t2"]
        assert [t.name for t in api.list()] == ["keep"]

    def test_patch_merge_semantics(self):
        cs = new_fake_clientset(_throttle("t1", cpu="1", pod=5))
        api = cs.schedule_v1alpha1().throttles("default")
        api.patch("t1", {"spec": {"threshold": {"resourceRequests": {"cpu": "200m"}}}})
        got = api.get("t1")
        # patched dimension replaced, sibling dimensions survive the merge
        assert got.spec.threshold.resource_requests["cpu"] == pytest.approx(0.2)
        assert got.spec.threshold.resource_counts == 5
        assert got.spec.selector.selector_terms  # untouched subtree preserved

    def test_cluster_throttle_interface(self):
        cs = new_fake_clientset(_cluster_throttle("ct1"))
        api = cs.schedule_v1alpha1().cluster_throttles()
        assert api.get("ct1").name == "ct1"
        api.patch("ct1", {"spec": {"threshold": {"resourceCounts": {"pod": 3}}}})
        assert api.get("ct1").spec.threshold.resource_counts == 3
        api.delete_collection()
        assert api.list() == []

    def test_pod_interface(self):
        cs = new_fake_clientset(Namespace("default"))
        pods = cs.core_v1().pods("default")
        pods.create(make_pod("p1", requests={"cpu": "100m"}))
        pods.patch("p1", {"spec": {"nodeName": "node-1"}})
        assert pods.get("p1").spec.node_name == "node-1"


class TestReviewRegressions:
    def test_patch_preserves_microsecond_calculated_at(self):
        from datetime import datetime, timezone

        from kube_throttler_tpu_torch.api.types import CalculatedThreshold, ThrottleStatus

        cs = new_fake_clientset(_throttle("t1"))
        api = cs.schedule_v1alpha1().throttles("default")
        stamped = ThrottleStatus(
            calculated_threshold=CalculatedThreshold(
                threshold=ResourceAmount.of(pod=5),
                calculated_at=datetime(2024, 3, 1, 1, 2, 3, 456789, tzinfo=timezone.utc),
            )
        )
        api.update_status(api.get("t1").with_status(stamped))
        api.patch("t1", {"spec": {"threshold": {"resourceCounts": {"pod": 7}}}})
        got = api.get("t1")
        assert got.status.calculated_threshold.calculated_at == stamped.calculated_threshold.calculated_at
        # and the serializer itself round-trips fractional seconds
        assert throttle_from_dict(throttle_to_dict(got)).status == got.status

    def test_patch_accepts_reference_typo_spelling(self):
        cs = new_fake_clientset(_throttle("t1"))
        api = cs.schedule_v1alpha1().throttles("default")
        api.patch(
            "t1",
            {
                "spec": {
                    "selector": {
                        "selecterTerms": [{"podSelector": {"matchLabels": {"a": "new"}}}]
                    }
                }
            },
        )
        terms = api.get("t1").spec.selector.selector_terms
        assert len(terms) == 1
        assert terms[0].pod_selector.match_labels == {"a": "new"}

    def test_update_cannot_clobber_controller_status(self):
        from dataclasses import replace

        from kube_throttler_tpu_torch.api.types import ThrottleStatus

        cs = new_fake_clientset(_throttle("t1"))
        api = cs.schedule_v1alpha1().throttles("default")
        stale = api.get("t1")  # read BEFORE the controller writes status
        api.update_status(stale.with_status(ThrottleStatus(used=ResourceAmount.of(pod=3))))
        # spec update from the stale read must not wipe status (subresource
        # semantics) — neither via update nor via patch
        api.update(replace(stale, spec=replace(stale.spec, threshold=ResourceAmount.of(pod=8))))
        got = api.get("t1")
        assert got.spec.threshold.resource_counts == 8
        assert got.status.used.resource_counts == 3
        api.patch("t1", {"spec": {"threshold": {"resourceCounts": {"pod": 9}}}})
        assert api.get("t1").status.used.resource_counts == 3

    def test_pod_patch_preserves_uid(self):
        cs = new_fake_clientset(Namespace("default"))
        pods = cs.core_v1().pods("default")
        created = pods.create(make_pod("p1", requests={"cpu": "100m"}))
        patched = pods.patch("p1", {"spec": {"nodeName": "n1"}})
        assert patched.uid == created.uid
        assert pod_from_dict(pod_to_dict(created)).uid == created.uid

    def test_resync_never_resurrects_deleted_object(self):
        store = Store()
        factory = SharedInformerFactory(store, resync_period=0.01)
        inf = factory.pods()
        alive = {}
        errors = []

        def handler(e):
            key = f"{e.obj.namespace}/{e.obj.name}"
            if e.type == EventType.DELETED:
                alive.pop(key, None)
            else:
                if e.type == EventType.MODIFIED and e.old_obj is e.obj and key not in alive:
                    errors.append(f"sync event for deleted {key}")
                alive[key] = e.obj

        inf.add_event_handler(handler)
        factory.start()
        import time

        for i in range(60):
            store.create_pod(make_pod(f"p{i}"))
            time.sleep(0.002)
            store.delete_pod("default", f"p{i}")
        time.sleep(0.05)
        factory.shutdown()
        assert errors == []
        assert alive == {}


class TestJsonMergePatch:
    def test_rfc7386_cases(self):
        # from RFC 7386 appendix A
        assert json_merge_patch({"a": "b"}, {"a": "c"}) == {"a": "c"}
        assert json_merge_patch({"a": "b"}, {"b": "c"}) == {"a": "b", "b": "c"}
        assert json_merge_patch({"a": "b"}, {"a": None}) == {}
        assert json_merge_patch({"a": "b", "b": "c"}, {"a": None}) == {"b": "c"}
        assert json_merge_patch({"a": ["b"]}, {"a": "c"}) == {"a": "c"}
        assert json_merge_patch({"a": {"b": "c"}}, {"a": {"b": "d", "c": None}}) == {
            "a": {"b": "d"}
        }
        assert json_merge_patch({"a": [{"b": "c"}]}, {"a": [1]}) == {"a": [1]}


class TestRoundTrip:
    def test_throttle_roundtrip(self):
        from datetime import datetime, timezone

        from kube_throttler_tpu_torch.api.types import (
            CalculatedThreshold,
            IsResourceAmountThrottled,
            TemporaryThresholdOverride,
            ThrottleStatus,
        )

        t = _throttle("t1")
        t = Throttle(
            name=t.name,
            namespace=t.namespace,
            spec=ThrottleSpec(
                throttler_name=t.spec.throttler_name,
                threshold=t.spec.threshold,
                temporary_threshold_overrides=(
                    TemporaryThresholdOverride(
                        begin="2024-01-01T00:00:00Z",
                        end="2024-01-02T00:00:00Z",
                        threshold=ResourceAmount.of(requests={"cpu": "2"}),
                    ),
                ),
                selector=t.spec.selector,
            ),
            status=ThrottleStatus(
                calculated_threshold=CalculatedThreshold(
                    threshold=ResourceAmount.of(pod=5, requests={"cpu": "1"}),
                    calculated_at=datetime(2024, 1, 1, 12, tzinfo=timezone.utc),
                    messages=("ok",),
                ),
                throttled=IsResourceAmountThrottled(
                    resource_counts_pod=True, resource_requests={"cpu": False}
                ),
                used=ResourceAmount.of(pod=5, requests={"cpu": "900m"}),
            ),
        )
        assert throttle_from_dict(throttle_to_dict(t)) == t

    def test_cluster_throttle_roundtrip(self):
        ct = _cluster_throttle("ct1")
        assert cluster_throttle_from_dict(cluster_throttle_to_dict(ct)) == ct

    def test_pod_roundtrip_effective_request(self):
        from kube_throttler_tpu_torch.resourcelist import pod_request_resource_list

        p = make_pod(
            "p1",
            requests={"cpu": "100m", "memory": "1Gi"},
            init_requests=[{"cpu": "500m"}],
            overhead={"cpu": "10m"},
            node_name="n1",
            phase="Running",
        )
        p2 = pod_from_dict(pod_to_dict(p))
        assert pod_request_resource_list(p2) == pod_request_resource_list(p)
        assert p2.spec.node_name == "n1" and p2.status.phase == "Running"


class TestWatch:
    def test_watch_stream_and_stop(self):
        cs = new_fake_clientset(_throttle("t0"))
        api = cs.schedule_v1alpha1().throttles("default")
        w = api.watch(replay=True)
        e = w.next(timeout=1)
        assert e.type == EventType.ADDED and e.obj.name == "t0"
        api.create(_throttle("t1"))
        api.delete("t1")
        assert [(w.next(timeout=1).type) for _ in range(2)] == [
            EventType.ADDED,
            EventType.DELETED,
        ]
        w.stop()
        with pytest.raises(StopIteration):
            w.next(timeout=1)
        # after stop, further mutations do not reach the stream
        api.create(_throttle("t2"))
        with pytest.raises(StopIteration):
            w.next(timeout=1)

    def test_watch_namespace_filter(self):
        cs = new_fake_clientset(Namespace("default"), Namespace("other"))
        w = cs.schedule_v1alpha1().throttles("other").watch()
        cs.schedule_v1alpha1().throttles("default").create(_throttle("t1"))
        cs.schedule_v1alpha1().throttles("other").create(_throttle("t2", ns="other"))
        assert w.next(timeout=1).obj.name == "t2"
        with pytest.raises(queue.Empty):
            w.next(timeout=0.05)
        w.stop()

    def test_watch_from_consumer_thread(self):
        cs = new_fake_clientset()
        w = cs.schedule_v1alpha1().cluster_throttles().watch()
        seen = []

        def consume():
            for e in w:
                seen.append(e.obj.name)

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        for i in range(10):
            cs.schedule_v1alpha1().cluster_throttles().create(_cluster_throttle(f"c{i}"))
        w.stop()
        t.join(timeout=2)
        assert not t.is_alive()
        assert seen == [f"c{i}" for i in range(10)]


class TestInformersAndListers:
    def test_indexer_namespace_index_and_listers(self):
        store = Store()
        factory = SharedInformerFactory(store, resync_period=0)
        inf = factory.throttles()
        store.create_throttle(_throttle("t1"))
        store.create_throttle(_throttle("t2", ns="other"))
        lister = ThrottleLister(inf.indexer)
        assert sorted(t.name for t in lister.list()) == ["t1", "t2"]
        assert [t.name for t in lister.throttles("other").list()] == ["t2"]
        assert lister.throttles("default").get("t1").namespace == "default"
        with pytest.raises(KeyError):
            lister.throttles("default").get("t2")
        store.delete_throttle("other", "t2")
        assert lister.throttles("other").list() == []
        factory.shutdown()

    def test_informer_replays_preexisting_objects(self):
        store = Store()
        store.create_cluster_throttle(_cluster_throttle("ct1"))
        factory = SharedInformerFactory(store, resync_period=0)
        inf = factory.cluster_throttles()  # created after the object existed
        assert ClusterThrottleLister(inf.indexer).get("ct1").name == "ct1"
        seen = []
        inf.add_event_handler(lambda e: seen.append((e.type, e.obj.name)))
        assert seen == [(EventType.ADDED, "ct1")]
        assert factory.wait_for_cache_sync()
        factory.shutdown()

    def test_resync_redelivers_sync_events(self):
        store = Store()
        store.create_pod(make_pod("p1"))
        factory = SharedInformerFactory(store, resync_period=0.05)
        inf = factory.pods()
        synced = threading.Event()

        def handler(e):
            if e.type == EventType.MODIFIED and e.old_obj is e.obj:
                synced.set()

        inf.add_event_handler(handler, replay=False)
        factory.start()
        assert synced.wait(timeout=2), "resync never fired"
        factory.shutdown()

    def test_pod_lister_namespace_view(self):
        store = Store()
        factory = SharedInformerFactory(store, resync_period=0)
        lister = PodLister(factory.pods().indexer)
        store.create_pod(make_pod("a", namespace="ns1"))
        store.create_pod(make_pod("b", namespace="ns2"))
        store.create_pod(make_pod("c", namespace="ns1"))
        assert sorted(p.name for p in lister.pods("ns1").list()) == ["a", "c"]
        assert lister.pods("ns2").get("b").name == "b"
        # predicate filter (the labels.Selector analog)
        assert [p.name for p in lister.list(lambda p: p.name == "b")] == ["b"]
        factory.shutdown()


class TestFakeClientset:
    def test_preloaded_objects_visible_through_all_surfaces(self):
        cs = new_fake_clientset(
            Namespace("ns1", labels={"team": "a"}),
            _throttle("t1", ns="ns1"),
            _cluster_throttle("ct1"),
            make_pod("p1", namespace="ns1"),
        )
        assert cs.schedule_v1alpha1().throttles("ns1").get("t1").name == "t1"
        assert cs.schedule_v1alpha1().cluster_throttles().get("ct1").name == "ct1"
        assert cs.core_v1().pods("ns1").get("p1").name == "p1"
        assert cs.core_v1().namespaces().get("ns1").labels == {"team": "a"}
