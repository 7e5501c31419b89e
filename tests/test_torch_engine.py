"""State-engine components: store/watch, workqueue, reservations, index."""

import random
import threading
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from kube_throttler_tpu_torch.api import (
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    LabelSelector,
    Namespace,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.api.pod import make_pod
from kube_throttler_tpu_torch.api.types import LabelSelectorRequirement
from kube_throttler_tpu_torch.engine import RateLimitingQueue, ReservedResourceAmounts, Store
from kube_throttler_tpu_torch.engine.index import SelectorIndex
from kube_throttler_tpu_torch.engine.store import ConflictError, Event, EventType
from kube_throttler_tpu_torch.utils.clock import FakeClock
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


class TestStore:
    def test_watch_events_and_replay(self):
        store = Store()
        events = []
        pod = make_pod("p1")
        store.create_pod(pod)
        store.add_event_handler("Pod", events.append)  # replay existing
        store.update_pod(make_pod("p1", labels={"a": "b"}))
        store.delete_pod("default", "p1")
        assert [e.type for e in events] == [
            EventType.ADDED,
            EventType.MODIFIED,
            EventType.DELETED,
        ]
        assert events[1].old_obj.labels == {}

    def test_status_update_optimistic_concurrency(self):
        store = Store()
        thr = Throttle(name="t1", spec=ThrottleSpec(threshold=ResourceAmount.of(pod=1)))
        store.create_throttle(thr)
        rv = store.resource_version("Throttle", "default/t1")
        from kube_throttler_tpu_torch.api.types import ThrottleStatus

        updated = thr.with_status(ThrottleStatus(used=ResourceAmount.of(pod=1)))
        store.update_throttle_status(updated, expected_version=rv)
        with pytest.raises(ConflictError):
            store.update_throttle_status(updated, expected_version=rv)
        # spec is preserved on status write
        assert store.get_throttle("default", "t1").spec.threshold.resource_counts == 1


class TestWorkqueue:
    def test_dedup_while_queued(self):
        q = RateLimitingQueue("test")
        q.add("a")
        q.add("a")
        q.add("b")
        assert len(q) == 2

    def test_requeue_if_added_while_processing(self):
        q = RateLimitingQueue("test")
        q.add("a")
        item = q.get()
        q.add("a")  # while processing → dirty, not queued
        assert len(q) == 0
        q.done(item)
        assert len(q) == 1

    def test_add_after_with_fake_clock(self):
        clock = FakeClock(datetime(2024, 1, 1, tzinfo=timezone.utc))
        q = RateLimitingQueue("test", clock=clock)
        q.add_after("x", timedelta(seconds=60))
        import time

        time.sleep(0.02)
        assert len(q) == 0
        clock.advance(timedelta(seconds=61))
        deadline = time.time() + 2
        while len(q) == 0 and time.time() < deadline:
            time.sleep(0.005)
        assert len(q) == 1

    def test_rate_limited_backoff_and_forget(self):
        q = RateLimitingQueue("test")
        q.add_rate_limited("k")  # 5ms
        import time

        time.sleep(0.1)
        assert len(q) == 1
        assert q.num_requeues("k") == 1
        q.forget("k")
        assert q.num_requeues("k") == 0


class TestReservations:
    def test_idempotent_add_remove(self):
        cache = ReservedResourceAmounts(8)
        pod = make_pod("p1", requests={"cpu": "100m"})
        assert cache.add_pod("default/t1", pod)
        assert not cache.add_pod("default/t1", pod)  # overwrite, not new
        amt, keys = cache.reserved_resource_amount("default/t1")
        assert amt.resource_counts == 1 and keys == {"default/p1"}
        assert cache.remove_pod("default/t1", pod)
        assert not cache.remove_pod("default/t1", pod)
        amt, keys = cache.reserved_resource_amount("default/t1")
        assert amt == ResourceAmount() and keys == set()

    def test_move_assignment(self):
        cache = ReservedResourceAmounts(8)
        pod = make_pod("p1", requests={"cpu": "100m"})
        cache.add_pod("default/t1", pod)
        cache.move_throttle_assignment(pod, ["default/t1"], ["default/t2"])
        assert cache.reserved_pod_keys("default/t1") == set()
        assert cache.reserved_pod_keys("default/t2") == {"default/p1"}

    def test_concurrent_stress(self):
        # reserved_resource_amounts_test.go:33-108, scaled to Python threads
        cache = ReservedResourceAmounts(16)
        pods = [make_pod(f"p{i}", requests={"cpu": "1"}) for i in range(50)]
        keys = [f"default/t{i}" for i in range(8)]
        errors = []

        def worker(seed):
            rng = random.Random(seed)
            try:
                for _ in range(200):
                    key = rng.choice(keys)
                    pod = rng.choice(pods)
                    op = rng.random()
                    if op < 0.45:
                        cache.add_pod(key, pod)
                    elif op < 0.9:
                        cache.remove_pod(key, pod)
                    else:
                        cache.reserved_resource_amount(key)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        # ledger remains consistent: every remaining entry sums correctly
        for key in keys:
            amt, pod_keys = cache.reserved_resource_amount(key)
            assert (amt.resource_counts or 0) == len(pod_keys)


def _random_label(rng):
    return {f"k{rng.randrange(3)}": f"v{rng.randrange(3)}"}


class TestSelectorIndex:
    def _oracle_mask(self, index, pods, throttles, namespaces):
        out = {}
        for pk, pod in pods.items():
            for tk, thr in throttles.items():
                if isinstance(thr, Throttle):
                    want = thr.namespace == pod.namespace and thr.spec.selector.matches_to_pod(pod)
                else:
                    ns = namespaces.get(pod.namespace)
                    want = ns is not None and thr.spec.selector.matches_to_pod(pod, ns)
                out[(pk, tk)] = want
        return out

    @pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
    def test_random_churn_matches_oracle(self, kind):
        rng = random.Random(42)
        index = SelectorIndex(kind, pod_capacity=4, throttle_capacity=2)  # force growth
        pods, throttles, namespaces = {}, {}, {}

        for name in ("ns1", "ns2", "ns3"):
            ns = Namespace(name, labels=_random_label(rng))
            namespaces[name] = ns
            index.upsert_namespace(ns)

        def rand_throttle(i):
            n_terms = rng.randrange(0, 3)
            if kind == "throttle":
                terms = tuple(
                    ThrottleSelectorTerm(LabelSelector(match_labels=_random_label(rng)))
                    for _ in range(n_terms)
                )
                # occasionally a matchExpressions (general-tier) term
                if rng.random() < 0.3:
                    terms += (
                        ThrottleSelectorTerm(
                            LabelSelector(
                                match_expressions=(
                                    LabelSelectorRequirement(f"k{rng.randrange(3)}", "Exists"),
                                )
                            )
                        ),
                    )
                return Throttle(
                    name=f"t{i}",
                    namespace=rng.choice(["ns1", "ns2", "ns3"]),
                    spec=ThrottleSpec(selector=ThrottleSelector(selector_terms=terms)),
                )
            terms = tuple(
                ClusterThrottleSelectorTerm(
                    pod_selector=LabelSelector(match_labels=_random_label(rng)),
                    namespace_selector=LabelSelector(match_labels=_random_label(rng))
                    if rng.random() < 0.7
                    else LabelSelector(),
                )
                for _ in range(n_terms)
            )
            return ClusterThrottle(
                name=f"c{i}", spec=ClusterThrottleSpec(selector=ClusterThrottleSelector(selector_terms=terms))
            )

        for step in range(300):
            op = rng.random()
            if op < 0.35:
                pod = make_pod(
                    f"p{rng.randrange(20)}",
                    namespace=rng.choice(["ns1", "ns2", "ns3"]),
                    labels=_random_label(rng) if rng.random() < 0.8 else {},
                )
                pods[pod.key] = pod
                index.upsert_pod(pod)
            elif op < 0.5 and pods:
                key = rng.choice(list(pods))
                del pods[key]
                index.remove_pod(key)
            elif op < 0.8:
                thr = rand_throttle(rng.randrange(6))
                throttles[thr.key] = thr
                index.upsert_throttle(thr)
            elif op < 0.9 and throttles:
                key = rng.choice(list(throttles))
                del throttles[key]
                index.remove_throttle(key)
            else:
                name = rng.choice(["ns1", "ns2", "ns3"])
                ns = Namespace(name, labels=_random_label(rng))
                namespaces[name] = ns
                index.upsert_namespace(ns)
                # ns label change can flip throttle matches for its pods
                # (handled inside upsert_namespace)

        oracle = self._oracle_mask(index, pods, throttles, namespaces)
        for (pk, tk), want in oracle.items():
            row = index.pod_row(pk)
            col = index.throttle_col(tk)
            got = bool(index.mask[row, col])
            assert got == want, f"({pk},{tk}): index={got} oracle={want}"
        # affected queries agree with the mask
        for pk in pods:
            got = set(index.affected_throttle_keys(pk))
            want_keys = {tk for tk in throttles if oracle[(pk, tk)]}
            assert got == want_keys

    @pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
    def test_probe_cache_tracks_mutations(self, kind):
        """match_row_cached_locked must never serve a stale compiled-column
        evaluation: interleave probe queries (repeating (ns,labels) keys,
        so hits DO occur) with throttle/namespace churn and diff every
        result against the uncached evaluation."""
        rng = random.Random(7)
        index = SelectorIndex(kind, throttle_capacity=2)
        for name in ("ns1", "ns2"):
            index.upsert_namespace(Namespace(name, labels=_random_label(rng)))

        labels_pool = [_random_label(rng) for _ in range(5)]

        def probe():
            pod = make_pod(
                f"probe{rng.randrange(3)}",
                namespace=rng.choice(["ns1", "ns2"]),
                labels=rng.choice(labels_pool),
            )
            with index._lock:
                got = index.match_row_cached_locked(pod).copy()
                want = index._match_row_arbitrary_locked(pod)
            np.testing.assert_array_equal(got, want)

        mk_throttle = (
            (lambda i: Throttle(
                name=f"t{i}", namespace="ns1",
                spec=ThrottleSpec(selector=ThrottleSelector(selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels=_random_label(rng))),
                ))),
            ))
            if kind == "throttle"
            else (lambda i: ClusterThrottle(
                name=f"c{i}",
                spec=ClusterThrottleSpec(selector=ClusterThrottleSelector(selector_terms=(
                    ClusterThrottleSelectorTerm(
                        pod_selector=LabelSelector(match_labels=_random_label(rng))
                    ),
                ))),
            ))
        )
        live = {}
        for step in range(200):
            op = rng.random()
            if op < 0.5:
                probe()
            elif op < 0.8:
                thr = mk_throttle(rng.randrange(4))
                live[thr.key] = thr
                index.upsert_throttle(thr)
                probe()
            elif op < 0.9 and live:
                index.remove_throttle(live.popitem()[0])
                probe()
            else:
                index.upsert_namespace(
                    Namespace(rng.choice(["ns1", "ns2"]), labels=_random_label(rng))
                )
                probe()
        assert index._probe_cache, "cache should have entries"


class TestDeviceMirrorRegressions:
    """Round-1 review findings on the device mirror."""

    def _manager(self):
        from kube_throttler_tpu_torch.engine.devicestate import DeviceStateManager

        store = Store()
        store.create_namespace(Namespace("default"))
        mgr = DeviceStateManager(store, "kube-throttler", "my-scheduler", device="cpu")
        return store, mgr

    def _throttle(self, name, namespace="default", label="x", throttler="kube-throttler"):
        return Throttle(
            name=name,
            namespace=namespace,
            spec=ThrottleSpec(
                throttler_name=throttler,
                threshold=ResourceAmount.of(requests={"cpu": "100m"}),
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": label})),
                    )
                ),
            ),
        )

    def test_unknown_pod_fallback_respects_throttle_namespace(self):
        store, mgr = self._manager()
        store.create_namespace(Namespace("other"))
        store.create_throttle(self._throttle("t1", namespace="other"))
        # pod NOT in the store → fallback mask path
        pod = make_pod("ghost", namespace="default", labels={"throttle": "x"}, requests={"cpu": "1"})
        assert mgr.check_pod(pod, "throttle") == {}

    def test_throttler_name_change_removes_device_row(self):
        from dataclasses import replace

        store, mgr = self._manager()
        thr = self._throttle("t2")
        store.create_throttle(thr)
        pod = make_pod("p", labels={"throttle": "x"}, requests={"cpu": "1"})
        store.create_pod(pod)
        assert "default/t2" in mgr.check_pod(pod, "throttle")
        # rename the throttler → this throttler no longer governs t2
        store.update_throttle(replace(thr, spec=replace(thr.spec, throttler_name="someone-else")))
        assert mgr.check_pod(pod, "throttle") == {}

    def test_indexed_and_dense_check_branches_agree(self):
        """check_pod's indexed hot path vs its dense fallback over the SAME
        state — forced by tuning indexed_check_max (review finding: the dense
        branch was unreachable at the default 1024 threshold)."""
        store, mgr = self._manager()
        # several throttles at different saturation levels, all matching
        for i, cpu in enumerate(["50m", "100m", "1", "10"]):
            store.create_throttle(
                Throttle(
                    name=f"t{i}",
                    spec=ThrottleSpec(
                        throttler_name="kube-throttler",
                        threshold=ResourceAmount.of(pod=2 if i % 2 else None, requests={"cpu": cpu}),
                        selector=ThrottleSelector(
                            selector_terms=(
                                ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "x"})),
                            )
                        ),
                    ),
                )
            )
        pod = make_pod("p", labels={"throttle": "x"}, requests={"cpu": "200m"})
        store.create_pod(pod)
        for on_equal in (False, True):
            mgr.indexed_check_max = 1024
            hot = mgr.check_pod(pod, "throttle", on_equal=on_equal)
            mgr.indexed_check_max = 0  # force the dense branch
            dense = mgr.check_pod(pod, "throttle", on_equal=on_equal)
            assert hot == dense and len(hot) == 4

    def test_incremental_device_sync_matches_full_upload(self):
        """device_pods' row-scatter path (single-pod events) must produce
        the same check_batch results as a freshly-built manager that
        full-uploads, across interleaved pod churn, label moves, deletes,
        and a throttle edit (which still forces a full mask rebuild)."""
        import random
        from dataclasses import replace as dc_replace

        import numpy as np

        rng = random.Random(5)
        store, mgr = self._manager()
        store.create_throttle(self._throttle("t1", label="x"))
        store.create_throttle(self._throttle("t2", label="y"))

        live = {}
        for step in range(40):
            op = rng.random()
            if op < 0.5 or not live:
                name = f"p{step}"
                pod = make_pod(
                    name,
                    labels={"throttle": rng.choice("xy")},
                    requests={"cpu": f"{rng.randint(1, 4)}00m"},
                    node_name="n1" if rng.random() < 0.5 else "",
                )
                live[name] = pod
                try:
                    store.create_pod(pod)
                except ValueError:
                    store.update_pod(pod)
            elif op < 0.7:
                name = rng.choice(list(live))
                moved = dc_replace(live[name], labels={"throttle": rng.choice("xy")})
                live[name] = moved
                store.update_pod(moved)
            elif op < 0.85:
                name = rng.choice(list(live))
                del live[name]
                store.delete_pod("default", name)
            else:  # throttle edit → full mask invalidation interleaved
                thr = store.get_throttle("default", "t1")
                store.update_throttle(
                    dc_replace(
                        thr,
                        spec=dc_replace(
                            thr.spec,
                            threshold=ResourceAmount.of(requests={"cpu": f"{rng.randint(1, 9)}00m"}),
                        ),
                    )
                )

            counts_inc, sched_inc, rows_inc = mgr.check_batch("throttle")
            # fresh manager rebuilds everything from the same store state;
            # unsubscribe it afterwards or stale managers pile up handlers
            from kube_throttler_tpu_torch.engine.devicestate import DeviceStateManager

            fresh = DeviceStateManager(store, "kube-throttler", "my-scheduler", device="cpu")
            counts_full, sched_full, rows_full = fresh.check_batch("throttle")
            for kind_name, handler in (
                ("Namespace", fresh._on_namespace),
                ("Pod", fresh._on_pod),
                ("Throttle", fresh._on_throttle),
                ("ClusterThrottle", fresh._on_cluster_throttle),
            ):
                store.remove_event_handler(kind_name, handler)
            for key, row in rows_inc.items():
                frow = rows_full[key]
                np.testing.assert_array_equal(
                    np.asarray(counts_inc)[row], np.asarray(counts_full)[frow], err_msg=f"{step}:{key}"
                )
                assert bool(np.asarray(sched_inc)[row]) == bool(np.asarray(sched_full)[frow])

    def test_missing_namespace_never_matches_clusterthrottle(self):
        from kube_throttler_tpu_torch.engine.devicestate import DeviceStateManager

        store = Store()  # note: no namespace objects at all
        mgr = DeviceStateManager(store, "kube-throttler", "my-scheduler", device="cpu")
        clthr = ClusterThrottle(
            name="c1",
            spec=ClusterThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(requests={"cpu": "100m"}),
                selector=ClusterThrottleSelector(
                    selector_terms=(
                        ClusterThrottleSelectorTerm(
                            pod_selector=LabelSelector(match_labels={"throttle": "x"})
                        ),
                    )
                ),
            ),
        )
        store.create_cluster_throttle(clthr)
        pod = make_pod("p", namespace="ghost", labels={"throttle": "x"}, requests={"cpu": "1"})
        store.create_pod(pod)
        assert mgr.check_pod(pod, "clusterthrottle") == {}
        # once the namespace exists, the match appears
        store.create_namespace(Namespace("ghost"))
        assert "/c1" in mgr.check_pod(pod, "clusterthrottle")


def test_recording_event_recorder_aggregates_and_caps():
    from kube_throttler_tpu_torch.plugin.framework import RecordingEventRecorder

    r = RecordingEventRecorder(max_events=3)
    for _ in range(100):
        r.eventf("ns/p", "Warning", "FailedScheduling", "Scheduling", "same msg")
    assert len(r.events) == 1
    assert r.counts[r.events[0]] == 100
    for i in range(5):
        r.eventf("ns/p", "Warning", "FailedScheduling", "Scheduling", f"msg-{i}")
    assert len(r.events) == 3  # capped, oldest evicted
    assert len(r.counts) == 3


def test_sparse_cols_k_growth_through_dirty_row_path():
    """A pod relabel that multiplies its match count must escalate the
    sparse [P,K] cols ladder (K rung growth) through the dirty-row update,
    and the batch verdict must keep matching a fresh manager's."""
    from dataclasses import replace as dc_replace

    import numpy as np

    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.api.types import (
        LabelSelector,
        ResourceAmount,
        Throttle,
        ThrottleSelector,
        ThrottleSelectorTerm,
        ThrottleSpec,
    )
    from kube_throttler_tpu_torch.engine.devicestate import DeviceStateManager
    from kube_throttler_tpu_torch.engine.store import Store

    def throttle(name, labels):
        return Throttle(
            name=name,
            spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(requests={"cpu": "100m"}),
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels=labels)),
                    )
                ),
            ),
        )

    store = Store()
    store.create_namespace(Namespace("default"))
    mgr = DeviceStateManager(store, "kube-throttler", "my-scheduler", device="cpu")
    # 100 fillers (unique labels, match nothing) push tcap high enough that
    # the sparse path engages (at tiny tcap the dense fallback is correct)
    for i in range(100):
        store.create_throttle(throttle(f"t-fill{i}", {"fill": f"f{i}"}))
    for i in range(8):
        store.create_throttle(throttle(f"t-group{i}", {"grp": "a"}))
    store.create_throttle(throttle("t-solo", {"solo": "y"}))

    pod = make_pod("p0", labels={"solo": "y"}, requests={"cpu": "200m"},
                   node_name="n1")
    store.create_pod(pod)
    counts, _, rows = mgr.check_batch("throttle")
    assert int(np.asarray(counts)[rows["default/p0"]].sum()) == 1
    ks = mgr.throttle
    assert ks._cols_host is not None  # sparse path active
    k_before = ks._cols_K

    # relabel: now ALSO matches the 8 group throttles — nnz 9 > the K rung
    store.update_pod(
        dc_replace(pod, labels={"solo": "y", "grp": "a"})
    )
    counts, _, rows = mgr.check_batch("throttle")
    assert int(np.asarray(counts)[rows["default/p0"]].sum()) == 9
    assert ks._cols_host is not None and ks._cols_K > k_before  # rung grew

    fresh = DeviceStateManager(store, "kube-throttler", "my-scheduler", device="cpu")
    fcounts, _, frows = fresh.check_batch("throttle")
    np.testing.assert_array_equal(
        np.asarray(counts)[rows["default/p0"]],
        np.asarray(fcounts)[frows["default/p0"]],
    )
    for kind_name, handler in (
        ("Namespace", fresh._on_namespace),
        ("Pod", fresh._on_pod),
        ("Throttle", fresh._on_throttle),
        ("ClusterThrottle", fresh._on_cluster_throttle),
    ):
        store.remove_event_handler(kind_name, handler)


def test_store_batched_status_write_mixed_results():
    """One lock-hold batch write: successes update + dispatch MODIFIED with
    old_obj; a missing key reports NotFoundError in-place without failing
    the rest."""
    from kube_throttler_tpu_torch.api.pod import Namespace
    from kube_throttler_tpu_torch.api.types import (
        ResourceAmount,
        Throttle,
        ThrottleSpec,
        ThrottleStatus,
    )
    from kube_throttler_tpu_torch.engine.store import NotFoundError, Store

    store = Store()
    store.create_namespace(Namespace("default"))
    for name in ("a", "b"):
        store.create_throttle(
            Throttle(
                name=name,
                spec=ThrottleSpec(
                    throttler_name="kt", threshold=ResourceAmount.of(pod=3)
                ),
            )
        )
    events = []
    store.add_event_handler("Throttle", lambda e: events.append(e), replay=False)

    def with_used(name, pods):
        thr = store.get_throttle("default", name) if name != "ghost" else Throttle(
            name="ghost",
            spec=ThrottleSpec(throttler_name="kt", threshold=ResourceAmount.of(pod=3)),
        )
        return thr.with_status(
            ThrottleStatus(
                calculated_threshold=thr.status.calculated_threshold,
                throttled=thr.status.throttled,
                used=ResourceAmount.of(pod=pods),
            )
        )

    out = store.update_throttle_statuses(
        [with_used("a", 1), with_used("ghost", 9), with_used("b", 2)]
    )
    assert isinstance(out["default/ghost"], NotFoundError)
    assert out["default/a"].status.used.resource_counts == 1
    assert out["default/b"].status.used.resource_counts == 2
    mods = [e for e in events if e.type.name == "MODIFIED"]
    assert len(mods) == 2
    assert all(e.old_obj is not None for e in mods)
    # rv strictly increases across the batch
    assert store.resource_version("Throttle", "default/a") < store.resource_version(
        "Throttle", "default/b"
    )


def test_drain_requeues_only_failed_status_writes():
    """A per-key write failure inside the batched drain lands in the error
    map (→ rate-limited requeue) while the rest of the drain completes."""
    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.api.types import (
        LabelSelector,
        ResourceAmount,
        Throttle,
        ThrottleSelector,
        ThrottleSelectorTerm,
        ThrottleSpec,
    )
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

    store = Store()
    store.create_namespace(Namespace("default"))
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kt", "targetSchedulerName": "my-scheduler"}),
        store,
        use_device=False,
        start_workers=False, device="cpu",
    )
    for i in range(4):
        store.create_throttle(
            Throttle(
                name=f"t{i}",
                spec=ThrottleSpec(
                    throttler_name="kt",
                    threshold=ResourceAmount.of(pod=5),
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(
                                LabelSelector(match_labels={"g": f"g{i}"})
                            ),
                        )
                    ),
                ),
            )
        )
    for i in range(4):
        pod = make_pod(f"p{i}", labels={"g": f"g{i}"}, node_name="n1")
        pod.status.phase = "Running"
        store.create_pod(pod)

    ctr = plugin.throttle_ctr
    orig = store.update_throttle_statuses

    def poisoned(thrs):
        out = orig([t for t in thrs if t.name != "t2"])
        for t in thrs:
            if t.name == "t2":
                out["default/t2"] = RuntimeError("boom")
        return out

    store.update_throttle_statuses = poisoned
    errors = ctr.reconcile_batch([f"default/t{i}" for i in range(4)])
    assert set(errors) == {"default/t2"}
    assert isinstance(errors["default/t2"], RuntimeError)
    # the others' statuses landed
    for i in (0, 1, 3):
        assert (
            store.get_throttle("default", f"t{i}").status.used.resource_counts == 1
        )
    assert store.get_throttle("default", "t2").status.used.resource_counts is None


def test_self_echo_suppression_is_thread_scoped():
    """The self-echo signature is (writer thread, key, status identity):
    the SAME event object must suppress on the writing thread and must NOT
    suppress from any other thread — a concurrent spec-update write
    re-attaches the stored status object (with_status), and ITS echo,
    dispatched on the other writer's thread, has to enqueue or a threshold
    edit would sit until resync (review finding, r5)."""
    import threading

    from kube_throttler_tpu_torch.api import ResourceAmount, Throttle, ThrottleSpec
    from kube_throttler_tpu_torch.controllers import ThrottleController
    from kube_throttler_tpu_torch.engine.store import Event, EventType, Store

    store = Store()
    ctr = ThrottleController(
        throttler_name="kube-throttler",
        target_scheduler_name="my-scheduler",
        store=store,
    )
    thr = Throttle(
        name="t1", namespace="default",
        spec=ThrottleSpec(throttler_name="kube-throttler",
                          threshold=ResourceAmount.of(pod=1)),
    )
    ctr._inflight_status_echoes[thr.key] = (
        threading.get_ident(), id(thr.status),
    )
    event = Event(EventType.MODIFIED, "Throttle", thr, old_obj=thr)
    assert ctr._is_self_status_echo(event) is True

    seen = {}
    t = threading.Thread(
        target=lambda: seen.__setitem__("other", ctr._is_self_status_echo(event))
    )
    t.start(); t.join()
    assert seen["other"] is False  # other thread: never suppressed

    ctr._inflight_status_echoes.clear()
    assert ctr._is_self_status_echo(event) is False  # marker gone


class TestReservationTTL:
    """TTL'd reservations under a frozen clock: expiry, snapshot's
    remaining-budget serialization, and restore's
    charge-elapsed-then-rebase rule (never resurrect expired entries)."""

    T0 = datetime(2026, 8, 4, tzinfo=timezone.utc)

    def _cache(self, clock):
        return ReservedResourceAmounts(4, clock=clock)

    def test_ttl_expiry_is_clock_driven(self):
        clock = FakeClock(self.T0)
        cache = self._cache(clock)
        cache.add_pod("ns/t1", make_pod("p1"), ttl=30.0)
        cache.add_pod("ns/t1", make_pod("p2"))  # no TTL: reference lifetime
        amount, keys = cache.reserved_resource_amount("ns/t1")
        assert keys == {"default/p1", "default/p2"}
        assert amount.resource_counts == 2
        clock.advance(timedelta(seconds=29))
        assert cache.reserved_pod_keys("ns/t1") == {"default/p1", "default/p2"}
        clock.advance(timedelta(seconds=2))  # past p1's deadline
        amount, keys = cache.reserved_resource_amount("ns/t1")
        assert keys == {"default/p2"}
        assert amount.resource_counts == 1
        assert cache.expired_total == 1

    def test_re_add_refreshes_and_clears_deadlines(self):
        clock = FakeClock(self.T0)
        cache = self._cache(clock)
        cache.add_pod("ns/t1", make_pod("p1"), ttl=10.0)
        clock.advance(timedelta(seconds=8))
        cache.add_pod("ns/t1", make_pod("p1"))  # re-reserve WITHOUT a TTL
        clock.advance(timedelta(seconds=1000))
        assert cache.reserved_pod_keys("ns/t1") == {"default/p1"}

    def test_snapshot_serializes_remaining_budget_and_omits_expired(self):
        clock = FakeClock(self.T0)
        cache = self._cache(clock)
        cache.add_pod("ns/t1", make_pod("p1"), ttl=100.0)
        cache.add_pod("ns/t1", make_pod("p2"), ttl=10.0)
        clock.advance(timedelta(seconds=40))  # p2 already expired
        state = cache.snapshot_state()
        entries = state["ns/t1"]
        assert set(entries) == {"default/p1"}
        assert entries["default/p1"]["ttlRemainingSeconds"] == pytest.approx(60.0)

    def test_restore_charges_dead_time_then_rebases_on_restored_clock(self):
        clock = FakeClock(self.T0)
        cache = self._cache(clock)
        cache.add_pod("ns/t1", make_pod("keep"), ttl=100.0)
        cache.add_pod("ns/t1", make_pod("die"), ttl=10.0)
        state = cache.snapshot_state()

        # restart on a clock 50s later (the process was dead that long):
        # "die" (10s budget) must NOT resurrect; "keep" has 50s left
        restore_clock = FakeClock(self.T0 + timedelta(seconds=50))
        fresh = self._cache(restore_clock)
        restored, dropped, touched = fresh.restore_state(
            state, elapsed_s=50.0
        )
        assert (restored, dropped, touched) == (1, 1, ["ns/t1"])
        assert fresh.reserved_pod_keys("ns/t1") == {"default/keep"}
        restore_clock.advance(timedelta(seconds=49))
        assert fresh.reserved_pod_keys("ns/t1") == {"default/keep"}
        restore_clock.advance(timedelta(seconds=2))
        assert fresh.reserved_pod_keys("ns/t1") == set()

    def test_restore_is_skew_proof_frozen_clock(self):
        """Even a restored clock BEHIND the snapshot clock cannot extend a
        deadline: budgets are relative, never absolute timestamps."""
        clock = FakeClock(self.T0)
        cache = self._cache(clock)
        cache.add_pod("ns/t1", make_pod("p1"), ttl=20.0)
        state = cache.snapshot_state()
        skewed = FakeClock(self.T0 - timedelta(hours=3))  # clock went backwards
        fresh = self._cache(skewed)
        fresh.restore_state(state, elapsed_s=0.0)
        skewed.advance(timedelta(seconds=19))
        assert fresh.reserved_pod_keys("ns/t1") == {"default/p1"}
        skewed.advance(timedelta(seconds=2))
        assert fresh.reserved_pod_keys("ns/t1") == set()
