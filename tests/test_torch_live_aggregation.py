"""The live reconcile data plane: device used-aggregates + index-backed
collections (no store scans in reconcile).

Each scenario drives the REAL daemon path (store events → DeviceStateManager
deltas/rebases → controller reconcile_batch → status write) and asserts the
written ``status.used`` equals an independent oracle recompute, across the
sequences where incremental bookkeeping is easiest to get wrong:

- pod delta followed by a selector edit on the same throttle before any
  flush (the delta must be dropped, not double-applied, when the column is
  rebased);
- pod label move between throttles;
- bind/terminate phase flips (counted-set membership);
- namespace (re)definition (full-rebase path for clusterthrottles);
- delta-burst overflow (pending-list cap forces a full rebase);
- new resource dimension appearing mid-stream (R growth).
"""

from __future__ import annotations

from dataclasses import replace
from datetime import datetime, timezone

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    LabelSelector,
    ResourceAmount,
    ClusterThrottleSpec,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
    resource_amount_of_pod,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.utils.clock import FakeClock

NOW = datetime(2024, 3, 1, 12, 0, 0, tzinfo=timezone.utc)


def _stack():
    store = Store()
    clock = FakeClock(NOW)
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        clock=clock,
        use_device=True, device="cpu",
    )
    store.create_namespace(Namespace("default"))
    return store, plugin, clock


def _throttle(name, labels, **threshold):
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(**threshold),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels=labels)),
                )
            ),
        ),
    )


def _ct_team_x(name):
    """ClusterThrottle selecting pods {grp: a} in namespaces {team: x}."""
    return ClusterThrottle(
        name=name,
        spec=ClusterThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(pod=10),
            selector=ClusterThrottleSelector(
                selector_terms=(
                    ClusterThrottleSelectorTerm(
                        pod_selector=LabelSelector(match_labels={"grp": "a"}),
                        namespace_selector=LabelSelector(match_labels={"team": "x"}),
                    ),
                )
            ),
        ),
    )


def _bound(pod):
    bound = replace(pod, spec=replace(pod.spec, node_name="node-1"))
    bound.status.phase = "Running"
    return bound


def _oracle_used(store, thr):
    """Independent recompute of status.used from raw store contents."""
    used = ResourceAmount()
    for pod in store.list_pods():
        if pod.spec.scheduler_name != "my-scheduler" or not pod.is_scheduled():
            continue
        if not pod.is_not_finished():
            continue
        if isinstance(thr, Throttle):
            if pod.namespace != thr.namespace:
                continue
            if not thr.spec.selector.matches_to_pod(pod):
                continue
        else:
            ns = store.get_namespace(pod.namespace)
            if ns is None or not thr.spec.selector.matches_to_pod(pod, ns):
                continue
        used = used.add(resource_amount_of_pod(pod))
    return used


def _assert_status_matches_oracle(store, plugin):
    plugin.run_pending_once()
    for thr in store.list_throttles():
        assert thr.status.used == _oracle_used(store, thr), thr.key
    for thr in store.list_cluster_throttles():
        assert thr.status.used == _oracle_used(store, thr), thr.key


class TestDeltaThenRebase:
    def test_pod_delta_then_selector_edit_does_not_double_count(self):
        store, plugin, _ = _stack()
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=10, requests={"cpu": "1"}))
        plugin.run_pending_once()

        # pod event (pending delta) and a selector edit on the same throttle
        # land in the SAME flush window: the rebase reads current state, so
        # the pod's delta must be dropped or it applies twice
        pod = _bound(make_pod("p1", labels={"grp": "a"}, requests={"cpu": "300m"}))
        store.create_pod(pod)
        thr = store.get_throttle("default", "t1")
        store.update_throttle(thr)  # no-op spec touch still marks the column
        _assert_status_matches_oracle(store, plugin)
        thr = store.get_throttle("default", "t1")
        assert thr.status.used.resource_counts == 1

    def test_label_move_between_throttles(self):
        store, plugin, _ = _stack()
        store.create_throttle(_throttle("ta", {"grp": "a"}, pod=10, requests={"cpu": "1"}))
        store.create_throttle(_throttle("tb", {"grp": "b"}, pod=10, requests={"cpu": "1"}))
        pod = _bound(make_pod("p1", labels={"grp": "a"}, requests={"cpu": "200m"}))
        store.create_pod(pod)
        _assert_status_matches_oracle(store, plugin)

        moved = replace(pod, labels={"grp": "b"})
        store.update_pod(moved)
        _assert_status_matches_oracle(store, plugin)
        assert store.get_throttle("default", "ta").status.used == ResourceAmount()
        assert store.get_throttle("default", "tb").status.used.resource_counts == 1

    def test_phase_flip_leaves_then_rejoins_counted_set(self):
        store, plugin, _ = _stack()
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=10))
        pod = _bound(make_pod("p1", labels={"grp": "a"}, requests={"cpu": "100m"}))
        store.create_pod(pod)
        _assert_status_matches_oracle(store, plugin)

        finished = replace(pod)
        finished.status.phase = "Succeeded"
        store.update_pod(finished)
        _assert_status_matches_oracle(store, plugin)
        assert store.get_throttle("default", "t1").status.used == ResourceAmount()


class TestFullRebasePaths:
    def test_namespace_definition_triggers_clusterthrottle_rebase(self):
        store, plugin, _ = _stack()
        store.create_cluster_throttle(_ct_team_x("ct1"))
        store.create_namespace(Namespace("team-ns", labels={"team": "x"}))
        pod = _bound(
            make_pod("p1", namespace="team-ns", labels={"grp": "a"}, requests={"cpu": "1"})
        )
        store.create_pod(pod)
        _assert_status_matches_oracle(store, plugin)
        ct = store.get_cluster_throttle("ct1")
        assert ct.status.used.resource_counts == 1

        # relabel the namespace so the selector no longer matches: many mask
        # rows flip at once → full-rebase path
        store.update_namespace(Namespace("team-ns", labels={"team": "y"}))
        store.update_pod(replace(pod))  # poke a reconcile
        _assert_status_matches_oracle(store, plugin)

    def test_namespace_relabel_converges_without_pod_poke(self):
        """The namespace event alone must enqueue the affected
        clusterthrottle (controllers/clusterthrottle._on_namespace_event) —
        no pod activity required for status.used to converge."""
        store, plugin, _ = _stack()
        store.create_cluster_throttle(_ct_team_x("ct1"))
        store.create_namespace(Namespace("team-ns", labels={"team": "x"}))
        store.create_pod(
            _bound(
                make_pod(
                    "p1", namespace="team-ns", labels={"grp": "a"}, requests={"cpu": "1"}
                )
            )
        )
        _assert_status_matches_oracle(store, plugin)
        assert store.get_cluster_throttle("ct1").status.used.resource_counts == 1

        store.update_namespace(Namespace("team-ns", labels={"team": "y"}))
        _assert_status_matches_oracle(store, plugin)
        assert store.get_cluster_throttle("ct1").status.used == ResourceAmount()

        # and back: the namespace re-matching must also converge unpoked
        store.update_namespace(Namespace("team-ns", labels={"team": "x"}))
        _assert_status_matches_oracle(store, plugin)
        assert store.get_cluster_throttle("ct1").status.used.resource_counts == 1

    def test_namespace_delete_clears_clusterthrottle_used(self):
        """Deleting a Namespace object must un-match its pods from every
        clusterthrottle (the oracle requires the Namespace,
        clusterthrottle_controller.go:273-276) — a DELETED event must not
        be treated as an upsert that re-marks the namespace as existing."""
        store, plugin, _ = _stack()
        store.create_cluster_throttle(_ct_team_x("ct1"))
        store.create_namespace(Namespace("team-ns", labels={"team": "x"}))
        store.create_pod(
            _bound(
                make_pod(
                    "p1", namespace="team-ns", labels={"grp": "a"}, requests={"cpu": "1"}
                )
            )
        )
        plugin.run_pending_once()
        assert store.get_cluster_throttle("ct1").status.used.resource_counts == 1

        store.delete_namespace("team-ns")
        plugin.run_pending_once()
        assert store.get_cluster_throttle("ct1").status.used == ResourceAmount()

        # re-creating the namespace restores the match (existence flips back)
        store.create_namespace(Namespace("team-ns", labels={"team": "x"}))
        plugin.run_pending_once()
        assert store.get_cluster_throttle("ct1").status.used.resource_counts == 1

    def test_namespace_move_between_selector_terms_converges(self):
        """A relabel that moves the namespace from one selector term to
        another keeps the OR-aggregate namespace match True on both sides
        while the counted pod set changes completely — the flip detection
        must be per term."""
        store, plugin, _ = _stack()
        store.create_cluster_throttle(
            ClusterThrottle(
                name="ct2",
                spec=ClusterThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(pod=10),
                    selector=ClusterThrottleSelector(
                        selector_terms=(
                            ClusterThrottleSelectorTerm(
                                pod_selector=LabelSelector(match_labels={"grp": "a"}),
                                namespace_selector=LabelSelector(
                                    match_labels={"team": "x"}
                                ),
                            ),
                            ClusterThrottleSelectorTerm(
                                pod_selector=LabelSelector(match_labels={"grp": "b"}),
                                namespace_selector=LabelSelector(
                                    match_labels={"team": "y"}
                                ),
                            ),
                        )
                    ),
                ),
            )
        )
        store.create_namespace(Namespace("team-ns", labels={"team": "x"}))
        store.create_pod(
            _bound(
                make_pod(
                    "pa", namespace="team-ns", labels={"grp": "a"}, requests={"cpu": "1"}
                )
            )
        )
        store.create_pod(
            _bound(
                make_pod(
                    "pb", namespace="team-ns", labels={"grp": "b"}, requests={"cpu": "2"}
                )
            )
        )
        _assert_status_matches_oracle(store, plugin)
        ct = store.get_cluster_throttle("ct2")
        assert ct.status.used.resource_counts == 1  # only pa (term 1)

        # term-1 match flips off, term-2 flips on: counted set pa → pb,
        # with NO pod poke
        store.update_namespace(Namespace("team-ns", labels={"team": "y"}))
        _assert_status_matches_oracle(store, plugin)
        ct = store.get_cluster_throttle("ct2")
        assert ct.status.used.resource_counts == 1
        assert ct.status.used.resource_requests == {"cpu": 2}

    def test_resync_backstop_converges_after_missed_event(self):
        """reconcileTemporaryThresholdInterval as the eventual-consistency
        backstop (the analog of the reference's 5-min informer resync,
        plugin.go:77): with the namespace handler detached to simulate a
        missed watch event, the status is stale until the FakeClock crosses
        the resync interval — then it converges with NO pod poke."""
        import time

        store, plugin, clock = _stack()
        ctr = plugin.cluster_throttle_ctr
        store.create_cluster_throttle(_ct_team_x("ct1"))
        store.create_namespace(Namespace("team-ns", labels={"team": "x"}))
        store.create_pod(
            _bound(
                make_pod(
                    "p1", namespace="team-ns", labels={"grp": "a"}, requests={"cpu": "1"}
                )
            )
        )
        _assert_status_matches_oracle(store, plugin)
        assert store.get_cluster_throttle("ct1").status.used.resource_counts == 1

        plugin.informers.namespaces().remove_event_handler(ctr._on_namespace_event)
        store.update_namespace(Namespace("team-ns", labels={"team": "y"}))
        plugin.run_pending_once()
        # event missed → stale (exactly the round-2 bug, now confined to a
        # simulated watch-stream failure)
        assert store.get_cluster_throttle("ct1").status.used.resource_counts == 1

        # default interval is 15s; cross it and wait for the delayed-queue
        # waker to promote the resync sentinel (polls the clock at ~2ms)
        clock.advance(decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ).reconcile_temporary_threshold_interval + __import__("datetime").timedelta(seconds=1))
        deadline = time.time() + 5
        while time.time() < deadline:
            plugin.run_pending_once()
            if store.get_cluster_throttle("ct1").status.used == ResourceAmount():
                break
            time.sleep(0.01)
        assert store.get_cluster_throttle("ct1").status.used == ResourceAmount()
        for thr in store.list_cluster_throttles():
            assert thr.status.used == _oracle_used(store, thr)

    def test_delta_burst_overflow_forces_full_rebase(self):
        store, plugin, _ = _stack()
        dm = plugin.device_manager
        dm.throttle._agg_pending_max = 16  # force the overflow path
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=1000))
        for i in range(40):
            store.create_pod(
                _bound(make_pod(f"p{i}", labels={"grp": "a"}, requests={"cpu": "50m"}))
            )
        assert dm.throttle._agg_full_rebase  # cap tripped before any flush
        _assert_status_matches_oracle(store, plugin)
        assert store.get_throttle("default", "t1").status.used.resource_counts == 40

    def test_new_resource_dimension_mid_stream(self):
        store, plugin, _ = _stack()
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=10, requests={"cpu": "1"}))
        store.create_pod(
            _bound(make_pod("p1", labels={"grp": "a"}, requests={"cpu": "100m"}))
        )
        _assert_status_matches_oracle(store, plugin)
        # a resource name no prior object used: R grows, aggregates rebase
        store.create_pod(
            _bound(
                make_pod(
                    "p2",
                    labels={"grp": "a"},
                    requests={"cpu": "100m", "example.com/widgets": "3"},
                )
            )
        )
        _assert_status_matches_oracle(store, plugin)
        used = store.get_throttle("default", "t1").status.used
        assert used.resource_requests["example.com/widgets"] == 3


class TestThrottlerNameHandover:
    def test_handover_to_this_throttler_builds_the_column(self):
        """A MODIFIED that flips throttlerName TO this throttler without
        touching the selector must still build the mask column and the
        aggregate — the selector-unchanged fast path (a status-echo
        optimization) must not swallow it, or the throttle is silently
        unenforced."""
        store, plugin, _ = _stack()
        foreign = Throttle(
            name="t1",
            spec=ThrottleSpec(
                throttler_name="someone-else",
                threshold=ResourceAmount.of(pod=0),  # throttles immediately
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels={"grp": "a"})),
                    )
                ),
            ),
        )
        store.create_throttle(foreign)
        store.create_pod(
            _bound(make_pod("p1", labels={"grp": "a"}, requests={"cpu": "100m"}))
        )
        plugin.run_pending_once()
        # not ours: no status management (the OTHER throttler owns it, so
        # the used stays nil here), and pods are not throttled by it
        assert store.get_throttle("default", "t1").status.used == ResourceAmount()
        assert plugin.pre_filter(
            make_pod("p2", labels={"grp": "a"}, requests={"cpu": "1m"})
        ).is_success()

        # handover: same selector, new owner
        store.update_throttle_spec(
            replace(foreign, spec=replace(foreign.spec, throttler_name="kube-throttler"))
        )
        _assert_status_matches_oracle(store, plugin)
        thr = store.get_throttle("default", "t1")
        assert thr.status.used.resource_counts == 1
        verdict = plugin.pre_filter(
            make_pod("p2", labels={"grp": "a"}, requests={"cpu": "1m"})
        )
        assert not verdict.is_success()


class TestIndexBackedCollections:
    def test_affected_keys_for_stale_pod_version(self):
        store, plugin, _ = _stack()
        store.create_throttle(_throttle("ta", {"grp": "a"}, pod=10))
        store.create_throttle(_throttle("tb", {"grp": "b"}, pod=10))
        pod = _bound(make_pod("p1", labels={"grp": "a"}))
        store.create_pod(pod)
        moved = replace(pod, labels={"grp": "b"})
        store.update_pod(moved)
        # the index has moved to `moved`; querying the OLD object must
        # evaluate it fresh, not return the new row
        ctr = plugin.throttle_ctr
        assert ctr.affected_throttle_keys(pod) == ["default/ta"]
        assert ctr.affected_throttle_keys(moved) == ["default/tb"]

    def test_batch_drain_reconciles_all_keys_in_one_call(self):
        store, plugin, _ = _stack()
        calls = []
        dm = plugin.device_manager
        orig = dm.aggregate_used_for

        def spy(kind, keys, reserved=None, flips_out=None):
            calls.append((kind, tuple(sorted(keys))))
            return orig(kind, keys, reserved, flips_out=flips_out)

        dm.aggregate_used_for = spy
        for i in range(20):
            store.create_throttle(_throttle(f"t{i}", {"grp": f"g{i % 3}"}, pod=5))
        for i in range(10):
            store.create_pod(
                _bound(
                    make_pod(f"p{i}", labels={"grp": f"g{i % 3}"}, requests={"cpu": "10m"})
                )
            )
        plugin.run_pending_once()
        throttle_calls = [keys for kind, keys in calls if kind == "throttle"]
        # every enqueued key reconciled, in far fewer aggregate calls than keys
        reconciled = set().union(*throttle_calls)
        assert len(reconciled) == 20
        assert len(throttle_calls) < 20
        _assert_status_matches_oracle(store, plugin)
