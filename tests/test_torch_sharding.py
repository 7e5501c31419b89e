"""Multiprocess keyspace sharding: ring, router, scatter-gather merge,
two-phase reserve, gang one-owner ledger, resync.

The equivalence suite builds IDENTICAL object populations in (a) a
sharded front over N in-process shard cores (LocalShard transport —
deterministic, no sockets; the real IPC is covered by the framing tests
here and the subprocess chaos smoke in test_shard_chaos.py) and (b) a
single-process KubeThrottler oracle, then pins:

    sharded pre_filter ≡ single-process pre_filter

on status code + normalized reasons (name lists sorted — the
single-process ordering is index-column order, which does not exist
across shards) for every pod, including multi-shard-matching pods,
gang groups, and accel-class pods.
"""

from __future__ import annotations

import socket
import threading
import time

import pytest

import tools.harness_torch as H
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    AccelClassThreshold,
    LabelSelector,
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    ResourceAmount,
    ThrottleSelector,
    ThrottleSelectorTerm,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin.framework import StatusCode
from kube_throttler_tpu_torch.sharding.front import AdmissionFront
from kube_throttler_tpu_torch.sharding.ipc import (
    LocalShard,
    ShardUnavailable,
    read_frame,
    send_frame,
)
from kube_throttler_tpu_torch.sharding.ring import (
    HashRing,
    route_key_for,
    selector_fingerprint,
    stable_hash64,
)
from kube_throttler_tpu_torch.sharding.worker import ShardCore
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def make_cluster_throttle(name, labels, threshold=None, accel=()):
    return ClusterThrottle(
        name=name,
        spec=ClusterThrottleSpec(
            throttler_name="kube-throttler",
            threshold=threshold
            or ResourceAmount.of(pod=2, requests={"cpu": "1"}),
            selector=ClusterThrottleSelector(
                selector_terms=(
                    ClusterThrottleSelectorTerm(
                        LabelSelector(match_labels=dict(labels)),
                        LabelSelector(),
                    ),
                )
            ),
            accel_class_thresholds=tuple(accel),
        ),
    )


def build_sharded(n_shards, prepare_ttl=30.0, use_device=False):
    front = AdmissionFront(n_shards)
    cores = [
        ShardCore(i, n_shards, use_device=use_device, prepare_ttl=prepare_ttl)
        for i in range(n_shards)
    ]
    for i, core in enumerate(cores):
        front.attach_shard(i, LocalShard(i, core, on_push=front.apply_status_push))
    return front, cores


def teardown_sharded(front, cores):
    for core in cores:
        core.stop()
    front.stop()


def settle(front, timeout=30.0):
    assert front.drain(timeout=timeout)
    time.sleep(0.3)  # push loops flush on their own cadence


def apply_all(stores, fn):
    for store in stores:
        fn(store)


# --------------------------------------------------------------------------
# ring
# --------------------------------------------------------------------------


class TestRing:
    def test_stable_across_instances(self):
        a, b = HashRing(4), HashRing(4)
        keys = [f"k{i}" for i in range(500)]
        assert [a.shard_of(k) for k in keys] == [b.shard_of(k) for k in keys]

    def test_stable_hash_is_process_stable(self):
        # pinned value: blake2b, not the salted builtin hash
        assert stable_hash64("kube-throttler") == stable_hash64("kube-throttler")
        assert stable_hash64("a") != stable_hash64("b")

    def test_spread_is_balanced(self):
        ring = HashRing(4)
        counts = ring.spread(f"key-{i}" for i in range(4000))
        assert min(counts) > 0
        assert max(counts) / (sum(counts) / len(counts)) < 1.6

    def test_selector_affinity_colocates_same_selector(self):
        ring = HashRing(4)
        thrs = [H.make_throttle(7) for _ in range(5)]
        # same selector → same fingerprint → same shard, regardless of name
        import dataclasses

        thrs = [dataclasses.replace(t, name=f"t7-{i}") for i, t in enumerate(thrs)]
        owners = {ring.shard_of(route_key_for("Throttle", t)) for t in thrs}
        assert len(owners) == 1

    def test_fingerprint_scopes_namespace_and_kind(self):
        import dataclasses

        t = H.make_throttle(1)
        t2 = dataclasses.replace(t, namespace="other")
        assert selector_fingerprint(t) != selector_fingerprint(t2)
        ct = make_cluster_throttle("c1", {"grp": "g1"})
        assert selector_fingerprint(t) != selector_fingerprint(ct)

    def test_gang_route_key(self):
        assert route_key_for("Gang", "default/job") == "gang|default/job"
        ring = HashRing(8)
        assert ring.shard_of(route_key_for("Gang", "default/job")) == ring.shard_of(
            route_key_for("Gang", "default/job")
        )


# --------------------------------------------------------------------------
# ipc framing
# --------------------------------------------------------------------------


class TestFraming:
    def test_frame_roundtrip(self):
        a, b = socket.socketpair()
        try:
            lock = threading.Lock()
            pod = make_pod("p", labels={"x": "y"}, requests={"cpu": "1"})
            send_frame(a, lock, "evt", 7, [("upsert", "Pod", pod)], epoch=3)
            rfile = b.makefile("rb")
            mtype, rid, body, epoch = read_frame(rfile)
            assert (mtype, rid, epoch) == ("evt", 7, 3)
            verb, kind, got = body[0]
            assert (verb, kind, got.key, got.labels) == (
                "upsert", "Pod", pod.key, {"x": "y"},
            )
        finally:
            a.close()
            b.close()

    def test_read_frame_eof(self):
        a, b = socket.socketpair()
        a.close()
        assert read_frame(b.makefile("rb")) is None
        b.close()


# --------------------------------------------------------------------------
# verdict-merge equivalence: sharded ≡ single-process
# --------------------------------------------------------------------------


def seeded_population(seed, n_groups=6, n_pods=40):
    """Deterministic op list: namespaced throttles per group, a couple of
    cluster throttles (one with accel-class thresholds), and pods — some
    matching several selector classes at once (multi-shard pods), some
    gang-annotated, some accel-class, some in an unknown namespace."""
    import random

    rng = random.Random(seed)
    ops = []
    ops.append(("ns", Namespace("default")))
    for i in range(n_groups):
        ops.append(("thr", H.make_throttle(i)))
    ops.append(("cthr", make_cluster_throttle("cwide", {"tier": "hot"})))
    ops.append(
        (
            "cthr",
            make_cluster_throttle(
                "caccel",
                {"grp": "g1"},
                accel=(
                    AccelClassThreshold(
                        accel_class="tpu-v5e",
                        threshold=ResourceAmount.of(pod=1),
                    ),
                ),
            ),
        )
    )
    for i in range(n_pods):
        labels = {"grp": f"g{rng.randrange(n_groups)}"}
        if rng.random() < 0.4:
            labels["tier"] = "hot"  # matches cwide too → multi-shard pod
        kwargs = {}
        if rng.random() < 0.2:
            kwargs["accel_class"] = "tpu-v5e"
        if rng.random() < 0.2:
            kwargs["group"] = f"job{rng.randrange(3)}"
            kwargs["group_size"] = 3
        pod = make_pod(
            f"p{i}",
            labels=labels,
            requests={"cpu": f"{rng.randrange(1, 9) * 250}m"},
            node_name="node-1" if rng.random() < 0.8 else "",
            phase="Running" if rng.random() < 0.8 else "Pending",
            **kwargs,
        )
        ops.append(("pod", pod))
    return ops


def apply_population(store, ops):
    for what, obj in ops:
        if what == "ns":
            store.create_namespace(obj)
        elif what == "thr":
            store.create_throttle(obj)
        elif what == "cthr":
            store.create_cluster_throttle(obj)
        else:
            store.create_pod(obj)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_pre_filter_equivalence(seed, n_shards):
    """Seeded sweep: sharded pre_filter ≡ single-process pre_filter on
    identical stores — multi-shard-matching pods, accel-class pods, and
    probe pods included. Reasons compared via normalized_reasons."""
    ops = seeded_population(seed)
    front, cores = build_sharded(n_shards)
    oracle_store = Store()
    try:
        apply_population(front.store, ops)
        apply_population(oracle_store, ops)
        oracle = H.build_plugin(oracle_store)
        oracle.run_pending_once()  # shards reconcile; the oracle must too
        settle(front)
        # stored pods AND unstored probes (the scheduler's common case)
        probes = [
            make_pod("probe-multi", labels={"grp": "g1", "tier": "hot"},
                     requests={"cpu": "500m"}),
            make_pod("probe-accel", labels={"grp": "g1"},
                     requests={"cpu": "250m"}, accel_class="tpu-v5e"),
            make_pod("probe-nomatch", labels={"zz": "qq"},
                     requests={"cpu": "250m"}),
        ]
        for pod in list(oracle_store.list_pods()) + probes:
            got = front.pre_filter(pod)
            want = oracle.pre_filter(pod)
            assert got.code == want.code, (
                pod.key, got.code, got.reasons, want.code, want.reasons,
            )
            assert H.normalized_reasons(got.reasons) == H.normalized_reasons(
                want.reasons
            ), pod.key
    finally:
        teardown_sharded(front, cores)


def test_missing_namespace_is_error_like_single_process():
    front, cores = build_sharded(2)
    oracle_store = Store()
    try:
        for store in (front.store, oracle_store):
            store.create_namespace(Namespace("default"))
            store.create_throttle(H.make_throttle(0))
        oracle = H.build_plugin(oracle_store)
        oracle.run_pending_once()
        settle(front)
        ghost = make_pod("ghost", namespace="nowhere", labels={"grp": "g0"},
                         requests={"cpu": "100m"})
        got, want = front.pre_filter(ghost), oracle.pre_filter(ghost)
        assert got.code == want.code == StatusCode.ERROR
        assert got.reasons == want.reasons
    finally:
        teardown_sharded(front, cores)


def test_pre_filter_batch_equivalence():
    ops = seeded_population(5)
    front, cores = build_sharded(3)
    oracle_store = Store()
    try:
        apply_population(front.store, ops)
        apply_population(oracle_store, ops)
        oracle = H.build_plugin(oracle_store)
        oracle.run_pending_once()
        settle(front)
        got = front.pre_filter_batch()
        want = oracle.pre_filter_batch()
        assert got["schedulable"] == want["schedulable"]
        assert sorted(got["errors"]) == sorted(want["errors"])
    finally:
        teardown_sharded(front, cores)


def test_equivalence_with_reservations():
    """Reservations change 'insufficient' verdicts; a two-phase reserve on
    the sharded stack must produce the same downstream verdicts as the
    oracle's local reserve."""
    front, cores = build_sharded(2)
    oracle_store = Store()
    try:
        for store in (front.store, oracle_store):
            store.create_namespace(Namespace("default"))
            for i in range(4):
                store.create_throttle(H.make_throttle(i))
        oracle = H.build_plugin(oracle_store)
        oracle.run_pending_once()
        settle(front)
        held = [
            make_pod(f"r{i}", labels={"grp": f"g{i % 4}"},
                     requests={"cpu": "600m"})
            for i in range(6)
        ]
        for pod in held:
            assert front.reserve(pod).is_success()
            assert oracle.reserve(pod).is_success()
        probe = make_pod("probe", labels={"grp": "g2"}, requests={"cpu": "600m"})
        got, want = front.pre_filter(probe), oracle.pre_filter(probe)
        assert got.code == want.code
        assert H.normalized_reasons(got.reasons) == H.normalized_reasons(want.reasons)
        # and unreserve restores symmetry
        for pod in held:
            front.unreserve(pod)
            oracle.unreserve(pod)
        got2, want2 = front.pre_filter(probe), oracle.pre_filter(probe)
        assert got2.code == want2.code
    finally:
        teardown_sharded(front, cores)


# --------------------------------------------------------------------------
# two-phase reserve
# --------------------------------------------------------------------------


class TestTwoPhaseReserve:
    def test_prepare_failure_aborts_everywhere(self):
        """A pod matching throttles on two shards, one shard dead: the
        prepare on the live shard must be ABORTED — zero reservations
        survive anywhere."""
        front, cores = build_sharded(2)
        try:
            front.store.create_namespace(Namespace("default"))
            for i in range(4):
                front.store.create_throttle(H.make_throttle(i))
            front.store.create_cluster_throttle(
                make_cluster_throttle("cwide", {"tier": "hot"})
            )
            settle(front)
            cw_owner = front.owner_of("ClusterThrottle", "/cwide")
            g = next(
                i for i in range(4)
                if front.owner_of("Throttle", f"default/t{i}") != cw_owner
            )
            pod = make_pod("multi", labels={"grp": f"g{g}", "tier": "hot"},
                           requests={"cpu": "100m"})
            targets = sorted(front._pod_target_shards(pod))
            assert len(targets) == 2, "population must split across shards"
            front.shards[targets[1]].close()  # shard dies pre-prepare
            status = front.reserve(pod)
            assert status.code == StatusCode.ERROR
            live = cores[targets[0]]
            for cache in (
                live.plugin.throttle_ctr.cache,
                live.plugin.cluster_throttle_ctr.cache,
            ):
                for key in (
                    [t.key for t in live.store.list_throttles()]
                    + [t.key for t in live.store.list_cluster_throttles()]
                ):
                    amount, _ = cache.reserved_resource_amount(key)
                    assert not amount.resource_counts, (key, amount)
            assert front.stats()["two_phase_aborts"] == 1
        finally:
            teardown_sharded(front, cores)

    def test_orphaned_prepare_is_reaped(self):
        """Prepare lands, the front 'crashes' before commit/abort: the
        shard-side reaper aborts the stale transaction — no orphan
        reservation outlives prepare_ttl."""
        front, cores = build_sharded(2, prepare_ttl=0.2)
        try:
            front.store.create_namespace(Namespace("default"))
            front.store.create_throttle(H.make_throttle(1))
            settle(front)
            pod = make_pod("probe", labels={"grp": "g1"}, requests={"cpu": "100m"})
            (sid,) = front._pod_target_shards(pod)
            front.shards[sid].request(
                "reserve_prepare", {"txn": "orphan", "pod": pod}
            )
            amount, _ = cores[sid].plugin.throttle_ctr.cache.reserved_resource_amount(
                "default/t1"
            )
            assert amount.resource_counts == 1
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                amount, _ = cores[
                    sid
                ].plugin.throttle_ctr.cache.reserved_resource_amount("default/t1")
                if not amount.resource_counts:
                    break
                time.sleep(0.05)
            assert not amount.resource_counts
            assert cores[sid].reaped_txns == 1
        finally:
            teardown_sharded(front, cores)

    def test_commit_keeps_reservation(self):
        front, cores = build_sharded(2)
        try:
            front.store.create_namespace(Namespace("default"))
            front.store.create_throttle(H.make_throttle(1))
            settle(front)
            pod = make_pod("probe", labels={"grp": "g1"}, requests={"cpu": "100m"})
            assert front.reserve(pod).is_success()
            (sid,) = front._pod_target_shards(pod)
            amount, _ = cores[sid].plugin.throttle_ctr.cache.reserved_resource_amount(
                "default/t1"
            )
            assert amount.resource_counts == 1
            # committed: the reaper must NOT touch it
            cores[sid].reap_stale_txns(now=time.monotonic() + 120.0)
            amount, _ = cores[sid].plugin.throttle_ctr.cache.reserved_resource_amount(
                "default/t1"
            )
            assert amount.resource_counts == 1
            front.unreserve(pod)
        finally:
            teardown_sharded(front, cores)


# --------------------------------------------------------------------------
# gang admission
# --------------------------------------------------------------------------


class TestShardedGang:
    def _population(self, front_store, oracle_store):
        for store in (front_store, oracle_store):
            store.create_namespace(Namespace("default"))
            for i in range(4):
                store.create_throttle(H.make_throttle(i))
            store.create_cluster_throttle(
                make_cluster_throttle("cwide", {"tier": "hot"})
            )

    def _members(self, n=3, cpu="100m"):
        return [
            make_pod(f"gm{i}", labels={"grp": "g2", "tier": "hot"},
                     requests={"cpu": cpu}, group="job1", group_size=n)
            for i in range(n)
        ]

    def test_gang_check_equivalence(self):
        front, cores = build_sharded(2)
        oracle_store = Store()
        try:
            self._population(front.store, oracle_store)
            oracle = H.build_plugin(oracle_store)
            oracle.run_pending_once()
            settle(front)
            for cpu in ("100m", "5000m"):
                pods = self._members(cpu=cpu)
                got = front.pre_filter_gang("default/job1", pods)
                want = oracle.pre_filter_gang("default/job1", pods)
                assert got.is_success() == want.is_success(), (
                    cpu, got.reasons, want.reasons,
                )
        finally:
            teardown_sharded(front, cores)

    def test_ledger_record_on_exactly_one_shard(self):
        front, cores = build_sharded(3)
        try:
            self._population(front.store, Store())
            settle(front)
            pods = self._members()
            assert front.reserve_gang("default/job1", pods).is_success()
            records = {
                sid: front.shards[sid].request("gang_groups")
                for sid in range(3)
            }
            holders = [sid for sid, recs in records.items() if recs]
            assert holders == [front.gang_owner("default/job1")]
            front.unreserve_gang("default/job1")
            for sid in range(3):
                assert front.shards[sid].request("gang_groups") == []
        finally:
            teardown_sharded(front, cores)

    def test_gang_prepare_crash_leaves_no_orphans(self):
        """Gang prepare on every shard, front dies before commit: the
        reapers roll back the owner's ledger record AND the non-owner
        member reservations."""
        front, cores = build_sharded(2, prepare_ttl=0.2)
        try:
            self._population(front.store, Store())
            settle(front)
            pods = self._members()
            owner = front.gang_owner("default/job1")
            for sid in sorted(front._gang_targets("default/job1", pods)):
                front.shards[sid].request(
                    "gang_prepare",
                    {"txn": f"orphan-{sid}", "group": "default/job1",
                     "pods": pods, "owner": sid == owner},
                )
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                total = 0
                for core in cores:
                    for cache in (
                        core.plugin.throttle_ctr.cache,
                        core.plugin.cluster_throttle_ctr.cache,
                    ):
                        for thr in core.store.list_throttles():
                            a, _ = cache.reserved_resource_amount(thr.key)
                            total += a.resource_counts or 0
                        for thr in core.store.list_cluster_throttles():
                            a, _ = cache.reserved_resource_amount(thr.key)
                            total += a.resource_counts or 0
                if total == 0 and all(
                    front.shards[s].request("gang_groups") == [] for s in range(2)
                ):
                    break
                time.sleep(0.05)
            assert total == 0
            for sid in range(2):
                assert front.shards[sid].request("gang_groups") == []
        finally:
            teardown_sharded(front, cores)


# --------------------------------------------------------------------------
# router behavior
# --------------------------------------------------------------------------


class TestRouter:
    def test_pod_routes_follow_label_changes(self):
        front, cores = build_sharded(2)
        try:
            front.store.create_namespace(Namespace("default"))
            for i in range(4):
                front.store.create_throttle(H.make_throttle(i))
            settle(front)
            owners = {
                i: front.ring.shard_of(route_key_for("Throttle", H.make_throttle(i)))
                for i in range(4)
            }
            g_a = next(i for i in range(4) if owners[i] == 0)
            g_b = next(i for i in range(4) if owners[i] == 1)
            pod = make_pod("mover", labels={"grp": f"g{g_a}"}, requests={"cpu": "1"})
            front.store.create_pod(pod)
            settle(front)
            assert any(p.key == "default/mover" for p in cores[0].store.list_pods())
            assert not any(p.key == "default/mover" for p in cores[1].store.list_pods())
            moved = make_pod("mover", labels={"grp": f"g{g_b}"}, requests={"cpu": "1"})
            front.store.update_pod(moved)
            settle(front)
            # moved INTO shard 1, DELETED from shard 0 (no stale aggregate)
            assert not any(p.key == "default/mover" for p in cores[0].store.list_pods())
            assert any(p.key == "default/mover" for p in cores[1].store.list_pods())
            front.store.delete_pod("default", "mover")
            settle(front)
            assert not any(p.key == "default/mover" for p in cores[1].store.list_pods())
        finally:
            teardown_sharded(front, cores)

    def test_selector_edit_migrates_throttle_and_pods(self):
        import dataclasses

        front, cores = build_sharded(2)
        try:
            front.store.create_namespace(Namespace("default"))
            for i in range(4):
                front.store.create_throttle(H.make_throttle(i))
            pods = [
                make_pod(f"p{i}", labels={"grp": f"g{i % 4}"}, requests={"cpu": "1"})
                for i in range(8)
            ]
            for p in pods:
                front.store.create_pod(p)
            settle(front)
            owners = {
                i: front.ring.shard_of(route_key_for("Throttle", H.make_throttle(i)))
                for i in range(4)
            }
            g_a = next(i for i in range(4) if owners[i] == 0)
            g_b = next(i for i in range(4) if owners[i] == 1)
            # repoint t<g_a>'s selector at group g_b: the throttle must move
            # to g_b's selector-class shard and find its pods there
            old = front.store.get_throttle("default", f"t{g_a}")
            moved = dataclasses.replace(
                old,
                spec=dataclasses.replace(
                    old.spec,
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(
                                LabelSelector(match_labels={"grp": f"g{g_b}"})
                            ),
                        )
                    ),
                ),
            )
            front.store.update_throttle_spec(moved)
            settle(front)
            assert front.owner_of("Throttle", f"default/t{g_a}") == 1
            assert not any(
                t.key == f"default/t{g_a}" for t in cores[0].store.list_throttles()
            )
            assert any(
                t.key == f"default/t{g_a}" for t in cores[1].store.list_throttles()
            )
            probe = make_pod("probe", labels={"grp": f"g{g_b}"}, requests={"cpu": "9"})
            status = front.pre_filter(probe)
            # both g_b-selecting throttles answer from shard 1
            names = ";".join(status.reasons)
            assert f"default/t{g_a}" in names and f"default/t{g_b}" in names
        finally:
            teardown_sharded(front, cores)

    def test_status_pushes_are_not_rerouted(self):
        """A shard's status write streams into the front store as a
        status-only MODIFIED — the Router must not echo it back (event
        counts stay flat once drained)."""
        front, cores = build_sharded(2)
        try:
            front.store.create_namespace(Namespace("default"))
            front.store.create_throttle(H.make_throttle(0))
            pod = make_pod("p0", labels={"grp": "g0"}, requests={"cpu": "900m"},
                           node_name="node-1", phase="Running")
            front.store.create_pod(pod)
            settle(front)
            # statuses arrived at the front
            thr = front.store.get_throttle("default", "t0")
            assert thr.status.used.resource_counts == 1
            sent_before = sum(h.events_sent for h in front.shards.values())
            time.sleep(0.5)
            sent_after = sum(h.events_sent for h in front.shards.values())
            assert sent_before == sent_after
        finally:
            teardown_sharded(front, cores)

    def test_resync_after_shard_replacement(self):
        """Kill a LocalShard, attach a fresh empty core, resync: the new
        shard must reach the same verdicts and reconverge statuses."""
        front, cores = build_sharded(2)
        try:
            front.store.create_namespace(Namespace("default"))
            for i in range(4):
                front.store.create_throttle(H.make_throttle(i))
            for i in range(8):
                front.store.create_pod(
                    make_pod(f"p{i}", labels={"grp": f"g{i % 4}"},
                             requests={"cpu": "900m"}, node_name="node-1",
                             phase="Running")
                )
            settle(front)
            probe = make_pod("probe", labels={"grp": "g1"}, requests={"cpu": "1"})
            want = front.pre_filter(probe)
            (sid,) = {
                front.owner_of("Throttle", "default/t1"),
            }
            front.shards[sid].close()
            got_degraded = front.pre_filter(probe)
            assert got_degraded.code == StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE
            assert any("shard[unavailable]" in r for r in got_degraded.reasons)
            state, detail = front._shards_health()
            assert state == "degraded"
            replacement = ShardCore(sid, 2, use_device=False)
            cores.append(replacement)
            front.attach_shard(
                sid,
                LocalShard(sid, replacement, on_push=front.apply_status_push),
                resync=True,
            )
            settle(front)
            got = front.pre_filter(probe)
            assert got.code == want.code
            assert H.normalized_reasons(got.reasons) == H.normalized_reasons(
                want.reasons
            )
            state, _ = front._shards_health()
            assert state == "ok"
            # pruning: the replacement holds exactly its slice, nothing else
            stats = front.stats()["shards"][sid]
            assert stats["objects"]["throttles"] == len(
                [
                    k
                    for (kind, k), owner in front._owner.items()
                    if kind == "Throttle" and owner == sid
                ]
            )
        finally:
            teardown_sharded(front, cores)


# --------------------------------------------------------------------------
# degraded batch + health surfaces
# --------------------------------------------------------------------------


def test_batch_fails_safe_for_dead_shard_pods():
    front, cores = build_sharded(2)
    try:
        front.store.create_namespace(Namespace("default"))
        for i in range(4):
            front.store.create_throttle(H.make_throttle(i))
        for i in range(8):
            front.store.create_pod(
                make_pod(f"p{i}", labels={"grp": f"g{i % 4}"},
                         requests={"cpu": "100m"})
            )
        settle(front)
        dead = 0
        front.shards[dead].close()
        out = front.pre_filter_batch()
        with front._route_lock:
            routed = dict(front._pod_routes)
        for pkey, sids in routed.items():
            if dead in sids:
                assert out["schedulable"][pkey] is False
    finally:
        teardown_sharded(front, cores)


def test_shard_unavailable_raises_for_rpc():
    front, cores = build_sharded(1)
    try:
        front.shards[0].close()
        with pytest.raises(ShardUnavailable):
            front.shards[0].request("ping")
    finally:
        teardown_sharded(front, cores)
