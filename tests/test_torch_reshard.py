"""Live elastic resharding: retarget plans, dual-ring transition routing,
the fenced two-phase handoff, and its abort/reap paths.

Ring-retarget properties:

- **determinism** — ``plan_reshard`` is a pure function of the two ring
  parameter tuples (equal across instances and processes);
- **minimality** — a route key appears in a moving range IFF its owner
  differs between the rings (nothing else transfers);
- **zero-owner-never** — at EVERY intermediate cutover state the
  transition router maps every key to exactly one authoritative owner
  (src before its range cuts, dst after — never neither).

Handoff behavior runs over in-process shard cores (LocalShard), the
same deterministic transport the sharding equivalence suite uses; the
real-process SIGKILL variant is scenarios/resharding.py + the
tools/reshardtest.py matrix.
"""

from __future__ import annotations

import time

import pytest

import tools.harness_torch as H
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.replication import (
    RangeFence,
    ReplicationDiverged,
    SliceChunkSink,
    SliceChunkSource,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.faults.plan import FaultPlan
from kube_throttler_tpu_torch.sharding.front import AdmissionFront
from kube_throttler_tpu_torch.sharding.ipc import LocalShard
from kube_throttler_tpu_torch.sharding.reshard import (
    CoordinatorCrash,
    ReshardCoordinator,
)
from kube_throttler_tpu_torch.sharding.ring import (
    HashRing,
    TransitionRouting,
    plan_reshard,
    route_key_for,
    stable_hash64,
)
from kube_throttler_tpu_torch.sharding.worker import ShardCore
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

KEYS = [f"key-{i}" for i in range(2000)]


# --------------------------------------------------------------------------
# retarget plans
# --------------------------------------------------------------------------


class TestReshardPlan:
    def test_plan_is_deterministic(self):
        a = plan_reshard(HashRing(2), HashRing(4))
        b = plan_reshard(HashRing(2), HashRing(4))
        assert a == b
        assert a.moves  # a 2->4 split MUST move something

    @pytest.mark.parametrize("n_old,n_new", [(2, 4), (4, 3), (1, 2), (3, 8)])
    def test_plan_is_minimal(self, n_old, n_new):
        """A key transfers IFF its owner differs between the rings."""
        old, new = HashRing(n_old), HashRing(n_new)
        plan = plan_reshard(old, new)
        for key in KEYS:
            h = stable_hash64(key)
            move = plan.move_for_hash(h)
            if old.shard_of(key) == new.shard_of(key):
                assert move is None, key
            else:
                assert move is not None, key
                assert move.src == old.shard_of(key)
                assert move.dst == new.shard_of(key)

    def test_moves_partition_cleanly(self):
        plan = plan_reshard(HashRing(2), HashRing(3))
        for a, b in zip(plan.moves, plan.moves[1:]):
            assert a.hi <= b.lo  # sorted, non-overlapping
        for move in plan.moves:
            assert move.lo < move.hi
            assert move.src != move.dst

    @pytest.mark.parametrize("n_old,n_new", [(2, 4), (4, 3)])
    def test_zero_owners_never_at_any_intermediate_step(self, n_old, n_new):
        """Walk the cutover one range at a time: every key always has
        exactly one authoritative owner, equal to the old owner before
        its range cuts and the new owner after."""
        old, new = HashRing(n_old), HashRing(n_new)
        tr = TransitionRouting(old, new)
        hashes = [stable_hash64(k) for k in KEYS]
        valid = set(range(max(n_old, n_new)))
        for step in range(len(tr.plan.moves) + 1):
            for key, h in zip(KEYS, hashes):
                owner = tr.owner_of_hash(h)
                assert owner in valid
                move = tr.plan.move_for_hash(h)
                if move is None:
                    assert owner == old.shard_of(key) == new.shard_of(key)
                elif tr.state[move.index] == TransitionRouting.CUT:
                    assert owner == new.shard_of(key)
                else:
                    assert owner == old.shard_of(key)
            if step < len(tr.plan.moves):
                tr.set_state(tr.plan.moves[step].index, TransitionRouting.CUT)
        assert tr.complete()
        for key, h in zip(KEYS, hashes):
            assert tr.owner_of_hash(h) == new.shard_of(key)

    def test_mirror_only_while_mirroring(self):
        tr = TransitionRouting(HashRing(2), HashRing(3))
        move = tr.plan.moves[0]
        mid = (move.lo + move.hi) // 2
        assert tr.mirror_of_hash(mid) is None
        tr.set_state(move.index, TransitionRouting.MIRRORING)
        assert tr.mirror_of_hash(mid) is move
        assert tr.owner_of_hash(mid) == move.src  # authority unchanged
        tr.set_state(move.index, TransitionRouting.CUT)
        assert tr.mirror_of_hash(mid) is None
        assert tr.owner_of_hash(mid) == move.dst


# --------------------------------------------------------------------------
# the chunk protocol + range fence primitives
# --------------------------------------------------------------------------


class TestSlicePrimitives:
    def test_chunk_roundtrip_and_torn_detection(self):
        blob = bytes(range(256)) * 100
        source = SliceChunkSource(blob, max_chunk=1000)
        sink = SliceChunkSink()
        while not sink.done:
            chunk = source.chunk(sink.offset(), sink.sha_hex())
            sink.feed(chunk)
        assert sink.payload() == blob
        # a corrupted chunk MUST be refused by the hash check
        source2 = SliceChunkSource(blob, max_chunk=1000)
        sink2 = SliceChunkSink()
        chunk = source2.chunk(0, "")
        data = bytearray(chunk["data"])
        data[10] ^= 0xFF
        with pytest.raises(ReplicationDiverged):
            sink2.feed(dict(chunk, data=bytes(data)))
        assert sink2.offset() == 0  # nothing of the bad chunk kept

    def test_range_fence_covers_and_lifts(self):
        fence = RangeFence()
        fence.fence("h1", [(100, 200), (300, 400)], epoch=1)
        assert fence.covers(150) and fence.covers(399)
        assert not fence.covers(200) and not fence.covers(250)
        fence.refuse(3)
        assert fence.refused() == 3
        assert fence.lift("h1")
        assert not fence.covers(150)
        assert not fence.lift("h1")  # idempotent


# --------------------------------------------------------------------------
# in-process handoff end to end
# --------------------------------------------------------------------------


def build_front(n_shards, core_faults=None, prepare_ttl=30.0):
    front = AdmissionFront(n_shards)
    cores = []
    for i in range(n_shards):
        core = ShardCore(
            i, n_shards, use_device=False, faults=core_faults,
            prepare_ttl=prepare_ttl,
        )
        cores.append(core)
        front.attach_shard(i, LocalShard(i, core, on_push=front.apply_status_push))
    return front, cores


def seed_population(front, n_throttles=24, n_pods=150):
    front.store.create_namespace(Namespace("default"))
    for i in range(n_throttles):
        front.store.create_throttle(H.make_throttle(i))
    pods = []
    for i in range(n_pods):
        pod = make_pod(
            f"p{i}", labels={"grp": f"g{i % n_throttles}"},
            requests={"cpu": "100m"},
        )
        front.store.create_pod(pod)
        pods.append(pod)
    assert front.drain(60.0)
    time.sleep(0.3)
    return pods


def grow(front, cores, n_new, coord_faults=None):
    n_old = front.n_shards
    front.n_shards = max(n_old, n_new)
    for sid in range(n_old, n_new):
        core = ShardCore(sid, n_new, use_device=False)
        cores.append(core)
        front.attach_shard(sid, LocalShard(sid, core, on_push=front.apply_status_push))
        front.resync_shard(sid)
    return ReshardCoordinator(front, faults=coord_faults)


def assert_oracle_equivalent(front):
    store = Store()
    store.create_namespace(Namespace("default"))
    for thr in front.store.list_throttles():
        store.create_throttle(thr)
    for pod in front.store.list_pods():
        store.create_pod(pod)
    oracle = H.build_plugin(store)
    oracle.run_pending_once()
    try:
        for pod in store.list_pods():
            got = front.pre_filter(pod)
            want = oracle.pre_filter(pod)
            assert got.code == want.code, pod.key
            assert H.normalized_reasons(got.reasons) == H.normalized_reasons(
                want.reasons
            ), pod.key
    finally:
        oracle.stop()


def assert_audits_clean(front, n_shards):
    for sid in range(n_shards):
        audit = front.shards[sid].request("reshard_audit", None)
        assert audit["orphan_reservations"] == [], (sid, audit)
        assert audit["pending_handoffs"] == 0, (sid, audit)
        assert audit["fenced_handoffs"] == [], (sid, audit)


def teardown(front, cores):
    for core in cores:
        core.stop()
    front.stop()


class TestLiveReshard:
    def test_split_then_merge_keeps_verdicts_and_moves_keys(self):
        front, cores = build_front(2)
        try:
            seed_population(front)
            report = grow(front, cores, 3).rescale(HashRing(3), deadline_s=60.0)
            assert report["aborts"] == 0
            assert report["keys_cut"] > 0
            assert front.n_shards == 3
            # shard 2 now authoritatively owns keys
            with front._route_lock:
                owners = set(front._owner.values())
            assert 2 in owners
            # merge back 3 -> 2: shard 2 must end up owning nothing
            report = ReshardCoordinator(front).rescale(
                HashRing(2), deadline_s=60.0
            )
            assert report["keys_cut"] > 0
            with front._route_lock:
                owners = set(front._owner.values())
            assert 2 not in owners
            assert front.drain(60.0)
            time.sleep(0.3)
            assert_oracle_equivalent(front)
            assert_audits_clean(front, 3)
        finally:
            teardown(front, cores)

    def test_reservations_and_gangs_move_with_their_ranges(self):
        front, cores = build_front(2)
        try:
            pods = seed_population(front)
            for pod in pods[:12]:
                assert front.reserve(pod).is_success()
            gang_pods = [
                make_pod(
                    f"gp{i}", labels={"grp": "g3"}, requests={"cpu": "50m"},
                    group="default/gg1", group_size=3,
                )
                for i in range(3)
            ]
            for pod in gang_pods:
                front.store.create_pod(pod)
            assert front.drain(60.0)
            assert front.reserve_gang("default/gg1", gang_pods).is_success()
            owner_before = front.gang_owner("default/gg1")
            assert front.shards[owner_before].request("gang_groups", None) == [
                "default/gg1"
            ]
            grow(front, cores, 3).rescale(HashRing(3), deadline_s=60.0)
            assert front.drain(60.0)
            time.sleep(0.3)
            # the authoritative ledger record lives on exactly the (new)
            # hash owner — moved if its range moved, untouched otherwise
            owner_after = front.gang_owner("default/gg1")
            holders = [
                sid for sid in range(3)
                if front.shards[sid].request("gang_groups", None)
            ]
            assert holders == [owner_after]
            assert_audits_clean(front, 3)
            # reservations stayed release-able after the move: unreserve
            # everywhere, then nothing may remain reserved anywhere
            for pod in pods[:12]:
                front.unreserve(pod)
            front.unreserve_gang("default/gg1")
            for pod in gang_pods:
                front.unreserve(pod)
            stats = front.stats()
            assert all(
                s.get("reservations", 0) == 0
                for s in stats["shards"].values()
                if s.get("alive")
            ), stats
        finally:
            teardown(front, cores)

    def test_torn_stream_aborts_back_to_source_then_retry_lands(self):
        plan = FaultPlan(seed=1).rule("reshard.handoff.torn", mode="torn", times=1)
        front, cores = build_front(2, core_faults=plan)
        try:
            seed_population(front)
            report = grow(front, cores, 3).rescale(HashRing(3), deadline_s=60.0)
            assert plan.fired("reshard.handoff.torn") == 1
            assert report["aborts"] >= 1
            assert report["retries"] >= 1
            assert front.drain(60.0)
            time.sleep(0.3)
            assert_oracle_equivalent(front)
            assert_audits_clean(front, 3)
        finally:
            teardown(front, cores)

    def test_fence_race_aborts_and_unfences(self):
        plan = FaultPlan(seed=3).rule("reshard.fence.race", mode="error", times=1)
        front, cores = build_front(2)
        try:
            seed_population(front)
            report = grow(front, cores, 3, coord_faults=plan).rescale(
                HashRing(3), deadline_s=60.0
            )
            assert plan.fired("reshard.fence.race") == 1
            assert report["aborts"] >= 1
            assert front.drain(60.0)
            time.sleep(0.3)
            # the abort lifted the fence: no standing fence anywhere
            assert_audits_clean(front, 3)
            assert_oracle_equivalent(front)
        finally:
            teardown(front, cores)

    def test_front_crash_orphans_are_ttl_reaped_with_zero_orphan_reservations(self):
        plan = FaultPlan(seed=2).rule("reshard.front.crash", mode="error", times=1)
        front, cores = build_front(2)
        try:
            pods = seed_population(front)
            for pod in pods[:8]:
                assert front.reserve(pod).is_success()
            coordinator = grow(front, cores, 3, coord_faults=plan)
            with pytest.raises(CoordinatorCrash):
                coordinator.rescale(HashRing(3), deadline_s=60.0)
            # the orphaned handoff is pending on both sides (staged blob
            # + fence on the source would follow; here prepare+import ran)
            pending = sum(
                front.shards[sid].request("reshard_audit", None)[
                    "pending_handoffs"
                ]
                for sid in range(3)
            )
            assert pending >= 1
            # the two-phase reaper TTLs it out on both ends
            for core in cores:
                core.prepare_ttl = 0.0
                core.reap_stale_txns()
            assert_audits_clean(front, 3)
            # the source never lost authority: a fresh coordinator (the
            # restarted front) completes the retarget cleanly
            report = ReshardCoordinator(front).rescale(
                HashRing(3), deadline_s=60.0
            )
            assert report["aborts"] == 0
            assert front.drain(60.0)
            time.sleep(0.3)
            assert_oracle_equivalent(front)
            assert_audits_clean(front, 3)
        finally:
            teardown(front, cores)

    def test_fenced_range_refuses_post_cutover_writes(self):
        front, cores = build_front(2)
        try:
            seed_population(front)
            # fence shard 0's entire keyspace by hand and push a spec
            # write at it: the worker must drop it and count the refusal
            core = cores[0]
            core.range_fence.fence("manual", [(0, 1 << 64)], epoch=99)
            thr = H.make_throttle(0)
            core.handle_events([("upsert", "Throttle", thr)])
            assert core.range_fence.refused() >= 1
            core.range_fence.lift("manual")
            core.handle_events([("upsert", "Throttle", thr)])
            assert core.range_fence.refused() == 1  # unchanged after lift
        finally:
            teardown(front, cores)


# --------------------------------------------------------------------------
# hunt integration (satellites): mutators + shard-tier routing
# --------------------------------------------------------------------------


class TestHuntReshardSurface:
    def test_reshard_sites_are_mutable_and_known(self):
        from kube_throttler_tpu_torch.faults.plan import KNOWN_SITES
        from kube_throttler_tpu_torch.scenarios.hunt.mutate import MUTABLE_FAULT_SITES

        for site in (
            "reshard.handoff.torn",
            "reshard.dest.crash",
            "reshard.fence.race",
            "reshard.front.crash",
            "shard.worker.kill",
        ):
            assert site in MUTABLE_FAULT_SITES
            assert site in KNOWN_SITES

    def test_needs_shard_tier_routing(self):
        from kube_throttler_tpu_torch.scenarios.dsl import FaultSpec, Scenario
        from kube_throttler_tpu_torch.scenarios.hunt.mutate import needs_shard_tier

        plain = Scenario(name="x", description="x")
        assert not needs_shard_tier(plain)
        armed = Scenario(
            name="x", description="x",
            faults=(FaultSpec(site="shard.worker.kill", mode="kill"),),
        )
        assert needs_shard_tier(armed)
        armed2 = Scenario(
            name="x", description="x",
            faults=(FaultSpec(site="reshard.dest.crash", mode="kill"),),
        )
        assert needs_shard_tier(armed2)

    def test_gang_accel_axes_reach_topology_and_trace(self):
        from kube_throttler_tpu_torch.scenarios.dsl import Scenario, Topology
        from kube_throttler_tpu_torch.scenarios.trace import build_topology, build_trace

        scn = Scenario(
            name="axes", description="x", duration_s=1.5,
            topology=Topology(
                pods=300, throttles=24, groups=12, gang_size=4,
                accel_classes=3, class_threshold_frac=0.4,
            ),
        )
        topo = build_topology(scn, 0)
        acls = {p.get("acl") for p in topo["pods"]}
        assert acls == {"ac0", "ac1", "ac2"}
        gangs = {p["gang"] for p in topo["pods"]}
        assert gangs and all(g.startswith("gg-") for g in gangs)
        _header, ops = build_trace(scn, 0)
        annotated = [op for op in ops if "acl" in op]
        assert annotated, "trace ops must carry the accel axis"

    def test_axes_off_keeps_committed_traces_byte_identical(self):
        """The new Topology fields default OFF and must not perturb one
        byte of an existing committed trace."""
        from kube_throttler_tpu_torch.scenarios.corpus import get_scenario
        from kube_throttler_tpu_torch.scenarios.trace import (
            build_trace,
            serialize_trace,
            trace_sha256,
        )

        scn = get_scenario("smoke")
        header, ops = build_trace(scn, 0)
        sha_a = trace_sha256(serialize_trace(header, ops))
        header2, ops2 = build_trace(scn, 0)
        sha_b = trace_sha256(serialize_trace(header2, ops2))
        assert sha_a == sha_b
        assert not any("acl" in op or "gang" in op for op in ops)

    def test_mutators_cover_gang_and_accel_axes(self):
        import random

        from kube_throttler_tpu_torch.scenarios.hunt.loop import base_programs
        from kube_throttler_tpu_torch.scenarios.hunt.mutate import (
            BOUNDS,
            _mut_topology_accel,
            _mut_topology_gang,
            normalize,
        )

        base = base_programs()[0]
        rng = random.Random(7)
        child = normalize(_mut_topology_gang(base, rng))
        assert BOUNDS["gang_size"][0] <= child.topology.gang_size <= BOUNDS["gang_size"][1]
        child2 = normalize(_mut_topology_accel(base, rng))
        assert 0 <= child2.topology.accel_classes <= BOUNDS["accel_classes"][1]
        if child2.topology.accel_classes:
            assert child2.topology.class_threshold_frac > 0

    def test_reshard_metrics_registered(self):
        from kube_throttler_tpu_torch.metrics import METRIC_NAMES

        for name in (
            "kube_throttler_reshard_ranges_moving",
            "kube_throttler_reshard_handoff_bytes_total",
            "kube_throttler_reshard_handoff_events_total",
            "kube_throttler_reshard_cutover_duration_seconds",
            "kube_throttler_reshard_aborted_total",
        ):
            assert name in METRIC_NAMES
