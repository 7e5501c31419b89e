"""Gang & heterogeneity-aware admission (engine/gang.py, ops/gang_check.py,
scheduler gang cycles, workqueue ordered lane, snapshot/recovery wiring).

The hypothesis equivalence property (batched kernel ≡ sequential oracle)
lives in tests/test_gang_property.py; the SIGKILL crash matrix coverage in
tests/test_crash_recovery.py. This file is the deterministic tier.
"""

from __future__ import annotations

import json
from datetime import datetime, timedelta, timezone

import pytest

from kube_throttler_tpu_torch.api.pod import (
    Namespace,
    accel_class_of,
    make_pod,
    pod_group_of,
    priority_of,
)
from kube_throttler_tpu_torch.api.types import (
    AccelClassThreshold,
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.engine.gang import GangLedger
from kube_throttler_tpu_torch.engine.journal import attach
from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
from kube_throttler_tpu_torch.engine.reservations import ReservedResourceAmounts
from kube_throttler_tpu_torch.engine.snapshot import SnapshotManager
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.engine.workqueue import RateLimitingQueue
from kube_throttler_tpu_torch.faults.plan import FaultPlan
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.plugin.framework import RecordingEventRecorder
from kube_throttler_tpu_torch.scheduler import Node, Scheduler
from kube_throttler_tpu_torch.utils.clock import FakeClock
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _throttle(name, pod=None, cpu=None, accel=(), labels=None):
    requests = {"cpu": cpu} if cpu else None
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(pod=pod, requests=requests),
            accel_class_thresholds=tuple(accel),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(
                        LabelSelector(match_labels=labels or {"throttle": name})
                    ),
                )
            ),
        ),
    )


def _setup(nodes=None, use_device=True):
    store = Store()
    store.create_namespace(Namespace("default"))
    recorder = RecordingEventRecorder()
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        event_recorder=recorder,
        use_device=use_device, device="cpu",
    )
    sched = Scheduler(plugin, store, nodes=nodes)
    return store, plugin, sched, recorder


def _member(name, group, size, cpu="100m", labels=None, **kw):
    return make_pod(
        name,
        labels=labels or {"throttle": "t1"},
        requests={"cpu": cpu},
        group=group,
        group_size=size,
        **kw,
    )


# ---------------------------------------------------------------- contract


class TestPodGroupContract:
    def test_group_parse(self):
        p = make_pod("a", namespace="ns1", group="job", group_size=4)
        g = pod_group_of(p)
        assert g.key == "ns1/job" and g.name == "job" and g.size == 4

    def test_no_annotations_is_per_pod(self):
        assert pod_group_of(make_pod("a")) is None

    @pytest.mark.parametrize("size", ["", "zero", "0", "-3"])
    def test_malformed_size_degrades_to_per_pod(self, size):
        p = make_pod("a", group="job")
        p.annotations["kube-throttler.github.io/pod-group-size"] = size
        assert pod_group_of(p) is None

    def test_accel_class_and_priority(self):
        p = make_pod("a", accel_class="tpu-v5e", priority=9)
        assert accel_class_of(p) == "tpu-v5e"
        assert priority_of(p) == 9
        q = make_pod("b")
        q.annotations["kube-throttler.github.io/priority"] = "not-a-number"
        assert priority_of(q) == 0

    def test_annotations_roundtrip_serialization(self):
        from kube_throttler_tpu_torch.api.serialization import pod_from_dict, pod_to_dict

        p = make_pod("a", group="job", group_size=2, accel_class="v5p", priority=3)
        back = pod_from_dict(pod_to_dict(p))
        assert pod_group_of(back) == pod_group_of(p)
        assert accel_class_of(back) == "v5p" and priority_of(back) == 3

    def test_accel_thresholds_roundtrip_serialization(self):
        from kube_throttler_tpu_torch.api.serialization import (
            throttle_from_dict,
            throttle_to_dict,
        )

        thr = _throttle(
            "t1", pod=10, accel=[AccelClassThreshold("v5e", ResourceAmount.of(pod=2))]
        )
        back = throttle_from_dict(throttle_to_dict(thr))
        assert back.spec.accel_class_thresholds == thr.spec.accel_class_thresholds
        assert back.spec.accel_threshold_for("v5e") == ResourceAmount.of(pod=2)
        assert back.spec.accel_threshold_for("v5p") is None


# ---------------------------------------------------------- ordered lane


class TestOrderedPriorityLane:
    def test_priority_then_age_order(self):
        q = RateLimitingQueue("test")
        q.add_all_priority(["low-old"], priorities={"low-old": 1})
        q.add_all_priority(["hi"], priorities={"hi": 5})
        q.add_all_priority(["low-new"], priorities={"low-new": 1})
        assert [q.get(timeout=1) for _ in range(3)] == ["hi", "low-old", "low-new"]
        q.shut_down()

    def test_default_stays_fifo(self):
        q = RateLimitingQueue("test")
        q.add_all_priority(["a", "b", "c"])
        assert [q.get(timeout=1) for _ in range(3)] == ["a", "b", "c"]
        q.shut_down()

    def test_promote_from_normal_lane_keeps_single_queueing(self):
        q = RateLimitingQueue("test")
        q.add("x")
        q.add("y")
        q.add_all_priority(["y"], priorities={"y": 2})
        got = [q.get(timeout=1), q.get(timeout=1)]
        assert got == ["y", "x"]
        assert len(q) == 0
        q.shut_down()

    def test_processing_requeues_with_priority_at_done(self):
        q = RateLimitingQueue("test")
        q.add("a")
        assert q.get(timeout=1) == "a"
        q.add_all_priority(["a"], priorities={"a": 3})  # while processing
        q.add_all_priority(["b"], priorities={"b": 1})
        q.done("a")
        # a re-enters the hi lane at priority 3, beating b's 1
        assert q.get(timeout=1) == "a"
        assert q.get(timeout=1) == "b"
        q.shut_down()

    def test_hi_lane_drains_before_normal(self):
        q = RateLimitingQueue("test")
        q.add("norm")
        q.add_priority("flip")
        assert q.get(timeout=1) == "flip"
        q.shut_down()


# ---------------------------------------------------------------- ledger


def _caches(clock=None):
    return {
        "throttle": ReservedResourceAmounts(8, clock=clock),
        "clusterthrottle": ReservedResourceAmounts(8, clock=clock),
    }


def _mk_members(n, prefix="m"):
    pods = [_member(f"{prefix}{i}", "job", n) for i in range(n)]
    member_keys = {p.key: {"throttle": ["default/t1"]} for p in pods}
    return pods, member_keys


class TestGangLedger:
    def test_reserve_then_rollback_releases_everything(self):
        caches = _caches()
        ledger = GangLedger(caches)
        pods, keys = _mk_members(3)
        assert ledger.reserve_group("default/job", pods, keys) is True
        assert caches["throttle"].reserved_pod_keys("default/t1") == {
            p.key for p in pods
        }
        assert ledger.pending_groups() == 1
        assert ledger.rollback_group("default/job") is True
        assert caches["throttle"].reserved_pod_keys("default/t1") == set()
        assert ledger.groups_rolled_back_total == 1

    def test_reserve_is_idempotent_for_pending_group(self):
        caches = _caches()
        ledger = GangLedger(caches)
        pods, keys = _mk_members(2)
        assert ledger.reserve_group("default/job", pods, keys)
        assert ledger.reserve_group("default/job", pods, keys)
        assert ledger.groups_reserved_total == 1

    def test_member_failure_rolls_back_already_added(self):
        """Fault site gang.reserve.partial: the 3rd member-key add raises —
        the first two members' reservations must be gone afterwards."""
        caches = _caches()
        plan = FaultPlan(seed=1).rule("gang.reserve.partial", schedule=[3])
        ledger = GangLedger(caches, faults=plan)
        pods, keys = _mk_members(4)
        assert ledger.reserve_group("default/job", pods, keys) is False
        assert caches["throttle"].reserved_pod_keys("default/t1") == set()
        assert ledger.pending_groups() == 0
        assert ledger.groups_rolled_back_total == 1

    def test_group_ttl_expiry_frees_all_members(self):
        clock = FakeClock(datetime(2026, 1, 1, tzinfo=timezone.utc))
        caches = _caches(clock)
        ledger = GangLedger(caches, clock=clock, default_ttl=30.0)
        pods, keys = _mk_members(3)
        assert ledger.reserve_group("default/job", pods, keys)
        clock.advance(timedelta(seconds=31))
        assert ledger.pending_groups() == 0
        assert ledger.groups_expired_total == 1
        # member reservations carried the same TTL — expired with the group
        assert caches["throttle"].reserved_pod_keys("default/t1") == set()

    def test_bound_members_admit_and_group_retires(self):
        from kube_throttler_tpu_torch.engine.store import Event, EventType

        caches = _caches()
        ledger = GangLedger(caches)
        pods, keys = _mk_members(2)
        ledger.reserve_group("default/job", pods, keys)
        for p in pods:
            bound = make_pod(p.name, node_name="node-1")
            ledger.on_pod_event(Event(EventType.MODIFIED, "Pod", bound, old_obj=p))
        assert ledger.pending_groups() == 0
        assert ledger.groups_admitted_total == 1

    def test_member_deleted_preadmission_rolls_whole_group_back(self):
        from kube_throttler_tpu_torch.engine.store import Event, EventType

        caches = _caches()
        ledger = GangLedger(caches)
        pods, keys = _mk_members(3)
        ledger.reserve_group("default/job", pods, keys)
        ledger.on_pod_event(Event(EventType.DELETED, "Pod", pods[1]))
        assert ledger.pending_groups() == 0
        assert ledger.groups_rolled_back_total == 1
        assert caches["throttle"].reserved_pod_keys("default/t1") == set()

    def test_note_unreserved_counts_member_admitted(self):
        caches = _caches()
        ledger = GangLedger(caches)
        pods, keys = _mk_members(2)
        ledger.reserve_group("default/job", pods, keys)
        ledger.note_unreserved("throttle", "default/t1", pods[0].key)
        ledger.note_unreserved("throttle", "default/t1", pods[1].key)
        assert ledger.groups_admitted_total == 1
        assert ledger.pending_groups() == 0

    def test_snapshot_restore_roundtrip_rebases_ttl(self):
        clock = FakeClock(datetime(2026, 1, 1, tzinfo=timezone.utc))
        caches = _caches(clock)
        ledger = GangLedger(caches, clock=clock, default_ttl=60.0)
        pods, keys = _mk_members(2)
        ledger.reserve_group("default/job", pods, keys)
        state = ledger.snapshot_state()
        assert state["default/job"]["ttlRemainingSeconds"] == pytest.approx(60.0)

        clock2 = FakeClock(datetime(2026, 6, 1, tzinfo=timezone.utc))
        caches2 = _caches(clock2)
        for p in pods:
            caches2["throttle"].add_pod("default/t1", p, ttl=60.0)
        ledger2 = GangLedger(caches2, clock=clock2)
        restored, dropped = ledger2.restore_state(state, elapsed_s=20.0)
        assert (restored, dropped) == (1, 0)
        rec = ledger2.group_record("default/job")
        remaining = (rec.deadline - clock2.now()).total_seconds()
        assert remaining == pytest.approx(40.0)

    def test_restore_drops_expired_group_and_its_members(self):
        clock = FakeClock(datetime(2026, 1, 1, tzinfo=timezone.utc))
        caches = _caches(clock)
        ledger = GangLedger(caches, clock=clock, default_ttl=10.0)
        pods, keys = _mk_members(2)
        ledger.reserve_group("default/job", pods, keys)
        state = ledger.snapshot_state()

        clock2 = FakeClock(datetime(2026, 6, 1, tzinfo=timezone.utc))
        caches2 = _caches(clock2)
        for p in pods:
            caches2["throttle"].add_pod("default/t1", p)  # no TTL: survived restore
        ledger2 = GangLedger(caches2, clock=clock2)
        restored, dropped = ledger2.restore_state(state, elapsed_s=99.0)
        assert (restored, dropped) == (0, 1)
        # the dead gang's members were pruned back out of the caches
        assert caches2["throttle"].reserved_pod_keys("default/t1") == set()


# ------------------------------------------------------- journal stamping


class TestGangJournal:
    def test_stamps_replay_into_gang_ops(self, tmp_path):
        store = Store()
        journal = attach(store, str(tmp_path / "store.journal"))
        ledger = GangLedger(_caches(), journal=journal)
        pods, keys = _mk_members(2)
        ledger.reserve_group("default/job", pods, keys)
        ledger.rollback_group("default/job")
        journal.close()

        store2 = Store()
        journal2 = attach(store2, str(tmp_path / "store.journal"))
        entry = journal2.gang_ops["default/job"]
        assert entry["op"] == "rollback"
        # members inherited from the begin line through commit+rollback
        assert sorted(entry["members"]) == sorted(p.key for p in pods)
        journal2.close()

    def test_gang_lines_have_no_store_effect(self, tmp_path):
        store = Store()
        journal = attach(store, str(tmp_path / "store.journal"))
        store.create_namespace(Namespace("default"))
        journal.append_gang("begin", "default/job", members=["default/m0"])
        journal.close()
        with open(tmp_path / "store.journal") as f:
            lines = [json.loads(line) for line in f]
        assert lines[-1]["type"] == "GANG"
        replayed = Store()
        attach(replayed, str(tmp_path / "store.journal")).close()
        assert [n.name for n in replayed.list_namespaces()] == ["default"]

    def test_recovery_rolls_back_begin_without_commit(self, tmp_path):
        """Mid-reserve crash shape, driven without SIGKILL: journal says
        begin (no commit) while the caches still carry a member — recovery
        must remove it."""
        store = Store()
        journal = attach(store, str(tmp_path / "store.journal"))
        journal.append_gang("begin", "default/job", members=["default/m0", "default/m1"])
        journal.close()

        recovered = Store()
        rec = RecoveryManager(str(tmp_path))
        journal2 = rec.recover_store(recovered)
        caches = _caches()
        caches["throttle"].add_pod("default/t1", make_pod("m0"))
        ledger = GangLedger(caches)
        rec.restore_gangs(ledger, journal2)
        journal2.close()
        assert rec.report.gangs_rolled_back == 1
        assert caches["throttle"].reserved_pod_keys("default/t1") == set()


# ----------------------------------------------------- snapshot atomicity


class TestGangSnapshot:
    def test_snapshot_carries_gangs_and_restore_rebuilds(self, tmp_path):
        store = Store()
        store.create_namespace(Namespace("default"))
        journal = attach(store, str(tmp_path / "store.journal"))
        caches = _caches()
        ledger = GangLedger(caches, journal=journal)
        pods, keys = _mk_members(3)
        ledger.reserve_group("default/job", pods, keys)
        mgr = SnapshotManager(
            str(tmp_path), store, reservations=caches, gang_ledger=ledger
        )
        mgr.journal = journal
        assert mgr.write() is not None
        journal.close()

        recovered = Store()
        rec = RecoveryManager(str(tmp_path))
        journal2 = rec.recover_store(recovered)
        caches2 = _caches()
        rec.restore_reservations(caches2)
        ledger2 = GangLedger(caches2)
        rec.restore_gangs(ledger2, journal2)
        journal2.close()
        assert rec.report.gangs_restored == 1
        rec2 = ledger2.group_record("default/job")
        assert set(rec2.members) == {p.key for p in pods}
        # members' reservations restored alongside — fully reserved
        assert caches2["throttle"].reserved_pod_keys("default/t1") == {
            p.key for p in pods
        }


# ----------------------------------------------------- admission surfaces


class TestGangAdmission:
    def test_device_and_host_verdicts_agree(self):
        """pre_filter_gang through the batched kernel (device plugin) and
        through the sequential host oracle (use_device=False) must agree
        on feasible and infeasible groups alike."""
        scenarios = [
            (3, 4, True),  # 3 ranks under pod=4 → fits
            (5, 4, False),  # 5 ranks under pod=4 → all-or-nothing reject
            (4, 4, True),  # exact fit (onEqual=False admission)
        ]
        for n, cap, want in scenarios:
            for use_device in (True, False):
                store = Store()
                store.create_namespace(Namespace("default"))
                plugin = KubeThrottler(
                    decode_plugin_args(
                        {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
                    ),
                    store,
                    use_device=use_device, device="cpu",
                )
                store.create_throttle(_throttle("t1", pod=cap))
                pods = [_member(f"m{i}", "job", n) for i in range(n)]
                st = plugin.pre_filter_gang("default/job", pods)
                assert st.is_success() is want, (
                    f"n={n} cap={cap} device={use_device}: {st.reasons}"
                )
                plugin.stop()

    def test_partial_fit_rejects_whole_group(self):
        """Per-pod admission would admit 2 of 5 — gang admission admits 0."""
        store, plugin, _sched, _ = _setup()
        store.create_throttle(_throttle("t1", pod=2))
        pods = [_member(f"m{i}", "job", 5) for i in range(5)]
        st = plugin.pre_filter_gang("default/job", pods)
        assert not st.is_success()
        # the members would pass per-pod pre_filter individually
        assert plugin.pre_filter(pods[0]).is_success()
        plugin.stop()

    def test_accel_class_threshold_resolves_per_pod_check(self):
        store, plugin, _sched, _ = _setup()
        store.create_throttle(
            _throttle(
                "t1",
                pod=10,
                accel=[AccelClassThreshold("v5e", ResourceAmount.of(pod=0))],
            )
        )
        base_pod = make_pod("p", labels={"throttle": "t1"})
        accel_pod = make_pod("q", labels={"throttle": "t1"}, accel_class="v5e")
        assert plugin.pre_filter(base_pod).is_success()
        st = plugin.pre_filter(accel_pod)
        assert not st.is_success()
        assert "pod-requests-exceeds-threshold" in ";".join(st.reasons)
        plugin.stop()

    def test_gang_accel_class_uses_class_threshold(self):
        store, plugin, _sched, _ = _setup()
        store.create_throttle(
            _throttle(
                "t1",
                pod=8,
                accel=[AccelClassThreshold("v5p", ResourceAmount.of(pod=2))],
            )
        )
        pods = [
            _member(f"m{i}", "job", 3, accel_class="v5p") for i in range(3)
        ]
        st = plugin.pre_filter_gang("default/job", pods)
        assert not st.is_success()
        # same group without the class rides the base pod=8 threshold
        plain = [_member(f"n{i}", "job2", 3) for i in range(3)]
        assert plugin.pre_filter_gang("default/job2", plain).is_success()
        plugin.stop()


# ---------------------------------------------------------- scheduler e2e


class TestGangScheduling:
    def test_gang_waits_for_members_then_binds_all(self):
        store, plugin, sched, recorder = _setup()
        store.create_throttle(_throttle("t1", pod=10))
        store.create_pod(_member("r0", "job", 3))
        store.create_pod(_member("r1", "job", 3))
        assert sched.run_until_idle() == 0
        assert any(
            e.reason == "FailedScheduling" and "waiting for members" in e.note
            for e in recorder.events
        )
        # third rank arrives → the whole gang binds in one cycle
        store.create_pod(_member("r2", "job", 3))
        bound = sched.run_until_idle()
        assert bound >= 1
        for name in ("r0", "r1", "r2"):
            assert store.get_pod("default", name).spec.node_name != ""
        # ledger retired the group once every rank was observed bound
        assert plugin.gang.pending_groups() == 0
        assert plugin.gang.groups_admitted_total == 1
        plugin.stop()

    def test_gang_all_or_nothing_under_throttle(self):
        store, plugin, sched, recorder = _setup()
        store.create_throttle(_throttle("t1", pod=2))
        for i in range(3):
            store.create_pod(_member(f"r{i}", "job", 3))
        assert sched.run_until_idle(max_cycles=50) == 0
        for i in range(3):
            assert store.get_pod("default", f"r{i}").spec.node_name == ""
        assert plugin.gang.pending_groups() == 0
        assert any(
            e.reason == "FailedScheduling" and "gang" in e.note for e in recorder.events
        )
        plugin.stop()

    def test_gang_all_or_nothing_under_node_capacity(self):
        store, plugin, sched, _ = _setup(nodes=[Node("tiny", max_pods=2)])
        store.create_throttle(_throttle("t1", pod=10))
        for i in range(3):
            store.create_pod(_member(f"r{i}", "job", 3))
        assert sched.run_until_idle(max_cycles=50) == 0
        for i in range(3):
            assert store.get_pod("default", f"r{i}").spec.node_name == ""
        plugin.stop()

    def test_gang_admits_when_capacity_opens(self):
        store, plugin, sched, _ = _setup()
        store.create_throttle(_throttle("t1", pod=2))
        for i in range(3):
            store.create_pod(_member(f"r{i}", "job", 3))
        assert sched.run_until_idle(max_cycles=50) == 0
        # capacity opens: threshold raised → event-driven requeue fires
        from dataclasses import replace

        thr = store.get_throttle("default", "t1")
        store.update_throttle_spec(
            replace(
                thr,
                spec=replace(thr.spec, threshold=ResourceAmount.of(pod=5)),
            )
        )
        assert sched.run_until_idle() >= 1
        for i in range(3):
            assert store.get_pod("default", f"r{i}").spec.node_name != ""
        plugin.stop()

    def test_priority_order_when_capacity_opens(self):
        """Preemption-ordered admission: two parked pods, the YOUNGER one
        carrying higher priority — when the throttle opens one slot, the
        high-priority pod takes it."""
        store, plugin, sched, _ = _setup()
        store.create_throttle(_throttle("t1", pod=0))
        store.create_pod(
            make_pod("old-low", labels={"throttle": "t1"}, priority=0)
        )
        store.create_pod(
            make_pod("young-high", labels={"throttle": "t1"}, priority=5)
        )
        assert sched.run_until_idle(max_cycles=50) == 0
        from dataclasses import replace

        thr = store.get_throttle("default", "t1")
        store.update_throttle_spec(
            replace(thr, spec=replace(thr.spec, threshold=ResourceAmount.of(pod=1)))
        )
        assert sched.run_until_idle() == 1
        assert store.get_pod("default", "young-high").spec.node_name != ""
        assert store.get_pod("default", "old-low").spec.node_name == ""
        plugin.stop()

    def test_gang_members_share_age_order_with_equal_priority(self):
        """Two plain pods, equal priority: the older binds first when one
        slot opens (the age tiebreak)."""
        store, plugin, sched, _ = _setup()
        store.create_throttle(_throttle("t1", pod=0))
        store.create_pod(make_pod("first", labels={"throttle": "t1"}))
        store.create_pod(make_pod("second", labels={"throttle": "t1"}))
        assert sched.run_until_idle(max_cycles=50) == 0
        from dataclasses import replace

        thr = store.get_throttle("default", "t1")
        store.update_throttle_spec(
            replace(thr, spec=replace(thr.spec, threshold=ResourceAmount.of(pod=1)))
        )
        assert sched.run_until_idle() == 1
        assert store.get_pod("default", "first").spec.node_name != ""
        assert store.get_pod("default", "second").spec.node_name == ""
        plugin.stop()


# ----------------------------------------- seeded kernel ↔ oracle sweep


class TestKernelOracleSeeded:
    """Deterministic mini-twin of tests/test_gang_property.py (which needs
    hypothesis): 40 seeded random scenarios, batched kernel verdict ==
    sequential per-pod oracle. Runs in tier-1 on environments without
    hypothesis so the equivalence never goes untested."""

    def test_randomized_scenarios(self):
        import random

        from kube_throttler_tpu_torch.engine.gang import sequential_gang_check

        rng = random.Random(20260804)

        def amount():
            cnt = rng.choice([None, 0, 1, 2, 3, 5])
            cpu = rng.choice([None, 0, 500, 1000, 2500])
            return ResourceAmount.of(
                pod=cnt, requests={"cpu": f"{cpu}m"} if cpu is not None else None
            )

        for case in range(40):
            store = Store()
            store.create_namespace(Namespace("default"))
            plugin = KubeThrottler(
                decode_plugin_args(
                    {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
                ),
                store,
                use_device=True, device="cpu",
            )
            throttles = []
            for j in range(rng.randint(1, 3)):
                threshold = amount()
                used = amount()
                accel = tuple(
                    AccelClassThreshold(cls, amount())
                    for cls in ("v5e",)
                    if rng.random() < 0.4
                )
                grp = rng.choice(["g0", "g1", "*"])
                from kube_throttler_tpu_torch.api.types import ThrottleStatus

                thr = Throttle(
                    name=f"t{j}",
                    spec=ThrottleSpec(
                        throttler_name="kube-throttler",
                        threshold=threshold,
                        accel_class_thresholds=accel,
                        selector=ThrottleSelector(
                            selector_terms=(
                                ThrottleSelectorTerm(
                                    LabelSelector(
                                        match_labels=(
                                            {} if grp == "*" else {"grp": grp}
                                        )
                                    )
                                ),
                            )
                        ),
                    ),
                    status=ThrottleStatus(
                        used=used, throttled=threshold.is_throttled(used, True)
                    ),
                )
                store.create_throttle(thr)
                throttles.append(thr)
            if rng.random() < 0.5:
                plugin.reserve(
                    make_pod(
                        "filler",
                        labels={"grp": rng.choice(["g0", "g1"])},
                        requests={"cpu": f"{rng.randint(0, 1500)}m"},
                    )
                )
            accel_cls = rng.choice([None, "v5e"])
            members = [
                make_pod(
                    f"m{i}",
                    labels={"grp": rng.choice(["g0", "g1"])},
                    requests={"cpu": f"{rng.choice([0, 250, 800, 1500])}m"},
                    group="job",
                    group_size=4,
                    accel_class=accel_cls,
                )
                for i in range(rng.randint(1, 5))
            ]
            kernel = plugin.device_manager.gang_check_groups(
                [("default/job", members, accel_cls)]
            )["default/job"]
            oracle_ok, blocked = sequential_gang_check(
                members,
                (
                    ("throttle", plugin.throttle_ctr, False),
                    ("clusterthrottle", plugin.cluster_throttle_ctr, False),
                ),
            )
            assert kernel["ok"] == oracle_ok, (
                f"case {case}: kernel={kernel} oracle={oracle_ok} "
                f"blocked={blocked} accel={accel_cls} members="
                f"{[(m.name, m.labels, m.spec.containers[0].requests) for m in members]} "
                f"throttles={[(t.key, t.spec.threshold, t.status.used, t.spec.accel_class_thresholds) for t in throttles]}"
            )
            plugin.stop()


# ------------------------------------------------------------- metrics


class TestGangMetrics:
    def test_families_export(self):
        store, plugin, _sched, _ = _setup()
        store.create_throttle(_throttle("t1", pod=10))
        pods = [_member(f"m{i}", "job", 2) for i in range(2)]
        assert plugin.pre_filter_gang("default/job", pods).is_success()
        assert plugin.reserve_gang("default/job", pods).is_success()
        text = plugin.metrics_registry.exposition()
        assert "kube_throttler_gang_groups_pending 1" in text
        assert "kube_throttler_gang_check_duration_seconds_count 1" in text
        plugin.unreserve_gang("default/job")
        text = plugin.metrics_registry.exposition()
        assert "kube_throttler_gang_groups_pending 0" in text
        assert "kube_throttler_gang_groups_rolled_back_total 1" in text
        plugin.stop()
