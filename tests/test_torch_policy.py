"""Preemption & policy engine (policy/, ops/victim_select.py, journal
PREEMPT lines, scheduler preemption hook + rank-aware placement, workqueue
re-prioritize, policy-weighted flip promotion).

The hypothesis equivalence property (batched kernel ≡ sequential oracle)
lives in tests/test_victim_property.py; the SIGKILL crash coverage for
``crash.preempt.partial_evict`` in tools/crashtest.py (smoke in
tests/test_crash_recovery.py). This file is the deterministic tier.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone

import numpy as np
import torch
import pytest

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
from kube_throttler_tpu_torch.engine.journal import (
    attach,
    rollback_uncommitted_preempts,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.engine.workqueue import RateLimitingQueue
from kube_throttler_tpu_torch.ops.victim_select import victim_select
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.policy import (
    EvictionUnit,
    PolicyEngine,
    PolicySpec,
    build_selection_problem,
    compute_gang_deficits,
    policy_spec_from_dict,
    rank_eviction_units,
    sequential_victim_select,
)
from kube_throttler_tpu_torch.scheduler import Node, Scheduler
from kube_throttler_tpu_torch.utils.clock import FakeClock
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _throttle(name, cpu_m, labels=None, accel=()):
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(requests={"cpu": f"{cpu_m}m"}),
            accel_class_thresholds=tuple(accel),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(
                        LabelSelector(match_labels=labels or {"grp": name})
                    ),
                )
            ),
        ),
    )


PREEMPT_POLICY = {
    "name": "test",
    "preemptionEnabled": True,
    "minPriorityGap": 1,
    "classWeights": [{"accelClass": "gold", "weight": 2.0}],
}


def _setup(policies=None, nodes=None):
    store = Store()
    store.create_namespace(Namespace("default"))
    config = {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
    if policies is not None:
        config["policies"] = policies
    plugin = KubeThrottler(decode_plugin_args(config), store, use_device=True, device="cpu")
    sched = Scheduler(plugin, store, nodes=nodes)
    return store, plugin, sched


# ------------------------------------------------------------------ spec


class TestPolicySpec:
    def test_decode_and_defaults(self):
        spec = policy_spec_from_dict(PREEMPT_POLICY)
        assert spec.preemption_enabled and spec.min_priority_gap == 1
        assert spec.weight_for("gold") == 2.0
        assert spec.weight_for("silver") == 1.0  # default weight
        assert spec.weight_for(None) == 1.0
        assert spec.rank_aware_placement

    @pytest.mark.parametrize(
        "bad",
        [
            {"unknownKnob": 1},
            {"maxVictimsPerCycle": 0},
            {"preemptCooldownSeconds": -1},
            {"minPriorityGap": -2},
            {"defaultWeight": -0.5},
            {"classWeights": [{"weight": 1.0}]},
            {"classWeights": [{"accelClass": "a", "weight": -1.0}]},
            {"classWeights": [{"accelClass": "a", "typo": 1}]},
        ],
    )
    def test_decode_rejects(self, bad):
        with pytest.raises(ValueError):
            policy_spec_from_dict(bad)

    def test_promotion_priority_scales_weight_margin(self):
        spec = policy_spec_from_dict(PREEMPT_POLICY)
        assert spec.promotion_priority(["gold"]) == 100
        assert spec.promotion_priority(["silver"]) == 0
        assert spec.promotion_priority([]) == 0

    def test_activation_window_is_override_machinery(self):
        spec = PolicySpec(
            begin="2026-08-05T00:00:00Z", end="2026-08-05T12:00:00Z"
        )
        inside = datetime(2026, 8, 5, 6, tzinfo=timezone.utc)
        outside = datetime(2026, 8, 5, 13, tzinfo=timezone.utc)
        assert spec.is_active(inside)
        assert not spec.is_active(outside)
        # boundaries inclusive, like TemporaryThresholdOverride
        assert spec.is_active(datetime(2026, 8, 5, 12, tzinfo=timezone.utc))


class TestPolicyEngine:
    def test_first_active_wins_and_hot_swap(self):
        clock = FakeClock(datetime(2026, 8, 5, 6, tzinfo=timezone.utc))
        engine = PolicyEngine(
            specs=(
                PolicySpec(name="night", begin="2026-08-05T18:00:00Z"),
                PolicySpec(name="day", preemption_enabled=True),
            ),
            clock=clock,
        )
        assert engine.active().name == "day"
        clock.set(datetime(2026, 8, 5, 19, tzinfo=timezone.utc))
        assert engine.active().name == "night"  # window opened: first wins
        gen = engine.set_specs((PolicySpec(name="swapped"),))
        assert engine.active().name == "swapped"
        assert engine.set_specs(()) == gen + 1
        assert engine.active().name == "default"  # built-in fallback

    def test_bad_window_skipped(self):
        engine = PolicyEngine(
            specs=(
                PolicySpec(name="broken", begin="not-a-time"),
                PolicySpec(name="good"),
            )
        )
        assert engine.active().name == "good"


# ------------------------------------------------- ranking + oracle


class TestVictimRanking:
    def test_weight_then_priority_then_age_desc(self):
        units = [
            EvictionUnit(unit_key="heavy", pods=(), weight=2.0, priority=0, age_s=99),
            EvictionUnit(unit_key="young", pods=(), weight=1.0, priority=0, age_s=1),
            EvictionUnit(unit_key="old", pods=(), weight=1.0, priority=0, age_s=50),
            EvictionUnit(unit_key="hiprio", pods=(), weight=1.0, priority=3, age_s=99),
        ]
        order = [u.unit_key for u in rank_eviction_units(units)]
        # weight asc first, then priority asc, then age DESC (oldest first)
        assert order == ["old", "young", "hiprio", "heavy"]

    def test_unknown_age_ranks_oldest(self):
        units = [
            EvictionUnit(unit_key="known", pods=(), age_s=1e6),
            EvictionUnit(unit_key="unknown", pods=(), age_s=float("inf")),
        ]
        assert [u.unit_key for u in rank_eviction_units(units)][0] == "unknown"


class TestSequentialOracle:
    def test_skips_non_contributors_and_stops_early(self):
        deficit = np.array([2], dtype=np.int64)
        contrib = np.array([[0], [1], [0], [1], [5]], dtype=np.int64)
        ok, sel, rem = sequential_victim_select(deficit, contrib)
        assert ok and sel == [1, 3] and rem[0] == 0

    def test_infeasible_reports_remaining(self):
        deficit = np.array([10], dtype=np.int64)
        contrib = np.array([[3], [3]], dtype=np.int64)
        ok, sel, rem = sequential_victim_select(deficit, contrib)
        assert not ok and sel == [0, 1] and rem[0] == 4

    def test_victim_cap(self):
        deficit = np.array([3], dtype=np.int64)
        contrib = np.array([[1], [1], [1]], dtype=np.int64)
        ok, sel, _ = sequential_victim_select(deficit, contrib, max_victims=2)
        assert not ok and sel == [0, 1]

    def test_inputs_unmutated(self):
        deficit = np.array([2, 2], dtype=np.int64)
        contrib = np.array([[2, 2]], dtype=np.int64)
        sequential_victim_select(deficit, contrib)
        assert deficit.tolist() == [2, 2]


class TestKernelOracleSeeded:
    """Deterministic mini-twin of tests/test_victim_property.py (which
    needs hypothesis): 40 seeded random selection problems, batched
    kernel ≡ sequential oracle on BOTH the verdict and the selected set,
    caps included."""

    def test_randomized_problems(self):
        import random

        rng = random.Random(20260805)
        for case in range(40):
            n = rng.randint(1, 40)
            m = rng.randint(1, 8)
            cap = rng.choice([0, 0, rng.randint(1, n)])
            contrib = np.array(
                [
                    [rng.choice([0, 0, 0, 1, 2, 5, 100, 333, 1000]) for _ in range(m)]
                    for _ in range(n)
                ],
                dtype=np.int64,
            )
            deficit = np.array(
                [rng.choice([0, 1, 4, 250, 900, 2000]) for _ in range(m)],
                dtype=np.int64,
            )
            ok_s, sel_s, rem_s = sequential_victim_select(
                deficit, contrib, max_victims=cap
            )
            sel_k, ok_k, rem_k = victim_select(
                torch.as_tensor(contrib), torch.as_tensor(deficit), max_victims=cap
            )
            got = list(np.nonzero(np.asarray(sel_k))[0])
            assert (bool(np.asarray(ok_k)), got) == (ok_s, sel_s), (
                f"case {case}: kernel=({bool(np.asarray(ok_k))}, {got}) "
                f"oracle=({ok_s}, {sel_s}) cap={cap}\n{deficit}\n{contrib}"
            )
            taken = np.asarray(rem_k)
            assert taken.tolist() == rem_s.tolist()

    def test_padded_rows_and_dims_are_inert(self):
        deficit = np.array([5, 0, 0, 0], dtype=np.int64)
        contrib = np.zeros((8, 4), dtype=np.int64)
        contrib[2, 0] = 5
        sel, ok, _ = victim_select(torch.as_tensor(contrib), torch.as_tensor(deficit), max_victims=0)
        assert bool(np.asarray(ok))
        assert list(np.nonzero(np.asarray(sel))[0]) == [2]


# ------------------------------------------------------------- deficits


class TestGangDeficits:
    def _stack(self):
        store, plugin, sched = _setup(policies=[dict(PREEMPT_POLICY)])
        store.create_throttle(_throttle("t1", 400, labels={"grp": "a"}))
        for i in range(4):
            store.create_pod(
                make_pod(
                    f"res{i}", labels={"grp": "a"}, requests={"cpu": "100m"},
                    node_name="node-1", phase="Running", priority=0,
                )
            )
        sched.run_until_idle()
        return store, plugin, sched

    def _kcs(self, plugin):
        return (
            ("throttle", plugin.throttle_ctr),
            ("clusterthrottle", plugin.cluster_throttle_ctr),
        )

    def test_exact_capacity_deficit(self):
        store, plugin, sched = self._stack()
        members = [
            make_pod(f"m{i}", labels={"grp": "a"}, requests={"cpu": "100m"})
            for i in range(2)
        ]
        deficits = compute_gang_deficits(members, self._kcs(plugin))
        assert deficits == {("throttle", "default/t1", "cpu"): 200}
        plugin.stop()

    def test_member_exceeds_is_unpreemptable(self):
        store, plugin, sched = self._stack()
        members = [make_pod("big", labels={"grp": "a"}, requests={"cpu": "500m"})]
        assert compute_gang_deficits(members, self._kcs(plugin)) is None
        plugin.stop()

    def test_no_deficit_when_group_fits(self):
        store, plugin, sched = _setup(policies=[dict(PREEMPT_POLICY)])
        store.create_throttle(_throttle("t1", 400, labels={"grp": "a"}))
        members = [make_pod("m0", labels={"grp": "a"}, requests={"cpu": "100m"})]
        assert compute_gang_deficits(members, self._kcs(plugin)) == {}
        plugin.stop()

    def test_selection_problem_flattens_contribs(self):
        deficits = {("throttle", "default/t1", "cpu"): 200}
        unit = EvictionUnit(unit_key="u", pods=())
        unit.add_pod_contrib(
            "throttle", "default/t1",
            make_pod("v", requests={"cpu": "100m"}),
        )
        dims, deficit, contrib = build_selection_problem(deficits, [unit])
        assert dims == [("throttle", "default/t1", "cpu")]
        assert deficit.tolist() == [200] and contrib.tolist() == [[100]]


# ------------------------------------------------------ e2e preemption


class TestGangPreemption:
    def _residents(self, store, gang_first=True):
        """One throttle (400m) saturated by 4 running 100m pods: a gang
        of two (created FIRST — oldest, so victim rank prefers it) plus
        two singles."""
        store.create_throttle(_throttle("t1", 400, labels={"grp": "a"}))
        keys = {"gang": [], "single": []}
        for i in range(2):
            p = make_pod(
                f"vg{i}", labels={"grp": "a"}, requests={"cpu": "100m"},
                node_name="node-1", phase="Running", priority=0,
                group="victims", group_size=2,
            )
            store.create_pod(p)
            keys["gang"].append(p.key)
        for i in range(2):
            p = make_pod(
                f"vs{i}", labels={"grp": "a"}, requests={"cpu": "100m"},
                node_name="node-1", phase="Running", priority=1,
            )
            store.create_pod(p)
            keys["single"].append(p.key)
        return keys

    def test_high_priority_gang_preempts_and_admits(self):
        store, plugin, sched = _setup(policies=[dict(PREEMPT_POLICY)])
        keys = self._residents(store)
        sched.run_until_idle()
        for r in range(2):
            store.create_pod(
                make_pod(
                    f"hi-r{r}", labels={"grp": "a"}, requests={"cpu": "100m"},
                    group="hi", group_size=2, priority=5,
                )
            )
        sched.run_until_idle()
        # the gang admitted — every rank bound
        for r in range(2):
            assert store.get_pod("default", f"hi-r{r}").spec.node_name != ""
        # exactly the deficit's worth of victims evicted (200m = 2 pods)
        live = {p.key for p in store.list_pods("default")}
        assert plugin.preempt.cycles_total == 1
        assert plugin.preempt.victims_total == 2
        # whole-gang atomicity: the victim gang is all-present or all-gone
        gang_present = [k in live for k in keys["gang"]]
        assert all(gang_present) or not any(gang_present)
        plugin.stop()

    def test_victim_gang_evicts_whole_and_ledger_rolls_back(self):
        """Force the gang unit to be chosen (it is the only eligible
        victim class) and pin: both members die, none half-evicted, and a
        pending ledger record for it is rolled back."""
        store, plugin, sched = _setup(policies=[dict(PREEMPT_POLICY)])
        store.create_throttle(_throttle("t1", 200, labels={"grp": "a"}))
        for i in range(2):
            store.create_pod(
                make_pod(
                    f"vg{i}", labels={"grp": "a"}, requests={"cpu": "100m"},
                    node_name="node-1", phase="Running", priority=0,
                    group="victims", group_size=2,
                )
            )
        sched.run_until_idle()
        for r in range(2):
            store.create_pod(
                make_pod(
                    f"hi-r{r}", labels={"grp": "a"}, requests={"cpu": "100m"},
                    group="hi", group_size=2, priority=5,
                )
            )
        sched.run_until_idle()
        live = {p.key for p in store.list_pods("default")}
        assert "default/vg0" not in live and "default/vg1" not in live
        assert store.get_pod("default", "hi-r0").spec.node_name != ""
        plugin.stop()

    def test_disabled_policy_never_evicts(self):
        store, plugin, sched = _setup()  # no policies: built-in default
        self._residents(store)
        sched.run_until_idle()
        for r in range(2):
            store.create_pod(
                make_pod(
                    f"hi-r{r}", labels={"grp": "a"}, requests={"cpu": "100m"},
                    group="hi", group_size=2, priority=5,
                )
            )
        sched.run_until_idle(max_cycles=60)
        assert plugin.preempt.victims_total == 0
        assert len(store.list_pods("default")) == 6  # nobody evicted
        assert store.get_pod("default", "hi-r0").spec.node_name == ""
        plugin.stop()

    def test_priority_gap_protects_equal_priority_work(self):
        store, plugin, sched = _setup(policies=[dict(PREEMPT_POLICY)])
        store.create_throttle(_throttle("t1", 200, labels={"grp": "a"}))
        for i in range(2):
            store.create_pod(
                make_pod(
                    f"res{i}", labels={"grp": "a"}, requests={"cpu": "100m"},
                    node_name="node-1", phase="Running", priority=5,
                )
            )
        sched.run_until_idle()
        for r in range(2):
            store.create_pod(
                make_pod(
                    f"hi-r{r}", labels={"grp": "a"}, requests={"cpu": "100m"},
                    group="hi", group_size=2, priority=5,  # equal, gap 1
                )
            )
        sched.run_until_idle(max_cycles=60)
        assert plugin.preempt.victims_total == 0
        assert plugin.preempt.infeasible_total >= 1
        plugin.stop()

    def test_cooldown_skips_repeat_cycles(self):
        store, plugin, sched = _setup(
            policies=[dict(PREEMPT_POLICY, preemptCooldownSeconds=3600.0)]
        )
        members = [make_pod("m0", labels={"grp": "a"}, priority=5)]
        first = plugin.preempt.preempt_for_gang("default/g", members, mono=100.0)
        again = plugin.preempt.preempt_for_gang("default/g", members, mono=101.0)
        assert first["reason"] != "cooldown"
        assert again["reason"] == "cooldown"
        assert plugin.preempt.cooldown_skipped_total == 1
        plugin.stop()

    def test_metrics_families_export(self):
        store, plugin, sched = _setup(policies=[dict(PREEMPT_POLICY)])
        self._residents(store)
        sched.run_until_idle()
        for r in range(2):
            store.create_pod(
                make_pod(
                    f"hi-r{r}", labels={"grp": "a"}, requests={"cpu": "100m"},
                    group="hi", group_size=2, priority=5,
                )
            )
        sched.run_until_idle()
        text = plugin.metrics_registry.exposition()
        assert "kube_throttler_preempt_cycles_total 1" in text
        assert "kube_throttler_preempt_victims_total 2" in text
        assert "kube_throttler_preempt_select_duration_seconds_count" in text
        plugin.stop()


# --------------------------------------------------- journal PREEMPT


class TestPreemptJournal:
    def _evicted_store(self, tmp_path, commit: bool):
        from kube_throttler_tpu_torch.api.serialization import object_to_dict

        store = Store()
        path = str(tmp_path / "store.journal")
        journal = attach(store, path)
        store.create_namespace(Namespace("default"))
        victim = make_pod(
            "victim", labels={"grp": "a"}, node_name="node-1", phase="Running"
        )
        store.create_pod(victim)
        journal.append_preempt(
            "begin", "default/p#1",
            victims=[victim.key], objects=[object_to_dict(victim)],
        )
        store.delete_pod("default", "victim")
        if commit:
            journal.append_preempt("commit", "default/p#1")
        journal.close()
        return path

    def test_uncommitted_preempt_rolls_back_to_zero_evictions(self, tmp_path):
        path = self._evicted_store(tmp_path, commit=False)
        store2 = Store()
        journal2 = attach(store2, path)
        # attach's full replay rolled the open preemption back: the
        # victim is restored, the entry stamped rollback
        assert store2.get_pod("default", "victim").name == "victim"
        assert journal2.preempts_rolled_back == 1
        assert journal2.preempt_victims_restored == 1
        assert journal2.preempt_ops["default/p#1"]["op"] == "rollback"
        journal2.close()
        # idempotent: a THIRD replay sees the rollback stamp and restores
        # nothing new (the restored ADDED line re-journaled the victim)
        store3 = Store()
        journal3 = attach(store3, path)
        assert journal3.preempts_rolled_back == 0
        assert store3.get_pod("default", "victim").name == "victim"
        journal3.close()

    def test_committed_preempt_stays_evicted(self, tmp_path):
        path = self._evicted_store(tmp_path, commit=True)
        store2 = Store()
        journal2 = attach(store2, path)
        assert journal2.preempts_rolled_back == 0
        with pytest.raises(KeyError):
            store2.get_pod("default", "victim")
        journal2.close()

    def test_compaction_re_emits_open_preempt(self, tmp_path):
        from kube_throttler_tpu_torch.api.serialization import object_to_dict

        store = Store()
        path = str(tmp_path / "store.journal")
        journal = attach(store, path)
        store.create_namespace(Namespace("default"))
        victim = make_pod("victim", node_name="node-1", phase="Running")
        store.create_pod(victim)
        journal.append_preempt(
            "begin", "default/p#1",
            victims=[victim.key], objects=[object_to_dict(victim)],
        )
        store.delete_pod("default", "victim")
        # compaction rewrites the log from the store — the open (begin)
        # marker must survive the rewrite WITH its rollback payload
        journal.compact()
        journal.close()
        with open(path) as f:
            ops = [json.loads(line) for line in f if '"PREEMPT"' in line]
        assert [o["op"] for o in ops] == ["begin"]
        assert ops[0]["victims"] == ["default/victim"]
        assert ops[0]["victimObjects"]
        # and a post-compaction replay still rolls back to zero evictions
        store2 = Store()
        journal2 = attach(store2, path)
        assert store2.get_pod("default", "victim").name == "victim"
        assert journal2.preempts_rolled_back == 1
        journal2.close()

    def test_open_preempts_probe_and_snapshot_payload(self, tmp_path):
        from kube_throttler_tpu_torch.api.serialization import object_to_dict
        from kube_throttler_tpu_torch.engine.snapshot import SnapshotManager, load_snapshot

        store = Store()
        path = str(tmp_path / "store.journal")
        journal = attach(store, path)
        store.create_namespace(Namespace("default"))
        victim = make_pod("v", node_name="node-1", phase="Running")
        store.create_pod(victim)
        journal.append_preempt(
            "begin", "p#9", victims=[victim.key], objects=[object_to_dict(victim)]
        )
        assert set(journal.open_preempts()) == {"p#9"}
        snapshotter = SnapshotManager(str(tmp_path), store)
        snapshotter.journal = journal
        snap_path = snapshotter.write(reason="test")
        payload = load_snapshot(snap_path)
        assert "p#9" in (payload.get("preempts") or {})
        journal.append_preempt("commit", "p#9")
        assert journal.open_preempts() == {}
        journal.close()

    def test_rollback_merges_snapshot_extras(self, tmp_path):
        """Tail-mode shape: the journal never saw the begin line — the
        snapshot's open-preempt payload alone drives the restore."""
        from kube_throttler_tpu_torch.api.serialization import object_to_dict

        store = Store()
        journal = attach(store, str(tmp_path / "j"))
        store.create_namespace(Namespace("default"))
        victim = make_pod("v", node_name="node-1", phase="Running")
        extras = {
            "p#7": {
                "op": "begin",
                "victims": [victim.key],
                "victimObjects": [object_to_dict(victim)],
            }
        }
        rolled, restored = rollback_uncommitted_preempts(
            store, journal, extra_ops=extras
        )
        assert (rolled, restored) == (1, 1)
        assert store.get_pod("default", "v").name == "v"
        journal.close()

    def test_standby_forwards_preempt_lines(self, tmp_path):
        from kube_throttler_tpu_torch.engine.replication import StandbyReplicator

        store = Store()
        journal = attach(store, str(tmp_path / "j"))
        rep = StandbyReplicator(store, journal, "http://127.0.0.1:1")
        line = json.dumps(
            {"type": "PREEMPT", "op": "begin", "id": "p#3", "victims": ["d/x"]}
        ).encode()
        applied = rep._apply_lines(line + b"\n")
        assert applied == 0 and rep.lines_skipped == 0
        assert journal.preempt_ops["p#3"]["op"] == "begin"
        journal.close()


# ------------------------------------------- workqueue re-prioritize


class TestWorkqueueReprioritize:
    def test_update_reorders_queued_item(self):
        q = RateLimitingQueue("t")
        q.add_all_priority(["a"], priorities={"a": 1})
        q.add_all_priority(["b"], priorities={"b": 3})
        assert len(q) == 2
        q.add_all_priority(["a"], priorities={"a": 5})  # the update
        assert len(q) == 2  # still queued once (lane-global dedup)
        assert q.get() == "a"  # 5 > 3: the update took effect
        q.done("a")
        assert q.get() == "b"
        q.done("b")
        # the superseded heap entry drains as nothing
        assert q.try_get() is None
        q.shut_down()

    def test_downgrade_also_reorders(self):
        q = RateLimitingQueue("t")
        q.add_all_priority(["a"], priorities={"a": 5})
        q.add_all_priority(["b"], priorities={"b": 3})
        q.add_all_priority(["a"], priorities={"a": 1})
        assert q.get() == "b"
        q.done("b")
        assert q.get() == "a"
        q.done("a")
        q.shut_down()

    def test_same_priority_readd_is_noop(self):
        q = RateLimitingQueue("t")
        q.add_all_priority(["a", "b"], priorities={"a": 2, "b": 2})
        q.add_all_priority(["a"], priorities={"a": 2})
        # age order preserved: the no-op re-add must not reset a's seq
        assert q.get() == "a"
        q.done("a")
        q.shut_down()

    def test_timeout_after_stale_only_heap(self):
        q = RateLimitingQueue("t")
        q.add_all_priority(["a"], priorities={"a": 1})
        q.add_all_priority(["a"], priorities={"a": 5})
        assert q.get() == "a"
        q.done("a")
        with pytest.raises(TimeoutError):
            q.get(timeout=0.05)
        q.shut_down()

    def test_processing_reprioritize_latest_wins(self):
        q = RateLimitingQueue("t")
        q.add("a")
        assert q.get() == "a"  # in processing
        q.add_all_priority(["a"], priorities={"a": 2})
        q.add_all_priority(["a"], priorities={"a": 7})
        q.add_all_priority(["b"], priorities={"b": 5})
        q.done("a")  # re-queued hi at the LATEST recorded priority (7)
        assert q.get() == "a"
        q.done("a")
        q.shut_down()


class TestSchedulerPriorityUpdate:
    def test_annotation_update_reorders_parked_pods(self):
        from dataclasses import replace

        from kube_throttler_tpu_torch.api.pod import PRIORITY_ANNOTATION

        store, plugin, sched = _setup()
        store.create_throttle(
            Throttle(
                name="t1",
                spec=ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(pod=0),
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(
                                LabelSelector(match_labels={"grp": "a"})
                            ),
                        )
                    ),
                ),
            )
        )
        store.create_pod(make_pod("old-low", labels={"grp": "a"}, priority=0))
        store.create_pod(make_pod("young-high", labels={"grp": "a"}, priority=5))
        assert sched.run_until_idle(max_cycles=50) == 0
        # the annotation update: old-low becomes the highest priority
        pod = store.get_pod("default", "old-low")
        ann = dict(pod.annotations)
        ann[PRIORITY_ANNOTATION] = "9"
        store.update_pod(replace(pod, annotations=ann))
        thr = store.get_throttle("default", "t1")
        store.update_throttle_spec(
            replace(thr, spec=replace(thr.spec, threshold=ResourceAmount.of(pod=1)))
        )
        assert sched.run_until_idle() == 1
        assert store.get_pod("default", "old-low").spec.node_name != ""
        assert store.get_pod("default", "young-high").spec.node_name == ""
        plugin.stop()


# ------------------------------------- policy-weighted flip promotion


class TestPolicyFlipPromotion:
    def test_flip_priorities_from_accel_weights(self):
        store, plugin, sched = _setup(policies=[dict(PREEMPT_POLICY)])
        store.create_throttle(
            _throttle(
                "gold-t", 400, labels={"grp": "g"},
                accel=(AccelClassThreshold("gold", ResourceAmount.of(pod=3)),),
            )
        )
        store.create_throttle(_throttle("plain-t", 400, labels={"grp": "p"}))
        pri = plugin.throttle_ctr.flip_priorities(
            ["default/gold-t", "default/plain-t", "default/ghost"]
        )
        assert pri == {"default/gold-t": 100}
        plugin.stop()

    def test_weighted_promotion_orders_hi_lane(self):
        store, plugin, sched = _setup(policies=[dict(PREEMPT_POLICY)])
        ctr = plugin.throttle_ctr
        ctr.workqueue.add_all_priority(
            ["default/plain"], priorities=ctr.flip_priorities(["default/plain"])
        )
        store.create_throttle(
            _throttle(
                "gold-t", 400, labels={"grp": "g"},
                accel=(AccelClassThreshold("gold", ResourceAmount.of(pod=3)),),
            )
        )
        ctr.workqueue.add_all_priority(
            ["default/gold-t"],
            priorities=ctr.flip_priorities(["default/gold-t"]),
        )
        # the gold throttle enqueued LATER but drains FIRST (weight 2.0)
        assert ctr.workqueue.get() == "default/gold-t"
        ctr.workqueue.done("default/gold-t")
        plugin.stop()


# --------------------------------------------- rank-aware placement


class TestRankAwarePlacement:
    """Three nodes: n0 has room only for SMALL ranks, n1/n2 are roomy.
    Gang ranks request [1.5, 0.5, 1.5] cpu (name order == admission
    order). First-fit fragments rank 1 back onto n0; contiguity keeps it
    with rank 0 on n1 — the topology-adjacent placement."""

    def _nodes(self):
        return [
            Node("n0", allocatable={"cpu": "1"}),
            Node("n1", allocatable={"cpu": "4"}),
            Node("n2", allocatable={"cpu": "4"}),
        ]

    def _gang(self, store):
        for r, cpu in enumerate(["1500m", "500m", "1500m"]):
            store.create_pod(
                make_pod(
                    f"g-r{r}", labels={"grp": "a"}, requests={"cpu": cpu},
                    group="g", group_size=3,
                )
            )

    def test_gang_lands_contiguous(self):
        store, plugin, sched = _setup(nodes=self._nodes())
        self._gang(store)
        sched.run_until_idle()
        placed = [
            store.get_pod("default", f"g-r{r}").spec.node_name for r in range(3)
        ]
        assert placed == ["n1", "n1", "n1"]
        plugin.stop()

    def test_policy_can_disable_contiguity(self):
        store, plugin, sched = _setup(
            policies=[{"name": "flat", "rankAwarePlacement": False}],
            nodes=self._nodes(),
        )
        assert sched._placement_rank_aware() is False
        self._gang(store)
        sched.run_until_idle()
        placed = [
            store.get_pod("default", f"g-r{r}").spec.node_name for r in range(3)
        ]
        # original first-fit: the small rank fragments back onto n0
        assert placed == ["n1", "n0", "n1"]
        plugin.stop()
