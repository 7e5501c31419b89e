"""Interned-verdict cache (engine/verdictcache.py) + the epoch planes that
invalidate it.

The load-bearing suite is the epoch-bump COMPLETENESS sweep: a seeded
mutation mix (status flips, threshold edits, override windows, policy
swaps, reservations, gang reserve/rollback, preemption, namespace churn)
where after EVERY mutation the cached ``pre_filter`` must agree with the
uncached recompute on the same state — any mutation site missing its
epoch bump serves a stale verdict here and fails the pin. The front-tier
mirror (sharding/front.py) gets the same treatment over the scatter
path, including the reshard/resync/attach global bumps.
"""

from __future__ import annotations

import random

import pytest

from conftest import normalize_reasons as norm
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    LabelSelector,
    ResourceAmount,
    TemporaryThresholdOverride,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.engine.verdictcache import VerdictCache
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.plugin.framework import Status, StatusCode
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _throttle(name="t1", cpu="200m", grp="a", overrides=()):
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(requests={"cpu": cpu}),
            temporary_threshold_overrides=tuple(overrides),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(
                        pod_selector=LabelSelector(match_labels={"grp": grp})
                    ),
                )
            ),
        ),
    )


def _cluster_throttle(name="ct1", cpu="500m", grp="a"):
    return ClusterThrottle(
        name=name,
        spec=ClusterThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(requests={"cpu": cpu}),
            selector=ClusterThrottleSelector(
                selector_terms=(
                    ClusterThrottleSelectorTerm(
                        LabelSelector(match_labels={"grp": grp}),
                        LabelSelector(),
                    ),
                )
            ),
        ),
    )


def _plugin(store, policies=None):
    config = {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
    if policies is not None:
        config["policies"] = policies
    return KubeThrottler(
        decode_plugin_args(config), store, use_device=True, start_workers=False, device="cpu"
    )


# --------------------------------------------------------------------------
# cache data structure
# --------------------------------------------------------------------------


class TestVerdictCacheUnit:
    def test_hit_requires_epoch_match(self):
        c = VerdictCache(capacity=8)
        st = Status(StatusCode.SUCCESS)
        c.put(("k",), 3, st)
        assert c.get(("k",), 3) is st
        # a bumped epoch sum invalidates without any explicit eviction
        assert c.get(("k",), 4) is None
        hits, misses, *_ = c.stats()
        assert hits == 1 and misses >= 1

    def test_unknown_key_misses(self):
        c = VerdictCache(capacity=8)
        assert c.get(("nope",), 0) is None
        assert c.stats()[1] == 1

    def test_put_replaces_stale_entry(self):
        c = VerdictCache(capacity=8)
        old, new = Status(StatusCode.SUCCESS), Status(StatusCode.ERROR, ("x",))
        c.put(("k",), 1, old)
        c.put(("k",), 2, new)
        assert c.get(("k",), 2) is new
        assert c.get(("k",), 1) is None

    def test_rotation_bounds_size(self):
        c = VerdictCache(capacity=16)  # segments of 8
        st = Status(StatusCode.SUCCESS)
        for i in range(200):
            c.put((f"k{i}",), 0, st)
        assert len(c) <= 16

    def test_rotation_promotes_hot_entries(self):
        c = VerdictCache(capacity=8)  # segments of 4
        hot = Status(StatusCode.SUCCESS)
        c.put(("hot",), 0, hot)
        for i in range(4):  # rotate: "hot" falls into the old segment
            c.put((f"cold{i}",), 0, hot)
        assert c.get(("hot",), 0) is hot  # old-segment hit promotes
        for i in range(4, 8):  # rotate again: promoted entry survives
            c.put((f"cold{i}",), 0, hot)
        assert c.get(("hot",), 0) is hot

    def test_invalidate_all(self):
        c = VerdictCache(capacity=8)
        c.put(("k",), 0, Status(StatusCode.SUCCESS))
        c.invalidate_all()
        assert len(c) == 0
        assert c.get(("k",), 0) is None
        assert c.stats()[3] == 1  # invalidations


# --------------------------------------------------------------------------
# plugin hot path
# --------------------------------------------------------------------------


class TestPluginCacheHotPath:
    def _stack(self):
        store = Store()
        plugin = _plugin(store)
        store.create_namespace(Namespace("default"))
        store.create_throttle(_throttle())
        plugin.run_pending_once()
        return store, plugin

    def test_repeat_verdict_is_a_cache_hit(self):
        _, plugin = self._stack()
        assert plugin.verdict_cache is not None
        pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
        first = plugin.pre_filter(pod)
        hits0 = plugin.verdict_cache.stats()[0]
        second = plugin.pre_filter(pod)
        assert second is first  # the interned Status object itself
        assert plugin.verdict_cache.stats()[0] == hits0 + 1

    def test_same_shape_different_pod_shares_entry(self):
        _, plugin = self._stack()
        a = make_pod("a", labels={"grp": "a"}, requests={"cpu": "100m"})
        b = make_pod("b", labels={"grp": "a"}, requests={"cpu": "100m"})
        sa = plugin.pre_filter(a)
        hits0 = plugin.verdict_cache.stats()[0]
        sb = plugin.pre_filter(b)
        assert sb is sa
        assert plugin.verdict_cache.stats()[0] == hits0 + 1

    def test_unknown_namespace_is_uncacheable(self):
        _, plugin = self._stack()
        ghost = make_pod("g", namespace="ghost", requests={"cpu": "1m"})
        st1 = plugin.pre_filter(ghost)
        st2 = plugin.pre_filter(ghost)
        assert st1.code == StatusCode.ERROR and st2.code == StatusCode.ERROR
        # never entered the cache: the (shape, empty-cols) key would
        # collide with known-namespace pods that cached SUCCESS
        assert plugin.verdict_cache.stats()[0] == 0

    def test_exceeds_verdict_not_cached_and_reemits_event(self):
        from kube_throttler_tpu_torch.plugin import RecordingEventRecorder

        store = Store()
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            store,
            event_recorder=RecordingEventRecorder(),
            use_device=True,
            start_workers=False, device="cpu",
        )
        store.create_namespace(Namespace("default"))
        store.create_throttle(_throttle())
        plugin.run_pending_once()
        whale = make_pod("whale", labels={"grp": "a"}, requests={"cpu": "900m"})
        for _ in range(2):
            st = plugin.pre_filter(whale)
            assert any("exceeds-threshold" in r for r in st.reasons)
        # one Warning per CALL (the recorder aggregates identical events
        # into a count) — a cache hit would have swallowed the second
        assert sum(plugin.event_recorder.counts.values()) == 2

    def test_selector_edit_invalidates_memoized_cols(self):
        store, plugin = self._stack()
        pod = make_pod("p", labels={"grp": "b"}, requests={"cpu": "900m"})
        assert plugin.pre_filter(pod).code is StatusCode.SUCCESS  # matches nothing
        # the selector edit makes t1 match grp=b: the memoized cols for
        # the SAME pod object are now stale (index generation bumped)
        cur = store.get_throttle("default", "t1")
        store.update_throttle(
            Throttle(name="t1", spec=_throttle(grp="b").spec, status=cur.status)
        )
        plugin.run_pending_once()
        st = plugin.pre_filter(pod)
        assert st.code is not StatusCode.SUCCESS, st.reasons
        assert norm(st.reasons) == norm(plugin._pre_filter_uncached(pod).reasons)

    def test_policy_swap_drops_cache(self):
        _, plugin = self._stack()
        pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
        plugin.pre_filter(pod)
        assert len(plugin.verdict_cache) > 0
        plugin.set_policy_specs(
            [{"name": "swap", "preemptionEnabled": True, "minPriorityGap": 1}]
        )
        assert len(plugin.verdict_cache) == 0


# --------------------------------------------------------------------------
# intra-batch dedupe
# --------------------------------------------------------------------------


class TestBatchDedupe:
    def test_batch_agrees_with_uncached_on_degenerate_mix(self):
        def build():
            store = Store()
            plugin = _plugin(store)
            store.create_namespace(Namespace("default"))
            store.create_throttle(_throttle(cpu="450m"))
            store.create_throttle(_throttle("t2", cpu="300m", grp="b"))
            store.create_cluster_throttle(_cluster_throttle())
            for i in range(40):  # one degenerate group: identical shape
                store.create_pod(
                    make_pod(
                        f"same{i}", labels={"grp": "a"},
                        requests={"cpu": "10m"}, node_name="n1", phase="Running",
                    )
                )
            for i in range(6):  # distinct shapes and groups
                store.create_pod(
                    make_pod(
                        f"diff{i}", labels={"grp": "ab"[i % 2]},
                        requests={"cpu": f"{(i + 1) * 50}m"},
                    )
                )
            store.create_pod(make_pod("lost", namespace="ghost"))
            plugin.run_pending_once()
            return plugin

        cached, uncached = build(), build()
        uncached.verdict_cache = None
        out_c = cached.pre_filter_batch()
        out_u = uncached.pre_filter_batch()
        assert out_c == out_u
        # the dedupe actually engaged: 46 known-ns pods collapsed into a
        # handful of (shape, cols) groups, one evaluation each
        hits1, misses1, *_ = cached.verdict_cache.stats()
        assert misses1 <= 15, f"dedupe evaluated {misses1} groups for 46 pods"
        # a second batch over unchanged state serves the groups from cache
        assert cached.pre_filter_batch() == out_u
        hits2, misses2, *_ = cached.verdict_cache.stats()
        assert hits2 > hits1, "warm batch never hit the cache"
        assert misses2 == misses1

    def test_batch_dedupe_declines_on_diverse_population(self):
        store = Store()
        plugin = _plugin(store)
        store.create_namespace(Namespace("default"))
        store.create_throttle(_throttle(cpu="10000m"))
        for i in range(300):  # every pod a distinct shape → groups*2 > pods
            store.create_pod(
                make_pod(f"p{i}", labels={"grp": "a"}, requests={"cpu": f"{i + 1}m"})
            )
        plugin.run_pending_once()
        out = plugin.pre_filter_batch()
        assert len(out["schedulable"]) == 300
        ref = plugin.verdict_cache
        plugin.verdict_cache = None
        assert plugin.pre_filter_batch() == out
        plugin.verdict_cache = ref


# --------------------------------------------------------------------------
# epoch-bump completeness: mutation sweep, cache ≡ recompute
# --------------------------------------------------------------------------


class TestEpochBumpCompleteness:
    @pytest.mark.parametrize("seed", [7, 19, 31])
    def test_mutation_sweep_cache_equals_recompute(self, seed):
        """Every mutation class that can change a verdict, in a seeded
        mix; after each one the cached path must agree with the uncached
        recompute for a probe population spanning matched/unmatched
        shapes. A missing epoch bump anywhere = a stale verdict here."""
        rng = random.Random(seed)
        store = Store()
        plugin = _plugin(
            store,
            policies=[{"name": "p0", "preemptionEnabled": True, "minPriorityGap": 1}],
        )
        assert plugin.verdict_cache is not None
        store.create_namespace(Namespace("default"))

        probes = [
            make_pod(
                f"probe{i}",
                labels={"grp": "ab"[i % 2]},
                requests={"cpu": f"{(i % 5 + 1)}00m"},
            )
            for i in range(6)
        ]
        reserved: list = []
        gangs: list = []

        def check():
            plugin.run_pending_once()  # status flips land (epoch-covered)
            for pod in probes:
                fresh = plugin._pre_filter_uncached(pod)
                for _ in range(2):  # miss-then-hit: both must match fresh
                    got = plugin.pre_filter(pod)
                    assert got.code == fresh.code, (pod.key, got.reasons, fresh.reasons)
                    assert norm(got.reasons) == norm(fresh.reasons), pod.key

        def op_throttle_edit():
            name = f"t{rng.randint(0, 3)}"
            thr = _throttle(name, cpu=f"{rng.randint(1, 6)}00m", grp=rng.choice("ab"))
            try:
                store.create_throttle(thr)
            except ValueError:
                cur = store.get_throttle("default", name)
                store.update_throttle(
                    Throttle(name=name, spec=thr.spec, status=cur.status)
                )

        def op_clusterthrottle_edit():
            name = f"ct{rng.randint(0, 1)}"
            ct = _cluster_throttle(
                name, cpu=f"{rng.randint(2, 8)}00m", grp=rng.choice("ab")
            )
            try:
                store.create_cluster_throttle(ct)
            except ValueError:
                cur = store.get_cluster_throttle(name)
                store.update_cluster_throttle(
                    ClusterThrottle(name=name, spec=ct.spec, status=cur.status)
                )

        def op_override_window():
            # an override that is active NOW halves (or floods) the
            # threshold; it reaches verdicts via the status write the
            # next reconcile stamps — which must bump the epoch
            cpu = rng.choice(["50m", "900m"])
            thr = _throttle(
                "t0",
                cpu="300m",
                grp="a",
                overrides=(
                    TemporaryThresholdOverride(
                        begin="2000-01-01T00:00:00Z",
                        end="2100-01-01T00:00:00Z",
                        threshold=ResourceAmount.of(requests={"cpu": cpu}),
                    ),
                ),
            )
            try:
                store.create_throttle(thr)
            except ValueError:
                cur = store.get_throttle("default", "t0")
                store.update_throttle(
                    Throttle(name="t0", spec=thr.spec, status=cur.status)
                )

        def op_pod_churn():
            if rng.random() < 0.6 or not store.list_pods("default"):
                store.create_pod(
                    make_pod(
                        f"w{rng.randrange(10**6)}",
                        labels={"grp": rng.choice("ab")},
                        requests={"cpu": f"{rng.randint(1, 4)}00m"},
                        node_name="n1",
                        phase="Running",
                    )
                )
            else:
                doomed = rng.choice(store.list_pods("default"))
                store.delete_pod("default", doomed.name)

        def op_reserve():
            pod = make_pod(
                f"r{rng.randrange(10**6)}",
                labels={"grp": rng.choice("ab")},
                requests={"cpu": f"{rng.randint(1, 3)}00m"},
            )
            if plugin.reserve(pod).is_success():
                reserved.append(pod)

        def op_unreserve():
            if reserved:
                plugin.unreserve(reserved.pop(rng.randrange(len(reserved))))

        def op_gang_reserve():
            gid = f"default/g{rng.randrange(10**6)}"
            members = [
                make_pod(
                    f"gm{rng.randrange(10**6)}",
                    labels={"grp": rng.choice("ab")},
                    requests={"cpu": "50m"},
                )
                for _ in range(2)
            ]
            if plugin.reserve_gang(gid, members).is_success():
                gangs.append(gid)

        def op_gang_rollback():
            if gangs:
                plugin.unreserve_gang(gangs.pop(rng.randrange(len(gangs))))

        def op_policy_swap():
            plugin.set_policy_specs(
                [
                    {
                        "name": f"p{rng.randrange(10**6)}",
                        "preemptionEnabled": bool(rng.getrandbits(1)),
                        "minPriorityGap": rng.randint(1, 3),
                    }
                ]
            )

        def op_preempt_cycle():
            members = [
                make_pod(
                    f"hi{rng.randrange(10**6)}",
                    labels={"grp": "a"},
                    requests={"cpu": "100m"},
                    priority=5,
                )
            ]
            # commit or infeasible-rollback — either way any evictions
            # land as pod deletes whose epoch bumps the probes see
            plugin.maybe_preempt_gang(f"default/pg{rng.randrange(10**6)}", members)

        def op_namespace_churn():
            if store.get_namespace("burst") is None:
                store.create_namespace(Namespace("burst"))
            else:
                store.delete_namespace("burst")

        ops = [
            op_throttle_edit,
            op_clusterthrottle_edit,
            op_override_window,
            op_pod_churn,
            op_pod_churn,
            op_reserve,
            op_unreserve,
            op_gang_reserve,
            op_gang_rollback,
            op_policy_swap,
            op_preempt_cycle,
            op_namespace_churn,
        ]
        for _ in range(40):
            rng.choice(ops)()
            check()


# The front-tier cache (scatter path), the reference's TestFrontCache, is
# tests/test_torch_front_cache.py.
