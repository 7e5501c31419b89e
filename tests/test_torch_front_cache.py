"""The admission front's interned-verdict cache over the port's shard
cores: a copy of the reference's ``TestFrontCache``
(``tests/test_verdictcache.py``) with the port's imports. After every
mutation in a seeded churn the front's cached ``pre_filter`` must equal
the uncached scatter recompute, and status pushes and the structural
operations (reshard, resync, attach) must bump the front's epochs.
"""

from __future__ import annotations

import random

from conftest import normalize_reasons as norm
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.plugin.framework import StatusCode
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




class TestFrontCache:
    def _build(self, n_shards=3):
        from kube_throttler_tpu_torch.sharding.front import AdmissionFront
        from kube_throttler_tpu_torch.sharding.ipc import LocalShard
        from kube_throttler_tpu_torch.sharding.worker import ShardCore

        front = AdmissionFront(n_shards)
        cores = [ShardCore(i, n_shards, use_device=False) for i in range(n_shards)]
        for i, core in enumerate(cores):
            front.attach_shard(
                i, LocalShard(i, core, on_push=front.apply_status_push)
            )
        front.store.create_namespace(Namespace("default"))
        return front, cores

    @staticmethod
    def _teardown(front, cores):
        for core in cores:
            core.stop()
        front.stop()

    @staticmethod
    def _settle(front):
        assert front.drain(timeout=30.0)
        import time

        time.sleep(0.3)  # shard push loops flush on their own cadence

    @staticmethod
    def _fresh(front, pod):
        cache, front.verdict_cache = front.verdict_cache, None
        try:
            return front.pre_filter(pod)
        finally:
            front.verdict_cache = cache

    def test_scatter_cache_equals_recompute_under_churn(self):
        rng = random.Random(13)
        front, cores = self._build()
        try:
            assert front.verdict_cache is not None
            probes = [
                make_pod(
                    f"probe{i}",
                    labels={"grp": "ab"[i % 2]},
                    requests={"cpu": f"{(i % 4 + 1)}00m"},
                )
                for i in range(4)
            ]

            def check():
                self._settle(front)
                for pod in probes:
                    fresh = self._fresh(front, pod)
                    for _ in range(2):
                        got = front.pre_filter(pod)
                        assert got.code == fresh.code, (pod.key, got.reasons)
                        assert norm(got.reasons) == norm(fresh.reasons), pod.key

            for step in range(12):
                r = rng.random()
                if r < 0.4:
                    name = f"t{rng.randint(0, 4)}"
                    thr = _throttle(
                        name, cpu=f"{rng.randint(1, 5)}00m", grp=rng.choice("ab")
                    )
                    try:
                        front.store.create_throttle(thr)
                    except ValueError:
                        cur = front.store.get_throttle("default", name)
                        front.store.update_throttle(
                            Throttle(name=name, spec=thr.spec, status=cur.status)
                        )
                elif r < 0.7:
                    front.store.create_pod(
                        make_pod(
                            f"w{step}",
                            labels={"grp": rng.choice("ab")},
                            requests={"cpu": f"{rng.randint(1, 3)}00m"},
                            node_name="n1",
                            phase="Running",
                        )
                    )
                else:
                    front.reserve(
                        make_pod(
                            f"r{step}",
                            labels={"grp": rng.choice("ab")},
                            requests={"cpu": "100m"},
                        )
                    )
                check()
            # the cache is actually in play on this path
            assert front.verdict_cache.stats()[0] > 0
        finally:
            self._teardown(front, cores)

    def test_status_push_bumps_front_epoch(self):
        """A shard's status push (flip) must invalidate without any spec
        route: cache a verdict, flip the throttle via shard-side state,
        and pin that the pushed status re-derives the verdict."""
        front, cores = self._build(n_shards=1)
        try:
            front.store.create_throttle(_throttle(cpu="200m"))
            self._settle(front)
            pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
            assert front.pre_filter(pod).code is StatusCode.SUCCESS
            # saturate the throttle: the shard reconciles, pushes the
            # flipped status back, and the Router's echo path must bump
            front.store.create_pod(
                make_pod(
                    "hog", labels={"grp": "a"}, requests={"cpu": "200m"},
                    node_name="n1", phase="Running",
                )
            )
            self._settle(front)
            st = front.pre_filter(pod)
            fresh = self._fresh(front, pod)
            assert st.code == fresh.code and st.code is not StatusCode.SUCCESS
        finally:
            self._teardown(front, cores)

    def test_structural_ops_bump_global_epoch(self):
        """Reshard cutover, finish/cancel, resync, and attach all change
        what a cached verdict means without touching per-key epochs —
        each must move the global counter (= fingerprint sum)."""
        from kube_throttler_tpu_torch.sharding.ring import HashRing, RangeMove

        front, cores = self._build(n_shards=2)
        try:
            front.store.create_throttle(_throttle())
            self._settle(front)
            pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})

            def esum():
                fp = front._verdict_fingerprint(pod)
                assert fp is not None
                return fp[1]

            e0 = esum()
            move = RangeMove(index=0, lo=0, hi=1, src=0, dst=1)
            front.cutover_range(move)
            e1 = esum()
            assert e1 > e0
            front.finish_reshard(HashRing(2), 2)
            e2 = esum()
            assert e2 > e1
            front.cancel_reshard()
            e3 = esum()
            assert e3 > e2
            front.resync_shard(0)
            e4 = esum()
            assert e4 > e3
            front.attach_shard(0, front.shards[0])
            assert esum() > e4
        finally:
            self._teardown(front, cores)
