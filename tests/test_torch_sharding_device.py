"""The sharded fleet's device route, on the CPU: the port's shard cores
(``ShardCore(..., device="cpu")``) behind an ``AdmissionFront`` answer as
the JAX package's shard cores with ``use_device=True`` do, and as the
port's single process (``KubeThrottler(device="cpu")``) does.

The reference's own sharding tests build every shard host-only
(``use_device=False``), so they never reach a shard's device route. Here
each fleet is built over ``LocalShard`` cores at 2 and 3 shards, seeds 0-2,
on one seeded cluster (numpy plan; Throttles from the harness fixtures,
enough of them that a shard's Throttle kind takes the sparse gather route,
and ClusterThrottles that take the dense one). Pods match one shard,
several shards (a Throttle group and a ClusterThrottle owned elsewhere), or
nothing. The three must agree on every ``pre_filter_batch`` verdict, every
``pre_filter`` code and reason string (stored pods and unstored probes), a
two-phase reserve followed by ``pre_filter``, and a gang check routed by
group id; again after a churn of pod updates, and again after one worker is
replaced by a fresh core and resynced. Each port shard's batch must have
taken the device route (``last_batch_routes``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

import tools.harness as JH
import tools.harness_torch as H
from kube_throttler_tpu.api import pod as j_pod
from kube_throttler_tpu.api import types as j_types
from kube_throttler_tpu.sharding.front import AdmissionFront as JFront
from kube_throttler_tpu.sharding.ipc import LocalShard as JLocalShard
from kube_throttler_tpu.sharding.worker import ShardCore as JShardCore
from kube_throttler_tpu_torch.api import pod as t_pod
from kube_throttler_tpu_torch.api import types as t_types
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.sharding.front import AdmissionFront
from kube_throttler_tpu_torch.sharding.ipc import LocalShard
from kube_throttler_tpu_torch.sharding.worker import ShardCore
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

N_THROTTLES = 64  # one per label group; > 16 a shard puts its kind on the sparse route
HOT_GROUPS = 6  # most pods land in the tight low-numbered groups
N_PODS = 120
GANG = "default/job1"


@dataclasses.dataclass(frozen=True)
class Pkg:
    """One package's constructors, so one plan builds both packages' objects."""

    pod: object
    types: object
    harness: object


JAX = Pkg(j_pod, j_types, JH)
PORT = Pkg(t_pod, t_types, H)


def plan(seed: int) -> dict:
    """The cluster as plain numbers from a numpy generator. The
    ClusterThrottles' thresholds are set from the bound pods they select,
    so that each outcome occurs: ``cm0`` leaves less cpu than most pods
    ask (insufficient), ``cm1`` is one pod below its count (active),
    ``cm2`` is roomy, ``cwide`` (tier=hot) is near its cpu sum; ``m3``
    pods match no ``cm``."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(N_PODS):
        r = rng.random()
        if r < 0.08:
            group = -1  # matches no Throttle (and no ClusterThrottle unless hot)
        elif r < 0.35:
            group = int(rng.integers(0, HOT_GROUPS))
        else:
            group = int(rng.integers(0, N_THROTTLES))
        pods.append({
            "name": f"p{i}",
            "group": group,
            "hot": bool(rng.random() < 0.35),
            "mod": int(rng.integers(0, 4)),
            "cpu": int(rng.integers(1, 9)) * 250,
            "bound": bool(rng.random() < 0.8),
        })
    bound = [p for p in pods if p["bound"]]
    cpu_of = lambda sel: sum(p["cpu"] for p in bound if sel(p))  # noqa: E731
    count_of = lambda sel: sum(1 for p in bound if sel(p))  # noqa: E731
    return {
        "pods": pods,
        "cwide_cpu": cpu_of(lambda p: p["hot"]) + int(rng.integers(0, 6)) * 250,
        "cmod": [
            (10**6, cpu_of(lambda p: p["mod"] == 0) + int(rng.integers(1, 4)) * 250),
            (max(count_of(lambda p: p["mod"] == 1) - 1, 1), 10**7),
            (10**6, 10**7),
        ],
        "churn": [(int(rng.integers(0, N_PODS)), int(rng.integers(1, 9)) * 250)
                  for _ in range(30)],
    }


def make_pod(pkg: Pkg, p: dict, cpu=None, **extra):
    labels = {"grp": f"g{p['group']}" if p["group"] >= 0 else "zz", "mod": f"m{p['mod']}"}
    if p["hot"]:
        labels["tier"] = "hot"
    return pkg.pod.make_pod(
        p["name"], labels=labels, requests={"cpu": f"{cpu or p['cpu']}m"},
        node_name="node-1" if p["bound"] else "",
        phase="Running" if p["bound"] else "Pending", **extra,
    )


def cluster_throttle(pkg: Pkg, name: str, labels: dict, pods: int, cpu: int):
    t = pkg.types
    return t.ClusterThrottle(
        name=name,
        spec=t.ClusterThrottleSpec(
            throttler_name="kube-throttler",
            threshold=t.ResourceAmount.of(pod=pods, requests={"cpu": f"{cpu}m"}),
            selector=t.ClusterThrottleSelector(selector_terms=(
                t.ClusterThrottleSelectorTerm(
                    t.LabelSelector(match_labels=dict(labels)), t.LabelSelector()),
            )),
        ),
    )


def populate(pkg: Pkg, store, pl: dict) -> None:
    store.create_namespace(pkg.pod.Namespace("default"))
    for i in range(N_THROTTLES):
        store.create_throttle(pkg.harness.make_throttle(i))
    store.create_cluster_throttle(
        cluster_throttle(pkg, "cwide", {"tier": "hot"}, 10**6, pl["cwide_cpu"]))
    for m, (pods, cpu) in enumerate(pl["cmod"]):
        store.create_cluster_throttle(cluster_throttle(pkg, f"cm{m}", {"mod": f"m{m}"}, pods, cpu))
    for p in pl["pods"]:
        store.create_pod(make_pod(pkg, p))


def probes(pkg: Pkg) -> list:
    """Unstored pods, as a scheduler asks about them."""
    spec = [("probe-multi", 1, True, 0, 500), ("probe-hot-none", -1, True, 1, 250),
            ("probe-none", -1, False, 2, 250), ("probe-tight", 0, False, 0, 2000)]
    return [make_pod(pkg, {"name": n, "group": g, "hot": h, "mod": m, "cpu": c,
                           "bound": False}) for n, g, h, m, c in spec]


def members(pkg: Pkg, cpu: int) -> list:
    p = {"group": 20, "hot": False, "mod": 2, "cpu": cpu, "bound": False}
    return [make_pod(pkg, dict(p, name=f"gm{i}"), group="job1", group_size=3)
            for i in range(3)]


def flat_reasons(reasons) -> list:
    """Each (reason, throttle name) pair once, sorted."""
    return sorted({(head, name) for r in reasons
                   for head, _, names in [r.partition("=")] for name in names.split(",")})


class Fleet:
    """A front over ``n`` LocalShard cores of one package."""

    def __init__(self, front_cls, core_fn, shard_cls, n: int):
        self.front = front_cls(n)
        self.core_fn, self.shard_cls = core_fn, shard_cls
        self.cores = {}
        for sid in range(n):
            self.attach(sid, resync=False)

    def attach(self, sid: int, resync: bool) -> None:
        core = self.core_fn(sid, self.front.n_shards)
        self.cores.setdefault(sid, []).append(core)
        self.front.attach_shard(
            sid, self.shard_cls(sid, core, on_push=self.front.apply_status_push),
            resync=resync)

    def live(self, sid: int):
        return self.cores[sid][-1]

    def settle(self) -> None:
        assert self.front.drain(timeout=30.0)
        time.sleep(0.3)  # status pushes flush on their own cadence

    def stop(self) -> None:
        for cores in self.cores.values():
            for core in cores:
                core.stop()
        self.front.stop()


class Stacks:
    """The JAX fleet, the port's fleet and the port's single process over
    one plan; ``do(fn)`` applies ``fn(pkg, store)`` to all three stores."""

    def __init__(self, n_shards: int, seed: int):
        self.plan = plan(seed)
        self.jax = Fleet(JFront, lambda i, n: JShardCore(i, n, use_device=True), JLocalShard,
                         n_shards)
        self.port = Fleet(AdmissionFront, lambda i, n: ShardCore(i, n, device="cpu"),
                          LocalShard, n_shards)
        self.single_store = Store()
        self.single = H.build_plugin(self.single_store)
        self.do(lambda pkg, store: populate(pkg, store, self.plan))

    def do(self, fn) -> None:
        fn(JAX, self.jax.front.store)
        fn(PORT, self.port.front.store)
        fn(PORT, self.single_store)
        self.settle()

    def settle(self) -> None:
        self.jax.settle()
        self.port.settle()
        self.single.run_pending_once()

    def stop(self) -> None:
        self.jax.stop()
        self.port.stop()
        self.single.stop()

    def assert_batch_equal(self) -> None:
        j = self.jax.front.pre_filter_batch()
        t = self.port.front.pre_filter_batch()
        s = self.single.pre_filter_batch()
        assert len(t["schedulable"]) + len(t["errors"]) == N_PODS
        assert t["schedulable"] == j["schedulable"] == s["schedulable"]
        assert sorted(t["errors"]) == sorted(j["errors"]) == sorted(s["errors"])
        # every port shard classified its pods on the device route; over
        # the fleet the Throttle kind took the gather route somewhere and
        # the ClusterThrottle kind the dense one
        routes = [self.port.live(sid).plugin.device_manager.last_batch_routes
                  for sid in range(self.port.front.n_shards)]
        assert all(set(r) == {"throttle", "clusterthrottle"} for r in routes), routes
        assert "sparse" in {r["throttle"] for r in routes}, routes
        assert "dense" in {r["clusterthrottle"] for r in routes}, routes

    def statuses(self, pods_by_pkg) -> None:
        """``pre_filter`` of each pod: code and reason strings. The two
        fleets agree string for string; the single process lists the same
        reasons, each with the same throttle names."""
        for jp, tp in zip(*pods_by_pkg):
            j, t = self.jax.front.pre_filter(jp), self.port.front.pre_filter(tp)
            s = self.single.pre_filter(tp)
            assert (t.code.value, t.reasons) == (j.code.value, j.reasons), tp.key
            assert t.code == s.code, (tp.key, t.reasons, s.reasons)
            assert H.normalized_reasons(t.reasons) == H.normalized_reasons(s.reasons), tp.key

    def assert_all_equal(self) -> None:
        self.assert_batch_equal()
        stored = [make_pod(pkg, p) for pkg in (JAX, PORT) for p in self.plan["pods"]]
        self.statuses((stored[:N_PODS] + probes(JAX), stored[N_PODS:] + probes(PORT)))

    def assert_reserve_equal(self) -> None:
        """Two-phase reserve of a tight group's pending pod on the fleets,
        a local reserve on the single process, then every answer again."""
        held = {"name": "held", "group": 30, "hot": False, "mod": 0, "cpu": 2000,
                "bound": False}
        jp, tp = make_pod(JAX, held), make_pod(PORT, held)
        before = self.port.front.pre_filter_batch()["schedulable"]
        j, t, s = self.jax.front.reserve(jp), self.port.front.reserve(tp), self.single.reserve(tp)
        assert t.is_success() == j.is_success() == s.is_success(), (t.reasons, s.reasons)
        assert t.is_success()
        # the reservation fills cm0: its pods' verdicts turn
        assert self.port.front.pre_filter_batch()["schedulable"] != before
        self.assert_all_equal()
        self.jax.front.unreserve(jp)
        self.port.front.unreserve(tp)
        self.single.unreserve(tp)
        self.assert_all_equal()

    def assert_gang_equal(self) -> None:
        for cpu in (100, 2500, 9000):
            j = self.jax.front.pre_filter_gang(GANG, members(JAX, cpu))
            t = self.port.front.pre_filter_gang(GANG, members(PORT, cpu))
            s = self.single.pre_filter_gang(GANG, members(PORT, cpu))
            assert t.code == s.code and t.code.value == j.code.value, (cpu, t.reasons, s.reasons)
            assert t.reasons == j.reasons, cpu
            # the front reports each shard's names in its own reason string
            assert flat_reasons(t.reasons) == flat_reasons(s.reasons), cpu


@pytest.fixture
def no_verdict_cache(monkeypatch):
    # the verdict cache's batch dedupe would classify these small, repetitive
    # clusters on the host; the device route is what is compared here
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_device_route_equals_jax_shards_and_single_process(
        n_shards, seed, no_verdict_cache):
    stacks = Stacks(n_shards, seed)
    try:
        stacks.assert_all_equal()
        stacks.assert_reserve_equal()
        stacks.assert_gang_equal()

        by_name = {p["name"]: p for p in stacks.plan["pods"]}

        def churn(pkg, store):
            for i, cpu in stacks.plan["churn"]:
                store.update_pod(make_pod(pkg, by_name[f"p{i}"], cpu=cpu))

        stacks.do(churn)
        for i, cpu in stacks.plan["churn"]:
            by_name[f"p{i}"]["cpu"] = cpu
        stacks.assert_all_equal()

        # a worker replaced by a fresh core, resynced from the front's store
        victim = stacks.port.front.owner_of("Throttle", "default/t0")
        for fleet in (stacks.jax, stacks.port):
            fleet.front.shards[victim].close()
            fleet.attach(victim, resync=True)
        stacks.settle()
        stacks.assert_all_equal()
        stacks.assert_gang_equal()
    finally:
        stacks.stop()


def test_port_shard_core_needs_a_device_unless_host_only():
    """``ShardCore`` follows the port's device convention: ``device=None``
    means CUDA, so without a card it refuses to build; ``device="cpu"``
    runs the device mirror on the CPU; host-only needs no device."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardCore(0, 1)
    core = ShardCore(0, 1, device="cpu")
    host = ShardCore(0, 1, use_device=False)
    try:
        stats = core.rpc("stats", None)[1]
        assert stats["device"] == "cpu"
        assert set(stats["kernel_launches"]) == {
            "check_dense", "check_gather", "pack_gather_rows", "victim_select"}
        assert host.rpc("stats", None)[1]["device"] is None
    finally:
        core.stop()
        host.stop()
