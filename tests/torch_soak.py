"""The differential soak's random churn, in one module that imports neither
JAX nor pytest's conftest: ``tests/test_torch_differential_soak.py`` runs it
with both stacks on the CPU, and the chip smoke's ``[soak]`` phase (which
puts this directory on ``sys.path``) runs it with the device stack on the
card.

Two full stacks — device-kernel-served and host-oracle — consume an
identical random event stream; every pod's PreFilter verdict and every
throttle's reconciled status must agree at every checkpoint.

The churn builds its objects and stacks from a *kit* (``PORT_KIT`` by
default): a namespace of the API classes, the store's ``NotFoundError``
and a ``stack(use_device)`` factory. It returns the run's trace as plain
data, so a test can hand in another package's kit, run one stack of it
through the same seed and hold the two traces equal.
"""

from __future__ import annotations

import random
from dataclasses import replace
from types import SimpleNamespace
from datetime import datetime, timedelta, timezone

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    LabelSelector,
    LabelSelectorRequirement,
    ResourceAmount,
    TemporaryThresholdOverride,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.engine.store import NotFoundError, Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.utils.clock import FakeClock

NOW = datetime(2024, 3, 1, 12, 0, 0, tzinfo=timezone.utc)


def _rfc(dt):
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


def _stack(use_device: bool, device="cpu"):
    store = Store()
    clock = FakeClock(NOW)
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store,
        clock=clock,
        use_device=use_device, device=device,
    )
    return store, plugin, clock


#: the port's kit: its API classes, its store's NotFoundError and its stacks
PORT_KIT = SimpleNamespace(
    Namespace=Namespace, make_pod=make_pod, ClusterThrottle=ClusterThrottle,
    ClusterThrottleSelector=ClusterThrottleSelector,
    ClusterThrottleSelectorTerm=ClusterThrottleSelectorTerm,
    ClusterThrottleSpec=ClusterThrottleSpec, LabelSelector=LabelSelector,
    LabelSelectorRequirement=LabelSelectorRequirement, ResourceAmount=ResourceAmount,
    TemporaryThresholdOverride=TemporaryThresholdOverride, Throttle=Throttle,
    ThrottleSelector=ThrottleSelector, ThrottleSelectorTerm=ThrottleSelectorTerm,
    ThrottleSpec=ThrottleSpec, NotFoundError=NotFoundError, stack=_stack,
)


def _rand_expression(rng, kit=None):
    kit = kit or PORT_KIT
    op = rng.choice(["In", "NotIn", "Exists", "DoesNotExist"])
    return kit.LabelSelectorRequirement(
        key=rng.choice("abc"),
        operator=op,
        values=(rng.choice("xyz"),) if op in ("In", "NotIn") else (),
    )


def _rand_selector(rng, cluster: bool, kit=None):
    kit = kit or PORT_KIT
    terms = []
    for _ in range(rng.randint(0, 2)):
        pod_sel = kit.LabelSelector(
            match_labels={rng.choice("abc"): rng.choice("xyz") for _ in range(rng.randint(0, 2))},
            match_expressions=(
                (_rand_expression(rng, kit),) if rng.random() < 0.3 else ()
            ),
        )
        if cluster:
            terms.append(
                kit.ClusterThrottleSelectorTerm(
                    pod_selector=pod_sel,
                    namespace_selector=kit.LabelSelector(
                        match_labels={"env": rng.choice("pq")} if rng.random() < 0.4 else {}
                    ),
                )
            )
        else:
            terms.append(kit.ThrottleSelectorTerm(pod_selector=pod_sel))
    if cluster:
        return kit.ClusterThrottleSelector(selector_terms=tuple(terms))
    return kit.ThrottleSelector(selector_terms=tuple(terms))


def _rand_threshold(rng, kit=None):
    kit = kit or PORT_KIT
    reqs = {}
    if rng.random() < 0.8:
        reqs["cpu"] = f"{rng.randint(1, 9)}00m"
    if rng.random() < 0.5:
        reqs["memory"] = f"{rng.randint(1, 8)}Gi"
    return kit.ResourceAmount.of(
        pod=rng.randint(1, 4) if rng.random() < 0.6 else None, requests=reqs or None
    )


def _rand_overrides(rng, kit=None):
    kit = kit or PORT_KIT
    out = []
    for _ in range(rng.randint(0, 2)):
        active = rng.random() < 0.5
        begin = NOW - timedelta(hours=1) if active else NOW + timedelta(hours=1)
        out.append(
            kit.TemporaryThresholdOverride(
                begin=_rfc(begin),
                end=_rfc(begin + timedelta(hours=2)),
                threshold=_rand_threshold(rng, kit),
            )
        )
    return tuple(out)


def _normalize_reasons(reasons):
    """Order-insensitive form of PreFilter reason strings (the conftest's
    ``normalize_reasons``): throttle-name order within one reason is not
    part of the contract."""
    out = []
    for r in reasons:
        head, _, names = r.partition("=")
        out.append(f"{head}={','.join(sorted(names.split(',')))}")
    return sorted(out)


def _status_dict(thr):
    return {
        "used": thr.status.used.to_dict(),
        "throttled": thr.status.throttled.to_dict(),
        "threshold": thr.status.calculated_threshold.threshold.to_dict(),
    }


#: the copy's seeds; seed 20 found the reservation-outlives-throttle-recreation
#: divergence (device under-counted reserved after delete+recreate)
PINNED_SEEDS = (1, 2, 3, 20)


def _verdict(status):
    return getattr(status.code, "name", str(status.code)), _normalize_reasons(status.reasons)


def churn(seed: int, stacks=None, batch: bool = False, kit=None) -> list:
    """The soak of ``seed``: 120 random steps, a checkpoint after every
    12th and one at the end, over ``stacks`` (each ``(store, plugin,
    clock)`` of ``kit``; by default a device stack and a host stack of the
    port, both on the CPU). Every stack is held equal to the last one at
    every reserve and checkpoint; with ``batch``, each checkpoint also
    holds the first stack's ``pre_filter_batch`` equal to the last one's.
    A divergence fails an assertion. Returns the last stack's trace as
    plain data: each reserve's ``("reserve", pod, code)`` and each
    checkpoint's ``("checkpoint", verdicts, throttles, cluster throttles)``
    (each pod's code and normalised reasons, each status's dicts)."""
    kit = kit or PORT_KIT
    rng = random.Random(seed)
    stacks = list(stacks or (kit.stack(True), kit.stack(False)))
    stores = [st for st, _, _ in stacks]
    plugins = [pl for _, pl, _ in stacks]
    host_store, host = stores[-1], plugins[-1]
    trace: list = []

    namespaces = ["default", "ns1", "ns2"]
    pods: list = []

    def both(fn):
        for s in stores:
            fn(s)

    # two namespaces known from the start; ns2 arrives (or not) mid-stream
    for ns in namespaces[:2]:
        labels = {"env": rng.choice("pq")}
        both(lambda s, ns=ns, labels=labels: s.create_namespace(kit.Namespace(ns, labels=dict(labels))))

    def checkpoint():
        for p in plugins:
            p.run_pending_once()
        # every pod's PreFilter verdict agrees
        verdicts = []
        for pod in pods:
            sh = host.pre_filter(pod)
            for p in plugins[:-1]:
                sd = p.pre_filter(pod)
                assert sd.code == sh.code, (pod.key, sd.reasons, sh.reasons)
                assert _normalize_reasons(sd.reasons) == _normalize_reasons(sh.reasons), pod.key
            verdicts.append((pod.key,) + _verdict(sh))
        # every throttle's reconciled status agrees
        throttles = []
        for thr_h in host_store.list_throttles():
            for s in stores[:-1]:
                thr_d = s.get_throttle(thr_h.namespace, thr_h.name)
                assert _status_dict(thr_d) == _status_dict(thr_h), thr_h.key
            throttles.append((thr_h.key, _status_dict(thr_h)))
        assert all(len(s.list_throttles()) == len(throttles) for s in stores)
        cluster = []
        for ct_h in host_store.list_cluster_throttles():
            for s in stores[:-1]:
                ct_d = s.get_cluster_throttle(ct_h.name)
                assert _status_dict(ct_d) == _status_dict(ct_h), ct_h.key
            cluster.append((ct_h.key, _status_dict(ct_h)))
        assert all(len(s.list_cluster_throttles()) == len(cluster) for s in stores)
        trace.append(("checkpoint", verdicts, sorted(throttles), sorted(cluster)))
        if batch:
            # every pod's verdict in one batch: on a device stack, the kernels
            bd, bh = plugins[0].pre_filter_batch(), host.pre_filter_batch()
            assert bd["schedulable"] == bh["schedulable"], (
                sorted(k for k in bh["schedulable"]
                       if bd["schedulable"].get(k) != bh["schedulable"][k]))
            assert sorted(bd["errors"]) == sorted(bh["errors"])

    for step in range(120):
        op = rng.random()
        if op < 0.25:  # (re)apply a Throttle
            name, ns = f"t{rng.randint(0, 6)}", rng.choice(namespaces)
            thr = kit.Throttle(
                name=name,
                namespace=ns,
                spec=kit.ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=_rand_threshold(rng, kit),
                    temporary_threshold_overrides=_rand_overrides(rng, kit),
                    selector=_rand_selector(rng, cluster=False, kit=kit),
                ),
            )

            def apply_thr(s, thr=thr):
                try:
                    s.create_throttle(thr)
                except ValueError:
                    cur = s.get_throttle(thr.namespace, thr.name)
                    s.update_throttle(replace(thr, status=cur.status))

            both(apply_thr)
        elif op < 0.4:  # (re)apply a ClusterThrottle
            ct = kit.ClusterThrottle(
                name=f"ct{rng.randint(0, 4)}",
                spec=kit.ClusterThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=_rand_threshold(rng, kit),
                    temporary_threshold_overrides=_rand_overrides(rng, kit),
                    selector=_rand_selector(rng, cluster=True, kit=kit),
                ),
            )

            def apply_ct(s, ct=ct):
                try:
                    s.create_cluster_throttle(ct)
                except ValueError:
                    cur = s.get_cluster_throttle(ct.name)
                    s.update_cluster_throttle(replace(ct, status=cur.status))

            both(apply_ct)
        elif op < 0.65 or not pods:  # create a pod (sometimes already bound)
            name, ns = f"p{step}", rng.choice(namespaces)
            pod = kit.make_pod(
                name,
                namespace=ns,
                labels={rng.choice("abc"): rng.choice("xyz") for _ in range(rng.randint(0, 2))},
                requests={"cpu": f"{rng.randint(1, 6)}00m"},
                scheduler_name="my-scheduler" if rng.random() < 0.9 else "other",
                node_name="n1" if rng.random() < 0.5 else "",
            )
            pods.append(pod)
            both(lambda s, pod=pod: s.create_pod(pod))
        elif op < 0.75:  # label move on a random pod
            old = rng.choice(pods)
            moved = replace(
                old, labels={rng.choice("abc"): rng.choice("xyz")}
            )
            pods[pods.index(old)] = moved

            def upd(s, moved=moved):
                try:
                    s.update_pod(moved)
                except kit.NotFoundError:
                    pass

            both(upd)
        elif op < 0.82:  # reserve / unreserve a pod (scheduler cycle)
            pod = rng.choice(pods)
            if rng.random() < 0.6:
                got = [p.reserve(pod) for p in plugins]
                sh = got[-1]
                for sd in got[:-1]:
                    assert sd.code == sh.code, (pod.key, sd.reasons, sh.reasons)
                trace.append(("reserve", pod.key, _verdict(sh)[0]))
            else:
                for p in plugins:
                    p.unreserve(pod)
        elif op < 0.87:  # delete a throttle — exercises column free/reuse
            if rng.random() < 0.5:
                name, ns = f"t{rng.randint(0, 6)}", rng.choice(namespaces)

                def rm_thr(s, name=name, ns=ns):
                    try:
                        s.delete_throttle(ns, name)
                    except kit.NotFoundError:
                        pass

                both(rm_thr)
            else:
                name = f"ct{rng.randint(0, 4)}"

                def rm_ct(s, name=name):
                    try:
                        s.delete_cluster_throttle(name)
                    except kit.NotFoundError:
                        pass

                both(rm_ct)
        elif op < 0.93:  # delete a pod
            pod = pods.pop(rng.randrange(len(pods)))

            def rm(s, pod=pod):
                try:
                    s.delete_pod(pod.namespace, pod.name)
                except kit.NotFoundError:
                    pass

            both(rm)
        else:  # late namespace arrival / label change
            ns = rng.choice(namespaces)
            labels = {"env": rng.choice("pq")}

            def upsert_ns(s, ns=ns, labels=labels):
                try:
                    s.create_namespace(kit.Namespace(ns, labels=dict(labels)))
                except ValueError:
                    s.update_namespace(kit.Namespace(ns, labels=dict(labels)))

            both(upsert_ns)

        if step == 60:
            # advance every clock past every override window boundary so the
            # next reconciles flip active → expired (and future → active)
            for _, _, clock in stacks:
                clock.advance(timedelta(hours=1, minutes=30))
            # re-reconcile every override-bearing throttle at the new time
            for s in stores:
                for thr in s.list_throttles():
                    s.update_throttle(thr)
                for ct in s.list_cluster_throttles():
                    s.update_cluster_throttle(ct)

        if step % 12 == 11:
            checkpoint()

    checkpoint()
    return trace


def checkpoints(trace) -> int:
    """The checkpoints of a :func:`churn` trace."""
    return sum(1 for entry in trace if entry[0] == "checkpoint")
