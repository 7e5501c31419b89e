"""The thin adapter from the plain cluster to the program's own objects.

It hands the program exactly the data the reference reads: the same
namespaces, pods, quantities and selectors, as ``Namespace``,
``make_pod`` pods and the ``api.types`` classes, loaded into a ``Store``
under the in-process plugin (``KubeThrottler(..., use_device=True)``) at
its deployment defaults.
"""

from __future__ import annotations

from typing import List

from .cluster import Cluster, Spec, rfc3339

THROTTLER_NAME = "kube-throttler"
SCHEDULER_NAME = "my-scheduler"
POD_BATCH = 10_000  # pods a store batch applies, as an informer's relist delivers them
PODS_PER_NODE = 110  # the kubelet's default max-pods


def amount(spec: Spec):
    from kube_throttler_tpu_torch.api.types import ResourceAmount

    return ResourceAmount.of(pod=spec.pod, requests=spec.requests)


def _label_selector(labels):
    from kube_throttler_tpu_torch.api.types import LabelSelector

    return LabelSelector(match_labels=dict(labels))


def throttle_objects(cluster: Cluster, kind: str) -> list:
    from kube_throttler_tpu_torch.api.types import (
        ClusterThrottle, ClusterThrottleSelector, ClusterThrottleSelectorTerm,
        ClusterThrottleSpec, TemporaryThresholdOverride, Throttle, ThrottleSelector,
        ThrottleSelectorTerm, ThrottleSpec,
    )

    ts = cluster.throttles if kind == "throttle" else cluster.cluster_throttles
    out = []
    for i, key in enumerate(ts.keys):
        ns, _, name = key.partition("/")
        overrides = tuple(
            TemporaryThresholdOverride(begin=rfc3339(b), end="" if e is None else rfc3339(e),
                                       threshold=amount(s))
            for b, e, s in cluster.override_specs[kind][i]
        )
        threshold = amount(cluster.specs[kind][i])
        if kind == "throttle":
            out.append(Throttle(name=name, namespace=ns, spec=ThrottleSpec(
                throttler_name=THROTTLER_NAME, threshold=threshold,
                temporary_threshold_overrides=overrides,
                selector=ThrottleSelector(selector_terms=tuple(
                    ThrottleSelectorTerm(_label_selector(term.pod)) for term in ts.terms[i])),
            )))
        else:
            out.append(ClusterThrottle(name=name, spec=ClusterThrottleSpec(
                throttler_name=THROTTLER_NAME, threshold=threshold,
                temporary_threshold_overrides=overrides,
                selector=ClusterThrottleSelector(selector_terms=tuple(
                    ClusterThrottleSelectorTerm(pod_selector=_label_selector(term.pod),
                                                namespace_selector=_label_selector(term.namespace))
                    for term in ts.terms[i])),
            )))
    return out


def pod_object(cluster: Cluster, row: int):
    from kube_throttler_tpu_torch.api.pod import make_pod

    p = cluster.pods
    labels = {k: v[row] for k, v in p.labels.items() if v[row] is not None}
    counted = bool(p.counted[row])
    return make_pod(
        p.names[row], namespace=cluster.namespaces.names[p.ns[row]], labels=labels,
        requests=cluster.pod_requests[row], scheduler_name=SCHEDULER_NAME,
        node_name=f"node-{row // PODS_PER_NODE}" if counted else "",
        phase="Running" if counted else "Pending",
    )


def build_plugin(cluster: Cluster, device, marks=None, clock=None):
    """(store, plugin) with the whole cluster loaded, reconciled once.
    With ``marks`` and ``clock``, appends (step, time) after each step."""

    def mark(name):
        if marks is not None:
            marks.append((name, clock()))

    from kube_throttler_tpu_torch.api.pod import Namespace
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args({"name": THROTTLER_NAME, "targetSchedulerName": SCHEDULER_NAME}),
        store, use_device=True, device=device,
    )
    mark("plugin")
    ns = cluster.namespaces
    for i, name in enumerate(ns.names):
        labels = {k: v[i] for k, v in ns.labels.items() if v[i] is not None}
        store.create_namespace(Namespace(name, labels=labels))
    for t in throttle_objects(cluster, "throttle"):
        store.create_throttle(t)
    for t in throttle_objects(cluster, "clusterthrottle"):
        store.create_cluster_throttle(t)
    mark("throttles")
    rows = [int(r) for r in cluster.pods.alive.nonzero()[0]]
    pods = [pod_object(cluster, r) for r in rows]
    mark("pod_objects")
    for i in range(0, len(pods), POD_BATCH):
        apply(store, [("create", "Pod", p) for p in pods[i:i + POD_BATCH]])
    mark("pods_loaded")
    plugin.run_pending_once()
    mark("reconcile")
    return store, plugin


def apply(store, ops: List[tuple]) -> None:
    """One store batch; raises on the first op that failed."""
    for res in store.apply_events(ops):
        if isinstance(res, Exception):
            raise res
