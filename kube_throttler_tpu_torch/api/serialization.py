"""Manifest (de)serialization — YAML/JSON dicts ↔ typed API objects.

Accepts the same manifest shapes as the reference CRDs (see
the reference's example/*.yaml and deploy/crd.yaml): ``spec.throttlerName``,
``spec.selector.selectorTerms[].podSelector/namespaceSelector`` (matchLabels +
matchExpressions), ``spec.threshold.resourceCounts.pod`` /
``.resourceRequests``, and ``spec.temporaryThresholdOverrides[].begin/end/
threshold``.
"""

from __future__ import annotations

from datetime import date, datetime, timezone
from typing import Any, Dict, List, Mapping, Optional

from ..quantity import format_quantity, parse_quantity
from .pod import Container, Namespace, Pod, PodSpec, PodStatus
from .types import (
    AccelClassThreshold,
    CalculatedThreshold,
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    IsResourceAmountThrottled,
    LabelSelector,
    LabelSelectorRequirement,
    ResourceAmount,
    TemporaryThresholdOverride,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
    ThrottleStatus,
    parse_rfc3339,
)

API_GROUP = "schedule.k8s.everpeace.github.com"
VERSION = "v1alpha1"
API_VERSION = f"{API_GROUP}/{VERSION}"


def resource_amount_from_dict(d: Optional[Mapping[str, Any]]) -> ResourceAmount:
    if not d:
        return ResourceAmount()
    counts = d.get("resourceCounts")
    requests = d.get("resourceRequests")
    # presence of the resourceCounts *object* is what matters: Go unmarshals
    # `resourceCounts: {}` to &ResourceCounts{Pod: 0} — an active zero
    # pod-count threshold that blocks every pod, not an absent dimension
    return ResourceAmount(
        resource_counts=int(counts.get("pod", 0)) if counts is not None else None,
        resource_requests=(
            {str(k): parse_quantity(v) for k, v in requests.items()}
            if requests is not None
            else None
        ),
    )


def label_selector_from_dict(d: Optional[Mapping[str, Any]]) -> LabelSelector:
    if not d:
        return LabelSelector()
    exprs = tuple(
        LabelSelectorRequirement(
            key=str(e["key"]),
            operator=str(e.get("operator", "")),
            values=tuple(str(v) for v in e.get("values", []) or []),
        )
        for e in d.get("matchExpressions", []) or []
    )
    return LabelSelector(
        match_labels={str(k): str(v) for k, v in (d.get("matchLabels") or {}).items()},
        match_expressions=exprs,
    )


def _boundary_str(v: Any) -> str:
    # YAML auto-parses unquoted RFC3339 timestamps into datetime objects
    # (and date-only values into datetime.date); str() would yield
    # "2024-01-01 00:00:00+09:00" (space, not RFC3339), so format explicitly.
    if isinstance(v, datetime):
        if v.tzinfo is None:
            v = v.replace(tzinfo=timezone.utc)
        return v.isoformat().replace("+00:00", "Z")
    if isinstance(v, date):
        return v.isoformat()
    return str(v or "")


def _overrides_from_list(items: Optional[List[Mapping[str, Any]]]):
    return tuple(
        TemporaryThresholdOverride(
            begin=_boundary_str(o.get("begin", "")),
            end=_boundary_str(o.get("end", "")),
            threshold=resource_amount_from_dict(o.get("threshold")),
        )
        for o in (items or [])
    )


def _accel_thresholds_from_list(items: Optional[List[Mapping[str, Any]]]):
    return tuple(
        AccelClassThreshold(
            accel_class=str(e.get("accelClass", "")),
            threshold=resource_amount_from_dict(e.get("threshold")),
        )
        for e in (items or [])
    )


def _accel_thresholds_to_list(entries) -> List[Dict[str, Any]]:
    return [
        {"accelClass": e.accel_class, "threshold": e.threshold.to_dict()}
        for e in entries
    ]


def _throttled_flags_from_dict(d: Optional[Mapping[str, Any]]) -> IsResourceAmountThrottled:
    if not d:
        return IsResourceAmountThrottled()
    counts = d.get("resourceCounts")
    requests = d.get("resourceRequests")
    return IsResourceAmountThrottled(
        resource_counts_pod=bool(counts.get("pod", False)) if counts is not None else False,
        resource_requests=(
            {str(k): bool(v) for k, v in requests.items()} if requests is not None else None
        ),
    )


def status_from_dict(d: Optional[Mapping[str, Any]]) -> ThrottleStatus:
    """Parse the status subresource (throttle_types.go:113-117 shape)."""
    if not d:
        return ThrottleStatus()
    ct = d.get("calculatedThreshold") or {}
    calculated_at = ct.get("calculatedAt")
    return ThrottleStatus(
        calculated_threshold=CalculatedThreshold(
            threshold=resource_amount_from_dict(ct.get("threshold")),
            calculated_at=parse_rfc3339(calculated_at) if calculated_at else None,
            messages=tuple(str(m) for m in ct.get("messages", []) or []),
        ),
        throttled=_throttled_flags_from_dict(d.get("throttled")),
        used=resource_amount_from_dict(d.get("used")),
    )


def throttle_from_dict(d: Mapping[str, Any]) -> Throttle:
    meta = d.get("metadata", {})
    spec = d.get("spec", {})
    selector = spec.get("selector", {}) or {}
    terms = tuple(
        ThrottleSelectorTerm(pod_selector=label_selector_from_dict(t.get("podSelector")))
        for t in (selector.get("selectorTerms") or selector.get("selecterTerms") or [])
    )
    return Throttle(
        name=str(meta.get("name", "")),
        namespace=str(meta.get("namespace", "default") or "default"),
        uid=str(meta.get("uid", "")),
        spec=ThrottleSpec(
            throttler_name=str(spec.get("throttlerName", "")),
            threshold=resource_amount_from_dict(spec.get("threshold")),
            temporary_threshold_overrides=_overrides_from_list(
                spec.get("temporaryThresholdOverrides")
            ),
            accel_class_thresholds=_accel_thresholds_from_list(
                spec.get("accelClassThresholds")
            ),
            selector=ThrottleSelector(selector_terms=terms),
        ),
        status=status_from_dict(d.get("status")),
    )


def cluster_throttle_from_dict(d: Mapping[str, Any]) -> ClusterThrottle:
    meta = d.get("metadata", {})
    spec = d.get("spec", {})
    selector = spec.get("selector", {}) or {}
    terms = tuple(
        ClusterThrottleSelectorTerm(
            pod_selector=label_selector_from_dict(t.get("podSelector")),
            namespace_selector=label_selector_from_dict(t.get("namespaceSelector")),
        )
        for t in (selector.get("selectorTerms") or selector.get("selecterTerms") or [])
    )
    return ClusterThrottle(
        name=str(meta.get("name", "")),
        uid=str(meta.get("uid", "")),
        spec=ClusterThrottleSpec(
            throttler_name=str(spec.get("throttlerName", "")),
            threshold=resource_amount_from_dict(spec.get("threshold")),
            temporary_threshold_overrides=_overrides_from_list(
                spec.get("temporaryThresholdOverrides")
            ),
            accel_class_thresholds=_accel_thresholds_from_list(
                spec.get("accelClassThresholds")
            ),
            selector=ClusterThrottleSelector(selector_terms=terms),
        ),
        status=status_from_dict(d.get("status")),
    )


def pod_from_dict(d: Mapping[str, Any]) -> Pod:
    meta = d.get("metadata", {})
    spec = d.get("spec", {})
    status = d.get("status", {})

    def containers(key: str) -> List[Container]:
        out = []
        for c in spec.get(key, []) or []:
            reqs = (c.get("resources", {}) or {}).get("requests", {}) or {}
            out.append(Container.of(reqs, name=str(c.get("name", ""))))
        return out

    overhead = spec.get("overhead")
    uid_kwargs = {"uid": str(meta["uid"])} if meta.get("uid") else {}
    return Pod(
        name=str(meta.get("name", "")),
        namespace=str(meta.get("namespace", "default") or "default"),
        labels={str(k): str(v) for k, v in (meta.get("labels") or {}).items()},
        annotations={
            str(k): str(v) for k, v in (meta.get("annotations") or {}).items()
        },
        **uid_kwargs,
        spec=PodSpec(
            scheduler_name=str(spec.get("schedulerName", "")),
            node_name=str(spec.get("nodeName", "") or ""),
            containers=containers("containers"),
            init_containers=containers("initContainers"),
            overhead={k: parse_quantity(v) for k, v in overhead.items()}
            if overhead
            else None,
        ),
        status=PodStatus(phase=str(status.get("phase", "Pending") or "Pending")),
    )


def object_from_dict(d: Mapping[str, Any]):
    kind = d.get("kind", "")
    if kind == "Throttle":
        return throttle_from_dict(d)
    if kind == "ClusterThrottle":
        return cluster_throttle_from_dict(d)
    if kind == "Pod":
        return pod_from_dict(d)
    if kind == "Namespace":
        return namespace_from_dict(d)
    raise ValueError(f"unsupported kind: {kind!r}")


def namespace_from_dict(d: Mapping[str, Any]) -> Namespace:
    meta = d.get("metadata", {})
    kwargs = {"uid": str(meta["uid"])} if meta.get("uid") else {}
    return Namespace(
        name=str(meta.get("name", "")),
        labels={str(k): str(v) for k, v in (meta.get("labels") or {}).items()},
        **kwargs,
    )


def normalize_manifest(d: Any) -> Any:
    """Recursively rewrite the reference API's typo spelling ``selecterTerms``
    (throttle_selector.go:27 — an accepted input everywhere) to the canonical
    ``selectorTerms``. Needed before a JSON merge patch: merging a typo-keyed
    patch into a canonically-keyed document would otherwise leave BOTH keys,
    and the reader's precedence would pick the stale canonical one.

    Also renders YAML's auto-parsed timestamps (datetime and date-only)
    back to RFC3339 strings — the wire format is JSON, where they are
    strings (kubectl does the same YAML→JSON conversion before sending)."""
    if isinstance(d, (datetime, date)):
        return _boundary_str(d)
    if isinstance(d, dict):
        out = {}
        for k, v in d.items():
            key = "selectorTerms" if k == "selecterTerms" else k
            out[key] = normalize_manifest(v)
        return out
    if isinstance(d, list):
        return [normalize_manifest(v) for v in d]
    return d


# ---------------------------------------------------------------------------
# typed objects → manifest dicts (the serializer half the generated clients'
# Patch verb needs: round-trippable through *_from_dict above)
# ---------------------------------------------------------------------------


def label_selector_to_dict(sel: LabelSelector) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if sel.match_labels:
        out["matchLabels"] = dict(sorted(sel.match_labels.items()))
    if sel.match_expressions:
        out["matchExpressions"] = [
            {"key": e.key, "operator": e.operator, **({"values": list(e.values)} if e.values else {})}
            for e in sel.match_expressions
        ]
    return out


def _overrides_to_list(overrides) -> List[Dict[str, Any]]:
    return [
        {
            **({"begin": o.begin} if o.begin else {}),
            **({"end": o.end} if o.end else {}),
            "threshold": o.threshold.to_dict(),
        }
        for o in overrides
    ]


def status_to_dict(status: ThrottleStatus) -> Dict[str, Any]:
    ct = status.calculated_threshold
    return {
        "used": status.used.to_dict(),
        "throttled": status.throttled.to_dict(),
        "calculatedThreshold": {
            "threshold": ct.threshold.to_dict(),
            "calculatedAt": (
                # full precision (isoformat keeps microseconds; parse_rfc3339
                # accepts them) so to_dict/from_dict round-trips clock-stamped
                # statuses exactly
                ct.calculated_at.astimezone(timezone.utc).isoformat().replace("+00:00", "Z")
                if ct.calculated_at
                else None
            ),
            "messages": list(ct.messages),
        },
    }


def throttle_to_dict(thr: Throttle) -> Dict[str, Any]:
    return {
        "apiVersion": API_VERSION,
        "kind": "Throttle",
        "metadata": {
            "name": thr.name,
            "namespace": thr.namespace,
            **({"uid": thr.uid} if thr.uid else {}),
        },
        "spec": {
            **({"throttlerName": thr.spec.throttler_name} if thr.spec.throttler_name else {}),
            "threshold": thr.spec.threshold.to_dict(),
            **(
                {
                    "temporaryThresholdOverrides": _overrides_to_list(
                        thr.spec.temporary_threshold_overrides
                    )
                }
                if thr.spec.temporary_threshold_overrides
                else {}
            ),
            **(
                {
                    "accelClassThresholds": _accel_thresholds_to_list(
                        thr.spec.accel_class_thresholds
                    )
                }
                if thr.spec.accel_class_thresholds
                else {}
            ),
            "selector": {
                "selectorTerms": [
                    {"podSelector": label_selector_to_dict(t.pod_selector)}
                    for t in thr.spec.selector.selector_terms
                ]
            },
        },
        "status": status_to_dict(thr.status),
    }


def cluster_throttle_to_dict(thr: ClusterThrottle) -> Dict[str, Any]:
    return {
        "apiVersion": API_VERSION,
        "kind": "ClusterThrottle",
        "metadata": {"name": thr.name, **({"uid": thr.uid} if thr.uid else {})},
        "spec": {
            **({"throttlerName": thr.spec.throttler_name} if thr.spec.throttler_name else {}),
            "threshold": thr.spec.threshold.to_dict(),
            **(
                {
                    "temporaryThresholdOverrides": _overrides_to_list(
                        thr.spec.temporary_threshold_overrides
                    )
                }
                if thr.spec.temporary_threshold_overrides
                else {}
            ),
            **(
                {
                    "accelClassThresholds": _accel_thresholds_to_list(
                        thr.spec.accel_class_thresholds
                    )
                }
                if thr.spec.accel_class_thresholds
                else {}
            ),
            "selector": {
                "selectorTerms": [
                    {
                        "podSelector": label_selector_to_dict(t.pod_selector),
                        "namespaceSelector": label_selector_to_dict(t.namespace_selector),
                    }
                    for t in thr.spec.selector.selector_terms
                ]
            },
        },
        "status": status_to_dict(thr.status),
    }


def pod_to_dict(pod: Pod) -> Dict[str, Any]:
    def containers(cs: List[Container]) -> List[Dict[str, Any]]:
        return [
            {
                **({"name": c.name} if c.name else {}),
                "resources": {
                    "requests": {k: format_quantity(v) for k, v in sorted(c.requests.items())}
                },
            }
            for c in cs
        ]

    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            **({"uid": pod.uid} if pod.uid else {}),
            **({"labels": dict(sorted(pod.labels.items()))} if pod.labels else {}),
            **(
                {"annotations": dict(sorted(pod.annotations.items()))}
                if pod.annotations
                else {}
            ),
        },
        "spec": {
            **({"schedulerName": pod.spec.scheduler_name} if pod.spec.scheduler_name else {}),
            **({"nodeName": pod.spec.node_name} if pod.spec.node_name else {}),
            "containers": containers(pod.spec.containers),
            **(
                {"initContainers": containers(pod.spec.init_containers)}
                if pod.spec.init_containers
                else {}
            ),
            **(
                {"overhead": {k: format_quantity(v) for k, v in sorted(pod.spec.overhead.items())}}
                if pod.spec.overhead
                else {}
            ),
        },
        "status": {"phase": pod.status.phase},
    }


def namespace_to_dict(ns: Namespace) -> Dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {
            "name": ns.name,
            **({"uid": ns.uid} if ns.uid else {}),
            **({"labels": dict(sorted(ns.labels.items()))} if ns.labels else {}),
        },
    }


def object_to_dict(obj) -> Dict[str, Any]:
    if isinstance(obj, Throttle):
        return throttle_to_dict(obj)
    if isinstance(obj, ClusterThrottle):
        return cluster_throttle_to_dict(obj)
    if isinstance(obj, Pod):
        return pod_to_dict(obj)
    if isinstance(obj, Namespace):
        return namespace_to_dict(obj)
    raise ValueError(f"unsupported object: {type(obj).__name__}")
