"""CRD generation — the codegen pipeline, TPU-build edition.

The reference generates ``deploy/crd.yaml`` with controller-gen from Go
struct markers (Makefile:40-42, hack/update-codegen.sh). Here the typed
model lives in :mod:`kube_throttler_tpu.api.types`, so the OpenAPI v3
structural schemas are built programmatically from that model and emitted
by ``tools/gen_crd.py`` (run via ``make gen``).

Also provides :func:`validate` — a minimal structural-schema validator
(the subset controller-gen emits: object/array/string/integer types,
``properties``/``items``/``additionalProperties``/``required``,
``x-kubernetes-int-or-string``) so tests and the in-memory apiserver can
check manifests against the generated schema without a cluster.

Group/version/kind names match the reference exactly
(pkg/apis/schedule/register.go:217-219, v1alpha1/register.go:169-196) so
existing manifests apply unchanged.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from .serialization import API_GROUP as GROUP
from .serialization import API_VERSION, VERSION


# ---------------------------------------------------------------------------
# Schema builders (composable; mirror the types in api/types.py)
# ---------------------------------------------------------------------------


def _s(t: str, **kw: Any) -> Dict[str, Any]:
    d: Dict[str, Any] = {"type": t}
    d.update(kw)
    return d


def quantity_schema() -> Dict[str, Any]:
    """k8s resource.Quantity: int-or-string with the canonical pattern."""
    return {
        "anyOf": [{"type": "integer"}, {"type": "string"}],
        "pattern": r"^(\+|-)?(([0-9]+(\.[0-9]*)?)|(\.[0-9]+))(([KMGTPE]i)|[numkMGTPE]|([eE](\+|-)?(([0-9]+(\.[0-9]*)?)|(\.[0-9]+))))?$",
        "x-kubernetes-int-or-string": True,
    }


def resource_amount_schema() -> Dict[str, Any]:
    """ResourceAmount {resourceCounts{pod int}, resourceRequests ResourceList}
    (resource_amount.go / api/types.py ResourceAmount)."""
    return _s(
        "object",
        properties={
            "resourceCounts": _s(
                "object",
                description="limits number of resources",
                properties={"pod": _s("integer", description="max running pod count")},
            ),
            "resourceRequests": _s(
                "object",
                description="limits aggregate resources.requests of running pods",
                additionalProperties=quantity_schema(),
            ),
        },
    )


def label_selector_schema() -> Dict[str, Any]:
    """metav1.LabelSelector: matchLabels AND matchExpressions."""
    return {
        "type": "object",
        "properties": {
            "matchLabels": _s("object", additionalProperties=_s("string")),
            "matchExpressions": _s(
                "array",
                items=_s(
                    "object",
                    properties={
                        "key": _s("string"),
                        "operator": _s(
                            "string",
                            description="In, NotIn, Exists or DoesNotExist",
                        ),
                        "values": _s("array", items=_s("string")),
                    },
                    required=["key", "operator"],
                ),
            ),
        },
        "x-kubernetes-map-type": "atomic",
    }


def selector_schema(cluster: bool) -> Dict[str, Any]:
    """selector.selectorTerms[] OR-ed; ClusterThrottle terms add a
    namespaceSelector ANDed with the podSelector (throttle_selector.go:26-54,
    clusterthrottle_selector.go:84-141). The reference's Go field name is the
    typo ``SelecterTerms`` but its JSON tag — the wire format — is
    ``selectorTerms`` (throttle_selector.go:27), so only that spelling is in
    the schema."""
    term_props: Dict[str, Any] = {"podSelector": label_selector_schema()}
    if cluster:
        term_props["namespaceSelector"] = label_selector_schema()
    terms = _s("array", items=_s("object", properties=term_props))
    return _s(
        "object",
        description="OR-ed list of selector terms; each term is an AND of its selectors",
        properties={"selectorTerms": terms},
    )


def override_schema() -> Dict[str, Any]:
    return _s(
        "object",
        description=(
            "time-windowed threshold replacement; begin/end are inclusive "
            "RFC3339 timestamps, either may be empty (open-ended); when "
            "multiple overrides are active the first wins per resource"
        ),
        properties={
            "begin": _s("string"),
            "end": _s("string"),
            "threshold": resource_amount_schema(),
        },
    )


def throttled_flags_schema() -> Dict[str, Any]:
    return _s(
        "object",
        properties={
            "resourceCounts": _s("object", properties={"pod": _s("boolean")}),
            "resourceRequests": _s("object", additionalProperties=_s("boolean")),
        },
    )


def status_schema() -> Dict[str, Any]:
    return _s(
        "object",
        properties={
            "throttled": throttled_flags_schema(),
            "used": resource_amount_schema(),
            "calculatedThreshold": _s(
                "object",
                properties={
                    "threshold": resource_amount_schema(),
                    # Go's zero metav1.Time marshals as JSON null
                    "calculatedAt": _s("string", format="date-time", nullable=True),
                    "messages": _s("array", items=_s("string")),
                },
            ),
        },
    )


def spec_schema(cluster: bool) -> Dict[str, Any]:
    return _s(
        "object",
        properties={
            "throttlerName": _s(
                "string",
                description="the throttler instance (plugin args .name) owning this object",
            ),
            "selector": selector_schema(cluster),
            "threshold": resource_amount_schema(),
            "temporaryThresholdOverrides": _s("array", items=override_schema()),
        },
    )


def _printer_columns() -> List[Dict[str, Any]]:
    return [
        {"name": "throttled", "type": "string", "format": "byte", "jsonPath": ".status.throttled"},
        {
            "name": "calculatedThreshold",
            "type": "string",
            "format": "byte",
            "priority": 1,
            "jsonPath": ".status.calculatedThreshold.threshold",
        },
        {
            "name": "calculatedAt",
            "type": "date",
            "priority": 1,
            "jsonPath": ".status.calculatedThreshold.calculatedAt",
        },
        {"name": "age", "type": "date", "jsonPath": ".metadata.creationTimestamp"},
    ]


def object_schema(cluster: bool) -> Dict[str, Any]:
    return _s(
        "object",
        properties={
            "apiVersion": _s("string"),
            "kind": _s("string"),
            "metadata": _s("object"),
            "spec": spec_schema(cluster),
            "status": status_schema(),
        },
    )


def crd(cluster: bool) -> Dict[str, Any]:
    """One CustomResourceDefinition document (apiextensions.k8s.io/v1)."""
    kind = "ClusterThrottle" if cluster else "Throttle"
    plural = kind.lower() + "s"
    short = ["clthr", "clthrs"] if cluster else ["thr", "thrs"]
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {
            "name": f"{plural}.{GROUP}",
            "annotations": {"kube-throttler-tpu/codegen": "tools/gen_crd.py"},
        },
        "spec": {
            "group": GROUP,
            "scope": "Cluster" if cluster else "Namespaced",
            "names": {
                "kind": kind,
                "listKind": kind + "List",
                "plural": plural,
                "singular": kind.lower(),
                "shortNames": short,
                "categories": ["kube-throttler"],
            },
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    "additionalPrinterColumns": _printer_columns(),
                    "subresources": {"status": {}},
                    "schema": {"openAPIV3Schema": object_schema(cluster)},
                }
            ],
        },
    }


def throttle_crd() -> Dict[str, Any]:
    return crd(cluster=False)


def cluster_throttle_crd() -> Dict[str, Any]:
    return crd(cluster=True)


# ---------------------------------------------------------------------------
# Minimal structural-schema validation
# ---------------------------------------------------------------------------


class SchemaError(ValueError):
    def __init__(self, path: str, message: str) -> None:
        self.path = path or "."
        super().__init__(f"{self.path}: {message}")


def _validate(value: Any, schema: Dict[str, Any], path: str, errors: List[SchemaError]) -> None:
    if value is None and schema.get("nullable"):
        return
    if schema.get("x-kubernetes-int-or-string") or "anyOf" in schema:
        if not isinstance(value, (int, str)) or isinstance(value, bool):
            errors.append(SchemaError(path, f"expected integer or string, got {type(value).__name__}"))
        elif isinstance(value, str) and "pattern" in schema and not re.fullmatch(schema["pattern"], value):
            errors.append(SchemaError(path, f"{value!r} does not match pattern {schema['pattern']!r}"))
        return
    t = schema.get("type")
    if t == "object":
        if not isinstance(value, dict):
            errors.append(SchemaError(path, f"expected object, got {type(value).__name__}"))
            return
        props = schema.get("properties", {})
        for req in schema.get("required", []):
            if req not in value:
                errors.append(SchemaError(path, f"missing required field {req!r}"))
        addl = schema.get("additionalProperties")
        for k, v in value.items():
            if k in props:
                _validate(v, props[k], f"{path}.{k}", errors)
            elif isinstance(addl, dict):
                _validate(v, addl, f"{path}.{k}", errors)
            elif props and addl is None:
                # structural schemas prune unknown fields rather than reject;
                # flag them so tests catch typos, mirroring kubectl's
                # server-side "unknown field" warning
                errors.append(SchemaError(path, f"unknown field {k!r}"))
    elif t == "array":
        if not isinstance(value, list):
            errors.append(SchemaError(path, f"expected array, got {type(value).__name__}"))
            return
        item_schema = schema.get("items")
        if isinstance(item_schema, dict):
            for i, item in enumerate(value):
                _validate(item, item_schema, f"{path}[{i}]", errors)
    elif t == "string":
        if not isinstance(value, str):
            errors.append(SchemaError(path, f"expected string, got {type(value).__name__}"))
    elif t == "integer":
        if not isinstance(value, int) or isinstance(value, bool):
            errors.append(SchemaError(path, f"expected integer, got {type(value).__name__}"))
    elif t == "boolean":
        if not isinstance(value, bool):
            errors.append(SchemaError(path, f"expected boolean, got {type(value).__name__}"))


def validate(manifest: Dict[str, Any], schema: Optional[Dict[str, Any]] = None) -> List[SchemaError]:
    """Validate a manifest dict; returns a list of errors (empty == valid).

    With ``schema=None`` the schema is chosen from ``manifest["kind"]``.
    """
    if schema is None:
        kind = manifest.get("kind")
        if kind == "Throttle":
            schema = object_schema(cluster=False)
        elif kind == "ClusterThrottle":
            schema = object_schema(cluster=True)
        else:
            return [SchemaError("kind", f"no schema for kind {kind!r}")]
    errors: List[SchemaError] = []
    _validate(manifest, schema, "", errors)
    return errors
