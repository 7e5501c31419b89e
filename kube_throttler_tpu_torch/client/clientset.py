"""Typed clientset — the hand-written analog of the reference's generated
client-gen output (pkg/generated/clientset/versioned/).

Verb parity with ThrottleInterface (clientset/versioned/typed/schedule/
v1alpha1/throttle.go:39-52): Create, Update, UpdateStatus, Delete,
DeleteCollection, Get, List, Watch, Patch. ClusterThrottles are
cluster-scoped (clusterthrottle.go:39-52); a CoreV1 facade covers the
Pod/Namespace surface the plugin consumes through its second informer
factory (plugin.go:81-88).

``Patch`` is an RFC 7386 JSON merge patch applied to the object's manifest
dict and re-parsed — the moral equivalent of the generated client's
``types.MergePatchType`` path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ..api.pod import Namespace, Pod
from ..api.serialization import (
    cluster_throttle_from_dict,
    cluster_throttle_to_dict,
    namespace_from_dict,
    namespace_to_dict,
    normalize_manifest,
    pod_from_dict,
    pod_to_dict,
    throttle_from_dict,
    throttle_to_dict,
)
from ..api.types import ClusterThrottle, Throttle
from ..engine.store import NotFoundError, Store
from .watch import Watch


def json_merge_patch(target: Any, patch: Any) -> Any:
    """RFC 7386: objects merge recursively, ``null`` deletes, everything
    else replaces."""
    if not isinstance(patch, dict):
        return patch
    result: Dict[str, Any] = dict(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            result.pop(k, None)
        else:
            result[k] = json_merge_patch(result.get(k), v)
    return result


class ThrottleInterface:
    """Namespaced Throttle client (throttle.go:69-196)."""

    def __init__(self, store: Store, namespace: str) -> None:
        self._store = store
        self._namespace = namespace

    def _scoped(self, thr: Throttle) -> Throttle:
        if thr.namespace != self._namespace:
            from dataclasses import replace

            thr = replace(thr, namespace=self._namespace)
        return thr

    def create(self, thr: Throttle) -> Throttle:
        return self._store.create_throttle(self._scoped(thr))

    def update(self, thr: Throttle) -> Throttle:
        # status-subresource semantics: the store atomically preserves the
        # stored status under its lock (see Store.update_throttle_spec)
        return self._store.update_throttle_spec(self._scoped(thr))

    def update_status(self, thr: Throttle, expected_version: Optional[int] = None) -> Throttle:
        return self._store.update_throttle_status(self._scoped(thr), expected_version)

    def delete(self, name: str) -> Throttle:
        return self._store.delete_throttle(self._namespace, name)

    def delete_collection(
        self, predicate: Optional[Callable[[Throttle], bool]] = None
    ) -> List[Throttle]:
        deleted = []
        for thr in self.list():
            if predicate is None or predicate(thr):
                try:
                    deleted.append(self._store.delete_throttle(self._namespace, thr.name))
                except NotFoundError:
                    pass  # raced with a concurrent delete
        return deleted

    def get(self, name: str) -> Throttle:
        return self._store.get_throttle(self._namespace, name)

    def list(self) -> List[Throttle]:
        return self._store.list_throttles(self._namespace)

    def watch(self, replay: bool = False) -> Watch:
        ns = self._namespace
        return Watch(
            self._store, "Throttle", filter=lambda e: e.obj.namespace == ns, replay=replay
        )

    def patch(self, name: str, patch: Dict[str, Any]) -> Throttle:
        normalized = normalize_manifest(patch)

        def apply(current: Throttle) -> Throttle:
            merged = json_merge_patch(throttle_to_dict(current), normalized)
            return self._scoped(throttle_from_dict(merged))

        # atomic get→merge→update under the store lock (MergePatchType is
        # atomic on a real apiserver; see Store.mutate)
        return self._store.mutate("Throttle", f"{self._namespace}/{name}", apply)


class ClusterThrottleInterface:
    """Cluster-scoped client (clusterthrottle.go:69-186)."""

    def __init__(self, store: Store) -> None:
        self._store = store

    def create(self, thr: ClusterThrottle) -> ClusterThrottle:
        return self._store.create_cluster_throttle(thr)

    def update(self, thr: ClusterThrottle) -> ClusterThrottle:
        return self._store.update_cluster_throttle_spec(thr)

    def update_status(
        self, thr: ClusterThrottle, expected_version: Optional[int] = None
    ) -> ClusterThrottle:
        return self._store.update_cluster_throttle_status(thr, expected_version)

    def delete(self, name: str) -> ClusterThrottle:
        return self._store.delete_cluster_throttle(name)

    def delete_collection(
        self, predicate: Optional[Callable[[ClusterThrottle], bool]] = None
    ) -> List[ClusterThrottle]:
        deleted = []
        for thr in self.list():
            if predicate is None or predicate(thr):
                try:
                    deleted.append(self._store.delete_cluster_throttle(thr.name))
                except NotFoundError:
                    pass  # raced with a concurrent delete
        return deleted

    def get(self, name: str) -> ClusterThrottle:
        return self._store.get_cluster_throttle(name)

    def list(self) -> List[ClusterThrottle]:
        return self._store.list_cluster_throttles()

    def watch(self, replay: bool = False) -> Watch:
        return Watch(self._store, "ClusterThrottle", replay=replay)

    def patch(self, name: str, patch: Dict[str, Any]) -> ClusterThrottle:
        normalized = normalize_manifest(patch)

        def apply(current: ClusterThrottle) -> ClusterThrottle:
            merged = json_merge_patch(cluster_throttle_to_dict(current), normalized)
            return cluster_throttle_from_dict(merged)

        return self._store.mutate("ClusterThrottle", name, apply)


class PodInterface:
    def __init__(self, store: Store, namespace: str) -> None:
        self._store = store
        self._namespace = namespace

    def create(self, pod: Pod) -> Pod:
        return self._store.create_pod(pod)

    def update(self, pod: Pod) -> Pod:
        return self._store.update_pod(pod)

    def delete(self, name: str) -> Pod:
        return self._store.delete_pod(self._namespace, name)

    def get(self, name: str) -> Pod:
        return self._store.get_pod(self._namespace, name)

    def list(self) -> List[Pod]:
        return self._store.list_pods(self._namespace)

    def watch(self, replay: bool = False) -> Watch:
        ns = self._namespace
        return Watch(self._store, "Pod", filter=lambda e: e.obj.namespace == ns, replay=replay)

    def patch(self, name: str, patch: Dict[str, Any]) -> Pod:
        def apply(current: Pod) -> Pod:
            merged = json_merge_patch(pod_to_dict(current), patch)
            return pod_from_dict(merged)

        return self._store.mutate("Pod", f"{self._namespace}/{name}", apply)


class NamespaceInterface:
    def __init__(self, store: Store) -> None:
        self._store = store

    def create(self, ns: Namespace) -> Namespace:
        return self._store.create_namespace(ns)

    def update(self, ns: Namespace) -> Namespace:
        return self._store.update_namespace(ns)

    def get(self, name: str) -> Optional[Namespace]:
        return self._store.get_namespace(name)

    def list(self) -> List[Namespace]:
        return self._store.list_namespaces()

    def watch(self, replay: bool = False) -> Watch:
        return Watch(self._store, "Namespace", replay=replay)

    def patch(self, name: str, patch: Dict[str, Any]) -> Namespace:
        def apply(current: Namespace) -> Namespace:
            merged = json_merge_patch(namespace_to_dict(current), patch)
            return namespace_from_dict(merged)

        return self._store.mutate("Namespace", name, apply)


class ScheduleV1alpha1Client:
    """group schedule.k8s.everpeace.github.com, version v1alpha1
    (schedule_client.go:27-42)."""

    def __init__(self, store: Store) -> None:
        self._store = store

    def throttles(self, namespace: str = "default") -> ThrottleInterface:
        return ThrottleInterface(self._store, namespace)

    def cluster_throttles(self) -> ClusterThrottleInterface:
        return ClusterThrottleInterface(self._store)


class CoreV1Client:
    def __init__(self, store: Store) -> None:
        self._store = store

    def pods(self, namespace: str = "default") -> PodInterface:
        return PodInterface(self._store, namespace)

    def namespaces(self) -> NamespaceInterface:
        return NamespaceInterface(self._store)


class Clientset:
    """The versioned clientset facade (clientset.go:30-41)."""

    def __init__(self, store: Store) -> None:
        self.store = store

    def schedule_v1alpha1(self) -> ScheduleV1alpha1Client:
        return ScheduleV1alpha1Client(self.store)

    def core_v1(self) -> CoreV1Client:
        return CoreV1Client(self.store)


def new_fake_clientset(*objects) -> Clientset:
    """Fake clientset preloaded with objects (fake/clientset.go:38-58):
    a real clientset over a private fresh store — the store *is* the
    deterministic apiserver double, so the fake and the real client share
    one implementation."""
    store = Store()
    # namespaces first so namespaced objects land in existing namespaces
    for obj in objects:
        if isinstance(obj, Namespace):
            store.create_namespace(obj)
    for obj in objects:
        if isinstance(obj, Namespace):
            continue
        if isinstance(obj, Throttle):
            store.create_throttle(obj)
        elif isinstance(obj, ClusterThrottle):
            store.create_cluster_throttle(obj)
        elif isinstance(obj, Pod):
            store.create_pod(obj)
        else:
            raise ValueError(f"unsupported object: {type(obj).__name__}")
    return Clientset(store)
