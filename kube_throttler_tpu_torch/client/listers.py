"""Indexer-backed listers — the lister-gen analog
(pkg/generated/listers/schedule/v1alpha1/).

``ThrottleLister.throttles(ns).list(selector)`` mirrors
listers/schedule/v1alpha1/throttle.go:46-99: list from the shared
informer's indexer using the namespace index, optionally filtered by a
predicate (the Go version takes ``labels.Selector``; throttle objects here
carry no metadata labels, so the filter is a generic predicate — the
everything-selector is ``None``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, TypeVar

from ..api.pod import Namespace, Pod
from ..api.types import ClusterThrottle, Throttle
from .informers import NAMESPACE_INDEX, Indexer

T = TypeVar("T")
Predicate = Optional[Callable[[T], bool]]


def _filtered(objs: List[T], predicate: Predicate) -> List[T]:
    if predicate is None:
        return objs
    return [o for o in objs if predicate(o)]


class ThrottleNamespaceLister:
    def __init__(self, indexer: Indexer, namespace: str) -> None:
        self._indexer = indexer
        self._namespace = namespace

    def list(self, predicate: Predicate = None) -> List[Throttle]:
        return _filtered(self._indexer.by_index(NAMESPACE_INDEX, self._namespace), predicate)

    def get(self, name: str) -> Throttle:
        obj = self._indexer.get(f"{self._namespace}/{name}")
        if obj is None:
            raise KeyError(f"throttle {self._namespace}/{name} not found")
        return obj


class ThrottleLister:
    def __init__(self, indexer: Indexer) -> None:
        self._indexer = indexer

    def list(self, predicate: Predicate = None) -> List[Throttle]:
        return _filtered(self._indexer.list(), predicate)

    def throttles(self, namespace: str) -> ThrottleNamespaceLister:
        return ThrottleNamespaceLister(self._indexer, namespace)

    def get_by_keys(self, keys) -> List[Optional[Throttle]]:
        """Bulk fetch by full "ns/name" store keys (one indexer lock hold);
        None per missing key. Serving fast path — see Indexer.get_many."""
        return self._indexer.get_many(keys)


class ClusterThrottleLister:
    def __init__(self, indexer: Indexer) -> None:
        self._indexer = indexer

    def list(self, predicate: Predicate = None) -> List[ClusterThrottle]:
        return _filtered(self._indexer.list(), predicate)

    def get(self, name: str) -> ClusterThrottle:
        obj = self._indexer.get(name)
        if obj is None:
            raise KeyError(f"clusterthrottle {name} not found")
        return obj

    def get_by_names(self, names) -> List[Optional[ClusterThrottle]]:
        """Bulk fetch by bare names (one indexer lock hold); None per
        missing name. Serving fast path — see Indexer.get_many."""
        return self._indexer.get_many(names)


class PodNamespaceLister:
    def __init__(self, indexer: Indexer, namespace: str) -> None:
        self._indexer = indexer
        self._namespace = namespace

    def list(self, predicate: Predicate = None) -> List[Pod]:
        return _filtered(self._indexer.by_index(NAMESPACE_INDEX, self._namespace), predicate)

    def get(self, name: str) -> Pod:
        obj = self._indexer.get(f"{self._namespace}/{name}")
        if obj is None:
            raise KeyError(f"pod {self._namespace}/{name} not found")
        return obj


class PodLister:
    def __init__(self, indexer: Indexer) -> None:
        self._indexer = indexer

    def list(self, predicate: Predicate = None) -> List[Pod]:
        return _filtered(self._indexer.list(), predicate)

    def pods(self, namespace: str) -> PodNamespaceLister:
        return PodNamespaceLister(self._indexer, namespace)


class NamespaceLister:
    def __init__(self, indexer: Indexer) -> None:
        self._indexer = indexer

    def list(self, predicate: Predicate = None) -> List[Namespace]:
        return _filtered(self._indexer.list(), predicate)

    def get(self, name: str) -> Namespace:
        obj = self._indexer.get(name)
        if obj is None:
            raise KeyError(f"namespace {name} not found")
        return obj


class Listers:
    """The bundle the plugin hands its controllers: every read the hot/async
    paths do goes through these indexer-backed listers (the reference reads
    through exactly this layer — plugin.go:76-88 wires listers from the two
    informer factories into the controllers)."""

    def __init__(
        self,
        throttles: ThrottleLister,
        cluster_throttles: ClusterThrottleLister,
        pods: PodLister,
        namespaces: NamespaceLister,
    ) -> None:
        self.throttles = throttles
        self.cluster_throttles = cluster_throttles
        self.pods = pods
        self.namespaces = namespaces

    @classmethod
    def from_factories(cls, schedule_factory, core_factory) -> "Listers":
        """Build from the two shared informer factories (the reference keeps
        throttle kinds and core kinds in separate factories because the
        framework's pod informer lacks a namespace indexer, plugin.go:81-84)."""
        return cls(
            throttles=ThrottleLister(schedule_factory.throttles().indexer),
            cluster_throttles=ClusterThrottleLister(
                schedule_factory.cluster_throttles().indexer
            ),
            pods=PodLister(core_factory.pods().indexer),
            namespaces=NamespaceLister(core_factory.namespaces().indexer),
        )
