"""Deterministic in-memory object store speaking the watch protocol.

Plays the role of kube-apiserver + client-go informer caches in one object:

- every mutation bumps a global monotonically-increasing resourceVersion;
- ``update_*_status`` enforces optimistic concurrency like the status
  subresource (conflict → ``ConflictError``, caller re-reads and retries,
  matching UpdateStatus error handling at throttle_controller.go:170-173);
- event handlers (add/update/delete) fire synchronously on the mutating
  thread — informer handlers in the reference are required to be fast and
  only enqueue workqueue keys, which is exactly how the controllers here use
  them. Reconcile work itself is decoupled through the workqueue, so the
  observable interleaving (watch event → enqueue → async reconcile → status
  write → next event) matches the reference's.

Store contents are immutable-by-convention: mutators replace whole objects
(`dataclasses.replace` style); readers must not mutate returned objects.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..api.pod import Namespace, Pod
from ..api.types import ClusterThrottle, Throttle
from ..utils.lockorder import assert_held, make_rlock
from .columnar import ColumnarEventFrame, PodArena

KObject = Union[Pod, Namespace, Throttle, ClusterThrottle]


class _ColumnarPodMap:
    """Dict-shaped facade over a :class:`PodArena`: the store's mutation
    code keeps its exact ``self._objects["Pod"]`` surface (contains /
    get / setitem / pop / values), but writes absorb into columns and
    reads materialize full objects lazily — the arena IS the store for
    pods. Only touched under the store lock, like the dicts it
    replaces."""

    __slots__ = ("arena",)

    def __init__(self, arena: PodArena) -> None:
        self.arena = arena

    def __contains__(self, key: str) -> bool:
        return key in self.arena

    def __len__(self) -> int:
        return len(self.arena)

    def __setitem__(self, key: str, pod: Pod) -> None:
        self.arena.absorb(key, pod)

    def get(self, key: str, default=None):
        pod = self.arena.materialize_key(key)
        return pod if pod is not None else default

    def pop(self, key: str, default=None):
        pod = self.arena.materialize_key(key)
        if pod is None:
            return default
        self.arena.free(key)
        return pod

    def keys(self):
        return self.arena.keys()

    def values(self):
        # generator (not a view): both consumers — handler replay and
        # _list's list() — iterate once; a 1M-pod store must not
        # materialize a second full object list just to iterate
        for key in list(self.arena.keys()):
            pod = self.arena.materialize_key(key)
            if pod is not None:
                yield pod


def columnar_default() -> bool:
    """Columnar pods are the default; ``KT_STORE_COLUMNAR=0`` keeps the
    frozen-dict reference path alive (the equivalence-sweep oracle)."""
    return os.environ.get("KT_STORE_COLUMNAR", "1") != "0"


class ConflictError(Exception):
    """Optimistic-concurrency conflict on a status update."""


class NotFoundError(KeyError):
    pass


class EventType(Enum):
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


@dataclass(frozen=True)
class Event:
    type: EventType
    kind: str  # "Pod" | "Namespace" | "Throttle" | "ClusterThrottle"
    obj: KObject
    old_obj: Optional[KObject] = None
    # the resourceVersion assigned by the mutation that produced this event.
    # Under BATCHED dispatch (apply_events / the batched status writes)
    # handlers run after the whole batch has mutated, so reading
    # ``store.latest_resource_version`` inside a handler would report the
    # batch's LAST version for every event — consumers that stamp wire
    # events (the mockserver's watch log) must read this field instead.
    rv: Optional[int] = None


Handler = Callable[[Event], None]


def key_of(kind: str, obj: KObject) -> str:
    """Canonical store/informer cache key for an object of ``kind``."""
    if kind in ("Pod", "Throttle"):
        return f"{obj.namespace}/{obj.name}"
    return obj.name  # Namespace, ClusterThrottle (cluster-scoped)


_key_of = key_of


class Store:
    """Thread-safe store for the four kinds the throttler watches."""

    KINDS = ("Pod", "Namespace", "Throttle", "ClusterThrottle")

    # everything below mutates only under the store lock; dispatch also
    # runs inside it (lock order store -> handler-internal, see _create)
    GUARDED_BY = {
        "_rv": "self._lock",
        "_objects": "self._lock",
        "_versions": "self._lock",
        "_handlers": "self._lock",
        "_batch_listeners": "self._lock",
        "_in_batch_dispatch": "self._lock",
    }

    # statuses written per lock hold by the batched status writers: one
    # hold per drain (the pre-chunking behavior) kept event ingest parked
    # behind a ~250-key write for tens of ms at full scale, which is
    # exactly the flip-publication tail. Chunking bounds any single hold
    # while keeping the per-drain amortization (~chunk× fewer acquires).
    STATUS_WRITE_CHUNK = 64

    def __init__(self, columnar: Optional[bool] = None) -> None:
        self._lock = make_rlock("store")
        self._rv = 0
        # pods live in the columnar arena (interned struct-of-arrays,
        # lazily materialized at the API edge) unless the frozen-dict
        # reference mode is forced — see engine/columnar.py
        self.columnar = columnar_default() if columnar is None else bool(columnar)
        self.pod_arena: Optional[PodArena] = PodArena() if self.columnar else None
        self._objects: Dict[str, Dict[str, KObject]] = {k: {} for k in self.KINDS}
        if self.pod_arena is not None:
            self._objects["Pod"] = _ColumnarPodMap(self.pod_arena)
        self._versions: Dict[str, Dict[str, int]] = {k: {} for k in self.KINDS}
        self._handlers: Dict[str, List[Handler]] = {k: [] for k in self.KINDS}
        # batch-aware subscribers (journal, device mirror, informers, batch
        # watches): each gets ONE ``on_batch(events)`` call per batched
        # mutation with the whole ordered event list, instead of N per-event
        # handler calls — the micro-batch ingest amortization point
        self._batch_listeners: List = []
        # True while apply_events / the batched status write dispatches the
        # batch's events to PER-EVENT handlers; batch-aware components'
        # per-event handlers early-return on it (they already processed the
        # batch in on_batch). Only ever read under the store lock.
        self._in_batch_dispatch = False

    # -- atomic sections ---------------------------------------------------

    @contextmanager
    def atomic(self):
        """Hold the store lock across a multi-read (or read-modify) section.

        Every mutation dispatches its events to listeners UNDER this
        (reentrant) lock, so a section inside ``atomic()`` observes a
        frozen store AND is totally ordered against every listener
        callback — the property resync snapshots need: no event routed
        concurrently can land in a shard queue between the snapshot's
        reads and its enqueue (sharding/front.py resync_shard)."""
        with self._lock:
            yield self

    # -- watch ------------------------------------------------------------

    def add_event_handler(self, kind: str, handler: Handler, replay: bool = True) -> None:
        """Register a handler; with ``replay`` it receives synthetic ADDED
        events for existing objects first (informer cache-sync semantics,
        plugin.go:114-130)."""
        with self._lock:
            self._handlers[kind].append(handler)
            # replay INSIDE the lock (normal dispatch already runs under it):
            # otherwise a concurrent DELETED could reach the handler before
            # the stale replay ADDED, resurrecting a deleted object
            if replay:
                for obj in self._objects[kind].values():
                    handler(Event(EventType.ADDED, kind, obj))

    def remove_event_handler(self, kind: str, handler: Handler) -> None:
        """Unregister a handler (watch-stream stop)."""
        with self._lock:
            try:
                self._handlers[kind].remove(handler)
            except ValueError:
                pass

    def _dispatch_locked(self, event: Event) -> None:
        """Caller holds the store lock (see the NOTE below — dispatch runs
        inside it by design; asserted under KT_LOCK_ASSERT=1)."""
        assert_held(self._lock, "Store._dispatch_locked")
        for handler in list(self._handlers[event.kind]):
            handler(event)

    # -- batch-aware subscription (micro-batched ingest) -------------------

    def add_batch_listener(self, listener) -> None:
        """Register a batch-aware subscriber: ``listener.on_batch(events)``
        runs ONCE per batched mutation (``apply_events`` or the batched
        status writes), under the store lock, after every mutation in the
        batch has landed and BEFORE per-event handlers dispatch. A listener
        whose per-event handlers are subsumed by its batch processing must
        early-return from them while :attr:`in_batch_dispatch` is set."""
        with self._lock:
            self._batch_listeners.append(listener)

    def remove_batch_listener(self, listener) -> None:
        with self._lock:
            try:
                self._batch_listeners.remove(listener)
            except ValueError:
                pass

    @property
    def in_batch_dispatch(self) -> bool:
        """True while per-event handlers are being replayed for a batch a
        batch listener already processed. Handlers are only ever called
        under the store lock (asserted under KT_LOCK_ASSERT=1), so the
        read is coherent."""
        return self._in_batch_dispatch_locked()

    def _in_batch_dispatch_locked(self) -> bool:
        assert_held(self._lock, "Store.in_batch_dispatch")
        return self._in_batch_dispatch

    def _dispatch_batch_locked(self, events: List[Event]) -> None:
        """Batch dispatch: batch listeners first (one call each, whole
        ordered list), then the regular per-event handlers with
        ``in_batch_dispatch`` raised so batch-subsumed handlers skip."""
        assert_held(self._lock, "Store._dispatch_batch_locked")
        if not events:
            return
        frame = None
        for listener in list(self._batch_listeners):
            on_frame = getattr(listener, "on_frame", None)
            if on_frame is not None:
                # columnar batch payload (engine/columnar.py): built once
                # per batch, only when some listener asked for it — flat
                # verb/kind/key/rv/slot columns instead of object events
                if frame is None:
                    frame = ColumnarEventFrame(events, _key_of, self.pod_arena)
                on_frame(frame, events)
            else:
                listener.on_batch(events)
        self._in_batch_dispatch = True
        try:
            for event in events:
                self._dispatch_locked(event)
        finally:
            self._in_batch_dispatch = False

    def apply_events(self, ops: Sequence[Tuple[str, str, object]]) -> List[object]:
        """Apply N mutations under ONE lock acquisition — the micro-batched
        ingest entry point (engine/ingest.py drains its queue into this).

        ``ops`` is an ordered sequence of ``(verb, kind, payload)``:

        - ``("create", kind, obj)`` / ``("update", kind, obj)`` — the exact
          single-op semantics (create raises on exists, update on missing);
        - ``("upsert", kind, obj)`` — create-else-update (the watch-replay
          shape reflectors and journals apply);
        - ``("delete", kind, key)`` — delete by store key (also accepts the
          object for convenience).

        Returns one entry per op: the dispatched :class:`Event` on success
        or the raised exception (per-op failures never abort the batch —
        the events before AND after a bad op still land, so a batch is
        observably a sequence of independent mutations).

        Equivalence contract: for any partition of an op stream into
        batches, the final store contents, assigned resourceVersions, and
        the per-event handler event sequence are identical to applying the
        ops one at a time. What batching changes is only WHEN handlers run
        (after the whole batch mutated, not interleaved per op) and that
        batch listeners get one amortized call per batch."""
        results: List[object] = []
        events: List[Event] = []
        with self._lock:
            for op in ops:
                try:
                    event = self._apply_op_locked(*op)
                except Exception as e:  # noqa: BLE001 — reported per op
                    results.append(e)
                    continue
                events.append(event)
                results.append(event)
            self._dispatch_batch_locked(events)
        return results

    def _apply_op_locked(self, verb: str, kind: str, payload) -> Event:
        assert_held(self._lock, "Store._apply_op_locked")
        if verb == "delete":
            key = payload if isinstance(payload, str) else _key_of(kind, payload)
            return self._delete_locked(kind, key)
        if verb == "create":
            return self._create_locked(kind, payload)
        if verb == "update":
            return self._update_locked(kind, payload)
        if verb == "upsert":
            try:
                return self._create_locked(kind, payload)
            except ValueError:
                return self._update_locked(kind, payload)
        raise ValueError(f"unknown ingest verb {verb!r}")

    # -- generic mutations ------------------------------------------------

    # NOTE: dispatch happens INSIDE the store lock. Releasing before dispatch
    # would let two concurrent mutations of the same key deliver their
    # MODIFIED events in reverse resourceVersion order, leaving mirrors (the
    # device state) stale until the next unrelated event. Handlers are
    # informer-contract cheap (row updates + enqueues) and must never hold
    # their own lock while mutating the store from another thread (lock order
    # is store → handler-internal, established here).

    def _create_locked(self, kind: str, obj: KObject) -> Event:
        assert_held(self._lock, "Store._create_locked")
        key = _key_of(kind, obj)
        if key in self._objects[kind]:
            raise ValueError(f"{kind} {key!r} already exists")
        self._rv += 1
        self._objects[kind][key] = obj
        self._versions[kind][key] = self._rv
        return Event(EventType.ADDED, kind, obj, rv=self._rv)

    def _update_locked(self, kind: str, obj: KObject) -> Event:
        assert_held(self._lock, "Store._update_locked")
        key = _key_of(kind, obj)
        old = self._objects[kind].get(key)
        if old is None:
            raise NotFoundError(f"{kind} {key!r} not found")
        self._rv += 1
        self._objects[kind][key] = obj
        self._versions[kind][key] = self._rv
        return Event(EventType.MODIFIED, kind, obj, old_obj=old, rv=self._rv)

    def _delete_locked(self, kind: str, key: str) -> Event:
        assert_held(self._lock, "Store._delete_locked")
        old = self._objects[kind].pop(key, None)
        if old is None:
            raise NotFoundError(f"{kind} {key!r} not found")
        self._versions[kind].pop(key, None)
        self._rv += 1
        return Event(EventType.DELETED, kind, old, rv=self._rv)

    def _create(self, kind: str, obj: KObject) -> KObject:
        with self._lock:
            self._dispatch_locked(self._create_locked(kind, obj))
        return obj

    def _update(self, kind: str, obj: KObject) -> KObject:
        with self._lock:
            self._dispatch_locked(self._update_locked(kind, obj))
        return obj

    def _delete(self, kind: str, key: str) -> KObject:
        with self._lock:
            event = self._delete_locked(kind, key)
            self._dispatch_locked(event)
        return event.obj

    def materialize_pod(self, pod_key: str) -> Optional[Pod]:
        """Resolver handed to the selector indexes (SelectorIndex.pod_resolver)
        so they stop retaining per-pod objects: rare consumers (general-tier
        selector evaluation, matched_pods) materialize on demand. Takes
        ONLY the arena's leaf lock — callers hold index/devicestate locks,
        and nesting the store lock inside those would invert the
        store→index order."""
        if self.pod_arena is not None:
            return self.pod_arena.materialize_key(pod_key)
        with self._lock:
            return self._objects["Pod"].get(pod_key)

    def _get(self, kind: str, key: str) -> KObject:
        with self._lock:
            obj = self._objects[kind].get(key)
        if obj is None:
            raise NotFoundError(f"{kind} {key!r} not found")
        return obj

    def _list(self, kind: str) -> List[KObject]:
        with self._lock:
            return list(self._objects[kind].values())

    # -- typed convenience ------------------------------------------------

    def create_pod(self, pod: Pod) -> Pod:
        return self._create("Pod", pod)

    def update_pod(self, pod: Pod) -> Pod:
        return self._update("Pod", pod)

    def delete_pod(self, namespace: str, name: str) -> Pod:
        return self._delete("Pod", f"{namespace}/{name}")

    def get_pod(self, namespace: str, name: str) -> Pod:
        return self._get("Pod", f"{namespace}/{name}")

    def list_pods(self, namespace: Optional[str] = None) -> List[Pod]:
        pods = self._list("Pod")
        if namespace is None:
            return pods
        return [p for p in pods if p.namespace == namespace]

    def create_namespace(self, ns: Namespace) -> Namespace:
        return self._create("Namespace", ns)

    def update_namespace(self, ns: Namespace) -> Namespace:
        return self._update("Namespace", ns)

    def delete_namespace(self, name: str) -> Namespace:
        return self._delete("Namespace", name)

    def get_namespace(self, name: str) -> Optional[Namespace]:
        try:
            return self._get("Namespace", name)
        except NotFoundError:
            return None

    def list_namespaces(self) -> List[Namespace]:
        return self._list("Namespace")

    def create_throttle(self, thr: Throttle) -> Throttle:
        return self._create("Throttle", thr)

    def update_throttle(self, thr: Throttle) -> Throttle:
        return self._update("Throttle", thr)

    def delete_throttle(self, namespace: str, name: str) -> Throttle:
        return self._delete("Throttle", f"{namespace}/{name}")

    def get_throttle(self, namespace: str, name: str) -> Throttle:
        return self._get("Throttle", f"{namespace}/{name}")

    def list_throttles(self, namespace: Optional[str] = None) -> List[Throttle]:
        thrs = self._list("Throttle")
        if namespace is None:
            return thrs
        return [t for t in thrs if t.namespace == namespace]

    def create_cluster_throttle(self, thr: ClusterThrottle) -> ClusterThrottle:
        return self._create("ClusterThrottle", thr)

    def update_cluster_throttle(self, thr: ClusterThrottle) -> ClusterThrottle:
        return self._update("ClusterThrottle", thr)

    def delete_cluster_throttle(self, name: str) -> ClusterThrottle:
        return self._delete("ClusterThrottle", name)

    def get_cluster_throttle(self, name: str) -> ClusterThrottle:
        return self._get("ClusterThrottle", name)

    def list_cluster_throttles(self) -> List[ClusterThrottle]:
        return self._list("ClusterThrottle")

    # -- atomic read-modify-write (Patch verbs) ----------------------------

    def mutate(self, kind: str, key: str, fn: Callable[[KObject], KObject]) -> KObject:
        """Apply ``fn(current) -> updated`` atomically under the store lock —
        the server-side-apply analog a JSON merge patch needs: without it,
        two concurrent get→merge→update round trips silently lose one
        write. For Throttle/ClusterThrottle the stored status is preserved
        (status-subresource semantics). ``fn`` must be pure and fast; it
        runs under the store lock."""
        with self._lock:
            current = self._objects[kind].get(key)
            if current is None:
                raise NotFoundError(f"{kind} {key!r} not found")
            updated = fn(current)
            if kind in ("Throttle", "ClusterThrottle"):
                updated = updated.with_status(current.status)
            return self._update(kind, updated)

    # -- main-resource update with status-subresource semantics ------------

    def update_throttle_spec(self, thr: Throttle) -> Throttle:
        """Replace the object but keep the STORED status (the apiserver
        ignores status changes on main-resource writes when the status
        subresource is enabled — throttle_types.go:158 marker). Atomic via
        :meth:`mutate`, so a concurrent ``update_throttle_status`` can never
        be reverted by a stale read."""
        return self.mutate("Throttle", thr.key, lambda _cur: thr)

    def update_cluster_throttle_spec(self, thr: ClusterThrottle) -> ClusterThrottle:
        return self.mutate("ClusterThrottle", thr.name, lambda _cur: thr)

    # -- status subresource (optimistic concurrency) ----------------------

    def update_throttle_status(self, thr: Throttle, expected_version: Optional[int] = None) -> Throttle:
        """UpdateStatus: replace only the status of the stored object. With
        ``expected_version``, conflicts raise (the caller re-reads, like a
        client-go retry-on-conflict loop)."""
        key = thr.key
        with self._lock:
            current = self._objects["Throttle"].get(key)
            if current is None:
                raise NotFoundError(f"Throttle {key!r} not found")
            if expected_version is not None and self._versions["Throttle"][key] != expected_version:
                raise ConflictError(f"Throttle {key!r} version changed")
            updated = current.with_status(thr.status)
            self._rv += 1
            self._objects["Throttle"][key] = updated
            self._versions["Throttle"][key] = self._rv
            self._dispatch_locked(
                Event(EventType.MODIFIED, "Throttle", updated, old_obj=current, rv=self._rv)
            )
        return updated

    def _update_statuses_locked(self, kind: str, thrs) -> Dict[str, object]:
        """Batched UpdateStatus under ONE lock hold: at reconcile-drain
        saturation, per-key writes made every status contend with the
        event-ingest threads for this lock ~hundreds of times per drain;
        one hold writes the whole drain's worth. Dispatch is BATCHED
        (``_dispatch_batch_locked``): batch listeners — the journal's group
        commit, the device mirror's one-hold echo pass — get the drain's
        events in one call; per-event handlers still see every event in
        resourceVersion order. Returns {key: updated object | Exception} —
        per-key failures don't fail the batch."""
        out: Dict[str, object] = {}
        thrs = list(thrs)
        chunk = max(1, int(self.STATUS_WRITE_CHUNK))
        for s in range(0, len(thrs), chunk):
            events: List[Event] = []
            with self._lock:
                for thr in thrs[s : s + chunk]:
                    key = _key_of(kind, thr)
                    try:
                        current = self._objects[kind].get(key)
                        if current is None:
                            raise NotFoundError(f"{kind} {key!r} not found")
                        updated = current.with_status(thr.status)
                        self._rv += 1
                        self._objects[kind][key] = updated
                        self._versions[kind][key] = self._rv
                        events.append(
                            Event(
                                EventType.MODIFIED, kind, updated,
                                old_obj=current, rv=self._rv,
                            )
                        )
                        out[key] = updated
                    except Exception as e:  # noqa: BLE001 — reported per key
                        out[key] = e
                self._dispatch_batch_locked(events)
        return out

    def update_throttle_statuses(self, thrs) -> Dict[str, object]:
        """Batch form of update_throttle_status (no optimistic-concurrency
        arg: the reconcile loop re-reads on requeue anyway)."""
        return self._update_statuses_locked("Throttle", thrs)

    def update_cluster_throttle_statuses(self, thrs) -> Dict[str, object]:
        return self._update_statuses_locked("ClusterThrottle", thrs)

    def update_cluster_throttle_status(
        self, thr: ClusterThrottle, expected_version: Optional[int] = None
    ) -> ClusterThrottle:
        key = thr.name
        with self._lock:
            current = self._objects["ClusterThrottle"].get(key)
            if current is None:
                raise NotFoundError(f"ClusterThrottle {key!r} not found")
            if expected_version is not None and self._versions["ClusterThrottle"][key] != expected_version:
                raise ConflictError(f"ClusterThrottle {key!r} version changed")
            updated = current.with_status(thr.status)
            self._rv += 1
            self._objects["ClusterThrottle"][key] = updated
            self._versions["ClusterThrottle"][key] = self._rv
            self._dispatch_locked(
                Event(
                    EventType.MODIFIED, "ClusterThrottle", updated,
                    old_obj=current, rv=self._rv,
                )
            )
        return updated

    def resource_version(self, kind: str, key: str) -> int:
        with self._lock:
            return self._versions[kind][key]

    def advance_resource_version_to(self, rv: int) -> None:
        """Raise the global resourceVersion floor (never lowers it).
        Snapshot restore uses this so recovered state keeps pre-crash RV
        continuity — post-recovery writes must never reuse a version an
        old client already observed."""
        with self._lock:
            if rv > self._rv:
                self._rv = int(rv)

    @property
    def latest_resource_version(self) -> int:
        """The highest resourceVersion assigned so far (the list RV a
        wire-protocol LIST response reports). Inside an event handler this is
        exactly the dispatching event's RV — dispatch runs under the store
        lock right after the bump."""
        with self._lock:
            return self._rv
