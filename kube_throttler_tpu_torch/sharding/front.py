"""The thin admission front over N shared-nothing keyspace shards.

The front owns three things and no controllers:

1. **The merged object view** — a plain :class:`Store` holding every
   object. Specs/pods flow IN through it (any mutation is routed); the
   shards' controllers stream status writes BACK into it (flips first,
   from their two-lane pipelines), so the HTTP surface and the bench
   read one coherent view.
2. **The routing index** — a :class:`SelectorIndex` per kind, the same
   incremental match structure the shards run, used only to answer
   "which shards' throttles can this pod match". Ownership is the
   consistent-hash ring over selector-affinity route keys (ring.py);
   the front records the owner per throttle key.
3. **Scatter-gather admission** — ``pre_filter`` fans out to the
   matching shards and AND-merges shard-local verdicts: a pod may match
   throttles in several shards, and any-shard-throttled ⇒ unschedulable,
   so the merge needs no cross-shard transaction. Reservations DO span
   shards, so ``reserve`` is two-phase: prepare on every matching shard,
   commit/abort from the front; a prepared transaction orphaned by a
   front crash is reaped shard-side (worker.ShardCore.reap_stale_txns).
   Gang groups hash by group id — the group's authoritative ledger
   record lives on exactly one shard — while member reservations ride
   the same two-phase fan-out.

Routing rules (Router, a store batch listener):

- Namespace events broadcast to every shard (rare, verdict-critical);
- Throttle/ClusterThrottle SPEC changes route to the owner shard
  (status-only writes are the shards' own echoes and are not routed);
  an owner change (selector edit) migrates the object and replays its
  matching pods to the new owner;
- Pod events route to the union of shards owning a matching throttle —
  plus a DELETE to shards the pod just stopped mattering to, so no
  shard ever aggregates a stale pod. Pods matching nothing live only in
  the front's store.

Degraded mode: a dead shard makes the front FAIL-SAFE — pods that match
its keyspace report unschedulable (reason ``shard[unavailable]=...``),
health reports degraded, and every event meant for it marks the shard
dirty; the supervisor's restart triggers a full resync (replay + prune)
after which the shard's controllers recompute and re-push every status,
so no flip is lost.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ..api.pod import Namespace, Pod, accel_class_of
from ..engine.index import SelectorIndex
from ..engine.store import Event, EventType, NotFoundError, Store, key_of
from ..health import Health
from ..metrics import Registry
from ..plugin.framework import Status, StatusCode
from ..utils.lockorder import guard_attrs, make_lock
from ..utils.tracing import PhaseTracer, vlog
from .ipc import ShardUnavailable
from .ring import (
    HashRing,
    RangeMove,
    TransitionRouting,
    route_key_for,
    stable_hash64,
)

logger = logging.getLogger(__name__)

_KINDS = ("Throttle", "ClusterThrottle")


@guard_attrs
class AdmissionFront:
    """Scatter-gather admission front over ``n_shards`` workers.

    Implements the plugin surface the HTTP server and the scheduler
    speak (``pre_filter`` / ``pre_filter_batch`` / ``reserve`` /
    ``unreserve`` / gang ops / ``health``), so ``cli.py --shards N``
    drops it in where the single-process ``KubeThrottler`` goes.
    """

    # routing maps move only under the route lock (the Router runs under
    # the store lock and takes it; readers take it alone)
    GUARDED_BY = {
        "_owner": "self._route_lock",
        "_pod_routes": "self._route_lock",
        "_route_hash": "self._route_lock",
        "_mirror": "self._route_lock",
        "_transition": "self._route_lock",
        "_gang_routes": "self._txn_lock",
        "_txn_seq": "self._txn_lock",
        "route_misses": "self._route_lock",
        "two_phase_aborts": "self._txn_lock",
        "_epochs": "self._route_lock",
        "_global_epoch": "self._route_lock",
    }

    def __init__(
        self,
        n_shards: int,
        store: Optional[Store] = None,
        metrics_registry: Optional[Registry] = None,
        event_recorder=None,
        faults=None,
        name: str = "kube-throttler",
        rpc_deadline: float = 30.0,
        rpc_deadlines: Optional[Dict[str, float]] = None,
    ):
        self.n_shards = int(n_shards)
        self.name = name
        # per-op RPC deadline budget (--shard-rpc-deadline): every
        # scatter resolves its timeout through deadline_for(op). The
        # batch triage op keeps a wide floor — one device pass over a
        # full shard population legitimately outlives a point RPC
        self.rpc_deadline = float(rpc_deadline)
        self.rpc_deadlines: Dict[str, float] = {
            "pre_filter_batch": max(120.0, self.rpc_deadline),
        }
        self.rpc_deadlines.update(rpc_deadlines or {})
        self.ring = HashRing(self.n_shards)
        self.store = store if store is not None else Store()
        self.metrics_registry = metrics_registry or Registry()
        self.tracer = PhaseTracer(self.metrics_registry)
        self.event_recorder = event_recorder
        self.faults = faults
        self.device_manager = None  # server.py compatibility (host-side front)
        self.shards: Dict[int, object] = {}  # shard_id -> ShardClient/LocalShard
        self._route_lock = make_lock("shard.front.route")
        self._txn_lock = make_lock("shard.front.txn")
        # (kind, key) -> owning shard id
        self._owner: Dict[Tuple[str, str], int] = {}
        # (kind, key) -> ring position of its route key (reshard range
        # membership without re-fingerprinting the object)
        self._route_hash: Dict[Tuple[str, str], int] = {}
        # live resharding: (kind, key) -> (mirror shard, range index)
        # while the covering range is warming; the dual-ring router for
        # keys first seen mid-transition
        self._mirror: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._transition: Optional[TransitionRouting] = None
        # pod key -> frozenset of shard ids the pod was last routed to
        self._pod_routes: Dict[str, FrozenSet[int]] = {}
        # gang group key -> shard ids holding a prepared reserve
        self._gang_routes: Dict[str, Tuple[int, ...]] = {}
        self._txn_seq = 0
        self.route_misses = 0  # events destined for a down shard
        self.two_phase_aborts = 0  # single-writer per call path; approximate
        # front-side verdict epochs (the scatter-tier mirror of the
        # engine's col_epoch plane, engine/verdictcache.py): one counter
        # per routed throttle key, bumped by every event that can change
        # that key's verdict — spec routes, status echoes/pushes, and the
        # two-phase reservation ops (which mutate shard state without a
        # throttle event). Namespace/reshard/resync mutations bump the
        # global counter. Entries are never popped, even on delete: a
        # re-created key restarting at zero could replay an old epoch sum
        # and falsely validate a pre-delete cache entry (ABA)
        self._epochs: Dict[Tuple[str, str], int] = {}
        self._global_epoch = 0
        # routing index: one SelectorIndex per kind, front-side only. With
        # the columnar merged store the indexes share its intern pool and
        # retain NO pod objects (resolved through the arena below) — this
        # is what kills the front-side copy of the pod population, so
        # full-scale RSS no longer multiplies with shard count
        _arena = getattr(self.store, "pod_arena", None)
        _interner = _arena.pool if _arena is not None else None
        self.index: Dict[str, SelectorIndex] = {
            "Throttle": SelectorIndex("throttle", interner=_interner),
            "ClusterThrottle": SelectorIndex("clusterthrottle", interner=_interner),
        }
        if _arena is not None:
            for idx in self.index.values():
                idx.pod_resolver = self.store.materialize_pod
        # interned-verdict cache over the scatter path: a hit skips the
        # whole fan-out (RPC round trips, not just a plane walk). Only
        # available with the columnar store — the request-shape id that
        # keys it lives in the arena's intern pool
        self.verdict_cache = None
        if _arena is not None and os.environ.get("KT_VERDICT_CACHE", "1") != "0":
            from ..engine.verdictcache import VerdictCache

            try:
                capacity = int(os.environ.get("KT_VERDICT_CACHE_SIZE", "65536"))
            except ValueError:
                capacity = 65536  # malformed override must not kill serving
            self.verdict_cache = VerdictCache(capacity=capacity)
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, self.n_shards), thread_name_prefix="front-scatter"
        )
        # typed read surface (server.py parity with the plugin)
        from ..client import Clientset, InformerBundle, Listers, SharedInformerFactory

        self.clientset = Clientset(self.store)
        self.informer_factory = SharedInformerFactory(self.store, resync_period=0.0)
        self.core_informer_factory = SharedInformerFactory(
            self.store, resync_period=0.0
        )
        self.informers = InformerBundle(
            self.informer_factory, self.core_informer_factory
        )
        self.listers = Listers.from_factories(
            self.informer_factory, self.core_informer_factory
        )
        self.informer_factory.start()
        self.core_informer_factory.start()
        # metrics (families registered in metrics.METRIC_NAMES)
        from ..metrics import register_shard_metrics

        m = register_shard_metrics(self.metrics_registry, self)
        self._m_scatter = m["scatter"]
        self._m_aborts = m["aborts"]
        self._m_misses = m["misses"]
        from ..metrics import register_net_metrics

        # kube_throttler_net_* families: transport health per shard,
        # sampled from the handles at scrape (TCP fleets; zeros locally)
        self.net_metrics = register_net_metrics(self.metrics_registry, self)
        from ..metrics import register_reshard_metrics

        # kube_throttler_reshard_* families: the gauge samples
        # reshard_state() at scrape; the coordinator drives the counters
        # and the cutover histogram through this dict
        self.reshard_metrics = register_reshard_metrics(self.metrics_registry, self)
        from ..metrics import register_build_metrics

        # kube_throttler_build_info + version-mismatch counter: this
        # build's identity plus the per-shard negotiated proto/caps,
        # sampled from the handles at scrape (rolling-upgrade telemetry)
        register_build_metrics(self.metrics_registry, role="front", front=self)
        from ..metrics import register_shm_metrics

        # kube_throttler_shm_* families: zero-copy event-ring health per
        # shard, sampled from each handle's lane at scrape (zeros when
        # the fleet runs plain pickle)
        register_shm_metrics(self.metrics_registry, self)
        self.health = Health()
        self.health.register("shards", self._shards_health)
        # the Router: batch listener + per-event handlers on the store
        # (dispatch order: handlers registered here run for every event;
        # batch-applied events reach _on_batch once, then the per-event
        # handlers skip while in_batch_dispatch is set)
        self.store.add_batch_listener(self)
        for kind in ("Pod", "Namespace", "Throttle", "ClusterThrottle"):
            self.store.add_event_handler(kind, self._on_event, replay=False)

    # ----------------------------------------------------------- shard admin

    def attach_shard(self, shard_id: int, handle, resync: bool = False) -> None:
        """Register (or replace, after a restart) a shard handle. With
        ``resync`` the shard is replayed its full keyspace slice first."""
        self.shards[shard_id] = handle
        # a (re)attached shard serves from replayed state: cached verdicts
        # computed against its predecessor must not validate
        self._bump_global_epoch()
        if resync:
            self.resync_shard(shard_id)

    def owner_of(self, kind: str, key: str) -> Optional[int]:
        """The shard owning a throttle key (None = not yet routed)."""
        with self._route_lock:
            return self._owner.get((kind, key))

    def _alive(self, shard_id: int):
        handle = self.shards.get(shard_id)
        return handle if handle is not None and handle.alive else None

    def _shards_health(self):
        detail = {}
        down = 0
        for sid in range(self.n_shards):
            handle = self.shards.get(sid)
            state = "ok"
            refused = (
                getattr(handle, "version_refused", None)
                if handle is not None else None
            )
            if refused:
                # the worker refused our protocol MAJOR (version.py): a
                # deliberate, typed condition an operator fixes by
                # upgrading one side — named here so /healthz says WHY
                # the shard is dark instead of looking like a partition
                down += 1
                state = f"version-mismatch: {refused}"
            elif handle is None or not handle.alive:
                down += 1
                state = "down"
                if handle is not None and getattr(handle, "transport", "") == "tcp":
                    # connection lost ≠ process died: the TCP client is
                    # reconnecting on its own — the supervisor must NOT
                    # spuriously restart a partitioned remote worker
                    state = "disconnected"
            elif handle.is_dirty():
                state = "degraded"
            detail[f"shard-{sid}"] = state
        if down == self.n_shards and self.n_shards > 0:
            return "down", detail
        if down or any(v == "degraded" for v in detail.values()):
            return "degraded", detail
        return "ok", detail

    # ------------------------------------------------- verdict-cache epochs

    def _bump_key_epoch(self, kind: str, key: str) -> None:
        with self._route_lock:
            self._epochs[(kind, key)] = self._epochs.get((kind, key), 0) + 1

    def _bump_global_epoch(self) -> None:
        with self._route_lock:
            self._global_epoch += 1

    def _bump_pod_epochs(self, pod: Pod) -> None:
        """Bump every throttle key the pod matches — the reservation ops
        change shard-side reserved amounts without any throttle event
        flowing through the Router, so they invalidate here explicitly."""
        with self._route_lock:
            for kind in _KINDS:
                for key in self.index[kind].affected_throttle_keys_for(pod):
                    self._epochs[(kind, key)] = self._epochs.get((kind, key), 0) + 1

    def _verdict_fingerprint(self, pod: Pod):
        """(cache key, epoch sum) for a pod, or None when uncacheable
        (no arena, or a live reshard is re-pointing owners). The key is
        (request-shape id, accel class, matched throttle keys); the sum
        covers exactly those keys plus the global counter, so monotonic
        bumps make equality prove nothing relevant changed (the same
        argument as DeviceStateManager.verdict_fingerprint)."""
        arena = getattr(self.store, "pod_arena", None)
        if arena is None:
            return None
        if pod.__dict__.get("_kt_arena") is arena.token:
            sid = pod.__dict__["_kt_req_sid"]
        else:
            sid = arena.request_shape_id(pod.spec)
        accel = accel_class_of(pod)
        matched: List[Tuple[str, str]] = []
        with self._route_lock:
            if self._transition is not None:
                return None
            esum = self._global_epoch
            for kind in _KINDS:
                for key in sorted(self.index[kind].affected_throttle_keys_for(pod)):
                    matched.append((kind, key))
                    esum += self._epochs.get((kind, key), 0)
        return (sid, accel, tuple(matched)), esum

    @staticmethod
    def _front_cacheable(status: Status) -> bool:
        """ERROR verdicts, fail-safe shard-down verdicts, and exceeds
        verdicts (which emit a Warning event per call — a hit would
        swallow the emission) never enter the cache."""
        if status.code is StatusCode.ERROR:
            return False
        return not any(
            "[pod-requests-exceeds-threshold]" in r
            or r.startswith("shard[unavailable]")
            for r in status.reasons
        )

    # ------------------------------------------------------ routing (Router)

    def on_batch(self, events: List[Event]) -> None:
        """Store batch listener: route the whole ordered batch, one
        per-shard buffer flush at the end."""
        buffers: Dict[int, list] = {}
        for event in events:
            self._route_event(event, buffers)
        self._flush_buffers(buffers)

    def _on_event(self, event: Event) -> None:
        if self.store.in_batch_dispatch:
            return  # already routed by on_batch
        buffers: Dict[int, list] = {}
        self._route_event(event, buffers)
        self._flush_buffers(buffers)

    def _flush_buffers(self, buffers: Dict[int, list]) -> None:
        if len(buffers) > 1:
            self._dedup_fanout(buffers)
        for sid, ops in buffers.items():
            handle = self._alive(sid)
            if handle is None:
                with self._route_lock:
                    self.route_misses += len(ops)
                self._m_misses.inc({}, float(len(ops)))
                handle = self.shards.get(sid)
                if handle is not None:
                    handle.mark_dirty()
                continue
            handle.enqueue_ops(ops)

    @staticmethod
    def _dedup_fanout(buffers: Dict[int, list]) -> None:
        """Fan-out dedup: an op payload routed to N shards used to be
        pickled N times, once per shard batch. Wrap any payload object
        that lands in two or more shard buffers in one shared
        :class:`~.ipc.PrepickledPayload` so the pickle fallback
        serializes it ONCE and splices the cached bytes into every
        shard's frame (``__reduce__`` replays them; the shm encoder
        just unwraps ``.obj`` and pays nothing)."""
        from .ipc import PrepickledPayload

        seen_in: Dict[int, set] = {}
        first: Dict[int, object] = {}
        for sid, ops in buffers.items():
            for op in ops:
                payload = op[2]
                if isinstance(payload, str) or getattr(
                    payload, "_kt_prepickled", False
                ):
                    continue
                seen_in.setdefault(id(payload), set()).add(sid)
                first[id(payload)] = payload
        shared = {
            pid: PrepickledPayload(first[pid])
            for pid, sids in seen_in.items()
            if len(sids) >= 2
        }
        if not shared:
            return
        for ops in buffers.values():
            for i, op in enumerate(ops):
                wrapped = shared.get(id(op[2]))
                if wrapped is not None:
                    ops[i] = (op[0], op[1], wrapped)

    def _route_event(self, event: Event, buffers: Dict[int, list]) -> None:
        kind = event.kind
        if kind == "Namespace":
            self._route_namespace(event, buffers)
        elif kind in _KINDS:
            self._route_throttle(event, buffers)
        elif kind == "Pod":
            self._route_pod(event, buffers)

    def _route_namespace(self, event: Event, buffers) -> None:
        ns: Namespace = event.obj
        # namespace changes alter selector matching (and the unknown-ns
        # ERROR verdict) for arbitrary pods: global invalidation
        self._bump_global_epoch()
        if event.type is EventType.DELETED:
            for idx in self.index.values():
                idx.remove_namespace(ns.name)
            op = ("delete", "Namespace", ns.name)
        else:
            for idx in self.index.values():
                idx.upsert_namespace(ns)
            op = ("upsert", "Namespace", ns)
        for sid in range(self.n_shards):
            buffers.setdefault(sid, []).append(op)

    def _route_throttle(self, event: Event, buffers) -> None:
        kind, thr = event.kind, event.obj
        # ownership/index key is thr.key (what affected_throttle_keys_for
        # answers: "ns/name", or "/name" for ClusterThrottle); store ops
        # use the store key (no leading slash)
        key = thr.key
        store_key = key_of(kind, thr)
        idx = self.index[kind]
        # EVERY throttle event — spec route, delete, or a shard's status
        # echo/push streaming back — can change this key's verdict
        # (status flips carry the active/insufficient transitions), so
        # every path through here bumps its epoch
        self._bump_key_epoch(kind, key)
        if event.type is EventType.DELETED:
            with self._route_lock:
                owner = self._owner.pop((kind, key), None)
                self._route_hash.pop((kind, key), None)
                mirror = self._mirror.pop((kind, key), None)
            idx.remove_throttle(key)
            if owner is not None:
                buffers.setdefault(owner, []).append(("delete", kind, store_key))
            if mirror is not None:
                buffers.setdefault(mirror[0], []).append(("delete", kind, store_key))
            return
        spec_changed = (
            event.type is EventType.ADDED
            or event.old_obj is None
            or event.old_obj.spec != thr.spec
        )
        if not spec_changed:
            # a status write — either this shard's own echo streaming back
            # or a local write; the owner computes statuses, don't route
            idx.refresh_throttle_object(thr)
            return
        h = stable_hash64(route_key_for(kind, thr))
        with self._route_lock:
            tr = self._transition
            if tr is None:
                owner, move = self.ring.owner_of_hash(h), None
            else:
                owner, move = tr.owner_of_hash(h), tr.mirror_of_hash(h)
            prev = self._owner.get((kind, key))
            self._owner[(kind, key)] = owner
            self._route_hash[(kind, key)] = h
            if move is not None:
                self._mirror[(kind, key)] = (move.dst, move.index)
            else:
                self._mirror.pop((kind, key), None)
        idx.upsert_throttle(thr)
        if prev is not None and prev != owner:
            # selector edit moved the key: migrate object + matching pods
            buffers.setdefault(prev, []).append(("delete", kind, store_key))
        targets = [owner] if move is None else [owner, move.dst]
        for sid in targets:
            buffers.setdefault(sid, []).append(("upsert", kind, thr))
        # the (new) owner — and a warming mirror — must hold every pod this
        # throttle matches; send the ones not already routed there (set-
        # difference via the route map keeps this O(matched), no full scan)
        matched = idx.matched_pod_keys(key)
        if matched:
            pods_needed: Dict[str, List[int]] = {}
            with self._route_lock:
                for pkey in matched:
                    routes = self._pod_routes.get(pkey, frozenset())
                    missing = [sid for sid in targets if sid not in routes]
                    if missing:
                        self._pod_routes[pkey] = routes | set(missing)
                        pods_needed[pkey] = missing
            for pkey, sids in pods_needed.items():
                ns, _, pname = pkey.partition("/")
                try:
                    pod = self.store.get_pod(ns, pname)
                except NotFoundError:
                    continue
                for sid in sids:
                    buffers.setdefault(sid, []).append(("upsert", "Pod", pod))

    def _pod_target_shards(self, pod: Pod) -> Set[int]:
        """Shards owning at least one throttle (of either kind) whose
        selector matches the pod — the AUTHORITATIVE scatter set for
        verdicts. During a live reshard a warming mirror is deliberately
        absent here: its verdicts are advisory until the range cuts over."""
        targets: Set[int] = set()
        with self._route_lock:
            for kind in _KINDS:
                for key in self.index[kind].affected_throttle_keys_for(pod):
                    owner = self._owner.get((kind, key))
                    if owner is not None:
                        targets.add(owner)
        return targets

    def _pod_mirror_shards(self, pod: Pod) -> Set[int]:
        """Warming destinations holding a mirrored copy of a matching
        throttle — the double-route extension for events and the reserve
        fan-out (a reservation made only on the source during warm-up
        would be missing from the destination at cutover)."""
        mirrors: Set[int] = set()
        with self._route_lock:
            if not self._mirror:
                return mirrors
            for kind in _KINDS:
                for key in self.index[kind].affected_throttle_keys_for(pod):
                    m = self._mirror.get((kind, key))
                    if m is not None:
                        mirrors.add(m[0])
        return mirrors

    def _route_pod(self, event: Event, buffers) -> None:
        pod: Pod = event.obj
        for idx in self.index.values():
            if event.type is EventType.DELETED:
                idx.remove_pod(pod.key)
            else:
                idx.upsert_pod(pod)
        if event.type is EventType.DELETED:
            with self._route_lock:
                routes = self._pod_routes.pop(pod.key, frozenset())
            for sid in routes:
                buffers.setdefault(sid, []).append(("delete", "Pod", pod.key))
            return
        new_set = frozenset(
            self._pod_target_shards(pod) | self._pod_mirror_shards(pod)
        )
        with self._route_lock:
            old_set = self._pod_routes.get(pod.key, frozenset())
            if new_set:
                self._pod_routes[pod.key] = new_set
            else:
                self._pod_routes.pop(pod.key, None)
        for sid in new_set:
            buffers.setdefault(sid, []).append(("upsert", "Pod", pod))
        for sid in old_set - new_set:
            # the pod stopped matching anything on sid: a delete keeps that
            # shard's store/aggregates clean (equivalent to updating it —
            # a non-matching pod contributes nothing — but O(1) forever)
            buffers.setdefault(sid, []).append(("delete", "Pod", pod.key))

    # ------------------------------------------------------- status upstream

    def apply_status_push(self, shard_id: int, items) -> None:
        """Shard → front status stream: replace ONLY the status of the
        front's stored object (status-subresource semantics) so an echo
        in flight can never revert a newer routed spec. Keys the front no
        longer holds (concurrent delete) are skipped per key. The
        resulting MODIFIED events are spec-unchanged by construction, so
        the Router does not route them back (no echo loop)."""
        thrs = [obj for kind, obj in items if kind == "Throttle"]
        cthrs = [obj for kind, obj in items if kind == "ClusterThrottle"]
        if thrs:
            self.store.update_throttle_statuses(thrs)
        if cthrs:
            self.store.update_cluster_throttle_statuses(cthrs)

    # ----------------------------------------------------------- scatter RPC

    def deadline_for(self, op: str) -> float:
        """The per-op RPC deadline budget for a scatter call."""
        return self.rpc_deadlines.get(op, self.rpc_deadline)

    def _scatter(
        self, targets: Sequence[int], op: str, payload,
        timeout: Optional[float] = None,
    ):
        """Fan an RPC out to ``targets``; returns {shard_id: result}.
        Shard failures surface as the exception object in the map.
        ``timeout=None`` resolves through the per-op deadline budget."""
        if timeout is None:
            timeout = self.deadline_for(op)
        t0 = time.monotonic()
        targets = list(targets)

        def call(sid: int):
            handle = self._alive(sid)
            if handle is None:
                return ShardUnavailable(f"shard {sid} is down")
            try:
                return handle.request(op, payload, timeout=timeout)
            except Exception as e:  # noqa: BLE001 — merged by the caller
                return e
        if len(targets) == 1:
            out = {targets[0]: call(targets[0])}
        else:
            futs = {sid: self._pool.submit(call, sid) for sid in targets}
            out = {sid: f.result() for sid, f in futs.items()}
        self._m_scatter.observe_key((op,), time.monotonic() - t0)
        return out

    # ------------------------------------------------------------ pre_filter

    def pre_filter(self, pod: Pod) -> Status:
        with self.tracer.trace("prefilter"):
            return self._pre_filter(pod)

    def _pre_filter(self, pod: Pod) -> Status:
        # the single-process ClusterThrottle check errors on a pod whose
        # Namespace object is unknown (clusterthrottle_controller.go:273-
        # 276) before anything else can answer — replicate it centrally
        # so a pod matching zero shards still gets the identical verdict
        if self.store.get_namespace(pod.namespace) is None:
            return Status(
                StatusCode.ERROR,
                (str(NotFoundError(f"namespace {pod.namespace!r} not found")),),
            )
        targets = sorted(self._pod_target_shards(pod))
        if not targets:
            vlog(5, "pod %s is not throttled by any throttle/clusterthrottle (0 shards)", pod.key)
            return Status(StatusCode.SUCCESS)
        # interned-verdict probe: a hit skips the whole scatter. Gated on
        # every target shard being alive and clean — a cached SUCCESS must
        # not outlive the fail-safe discipline (shard death bumps no
        # epoch), and a dirty shard's answers are stale until resync
        cache = self.verdict_cache
        fp = None
        if cache is not None:
            for s in targets:
                handle = self._alive(s)
                if handle is None or handle.is_dirty():
                    break
            else:
                fp = self._verdict_fingerprint(pod)
        if fp is not None:
            hit = cache.get(fp[0], fp[1])
            if hit is not None:
                return hit
        results = self._scatter(targets, "pre_filter", pod)
        down = sorted(
            sid for sid, r in results.items() if isinstance(r, ShardUnavailable)
        )
        if down:
            # FAIL-SAFE degradation: this pod's keyspace is dark — report
            # unschedulable rather than fabricate an admission
            return Status(
                StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE,
                tuple(f"shard[unavailable]=shard-{sid}" for sid in down),
            )
        errors: List[str] = []
        merged = {
            "throttle": {"active": set(), "insufficient": set(), "exceeds": set()},
            "clusterthrottle": {
                "active": set(), "insufficient": set(), "exceeds": set()
            },
        }
        for sid, r in sorted(results.items()):
            if isinstance(r, Exception):
                errors.append(str(r))
                continue
            for kind, cats in r.items():
                if "error" in cats:
                    errors.append(cats["error"])
                    continue
                for cat, keys in cats.items():
                    merged[kind][cat].update(keys)
        if errors:
            return Status(StatusCode.ERROR, tuple(sorted(set(errors))))
        status = self._compose_status(pod, merged)
        if (
            fp is not None
            and self._front_cacheable(status)
            # validate-after-compute: a mutation that raced the scatter
            # bumped an epoch, so the re-read sum differs and the insert
            # is suppressed instead of poisoning the cache
            and self._verdict_fingerprint(pod) == fp
        ):
            cache.put(fp[0], fp[1], status)
        return status

    def _compose_status(self, pod: Pod, merged) -> Status:
        """Reason composition in the exact plugin.go:182-214 order, from
        the AND-merged shard verdicts. Name lists are sorted — the
        single-process ordering is index-column order, which no longer
        exists across shards; verdict equivalence is pinned on sorted
        name sets (tools/harness.normalized_reasons)."""
        thr, clthr = merged["throttle"], merged["clusterthrottle"]
        if not any(thr.values()) and not any(clthr.values()):
            vlog(5, "pod %s is not throttled by any throttle/clusterthrottle", pod.key)
            return Status(StatusCode.SUCCESS)
        reasons: List[str] = []
        if clthr["exceeds"]:
            reasons.append(
                "clusterthrottle[pod-requests-exceeds-threshold]="
                + ",".join(sorted(clthr["exceeds"]))
            )
        if thr["exceeds"]:
            reasons.append(
                "throttle[pod-requests-exceeds-threshold]="
                + ",".join(sorted(thr["exceeds"]))
            )
        if (clthr["exceeds"] or thr["exceeds"]) and self.event_recorder is not None:
            names = sorted(clthr["exceeds"]) + sorted(thr["exceeds"])
            self.event_recorder.eventf(
                pod.key,
                "Warning",
                "ResourceRequestsExceedsThrottleThreshold",
                self.name,
                "It won't be scheduled unless decreasing resource requests or "
                "increasing ClusterThrottle/Throttle threshold because its "
                f"resource requests exceeds their thresholds: {','.join(names)}",
            )
        if clthr["active"]:
            reasons.append(
                "clusterthrottle[active]=" + ",".join(sorted(clthr["active"]))
            )
        if thr["active"]:
            reasons.append("throttle[active]=" + ",".join(sorted(thr["active"])))
        if clthr["insufficient"]:
            reasons.append(
                "clusterthrottle[insufficient]="
                + ",".join(sorted(clthr["insufficient"]))
            )
        if thr["insufficient"]:
            reasons.append(
                "throttle[insufficient]=" + ",".join(sorted(thr["insufficient"]))
            )
        vlog(2, "pod %s is unschedulable: %s", pod.key, "; ".join(reasons))
        return Status(StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE, tuple(reasons))

    def pre_filter_batch(self) -> dict:
        """Bulk triage, sharded: every shard classifies its own pods in
        one local device pass; the front ANDs verdicts per pod across the
        shards that carry it and fills in the pods no shard holds (they
        match nothing ⇒ schedulable, unless their namespace is unknown —
        the identical never-schedulable routing the single-process merge
        applies)."""
        with self.tracer.trace("prefilter_batch"):
            alive = [s for s in range(self.n_shards) if self._alive(s) is not None]
            results = self._scatter(alive, "pre_filter_batch", None)
            # during a live reshard the AND-merge must consult only each
            # pod's AUTHORITATIVE owners: a warming mirror's verdict is
            # advisory (it may lag the source), and a dead mirror must not
            # fail-safe pods whose owners are healthy
            owner_filter: Optional[Dict[str, Set[int]]] = None
            with self._route_lock:
                transition_active = self._transition is not None
            if transition_active:
                owner_filter = {
                    pod.key: self._pod_target_shards(pod)
                    for pod in self.store.list_pods()
                }
            schedulable: Dict[str, bool] = {}
            errors: Set[str] = set()
            for sid in sorted(results):
                r = results[sid]
                if isinstance(r, Exception):
                    continue  # its routed pods are handled as down below
                for key, ok in r["schedulable"].items():
                    if (
                        owner_filter is not None
                        and sid not in owner_filter.get(key, frozenset())
                    ):
                        continue
                    schedulable[key] = schedulable.get(key, True) and bool(ok)
                errors.update(r["errors"])
            # pods routed to a shard that answered nothing are dark: fail
            # safe, like the per-pod surface
            dead = {
                sid
                for sid in range(self.n_shards)
                if sid not in results or isinstance(results.get(sid), Exception)
            }
            if dead:
                if owner_filter is not None:
                    for pkey, sids in owner_filter.items():
                        if sids & dead:
                            schedulable[pkey] = False
                else:
                    with self._route_lock:
                        routes = dict(self._pod_routes)
                    for pkey, sids in routes.items():
                        if sids & dead:
                            schedulable[pkey] = False
            known_ns = {ns.name for ns in self.store.list_namespaces()}
            for pod in self.store.list_pods():
                if pod.key not in schedulable and pod.key not in errors:
                    schedulable[pod.key] = True
            bad = [k for k in schedulable if k.partition("/")[0] not in known_ns]
            for key in bad:
                del schedulable[key]
                errors.add(key)
            return {"schedulable": schedulable, "errors": sorted(errors)}

    # --------------------------------------------------- two-phase reserve

    def _next_txn(self) -> str:
        with self._txn_lock:
            self._txn_seq += 1
            return f"front-txn-{self._txn_seq}"

    def reserve(self, pod: Pod, node: str = "") -> Status:
        """Two-phase reserve: prepare on every matching shard, commit (or
        abort) from the front. Any prepare failure aborts the prepared
        subset — no cross-shard transaction, no partial reserve."""
        with self.tracer.trace("reserve"):
            # mirrors ride the two-phase fan-out: a reserve prepared only
            # on the source during a handoff would be missing from the
            # destination at cutover (a lost reservation, not an orphan)
            targets = sorted(
                self._pod_target_shards(pod) | self._pod_mirror_shards(pod)
            )
            if not targets:
                return Status(StatusCode.SUCCESS)
            txn = self._next_txn()
            results = self._scatter(targets, "reserve_prepare", {"txn": txn, "pod": pod})
            failed = {sid: r for sid, r in results.items() if isinstance(r, Exception)}
            if failed:
                # abort EVERY target, not just the ones that answered ok:
                # a prepare that TIMED OUT may still have landed (the
                # deadline is the front's clock, not the shard's) — only
                # an abort addressed to all of them guarantees zero
                # orphans now rather than after the shard's TTL reaper.
                # Shards that never saw the prepare no-op the abort
                self._scatter(targets, "txn_abort", {"txn": txn})
                with self._txn_lock:
                    self.two_phase_aborts += 1
                self._m_aborts.inc({})
                # the abort rolled prepared shards back, but bump anyway:
                # invalidating a still-valid entry costs one recompute;
                # missing a real change costs a wrong verdict
                self._bump_pod_epochs(pod)
                return Status(
                    StatusCode.ERROR,
                    tuple(
                        f"Failed to reserve pod={pod.key} on shard {sid}: {e}"
                        for sid, e in sorted(failed.items())
                    ),
                )
            self._scatter(targets, "txn_commit", {"txn": txn})
            self._bump_pod_epochs(pod)
            return Status(StatusCode.SUCCESS)

    def unreserve(self, pod: Pod, node: str = "") -> None:
        with self.tracer.trace("unreserve"):
            targets = sorted(
                self._pod_target_shards(pod) | self._pod_mirror_shards(pod)
            )
            results = self._scatter(targets, "unreserve", pod)
            for sid, r in results.items():
                if isinstance(r, Exception):
                    logger.warning("unreserve of %s on shard %d failed: %s",
                                   pod.key, sid, r)
            self._bump_pod_epochs(pod)

    # -------------------------------------------------------- gang admission

    def _gang_targets(self, group_key: str, pods: Sequence[Pod]) -> List[int]:
        """Shards touched by a gang: every member-matching shard PLUS the
        group's hash owner — the one shard whose ledger holds the
        authoritative group record (journal GANG stamps, TTL clock)."""
        targets: Set[int] = set()
        for pod in pods:
            targets |= self._pod_target_shards(pod)
            targets |= self._pod_mirror_shards(pod)
        targets.add(self.gang_owner(group_key))
        mirror = self._gang_mirror(group_key)
        if mirror is not None:
            targets.add(mirror)
        return sorted(targets)

    def gang_owner(self, group_key: str) -> int:
        h = stable_hash64(route_key_for("Gang", group_key))
        with self._route_lock:
            tr = self._transition
        if tr is not None:
            return tr.owner_of_hash(h)
        return self.ring.owner_of_hash(h)

    def _gang_mirror(self, group_key: str) -> Optional[int]:
        h = stable_hash64(route_key_for("Gang", group_key))
        with self._route_lock:
            tr = self._transition
        if tr is not None:
            move = tr.mirror_of_hash(h)
            if move is not None:
                return move.dst
        return None

    def pre_filter_gang(self, group_key: str, pods: Sequence[Pod]) -> Status:
        """Group feasibility scatter-gather. Feasibility partitions by
        throttle (a group fits iff it fits under every matched throttle),
        so shard-local gang checks AND-merge exactly like pre_filter."""
        with self.tracer.trace("prefilter_gang"):
            if not pods:
                return Status(StatusCode.SUCCESS)
            targets = [
                sid for sid in sorted(set().union(
                    *(self._pod_target_shards(p) for p in pods)
                ))
            ]
            if not targets:
                return Status(StatusCode.SUCCESS)
            results = self._scatter(
                targets, "gang_check", {"group": group_key, "pods": list(pods)}
            )
            reasons: List[str] = []
            errors: List[str] = []
            for sid in sorted(results):
                r = results[sid]
                if isinstance(r, ShardUnavailable):
                    reasons.append(f"shard[unavailable]=shard-{sid}")
                elif isinstance(r, Exception):
                    errors.append(str(r))
                elif r["code"] == StatusCode.ERROR.value:
                    errors.extend(r["reasons"])
                elif r["code"] != StatusCode.SUCCESS.value:
                    reasons.extend(r["reasons"])
            if errors:
                return Status(StatusCode.ERROR, tuple(sorted(set(errors))))
            if reasons:
                return Status(
                    StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE,
                    tuple(sorted(set(reasons))),
                )
            return Status(StatusCode.SUCCESS)

    def reserve_gang(self, group_key: str, pods: Sequence[Pod]) -> Status:
        """Two-phase gang reserve: each target shard performs its local
        all-or-nothing ``reserve_gang`` (its own ledger rolls back its own
        members on local failure); the front aborts every prepared shard
        if ANY prepare fails, so the group is reserved everywhere or
        nowhere."""
        with self.tracer.trace("reserve_gang"):
            targets = self._gang_targets(group_key, pods)
            owner = self.gang_owner(group_key)
            txn = self._next_txn()
            results = {}
            for sid in targets:
                r = self._scatter(
                    [sid], "gang_prepare",
                    {
                        "txn": txn, "group": group_key, "pods": list(pods),
                        "owner": sid == owner,
                    },
                )
                results.update(r)
            failed = {sid: r for sid, r in results.items() if isinstance(r, Exception)}
            if failed:
                # same zero-orphan discipline as reserve(): a timed-out
                # gang_prepare may have landed — abort ALL targets
                self._scatter(targets, "txn_abort", {"txn": txn})
                with self._txn_lock:
                    self.two_phase_aborts += 1
                self._m_aborts.inc({})
                for p in pods:
                    self._bump_pod_epochs(p)
                return Status(
                    StatusCode.ERROR,
                    tuple(
                        f"gang {group_key}: prepare failed on shard {sid}: {e}"
                        for sid, e in sorted(failed.items())
                    ),
                )
            self._scatter(targets, "txn_commit", {"txn": txn})
            with self._txn_lock:
                self._gang_routes[group_key] = tuple(targets)
            for p in pods:
                self._bump_pod_epochs(p)
            return Status(StatusCode.SUCCESS)

    def unreserve_gang(self, group_key: str) -> None:
        with self.tracer.trace("unreserve_gang"):
            with self._txn_lock:
                targets = self._gang_routes.pop(group_key, None)
            if targets is None:
                targets = [
                    sid for sid in range(self.n_shards)
                    if self._alive(sid) is not None
                ]
            self._scatter(list(targets), "gang_rollback", {"group": group_key})
            # the rolled-back members are unknown here (the ledger lives
            # shard-side): global invalidation
            self._bump_global_epoch()

    # ------------------------------------------------------ live resharding
    # (driven by sharding/reshard.ReshardCoordinator; every mutation of
    # the routing maps happens under the route lock, so a cutover is
    # atomic with respect to the Router and the scatter target builders)

    def begin_reshard(self, transition: TransitionRouting) -> None:
        """Install the dual-ring transition router. From here until
        ``finish_reshard``/``cancel_reshard``, new keys route through it
        (old-ring owner until the covering range cuts over)."""
        with self._route_lock:
            self._transition = transition
            # every reshard phase bumps the global verdict epoch inline
            # (already under the route lock): cached verdicts predate the
            # ownership moves and must not validate across them
            self._global_epoch += 1

    def begin_range(self, move: RangeMove) -> int:
        """Turn double-routing ON for one moving range: every owned key
        whose route hash the range covers gains a mirror entry, and keys
        first seen from now on mirror via the transition router. Returns
        the number of keys mirrored."""
        n = 0
        with self._route_lock:
            if self._transition is not None:
                self._transition.set_state(move.index, TransitionRouting.MIRRORING)
            for (kind, key), h in self._route_hash.items():
                if move.covers(h):
                    self._mirror[(kind, key)] = (move.dst, move.index)
                    n += 1
        return n

    def cutover_range(self, move: RangeMove) -> int:
        """The atomic per-range cutover: re-point every mirrored key's
        owner at the destination and drop its mirror entry, all under one
        route-lock hold — no event, check, or reserve can observe a
        half-cut range. Returns keys re-pointed."""
        n = 0
        with self._route_lock:
            if self._transition is not None:
                self._transition.set_state(move.index, TransitionRouting.CUT)
            for (kind, key), (dst, ridx) in list(self._mirror.items()):
                if ridx == move.index:
                    self._owner[(kind, key)] = dst
                    del self._mirror[(kind, key)]
                    n += 1
            self._global_epoch += 1
        return n

    def abort_range(self, move: RangeMove) -> int:
        """Abort-back-to-source: drop the range's mirror entries (owners
        were never re-pointed) and return the range to ``pending`` so a
        later attempt can re-stream it."""
        n = 0
        with self._route_lock:
            if self._transition is not None:
                self._transition.set_state(move.index, TransitionRouting.PENDING)
            for (kind, key), (_dst, ridx) in list(self._mirror.items()):
                if ridx == move.index:
                    del self._mirror[(kind, key)]
                    n += 1
        return n

    def finish_reshard(self, new_ring: HashRing, n_shards: int) -> None:
        """Adopt the target ring as THE ring (every range cut over) and
        drop the transition router."""
        with self._route_lock:
            self.ring = new_ring
            self._transition = None
            self._mirror.clear()
            self._global_epoch += 1
        self.n_shards = int(n_shards)

    def cancel_reshard(self) -> None:
        """Abandon a reshard whose every range was aborted: the old ring
        stays authoritative (owners were never re-pointed)."""
        with self._route_lock:
            self._transition = None
            self._mirror.clear()
            self._global_epoch += 1

    def reshard_state(self) -> Optional[Dict[str, object]]:
        with self._route_lock:
            tr = self._transition
            mirrored = len(self._mirror)
        if tr is None:
            return None
        states = list(tr.state.values())
        return {
            "moves": len(states),
            "pending": states.count(TransitionRouting.PENDING),
            "mirroring": states.count(TransitionRouting.MIRRORING),
            "cut": states.count(TransitionRouting.CUT),
            "mirrored_keys": mirrored,
            "target_shards": tr.new_ring.n_shards,
        }

    # ------------------------------------------------------- resync / drain

    def resync_shard(self, shard_id: int) -> int:
        """Replay a (restarted) shard's full keyspace slice: namespaces,
        owned throttles, their matching pods, then a prune of everything
        the replay did not name. Returns ops sent. The shard's controllers
        recompute every status from the replayed state and push the
        results back — flips the dead worker never published re-derive."""
        handle = self.shards.get(shard_id)
        if handle is None:
            return 0
        bump = getattr(handle, "bump_epoch", None)
        if bump is not None:
            # fence the past before replaying the present: frames from
            # before the heal (a partitioned peer's view, bytes parked in
            # a kernel buffer) must be refused once this resync lands
            bump()
        # store.atomic(): snapshot reads and the enqueue must be ATOMIC
        # w.r.t. dispatch — mutations dispatch (and _flush_buffers
        # enqueues) under the store lock, so holding it here means no
        # live event can land in the shard queue between this snapshot's
        # reads and its enqueue. Without it, an event routed while we
        # iterate sits BEFORE the (older) snapshot in the queue and the
        # worker keeps the stale object forever.
        with self.store.atomic():
            n = self._resync_locked(shard_id, handle)
        # the healed shard recomputes everything from the replay; cached
        # verdicts from before the heal must not validate
        self._bump_global_epoch()
        return n

    def _resync_locked(self, shard_id: int, handle) -> int:
        ops: List[tuple] = []
        want: Dict[str, List[str]] = {
            "Namespace": [], "Throttle": [], "ClusterThrottle": [], "Pod": [],
        }
        for ns in self.store.list_namespaces():
            ops.append(("upsert", "Namespace", ns))
            want["Namespace"].append(ns.name)
        with self._route_lock:
            owned = [
                (kind, key) for (kind, key), sid in self._owner.items()
                if sid == shard_id
            ]
            pod_keys = [
                pkey for pkey, sids in self._pod_routes.items() if shard_id in sids
            ]
        for kind, key in owned:
            try:
                if kind == "Throttle":
                    ns, _, nm = key.partition("/")
                    obj = self.store.get_throttle(ns, nm)
                else:
                    obj = self.store.get_cluster_throttle(key.lstrip("/"))
            except NotFoundError:
                continue
            ops.append(("upsert", kind, obj))
            # the prune set compares STORE keys on the shard
            want[kind].append(key_of(kind, obj))
        for pkey in pod_keys:
            ns, _, nm = pkey.partition("/")
            try:
                pod = self.store.get_pod(ns, nm)
            except NotFoundError:
                continue
            ops.append(("upsert", "Pod", pod))
            want["Pod"].append(pkey)
        from .worker import RESYNC_PRUNE

        ops.append((RESYNC_PRUNE, "", want))
        handle.enqueue_ops(ops)
        handle.clear_dirty()
        logger.info("resynced shard %d: %d ops", shard_id, len(ops))
        return len(ops)

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every alive shard has applied everything routed to
        it and its workqueues are empty (the bench's applied-not-submitted
        accounting point)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            busy = False
            for sid in range(self.n_shards):
                handle = self._alive(sid)
                if handle is None:
                    continue
                if handle.pending_events() > 0:
                    busy = True
                    continue
                try:
                    d = handle.request("drain", {"timeout": 2.0}, timeout=30.0)
                except (ShardUnavailable, RuntimeError):
                    continue
                if d["queue"] > 0 or any(v > 0 for v in d["workqueues"].values()):
                    busy = True
            if not busy:
                return True
            time.sleep(0.02)
        return False

    def stats(self) -> dict:
        """Front + per-shard aggregate (the bench and /readyz detail)."""
        shards = {}
        for sid in range(self.n_shards):
            handle = self._alive(sid)
            if handle is None:
                shards[sid] = {"alive": False}
                continue
            try:
                s = handle.request("stats", None, timeout=10.0)
            except (ShardUnavailable, RuntimeError) as e:
                shards[sid] = {"alive": False, "error": str(e)}
                continue
            s["alive"] = True
            s["events_sent"] = handle.events_sent
            s["dropped_at_front"] = handle.dropped
            s["transport"] = getattr(handle, "transport", "socketpair")
            s["reconnects"] = getattr(handle, "reconnects", 0)
            s["rpc_deadline_exceeded"] = getattr(handle, "deadline_exceeded", 0)
            shards[sid] = s
        with self._route_lock:
            misses = self.route_misses
            routed_pods = len(self._pod_routes)
            owned = len(self._owner)
        with self._txn_lock:
            aborts = self.two_phase_aborts
        return {
            "shards": shards,
            "route_misses": misses,
            "routed_pods": routed_pods,
            "owned_throttles": owned,
            "two_phase_aborts": aborts,
            "reshard": self.reshard_state(),
        }

    # ------------------------------------------------------------- lifecycle

    def full_tick_sharded(self, n_devices=None, shape=None) -> dict:
        raise RuntimeError(
            "full_tick_sharded is a single-process device surface; the "
            "multiprocess front serves pre_filter_batch instead"
        )

    def run_pending_once(self) -> int:
        """Drain helper parity with the plugin (tests): waits for shard
        queues/workqueues instead of running local controllers."""
        self.drain(timeout=30.0)
        return 0

    def start(self) -> None:  # the workers already run their controllers
        return None

    def stop(self) -> None:
        for handle in self.shards.values():
            try:
                handle.close()
            except Exception:  # noqa: BLE001
                pass
        self._pool.shutdown(wait=False)
        self.informer_factory.shutdown()
        self.core_informer_factory.shutdown()
