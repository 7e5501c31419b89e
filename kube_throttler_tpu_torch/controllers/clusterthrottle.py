"""ClusterThrottleController — cluster-scoped twin (reference
clusterthrottle_controller.go).

Differences from ThrottleController, all mirrored from the reference:

- selector terms AND a namespaceSelector (affected_pods iterates matched
  namespaces — clusterthrottle_controller.go:224-270);
- ``affected_cluster_throttles`` requires the pod's Namespace object; a
  missing namespace is an error, not a silent no-match (273-276);
- ``check_throttled`` passes the caller's onEqual through to step 3 of the
  4-state check (via ClusterThrottle.check_throttled_for —
  clusterthrottle_types.go:45);
- the reference watches the namespace informer with NO handlers
  (clusterthrottle_controller.go:429) and relies on the 5-minute informer
  resync (plugin.go:77) to eventually repair statuses after a namespace
  relabel. This build diverges DELIBERATELY: ``_on_namespace_event``
  enqueues every responsible ClusterThrottle whose namespaceSelector match
  flipped, so ``status.used`` converges immediately instead of within 5
  minutes; the periodic resync (ControllerBase.resync_interval) remains the
  backstop.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ..api.pod import Pod
from ..api.types import (
    ClusterThrottle,
    ResourceAmount,
    ThrottleStatus,
    resource_amount_of_pod,
)
from ..engine.devicestate import DeviceStateManager
from ..engine.reservations import ReservedResourceAmounts
from ..engine.store import Event, EventType, NotFoundError, Store
from ..utils.clock import Clock
from .base import ControllerBase

logger = logging.getLogger(__name__)


class ClusterThrottleController(ControllerBase):
    KIND = "clusterthrottle"

    def __init__(
        self,
        throttler_name: str,
        target_scheduler_name: str,
        store: Store,
        clock: Optional[Clock] = None,
        threadiness: int = 1,
        num_key_mutex: int = 128,
        device_manager: Optional[DeviceStateManager] = None,
        metrics_recorder=None,
        resync_interval=None,
        listers=None,
        informers=None,
        status_writer=None,
        reservation_ttl=None,
    ):
        """See ThrottleController.__init__ for the listers / informers /
        status_writer contract (plugin.go:76-88 composition)."""
        super().__init__(
            name="ClusterThrottleController",
            target_kind="ClusterThrottle",
            throttler_name=throttler_name,
            target_scheduler_name=target_scheduler_name,
            clock=clock,
            threadiness=threadiness,
            resync_interval=resync_interval,
        )
        self.store = store
        self.listers = listers
        self.informers = informers
        self.status_writer = status_writer if status_writer is not None else store
        # reservation ledger shares the controller clock so TTL expiry is
        # deterministic under FakeClock tests and rebases correctly on
        # crash recovery (engine/recovery.py)
        self.cache = ReservedResourceAmounts(num_key_mutex, clock=self.clock)
        self.reservation_ttl = reservation_ttl
        # gang ledger (engine/gang.py), wired by the plugin — see
        # ThrottleController.gang_ledger
        self.gang_ledger = None
        self.device_manager = device_manager
        self.metrics_recorder = metrics_recorder
        self.reconcile_func = self.reconcile
        self.reconcile_batch_func = self.reconcile_batch
        self.list_keys_func = self._list_responsible_keys
        self._setup_event_handlers()

    # ------------------------------------------------------------- data reads
    # (lister-backed when wired, plugin.go:76-88; store fallback otherwise)

    def _get_cluster_throttle(self, name: str) -> ClusterThrottle:
        if self.listers is not None:
            try:
                return self.listers.cluster_throttles.get(name)
            except KeyError:
                raise NotFoundError(f"ClusterThrottle {name!r} not found")
        return self.store.get_cluster_throttle(name)

    def _list_cluster_throttles(self) -> List[ClusterThrottle]:
        if self.listers is not None:
            return self.listers.cluster_throttles.list()
        return self.store.list_cluster_throttles()

    def _get_namespace(self, name: str):
        if self.listers is not None:
            try:
                return self.listers.namespaces.get(name)
            except KeyError:
                return None
        return self.store.get_namespace(name)

    def _list_namespaces(self):
        if self.listers is not None:
            return self.listers.namespaces.list()
        return self.store.list_namespaces()

    def _list_pods(self, namespace: str) -> List[Pod]:
        if self.listers is not None:
            return self.listers.pods.pods(namespace).list()
        return self.store.list_pods(namespace)

    def _list_responsible_keys(self) -> List[str]:
        return [
            t.key for t in self._list_cluster_throttles() if self.is_responsible_for(t)
        ]

    def is_responsible_for(self, thr: ClusterThrottle) -> bool:
        return self.throttler_name == thr.spec.throttler_name

    def should_count_in(self, pod: Pod) -> bool:
        return (
            pod.spec.scheduler_name == self.target_scheduler_name and pod.is_scheduled()
        )

    # ------------------------------------------------------------- reconcile

    def reconcile(self, key: str) -> None:
        errors = self.reconcile_batch([key])
        if errors:
            raise errors[key]

    def reconcile_batch(self, keys: List[str]) -> Dict[str, Exception]:
        """Batched twin of ThrottleController.reconcile_batch: one device
        flush+gather of the used-aggregates serves the whole drained batch."""
        now = self.clock.now()
        thrs: Dict[str, ClusterThrottle] = {}
        for key in dict.fromkeys(keys):
            try:
                thrs[key] = self._get_cluster_throttle(key.lstrip("/"))
            except NotFoundError:
                pass
        if not thrs:
            return {}
        errors: Dict[str, Exception] = {}
        used_map = None
        flips: dict = {}
        dm = self.device_manager
        if dm is not None:
            # on breaker-open/failure reconcile falls to the host walk
            # below (the mask read is host-side); statuses keep converging
            reserved = {
                t.key: self.cache.reserved_pod_keys(t.key) for t in thrs.values()
            }
            used_map = dm.guarded(
                "reconcile",
                dm.aggregate_used_for,
                self.KIND,
                [t.key for t in thrs.values()],
                reserved,
                flips_out=flips,
            )
        promote = flips.get("promote")
        if promote:
            # classification-delta flips outside this drain: queue-front
            # promotion, policy-weighted (see ThrottleController.
            # reconcile_batch)
            self.workqueue.add_all_priority(
                promote, priorities=self.flip_priorities(promote)
            )
        drained_flips = flips.get("drained", frozenset())
        # three-phase drain, mirroring ThrottleController.reconcile_batch:
        # compute → one batched status write → per-key post-write work
        plans = []  # (key, thr, new_thr | None, unreserve_list)
        flip_keys = set()
        for key, thr in thrs.items():
            try:
                if used_map is not None:
                    used, unreserve_pods = used_map[thr.key]
                else:
                    non_terminated, terminated = self.affected_pods(thr)
                    used = ResourceAmount()
                    for p in non_terminated:
                        used = used.add(resource_amount_of_pod(p))
                    unreserve_pods = non_terminated + terminated
                new_status = self._planned_status(thr, used, now)
                new_thr = (
                    thr.with_status(new_status)
                    if new_status != thr.status
                    else None
                )
                if new_thr is not None and (
                    thr.key in drained_flips
                    or new_status.calculated_threshold
                    is not thr.status.calculated_threshold
                    or (
                        used_map is None
                        and new_status.throttled != thr.status.throttled
                    )
                ):
                    flip_keys.add(key)
                plans.append((key, thr, new_thr, unreserve_pods))
            except Exception as e:
                errors[key] = e
        self._commit_reconcile_plans(plans, now, errors, flip_keys=flip_keys)
        return errors

    # lane-aware batch writer method (AsyncStatusCommitter duck type)
    _prioritized_batch_attr = "update_cluster_throttle_statuses_prioritized"

    def _write_status(self, thr: ClusterThrottle) -> None:
        self.status_writer.update_cluster_throttle_status(thr)

    def _batch_write_statuses(self, thrs):
        batch = getattr(
            self.status_writer, "update_cluster_throttle_statuses", None
        )
        return None if batch is None else batch(thrs)

    @staticmethod
    def _store_key(thr: ClusterThrottle) -> str:
        # the store keys ClusterThrottles by bare name; the workqueue key
        # is mapped back by the base commit helper
        return thr.name

    def _planned_status(
        self, thr: ClusterThrottle, used: ResourceAmount, now
    ) -> ThrottleStatus:
        calculated = thr.spec.calculate_threshold(now)
        new_calculated = thr.status.calculated_threshold
        if (
            thr.status.calculated_threshold.threshold != calculated.threshold
            or thr.status.calculated_threshold.messages != calculated.messages
        ):
            new_calculated = calculated
        throttled = new_calculated.threshold.is_throttled(used, True)
        return ThrottleStatus(
            calculated_threshold=new_calculated, throttled=throttled, used=used
        )


    # ----------------------------------------------------------- collections

    def affected_pods(self, thr: ClusterThrottle) -> Tuple[List[Pod], List[Pod]]:
        non_terminated: List[Pod] = []
        terminated: List[Pod] = []
        if self.device_manager is not None:
            # the mask column already ANDs podSelector ∧ namespaceSelector ∧
            # namespace-existence (clusterthrottle_selector.go:112-141)
            pods = self.device_manager.matched_pods(self.KIND, thr.key)
        else:
            ns_map = {}
            pods = []
            for ns in self._list_namespaces():
                if not thr.spec.selector.matches_to_namespace(ns):
                    continue
                ns_map[ns.name] = ns
                pods.extend(self._list_pods(ns.name))
            pods = [
                p
                for p in pods
                if thr.spec.selector.matches_to_pod(p, ns_map[p.namespace])
            ]
        for pod in pods:
            if not self.should_count_in(pod):
                continue
            if pod.is_not_finished():
                non_terminated.append(pod)
            else:
                terminated.append(pod)
        return non_terminated, terminated

    def throttle_by_key(self, key: str) -> ClusterThrottle:
        # cluster keys carry the NamespacedName leading "/" (api/types.py)
        return self._get_cluster_throttle(key.lstrip("/"))

    def affected_cluster_throttle_keys(self, pod: Pod) -> List[str]:
        ns = self._get_namespace(pod.namespace)
        if ns is None:
            # Go: lister Get error propagates (clusterthrottle_controller.go:273-276)
            raise NotFoundError(f"namespace {pod.namespace!r} not found")
        if self.device_manager is not None:
            return self.device_manager.affected_throttle_keys(self.KIND, pod)
        return [t.key for t in self._scan_cluster_throttles(pod, ns)]

    def affected_cluster_throttles(self, pod: Pod) -> List[ClusterThrottle]:
        ns = self._get_namespace(pod.namespace)
        if ns is None:
            # Go: lister Get error propagates (clusterthrottle_controller.go:273-276)
            raise NotFoundError(f"namespace {pod.namespace!r} not found")
        if self.device_manager is not None:
            affected = []
            for key in self.device_manager.affected_throttle_keys(self.KIND, pod):
                try:
                    thr = self._get_cluster_throttle(key.lstrip("/"))
                except NotFoundError:
                    continue
                if self.is_responsible_for(thr):
                    affected.append(thr)
            return affected
        return self._scan_cluster_throttles(pod, ns)

    # kind-agnostic alias: the gang oracle (engine/gang.py
    # sequential_gang_check) and other cross-kind walkers iterate both
    # controllers through one method name
    def affected_throttles(self, pod: Pod) -> List[ClusterThrottle]:
        return self.affected_cluster_throttles(pod)

    def _scan_cluster_throttles(self, pod: Pod, ns) -> List[ClusterThrottle]:
        affected = []
        for thr in self._list_cluster_throttles():
            if not self.is_responsible_for(thr):
                continue
            if thr.spec.selector.matches_to_pod(pod, ns):
                affected.append(thr)
        return affected

    # ----------------------------------------------------------- reservation

    def reserve(self, pod: Pod) -> None:
        for thr in self.affected_cluster_throttles(pod):
            self.reserve_on_throttle(pod, thr)

    def reserve_on_throttle(self, pod: Pod, thr: ClusterThrottle) -> bool:
        added = self.cache.add_pod(thr.key, pod, ttl=self.reservation_ttl)
        if added and self.device_manager is not None:
            self.device_manager.on_reservation_change(self.KIND, thr.key, self.cache)
        return added

    def unreserve(self, pod: Pod) -> None:
        for thr in self.affected_cluster_throttles(pod):
            self.unreserve_on_throttle(pod, thr)

    def unreserve_on_throttle(self, pod: Pod, thr: ClusterThrottle) -> bool:
        removed = self.cache.remove_pod(thr.key, pod)
        if removed and self.device_manager is not None:
            self.device_manager.on_reservation_change(self.KIND, thr.key, self.cache)
        if removed and self.gang_ledger is not None:
            self.gang_ledger.note_unreserved(self.KIND, thr.key, pod.key)
        return removed

    # ----------------------------------------------------------------- check

    def check_throttled(
        self, pod: Pod, is_throttled_on_equal: bool
    ) -> Tuple[
        List[ClusterThrottle], List[ClusterThrottle], List[ClusterThrottle], List[ClusterThrottle]
    ]:
        from ..api.pod import accel_class_of

        accel = accel_class_of(pod)
        dm = self.device_manager
        if dm is not None and not (accel and dm.has_accel_thresholds(self.KIND)):
            # the missing-namespace error contract holds on the device path
            # too (clusterthrottle_controller.go:273-276); with the breaker
            # open the host path below enforces it itself
            if dm.device_available() and self._get_namespace(pod.namespace) is None:
                raise NotFoundError(f"namespace {pod.namespace!r} not found")
            results = dm.guarded("check", dm.check_pod, pod, self.KIND, is_throttled_on_equal)
            if results is not None:
                return self.classify_from_map(results)
        throttles = self.affected_cluster_throttles(pod)
        active: List[ClusterThrottle] = []
        insufficient: List[ClusterThrottle] = []
        exceeds: List[ClusterThrottle] = []
        for thr in throttles:
            reserved, _ = self.cache.reserved_resource_amount(thr.key)
            status = thr.check_throttled_for(
                pod, reserved, is_throttled_on_equal, accel_class=accel
            )
            if status == "active":
                active.append(thr)
            elif status == "insufficient":
                insufficient.append(thr)
            elif status == "pod-requests-exceeds-threshold":
                exceeds.append(thr)
        return active, insufficient, exceeds, throttles

    def classify_from_map(self, results: Dict[str, str]):
        """See ThrottleController.classify_from_map (cluster keys carry no
        namespace prefix; same bulk resolution + skip-deleted semantics)."""
        active, insufficient, exceeds, affected = [], [], [], []
        if self.listers is not None:
            objs = self.listers.cluster_throttles.get_by_names(
                [key.lstrip("/") for key in results]
            )
        else:
            objs = []
            for key in results:
                try:
                    objs.append(self.store.get_cluster_throttle(key.lstrip("/")))
                except NotFoundError:
                    objs.append(None)
        for (key, status), thr in zip(results.items(), objs):
            if thr is None:
                continue
            affected.append(thr)
            if status == "active":
                active.append(thr)
            elif status == "insufficient":
                insufficient.append(thr)
            elif status == "pod-requests-exceeds-threshold":
                exceeds.append(thr)
        return active, insufficient, exceeds, affected

    # ---------------------------------------------------------- event wiring

    def _setup_event_handlers(self) -> None:
        # The reference watches namespaces with NO handlers
        # (clusterthrottle_controller.go:429) and leans on the 5-min informer
        # resync; here a namespace event whose selector match flips enqueues
        # the affected clusterthrottles directly (no replay: preexisting
        # namespaces carry no pending status change).
        from .base import _BatchEventHandler

        if self.informers is not None:
            self.informers.cluster_throttles().add_event_handler(
                _BatchEventHandler(self._on_throttle_event, self._on_throttle_events)
            )
            self.informers.pods().add_event_handler(
                _BatchEventHandler(self._on_pod_event, self._on_pod_events)
            )
            self.informers.namespaces().add_event_handler(
                self._on_namespace_event, replay=False
            )
        else:
            self.store.add_event_handler("ClusterThrottle", self._on_throttle_event)
            self.store.add_event_handler("Pod", self._on_pod_event)
            self.store.add_event_handler(
                "Namespace", self._on_namespace_event, replay=False
            )

    def _on_namespace_event(self, event: Event) -> None:
        """Enqueue responsible clusterthrottles whose namespaceSelector match
        for this namespace changed. A relabel that un-matches a selector
        flips many device-mask rows at once (devicestate._on_namespace); this
        is the enqueue that makes the flipped aggregate land in status —
        without it, ``status.used`` stays wrong until a pod event or resync.

        A namespace label change affects all pods of the namespace uniformly
        within one selector term (the term is namespaceSelector ∧
        podSelector, clusterthrottle_selector.go:112-141), so membership can
        only change when some TERM's namespace-side match flips. The check
        must be per-term, not on the OR-aggregate: a relabel that moves the
        namespace from term A to term B keeps the aggregate True on both
        sides while the counted pod set (term A's podSelector vs term B's)
        changes completely.
        """
        old_ns = event.old_obj if event.type == EventType.MODIFIED else (
            event.obj if event.type == EventType.DELETED else None
        )
        new_ns = event.obj if event.type != EventType.DELETED else None
        for thr in self._list_cluster_throttles():
            if not self.is_responsible_for(thr):
                continue
            for term in thr.spec.selector.selector_terms:
                old_match = old_ns is not None and term.matches_to_namespace(old_ns)
                new_match = new_ns is not None and term.matches_to_namespace(new_ns)
                if old_match != new_match:
                    self.enqueue(thr.key)
                    break

    def _throttle_event_key(self, event: Event) -> Optional[str]:
        thr = event.obj
        if not self.is_responsible_for(thr):
            return None
        if self._is_self_status_echo(event):
            return None  # our own in-flight status write; reconciling it is a no-op
        return thr.key

    def _on_throttle_event(self, event: Event) -> None:
        key = self._throttle_event_key(event)
        if key is not None:
            self.enqueue(key)

    def _on_throttle_events(self, events) -> None:
        keys = [k for k in map(self._throttle_event_key, events) if k is not None]
        if keys:
            self.enqueue_all(keys)

    def _pod_event_keys(self, event: Event):
        """Per-event pod handling with the enqueue keys RETURNED (see
        ThrottleController._pod_event_keys — the batch fan-out unions a
        whole ingest burst into one workqueue lock hold)."""
        if event.type == EventType.ADDED:
            pod = event.obj
            if not self.should_count_in(pod):
                return None
            return self._affected_keys_or_log(pod)
        elif event.type == EventType.MODIFIED:
            old_pod, new_pod = event.old_obj, event.obj
            if not self.should_count_in(old_pod) and not self.should_count_in(new_pod):
                return None
            if self._selector_inputs_unchanged(old_pod, new_pod):
                return self._affected_keys_or_log(new_pod)
            try:
                old_keys = set(self.affected_cluster_throttle_keys(old_pod))
                new_keys = set(self.affected_cluster_throttle_keys(new_pod))
            except NotFoundError:
                logger.exception("failed to get affected clusterthrottles for %s", new_pod.key)
                return None
            moved_from = old_keys - new_keys
            moved_to = new_keys - old_keys
            if moved_from or moved_to:
                self.cache.move_throttle_assignment(new_pod, moved_from, moved_to)
                if self.device_manager is not None:
                    for key in moved_from | moved_to:
                        self.device_manager.on_reservation_change(self.KIND, key, self.cache)
            return old_keys | new_keys
        else:  # DELETED
            pod = event.obj
            if not self.should_count_in(pod):
                return None
            if pod.is_scheduled():
                try:
                    self.unreserve(pod)
                except Exception:
                    logger.exception("failed to unreserve deleted pod %s", pod.key)
            return self._affected_keys_or_log(pod)

    def _on_pod_event(self, event: Event) -> None:
        keys = self._pod_event_keys(event)
        if keys:
            self.enqueue_all(keys)

    def _on_pod_events(self, events) -> None:
        union: set = set()
        for event in events:
            keys = self._pod_event_keys(event)
            if keys:
                union.update(keys)
        if union:
            self.enqueue_all(union)

    def _affected_keys_or_log(self, pod: Pod) -> List[str]:
        try:
            return self.affected_cluster_throttle_keys(pod)
        except NotFoundError:
            logger.exception("failed to get affected clusterthrottles for %s", pod.key)
            return []
