"""ThrottleController — namespaced reconciler (reference
throttle_controller.go).

Responsibilities, mirroring the Go controller one-for-one:

- ``reconcile(key)``          (throttle_controller.go:84-211)
- ``affected_pods``           (221-246; the terminated-slice append bug at
                               241 is deliberately FIXED here)
- ``affected_throttles``      (248-269)
- ``reserve`` / ``unreserve`` (271-347)
- ``check_throttled``         (349-397)
- event handlers incl. the symmetric-difference reservation move on pod
  label changes (400-536)
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ..api.pod import Pod
from ..api.types import (
    CalculatedThreshold,
    ResourceAmount,
    Throttle,
    ThrottleStatus,
    resource_amount_of_pod,
)
from ..engine.devicestate import DeviceStateManager
from ..engine.reservations import ReservedResourceAmounts
from ..engine.store import Event, EventType, NotFoundError, Store
from ..utils.clock import Clock
from .base import ControllerBase

logger = logging.getLogger(__name__)


class ThrottleController(ControllerBase):
    KIND = "throttle"

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
        """``listers`` (client.listers.Listers) routes every read through the
        indexer-backed lister layer and ``informers`` (SharedInformerFactory)
        sources events from shared informers instead of raw store handlers —
        the reference's composition (plugin.go:76-88). Without them the
        controller falls back to direct store access (standalone/unit use).
        ``status_writer`` is where status updates go: the store (default) or
        a RemoteStatusWriter PUTting the real apiserver's status
        subresource (throttle_controller.go:170)."""
        super().__init__(
            name="ThrottleController",
            target_kind="Throttle",
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
        # gang ledger (engine/gang.py), wired by the plugin: the
        # unreserve-on-observe handshake notifies it as members' per-pod
        # reservations release into status.used
        self.gang_ledger = None
        self.device_manager = device_manager
        self.metrics_recorder = metrics_recorder
        self.reconcile_func = self.reconcile
        self.reconcile_batch_func = self.reconcile_batch
        self.list_keys_func = self._list_responsible_keys
        self._setup_event_handlers()

    # ------------------------------------------------------------- data reads
    # (lister-backed when wired, plugin.go:76-88; store fallback otherwise)

    def _get_throttle(self, namespace: str, name: str) -> Throttle:
        if self.listers is not None:
            try:
                return self.listers.throttles.throttles(namespace).get(name)
            except KeyError:
                raise NotFoundError(f"Throttle {namespace}/{name} not found")
        return self.store.get_throttle(namespace, name)

    def _list_throttles(self, namespace: Optional[str] = None) -> List[Throttle]:
        if self.listers is not None:
            if namespace is None:
                return self.listers.throttles.list()
            return self.listers.throttles.throttles(namespace).list()
        return self.store.list_throttles(namespace)

    def _list_pods(self, namespace: str) -> List[Pod]:
        if self.listers is not None:
            # the namespace-indexed pod lister — the very indexer the
            # reference builds its second informer factory for
            # (plugin.go:81-84)
            return self.listers.pods.pods(namespace).list()
        return self.store.list_pods(namespace)

    def _list_responsible_keys(self) -> List[str]:
        return [t.key for t in self._list_throttles() if self.is_responsible_for(t)]

    # ------------------------------------------------------------ predicates

    def is_responsible_for(self, thr: Throttle) -> bool:
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
        """Reconcile a drained batch of keys in three phases: with a device
        manager, ONE flush+gather of the used-aggregates serves every key
        (the streaming data plane — no per-throttle pod scan); all changed
        statuses then land in ONE batched store write (a per-key write
        contends with the event-ingest threads for the store lock hundreds
        of times per drain at saturation); finally the per-key post-write
        work (metrics, unreserve-on-observe, override wakeups) runs for the
        keys whose write — if any — succeeded. Returns failures for
        requeue."""
        now = self.clock.now()
        thrs: Dict[str, Throttle] = {}
        for key in dict.fromkeys(keys):
            namespace, _, name = key.partition("/")
            try:
                thrs[key] = self._get_throttle(namespace, name)
            except NotFoundError:
                pass  # deleted — nothing to do (throttle_controller.go:96-99)
        if not thrs:
            return {}
        errors: Dict[str, Exception] = {}
        used_map = None
        flips: dict = {}
        dm = self.device_manager
        if dm is not None:
            # on breaker-open/failure this batch reconciles via the host
            # walk below (matched_pods reads the host-side mask, no
            # device), so statuses keep converging through a device outage
            reserved = {key: self.cache.reserved_pod_keys(key) for key in thrs}
            used_map = dm.guarded(
                "reconcile", dm.aggregate_used_for, self.KIND, list(thrs),
                reserved, flips_out=flips,
            )
        promote = flips.get("promote")
        if promote:
            # keys OUTSIDE this drain whose published throttled flags
            # disagree with the fresh aggregates (the classification
            # delta): jump them to the queue front so their flip publishes
            # next drain instead of after a full refresh-backlog cycle —
            # policy-weighted (valued accel classes drain first)
            self.workqueue.add_all_priority(
                promote, priorities=self.flip_priorities(promote)
            )
        drained_flips = flips.get("drained", frozenset())
        # phase 1: pure status computation + the unreserve sets
        plans = []  # (key, thr, new_thr | None, unreserve_list)
        flip_keys = set()
        for key, thr in thrs.items():
            try:
                if used_map is not None:
                    used, unreserve_pods = used_map[key]
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
                    # _planned_status reuses the status object when the
                    # calculated threshold is unchanged, so identity is the
                    # zero-cost change check
                    or new_status.calculated_threshold
                    is not thr.status.calculated_threshold
                    # host-walk fallback (breaker open): no classification
                    # delta — fall back to the direct flag compare
                    or (
                        used_map is None
                        and new_status.throttled != thr.status.throttled
                    )
                ):
                    flip_keys.add(key)
                plans.append((key, thr, new_thr, unreserve_pods))
            except Exception as e:
                errors[key] = e
        # phases 2+3: batched write + post-write work (base helper; remote
        # mode interleaves per key so the double-count window stays one PUT)
        self._commit_reconcile_plans(plans, now, errors, flip_keys=flip_keys)
        return errors

    # lane-aware batch writer method (the AsyncStatusCommitter's duck type);
    # resolved by the base commit helper, absent on the plain Store
    _prioritized_batch_attr = "update_throttle_statuses_prioritized"

    def _write_status(self, thr: Throttle) -> None:
        self.status_writer.update_throttle_status(thr)

    def _batch_write_statuses(self, thrs):
        batch = getattr(self.status_writer, "update_throttle_statuses", None)
        return None if batch is None else batch(thrs)

    @staticmethod
    def _store_key(thr: Throttle) -> str:
        return thr.key

    def _planned_status(self, thr: Throttle, used: ResourceAmount, now) -> ThrottleStatus:
        calculated = thr.spec.calculate_threshold(now)
        new_calculated = thr.status.calculated_threshold
        if (
            thr.status.calculated_threshold.threshold != calculated.threshold
            or thr.status.calculated_threshold.messages != calculated.messages
        ):
            # only adopt the fresh calculatedAt when the content changed —
            # otherwise every reconcile would differ by timestamp alone
            # (throttle_controller.go:123-132)
            new_calculated = calculated
        throttled = new_calculated.threshold.is_throttled(used, True)
        return ThrottleStatus(
            calculated_threshold=new_calculated, throttled=throttled, used=used
        )

    # ----------------------------------------------------------- collections

    def affected_pods(self, thr: Throttle) -> Tuple[List[Pod], List[Pod]]:
        non_terminated: List[Pod] = []
        terminated: List[Pod] = []
        if self.device_manager is not None:
            # selector part answered by the incremental mask column — only
            # matched pods are touched, never the whole namespace
            pods = self.device_manager.matched_pods(self.KIND, thr.key)
            pods = [p for p in pods if p.namespace == thr.namespace]
        else:
            pods = [
                p
                for p in self._list_pods(thr.namespace)
                if thr.spec.selector.matches_to_pod(p)
            ]
        for pod in pods:
            if not self.should_count_in(pod):
                continue
            if pod.is_not_finished():
                non_terminated.append(pod)
            else:
                terminated.append(pod)
        return non_terminated, terminated

    def affected_throttle_keys(self, pod: Pod) -> List[str]:
        if self.device_manager is not None:
            return self.device_manager.affected_throttle_keys(self.KIND, pod)
        return [t.key for t in self.affected_throttles(pod)]

    def throttle_by_key(self, key: str) -> Throttle:
        namespace, _, name = key.partition("/")
        return self._get_throttle(namespace, name)

    def affected_throttles(self, pod: Pod) -> List[Throttle]:
        if self.device_manager is not None:
            affected = []
            for key in self.device_manager.affected_throttle_keys(self.KIND, pod):
                namespace, _, name = key.partition("/")
                try:
                    thr = self._get_throttle(namespace, name)
                except NotFoundError:
                    continue
                if self.is_responsible_for(thr):
                    affected.append(thr)
            return affected
        affected = []
        for thr in self._list_throttles(pod.namespace):
            if not self.is_responsible_for(thr):
                continue
            if thr.spec.selector.matches_to_pod(pod):
                affected.append(thr)
        return affected

    # ----------------------------------------------------------- reservation

    def reserve(self, pod: Pod) -> None:
        for thr in self.affected_throttles(pod):
            self.reserve_on_throttle(pod, thr)

    def reserve_on_throttle(self, pod: Pod, thr: Throttle) -> bool:
        added = self.cache.add_pod(thr.key, pod, ttl=self.reservation_ttl)
        if added and self.device_manager is not None:
            self.device_manager.on_reservation_change(self.KIND, thr.key, self.cache)
        return added

    def unreserve(self, pod: Pod) -> None:
        for thr in self.affected_throttles(pod):
            self.unreserve_on_throttle(pod, thr)

    def unreserve_on_throttle(self, pod: Pod, thr: Throttle) -> bool:
        removed = self.cache.remove_pod(thr.key, pod)
        if removed and self.device_manager is not None:
            self.device_manager.on_reservation_change(self.KIND, thr.key, self.cache)
        if removed and self.gang_ledger is not None:
            self.gang_ledger.note_unreserved(self.KIND, thr.key, pod.key)
        return removed

    # ----------------------------------------------------------------- check

    def check_throttled(
        self, pod: Pod, is_throttled_on_equal: bool
    ) -> Tuple[List[Throttle], List[Throttle], List[Throttle], List[Throttle]]:
        """→ (active, insufficient, pod-requests-exceeds, affected)
        (throttle_controller.go:349-397).

        With a device manager the classification runs as one kernel call
        over the mirrored tensors; otherwise — or while the device circuit
        breaker is open after a dispatch failure (backend/tunnel death) —
        the host oracle loops, so a device outage degrades latency, never
        availability. An accel-class pod takes the host oracle whenever
        any mirrored throttle declares accelClassThresholds: the device
        planes carry only the base thresholds, and the host oracle is
        where the per-class replacement resolves (api/types.py)."""
        from ..api.pod import accel_class_of

        accel = accel_class_of(pod)
        dm = self.device_manager
        if dm is not None and not (accel and dm.has_accel_thresholds(self.KIND)):
            results = dm.guarded("check", dm.check_pod, pod, self.KIND, is_throttled_on_equal)
            if results is not None:
                return self.classify_from_map(results)
        throttles = self.affected_throttles(pod)
        active: List[Throttle] = []
        insufficient: List[Throttle] = []
        exceeds: List[Throttle] = []
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
        """Device classification map {throttle_key: status} → the
        check_throttled 4-tuple. Shared by the per-pod device path and the
        micro-batching pre_filter front-end (one fused dispatch produces
        many pods' maps; each composes reasons through this same code).

        Object resolution is BULK (one indexer lock hold for all K keys):
        the per-key lister chain (namespace-lister alloc + lock + dict
        layers) measured ~3µs × ~20 affected keys × 2 kinds per decision
        at the 100k×10k scale — a third of the served p50. A key whose
        object vanished between the device snapshot and here (concurrent
        delete) is skipped: a deleted throttle cannot block scheduling,
        matching the lister-backed affectedThrottles behavior
        (throttle_controller.go:221-269 drops not-found keys)."""
        active, insufficient, exceeds, affected = [], [], [], []
        if self.listers is not None:
            objs = self.listers.throttles.get_by_keys(list(results.keys()))
        else:
            objs = []
            for key in results:
                try:
                    objs.append(self.store.get_throttle(*key.split("/", 1)))
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
        from .base import _BatchEventHandler

        if self.informers is not None:
            # shared-informer subscription (mustSetupEventHandler,
            # throttle_controller.go:400): the informer mirrors the store
            # into its indexer BEFORE fanning out, so lister reads from a
            # handler always observe a cache >= the event. The batch
            # wrappers let a micro-batched ingest burst fan out as ONE call
            # with one workqueue lock hold (informers.on_batch probes for
            # on_events).
            self.informers.throttles().add_event_handler(
                _BatchEventHandler(self._on_throttle_event, self._on_throttle_events)
            )
            self.informers.pods().add_event_handler(
                _BatchEventHandler(self._on_pod_event, self._on_pod_events)
            )
        else:
            self.store.add_event_handler("Throttle", self._on_throttle_event)
            self.store.add_event_handler("Pod", self._on_pod_event)

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
        """Per-event pod handling: reservation side effects run inline;
        the keys to enqueue are RETURNED so the batch fan-out can union a
        whole ingest burst into one workqueue lock hold."""
        if event.type == EventType.ADDED:
            pod = event.obj
            if not self.should_count_in(pod):
                return None
            return self.affected_throttle_keys(pod)
        elif event.type == EventType.MODIFIED:
            old_pod, new_pod = event.old_obj, event.obj
            if not self.should_count_in(old_pod) and not self.should_count_in(new_pod):
                return None
            if self._selector_inputs_unchanged(old_pod, new_pod):
                return self.affected_throttle_keys(new_pod)
            old_keys = set(self.affected_throttle_keys(old_pod))
            new_keys = set(self.affected_throttle_keys(new_pod))
            moved_from = old_keys - new_keys
            moved_to = new_keys - old_keys
            if moved_from or moved_to:
                # atomic reservation move on label change
                # (throttle_controller.go:469-500)
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
                # the deleted pod may still hold reservations
                # (throttle_controller.go:508-519)
                try:
                    self.unreserve(pod)
                except Exception:
                    logger.exception("failed to unreserve deleted pod %s", pod.key)
            return self.affected_throttle_keys(pod)

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
