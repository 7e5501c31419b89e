"""The gang (pod-group) ledger: all-or-nothing multi-pod reserve/rollback
layered on the per-pod reservation ledger (engine/reservations.py).

A tightly-coupled multi-host job must start all ranks or none (PAPERS.md,
Rank-Aware MPI scheduling): admitting half a gang pins capacity that can
never run while starving jobs that could. The ledger provides the group
half of that contract:

- ``reserve_group`` adds EVERY member's reservation to the underlying
  per-kind ``ReservedResourceAmounts`` caches (which keep their own
  key-lock → global-lock order — the gang lock nests OUTSIDE them, so the
  per-pod paths are untouched), or rolls back the members already added
  when any add fails. The whole loop runs under the gang lock, which is
  the crash-atomicity hinge: the snapshot gather (engine/snapshot.py)
  captures the gang records AND the reservation caches under this same
  lock, so a snapshot can never observe a half-formed gang — recovered
  state is always fully-reserved or fully-rolled-back
  (tools/crashtest.py site ``crash.gang.partial_reserve`` proves it).
- ``reserve``/``rollback``/``commit`` are stamped into the journal as
  ``GANG`` control lines (engine/journal.py): no store effect, but
  recovery reads the begin-without-commit tail as a rollback order for
  any member reservation that somehow survived (defense in depth behind
  the lock-level atomicity), and operators get a durable audit trail of
  group admission.
- group TTLs ride the charge-then-rebase machinery: every member
  reservation carries the gang TTL, the group record keeps the deadline,
  ``snapshot_state`` serializes REMAINING seconds and ``restore_state``
  charges the dead time then rebases — a half-dead scheduler's gang can
  never pin capacity across a crash.

Member lifecycle after a successful reserve: the scheduler binds each
rank; the store's Pod events drive the record (``on_pod_event`` — a bound
member is *admitted*; a deleted pre-admission member rolls the WHOLE
group back, all-or-nothing both ways), and the controllers'
unreserve-on-observe handshake notifies ``note_unreserved`` as each
member's reservation is released into ``status.used``. When every member
is admitted the record retires (``groups_admitted_total``).

``sequential_gang_check`` is the per-pod ORACLE the batched feasibility
kernel (ops/gang_check.py) is property-tested against: admit members one
at a time through the reference 4-step check, counting earlier members as
reserved.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..api.pod import Pod, accel_class_of
from ..api.types import CheckThrottleStatus, ResourceAmount, resource_amount_of_pod
from ..faults.plan import maybe_crash
from ..utils.clock import Clock, RealClock
from ..utils.lockorder import guard_attrs, make_rlock
from ..utils.tracing import vlog
from .reservations import TTL, _ttl_seconds
from .store import EventType

logger = logging.getLogger(__name__)

# member_keys shape: pod_key → {kind: [throttle_key, ...]}
MemberKeys = Dict[str, Dict[str, List[str]]]


@dataclass
class GangRecord:
    """One fully-reserved group awaiting admission of all its ranks."""

    group_key: str
    members: MemberKeys
    deadline: Optional[datetime] = None
    admitted: Set[str] = field(default_factory=set)
    # pods kept for rollback (remove needs only keys, but the device
    # mirror replay wants the amounts; keyed like members)
    pod_amounts: Dict[str, ResourceAmount] = field(default_factory=dict)


@guard_attrs
class GangLedger:
    """Group ledger over the per-kind reservation caches.

    Lock order: gang lock → reservation key/global locks (via the caches)
    and gang lock → devicestate main lock (via ``on_change``) and gang
    lock → journal lock (via the GANG stamps). The store lock, when
    involved, is always OUTSIDE the gang lock (store event dispatch →
    ``on_pod_event``; snapshot gather → ``lock``)."""

    GUARDED_BY = {
        "_groups": "self._lock",
        "_member_index": "self._lock",
    }

    def __init__(
        self,
        caches: Dict[str, object],  # {kind: ReservedResourceAmounts}
        clock: Optional[Clock] = None,
        on_change: Optional[Callable[[str, str], None]] = None,
        journal=None,
        faults=None,
        default_ttl: TTL = None,
    ):
        # RLock: on_pod_event → _rollback_locked nests fine, and the
        # snapshot gather may re-enter through cache callbacks
        self._lock = make_rlock("gang.ledger")
        self._caches = dict(caches)
        self._clock = clock or RealClock()
        self._on_change = on_change
        self.journal = journal
        self.faults = faults
        self.default_ttl = default_ttl
        self._groups: Dict[str, GangRecord] = {}
        self._member_index: Dict[str, str] = {}  # pod_key → group_key
        # single-writer counters (metrics/tests read these)
        self.groups_reserved_total = 0
        self.groups_admitted_total = 0
        self.groups_rolled_back_total = 0
        self.groups_expired_total = 0

    @property
    def lock(self):
        """The gang lock, exposed for the snapshot gather: holding it
        around the reservation-cache capture is what makes snapshots
        gang-atomic (module docstring)."""
        return self._lock

    def _notify(self, kind: str, throttle_key: str) -> None:
        if self._on_change is not None:
            self._on_change(kind, throttle_key)

    def _stamp(self, op: str, group_key: str, members: Optional[Sequence[str]] = None) -> None:
        if self.journal is not None:
            self.journal.append_gang(op, group_key, members=members)

    # -- reserve / rollback -------------------------------------------------

    def reserve_group(
        self,
        group_key: str,
        pods: Sequence[Pod],
        member_keys: MemberKeys,
        ttl: TTL = None,
    ) -> bool:
        """Atomically reserve every member on every matched throttle of
        both kinds. True on success; already-pending groups are idempotent
        True (a scheduler retry must not double-reserve). On any member
        failure the members already added are removed and the journal gets
        a rollback stamp — all-or-nothing, crash included (module
        docstring)."""
        ttl = ttl if ttl is not None else self.default_ttl
        ttl_s = _ttl_seconds(ttl)
        now = self._clock.now()
        with self._lock:
            self._purge_expired_locked(now)
            if group_key in self._groups:
                return True
            self._stamp("begin", group_key, members=sorted(p.key for p in pods))
            added: List[Tuple[str, str, str]] = []  # (kind, throttle_key, pod_key)
            record = GangRecord(
                group_key=group_key,
                members={p.key: dict(member_keys.get(p.key, {})) for p in pods},
                deadline=(
                    now + timedelta(seconds=ttl_s) if ttl_s is not None else None
                ),
            )
            try:
                for pod in pods:
                    record.pod_amounts[pod.key] = resource_amount_of_pod(pod)
                    for kind, keys in member_keys.get(pod.key, {}).items():
                        cache = self._caches[kind]
                        for key in keys:
                            # the mid-gang SIGKILL instant the crash matrix
                            # drives: some members reserved, the rest not
                            maybe_crash(self.faults, "crash.gang.partial_reserve")
                            if self.faults is not None:
                                self.faults.maybe_raise("gang.reserve.partial")
                            cache.add_pod(key, pod, ttl=ttl)
                            added.append((kind, key, pod.key))
                            self._notify(kind, key)
            except Exception:
                for kind, key, pod_key in reversed(added):
                    self._caches[kind].remove_pod_key(key, pod_key)
                    self._notify(kind, key)
                self._stamp("rollback", group_key)
                self.groups_rolled_back_total += 1
                logger.warning(
                    "gang %s: member reserve failed; rolled back %d "
                    "reservation(s)", group_key, len(added), exc_info=True,
                )
                return False
            self._groups[group_key] = record
            for pod_key in record.members:
                self._member_index[pod_key] = group_key
            self._stamp("commit", group_key)
            self.groups_reserved_total += 1
            vlog(3, "gang %s reserved: %d member(s)", group_key, len(pods))
            return True

    def rollback_group(self, group_key: str, reason: str = "rollback") -> bool:
        """Release every not-yet-admitted member reservation and retire the
        record. Admitted members' reservations are left to the normal
        unreserve-on-observe handshake (removing them early would reopen
        the double-count window the handshake closes)."""
        with self._lock:
            return self._rollback_locked(group_key, reason)

    def _rollback_locked(self, group_key: str, reason: str) -> bool:
        record = self._groups.pop(group_key, None)
        if record is None:
            return False
        for pod_key, kinds in record.members.items():
            self._member_index.pop(pod_key, None)
            if pod_key in record.admitted:
                continue
            for kind, keys in kinds.items():
                cache = self._caches[kind]
                for key in keys:
                    if cache.remove_pod_key(key, pod_key):
                        self._notify(kind, key)
        self._stamp("rollback", group_key)
        self.groups_rolled_back_total += 1
        vlog(3, "gang %s rolled back (%s)", group_key, reason)
        return True

    def drop_groups(self, group_keys) -> int:
        """Forget group records WITHOUT releasing member reservations —
        the live-resharding retire/abort path: the moved throttle keys'
        cache entries are dropped (or kept, on the surviving owner) by the
        same handoff step, so a rollback-style release here would
        double-free capacity the other shard now accounts. Returns the
        number of records removed."""
        dropped = 0
        with self._lock:
            for gk in list(group_keys):
                record = self._groups.pop(gk, None)
                if record is None:
                    continue
                dropped += 1
                for pod_key in record.members:
                    if self._member_index.get(pod_key) == gk:
                        del self._member_index[pod_key]
        return dropped

    # -- member lifecycle ---------------------------------------------------

    def on_pod_event(self, event) -> None:
        """Store Pod-event hook (registered by the plugin; runs under the
        store lock — order store → gang). A bound member is admitted; a
        deleted pre-admission member rolls the whole group back."""
        pod = event.obj
        with self._lock:
            group_key = self._member_index.get(pod.key)
            if group_key is None:
                return
            record = self._groups.get(group_key)
            if record is None:  # stale index entry
                self._member_index.pop(pod.key, None)
                return
            if event.type == EventType.DELETED:
                if pod.key in record.admitted:
                    # an admitted rank died: its reservations already
                    # released; the group record just forgets it
                    record.members.pop(pod.key, None)
                    record.admitted.discard(pod.key)
                    self._member_index.pop(pod.key, None)
                    self._maybe_complete_locked(group_key, record)
                else:
                    # a rank vanished before the gang started: the group
                    # can never run — free everything (all-or-nothing on
                    # the way out too)
                    self._rollback_locked(group_key, "member deleted")
                return
            if pod.is_scheduled() and pod.key not in record.admitted:
                record.admitted.add(pod.key)
                self._maybe_complete_locked(group_key, record)

    def note_unreserved(self, kind: str, throttle_key: str, pod_key: str) -> None:
        """Controller unreserve-on-observe hook: the member's reservation
        on ``throttle_key`` was just released into ``status.used`` — prune
        it from the record (a later rollback must not re-remove a live
        pod's worth of capacity) and count the member admitted."""
        with self._lock:
            group_key = self._member_index.get(pod_key)
            if group_key is None:
                return
            record = self._groups.get(group_key)
            if record is None:
                return
            keys = record.members.get(pod_key, {}).get(kind)
            if keys is not None and throttle_key in keys:
                keys.remove(throttle_key)
            if pod_key not in record.admitted:
                record.admitted.add(pod_key)
                self._maybe_complete_locked(group_key, record)

    def _maybe_complete_locked(self, group_key: str, record: GangRecord) -> None:
        if record.members and record.admitted >= set(record.members):
            self._groups.pop(group_key, None)
            for pod_key in record.members:
                self._member_index.pop(pod_key, None)
            self.groups_admitted_total += 1
            vlog(3, "gang %s fully admitted", group_key)

    # -- TTL expiry ---------------------------------------------------------

    def _purge_expired_locked(self, now: datetime) -> None:
        expired = [
            gk
            for gk, rec in self._groups.items()
            if rec.deadline is not None and rec.deadline <= now
        ]
        for gk in expired:
            self.groups_expired_total += 1
            self._rollback_locked(gk, "ttl expired")

    def purge_expired(self) -> None:
        with self._lock:
            self._purge_expired_locked(self._clock.now())

    # -- probes -------------------------------------------------------------

    def pending_groups(self) -> int:
        with self._lock:
            self._purge_expired_locked(self._clock.now())
            return len(self._groups)

    def group_record(self, group_key: str) -> Optional[GangRecord]:
        with self._lock:
            return self._groups.get(group_key)

    def is_member(self, pod_key: str) -> bool:
        with self._lock:
            return pod_key in self._member_index

    # -- snapshot / restore (engine/snapshot.py, engine/recovery.py) --------

    def snapshot_state(self, now: Optional[datetime] = None) -> Dict[str, dict]:
        """Serializable group records; TTLs as REMAINING seconds (the
        charge-then-rebase contract, engine/reservations.py). The snapshot
        gather calls this under ``self.lock`` (held around the reservation
        capture too), so the records and the member reservations describe
        one instant."""
        now = now or self._clock.now()
        with self._lock:
            out: Dict[str, dict] = {}
            for gk, rec in self._groups.items():
                if rec.deadline is not None and rec.deadline <= now:
                    continue  # a snapshot must never carry a dead gang
                out[gk] = {
                    "members": {
                        pk: {kind: list(keys) for kind, keys in kinds.items()}
                        for pk, kinds in rec.members.items()
                    },
                    "admitted": sorted(rec.admitted),
                    "ttlRemainingSeconds": (
                        (rec.deadline - now).total_seconds()
                        if rec.deadline is not None
                        else None
                    ),
                }
            return out

    def restore_state(
        self,
        state: Dict[str, dict],
        now: Optional[datetime] = None,
        elapsed_s: float = 0.0,
    ) -> Tuple[int, int]:
        """Rebuild group records from a snapshot payload. Each remaining
        TTL is charged the dead time then rebased on this clock; a group
        whose budget is spent is DROPPED — and its not-yet-admitted member
        reservations are removed from the caches (they were restored by
        ``restore_reservations`` moments earlier; a dead gang must not pin
        capacity). Returns ``(restored, dropped_expired)``."""
        now = now or self._clock.now()
        elapsed_s = max(0.0, float(elapsed_s))
        restored = dropped = 0
        with self._lock:
            for gk, entry in (state or {}).items():
                members: MemberKeys = {
                    pk: {kind: list(keys) for kind, keys in kinds.items()}
                    for pk, kinds in (entry.get("members") or {}).items()
                }
                remaining = entry.get("ttlRemainingSeconds")
                deadline = None
                if remaining is not None:
                    remaining = float(remaining) - elapsed_s
                    if remaining <= 0.0:
                        dropped += 1
                        self.groups_expired_total += 1
                        admitted = set(entry.get("admitted") or [])
                        for pk, kinds in members.items():
                            if pk in admitted:
                                continue
                            for kind, keys in kinds.items():
                                cache = self._caches[kind]
                                for key in keys:
                                    if cache.remove_pod_key(key, pk):
                                        self._notify(kind, key)
                        continue
                    deadline = now + timedelta(seconds=remaining)
                record = GangRecord(
                    group_key=gk,
                    members=members,
                    deadline=deadline,
                    admitted=set(entry.get("admitted") or []),
                )
                self._groups[gk] = record
                for pk in members:
                    self._member_index[pk] = gk
                restored += 1
        return restored, dropped

    def rollback_uncommitted(self, gang_ops: Dict[str, dict]) -> int:
        """Recovery's pass over the journal's GANG control lines
        (engine/journal.py ``gang_ops``): a group whose LAST stamped op is
        ``begin`` crashed mid-reserve, and one whose last op is
        ``rollback`` was released after the snapshot cut (reservation
        removals are not journaled, so the snapshot may still carry it) —
        either way, remove every member reservation of it that survived
        into the restored caches and drop any restored record. For the
        ``begin`` case this is defense in depth behind the gang lock's
        snapshot atomicity; for ``rollback`` it is the replay that brings
        the restored ledger forward to the journal's truth. Returns groups
        rolled back."""
        rolled = 0
        with self._lock:
            for gk, entry in (gang_ops or {}).items():
                if entry.get("op") not in ("begin", "rollback"):
                    continue
                record = self._groups.get(gk)
                if record is not None:
                    self._rollback_locked(gk, "journal begin without commit")
                    rolled += 1
                    continue
                members = entry.get("members") or []
                removed_any = False
                for pod_key in members:
                    for kind, cache in self._caches.items():
                        for key in list(cache.throttle_keys()):
                            if cache.remove_pod_key(key, pod_key):
                                self._notify(kind, key)
                                removed_any = True
                if removed_any:
                    self._stamp("rollback", gk)
                    self.groups_rolled_back_total += 1
                    rolled += 1
        return rolled


def sequential_gang_check(
    pods: Sequence[Pod],
    kind_controllers: Sequence[Tuple[str, object, bool]],
) -> Tuple[bool, Dict[str, List[str]]]:
    """The per-pod ORACLE batched gang feasibility must equal: admit the
    members ONE AT A TIME through the reference 4-step check, counting
    every earlier member as reserved on its matched throttles — exactly
    what a sequence of per-pod PreFilter+Reserve cycles would compute.
    ``kind_controllers`` is ``[(kind, controller, is_throttled_on_equal)]``
    (the controller supplies ``affected_throttles`` and its reservation
    ``cache``). Returns ``(feasible, {pod_key: [blocking "kind status
    throttle_key" strings]})``; side-effect-free (earlier members are
    accumulated in a local overlay, never the live caches)."""
    extra: Dict[Tuple[str, str], ResourceAmount] = {}
    blocked: Dict[str, List[str]] = {}
    feasible = True
    for pod in pods:
        accel = accel_class_of(pod)
        pod_blocks: List[str] = []
        matched: List[Tuple[str, object]] = []  # (kind, throttle) to charge
        for kind, ctr, on_equal in kind_controllers:
            for thr in ctr.affected_throttles(pod):
                matched.append((kind, thr))
                reserved, _ = ctr.cache.reserved_resource_amount(thr.key)
                overlay = extra.get((kind, thr.key))
                if overlay is not None:
                    reserved = reserved.add(overlay)
                status = thr.check_throttled_for(
                    pod, reserved, on_equal, accel_class=accel
                )
                if status != CheckThrottleStatus.NOT_THROTTLED:
                    pod_blocks.append(f"{kind}[{status}]={thr.key}")
        if pod_blocks:
            blocked[pod.key] = pod_blocks
            feasible = False
            continue  # keep collecting per-pod reasons; don't charge it
        amount = resource_amount_of_pod(pod)
        for kind, thr in matched:
            key = (kind, thr.key)
            extra[key] = (extra.get(key) or ResourceAmount()).add(amount)
    return feasible, blocked
