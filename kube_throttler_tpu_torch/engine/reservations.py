"""The scheduler-cycle reservation ledger.

Mirrors reserved_resource_amounts.go:32-156: throttle-key → (pod-key →
ResourceAmount), guarded by a global RW lock plus hashed per-throttle-key
locks (keymutex.NewHashed(n)); add is idempotent-overwrite, remove returns
whether the pod was present, and assignment moves are remove+add over the
symmetric difference (moveThrottleAssignmentForPods,
reserved_resource_amounts.go:92-111).

A reservation exists only between the scheduler's Reserve call and the first
reconcile that observes the pod counted in status.used (or pod deletion /
Unreserve) — the reserve-until-observed handshake (SURVEY §3.3).

**TTL deadlines.** ``add_pod(..., ttl=...)`` attaches an expiry deadline
(injectable clock): a reservation whose scheduler died mid-cycle must not
pin capacity forever. Expired entries are invisible to every read and are
purged lazily under the same locks the reads already hold. Deadlines are
snapshot/restore-aware (engine/snapshot.py / engine/recovery.py):
``snapshot_state`` serializes REMAINING seconds, and ``restore_state``
rebases them against the restoring process's clock — so a deadline can
never resurrect an already-expired reservation just because wall time
moved while the process was dead, and a frozen test clock restores exact
remaining budgets.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

from ..api.pod import Pod
from ..api.types import ResourceAmount, resource_amount_of_pod
from ..utils.clock import Clock, RealClock
from ..utils.lockorder import make_rlock
from ..utils.tracing import vlog

TTL = Union[None, float, int, timedelta]


def _ttl_seconds(ttl: TTL) -> Optional[float]:
    if ttl is None:
        return None
    if isinstance(ttl, timedelta):
        return ttl.total_seconds()
    return float(ttl)


class ReservedResourceAmounts:
    # the top-level cache/deadline maps are guarded by the global lock; the
    # per-key pod maps inside them are guarded by the hashed key locks
    # (lock order: key lock -> global lock, never the reverse)
    GUARDED_BY = {"_cache": "self._lock", "_deadlines": "self._lock"}

    def __init__(self, num_key_mutex: int = 128, clock: Optional[Clock] = None):
        self._lock = make_rlock("reservations.global")
        # hashed per-throttle-key mutexes share one name: distinct slots
        # are never nested (one hash bucket per operation), so a shared
        # name loses no order information
        self._key_locks = [
            make_rlock("reservations.key") for _ in range(max(1, num_key_mutex))
        ]
        self._clock = clock or RealClock()
        # throttle key -> pod key -> amount
        self._cache: Dict[str, Dict[str, ResourceAmount]] = {}
        # throttle key -> pod key -> expiry deadline (only TTL'd entries)
        self._deadlines: Dict[str, Dict[str, datetime]] = {}
        # reservations dropped by TTL expiry (single-writer-ish counter,
        # read by tests/probes)
        self.expired_total = 0

    def _key_lock(self, key: str):
        return self._key_locks[hash(key) % len(self._key_locks)]

    def _pod_map(self, throttle_key: str) -> Dict[str, ResourceAmount]:
        with self._lock:
            return self._cache.setdefault(throttle_key, {})

    def _deadline_map(self, throttle_key: str) -> Dict[str, datetime]:
        with self._lock:
            return self._deadlines.setdefault(throttle_key, {})

    def _purge_expired(self, throttle_key: str, now: datetime) -> None:
        """Drop expired entries for one throttle key. Caller holds that
        key's hashed lock (the pod/deadline inner maps move under it)."""
        dm = self._deadline_map(throttle_key)
        if not dm:
            return
        expired = [pk for pk, deadline in dm.items() if deadline <= now]
        if not expired:
            return
        m = self._pod_map(throttle_key)
        for pk in expired:
            dm.pop(pk, None)
            if m.pop(pk, None) is not None:
                self.expired_total += 1
                vlog(4, "reservation expired: pod=%s throttle=%s", pk, throttle_key)

    def add_pod(self, throttle_key: str, pod: Pod, ttl: TTL = None) -> bool:
        vlog(5, "reservation add: pod=%s throttle=%s", pod.key, throttle_key)
        """Overwrite-insert; True if the pod was newly reserved. ``ttl``
        (seconds or timedelta) attaches an expiry deadline; None keeps the
        reference's reserve-until-observed lifetime."""
        ttl_s = _ttl_seconds(ttl)
        now = self._clock.now()
        with self._key_lock(throttle_key):
            self._purge_expired(throttle_key, now)
            m = self._pod_map(throttle_key)
            dm = self._deadline_map(throttle_key)
            existed = pod.key in m
            m[pod.key] = resource_amount_of_pod(pod)
            if ttl_s is not None:
                dm[pod.key] = now + timedelta(seconds=ttl_s)
            else:
                dm.pop(pod.key, None)
            return not existed

    def remove_pod(self, throttle_key: str, pod: Pod) -> bool:
        vlog(5, "reservation remove: pod=%s throttle=%s", pod.key, throttle_key)
        return self.remove_pod_key(throttle_key, pod.key)

    def remove_pod_key(self, throttle_key: str, pod_key: str) -> bool:
        with self._key_lock(throttle_key):
            m = self._pod_map(throttle_key)
            self._deadline_map(throttle_key).pop(pod_key, None)
            return m.pop(pod_key, None) is not None

    def move_throttle_assignment(
        self, pod: Pod, from_keys: Iterable[str], to_keys: Iterable[str]
    ) -> None:
        """reserved_resource_amounts.go:92-111."""
        for key in from_keys:
            self.remove_pod(key, pod)
        for key in to_keys:
            self.add_pod(key, pod)

    def reserved_resource_amount(self, throttle_key: str) -> Tuple[ResourceAmount, Set[str]]:
        """Sum of reserved amounts + reserved pod keys for one throttle
        (expired entries purged first — they must never count toward
        ``reserved`` in the admission inequality)."""
        now = self._clock.now()
        with self._key_lock(throttle_key):
            self._purge_expired(throttle_key, now)
            with self._lock:
                m = self._cache.get(throttle_key)
                entries = list(m.items()) if m else []
        result = ResourceAmount()
        pod_keys: Set[str] = set()
        for pod_key, amount in entries:
            pod_keys.add(pod_key)
            result = result.add(amount)
        return result, pod_keys

    def reserved_pod_keys(self, throttle_key: str) -> Set[str]:
        now = self._clock.now()
        with self._lock:
            m = self._cache.get(throttle_key)
            if not m:
                return set()
            dm = self._deadlines.get(throttle_key) or {}
            # filter without purging: this read holds only the global lock,
            # and the inner maps move under the hashed key locks
            return {pk for pk in m if not (pk in dm and dm[pk] <= now)}

    def throttle_keys(self) -> Set[str]:
        with self._lock:
            return set(self._cache.keys())

    # -- snapshot / restore (engine/snapshot.py, engine/recovery.py) --------

    def snapshot_state(self, now: Optional[datetime] = None) -> Dict[str, dict]:
        """Serializable ledger state: ``{throttle_key: {pod_key: {"amount":
        <ResourceAmount dict>, "ttlRemainingSeconds": float | None}}}``.
        TTLs are stored as remaining budget relative to ``now`` so the
        restoring process can rebase them on ITS clock; already-expired
        entries are omitted (a snapshot must never carry a dead
        reservation)."""
        now = now or self._clock.now()
        with self._lock:
            throttle_keys = list(self._cache.keys())
        out: Dict[str, dict] = {}
        for tk in throttle_keys:
            with self._key_lock(tk):
                with self._lock:
                    m = dict(self._cache.get(tk) or {})
                    dm = dict(self._deadlines.get(tk) or {})
            entries = {}
            for pk, amount in m.items():
                deadline = dm.get(pk)
                if deadline is not None and deadline <= now:
                    continue
                entries[pk] = {
                    "amount": amount.to_dict(),
                    "ttlRemainingSeconds": (
                        (deadline - now).total_seconds()
                        if deadline is not None
                        else None
                    ),
                }
            if entries:
                out[tk] = entries
        return out

    def restore_state(
        self,
        state: Dict[str, dict],
        now: Optional[datetime] = None,
        elapsed_s: float = 0.0,
    ) -> Tuple[int, int, List[str]]:
        """Merge a ``snapshot_state`` payload into this ledger. Each
        remaining TTL is first charged ``elapsed_s`` — the wall time
        between the snapshot cut and this restore (the process was dead;
        the scheduler that held the reservation certainly is) — then
        REBASED onto ``now`` (this process's clock, so clock skew between
        runs can never extend a deadline). Entries whose charged budget is
        <= 0 are DROPPED, never resurrected. Returns ``(restored,
        dropped_expired, touched_throttle_keys)`` — the caller replays
        touched keys into the device mirror."""
        from ..api.serialization import resource_amount_from_dict

        now = now or self._clock.now()
        elapsed_s = max(0.0, float(elapsed_s))
        restored = dropped = 0
        touched: List[str] = []
        for tk, pods in (state or {}).items():
            wrote = False
            with self._key_lock(tk):
                m = self._pod_map(tk)
                dm = self._deadline_map(tk)
                for pk, entry in pods.items():
                    remaining = entry.get("ttlRemainingSeconds")
                    if remaining is not None:
                        remaining = float(remaining) - elapsed_s
                        if remaining <= 0.0:
                            dropped += 1
                            continue
                    m[pk] = resource_amount_from_dict(entry.get("amount"))
                    if remaining is not None:
                        dm[pk] = now + timedelta(seconds=remaining)
                    else:
                        dm.pop(pk, None)
                    restored += 1
                    wrote = True
            if wrote:
                touched.append(tk)
        return restored, dropped, touched
