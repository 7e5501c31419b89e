"""Crash recovery: snapshot restore + journal tail replay + reconcile.

The restore pipeline (standalone ``--data-dir`` mode, run before any store
handler exists):

1. **Pick a snapshot.** Walk ``snapshot-*.ktsnap`` newest-first; a file
   that fails the header/checksum/version gate (engine/snapshot.py) is
   counted in ``snapshots_rejected`` and the walk falls back to the next
   older one. Orphan ``*.tmp`` files (crash mid-snapshot-write) are swept.
2. **Tail or genesis.** A snapshot records the journal's ``(offset,
   sha256)`` at cut time. If the live journal's prefix up to that offset
   still hashes identically, the journal is a strict superset of the
   snapshot: apply the snapshot's objects and replay ONLY the tail
   (``journal_mode="tail"``). If the prefix no longer matches (the journal
   was compacted after the cut) the journal alone is the newest complete
   state: ignore the snapshot's objects and replay from genesis
   (``"genesis"`` — also the no-snapshot path). If the journal file is
   missing while a snapshot exists, the snapshot IS the state
   (``"snapshot-only"``): apply it and immediately compact the fresh
   journal so the log alone is complete again — the invariant after every
   recovery is *the journal by itself reproduces the store*.
   Either replay applies the journal's torn-tail rules: a torn FINAL line
   is truncated silently (normal crash artifact), interior corruption is
   skipped and counted (engine/journal.py).
3. **Reservations.** ``restore_reservations`` rebases snapshot TTLs
   against the restoring clock (never resurrecting expired entries) and
   replays restored keys into the device mirror's reserved rows.
4. **Reconcile.** After the plugin exists (SelectorIndex + devicestate
   planes rebuilt from the informer cache-sync replay), ``reconcile``
   compares the rebuilt published planes against the first informer-relist
   view of the statuses. Any mismatch is a divergence: counted, exported
   (kube_throttler_recovery_divergence_total), and REPAIRED by enqueueing
   the key — the controller recomputes the status from specs/pods and the
   write-echo refreshes the plane. The crash harness asserts this counter
   is zero for every seeded SIGKILL artifact.

The report lands in ``/readyz`` (health component ``recovery``) and the
recovery metric families (metrics.register_recovery_metrics).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from ..utils.clock import Clock, RealClock
from .journal import StoreJournal, attach, hash_prefix
from .snapshot import SnapshotError, find_snapshots, load_snapshot
from .store import Store

logger = logging.getLogger(__name__)

JOURNAL_FILE = "store.journal"


@dataclass
class RecoveryReport:
    """What recovery did, for /readyz + metrics + the crash harness."""

    data_dir: str = ""
    snapshot_path: Optional[str] = None
    snapshot_seq: Optional[int] = None
    snapshot_taken_at: Optional[str] = None
    snapshot_objects: int = 0
    snapshots_rejected: int = 0
    tmp_files_swept: int = 0
    journal_mode: str = "none"  # "tail" | "genesis" | "snapshot-only" | "none"
    journal_lines_replayed: int = 0
    journal_interior_skipped: int = 0
    journal_torn_tails: int = 0
    reservations_restored: int = 0
    reservations_expired_dropped: int = 0
    gangs_restored: int = 0
    gangs_expired_dropped: int = 0
    gangs_rolled_back: int = 0  # journal begin-without-commit rollbacks
    preempts_rolled_back: int = 0  # uncommitted preemptions rolled back
    preempt_victims_restored: int = 0  # victim pods re-created by rollback
    epoch: int = 0  # highest fencing epoch found (snapshot header + journal)
    divergences: int = 0
    repaired_keys: List[str] = field(default_factory=list)
    snapshot_drift_keys: int = 0  # keys whose flags legitimately progressed
    duration_s: float = 0.0


class RecoveryManager:
    """One recovery run for one data directory. Single-threaded startup
    object — construct, ``recover_store``, then (after the plugin exists)
    ``restore_reservations`` + ``reconcile``; keep it around for the
    ``health_state`` probe."""

    def __init__(
        self,
        data_dir: str,
        clock: Optional[Clock] = None,
        faults=None,
        compact_after: int = 100_000,
    ):
        self.data_dir = data_dir
        self.clock = clock or RealClock()
        self.faults = faults
        self.compact_after = compact_after
        self.journal_path = os.path.join(data_dir, JOURNAL_FILE)
        self.report = RecoveryReport(data_dir=data_dir)
        self.snapshot: Optional[dict] = None  # payload actually used

    # -- step 1+2: snapshot + journal ---------------------------------------

    def _sweep_tmp_files(self) -> None:
        try:
            entries = os.listdir(self.data_dir)
        except OSError:
            return
        for name in entries:
            if name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(self.data_dir, name))
                    self.report.tmp_files_swept += 1
                except OSError:  # pragma: no cover — racing cleaner
                    pass

    def _pick_snapshot(self) -> Optional[dict]:
        for _seq, path in find_snapshots(self.data_dir):
            try:
                payload = load_snapshot(path)
            except SnapshotError as e:
                self.report.snapshots_rejected += 1
                logger.warning("recovery: rejecting snapshot %s (%s)", path, e)
                continue
            self.report.snapshot_path = path
            self.report.snapshot_seq = payload.get("seq")
            self.report.snapshot_taken_at = payload.get("takenAt")
            return payload
        return None

    def _apply_snapshot_objects(self, store: Store, payload: dict) -> None:
        from ..api.serialization import object_from_dict

        # objects are serialized namespaces-first (snapshot._gather), so a
        # straight walk satisfies creation-order dependencies
        for d in payload.get("objects", []):
            obj = object_from_dict(d)
            kind = d.get("kind")
            if kind == "Namespace":
                store.create_namespace(obj)
            elif kind == "Throttle":
                store.create_throttle(obj)
            elif kind == "ClusterThrottle":
                store.create_cluster_throttle(obj)
            elif kind == "Pod":
                store.create_pod(obj)
            self.report.snapshot_objects += 1
        # v2 columnar pod block (pods absent from "objects"); v1 snapshots
        # (pre-bump fixtures and mixed-version restarts) recover through
        # the objects walk above — both paths land in the same store state
        block = payload.get("podColumns")
        if block:
            from .columnar import pods_from_columns

            for pod in pods_from_columns(block):
                store.create_pod(pod)
                self.report.snapshot_objects += 1
        store.advance_resource_version_to(int(payload.get("rv", 0)))

    def recover_store(self, store: Store) -> StoreJournal:
        """Restore ``store`` (freshly constructed, empty, no handlers) from
        the newest usable snapshot + journal tail, falling back per the
        module docstring. Returns the attached live journal."""
        t0 = time.monotonic()
        self._sweep_tmp_files()
        payload = self._pick_snapshot()
        mode = "genesis"
        start_offset, resume_hash = 0, None
        if payload is not None:
            jinfo = payload.get("journal")
            journal_exists = os.path.exists(self.journal_path)
            if jinfo is not None and journal_exists:
                h = hash_prefix(self.journal_path, int(jinfo.get("offset", -1)))
                if h is not None and h.hexdigest() == jinfo.get("sha256"):
                    mode = "tail"
                    start_offset, resume_hash = int(jinfo["offset"]), h
                else:
                    # journal compacted (or rewritten) after the cut: it is
                    # the newest complete state by itself — snapshot objects
                    # would resurrect things the compaction dropped
                    mode = "genesis"
            elif not journal_exists:
                mode = "snapshot-only"
            # jinfo None but journal exists → genesis (snapshot was cut
            # without a journal bound; the journal is the fuller record)
        if mode in ("tail", "snapshot-only"):
            self.snapshot = payload
            self._apply_snapshot_objects(store, payload)
        elif payload is not None:
            # snapshot skipped for objects, but reservations/published
            # planes still come from it (they are not in the journal)
            self.snapshot = payload
        journal = attach(
            store,
            self.journal_path,
            compact_after=self.compact_after,
            faults=self.faults,
            start_offset=start_offset,
            resume_hash=resume_hash,
        )
        if mode == "snapshot-only":
            # re-establish the invariant "the journal alone reproduces the
            # store": the fresh log would otherwise start empty and a later
            # genesis fallback would lose the snapshot's objects
            journal.compact()
        # uncommitted-preemption rollback (zero evictions, the GANG
        # contract's store-state mirror): full replays already rolled back
        # inside attach(); merging the snapshot's open-preempt payload
        # covers tail/snapshot-only modes whose anchor sits past the
        # PREEMPT begin line. Idempotent per id (rollback-stamped ids skip).
        from .journal import rollback_uncommitted_preempts

        extra_preempts = (payload or {}).get("preempts") or {}
        rollback_uncommitted_preempts(store, journal, extra_ops=extra_preempts)
        self.report.preempts_rolled_back = journal.preempts_rolled_back
        self.report.preempt_victims_restored = journal.preempt_victims_restored
        self.report.journal_mode = mode
        self.report.journal_lines_replayed = journal.replayed_events
        self.report.journal_interior_skipped = journal.replay_skipped
        self.report.journal_torn_tails = journal.torn_tails
        # the fencing high-water this data directory knows about: a
        # promoting standby (or restarting leader) must bump PAST it
        self.report.epoch = max(
            int((payload or {}).get("epoch") or 0), journal.last_epoch
        )
        self.report.duration_s = time.monotonic() - t0
        logger.info(
            "recovery: mode=%s snapshot=%s objects=%d journal_lines=%d "
            "interior_skipped=%d torn_tails=%d rejected=%d (%.3fs)",
            mode, self.report.snapshot_path, self.report.snapshot_objects,
            self.report.journal_lines_replayed,
            self.report.journal_interior_skipped, self.report.journal_torn_tails,
            self.report.snapshots_rejected, self.report.duration_s,
        )
        return journal

    # -- step 3: reservations ----------------------------------------------

    def restore_reservations(
        self,
        caches: Mapping[str, object],
        on_change: Optional[Callable[[str, str], None]] = None,
    ) -> None:
        """Rebase + restore the snapshot's reservation ledgers into
        ``caches`` ({kind: ReservedResourceAmounts}). The dead time between
        the snapshot cut and now is charged against every TTL (the
        scheduler that held a reservation did not survive the crash), then
        the remainder is rebased onto the restoring clock — so neither
        wall-time progression while dead nor clock skew between runs can
        resurrect an expired reservation. ``on_change(kind, throttle_key)``
        replays each touched key into the device mirror (the CLI passes
        device_manager.on_reservation_change)."""
        if self.snapshot is None:
            return
        state = self.snapshot.get("reservations") or {}
        now = self.clock.now()
        elapsed_s = 0.0
        taken_at = self.snapshot.get("takenAt")
        if taken_at:
            from datetime import datetime

            try:
                taken = datetime.fromisoformat(taken_at)
                if taken.tzinfo is None and now.tzinfo is not None:
                    taken = taken.replace(tzinfo=now.tzinfo)
                elapsed_s = max(0.0, (now - taken).total_seconds())
            except (ValueError, TypeError):  # pragma: no cover — we wrote it
                pass
        for kind, cache in caches.items():
            restored, dropped, touched = cache.restore_state(
                state.get(kind) or {}, now=now, elapsed_s=elapsed_s
            )
            self.report.reservations_restored += restored
            self.report.reservations_expired_dropped += dropped
            if on_change is not None:
                for throttle_key in touched:
                    on_change(kind, throttle_key)
        if self.report.reservations_restored or self.report.reservations_expired_dropped:
            logger.info(
                "recovery: %d reservation(s) restored with rebased TTLs, "
                "%d expired one(s) dropped",
                self.report.reservations_restored,
                self.report.reservations_expired_dropped,
            )

    def restore_gangs(self, ledger, journal: Optional[StoreJournal] = None) -> None:
        """Rebuild the gang ledger (engine/gang.py) from the snapshot's
        group records — group TTLs get the same charge-then-rebase
        treatment as reservations, and an expired group's surviving member
        reservations are removed (all-or-nothing across the crash). Then
        the journal's GANG control-line tail is applied: a group whose
        last stamp is ``begin`` (no commit) crashed mid-reserve and is
        rolled back — the defense-in-depth half behind the gang lock's
        snapshot atomicity. Call AFTER ``restore_reservations``."""
        state = (self.snapshot or {}).get("gangs") or {}
        now = self.clock.now()
        elapsed_s = 0.0
        taken_at = (self.snapshot or {}).get("takenAt")
        if taken_at:
            from datetime import datetime

            try:
                taken = datetime.fromisoformat(taken_at)
                if taken.tzinfo is None and now.tzinfo is not None:
                    taken = taken.replace(tzinfo=now.tzinfo)
                elapsed_s = max(0.0, (now - taken).total_seconds())
            except (ValueError, TypeError):  # pragma: no cover — we wrote it
                pass
        restored, dropped = ledger.restore_state(state, now=now, elapsed_s=elapsed_s)
        self.report.gangs_restored += restored
        self.report.gangs_expired_dropped += dropped
        if journal is not None:
            self.report.gangs_rolled_back += ledger.rollback_uncommitted(
                journal.gang_ops
            )
        if restored or dropped or self.report.gangs_rolled_back:
            logger.info(
                "recovery: %d gang(s) restored, %d expired dropped, %d "
                "uncommitted rolled back",
                restored, dropped, self.report.gangs_rolled_back,
            )

    # -- step 4: reconcile ---------------------------------------------------

    @staticmethod
    def _flags_of_status(thr) -> dict:
        flags = thr.status.throttled
        return {
            "pod": bool(flags.resource_counts_pod),
            "requests": {
                str(k): bool(v) for k, v in (flags.resource_requests or {}).items()
            },
        }

    def reconcile(
        self,
        informers,
        device_manager=None,
        enqueue: Optional[Mapping[str, Callable[[str], None]]] = None,
    ) -> int:
        """First-relist reconcile: the rebuilt published ``st_*`` planes
        must agree with the statuses the informer caches carry — any
        mismatch is a recovery divergence: counted, logged, and repaired by
        enqueueing the key for a fresh reconcile. Also counts (detail only,
        not a divergence) keys whose flags progressed past the snapshot —
        the journal tail legitimately outruns the snapshot's planes.
        Returns the divergence count."""
        kinds = {
            "throttle": informers.throttles(),
            "clusterthrottle": informers.cluster_throttles(),
        }
        planes = (
            device_manager.published_flags() if device_manager is not None else None
        )
        snap_published = (self.snapshot or {}).get("published") or {}
        divergences = 0
        for kind, informer in kinds.items():
            relisted = informer.snapshot_objects()
            expected = {
                key: self._flags_of_status(thr) for key, thr in relisted.items()
            }
            if planes is not None:
                plane = planes.get(kind, {})
                for key, want in expected.items():
                    got = plane.get(key)
                    if got != want:
                        divergences += 1
                        logger.warning(
                            "recovery divergence: %s %s plane=%r status=%r — "
                            "re-enqueueing for repair", kind, key, got, want,
                        )
                        self.report.repaired_keys.append(f"{kind}/{key}")
                        if enqueue is not None and kind in enqueue:
                            enqueue[kind](key)
            snap_kind = snap_published.get(kind) or {}
            self.report.snapshot_drift_keys += sum(
                1
                for key, flags in snap_kind.items()
                if key in expected and expected[key] != flags
            )
        self.report.divergences += divergences
        return divergences

    # -- probes -------------------------------------------------------------

    def snapshot_age_seconds(self) -> Optional[float]:
        """Age of the snapshot recovery restored from (None when recovery
        ran without one)."""
        if self.report.snapshot_taken_at is None:
            return None
        from datetime import datetime

        try:
            taken = datetime.fromisoformat(self.report.snapshot_taken_at)
        except ValueError:  # pragma: no cover — snapshot wrote isoformat
            return None
        now = self.clock.now()
        if taken.tzinfo is None and now.tzinfo is not None:
            taken = taken.replace(tzinfo=now.tzinfo)
        return max(0.0, (now - taken).total_seconds())

    def health_state(self) -> Tuple[str, dict]:
        """Health component (health.py): degraded when recovery had to
        reject a corrupt snapshot or found plane divergences — it still
        serves (older snapshot / genesis replay / repair enqueued), but the
        operator should know the crash left marks."""
        r = self.report
        age = self.snapshot_age_seconds()
        detail = {
            "mode": r.journal_mode,
            "snapshotSeq": r.snapshot_seq,
            "snapshotAgeSeconds": round(age, 3) if age is not None else None,
            "snapshotsRejected": r.snapshots_rejected,
            "journalLinesReplayed": r.journal_lines_replayed,
            "journalInteriorSkipped": r.journal_interior_skipped,
            "journalTornTails": r.journal_torn_tails,
            "reservationsRestored": r.reservations_restored,
            "reservationsExpiredDropped": r.reservations_expired_dropped,
            "gangsRestored": r.gangs_restored,
            "gangsExpiredDropped": r.gangs_expired_dropped,
            "gangsRolledBack": r.gangs_rolled_back,
            "preemptsRolledBack": r.preempts_rolled_back,
            "preemptVictimsRestored": r.preempt_victims_restored,
            "reconcileDivergences": r.divergences,
            "durationSeconds": round(r.duration_s, 4),
        }
        degraded = bool(r.snapshots_rejected or r.divergences)
        return ("degraded" if degraded else "ok"), detail
