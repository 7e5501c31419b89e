"""Atomic, checksummed, versioned snapshots of the standalone daemon's
full recoverable state.

The journal (engine/journal.py) already makes the Store durable, but a
journal-only restart replays from genesis (or the last compaction) and
recovers NOTHING that never flows through store events: standing
scheduler-cycle reservations and their TTL deadlines, and the published
``st_*`` device planes a recovering process must agree with. A snapshot
captures all of it at one consistent instant:

- every stored object (namespaces first, then throttles, then pods) as
  round-trippable manifest dicts (api/serialization.py);
- the store's resourceVersion high-water mark (restored so post-recovery
  writes never reuse a version an old client observed);
- per-kind reservation ledgers with TTLs serialized as REMAINING seconds —
  restore rebases them against the restored clock, so a deadline can never
  resurrect just because wall time moved while the process was dead;
- the published ``st_*`` devicestate planes per throttle key (recovery's
  divergence oracle: rebuilt planes must match restored statuses);
- the journal's ``(byte offset, sha256)`` at cut time — the tail-replay
  anchor (see engine/recovery.py).

File format: one JSON header line ``{"format", "version", "sha256",
"length"}`` followed by the JSON payload. The payload checksum makes a
torn or bit-rotted snapshot DETECTABLE, and the writer makes torn ones
IMPOSSIBLE to observe under its own name: payload is written to a temp
file in the same directory, fsynced, then atomically renamed to
``snapshot-<seq>.ktsnap`` (the directory is fsynced after the rename so
the new name itself survives a power cut). Recovery walks snapshots
newest-first and falls back to older ones on checksum failure.

Snapshots are cut on a journal-size trigger (``StoreJournal.set_snapshotter``)
and at graceful shutdown (cli.py). Consistency: the payload is gathered
under the store lock (reentrant when the trigger fires inside dispatch),
so objects, reservations, planes, and the journal position all describe
the same instant in the event stream.

Crash points (``crash.snapshot.*``, faults/plan.py) SIGKILL the writer at
every interesting instant — before the write, mid-tmp-file, before and
after the rename, and mid-prune — and the crash harness
(tools/crashtest.py) proves recovery survives each artifact.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

from ..faults.plan import maybe_crash
from ..utils.clock import Clock, RealClock
from ..utils.lockorder import guard_attrs, make_lock
from .store import Store

logger = logging.getLogger(__name__)

SNAPSHOT_FORMAT = "kube-throttler-snapshot"
# v1: every object (pods included) as manifest dicts in "objects".
# v2: pods move to a COLUMNAR block ("podColumns" — local string
# table + interned shape tables + per-pod id rows, engine/columnar.py) —
# ~30 bytes/pod instead of ~1 KB and no per-pod materialization on the
# write path. Readers accept both; writers emit v2 (with pods staying in
# "objects" only when the store runs the frozen-dict reference mode).
SNAPSHOT_VERSION = 2
# every entry here needs a ``snapshot:<v>`` row in version.FORMAT_REGISTRY
# (machine-checked by analysis/protocol.py): a version bump cannot land
# without declaring the minimum reader that replays it.
SUPPORTED_SNAPSHOT_VERSIONS = (1, 2)

_NAME_RE = re.compile(r"^snapshot-(\d{12})\.ktsnap$")


class SnapshotError(Exception):
    """A snapshot file that must not be trusted: bad header, unsupported
    version, truncated payload, or checksum mismatch."""


def snapshot_name(seq: int) -> str:
    return f"snapshot-{seq:012d}.ktsnap"


def find_snapshots(directory: str) -> List[Tuple[int, str]]:
    """``[(seq, path)]`` of well-NAMED snapshots, newest (highest seq)
    first. Validity is the loader's job — a corrupt file still lists, so
    recovery can count it as rejected and fall back."""
    out: List[Tuple[int, str]] = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return out
    for name in entries:
        m = _NAME_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def parse_snapshot_bytes(blob: bytes, origin: str = "<bytes>") -> dict:
    """Parse + verify a snapshot from raw bytes (header line + payload) —
    the form a replication bootstrap receives over the wire. Raises
    :class:`SnapshotError` on any integrity failure."""
    header_line, _, body = blob.partition(b"\n")
    try:
        header = json.loads(header_line.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise SnapshotError(f"bad snapshot header in {origin}: {e}") from e
    if header.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotError(f"{origin}: not a {SNAPSHOT_FORMAT} file")
    if header.get("version") not in SUPPORTED_SNAPSHOT_VERSIONS:
        raise SnapshotError(
            f"{origin}: unsupported snapshot version {header.get('version')!r} "
            f"(this reader supports {SUPPORTED_SNAPSHOT_VERSIONS}; upgrade "
            f"the reader, the writer was newer)"
        )
    length = int(header.get("length", -1))
    payload = body.rstrip(b"\n")
    if length != len(payload):
        raise SnapshotError(
            f"{origin}: truncated payload ({len(payload)} bytes, header says {length})"
        )
    digest = hashlib.sha256(payload).hexdigest()
    if digest != header.get("sha256"):
        raise SnapshotError(f"{origin}: payload checksum mismatch")
    try:
        return json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:  # pragma: no cover — sha256 gate
        raise SnapshotError(f"{origin}: undecodable payload: {e}") from e


def load_snapshot(path: str) -> dict:
    """Parse + verify one snapshot file; returns the payload dict. Raises
    :class:`SnapshotError` on any integrity failure (the caller falls back
    to an older snapshot or to pure journal replay)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise SnapshotError(f"unreadable snapshot {path}: {e}") from e
    return parse_snapshot_bytes(blob, origin=path)


@guard_attrs
class SnapshotManager:
    """Cuts snapshots of a Store (+ reservations, + published planes) into
    a directory; prunes superseded ones; serves health/metrics probes.

    ``reservations`` ({kind: ReservedResourceAmounts}) and
    ``device_manager`` are late-bound attributes — the CLI wires them after
    the plugin exists. ``bind_journal`` arms the journal-size trigger and
    makes every snapshot record the journal tail anchor."""

    # _seq moves under the lock; the stats below are single-writer values
    # read by health/metrics probes — unguarded on purpose (same stance as
    # the journal's robustness counters)
    GUARDED_BY = {"_seq": "self._lock"}

    def __init__(
        self,
        directory: str,
        store: Store,
        reservations: Optional[Dict[str, object]] = None,
        device_manager=None,
        clock: Optional[Clock] = None,
        keep: int = 3,
        faults=None,
        gang_ledger=None,
    ):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.store = store
        self.reservations = reservations or {}
        # gang ledger (engine/gang.py): its lock is held around the
        # reservation + gang capture below, which is what makes every
        # snapshot gang-ATOMIC — a half-formed group reserve can never be
        # observed by a snapshot, so recovery is always fully-reserved or
        # fully-rolled-back
        self.gang_ledger = gang_ledger
        self.device_manager = device_manager
        self.clock = clock or RealClock()
        self.keep = max(1, int(keep))
        self.faults = faults
        self.journal = None
        # HA fencing (engine/replication.py): when bound and stale, write()
        # refuses — a deposed leader must not publish snapshots a standby
        # could later bootstrap from
        self.fencing = None
        self._lock = make_lock("snapshot")
        existing = find_snapshots(directory)
        self._seq = existing[0][0] if existing else 0
        # single-writer stats (health/metrics probes read these)
        self.snapshots_written = 0
        self.snapshot_failures = 0
        self.stale_epoch_rejected = 0
        self.last_snapshot_time = None  # datetime (self.clock domain)
        self.last_snapshot_seq: Optional[int] = None
        self.last_snapshot_path: Optional[str] = None
        self.last_snapshot_reason: Optional[str] = None

    def bind_journal(self, journal, every_lines: int) -> None:
        """Record journal positions in snapshots and cut one every
        ``every_lines`` appended journal lines."""
        self.journal = journal
        journal.set_snapshotter(self, every_lines)

    # -- write --------------------------------------------------------------

    def snapshot_on_journal_trigger(self) -> None:
        """Journal-size trigger entry point — called from inside the
        store's dispatch (store lock held, journal lock released). Never
        raises into the dispatch path."""
        try:
            self.write(reason="journal-size")
        except Exception:  # noqa: BLE001 — dispatch must survive any writer bug
            logger.exception("snapshot trigger failed; ingest continues")

    def _gather(self, reason: str, seq: int) -> dict:
        """Materialize the payload under ONE store-lock hold (reentrant
        when triggered from dispatch), so objects, reservations, planes,
        and the journal anchor describe the same instant."""
        import contextlib

        from ..api.serialization import object_to_dict

        with self.store._lock:  # noqa: SLF001 — same-package access
            now = self.clock.now()
            objs = []
            for ns in self.store.list_namespaces():
                objs.append(object_to_dict(ns))
            for thr in self.store.list_throttles():
                objs.append(object_to_dict(thr))
            for thr in self.store.list_cluster_throttles():
                objs.append(object_to_dict(thr))
            arena = self.store.pod_arena
            pod_columns = None
            if arena is not None:
                # v2 columnar pod block: exported straight from the arena
                # (no per-pod materialization on the snapshot path)
                pod_columns = arena.export_columns(list(arena.keys()))
            else:
                for pod in self.store.list_pods():
                    objs.append(object_to_dict(pod))
            epoch = 0
            if self.fencing is not None:
                epoch = self.fencing.current()
            elif self.journal is not None:
                epoch = self.journal.last_epoch
            # the gang lock spans the reservation AND gang captures: a
            # reserve_group in flight holds it for its whole member loop,
            # so this gather waits it out and never sees a partial group
            # (lock order store → gang → reservation locks)
            gang_guard = (
                self.gang_ledger.lock
                if self.gang_ledger is not None
                else contextlib.nullcontext()
            )
            with gang_guard:
                payload = {
                    "seq": seq,
                    "reason": reason,
                    "epoch": epoch,
                    "takenAt": now.isoformat(),
                    "rv": self.store.latest_resource_version,
                    "objects": objs,
                    **({"podColumns": pod_columns} if pod_columns is not None else {}),
                    "reservations": {
                        kind: cache.snapshot_state(now)
                        for kind, cache in self.reservations.items()
                    },
                    "gangs": (
                        self.gang_ledger.snapshot_state(now)
                        if self.gang_ledger is not None
                        else None
                    ),
                    # open (begin-without-commit) preemptions at cut time:
                    # a tail-mode recovery whose anchor sits past the
                    # PREEMPT begin line still learns which eviction to
                    # roll back (engine/journal.py open_preempts; store →
                    # journal lock order, the dispatch path's own)
                    "preempts": (
                        self.journal.open_preempts()
                        if self.journal is not None
                        else None
                    ),
                    "published": (
                        self.device_manager.published_flags()
                        if self.device_manager is not None
                        else None
                    ),
                    "journal": (
                        dict(zip(("offset", "sha256"), self.journal.position()))
                        if self.journal is not None
                        else None
                    ),
                }
        return payload

    def write(self, reason: str = "manual") -> Optional[str]:
        """Cut one snapshot; returns its path, or None on an I/O failure
        (counted; the journal is still intact, so a failed snapshot only
        costs recovery speed, never correctness) — or None, counted
        separately, when this replica's fencing epoch has gone stale (a
        deposed leader must stop publishing snapshots)."""
        if self.fencing is not None and self.fencing.is_stale():
            self.stale_epoch_rejected += 1
            logger.warning(
                "snapshot (%s) refused: fencing epoch %d is stale",
                reason, self.fencing.current(),
            )
            return None
        maybe_crash(self.faults, "crash.snapshot.begin")
        with self._lock:
            self._seq += 1
            seq = self._seq
        try:
            payload = self._gather(reason, seq)
            path = self._write_atomic(payload, seq)
        except OSError:
            self.snapshot_failures += 1
            logger.warning(
                "snapshot %d (%s) failed; journal remains the recovery "
                "source", seq, reason, exc_info=True,
            )
            return None
        self.snapshots_written += 1
        self.last_snapshot_time = self.clock.now()
        self.last_snapshot_seq = seq
        self.last_snapshot_path = path
        self.last_snapshot_reason = reason
        self._prune()
        logger.info(
            "snapshot %s written (%s, %d objects)",
            path, reason, len(payload["objects"]),
        )
        return path

    def _write_atomic(self, payload: dict, seq: int) -> str:
        data = json.dumps(payload).encode("utf-8")
        header = json.dumps(
            {
                "format": SNAPSHOT_FORMAT,
                "version": SNAPSHOT_VERSION,
                "sha256": hashlib.sha256(data).hexdigest(),
                "length": len(data),
                # fencing epoch in the HEADER too: replication can answer
                # "whose term is this snapshot from" without parsing the
                # payload (loaders ignore unknown header keys)
                "epoch": payload.get("epoch", 0),
            }
        ).encode("utf-8")
        blob = header + b"\n" + data + b"\n"
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob[: len(blob) // 2])
                f.flush()
                # half the tmp file flushed, nothing renamed: the artifact
                # recovery must IGNORE (and clean up) without rejecting the
                # older complete snapshots next to it
                maybe_crash(self.faults, "crash.snapshot.tmp_partial")
                f.write(blob[len(blob) // 2 :])
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        final = os.path.join(self.directory, snapshot_name(seq))
        # tmp is complete + fsynced but unnamed: recovery sees only the
        # previous snapshots
        maybe_crash(self.faults, "crash.snapshot.pre_rename")
        # HA kill site: the leader dies mid-snapshot during a failover run
        # (tmp complete, rename pending) — the standby must promote from
        # the replicated journal, ignoring the orphan tmp
        maybe_crash(self.faults, "ha.snapshot.write")
        os.replace(tmp, final)
        self._fsync_dir()
        # renamed but superseded snapshots not yet pruned: recovery must
        # pick THIS one (highest seq) and ignore the stragglers
        maybe_crash(self.faults, "crash.snapshot.post_rename")
        return final

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.directory, os.O_RDONLY)
        except OSError:  # pragma: no cover — platform without dir-open
            return
        try:
            os.fsync(dfd)
        except OSError:  # pragma: no cover
            pass
        finally:
            os.close(dfd)

    def _prune(self) -> None:
        """Unlink snapshots beyond the newest ``keep`` (best effort — a
        crash mid-prune just leaves extra old snapshots for next time)."""
        for _seq, path in find_snapshots(self.directory)[self.keep :]:
            try:
                os.unlink(path)
            except OSError:  # pragma: no cover — racing an external cleaner
                continue
            maybe_crash(self.faults, "crash.snapshot.prune")

    # -- probes -------------------------------------------------------------

    def snapshot_age_seconds(self) -> Optional[float]:
        """Seconds since the last snapshot THIS process wrote (None before
        the first one — recovery's restored-snapshot age is reported by the
        recovery component instead)."""
        if self.last_snapshot_time is None:
            return None
        return max(0.0, (self.clock.now() - self.last_snapshot_time).total_seconds())

    def health_state(self) -> Tuple[str, dict]:
        """Health component (health.py): degraded while snapshot writes are
        failing — the journal still recovers everything except reservation
        TTL continuity, but an operator should know the snapshot cadence
        stopped."""
        age = self.snapshot_age_seconds()
        detail = {
            "written": self.snapshots_written,
            "failures": self.snapshot_failures,
            "lastSeq": self.last_snapshot_seq,
            "ageSeconds": round(age, 3) if age is not None else None,
            "staleEpochRejected": self.stale_epoch_rejected,
        }
        if self.stale_epoch_rejected:
            return "down", detail  # fenced replica: must not serve
        return ("degraded" if self.snapshot_failures else "ok"), detail
