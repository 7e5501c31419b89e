"""Durable event journal for the standalone Store.

The reference is crash-only because its state of record lives on the
kube-apiserver — informer caches resync on restart (plugin.go:114-130) and
reservations are scheduler-cycle-transient (SURVEY §5). This build has the
same stance in remote (``--kubeconfig``) mode: reflectors rebuild the cache
from the real apiserver. In STANDALONE mode, however, the in-memory Store
IS the apiserver, so crash-only needs a durable log: the journal appends
every watch event as a JSON line and replays it on startup, making
``status``/spec state survive a daemon restart.

Format: one ``{"type": ..., "kind": ..., "object": {...}}`` per line —
deliberately the watch wire-event shape (client/transport.py), so the
journal doubles as a replayable watch stream. Corruption handling on
replay distinguishes two cases:

- a torn FINAL line (crash between ``write()`` and the newline) is the
  legal crash artifact — it is silently truncated away and counted in
  ``torn_tails`` without degrading health;
- a corrupted INTERIOR line (torn write followed by later appends, bit
  rot) — and any extra bad lines in a trailing corrupt run beyond the
  final one — is skipped and counted in ``replay_skipped``: startup must
  not abort on one bad line when every event after it is intact, and the
  health probe surfaces the loss.

When the live log exceeds ``compact_after`` lines it is compacted to a
snapshot of ADDED events (written to a temp file, atomically renamed); a
failed compaction (fsync/rename error) is logged and retried a window
later — it never breaks the store's dispatch. Because compaction
invalidates every existing snapshot's recorded journal anchor, a bound
snapshotter is triggered immediately after each compaction so the newest
snapshot always carries a valid anchor (local recovery falls back to
genesis replay either way; streaming standbys re-bootstrap from the
newest snapshot and need its anchor to resolve).

The journal also maintains a running ``(byte offset, sha256)`` of its
content, exposed via :meth:`position`. Snapshots (engine/snapshot.py)
record that pair at cut time; recovery (engine/recovery.py) verifies the
prefix hash to decide whether the on-disk journal is a strict superset of
the snapshot (replay only the tail from ``start_offset``) or has been
compacted since (replay from genesis instead). ``set_snapshotter`` arms a
journal-size snapshot trigger fired every ``snapshot_every`` appended
lines (outside the journal lock, inside the store's dispatch).

Fault injection (faults/plan.py): site ``journal.append`` supports mode
``torn`` (write half the line, no newline — the next append turns it into
interior corruption) and ``error`` (drop the write); site ``journal.fsync``
fails the compaction fsync. The ``crash.journal.*`` sites SIGKILL the
process at the worst instants (see the crash harness, tools/crashtest.py).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from typing import Optional, Tuple

from ..api.serialization import object_from_dict, object_to_dict
from ..faults.plan import maybe_crash
from ..utils.lockorder import assert_held, guard_attrs, make_lock
from .store import Event, EventType, Store

logger = logging.getLogger(__name__)

# replay creation order: namespaced objects need their namespaces first
_KIND_ORDER = {"Namespace": 0, "Throttle": 1, "ClusterThrottle": 1, "Pod": 2}

# every line type this reader understands: the three watch-event types
# (store.EventType) plus the journal's own control lines. The format
# registry (version.FORMAT_REGISTRY, ``journal:*`` rows) is the durable
# contract these map to — the protocol checker (analysis/protocol.py)
# cross-checks that every control type emitted here has a registry row.
_KNOWN_LINE_TYPES = frozenset(
    {"ADDED", "MODIFIED", "DELETED", "EPOCH", "GANG", "PREEMPT"}
)


class JournalFormatError(Exception):
    """An UNKNOWN-BUT-VERSIONED control line: an uppercase ``type`` this
    reader does not recognise and that carries no ``object`` payload —
    the shape a NEWER writer's control line takes (rolling-upgrade skew:
    the journal was written by a later build). Unlike torn/corrupt lines
    (skip-and-count — losing one event beats losing the post-gap
    history), this is a *format* boundary: silently skipping a control
    line whose semantics we do not know (a future fencing or rollback
    bracket, say) risks replaying into a state the writer never meant,
    so replay STOPS deterministically, the refusal is counted and named
    (``format_refused`` / ``format_refused_reason``), and the health
    probe reports ``down`` until a reader of at least the line's
    ``minReader`` version replays it."""


def hash_prefix(path: str, length: int):
    """sha256 object over the first ``length`` bytes of ``path``, or None
    when the file is missing or shorter than ``length`` (the prefix a
    snapshot recorded no longer exists as-is). Recovery compares its
    hexdigest against the snapshot's recorded journal hash, and on a match
    seeds :func:`attach`'s ``resume_hash`` with the returned object so the
    running hash stays continuous across the tail replay."""
    if length < 0 or not os.path.exists(path):
        return None
    h = hashlib.sha256()
    remaining = length
    with open(path, "rb") as f:
        while remaining > 0:
            chunk = f.read(min(1 << 20, remaining))
            if not chunk:
                return None  # file shorter than the recorded offset
            h.update(chunk)
            remaining -= len(chunk)
    return h


@guard_attrs
class StoreJournal:
    """Attach with :func:`attach`; detach via :meth:`close`."""

    # the live-append file handle, its line counter, and the running
    # content position move only under the journal lock (the robustness
    # counters are single-writer ints read by health probes — unguarded on
    # purpose)
    GUARDED_BY = {
        "_file": "self._lock",
        "_lines": "self._lock",
        "_bytes": "self._lock",
        "_sha": "self._lock",
        "_snapshotter": "self._lock",
        "snapshot_every": "self._lock",
        "_lines_since_snapshot": "self._lock",
    }

    def __init__(
        self, store: Store, path: str, compact_after: int = 100_000, faults=None
    ):
        self.store = store
        self.path = path
        self.compact_after = compact_after
        self.faults = faults
        self._lock = make_lock("journal")
        # HA fencing (engine/replication.py): when a FencingEpoch is bound
        # and marked stale (leadership lost), every append is refused and
        # counted — a paused-then-resumed old leader cannot extend a log a
        # promoted standby no longer follows. ``last_epoch`` is the highest
        # EPOCH control line seen (replay or set_epoch); single-writer,
        # read by probes/recovery (same stance as the counters below).
        self.fencing = None
        self.last_epoch = 0
        # GANG control lines (engine/gang.py): group_key → {"op": last op
        # seen ("begin"|"commit"|"rollback"), "members": [...]} — recovery
        # reads begin-without-commit as a mid-reserve crash and rolls the
        # group's member reservations back (GangLedger.rollback_uncommitted).
        # Single-writer under the journal lock, read after replay.
        self.gang_ops: dict = {}
        # PREEMPT control lines (policy/preempt.py): preempt_id → {"op":
        # last op seen ("begin"|"commit"|"rollback"), "victims": [...],
        # "objects": [...serialized victim pods...]}. A begin-without-
        # commit tail is a mid-eviction crash: recovery re-creates the
        # victims from the begin line's objects — an uncommitted
        # preemption rolls back to ZERO evictions (the GANG contract's
        # mirror, but over store state, so the rollback payload must ride
        # the journal). Single-writer under the journal lock.
        self.preempt_ops: dict = {}
        self._lines = 0
        self._file = None
        # running position of the journal content: byte length + sha256 of
        # everything up to it (seeded by attach() from the replay)
        self._bytes = 0
        self._sha = hashlib.sha256()
        # journal-size snapshot trigger (engine/snapshot.py binds these)
        self._snapshotter = None
        self.snapshot_every = 0
        self._lines_since_snapshot = 0
        # group-commit durability knob: True adds ONE fsync per batched
        # write (still "at most one fsync per batch"); False (default)
        # keeps the append path's flush-only durability, same as the
        # single-event path (fsync happens at compaction/close)
        self.fsync_batches = False
        # robustness counters (health probe + tests read these)
        self.replay_skipped = 0  # corrupted interior lines skipped on replay
        self.torn_tails = 0  # torn final lines truncated (normal crash artifact)
        self.write_errors = 0  # appends dropped (injected/real write failure)
        self.torn_writes = 0  # injected torn appends
        self.compact_failures = 0  # compactions aborted (old log kept)
        self.replayed_events = 0  # events applied by the last replay
        self.stale_epoch_rejected = 0  # appends refused by the fencing gate
        self.preempts_rolled_back = 0  # uncommitted preemptions rolled back
        self.preempt_victims_restored = 0  # victim pods re-created by rollback
        # rolling-upgrade format refusal (JournalFormatError): replay hit a
        # control line from a newer writer and stopped. Single-writer,
        # read by the health probe — the reason names the line type and
        # the minimum reader version it demands.
        self.format_refused = 0
        self.format_refused_reason: Optional[str] = None

    # -- replay -------------------------------------------------------------

    def _replay(
        self, start_offset: int = 0, resume_hash=None
    ) -> Tuple[int, Optional[int], int, "hashlib._Hash"]:
        """Apply journaled events (from ``start_offset``) to the store.
        Returns ``(applied, truncate_at, end_bytes, end_sha)``: the event
        count, the byte offset to truncate at when the file ends in a
        corrupt run (else None), and the byte length + sha256 of the
        journal content that remains valid. The caller MUST truncate before
        appending: appending past a corrupt tail would strand every later
        event behind the gap on all future replays (silent loss of
        post-crash history).

        Corruption classification:

        - a bad line with ANY write after it — a later line, or even just
          its own terminating newline — cannot be the crash-mid-write
          artifact: it is real corruption, skipped and counted in
          ``replay_skipped`` with its line number. Aborting would trade
          one lost event for the whole post-gap history, so it stays in
          the file (and is re-counted on every replay until a compaction
          heals the log).
        - only a FINAL line with no terminating newline is the legal
          crash-mid-write artifact: truncated silently, counted in
          ``torn_tails`` (health stays ok)."""
        h = resume_hash.copy() if resume_hash is not None else hashlib.sha256()
        if not os.path.exists(self.path):
            return 0, None, start_offset, h
        applied = 0
        offset = start_offset  # byte offset after the current line
        last_line_start = start_offset
        h_before_last = h.copy()  # content hash up to last_line_start
        last_newline = True
        bad_run: list = []  # (lineno, error) since the last good line
        with open(self.path, "rb") as f:
            f.seek(start_offset)
            for lineno, raw in enumerate(f, 1):
                last_line_start = offset
                h_before_last = h.copy()
                offset += len(raw)
                h.update(raw)
                last_newline = raw.endswith(b"\n")
                line = raw.strip()
                if not line:
                    continue  # blank line: harmless, neither good nor bad
                try:
                    event = json.loads(line.decode("utf-8"))
                    self._apply(event)
                except JournalFormatError as e:
                    # a control line from a NEWER writer: refuse replay
                    # deterministically — count, name the version demand,
                    # and STOP (skip-and-continue here could replay into a
                    # state the writer never meant). Pending bad lines are
                    # still counted so the probe's detail stays honest. The
                    # remainder of the file is hashed (not applied) so the
                    # accounted position stays consistent with the bytes on
                    # disk; health_state reports down until a new-enough
                    # reader replays the log.
                    for bad_lineno, err in bad_run:
                        self.replay_skipped += 1
                        logger.warning(
                            "journal %s: skipping corrupted line %d (%s)",
                            self.path, bad_lineno, err,
                        )
                    self.format_refused += 1
                    self.format_refused_reason = str(e)
                    logger.error(
                        "journal %s: replay REFUSED at line %d: %s",
                        self.path, lineno, e,
                    )
                    rest = f.read()
                    h.update(rest)
                    offset += len(rest)
                    return applied, None, offset, h
                except (
                    json.JSONDecodeError,
                    KeyError,
                    ValueError,
                    UnicodeDecodeError,
                ) as e:
                    bad_run.append((lineno, str(e)))
                    continue
                applied += 1
                # bad lines BEFORE a good line are interior corruption:
                # skip-and-count, never truncate (that would delete the
                # good history that follows)
                for bad_lineno, err in bad_run:
                    self.replay_skipped += 1
                    logger.warning(
                        "journal %s: skipping corrupted line %d (%s)",
                        self.path, bad_lineno, err,
                    )
                bad_run = []
        if bad_run and not last_newline:
            # the torn final line (no newline = the write never finished):
            # truncate it alone, silently. Bad lines ahead of it in the
            # run are newline-terminated — genuine corruption, counted,
            # and left in place like interior corruption.
            for bad_lineno, err in bad_run[:-1]:
                self.replay_skipped += 1
                logger.warning(
                    "journal %s: skipping corrupted line %d (%s)",
                    self.path, bad_lineno, err,
                )
            self.torn_tails += 1
            logger.debug(
                "journal %s: truncating torn final line %d (%s) — normal "
                "crash artifact",
                self.path, bad_run[-1][0], bad_run[-1][1],
            )
            return applied, last_line_start, last_line_start, h_before_last
        for bad_lineno, err in bad_run:
            # trailing but newline-terminated: a write landed after the
            # corruption, so this is interior-class corruption that merely
            # has no good line after it YET
            self.replay_skipped += 1
            logger.warning(
                "journal %s: skipping corrupted line %d (%s)",
                self.path, bad_lineno, err,
            )
        return applied, None, offset, h

    def _apply(self, event: dict) -> None:
        etype = event["type"]
        if etype == "EPOCH":
            # fencing control line (engine/replication.py): records the
            # leadership term under which the following events were
            # written — no store effect, but recovery/promotion read the
            # high-water term from it
            self.last_epoch = max(self.last_epoch, int(event.get("epoch", 0)))
            return
        if etype == "GANG":
            # gang control line (engine/gang.py): group reserve/rollback
            # audit stamp — no store effect; last op per group wins
            group = str(event.get("group", ""))
            if group:
                entry = {"op": str(event.get("op", ""))}
                members = event.get("members")
                if members is not None:
                    entry["members"] = [str(m) for m in members]
                elif group in self.gang_ops and "members" in self.gang_ops[group]:
                    entry["members"] = self.gang_ops[group]["members"]
                self.gang_ops[group] = entry
            return
        if etype == "PREEMPT":
            # preemption control line (policy/preempt.py): victim-eviction
            # bracket — no store effect on replay; last op per id wins.
            # The begin line carries the serialized victims so recovery
            # can restore an uncommitted eviction to zero victims
            # (rollback_uncommitted_preempts).
            pid = str(event.get("id", ""))
            if pid:
                entry = {"op": str(event.get("op", ""))}
                prev = self.preempt_ops.get(pid) or {}
                for field in ("victims", "victimObjects"):
                    if event.get(field) is not None:
                        entry[field] = list(event[field])
                    elif field in prev:
                        entry[field] = prev[field]
                self.preempt_ops[pid] = entry
            return
        if (
            isinstance(etype, str)
            and etype.isupper()
            and etype not in _KNOWN_LINE_TYPES
            and "object" not in event
        ):
            # uppercase type, no object payload: the control-line shape,
            # but a type this reader does not know — a newer writer's
            # line, not bit rot. Refuse by name (the line may carry its
            # own ``minReader`` stamp; otherwise the demand is unknown).
            from ..version import local_proto_version

            need = event.get("minReader", "unknown")
            ours = "%d.%d" % local_proto_version()
            raise JournalFormatError(
                f"unknown control line type {etype!r} requires reader "
                f">= {need} (this reader speaks {ours}); refusing replay"
            )
        kind = event["kind"]
        obj = object_from_dict({**event["object"], "kind": kind})
        store = self.store
        if etype == "DELETED":
            try:
                if kind == "Pod":
                    store.delete_pod(obj.namespace, obj.name)
                elif kind == "Namespace":
                    store.delete_namespace(obj.name)
                elif kind == "Throttle":
                    store.delete_throttle(obj.namespace, obj.name)
                else:
                    store.delete_cluster_throttle(obj.name)
            except KeyError:
                pass
            return
        # ADDED/MODIFIED → upsert (replay must be idempotent-ish: a
        # compacted snapshot starts from ADDED lines)
        try:
            if kind == "Pod":
                store.create_pod(obj)
            elif kind == "Namespace":
                store.create_namespace(obj)
            elif kind == "Throttle":
                store.create_throttle(obj)
            else:
                store.create_cluster_throttle(obj)
        except ValueError:
            if kind == "Pod":
                store.update_pod(obj)
            elif kind == "Namespace":
                store.update_namespace(obj)
            elif kind == "Throttle":
                store.update_throttle(obj)
            else:
                store.update_cluster_throttle(obj)

    # -- live append ----------------------------------------------------------

    @staticmethod
    def _encode(event: Event) -> str:
        return json.dumps(
            {
                "type": event.type.value,
                "kind": event.kind,
                "object": object_to_dict(event.obj),
            }
        )

    def on_batch(self, events) -> None:
        """GROUP COMMIT (store batch-listener hook): journal a whole ingest
        batch as ONE buffered write + one flush (+ at most one fsync when
        ``fsync_batches`` is set) instead of a write+flush syscall pair per
        event.

        Crash contract (tools/crashtest.py site ``crash.journal.group_commit``):
        the batch's lines are concatenated in event order and handed to the
        file in one write, so a crash anywhere inside the commit leaves a
        strict PREFIX of the batch on disk — every complete line replays,
        and only the FINAL surviving record can be torn (truncated by
        recovery as the normal torn-tail artifact). No interior corruption
        is possible because nothing is appended after the cut.

        Per-line fault modes (``journal.append`` torn/error and the
        per-append ``crash.journal.*`` kill sites) keep their single-event
        meaning inside a batch: the buffer accumulated so far is flushed
        before a kill fires, so the on-disk artifact matches the
        event-by-event timeline."""
        # HA kill site: the whole batch mutated the store, but none of its
        # lines exist yet — the entire batch is unjournaled AND
        # unreplicated (tools/hatest.py asserts the standby promotes from
        # the surviving prefix with zero divergence)
        maybe_crash(self.faults, "ha.journal.batch")
        pieces: list = []
        lines_added = 0
        snapshotter = None
        with self._lock:
            if self._file is None:
                return
            if self.fencing is not None and self.fencing.is_stale():
                # fenced: a stale leader's batch must not extend the log
                self.stale_epoch_rejected += len(events)
                return
            for event in events:
                line = self._encode(event)
                fault = (
                    self.faults.check("journal.append")
                    if self.faults is not None
                    else None
                )
                if self.faults is not None:
                    crash = self.faults.check("crash.journal.append")
                    if crash is not None and crash.mode == "kill":
                        # die BEFORE this event's line exists — earlier batch
                        # lines already reached the store, so they reach the
                        # file first (the per-event timeline's artifact)
                        self._write_pieces_locked(pieces)
                        crash.kill()
                    crash_torn = self.faults.check("crash.journal.torn")
                    if crash_torn is not None and crash_torn.mode == "kill":
                        pieces.append(line[: max(1, len(line) // 2)])
                        self._write_pieces_locked(pieces)
                        crash_torn.kill()
                if fault is not None and fault.mode == "error":
                    self.write_errors += 1
                    continue
                if fault is not None and fault.mode == "torn":
                    # half the line, no newline: the NEXT buffered line
                    # concatenates onto it — one corrupt interior line,
                    # exactly the single-event torn artifact
                    pieces.append(line[: max(1, len(line) // 2)])
                    self.torn_writes += 1
                    lines_added += 1
                    continue
                pieces.append(line + "\n")
                lines_added += 1
            if pieces:
                crash_gc = (
                    self.faults.check("crash.journal.group_commit")
                    if self.faults is not None
                    else None
                )
                if crash_gc is not None and crash_gc.mode == "kill":
                    # die MID-COMMIT: half the batch buffer reaches the file
                    # (cutting through a line), then SIGKILL — recovery must
                    # see a clean prefix with one torn tail, zero divergence
                    data = "".join(pieces)
                    self._file.write(data[: max(1, len(data) // 2)])
                    self._file.flush()
                    crash_gc.kill()
                self._write_pieces_locked(pieces)
                if self.fsync_batches:
                    try:
                        os.fsync(self._file.fileno())
                    except OSError:  # pragma: no cover — fsync race on close
                        pass
            self._lines += lines_added
            compacted = False
            if self._lines >= self.compact_after:
                try:
                    self._compact_locked()
                    compacted = True
                except OSError:
                    self.compact_failures += 1
                    self._lines = 0
                    logger.warning(
                        "journal %s: compaction failed; keeping the "
                        "uncompacted log and retrying later",
                        self.path, exc_info=True,
                    )
            if self._snapshotter is not None:
                if self.snapshot_every > 0:
                    self._lines_since_snapshot += lines_added
                # a compaction invalidates every snapshot's journal anchor:
                # cut a fresh one regardless of the line budget so standby
                # bootstraps always find a resolvable anchor
                if compacted or (
                    self.snapshot_every > 0
                    and self._lines_since_snapshot >= self.snapshot_every
                ):
                    self._lines_since_snapshot = 0
                    snapshotter = self._snapshotter
        if snapshotter is not None:
            # outside the journal lock, inside the store's batch dispatch —
            # same placement as the single-event trigger
            snapshotter.snapshot_on_journal_trigger()

    def _write_pieces_locked(self, pieces) -> None:
        """One buffered write + flush of the accumulated batch lines, with
        the running (bytes, sha256) position advanced to match. Caller
        holds the journal lock."""
        assert_held(self._lock, "StoreJournal._write_pieces_locked")
        if not pieces:
            return
        data = "".join(pieces)
        raw = data.encode("utf-8")
        self._file.write(data)
        self._file.flush()
        self._sha.update(raw)
        self._bytes += len(raw)
        del pieces[:]

    def _on_event(self, event: Event) -> None:
        if self.store.in_batch_dispatch:
            return  # already group-committed by on_batch
        line = self._encode(event)
        fault = self.faults.check("journal.append") if self.faults is not None else None
        # crash points OUTSIDE the lock (SIGKILL never returns, but keeping
        # lock holds minimal keeps the site placement honest): before the
        # line hits the file at all, and the torn-then-die artifact
        maybe_crash(self.faults, "crash.journal.append")
        if event.kind in ("Throttle", "ClusterThrottle") and event.type is EventType.MODIFIED:
            # HA kill site: a status write (possibly a FLIP) reached the
            # store but its journal line never lands — the standby must
            # re-derive the flip from replicated pod/spec truth
            maybe_crash(self.faults, "ha.status.commit")
        crash_torn = (
            self.faults.check("crash.journal.torn")
            if self.faults is not None
            else None
        )
        snapshotter = None
        with self._lock:
            if self._file is None:
                return
            if self.fencing is not None and self.fencing.is_stale():
                self.stale_epoch_rejected += 1
                return
            if crash_torn is not None and crash_torn.mode == "kill":
                # the canonical crash-mid-write artifact: half the line,
                # no newline, then the process dies. Recovery must treat
                # this as a normal torn tail (truncate, stay healthy).
                self._file.write(line[: max(1, len(line) // 2)])
                self._file.flush()
                crash_torn.kill()
            if fault is not None and fault.mode == "error":
                # simulated failed write: the event never reaches the log
                # (the gap is what replay-convergence soaks must tolerate)
                self.write_errors += 1
                return
            if fault is not None and fault.mode == "torn":
                # half the line, no newline: the NEXT append concatenates
                # onto the fragment, producing one corrupt interior line —
                # the exact artifact a crash between write() and the
                # newline leaves behind
                frag = line[: max(1, len(line) // 2)].encode("utf-8")
                self._file.write(frag.decode("utf-8"))
                self._file.flush()
                self._sha.update(frag)
                self._bytes += len(frag)
                self.torn_writes += 1
                self._lines += 1
                return
            data = (line + "\n").encode("utf-8")
            self._file.write(line + "\n")
            self._file.flush()
            self._sha.update(data)
            self._bytes += len(data)
            self._lines += 1
            compacted = False
            if self._lines >= self.compact_after:
                try:
                    self._compact_locked()
                    compacted = True
                except OSError:
                    # a failed compaction (disk full, fsync error) must not
                    # propagate into the store's dispatch — the old log is
                    # intact and still growing; retry a full window later
                    self.compact_failures += 1
                    self._lines = 0
                    logger.warning(
                        "journal %s: compaction failed; keeping the "
                        "uncompacted log and retrying later",
                        self.path, exc_info=True,
                    )
            if self._snapshotter is not None:
                if self.snapshot_every > 0:
                    self._lines_since_snapshot += 1
                # see on_batch: a compaction must be followed by a fresh
                # snapshot or every bootstrap anchor dangles
                if compacted or (
                    self.snapshot_every > 0
                    and self._lines_since_snapshot >= self.snapshot_every
                ):
                    self._lines_since_snapshot = 0
                    snapshotter = self._snapshotter
        if snapshotter is not None:
            # journal-size snapshot trigger, OUTSIDE the journal lock (the
            # snapshot writer re-reads the journal position itself). We are
            # still inside the store's dispatch, so the store lock is held
            # (reentrant) and the cut is consistent with the event stream.
            snapshotter.snapshot_on_journal_trigger()

    def _compact_locked(self) -> None:
        """Rewrite the journal as a snapshot of the CURRENT store contents
        (ADDED lines, namespaces first), atomically. Caller holds the
        journal lock (asserted under KT_LOCK_ASSERT=1)."""
        assert_held(self._lock, "StoreJournal._compact_locked")
        epoch = self.last_epoch
        if self.fencing is not None:
            epoch = max(epoch, self.fencing.current())
        objs = []
        for ns in self.store.list_namespaces():
            objs.append(("Namespace", ns))
        for thr in self.store.list_throttles():
            objs.append(("Throttle", thr))
        for thr in self.store.list_cluster_throttles():
            objs.append(("ClusterThrottle", thr))
        for pod in self.store.list_pods():
            objs.append(("Pod", pod))
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", suffix=".journal"
        )
        new_sha = hashlib.sha256()
        new_bytes = 0
        lines = len(objs)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                if epoch > 0:
                    # compaction must not erase the fencing high-water: a
                    # genesis replay of the compacted log still learns the
                    # leadership term the objects were written under
                    data = (
                        json.dumps({"type": "EPOCH", "epoch": epoch}) + "\n"
                    ).encode("utf-8")
                    f.write(data.decode("utf-8"))
                    new_sha.update(data)
                    new_bytes += len(data)
                    lines += 1
                for group, entry in sorted(self.gang_ops.items()):
                    # compaction must not erase an in-flight gang reserve
                    # either (protocol checker: control types survive the
                    # re-emit): a begin-without-commit tail is how recovery
                    # learns a mid-reserve crash needs rolling back —
                    # committed/rolled-back groups carry no future meaning
                    # and are dropped with the rest of the history
                    if entry.get("op") != "begin":
                        continue
                    record = {"type": "GANG", "op": "begin", "group": group}
                    if "members" in entry:
                        record["members"] = list(entry["members"])
                    data = (json.dumps(record) + "\n").encode("utf-8")
                    f.write(data.decode("utf-8"))
                    new_sha.update(data)
                    new_bytes += len(data)
                    lines += 1
                for pid, entry in sorted(self.preempt_ops.items()):
                    # in-flight preemptions survive compaction the same way
                    # (protocol checker: control types survive the
                    # re-emit): a begin-without-commit marker — WITH its
                    # victim payload — is how recovery learns a mid-
                    # eviction crash must restore the victims; finished
                    # preemptions carry no future meaning and drop
                    if entry.get("op") != "begin":
                        continue
                    record = {"type": "PREEMPT", "op": "begin", "id": pid}
                    for field in ("victims", "victimObjects"):
                        if field in entry:
                            record[field] = list(entry[field])
                    data = (json.dumps(record) + "\n").encode("utf-8")
                    f.write(data.decode("utf-8"))
                    new_sha.update(data)
                    new_bytes += len(data)
                    lines += 1
                for kind, obj in objs:
                    data = (
                        json.dumps(
                            {"type": "ADDED", "kind": kind, "object": object_to_dict(obj)}
                        )
                        + "\n"
                    ).encode("utf-8")
                    f.write(data.decode("utf-8"))
                    new_sha.update(data)
                    new_bytes += len(data)
                f.flush()
                if self.faults is not None:
                    self.faults.maybe_raise(
                        "journal.fsync",
                        default=lambda: OSError("injected fsync failure"),
                    )
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        # the instant a crash invalidates every snapshot's recorded journal
        # offset (recovery must fall back to genesis replay of this file)
        maybe_crash(self.faults, "crash.journal.compact")
        self._file.close()
        self._file = open(self.path, "a", encoding="utf-8")
        self._lines = lines
        self._sha = new_sha
        self._bytes = new_bytes
        logger.info("journal %s compacted to %d objects", self.path, len(objs))

    def compact(self) -> None:
        """Force a compaction now (operational hook + the chaos soak's
        heal-the-log step): the journal becomes a clean snapshot of the
        live store, erasing any torn/corrupt interior lines."""
        if self.fencing is not None and self.fencing.is_stale():
            # a fenced (stale) leader rewriting its journal is still a
            # durable write after leadership loss — refuse, like every
            # other guarded write path (protocol checker)
            self.stale_epoch_rejected += 1
            logger.warning("journal %s: compaction refused (fenced)", self.path)
            return
        # store lock FIRST — the same order as the dispatch path
        # (store._dispatch_locked -> _on_event -> journal lock). Taking
        # only the journal lock here and letting _compact_locked's
        # store.list_* acquire the store lock underneath was an ABBA
        # inversion against concurrent writers (found by KT_LOCK_ASSERT),
        # and it could also lose a concurrent event: one appended to the
        # old file after the snapshot was cut would vanish at rotation.
        with self.store._lock:  # noqa: SLF001 — same-package access
            snapshotter = None
            with self._lock:
                if self._file is not None:
                    self._compact_locked()
                    snapshotter = self._snapshotter
            if snapshotter is not None:
                # the rewrite invalidated every snapshot's journal anchor;
                # cut a fresh one (journal lock released, store lock held —
                # the same stance as the dispatch-path trigger)
                snapshotter.snapshot_on_journal_trigger()

    # -- position / snapshot trigger ---------------------------------------

    def position(self) -> Tuple[int, str]:
        """``(byte offset, sha256 hexdigest)`` of the journal content up to
        now — the tail-replay anchor a snapshot records at cut time."""
        with self._lock:
            return self._bytes, self._sha.hexdigest()

    def append_gang(self, op: str, group_key: str, members=None) -> None:
        """Append a GANG control line (engine/gang.py): ``op`` is
        ``begin`` / ``commit`` / ``rollback``. No store effect; replays
        into :attr:`gang_ops` so recovery can treat a begin-without-commit
        tail as a mid-reserve crash. Stamps are advisory audit/defense
        lines — the all-or-nothing invariant itself is held by the gang
        lock around snapshot gathers (GangLedger) — so a fenced or closed
        journal silently drops them like any other refused append."""
        record = {"type": "GANG", "op": str(op), "group": str(group_key)}
        if members is not None:
            record["members"] = list(members)
        with self._lock:
            entry = {"op": str(op)}
            if members is not None:
                entry["members"] = list(members)
            elif group_key in self.gang_ops and "members" in self.gang_ops[group_key]:
                entry["members"] = self.gang_ops[group_key]["members"]
            self.gang_ops[str(group_key)] = entry
            if self._file is None:
                return
            if self.fencing is not None and self.fencing.is_stale():
                self.stale_epoch_rejected += 1
                return
            data = (json.dumps(record) + "\n").encode("utf-8")
            self._file.write(data.decode("utf-8"))
            self._file.flush()
            self._sha.update(data)
            self._bytes += len(data)
            self._lines += 1

    def append_preempt(
        self, op: str, preempt_id: str, victims=None, objects=None
    ) -> None:
        """Append a PREEMPT control line (policy/preempt.py): ``op`` is
        ``begin`` / ``commit`` / ``rollback``. The begin line carries the
        victim keys AND their serialized objects — unlike GANG stamps
        (advisory; the invariant is lock-held), this payload IS the crash
        contract: a begin-without-commit tail tells recovery to re-create
        exactly these objects (``rollback_uncommitted_preempts``), rolling
        an interrupted eviction back to zero victims. No store effect on
        replay; a fenced or closed journal drops the stamp like any other
        refused append (the eviction then has no rollback guarantee, but a
        fenced replica must not evict at all — the scheduler is gone)."""
        record = {"type": "PREEMPT", "op": str(op), "id": str(preempt_id)}
        if victims is not None:
            record["victims"] = list(victims)
        if objects is not None:
            record["victimObjects"] = list(objects)
        with self._lock:
            entry = {"op": str(op)}
            prev = self.preempt_ops.get(str(preempt_id)) or {}
            for field in ("victims", "victimObjects"):
                if record.get(field) is not None:
                    entry[field] = list(record[field])
                elif field in prev:
                    entry[field] = prev[field]
            self.preempt_ops[str(preempt_id)] = entry
            if self._file is None:
                return
            if self.fencing is not None and self.fencing.is_stale():
                self.stale_epoch_rejected += 1
                return
            data = (json.dumps(record) + "\n").encode("utf-8")
            self._file.write(data.decode("utf-8"))
            self._file.flush()
            self._sha.update(data)
            self._bytes += len(data)
            self._lines += 1

    def open_preempts(self) -> dict:
        """Begin-without-commit preemptions (id → entry with victims +
        objects), read under the journal lock — the snapshot payload
        carries these so a tail-mode recovery whose anchor sits PAST the
        begin line still knows which eviction to roll back."""
        with self._lock:
            return {
                pid: {k: (list(v) if isinstance(v, list) else v) for k, v in e.items()}
                for pid, e in self.preempt_ops.items()
                if e.get("op") == "begin"
            }

    def set_epoch(self, epoch: int) -> None:
        """Append a fencing EPOCH control line (engine/replication.py):
        stamps the leadership term into the event stream so replay,
        recovery, and streaming standbys all learn the high-water term
        from the journal alone. No store effect; replays as a no-op."""
        epoch = int(epoch)
        with self._lock:
            if epoch <= self.last_epoch:
                return  # terms only move forward; duplicates add no info
            self.last_epoch = epoch
            if self._file is None:
                return
            if self.fencing is not None and self.fencing.is_stale():
                # a fenced journal must not extend the log with ANY line,
                # control lines included (protocol checker: every durable
                # write dominated by a fencing check)
                self.stale_epoch_rejected += 1
                return
            data = (json.dumps({"type": "EPOCH", "epoch": epoch}) + "\n").encode(
                "utf-8"
            )
            self._file.write(data.decode("utf-8"))
            self._file.flush()
            self._sha.update(data)
            self._bytes += len(data)
            self._lines += 1

    def replication_chunk(
        self, start_offset: int, max_bytes: int = 4 << 20,
        want_start_sha: bool = False,
    ) -> Optional[Tuple[bytes, int, str, int, Optional[str]]]:
        """Tail bytes for a streaming standby: ``(data, end_offset,
        end_sha_hex, position, start_sha_hex)`` covering ``[start_offset,
        min(position, start_offset+max_bytes))``. Serving only up to the
        ACCOUNTED position (never the raw file end) guarantees complete
        lines — a torn crash artifact past the position is never shipped.
        Returns None when ``start_offset`` lies beyond the position (the
        journal was compacted/rewritten under the standby).
        ``start_sha_hex`` (the prefix hash at ``start_offset``, for the
        source's continuity verification) is None unless
        ``want_start_sha``. Everything — position, bytes, and both prefix
        hashes — is read under the journal lock so a concurrent compaction
        cannot swap the file between any two of the reads."""
        with self._lock:
            position = self._bytes
            if start_offset > position:
                return None
            start_sha: Optional[str] = None
            if want_start_sha:
                if start_offset == position:
                    start_sha = self._sha.hexdigest()
                else:
                    h = hash_prefix(self.path, start_offset)
                    if h is None:
                        return None
                    start_sha = h.hexdigest()
            end = min(position, start_offset + max_bytes)
            if start_offset == end:
                return b"", position, self._sha.hexdigest(), position, start_sha
            if not os.path.exists(self.path):
                return None
            with open(self.path, "rb") as f:
                f.seek(start_offset)
                data = f.read(end - start_offset)
            if len(data) != end - start_offset:
                return None  # file shorter than accounted (rewritten)
            if end == position:
                end_sha = self._sha.hexdigest()
            else:
                h = hash_prefix(self.path, end)
                if h is None:
                    return None
                end_sha = h.hexdigest()
            return data, end, end_sha, position, start_sha

    def set_snapshotter(self, snapshotter, every_lines: int) -> None:
        """Arm the journal-size snapshot trigger: every ``every_lines``
        appended lines, ``snapshotter.snapshot_on_journal_trigger()`` runs
        (outside the journal lock, inside the store's dispatch)."""
        with self._lock:
            self._snapshotter = snapshotter
            self.snapshot_every = int(every_lines)
            self._lines_since_snapshot = 0

    def health_state(self) -> Tuple[str, dict]:
        """Health-component contract (health.py): degraded while any
        corruption/write-loss counter is nonzero — the journal still works,
        but an operator should know recovery was lossy. A truncated torn
        FINAL line (``torn_tails``) is the normal crash artifact and does
        NOT degrade; it is surfaced in the detail only."""
        detail = {
            "replaySkipped": self.replay_skipped,
            "tornTails": self.torn_tails,
            "writeErrors": self.write_errors,
            "compactFailures": self.compact_failures,
            "staleEpochRejected": self.stale_epoch_rejected,
            "epoch": self.last_epoch,
            "formatRefused": self.format_refused,
        }
        if self.format_refused:
            # replay stopped at a newer writer's control line: the store
            # behind this journal is an incomplete prefix — serving from
            # it would hand out verdicts the missing tail may contradict.
            # Down, with the version demand named for the operator.
            detail["formatRefusedReason"] = self.format_refused_reason
            return "down", detail
        if self.stale_epoch_rejected:
            # a fenced journal is not merely lossy — this replica must not
            # serve at all (a standby owns the keyspace now)
            return "down", detail
        degraded = self.replay_skipped or self.write_errors or self.compact_failures
        return ("degraded" if degraded else "ok"), detail

    def close(self) -> None:
        for kind in Store.KINDS:
            self.store.remove_event_handler(kind, self._on_event)
        self.store.remove_batch_listener(self)
        with self._lock:
            if self._file is not None:
                self._file.flush()
                try:
                    # graceful shutdown fsyncs the log: a clean SIGTERM exit
                    # must leave nothing in OS buffers a power cut could eat
                    os.fsync(self._file.fileno())
                except OSError:  # pragma: no cover — fsync of a closed fd race
                    pass
                self._file.close()
                self._file = None


def rollback_uncommitted_preempts(
    store: Store, journal: StoreJournal, extra_ops: Optional[dict] = None
) -> Tuple[int, int]:
    """Roll every begin-without-commit preemption back to ZERO evictions:
    re-create each victim whose DELETED line landed (from the begin
    line's serialized objects) and stamp ``rollback``. The creates run
    through the live store, so they re-journal as ADDED lines and the log
    stays self-reproducing. ``extra_ops`` merges snapshot-carried open
    preemptions under the journal's own (the journal wins per id — it is
    strictly newer). Returns ``(preempts rolled back, victims
    restored)``; also accumulated on the journal's counters for recovery
    reports. Idempotent: a rolled-back id's last op is ``rollback`` and
    is skipped on any later pass."""
    ops = dict(extra_ops or {})
    ops.update(journal.preempt_ops)
    rolled = restored = 0
    for pid in sorted(ops):
        entry = ops[pid]
        if entry.get("op") != "begin":
            continue
        for d in entry.get("victimObjects") or []:
            try:
                obj = object_from_dict({**d, "kind": "Pod"})
                store.create_pod(obj)
                restored += 1
            except ValueError:
                pass  # still present: its DELETED never reached the log
        journal.append_preempt("rollback", pid)
        rolled += 1
        logger.warning(
            "journal %s: preemption %s crashed mid-eviction; rolled back "
            "to zero evictions", journal.path, pid,
        )
    journal.preempts_rolled_back += rolled
    journal.preempt_victims_restored += restored
    return rolled, restored


def attach(
    store: Store,
    path: str,
    compact_after: int = 100_000,
    faults=None,
    start_offset: int = 0,
    resume_hash=None,
) -> StoreJournal:
    """Replay ``path`` into the store, then journal every subsequent event
    to it. Must run BEFORE other handlers are registered so replayed events
    don't double-dispatch.

    ``start_offset``/``resume_hash`` are the tail-replay form recovery uses
    after restoring a snapshot: replay only the bytes past ``start_offset``
    (the caller has verified, via :func:`hash_prefix`, that the prefix
    matches the snapshot's recorded hash, and hands the prefix hash object
    over so the running content hash stays continuous)."""
    journal = StoreJournal(store, path, compact_after=compact_after, faults=faults)
    n, truncate_at, end_bytes, end_sha = journal._replay(
        start_offset=start_offset, resume_hash=resume_hash
    )
    journal.replayed_events = n
    if n:
        logger.info(
            "journal %s: replayed %d events (%d corrupted line(s) skipped)",
            path, n, journal.replay_skipped,
        )
    if truncate_at is not None:
        with open(path, "r+b") as f:
            f.truncate(truncate_at)
    elif end_bytes > start_offset and os.path.exists(path):
        # a final line that PARSED but lacks its newline (crash after the
        # payload byte, before the terminator): keep the event, repair the
        # terminator — otherwise the next append would concatenate onto it
        # and corrupt both
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                with open(path, "ab") as g:
                    g.write(b"\n")
                end_sha.update(b"\n")
                end_bytes += 1
    # under the lock although pre-publication: these are declared guarded,
    # and the runtime guard (KT_LOCK_ASSERT=1) checks rebinds
    with journal._lock:
        journal._file = open(path, "a", encoding="utf-8")
        journal._lines = n
        journal._bytes = end_bytes
        journal._sha = end_sha
    for kind in Store.KINDS:
        store.add_event_handler(kind, journal._on_event, replay=False)
    # batched mutations (micro-batched ingest, batched status drains) group-
    # commit through on_batch; the per-event handler skips those dispatches
    store.add_batch_listener(journal)
    if start_offset == 0:
        # full replay ⇒ preempt_ops is complete: roll uncommitted
        # preemptions back to zero evictions here, so EVERY full-replay
        # consumer (genesis recovery, the crash harness's pure-replay
        # oracle, a restarting standby) lands on the same contract without
        # separate wiring. Tail replays defer to RecoveryManager.
        # restore_preemptions, which merges the snapshot's open-preempt
        # payload (the begin line may predate the anchor).
        rollback_uncommitted_preempts(store, journal)
    return journal
