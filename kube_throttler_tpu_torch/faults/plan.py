"""Deterministic, seedable fault injection for the failure paths this
standalone recast owns.

The reference is crash-only because the apiserver is its state of record
(SURVEY §5): a dropped watch, a 410 relist, a torn write are all somebody
else's recovery problem. Here the transport, the watch fan-out, the journal,
and the device dispatch are OUR code — so their failure paths need to be
drivable on demand, deterministically, from tests and soaks.

Design:

- a :class:`FaultPlan` is a seed plus an ordered list of :class:`FaultRule`
  entries, each scoped to a *site* pattern (``fnmatch`` glob over dotted
  site names like ``transport.watch.read`` or ``journal.append``);
- instrumented code calls ``plan.check(site)`` (or the raising convenience
  ``plan.maybe_raise(site)``) at each fault point; a hit either fires a
  :class:`FiredFault` or passes through;
- **determinism**: the fire/no-fire decision for hit *n* at site *s* under
  rule *r* is a pure function of ``(seed, r, s, n)`` — per-decision RNG,
  no shared stream — so concurrent threads hitting different sites cannot
  perturb each other's fault sequences. Same seed → bit-for-bit the same
  per-site fault sequence, regardless of thread interleaving;
- every firing is recorded in ``plan.history[site]`` (hit index + mode),
  which doubles as the reproducibility witness and the soak's post-mortem
  trace.

Sites are interpreted by the instrumented layer: the plan only decides
*when*; the site decides *what* a firing means (raise, torn write, stream
cut, forced 409, added delay). The instrumented sites in-tree:

==========================  ==================================================
site                        effect of a firing
==========================  ==================================================
transport.request           ConnectionResetError before the HTTP round trip
transport.put.conflict      ConflictError from put() (409 storm)
transport.watch.open        ApiError(500) opening the watch stream
transport.watch.read        per-event: mode "close" ends the stream, "gone"
                            raises GoneError (410 storm), "error" raises,
                            "delay" stalls the read
journal.append              mode "torn" writes half the line (interior
                            corruption for the NEXT append), "error" skips
                            the write
journal.fsync               OSError during compaction fsync
device.dispatch             dispatch raises (opens the circuit breaker)
ingest.batch.partial        one op of a micro-batch fails mid-apply
                            (engine/ingest.py splits around it; the ops
                            before and after still land)
crash.journal.append        SIGKILL before the event's journal line is
                            written (event reached the store, not the log)
crash.journal.torn          half the line is written+flushed, then SIGKILL
                            (the canonical torn-final-line crash artifact)
crash.journal.compact       SIGKILL right after the compacted log replaces
                            the live one (snapshot journal offsets stale)
crash.journal.group_commit  SIGKILL mid group-commit write: half the batch
                            buffer reaches the file (cut mid-line), so
                            recovery must see a clean batch prefix with
                            one torn tail (engine/journal.py on_batch)
gang.reserve.partial        one member add of a gang reserve raises
                            (engine/gang.py rolls the whole group back —
                            the all-or-nothing failure path)
crash.gang.partial_reserve  SIGKILL mid-gang-reserve: some members'
                            reservations added, the rest not — recovery
                            must land fully-reserved or fully-rolled-back,
                            never a partial group (engine/gang.py)
crash.snapshot.begin        SIGKILL before a snapshot write starts
crash.snapshot.tmp_partial  SIGKILL with half the snapshot tmp file flushed
crash.snapshot.pre_rename   SIGKILL after tmp fsync, before the atomic
                            rename (orphan tmp left behind)
crash.snapshot.post_rename  SIGKILL after the rename, before pruning
crash.snapshot.prune        SIGKILL mid-prune of superseded snapshots
mock.list                   mockserver LIST answers 500 ("error"), 410
                            ("gone"), or stalls ("delay")
mock.watch.cut              mockserver cuts the watch stream mid-flight
mock.watch.gone             mockserver emits a 410 ERROR event mid-stream
mock.status.conflict        mockserver 409s a status PUT
mock.status.error           mockserver 500s a status PUT
mock.lease                  mockserver lease endpoint: "conflict" 409s a
                            lease write, "error" 500s any lease verb,
                            "delay" stalls it (leader-election chaos)
ha.journal.batch            SIGKILL the leader after a batch mutated the
                            store but before ANY of its journal lines were
                            written (the whole batch is unreplicated)
ha.snapshot.write           SIGKILL the leader mid-snapshot (tmp complete,
                            rename pending) during an HA failover run
ha.status.commit            SIGKILL the leader after a throttle status
                            write mutated the store but before its journal
                            line landed (a flip computed but uncommitted —
                            the standby must re-derive it)
ha.replication.send         SIGKILL the leader mid-way through sending a
                            journal chunk to a standby (torn replication
                            stream; the standby must discard the partial)
mock.status.delay           mockserver stalls a status PUT for the rule's
                            ``delay`` seconds before serving it (publication
                            slowdown — the scenario engine's injected-
                            regression knob)
scenario.apiserver.restart  the scenario engine restarts the mock apiserver
                            (stop, reset the RV retention window, start on
                            the same port) — clients see connection
                            failures, then 410 on re-watch, then the
                            paginated-relist storm (scenarios/engine.py)
scenario.leader.kill        the scenario engine runs one kill-the-leader
                            failover episode through tools/harness.py (the
                            ha.* machinery) and gates its window
scenario.churn.stall        the scenario engine's trace replayer pauses the
                            arrival process for the rule's ``delay`` (a
                            driver stall — tests the idle→burst transition)
scenario.regression.flip_stall  the deliberately-injected SLO regression:
                            the engine routes this into a per-status-PUT
                            stall (``mock.status.delay``) so the flip-p99
                            gate demonstrably fails (scenarios/slo.py)
shard.ipc.send              front→shard event-frame send raises: the shard
                            looks dead to the front — events count as
                            route misses, the shard goes dirty, and the
                            supervisor's resync repairs it (sharding/ipc.py)
shard.worker.kill           SIGKILL the shard worker at the next routed
                            event batch (the kill-a-shard chaos smoke;
                            sharding/worker.py handle_events)
reshard.handoff.torn        the live-resharding slice stream tears: mode
                            "torn" corrupts a chunk byte (the sink's
                            prefix-hash check MUST refuse it), any other
                            mode tears the stream outright — either way
                            the range aborts back to the source
                            (sharding/worker.py reshard_chunk)
reshard.dest.crash          the handoff DESTINATION dies mid-warm-up: mode
                            "kill" SIGKILLs the worker at the next import
                            chunk, "error" fails the import RPC — the
                            coordinator aborts and retries after the
                            supervisor restart (worker reshard_import)
net.connect.refused         the TCP shard client's connect() attempt is
                            refused — the reconnector backs off (jittered
                            exponential Backoff) and retries
                            (sharding/ipc.py TcpShardClient)
net.send.torn_frame         a framed send writes only a PREFIX of the
                            frame and then the socket dies: the peer's
                            read_frame sees a short read → treats the
                            stream as closed (no partial frame is ever
                            surfaced to the dispatcher)
net.recv.stall              the receive path stalls for the rule's
                            ``delay`` before reading the next frame (a
                            slow link / half-open socket — deadlines must
                            fire, dispatch must not block)
net.partition               the link blackholes: sends raise without
                            writing a byte and the connection is torn
                            down. Armed per-direction, so one rule makes
                            an ASYMMETRIC partition; the client degrades
                            to fail-safe verdicts until heal + resync
net.reconnect.storm         a just-reestablished connection is killed
                            again immediately (flapping link): the
                            reconnector must keep backing off, not
                            hot-loop (sharding/ipc.py TcpShardClient)
reshard.fence.race          the fence step loses a race (a concurrent
                            epoch superseded the handoff): the source
                            unfences and the range aborts back to it
                            (sharding/reshard.py, post-fence check)
reshard.front.crash         the coordinator dies between prepare and
                            cutover: mode "kill" SIGKILLs the front, any
                            other mode abandons the handoff WITHOUT
                            cleanup — both sides' two-phase reapers must
                            TTL the orphan (zero orphan reservations)
shm.ring.full               the shared-memory event ring reports itself
                            saturated: mode "delay" makes the writer
                            backpressure (counted) for the rule's delay,
                            any other mode fails the push — the lane dies
                            and the supervisor restart + resync repairs
                            it (sharding/shmring.py ShmRingWriter.push)
shm.slot.torn_commit        the writer commits a slot with a garbage
                            commit word — exactly what dying mid-commit
                            leaves behind. The reader MUST detect it
                            (TornSlotError), never consume the slot, and
                            route its own death so restart + resync
                            repairs (shmring ShmRingReader._check)
shm.doorbell.lost           the post-commit doorbell byte is dropped: the
                            reader's bounded poll must still find the
                            frame — latency, never loss (ShmRingWriter)
shm.reader.stall            the worker's ring pump stalls for the rule's
                            ``delay`` before polling — the writer must
                            backpressure, counted, without dropping a
                            committed frame (ShmRingReader.peek)
shm.segment.unlink          the creator loses the segment-unlink race at
                            close: the name is left behind and the
                            supervisor's sweep_segments backstop must
                            remove it — no leaked /dev/shm segments
                            (ShmRingWriter.close / supervisor.stop)
==========================  ==================================================

Virtual-time rules (the scenario engine's vocabulary): a rule may carry
``window=(t0, t1)`` — it only considers firing while the plan's installed
time source reads within [t0, t1) — and/or ``at_times=[...]`` — it fires
exactly once per listed instant, at the first matching hit observed at or
after that virtual time. Both extend the per-hit decision model: the plan
stays deterministic given the same hit sequence and the same clock
readings (scenarios replay committed traces, so both are pinned). A
virtual-time rule on a plan with NO time source installed never fires.

The ``crash.*`` family is the SIGKILL crash-point harness
(tools/crashtest.py): a rule with mode ``"kill"`` makes the process die by
uncatchable SIGKILL at that exact instant — no atexit, no flush, no
``finally`` — so recovery (engine/recovery.py) is exercised against the
worst on-disk artifacts each instant can leave behind.
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.lockorder import guard_attrs, make_lock


# The instrumented sites in-tree (the table above, as code). This is the
# registry the static analyzer's `registry` checker enforces: every literal
# site passed to check()/maybe_raise() must be a member, and every
# FaultRule site pattern must fnmatch at least one member — an
# unregistered site string silently never fires, which is exactly the
# drift class this exists to catch. Keep it a plain literal set (the
# analyzer reads it from the AST without importing this module).
KNOWN_SITES = frozenset(
    {
        "transport.request",
        "transport.put.conflict",
        "transport.watch.open",
        "transport.watch.read",
        "journal.append",
        "journal.fsync",
        "device.dispatch",
        "ingest.batch.partial",
        "gang.reserve.partial",
        "crash.gang.partial_reserve",
        "crash.preempt.partial_evict",
        "crash.journal.append",
        "crash.journal.torn",
        "crash.journal.compact",
        "crash.journal.group_commit",
        "crash.snapshot.begin",
        "crash.snapshot.tmp_partial",
        "crash.snapshot.pre_rename",
        "crash.snapshot.post_rename",
        "crash.snapshot.prune",
        "mock.list",
        "mock.watch.cut",
        "mock.watch.gone",
        "mock.status.conflict",
        "mock.status.error",
        "mock.lease",
        "ha.journal.batch",
        "ha.snapshot.write",
        "ha.status.commit",
        "ha.replication.send",
        "mock.status.delay",
        "scenario.apiserver.restart",
        "scenario.leader.kill",
        "scenario.churn.stall",
        "scenario.regression.flip_stall",
        "shard.ipc.send",
        "shard.worker.kill",
        "reshard.handoff.torn",
        "reshard.dest.crash",
        "reshard.fence.race",
        "reshard.front.crash",
        "net.connect.refused",
        "net.send.torn_frame",
        "net.recv.stall",
        "net.partition",
        "net.reconnect.storm",
        "shm.ring.full",
        "shm.slot.torn_commit",
        "shm.doorbell.lost",
        "shm.reader.stall",
        "shm.segment.unlink",
    }
)


class FaultInjected(Exception):
    """Default exception raised at a firing fault point with mode
    ``error`` and no explicit ``error`` factory."""


@dataclass(frozen=True)
class FiredFault:
    """One firing at one site: what the instrumented code should do."""

    site: str
    hit: int  # 1-based hit index at this site
    mode: str  # "error" | "close" | "gone" | "torn" | "delay" | ...
    rule_site: str  # the rule pattern that fired
    delay: float = 0.0
    _error: Optional[Callable[[], BaseException]] = None

    def make_error(self) -> BaseException:
        if self._error is not None:
            return self._error()
        return FaultInjected(f"injected fault at {self.site} (hit {self.hit})")

    def sleep(self) -> None:
        if self.delay > 0:
            time.sleep(self.delay)

    def kill(self) -> None:
        """Die by SIGKILL right here — uncatchable, no cleanup handlers, no
        buffered-file flushes. The crash harness's seeded worst-instant
        process death (mode ``"kill"`` at a ``crash.*`` site)."""
        os.kill(os.getpid(), signal.SIGKILL)


@dataclass
class FaultRule:
    """When to fire at matching sites.

    ``schedule`` (1-based hit indices, applied after ``after`` is skipped)
    beats ``probability``; ``times`` caps total firings per site; ``after``
    lets the first N hits through untouched (e.g. let the initial sync
    succeed, then storm).

    Virtual-time extensions (scenario engine): ``window=(t0, t1)`` gates
    the rule to hits observed while the plan's time source reads within
    [t0, t1); ``at_times=[...]`` fires exactly once per listed virtual
    instant — at the first matching hit at/after it — and beats
    probability/schedule the way ``schedule`` beats ``probability``.
    Either requires a time source on the plan (``set_time_source``)."""

    site: str  # fnmatch pattern over dotted site names
    mode: str = "error"
    error: Optional[Callable[[], BaseException]] = None
    probability: float = 1.0
    times: Optional[int] = None
    after: int = 0
    schedule: Optional[Sequence[int]] = None
    delay: float = 0.0
    window: Optional[Tuple[float, float]] = None
    at_times: Optional[Sequence[float]] = None
    _schedule_set: Optional[frozenset] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        if self.schedule is not None:
            self._schedule_set = frozenset(int(i) for i in self.schedule)

    def canonical(self) -> Dict[str, object]:
        """Minimal, stable, JSON-able form: default-valued fields dropped,
        ``schedule``/``at_times`` sorted, ``window`` a 2-list. Two rules
        with equal canonical forms decide identically for every
        ``(seed, rule_idx, site, hit, clock)`` tuple. ``error`` factories
        are represented by their qualified name only (callables don't
        serialize; the factory's identity is what distinguishes rules)."""
        out: Dict[str, object] = {"site": self.site}
        if self.mode != "error":
            out["mode"] = self.mode
        if self.error is not None:
            out["error"] = getattr(self.error, "__qualname__", repr(self.error))
        if self.probability < 1.0:
            out["probability"] = float(self.probability)
        if self.times is not None:
            out["times"] = int(self.times)
        if self.after:
            out["after"] = int(self.after)
        if self.schedule is not None:
            out["schedule"] = sorted(int(i) for i in self.schedule)
        if self.delay:
            out["delay"] = float(self.delay)
        if self.window is not None:
            out["window"] = [float(self.window[0]), float(self.window[1])]
        if self.at_times is not None:
            out["at_times"] = sorted(float(t) for t in self.at_times)
        return out


def _decision(seed: int, rule_idx: int, site: str, hit: int) -> float:
    """Uniform [0,1) that depends ONLY on (seed, rule, site, hit) — sha256,
    not ``hash()``, because PYTHONHASHSEED would break cross-process
    reproducibility of a recorded fault plan."""
    digest = hashlib.sha256(
        f"{seed}\x00{rule_idx}\x00{site}\x00{hit}".encode()
    ).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


@guard_attrs
class FaultPlan:
    """A seeded set of fault rules plus the per-site hit/firing bookkeeping.

    Thread-safe; the decision function is stateless per hit (see module
    docstring), so the per-site fault sequence is reproducible from the
    seed alone."""

    GUARDED_BY = {
        "_hits": "self._lock",
        "_fired": "self._lock",
        "history": "self._lock",
        "_times_pending": "self._lock",
    }

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rules: List[FaultRule] = []
        self._lock = make_lock("faults.plan")
        self._hits: Dict[str, int] = {}
        self._fired: Dict[Tuple[int, str], int] = {}  # (rule idx, site) → count
        # site → [(hit, mode)] — the reproducibility witness
        self.history: Dict[str, List[Tuple[int, str]]] = {}
        # virtual clock for window/at_times rules (scenarios install the
        # trace replayer's virtual-time reader); None ⇒ those rules are inert
        self._time_source: Optional[Callable[[], float]] = None
        # (rule idx, site) → sorted not-yet-fired at_times instants
        self._times_pending: Dict[Tuple[int, str], List[float]] = {}

    def set_time_source(self, fn: Optional[Callable[[], float]]) -> None:
        """Install the virtual clock that ``window``/``at_times`` rules read
        (monotone float seconds; the scenario engine's trace time)."""
        self._time_source = fn

    def rule(
        self,
        site: str,
        *,
        mode: str = "error",
        error: Optional[Callable[[], BaseException]] = None,
        probability: float = 1.0,
        times: Optional[int] = None,
        after: int = 0,
        schedule: Optional[Sequence[int]] = None,
        delay: float = 0.0,
        window: Optional[Tuple[float, float]] = None,
        at_times: Optional[Sequence[float]] = None,
    ) -> "FaultPlan":
        """Add a rule; returns self for chaining."""
        self._rules.append(
            FaultRule(
                site=site,
                mode=mode,
                error=error,
                probability=probability,
                times=times,
                after=after,
                schedule=schedule,
                delay=delay,
                window=window,
                at_times=at_times,
            )
        )
        return self

    # -- the fault point API ------------------------------------------------

    def check(self, site: str) -> Optional[FiredFault]:
        """Count a hit at ``site``; return the fault to apply, or None.
        First matching rule that decides to fire wins (rule order is
        priority order)."""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            now_v: Optional[float] = None
            if self._time_source is not None and any(
                r.window is not None or r.at_times is not None for r in self._rules
            ):
                now_v = self._time_source()  # one read serves every rule
            for idx, rule in enumerate(self._rules):
                if not fnmatch.fnmatchcase(site, rule.site):
                    continue
                if hit <= rule.after:
                    continue
                key = (idx, site)
                if rule.times is not None and self._fired.get(key, 0) >= rule.times:
                    continue
                if rule.window is not None:
                    if now_v is None or not (rule.window[0] <= now_v < rule.window[1]):
                        continue
                if rule.at_times is not None:
                    # fires once per scheduled instant, at the first hit
                    # observed at/after it (beats probability/schedule)
                    if now_v is None:
                        continue
                    pend = self._times_pending.get(key)
                    if pend is None:
                        pend = self._times_pending[key] = sorted(
                            float(t) for t in rule.at_times
                        )
                    if not pend or now_v < pend[0]:
                        continue
                    pend.pop(0)
                    fire = True
                elif rule._schedule_set is not None:
                    fire = (hit - rule.after) in rule._schedule_set
                elif rule.probability >= 1.0:
                    fire = True
                else:
                    fire = _decision(self.seed, idx, site, hit) < rule.probability
                if not fire:
                    continue
                self._fired[key] = self._fired.get(key, 0) + 1
                self.history.setdefault(site, []).append((hit, rule.mode))
                return FiredFault(
                    site=site,
                    hit=hit,
                    mode=rule.mode,
                    rule_site=rule.site,
                    delay=rule.delay,
                    _error=rule.error,
                )
        return None

    def maybe_raise(
        self, site: str, default: Callable[[], BaseException] = None
    ) -> None:
        """Convenience for sites whose only failure mode is raising: check,
        apply any delay, then raise the fault's error (``default`` supplies
        the exception factory when the rule carries none)."""
        fault = self.check(site)
        if fault is None:
            return
        fault.sleep()
        if fault.mode == "delay":
            return  # pure stall, no error
        if fault._error is None and default is not None:
            raise default()
        raise fault.make_error()

    # -- introspection ------------------------------------------------------

    def canonical_rules(self) -> List[Dict[str, object]]:
        """The effective rule set in priority order, each rule in its
        stable canonical form (:meth:`FaultRule.canonical`). Order is
        PRESERVED — first-match-wins makes priority part of the plan's
        semantics — so equality of canonical forms means behavioral
        equality, and the scenario hunt dedupes mutants by the sha of this
        list (trace headers commit it; scenarios/trace.py)."""
        return [r.canonical() for r in self._rules]

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def fired(self, site: Optional[str] = None) -> int:
        """Total firings, optionally for one site."""
        with self._lock:
            if site is not None:
                return len(self.history.get(site, []))
            return sum(len(v) for v in self.history.values())

    def snapshot(self) -> Dict[str, List[Tuple[int, str]]]:
        """Deep-ish copy of the per-site firing history (the determinism
        witness: equal across runs for equal seeds and site hit counts)."""
        with self._lock:
            return {site: list(v) for site, v in self.history.items()}

    def reset(self) -> None:
        """Clear hit counts and history, keep the rules (new run, same
        plan)."""
        with self._lock:
            self._hits.clear()
            self._fired.clear()
            self.history.clear()
            self._times_pending.clear()


def maybe_crash(plan: Optional[FaultPlan], site: str) -> None:
    """Crash-point hook: count a hit at ``site`` and, if a rule with mode
    ``"kill"`` fires, SIGKILL the process on the spot. Instrumented code
    sprinkles these at the instants whose on-disk artifacts recovery must
    survive (mid-snapshot rename, between journal append and fsync, ...).
    Production passes ``plan=None`` — a single ``is None`` branch."""
    if plan is None:
        return
    fault = plan.check(site)
    if fault is not None and fault.mode == "kill":
        fault.sleep()
        fault.kill()
