"""Live elastic resharding: the fenced two-phase keyspace handoff.

Without it, changing shard count is restart + full resync —
the one operation a fleet serving heavy traffic cannot afford. This
coordinator retargets the consistent-hash ring LIVE, one moving range at
a time, with the overlap discipline of "keep serving from the old owner
while the new owner warms, cut over only at a fence":

1. **Prepare + stream.** The front turns double-routing ON for the range
   (``AdmissionFront.begin_range`` — every event for a covered key now
   applies at the source AND mirrors to the destination, and reserves
   fan out to both). The source then stages its slice — store objects,
   reservation-ledger entries, gang records, published statuses — and
   streams it in prefix-sha-verified chunks (the StandbyReplicator
   chunk contract, re-pointed over the framed-pickle IPC; the
   coordinator relays source→destination because workers share no
   socket). Order matters: mirror-on happens BEFORE the prepare flush,
   so no event can fall between the snapshot and the mirror stream.

2. **Warm-up.** The destination applies the slice and keeps absorbing
   mirrored events; its controllers compute verdicts and flips, but its
   status pushes are SUPPRESSED (advisory) — the front consults only the
   authoritative owner for checks while the range is in flight.

3. **Fenced cutover, per range.** The source fences the range (the
   ``FencingEpoch`` discipline, range-scoped: post-fence
   authoritative writes for the range are refused and counted), the
   front atomically re-points every covered key's owner under one
   route-lock hold, and the destination ``reshard_activate``s —
   re-enqueueing every moved key on the PRIORITY lane so every flip it
   computed during warm-up re-publishes flips-first through the
   two-lane path. Nothing the source never committed is lost. The
   source then retires its slice (fence lifted with it).

Failure is first-class (``reshard.*`` sites, faults/plan.py):

- ``reshard.handoff.torn`` — the chunk stream tears or corrupts; the
  sink's hash check refuses the chunk and the range aborts back to the
  source (authority never moved).
- ``reshard.dest.crash`` — the destination dies mid-warm-up; the
  coordinator aborts the range and retries once the supervisor's
  monitor restarts the worker.
- ``reshard.fence.race`` — the fence step loses a race (a concurrent
  epoch superseded the handoff); the source unfences and the range
  aborts.
- ``reshard.front.crash`` — the coordinator dies between prepare and
  cutover; NOBODY cleans up in-band, and the shard-side two-phase
  reapers TTL the orphaned handoff on both ends (source lifts its
  fence, destination drops the imported slice including every imported
  reservation) — zero orphan reservations by the same clock that reaps
  two-phase reserves.

A failure AFTER the cutover is NOT aborted: the destination owns the
range from that instant, so a destination death there is the ordinary
kill-a-shard case (supervisor restart + resync from the front's merged
store), and a failed source retire leaves an inert fenced zombie slice
that the source's handoff reaper unstages.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

from .ipc import ShardUnavailable
from .ring import HashRing, RangeMove, ReshardPlan, TransitionRouting, plan_reshard

logger = logging.getLogger(__name__)

__all__ = [
    "ReshardAborted",
    "ReshardTimeout",
    "CoordinatorCrash",
    "ReshardCoordinator",
]


class ReshardAborted(Exception):
    """One range's handoff aborted back to the source (retryable)."""


class ReshardTimeout(Exception):
    """The rescale deadline passed with ranges still pending. The
    transition router stays installed — routing remains correct (cut
    ranges serve from their destinations, pending ones from their
    sources) — but the fleet is not at its target shape."""


class CoordinatorCrash(Exception):
    """Simulated coordinator death (``reshard.front.crash`` in a mode
    other than ``kill``): propagates WITHOUT cleanup so tests can drive
    the shard-side TTL reapers against the orphaned handoff."""


class ReshardCoordinator:
    """Drives one ring retarget over an :class:`AdmissionFront`."""

    def __init__(self, front, faults=None, chunk_timeout: float = 30.0):
        self.front = front
        self.faults = faults if faults is not None else front.faults
        self.metrics = getattr(front, "reshard_metrics", None)
        self.chunk_timeout = chunk_timeout
        self._seq = 0
        # single-writer progress counters (stats/tests)
        self.handoffs_done = 0
        self.handoffs_aborted = 0
        self.bytes_streamed = 0
        self.events_streamed = 0

    # ------------------------------------------------------------ plumbing

    def _request(self, sid: int, op: str, payload, timeout: Optional[float] = None):
        handle = self.front.shards.get(sid)
        if handle is None or not handle.alive:
            raise ShardUnavailable(f"shard {sid} is down")
        return handle.request(op, payload, timeout=timeout or self.chunk_timeout)

    def _wait_queue_empty(self, sid: int, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            handle = self.front.shards.get(sid)
            if handle is None or not handle.alive:
                raise ShardUnavailable(f"shard {sid} went down mid-handoff")
            if handle.pending_events() == 0:
                return
            time.sleep(0.005)
        raise ShardUnavailable(
            f"shard {sid} event queue never drained in {timeout}s"
        )

    def _check_fault(self, site: str) -> None:
        if self.faults is None:
            return
        fault = self.faults.check(site)
        if fault is None:
            return
        fault.sleep()
        if fault.mode == "kill":
            fault.kill()
        if site == "reshard.front.crash":
            raise CoordinatorCrash(f"injected coordinator death (hit {fault.hit})")
        raise fault.make_error()

    # ------------------------------------------------------------- the work

    def rescale(
        self,
        new_ring: HashRing,
        deadline_s: float = 180.0,
        retry_backoff: float = 0.5,
    ) -> Dict:
        """Retarget the front's ring to ``new_ring``, range by range.
        Aborted ranges are retried until the deadline; the target ring is
        adopted only once EVERY range has cut over, so a partial failure
        never leaves a hybrid steady state."""
        old_ring = self.front.ring
        plan: ReshardPlan = plan_reshard(old_ring, new_ring)
        transition = TransitionRouting(old_ring, new_ring, plan)
        self.front.begin_reshard(transition)
        report: Dict = {
            "from_shards": old_ring.n_shards,
            "to_shards": new_ring.n_shards,
            "moves": len(plan.moves),
            "aborts": 0,
            "retries": 0,
            "keys_cut": 0,
            "bytes": 0,
            "events": 0,
        }
        if not plan.moves:
            self.front.finish_reshard(new_ring, new_ring.n_shards)
            return report
        # one handoff per (src, dst) pair: a retarget produces O(vnodes)
        # elementary moves, but the slice stream and the fence are
        # per-PAIR concerns — grouping turns ~100 streams into ≤ a few,
        # while the front still mirrors/cuts each range individually
        groups: Dict[Tuple[int, int], List[RangeMove]] = {}
        for move in plan.moves:
            groups.setdefault((move.src, move.dst), []).append(move)
        report["groups"] = len(groups)
        pending: List[Tuple[int, int]] = sorted(groups)
        deadline = time.monotonic() + deadline_s
        while pending:
            src, dst = pending.pop(0)
            moves = groups[(src, dst)]
            try:
                report["keys_cut"] += self._handoff_group(src, dst, moves)
                self.handoffs_done += 1
            except CoordinatorCrash:
                raise
            except Exception as e:  # noqa: BLE001 — abort + retry is the contract
                self.handoffs_aborted += 1
                report["aborts"] += 1
                logger.warning(
                    "reshard: handoff shard %d→%d (%d ranges) aborted back "
                    "to source: %s", src, dst, len(moves), e,
                )
                if self.metrics is not None:
                    self.metrics["aborts"].inc({})
                if time.monotonic() > deadline:
                    raise ReshardTimeout(
                        f"handoff {src}->{dst} still pending at deadline "
                        f"(last error: {e})"
                    ) from e
                report["retries"] += 1
                pending.append((src, dst))
                time.sleep(retry_backoff)
        report["bytes"] = self.bytes_streamed
        report["events"] = self.events_streamed
        self.front.finish_reshard(new_ring, new_ring.n_shards)
        logger.info(
            "reshard complete: %d→%d shards, %d ranges, %d keys re-pointed "
            "(%d aborts retried)",
            report["from_shards"], report["to_shards"], report["moves"],
            report["keys_cut"], report["aborts"],
        )
        return report

    def _handoff_group(self, src: int, dst: int,
                       moves: List[RangeMove]) -> int:
        """One (src, dst) handoff end to end — every moving range between
        the pair rides one slice stream and one fence. Pre-cutover
        failures abort back to the source (and raise); post-cutover
        failures are repaired through the ordinary shard-death machinery
        (see module docstring)."""
        self._seq += 1
        handoff = f"reshard-{self._seq}-s{src}d{dst}"
        ranges = [(m.lo, m.hi) for m in moves]
        cut = False
        try:
            # 1. mirror ON first — no event may fall between the staged
            # snapshot and the mirror stream
            for move in moves:
                self.front.begin_range(move)
            # the prepare RPC rides the req channel, which can overtake
            # evt frames still queued front-side: wait for the source's
            # queue to drain so every pre-mirror event is on the socket
            # AHEAD of the prepare (FIFO) and lands in the export —
            # everything after the drain is mirrored by construction
            self._wait_queue_empty(src, timeout=60.0)
            prep = self._request(
                src, "reshard_prepare",
                {"handoff": handoff, "ranges": ranges}, timeout=120.0,
            )
            # 2. relay the verified chunk stream source → destination
            offset, sha = 0, ""
            while True:
                chunk = self._request(
                    src, "reshard_chunk",
                    {"handoff": handoff, "offset": offset, "sha": sha},
                )
                res = self._request(
                    dst, "reshard_import",
                    {"handoff": handoff, "ranges": ranges, "chunk": chunk},
                    timeout=120.0,
                )
                self.bytes_streamed += len(chunk["data"])
                if self.metrics is not None:
                    self.metrics["bytes"].inc({}, float(len(chunk["data"])))
                offset, sha = chunk["endOffset"], chunk["endSha"]
                if res.get("done"):
                    self.events_streamed += int(res.get("objects", 0))
                    if self.metrics is not None:
                        self.metrics["events"].inc(
                            {}, float(res.get("objects", 0))
                        )
                    break
            # 3. fenced cutover
            self._check_fault("reshard.front.crash")
            t_fence = time.monotonic()
            self._request(
                src, "reshard_fence",
                {"handoff": handoff, "ranges": ranges, "epoch": self._seq},
            )
            self._check_fault("reshard.fence.race")
            keys_cut = 0
            for move in moves:
                keys_cut += self.front.cutover_range(move)
            cut = True
            self._request(dst, "reshard_activate", {"handoff": handoff})
            self._request(src, "reshard_retire", {"handoff": handoff})
            if self.metrics is not None:
                self.metrics["cutover"].observe({}, time.monotonic() - t_fence)
            logger.info(
                "reshard: handoff shard %d→%d cut over (%d ranges, %d keys, "
                "%d slice bytes)", src, dst, len(moves), keys_cut,
                int(prep.get("bytes", 0)),
            )
            return keys_cut
        except CoordinatorCrash:
            raise  # no cleanup — the shard-side TTL reapers own this path
        except Exception:
            if cut:
                # the destination owns the ranges now: repair forward, not
                # backward (restart+resync is the shard-death machinery)
                logger.exception(
                    "reshard: post-cutover step failed for handoff %d→%d — "
                    "relying on supervisor restart+resync", src, dst,
                )
                self._post_cutover_repair(src, dst, handoff)
                return 0
            self._abort_group(src, dst, moves, handoff)
            raise

    def _abort_group(self, src: int, dst: int, moves: List[RangeMove],
                     handoff: str) -> None:
        """Pre-cutover abort: stop mirroring FIRST (no new mirrored event
        may trail the destination's cleanup), flush what is in flight,
        then roll both sides back. Every step is best-effort — a side
        that cannot answer will TTL-reap the handoff itself."""
        for move in moves:
            self.front.abort_range(move)
        for sid, drain in ((dst, True), (src, False)):
            try:
                if drain:
                    self._request(sid, "drain", {"timeout": 5.0}, timeout=30.0)
                self._request(sid, "reshard_abort", {"handoff": handoff})
            except Exception:  # noqa: BLE001 — reaper covers a dark side
                logger.warning(
                    "reshard: abort of %s on shard %d failed (TTL reaper "
                    "will finish it)", handoff, sid,
                )

    def _post_cutover_repair(self, src: int, dst: int, handoff: str) -> None:
        try:
            self._request(src, "reshard_retire", {"handoff": handoff})
        except Exception:  # noqa: BLE001 — the source reaper unstages it
            pass
        try:
            self.front.resync_shard(dst)
        except Exception:  # noqa: BLE001 — monitor-driven resync follows
            pass
