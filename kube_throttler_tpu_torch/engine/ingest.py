"""Micro-batched event ingest: the adaptive group-apply front-end.

A full-scale capacity window measured the engine saturating at ~1.4k
sustained events/s while the fired rate was higher — the watch→store→index→
device ingest path, not the kernels, had become the ceiling, because every
event paid its own store-lock acquisition (against reconcile drains holding
the lock for whole batched status writes), its own journal write+flush
syscall pair, and its own per-event Python dispatch overhead.

This module amortizes all of that with a classic group-commit shape:

- producers (the watch/reflector layer, the bench's churn driver, any
  embedder) ``submit()`` ops into a BOUNDED queue and return immediately —
  they never touch the store lock;
- one dispatcher thread drains the queue into a micro-batch and applies it
  via :meth:`Store.apply_events` — ONE store-lock acquisition, ONE journal
  group commit, ONE device-mirror pass, ONE controller enqueue per batch;
- the batch size is ADAPTIVE: it grows (×2 up to ``max_batch``) while a
  backlog remains after a drain and collapses back toward 1 when the queue
  runs dry — so an UNLOADED pipeline applies single events on the exact
  pre-batching path (no added latency), and a loaded one pays the per-event
  overhead 1/N times.

Overflow policy mirrors the bounded Watch queues (client/watch.py):
``drop-oldest`` — the producer never blocks, the newest events win, and
``dropped``/``overflowed`` record the gap PER EVENT so a consumer knows to
relist. (Counting per batch would under-report the gap by the batch size —
the exact single-event assumption this subsystem must not reintroduce.)

Overload posture (the scenario corpus' storm gates): shedding is
VERDICT-SAFE. Only pod upserts — status-lag refreshes the resync loop
regenerates — are eligible; Throttle/ClusterThrottle/Namespace ops and
every DELETE are verdict-critical (a shed throttle spec or pod delete
changes admission answers until a relist nobody scheduled), so they are
never dropped: the queue prefers shedding the oldest sheddable op, drops a
sheddable *incoming* op when nothing queued is sheddable, and briefly
exceeds the bound rather than shed a critical op. Every shed is recorded
per kind; ``take_overflow(kind)`` hands the gap to that kind's reflector,
which forces a relist — the overflow flag is now a repair trigger, not a
note. Under overload the pipeline therefore sheds non-flip status
freshness, never verdict correctness.

Fault site ``ingest.batch.partial`` (faults/plan.py): a firing makes one op
of the current batch fail mid-apply; the dispatcher splits around it — the
ops before AND after still land, the failure is counted in ``op_errors``
and surfaced per op — so a poisoned event can never wedge or tear the
batch.

Equivalence contract (property-tested in tests/test_batch_ingest.py): for
any partition of an op stream into micro-batches, the final store dump,
the published ``st_*`` device planes, and every ``pre_filter`` verdict are
identical to one-at-a-time ingest.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import List, Optional, Sequence, Tuple

from ..utils.lockorder import guard_attrs, make_lock
from .store import Store

logger = logging.getLogger(__name__)

# (verb, kind, payload) — the Store.apply_events op shape
IngestOp = Tuple[str, str, object]


@guard_attrs
class MicroBatchIngest:
    """Adaptive micro-batching front-end over :meth:`Store.apply_events`.

    ``batch_policy``: ``"adaptive"`` (default — grow under backlog, decay
    to 1 when idle) or a fixed positive int (every drain takes up to that
    many ops; the bench's fixed rungs). ``max_batch`` caps the adaptive
    growth. ``maxsize`` bounds the queue (drop-oldest on overflow).
    """

    DEFAULT_MAXSIZE = 65536

    # the queue, its counters, and the adaptive batch size only move under
    # the single pipeline lock (held directly or via the condition)
    GUARDED_BY = {
        "_queue": "self._lock",
        "_cur_max": "self._lock",
        "_applying": "self._lock",
        "_stopped": "self._lock",
        "dropped": "self._lock",
        "overflowed": "self._lock",
        "events_in": "self._lock",
        "_overflow_kinds": "self._lock",
    }

    def __init__(
        self,
        store: Store,
        max_batch: int = 256,
        batch_policy="adaptive",
        maxsize: Optional[int] = None,
        faults=None,
        metrics_registry=None,
    ) -> None:
        self.store = store
        self.max_batch = max(1, int(max_batch))
        if batch_policy != "adaptive":
            batch_policy = max(1, int(batch_policy))
        self.batch_policy = batch_policy
        self.maxsize = self.DEFAULT_MAXSIZE if maxsize is None else max(1, int(maxsize))
        self.faults = faults
        self._lock = make_lock("ingest")
        self._cond = threading.Condition(self._lock)
        self._queue: "deque[IngestOp]" = deque()
        self._cur_max = 1 if batch_policy == "adaptive" else int(batch_policy)
        self._applying = False
        self._stopped = False
        # single-writer stats (dispatcher thread) + producer-side drop
        # accounting; read by /metrics and tests
        self.events_in = 0  # ops accepted into the queue
        self.events_applied = 0  # ops applied to the store
        self.batches = 0  # apply_events calls issued (incl. size-1)
        self.op_errors = 0  # per-op failures (incl. injected partials)
        self.dropped = 0  # ops shed by drop-oldest (PER EVENT)
        self.overflowed = False  # the stream has a gap — consumer should relist
        # kinds with an unrepaired gap; reflectors consume via take_overflow
        self._overflow_kinds: set = set()
        self.max_batch_seen = 0
        self._batch_hist = None
        self._events_ctr = None
        if metrics_registry is not None:
            from ..metrics import register_ingest_metrics

            register_ingest_metrics(metrics_registry, self)
        self._thread = threading.Thread(
            target=self._run, name="ingest-batcher", daemon=True
        )
        self._thread.start()

    # -- producer side -----------------------------------------------------

    def submit(self, verb: str, kind: str, payload) -> None:
        """Queue one op; never blocks. On a full queue the OLDEST op is
        shed (counted per event in ``dropped``, gap flagged)."""
        self.submit_many(((verb, kind, payload),))

    def submit_many(self, ops: Sequence[IngestOp]) -> None:
        """Queue a producer-side batch under one lock hold. Overflow sheds
        one op per overflowing op — the counter moves PER EVENT even when a
        whole producer batch is shed at once — under the verdict-safe
        policy (see the module docstring's overload posture)."""
        with self._cond:
            if self._stopped:
                return
            for op in ops:
                if len(self._queue) >= self.maxsize and not self._shed_for_locked(op):
                    continue  # the incoming op itself was shed
                self._queue.append(op)
                self.events_in += 1
            self._cond.notify()

    @staticmethod
    def _sheddable(op: IngestOp) -> bool:
        """Only pod upserts may be shed: a dropped pod refresh costs status
        lag until the forced relist; a dropped throttle spec, namespace, or
        ANY delete costs verdict correctness until a relist nobody runs."""
        verb, kind, _ = op
        return kind == "Pod" and verb != "delete"

    def _shed_one_locked(self, op: IngestOp) -> None:
        self.dropped += 1
        self.overflowed = True
        self._overflow_kinds.add(op[1])

    def _shed_for_locked(self, incoming: IngestOp) -> bool:
        """Make room for ``incoming`` on a full queue. True ⇒ append it;
        False ⇒ ``incoming`` itself was dropped (queued ops were all
        verdict-critical and the incoming op was not)."""
        while len(self._queue) >= self.maxsize:
            idx = next(
                (i for i, op in enumerate(self._queue) if self._sheddable(op)),
                None,
            )
            if idx is None:
                if self._sheddable(incoming):
                    self._shed_one_locked(incoming)
                    return False
                # verdict-critical op against a verdict-critical backlog:
                # exceed the bound rather than shed correctness (critical
                # ops are bounded by spec-churn rates, not pod storms)
                return True
            shed = self._queue[idx]
            del self._queue[idx]
            self._shed_one_locked(shed)
        return True

    def take_overflow(self, kind: str) -> bool:
        """Consume ``kind``'s pending-gap marker (True exactly once per
        overflow episode): the kind's reflector forces a relist to repair
        the shed events' gap. ``overflowed``/``dropped`` stay as the
        sticky stats."""
        with self._cond:
            if kind in self._overflow_kinds:
                self._overflow_kinds.discard(kind)
                return True
            return False

    # typed convenience (the watch/reflector layer's vocabulary)

    def upsert(self, kind: str, obj) -> None:
        self.submit("upsert", kind, obj)

    def delete(self, kind: str, key: str) -> None:
        self.submit("delete", kind, key)

    # -- dispatcher --------------------------------------------------------

    def _drain_locked(self) -> List[IngestOp]:
        n = min(len(self._queue), self._cur_max)
        batch = [self._queue.popleft() for _ in range(n)]
        if self.batch_policy == "adaptive":
            if self._queue:
                # backlog remains: next drain may take twice as much
                self._cur_max = min(self._cur_max * 2, self.max_batch)
            else:
                # queue ran dry: collapse toward the unloaded single-event
                # path (halving, not snapping to 1, rides out pacing jitter)
                self._cur_max = max(1, self._cur_max // 2)
        return batch

    def _apply(self, batch: List[IngestOp]) -> None:
        fault = (
            self.faults.check("ingest.batch.partial")
            if self.faults is not None and len(batch) > 1
            else None
        )
        if fault is not None:
            # a poisoned op mid-batch: apply the prefix, fail the op,
            # apply the suffix — the batch tears into two, never wedges
            k = len(batch) // 2
            self._apply_ops(batch[:k])
            self.op_errors += 1
            logger.warning(
                "ingest: injected partial-batch failure dropped op %d/%d "
                "(site ingest.batch.partial, hit %d)", k, len(batch), fault.hit
            )
            self._apply_ops(batch[k + 1 :])
            return
        self._apply_ops(batch)

    def _apply_ops(self, ops: List[IngestOp]) -> None:
        if not ops:
            return
        if len(ops) == 1:
            # unloaded path: single events go through the exact pre-batching
            # single-op store path (no batch listeners, no group commit)
            verb, kind, payload = ops[0]
            try:
                with self.store._lock:  # noqa: SLF001 — same-package access
                    self.store._dispatch_locked(  # noqa: SLF001
                        self.store._apply_op_locked(verb, kind, payload)  # noqa: SLF001
                    )
                self.events_applied += 1
            except Exception:  # noqa: BLE001 — counted, never kills the loop
                self.op_errors += 1
                logger.warning("ingest: single op failed", exc_info=True)
            return
        results = self.store.apply_events(ops)
        ok = sum(1 for r in results if not isinstance(r, Exception))
        self.events_applied += ok
        errs = len(results) - ok
        if errs:
            self.op_errors += errs
            logger.warning("ingest: %d/%d ops failed in batch", errs, len(results))

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait(0.2)
                if self._stopped and not self._queue:
                    return
                batch = self._drain_locked()
                self._applying = True
            try:
                self._apply(batch)
            except Exception:  # noqa: BLE001 — a batch must never kill ingest
                self.op_errors += len(batch)
                logger.exception("ingest: batch apply failed (%d ops)", len(batch))
            finally:
                self.batches += 1
                if len(batch) > self.max_batch_seen:
                    self.max_batch_seen = len(batch)
                if self._batch_hist is not None:
                    self._batch_hist.observe_key((), float(len(batch)))
                if self._events_ctr is not None:
                    self._events_ctr.inc({}, float(len(batch)))
                with self._cond:
                    self._applying = False
                    self._cond.notify_all()  # wake flush()

    # -- lifecycle ---------------------------------------------------------

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until the queue is drained and no batch is in flight (or
        timeout). True when fully drained."""
        import time

        deadline = time.monotonic() + timeout
        with self._cond:
            while (self._queue or self._applying) and time.monotonic() < deadline:
                self._cond.wait(0.05)
            return not self._queue and not self._applying

    def qsize(self) -> int:
        with self._cond:
            return len(self._queue)

    def stop(self, timeout: float = 5.0) -> None:
        """Drain what's queued, then stop the dispatcher."""
        self.flush(timeout)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=2.0)

    def stats(self) -> dict:
        with self._cond:
            return {
                "events_in": self.events_in,
                "events_applied": self.events_applied,
                "batches": self.batches,
                "op_errors": self.op_errors,
                "dropped": self.dropped,
                "overflowed": self.overflowed,
                "queue_depth": len(self._queue),
                "cur_max": self._cur_max,
                "max_batch_seen": self.max_batch_seen,
            }


__all__ = ["MicroBatchIngest", "IngestOp"]
