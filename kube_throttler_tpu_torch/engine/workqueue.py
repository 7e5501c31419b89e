"""client-go-style rate-limiting workqueue.

Reproduces the semantics the controllers depend on
(controller.go:34-122 uses workqueue.NewNamedRateLimitingQueue with the
DefaultControllerRateLimiter):

- **dedup**: an item Add()ed while queued is not duplicated; an item Add()ed
  while *processing* is marked dirty and re-queued when Done() is called —
  so a reconcile never misses the latest state and never runs concurrently
  for the same key;
- **AddAfter**: delayed insertion (override-boundary self-wakeups,
  controller.go:64-72);
- **AddRateLimited / Forget**: per-item exponential backoff
  (5ms · 2^fails, capped at 1000s — client-go's ItemExponentialFailureRateLimiter
  defaults) reset by Forget on success.

Two extensions client-go does not have, both serving the two-lane status
pipeline (flip-first publication):

- **ordered priority lane** (``add_priority`` / ``add_all_priority``): a
  second lane drained before the normal one, ordered by **(priority desc,
  age)** — a heap of ``(-priority, enqueue seq, item)``. Without explicit
  priorities every item enters at priority 0 and the lane degenerates to
  the original FIFO (age order), so the flip-first pipeline is unchanged;
  WITH priorities (``add_all_priority(items, priorities={item: int})``)
  candidates drain highest-priority-first, ties oldest-first — the
  preemption-ordered admission lane (docs/gang_admission.md): when
  capacity opens, flip candidates no longer drain in arbitrary key order.
  Promoting an item already queued normal MOVES it (an item is only ever
  queued once — dedup is lane-global); promoting an item in processing
  re-queues it into the priority lane at Done() with its recorded
  priority. Promoting an item ALREADY in the hi lane at a different
  priority re-orders it in place (lazy heap supersede) — a pod/group
  priority-annotation update reorders already-queued work instead of
  riding the stale enqueue-time priority. Used for throttles whose ``status.throttled`` flag is about
  to flip: they overtake the value-only refresh backlog, which at full
  scale is the difference between ~100ms and multi-second flip
  publication.
- **enqueue timestamps** (``claim_ts``): the wall (monotonic) time of the
  FIRST add since the item was last handed out, claimed by the consumer at
  commit time — the "event" end of the event→publication lag histograms.

The delay waker sleeps on a condition variable until the EARLIEST delayed
deadline (no unconditional polling — an idle daemon makes zero wakeups);
``add_after`` re-arms it, and a FakeClock jump notifies it via the clock's
subscribe hook, keeping FakeClock tests deterministic.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from datetime import timedelta
from typing import Dict, List, Optional, Set, Tuple

from ..utils.clock import Clock, RealClock
from ..utils.lockorder import assert_held, guard_attrs, make_rlock

logger = logging.getLogger(__name__)

_BASE_DELAY = 0.005  # 5ms
_MAX_DELAY = 1000.0  # 1000s


class ShutDown(Exception):
    pass


@guard_attrs
class RateLimitingQueue:
    # every queue structure below moves only under the single shared lock
    # (held directly or via either condition); see docs/STATIC_ANALYSIS.md
    GUARDED_BY = {
        "_queue": "self._lock",
        "_queue_hi": "self._lock",
        "_hi": "self._lock",
        "_hi_pending": "self._lock",
        "_dirty": "self._lock",
        "_processing": "self._lock",
        "_failures": "self._lock",
        "_enqueue_ts": "self._lock",
        "_claim_ts": "self._lock",
        "_delayed": "self._lock",
        "_seq": "self._lock",
        "_shutdown": "self._lock",
    }

    def __init__(self, name: str = "", clock: Optional[Clock] = None):
        self.name = name
        self._clock = clock or RealClock()
        # consumers (get) and the delay waker wait on separate conditions
        # over ONE shared lock, so add()/done() can notify exactly one
        # consumer without waking (or losing the wakeup to) the waker
        self._lock = make_rlock(f"workqueue.{name or 'unnamed'}")
        self._cond = threading.Condition(self._lock)
        self._waker_cond = threading.Condition(self._lock)
        self._queue: List[str] = []  # FIFO of ready items (normal lane)
        # priority lane, drained first: heap of (-priority, seq, item) —
        # highest priority first, ties in enqueue (age) order
        self._queue_hi: List[Tuple[int, int, str]] = []
        # members of _queue_hi: item → its LIVE heap entry (-priority,
        # seq). Re-prioritizing a queued item pushes a fresh entry and
        # rebinds the mapping; the superseded heap entry is skipped lazily
        # at pop (it no longer matches). Without this, hi-lane priority
        # was pinned at enqueue time — a pod/group priority-annotation
        # update could not reorder already-queued work.
        self._hi: Dict[str, Tuple[int, int]] = {}
        # promoted while processing: done() re-queues into the hi lane at
        # the recorded priority (item → priority)
        self._hi_pending: Dict[str, int] = {}
        self._dirty: Set[str] = set()
        self._processing: Set[str] = set()
        self._failures: Dict[str, int] = {}
        # item → monotonic time of the first add since it was last handed
        # out (get/try_get move it to _claim_ts; claim_ts pops it)
        self._enqueue_ts: Dict[str, float] = {}
        self._claim_ts: Dict[str, float] = {}
        self._delayed: List[Tuple[float, int, str]] = []  # (ready_ts, seq, item)
        self._seq = 0
        self._shutdown = False
        self._clock.subscribe(self._on_clock_jump)
        self._waker = threading.Thread(target=self._delay_loop, daemon=True)
        self._waker.start()

    def _on_clock_jump(self) -> None:
        with self._lock:
            self._cond.notify_all()
            self._waker_cond.notify_all()

    # -- core queue semantics (client-go workqueue/queue.go) ---------------

    def add(self, item: str) -> None:
        with self._cond:
            if self._shutdown:
                return
            if item in self._dirty:
                return
            self._dirty.add(item)
            self._enqueue_ts.setdefault(item, time.monotonic())
            if item in self._processing:
                return  # re-queued by done()
            self._queue.append(item)
            self._cond.notify()

    def add_all(self, items) -> None:
        """Batch add under ONE lock hold: a pod event at full scale
        enqueues 20+ affected throttle keys — per-key lock round trips
        were ~10% of event-ingest cost."""
        with self._cond:
            if self._shutdown:
                return
            added = False
            now = time.monotonic()
            for item in items:
                if item in self._dirty:
                    continue
                self._dirty.add(item)
                self._enqueue_ts.setdefault(item, now)
                if item in self._processing:
                    continue  # re-queued by done()
                self._queue.append(item)
                added = True
            if added:
                self._cond.notify()

    def add_priority(self, item: str, priority: int = 0) -> None:
        self.add_all_priority((item,), priorities={item: priority} if priority else None)

    def _push_hi_locked(self, item: str, priority: int) -> None:
        assert_held(self._lock, "RateLimitingQueue._push_hi_locked")
        self._seq += 1
        entry = (-int(priority), self._seq)
        heapq.heappush(self._queue_hi, (entry[0], entry[1], item))
        self._hi[item] = entry

    def add_all_priority(self, items, priorities: Optional[Dict[str, int]] = None) -> None:
        """Add/promote items into the ordered priority lane (one lock
        hold). ``priorities`` (item → int, default 0) orders the drain
        (priority desc, age); omitted, the lane is the original FIFO. An
        item already queued normal MOVES — the single-queued-once dedup
        invariant is lane-global, which is also what makes per-key
        ordering trivial (an item is never drained twice for one add). An
        item in processing is re-queued into the hi lane by done()."""
        with self._cond:
            if self._shutdown:
                return
            move: Set[str] = set()
            added = False
            now = time.monotonic()
            for item in items:
                prio = int(priorities.get(item, 0)) if priorities else 0
                if item in self._hi:
                    if self._hi[item][0] == -prio:
                        continue  # already queued at this priority
                    # RE-prioritize in place: a priority-annotation update
                    # must reorder already-queued work, not ride the stale
                    # enqueue-time priority. Push a fresh entry (rebinding
                    # _hi); the superseded heap entry is skipped at pop.
                    self._push_hi_locked(item, prio)
                    added = True
                    continue
                if item in self._dirty:
                    if item in self._processing:
                        self._hi_pending[item] = prio
                        continue
                    move.add(item)  # queued normal: relocate below
                else:
                    self._dirty.add(item)
                    self._enqueue_ts.setdefault(item, now)
                    if item in self._processing:
                        self._hi_pending[item] = prio
                        continue
                self._push_hi_locked(item, prio)
                added = True
            if move:
                # one filter pass relocates every promoted normal-lane item
                self._queue = [i for i in self._queue if i not in move]
            if added:
                self._cond.notify()

    def _pop_ready_locked(self, hi_only: bool = False) -> Optional[Tuple[str, bool]]:
        """Caller holds the lock (the `_locked` contract — asserted under
        KT_LOCK_ASSERT=1). Priority lane first; ``hi_only`` refuses to touch
        the normal lane (the flip express drain). Returns (item, was_hi)."""
        assert_held(self._lock, "RateLimitingQueue._pop_ready_locked")
        item = None
        while self._queue_hi:
            negp, seq, cand = heapq.heappop(self._queue_hi)
            if self._hi.get(cand) != (negp, seq):
                continue  # superseded by a re-prioritize: skip the stale entry
            del self._hi[cand]
            item = cand
            break
        if item is not None:
            was_hi = True
        elif self._queue and not hi_only:
            item = self._queue.pop(0)
            was_hi = False
        else:
            return None
        self._processing.add(item)
        self._dirty.discard(item)
        ts = self._enqueue_ts.pop(item, None)
        if ts is not None:
            self._claim_ts[item] = ts
        return item, was_hi

    def get(self, timeout: Optional[float] = None) -> str:
        """Blocks until an item is available. Raises ShutDown."""
        return self.get_lane(timeout)[0]

    def get_lane(self, timeout: Optional[float] = None) -> Tuple[str, bool]:
        """``get`` plus which lane the item came from (True = priority) —
        the workers use the lane to shape the drain (a priority first-key
        triggers the flip express drain, controllers/base._drain_more)."""
        with self._cond:
            # _hi, not _queue_hi: the heap may hold only superseded
            # (re-prioritized) entries, which pop as nothing
            while not (self._queue or self._hi) and not self._shutdown:
                # untimed callers still wake on every add/done/shutdown
                # notify; the 1s re-check is only a lost-wakeup safety net
                if not self._cond.wait(timeout=timeout if timeout is not None else 1.0):
                    if timeout is not None:
                        raise TimeoutError
            if self._shutdown and not (self._queue or self._hi):
                raise ShutDown
            return self._pop_ready_locked()

    def try_get(self, hi_only: bool = False) -> Optional[str]:
        """Non-blocking get: an immediately-ready item or None (batch
        drain). ``hi_only`` drains the priority lane exclusively."""
        with self._cond:
            popped = self._pop_ready_locked(hi_only=hi_only)
            return popped[0] if popped is not None else None

    def claim_ts(self, item: str) -> Optional[float]:
        """Monotonic time of the first add that made the in-flight ``item``
        dirty (pops it — one lag sample per hand-out). The consumer calls
        this at commit time to observe event→publication lag."""
        with self._cond:
            return self._claim_ts.pop(item, None)

    def done(self, item: str) -> None:
        with self._cond:
            self._processing.discard(item)
            self._claim_ts.pop(item, None)  # unclaimed: drop, don't leak
            if item in self._dirty:
                if item in self._hi_pending:
                    self._push_hi_locked(item, self._hi_pending.pop(item))
                else:
                    self._queue.append(item)
                self._cond.notify()
            else:
                self._hi_pending.pop(item, None)

    # -- delay / rate limiting --------------------------------------------

    def add_after(self, item: str, delay: timedelta) -> None:
        secs = delay.total_seconds()
        if secs <= 0:
            self.add(item)
            return
        ready = self._now_ts() + secs
        with self._lock:
            if self._shutdown:
                return
            self._seq += 1
            heapq.heappush(self._delayed, (ready, self._seq, item))
            self._waker_cond.notify_all()  # new earliest deadline, re-arm

    def add_rate_limited(self, item: str) -> None:
        with self._cond:
            fails = self._failures.get(item, 0)
            self._failures[item] = fails + 1
        delay = min(_BASE_DELAY * (2**fails), _MAX_DELAY)
        self.add_after(item, timedelta(seconds=delay))

    def forget(self, item: str) -> None:
        with self._cond:
            self._failures.pop(item, None)

    def num_requeues(self, item: str) -> int:
        with self._cond:
            return self._failures.get(item, 0)

    # -- lifecycle ---------------------------------------------------------

    def shut_down(self) -> None:
        with self._lock:
            self._shutdown = True
            self._cond.notify_all()
            self._waker_cond.notify_all()
        # a shut-down queue must not stay referenced by a long-lived clock
        self._clock.unsubscribe(self._on_clock_jump)

    def __len__(self) -> int:
        with self._cond:
            # _hi, not _queue_hi: the heap may carry superseded
            # (re-prioritized) entries that no longer represent items
            return len(self._queue) + len(self._hi)

    # -- internals ---------------------------------------------------------

    def _now_ts(self) -> float:
        return self._clock.now().timestamp()

    def _delay_loop(self) -> None:
        """Move due delayed items onto the ready queue, sleeping until the
        earliest deadline (condition wait, not a poll): zero wakeups while
        idle. A FakeClock advance notifies via _on_clock_jump; add_after
        notifies when a new item becomes the earliest."""
        with self._waker_cond:
            while True:
                # loop-level routing (threads checker): a dead waker means
                # delayed retries are never delivered again — silently
                try:
                    if self._shutdown:
                        return
                    now = self._now_ts()
                    while self._delayed and self._delayed[0][0] <= now:
                        _, _, item = heapq.heappop(self._delayed)
                        if item not in self._dirty:
                            self._dirty.add(item)
                            self._enqueue_ts.setdefault(item, time.monotonic())
                            if item not in self._processing:
                                self._queue.append(item)
                                self._cond.notify()
                    timeout = self._delayed[0][0] - now if self._delayed else None
                    self._waker_cond.wait(timeout=timeout)
                except Exception:  # noqa: BLE001 — keep the waker alive
                    logger.exception("delay-queue waker error")
                    self._waker_cond.wait(timeout=0.1)
