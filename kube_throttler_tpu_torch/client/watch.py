"""Watch streams over the store (the clientset's Watch verb).

The reference's generated clients expose ``Watch(ctx, opts)`` returning a
``watch.Interface`` whose ``ResultChan()`` yields typed events
(clientset/versioned/typed/schedule/v1alpha1/throttle.go:110-125). Here a
``Watch`` is an iterator over :class:`~..engine.store.Event` objects fed by
the store's synchronous dispatch, decoupled through a queue so consumers run
on their own thread at their own pace.

The queue is BOUNDED (client-go's watch channels are too — chanSize 100 in
the reflector): the store dispatches events synchronously under its lock,
so a slow or dead consumer on an unbounded queue would grow memory without
limit, and on a blocking one would wedge every mutator in the process. The
default policy is ``drop-oldest``: the dispatch thread never blocks, the
consumer keeps the newest events, and the watch is marked ``overflowed`` so
the consumer knows its stream has a gap and can relist (the same contract
as a 410 on a real watch). ``block`` restores the old apply-backpressure
behavior for consumers that must see every event and guarantee their own
pace.
"""

from __future__ import annotations

import queue
import threading
import weakref
from collections import deque
from typing import Callable, Iterator, List, Optional, Union

from ..utils.lockorder import make_lock
from ..engine.store import Event, EventType, Store


class Watch:
    """A stoppable stream of events for one kind.

    With ``replay`` the stream begins with synthetic ADDED events for every
    object currently in the store (list-then-watch semantics).

    ``maxsize`` bounds the queue (0 = unbounded); ``overflow`` picks the
    slow-consumer policy: ``"drop-oldest"`` (default — dispatch never
    blocks, ``overflowed``/``dropped`` record the gap) or ``"block"``
    (dispatch waits; the pre-hardening behavior).
    """

    _SENTINEL = object()

    DEFAULT_MAXSIZE = 4096
    OVERFLOW_POLICIES = ("drop-oldest", "block")

    # class-level aggregates for /metrics (see metrics.register_watch_metrics):
    # live instances tracked weakly so an abandoned, never-stopped watch
    # doesn't pin the stats forever
    _live: "weakref.WeakSet[Watch]" = weakref.WeakSet()
    _stats_lock = make_lock("watch.stats")
    _dropped_total = 0

    def __init__(
        self,
        store: Store,
        kind: str,
        filter: Optional[Callable[[Event], bool]] = None,
        replay: bool = False,
        maxsize: Optional[int] = None,
        overflow: str = "drop-oldest",
    ) -> None:
        if overflow not in self.OVERFLOW_POLICIES:
            raise ValueError(
                f"overflow must be one of {self.OVERFLOW_POLICIES}, got {overflow!r}"
            )
        self._store = store
        self._kind = kind
        self._filter = filter
        self._maxsize = self.DEFAULT_MAXSIZE if maxsize is None else max(0, maxsize)
        self._overflow = overflow
        self._queue: "queue.Queue" = queue.Queue(maxsize=self._maxsize)
        self._stopped = threading.Event()
        self._terminal = False  # consumer-side: sentinel observed
        # consumer-side unpack buffer for batch items (micro-batched ingest
        # delivers one LIST per store batch — see on_batch)
        self._pending: "deque[Event]" = deque()
        self.dropped = 0  # events shed by drop-oldest on this watch (PER EVENT)
        self.overflowed = False  # the stream has a gap — consumer should relist

        def handler(event: Event) -> None:
            if self._stopped.is_set():
                return
            if store.in_batch_dispatch:
                return  # delivered as a batch item by on_batch
            if self._filter is not None and not self._filter(event):
                return
            self._put(event, 1)

        self._handler = handler
        Watch._live.add(self)
        store.add_event_handler(kind, handler, replay=replay)
        store.add_batch_listener(self)

    def on_batch(self, events: List[Event]) -> None:
        """Store batch-listener hook: the batch's matching events enqueue
        as ONE item (a list — a slow consumer pays one queue round trip
        per ingest batch, and the wire watch can encode them in one
        write). Shedding accounts PER EVENT: a dropped list moves the
        overflow counters by its length — counting batches would
        under-report the stream's gap by the batch size."""
        if self._stopped.is_set():
            return
        matched = [
            e
            for e in events
            if e.kind == self._kind and (self._filter is None or self._filter(e))
        ]
        if not matched:
            return
        self._put(matched[0] if len(matched) == 1 else matched, len(matched))

    def _put(self, item: Union[Event, List[Event]], n_events: int) -> None:
        """Enqueue one item (an Event or a batch list) under the overflow
        policy; drop-oldest counts shed EVENTS, not items."""
        if self._overflow == "block":
            self._queue.put(item)
            return
        while True:
            try:
                self._queue.put_nowait(item)
                return
            except queue.Full:
                try:
                    shed = self._queue.get_nowait()
                except queue.Empty:
                    continue  # consumer raced us; retry the put
                if shed is self._SENTINEL:
                    # never shed the terminator: the stream is stopping,
                    # losing THIS item instead is fine
                    self._queue.put_nowait(shed)
                    return
                n = len(shed) if isinstance(shed, list) else 1
                self.overflowed = True
                self.dropped += n
                with Watch._stats_lock:
                    Watch._dropped_total += n

    def stop(self) -> None:
        """Terminate the stream; pending and future ``next()`` calls raise
        StopIteration once drained."""
        if not self._stopped.is_set():
            self._stopped.set()
            self._store.remove_event_handler(self._kind, self._handler)
            self._store.remove_batch_listener(self)
            while True:
                try:
                    self._queue.put_nowait(self._SENTINEL)
                    return
                except queue.Full:
                    # full bounded queue with a gone consumer: shed one event
                    # to make room for the terminator (never block stop())
                    try:
                        self._queue.get_nowait()
                    except queue.Empty:
                        continue

    def qsize(self) -> int:
        # queue items plus the consumer-side unpack buffer; a batch item
        # counts once here (the depth gauge reads this — cheap, slightly
        # under events when batches are queued)
        return self._queue.qsize() + len(self._pending)

    def next(self, timeout: Optional[float] = None) -> Event:
        """Block for the next event. Raises ``queue.Empty`` on timeout,
        ``StopIteration`` after :meth:`stop`. Batch items unpack
        transparently — consumers keep their one-event-at-a-time view."""
        # once the sentinel has been observed the stream is terminal — a
        # straggler event that raced in behind the sentinel must never be
        # returned, so the flag (not the queue contents) is authoritative
        if self._terminal:
            raise StopIteration
        if self._pending:
            return self._pending.popleft()
        item = self._queue.get(timeout=timeout)
        if item is self._SENTINEL:
            self._terminal = True
            raise StopIteration
        if isinstance(item, list):
            self._pending.extend(item)
            return self._pending.popleft()
        return item

    def next_batch(self, timeout: Optional[float] = None, max_events: int = 256) -> List[Event]:
        """Drain up to ``max_events`` immediately-available events in one
        call (blocking like :meth:`next` for the first) — the consumer-side
        micro-batch for wire encoders and reflectors: one socket write /
        one store application per drained batch instead of per event."""
        out = [self.next(timeout=timeout)]
        while len(out) < max_events:
            if self._pending:
                out.append(self._pending.popleft())
                continue
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is self._SENTINEL:
                # re-stage the terminator for the NEXT call: this batch's
                # events are real and must be delivered first
                self._queue.put_nowait(item)
                break
            if isinstance(item, list):
                self._pending.extend(item)
            else:
                out.append(item)
        return out

    def __iter__(self) -> Iterator[Event]:
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def __enter__(self) -> "Watch":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- metrics ----------------------------------------------------------

    @classmethod
    def stats(cls) -> dict:
        """Aggregate snapshot across live watches (scrape-time reader for
        the watch-queue gauge/counter families)."""
        live = [w for w in cls._live if not w._stopped.is_set()]
        with cls._stats_lock:
            dropped_total = cls._dropped_total
        return {
            "open": len(live),
            "depth": sum(w.qsize() for w in live),
            "dropped_total": dropped_total,
        }


__all__ = ["Watch", "Event", "EventType"]
