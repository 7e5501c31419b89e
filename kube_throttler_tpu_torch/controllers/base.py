"""Shared controller worker-pool (reference controller.go:34-122).

N worker threads drain a rate-limiting workqueue; reconcile errors re-queue
with exponential backoff (controller.go:106-108); success forgets the key.
``enqueue_after`` drives override-boundary self-wakeups.

A periodic **resync** (``resync_interval`` + ``list_keys_func``) re-enqueues
every live key on a fixed cadence — the eventual-consistency backstop the
reference gets from its 5-minute informer resync (plugin.go:77,86): any
status left stale by a missed/unwirable event converges within one interval.
It rides the same delayed-queue machinery as ``enqueue_after`` via a
reserved sentinel key, so FakeClock tests drive it deterministically.
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import timedelta
from typing import Callable, Dict, List, Optional

from ..engine.store import EventType
from ..engine.workqueue import RateLimitingQueue, ShutDown
from ..utils.tracing import NoopTracer, vlog
from ..utils.clock import Clock, RealClock

logger = logging.getLogger(__name__)

# Reserved workqueue key that triggers a full re-enqueue of live keys.
# "\x00" cannot appear in a Kubernetes object name, so it can never collide
# with a real reconcile key.
RESYNC_KEY = "\x00resync"


class _BatchEventHandler:
    """Informer handler carrying a batch fast path.

    ``__call__`` keeps the plain per-event contract; ``on_events`` receives
    a whole ordered batch in one call (SharedIndexInformer.on_batch probes
    for the attribute). Bound methods cannot carry attributes, hence this
    two-slot wrapper — the controllers register it so a micro-batched
    ingest burst costs them ONE handler invocation and ONE workqueue lock
    hold instead of N."""

    __slots__ = ("_per_event", "on_events")

    def __init__(self, per_event, on_events):
        self._per_event = per_event
        self.on_events = on_events

    def __call__(self, event) -> None:
        self._per_event(event)


class ControllerBase:
    def __init__(
        self,
        name: str,
        target_kind: str,
        throttler_name: str,
        target_scheduler_name: str,
        clock: Optional[Clock] = None,
        threadiness: int = 1,
        resync_interval: Optional[timedelta] = None,
    ):
        self.name = name
        self.target_kind = target_kind
        self.throttler_name = throttler_name
        self.target_scheduler_name = target_scheduler_name
        self.clock = clock or RealClock()
        self.threadiness = threadiness
        self.workqueue = RateLimitingQueue(name, clock=self.clock)
        self.reconcile_func: Callable[[str], None] = lambda key: None
        # optional batched reconcile: a worker drains up to batch_max ready
        # keys and hands them over in one call, so a shared step (the device
        # used-aggregate flush+gather) is paid once per drain, not per key.
        # Returns {key: exception} for the keys to requeue.
        self.reconcile_batch_func: Optional[Callable[[List[str]], dict]] = None
        # 96, down from 256: a promoted flip waits out the IN-FLIGHT normal
        # drain before its express drain runs, so the drain size bounds the
        # flip tail — at full scale 256-key drains held flips ~100-500ms
        # p99, 96-key drains ~65ms, while the extra aggregate flushes are
        # noise (the steady-state steal is a list swap; measured sustained
        # ingest was unchanged)
        self.batch_max = 96
        # phase tracer (utils.tracing.PhaseTracer); set by the plugin so
        # reconcile latency lands in the same histogram family as the hot path
        self.tracer = NoopTracer()
        # periodic resync: every resync_interval, every key returned by
        # list_keys_func is re-enqueued (dedup'd by the workqueue)
        self.resync_interval = resync_interval
        self.list_keys_func: Optional[Callable[[], List[str]]] = None
        self._threads: List[threading.Thread] = []
        self._started = False
        # {store_key: id(status)} of writes in flight — see
        # _commit_reconcile_plans (self-echo suppression)
        self._inflight_status_echoes: Dict[str, int] = {}
        # StatusLagMetrics for LOCAL publication (set by the plugin when a
        # registry exists); remote publication is observed by the async
        # committer at PUT completion instead
        self.lag_metrics = None
        # policy-weighted flip promotion (docs/policy.md): key → hi-lane
        # priority, wired by the plugin from the policy engine's accel-
        # class value weights. None/0 keeps the lane's original FIFO.
        self.flip_priority_fn: Optional[Callable[[str], int]] = None
        if self.resync_interval is not None:
            self.workqueue.add_after(RESYNC_KEY, self.resync_interval)

    def _is_self_status_echo(self, event) -> bool:
        """True for the MODIFIED echo of a status THIS controller is
        writing right now. The store dispatches handlers synchronously
        inside the write, ON THE WRITER'S OWN THREAD — so the signature is
        (writing thread, key, identity of the exact status object passed
        in). The thread check closes the race where a CONCURRENT
        spec-update write from another thread re-attaches the stored
        (still-marked) status object via with_status while our marker is
        live: that event dispatches on the other thread and must still
        enqueue. Re-enqueueing a true self-echo is a guaranteed no-op
        reconcile — the write carried no information the reconcile that
        produced it hadn't already observed."""
        obj = event.obj
        return (
            event.type == EventType.MODIFIED
            and self._inflight_status_echoes.get(self._store_key(obj))
            == (threading.get_ident(), id(obj.status))
        )

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for i in range(self.threadiness):
            t = threading.Thread(
                target=self._run_worker, name=f"{self.name}-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        logger.info("Started %s workers name=%s threadiness=%d", self.name, self.throttler_name, self.threadiness)

    def stop(self) -> None:
        self.workqueue.shut_down()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()
        self._started = False

    def enqueue(self, key: str) -> None:
        self.workqueue.add(key)

    def enqueue_all(self, keys) -> None:
        self.workqueue.add_all(keys)

    @staticmethod
    def _selector_inputs_unchanged(old_pod, new_pod) -> bool:
        """Selector matching reads only labels + namespace, so an unchanged
        pair means the affected-throttle set cannot have moved — pod
        MODIFIED handlers take a single-lookup fast path with no
        reservation-move bookkeeping (the dominant churn shape:
        requests/status-only updates)."""
        return (
            old_pod is not None
            and old_pod.labels == new_pod.labels
            and old_pod.namespace == new_pod.namespace
        )

    def enqueue_after(self, key: str, duration: timedelta) -> None:
        self.workqueue.add_after(key, duration)

    def flip_priorities(self, keys) -> Optional[Dict[str, int]]:
        """Policy promotion priorities for a flip-promoted key set (the
        workqueue's (-priority, seq) hi-lane ordering input). None — the
        original FIFO — when no policy fn is wired or no key carries a
        non-zero weight, so the default path allocates nothing."""
        fn = self.flip_priority_fn
        if fn is None:
            return None
        out: Dict[str, int] = {}
        for key in keys:
            try:
                p = fn(key)
            except Exception:  # pragma: no cover — policy must not stall flips
                p = 0
            if p:
                out[key] = p
        return out or None

    def throttle_by_key(self, key: str):
        """Kind-specific store lookup by queue/store key (implemented by
        each controller; used by policy flip weighting and the preemption
        coordinator's candidate gathering)."""
        raise NotImplementedError

    # ------------------------------------------------- batched-drain commit

    def _commit_reconcile_plans(self, plans, now, errors, flip_keys=frozenset()) -> None:
        """Phases 2+3 of a batched reconcile drain, shared by both kinds'
        controllers (they differ only in writer methods and key forms).

        ``plans`` is ``[(queue_key, thr, new_thr | None, unreserve_pods)]``
        from the controller's compute phase. With a batch-capable status
        writer (the in-memory Store), every changed status lands in ONE
        store-lock hold — at drain saturation, per-key writes contend with
        the event-ingest threads for that lock hundreds of times per drain
        — and the post-write work runs afterwards (the used-vs-reserved
        double-count window is the few ms the batch write takes). Without
        one (remote mode, one HTTP PUT per object regardless), write and
        post-write work stay INTERLEAVED per key so the double-count
        window stays one PUT wide, exactly like the pre-batch code — a
        drain of slow PUTs must not delay key #1's unreserve to the end.

        ``flip_keys`` (queue keys) are statuses whose ``throttled`` flags
        or ``calculatedThreshold`` changed — the two-lane split: they are
        committed FIRST in every path (batch write order == store event
        dispatch order == watch order; interleaved PUTs go flips-first),
        and a lane-aware writer (the AsyncStatusCommitter) additionally
        routes them to its priority lane. Per-key ordering is unaffected:
        a key appears in ``plans`` once, so reordering between keys can
        never reorder writes of the same key.

        Controllers provide ``_write_status(thr)``,
        ``_batch_write_statuses(thrs) -> {store_key: obj|Exception} | None``
        (None ⇒ unsupported), ``_store_key(thr)``, and
        ``_prioritized_batch_attr`` (the lane-aware writer method name).
        """
        if flip_keys:
            plans = [p for p in plans if p[0] in flip_keys] + [
                p for p in plans if p[0] not in flip_keys
            ]
        changed = {key: new for key, _, new, _ in plans if new is not None}
        # event→publication lag inputs, keyed by STORE key: the enqueue
        # timestamp of the event that made each written key dirty
        event_ts: Dict[str, float] = {}
        flip_store_keys = set()
        for key, new in changed.items():
            sk = self._store_key(new)
            ts = self.workqueue.claim_ts(key)
            if ts is not None:
                event_ts[sk] = ts
            if key in flip_keys:
                flip_store_keys.add(sk)
        # self-echo suppression: the store dispatches our own MODIFIED echo
        # synchronously INSIDE the write below, and _on_throttle_event
        # re-enqueued the key on every one — at drain saturation ~half of
        # all drained keys were these no-op self-echo reconciles. Mark the
        # exact status objects about to be written (identity, per key) so
        # the handler can recognize and drop the echo; entries are removed
        # the moment the write returns. Remote-mode echoes arrive later as
        # freshly-decoded objects (different identity) and still enqueue —
        # the reference's watch-observe loop is preserved on the wire.
        me = threading.get_ident()
        for new in changed.values():
            self._inflight_status_echoes[self._store_key(new)] = (me, id(new.status))
        async_lanes = False
        try:
            if not changed:
                batched = {}
            else:
                pri = getattr(self.status_writer, self._prioritized_batch_attr, None)
                if pri is not None:
                    # lane-aware writer (AsyncStatusCommitter): flips take
                    # the priority PUT lane; it observes the lag histograms
                    # itself at PUT completion (publication is async here)
                    batched = pri(list(changed.values()), flip_store_keys, event_ts)
                    async_lanes = True
                else:
                    batched = self._batch_write_statuses(list(changed.values()))
        finally:
            for new in changed.values():
                self._inflight_status_echoes.pop(self._store_key(new), None)
        if batched is None:  # no batch writer: interleave per key
            for key, thr, new_thr, unreserve_pods in plans:
                try:
                    if new_thr is not None:
                        self._write_status(new_thr)
                        self._observe_lag(
                            event_ts, flip_store_keys, self._store_key(new_thr)
                        )
                    self._post_write(key, thr, new_thr, unreserve_pods, now)
                except Exception as e:  # noqa: BLE001 — requeued per key
                    errors[key] = e
            return
        if not async_lanes and batched and self.lag_metrics is not None:
            # local batched publication: the write above made every status
            # visible (store event dispatched inside the write, flips first)
            for sk, r in batched.items():
                if not isinstance(r, Exception):
                    self._observe_lag(event_ts, flip_store_keys, sk)
        store_to_queue = {self._store_key(new): key for key, new in changed.items()}
        write_errors = {
            store_to_queue.get(k, k): r
            for k, r in batched.items()
            if isinstance(r, Exception)
        }
        for key, thr, new_thr, unreserve_pods in plans:
            if key in write_errors:
                errors[key] = write_errors[key]
                continue
            try:
                self._post_write(key, thr, new_thr, unreserve_pods, now)
            except Exception as e:  # noqa: BLE001 — requeued per key
                errors[key] = e

    def _observe_lag(self, event_ts, flip_store_keys, store_key) -> None:
        if self.lag_metrics is None:
            return
        ts = event_ts.get(store_key)
        if ts is not None:
            self.lag_metrics.observe(
                self.target_kind,
                time.monotonic() - ts,
                store_key in flip_store_keys,
            )

    def _post_write(self, key, thr, new_thr, unreserve_pods, now) -> None:
        """Per-key work that must follow the status write: metrics record,
        unreserve-on-observe (throttle_controller.go:135-155 — the device
        path's set is snapshot-coherent with the aggregate; unreserve is a
        no-op for non-reserved pods), and the next override-boundary
        wakeup."""
        if self.metrics_recorder is not None:
            self.metrics_recorder.record(new_thr if new_thr is not None else thr)
        for p in unreserve_pods:
            self.unreserve_on_throttle(p, thr)
        next_in = thr.spec.next_override_happens_in(now)
        if next_in is not None:
            self.enqueue_after(key, next_in)

    def _resync(self) -> None:
        """Re-enqueue every live key, then re-arm the next tick. Errors in
        ``list_keys_func`` skip one tick but never kill the cadence."""
        try:
            if self.list_keys_func is not None:
                keys = self.list_keys_func()
                vlog(4, "%s: periodic resync, re-enqueuing %d keys", self.name, len(keys))
                for key in keys:
                    self.workqueue.add(key)
        except Exception:
            logger.exception("%s: resync key listing failed", self.name)
        finally:
            self.workqueue.forget(RESYNC_KEY)
            self.workqueue.done(RESYNC_KEY)
            if self.resync_interval is not None:
                self.workqueue.add_after(RESYNC_KEY, self.resync_interval)

    def _process_batch(self, keys: List[str]) -> None:
        """Run the (batched) reconcile for drained keys; requeue failures
        rate-limited (controller.go:106-108), forget successes."""
        if RESYNC_KEY in keys:
            keys = [k for k in keys if k != RESYNC_KEY]
            self._resync()
            if not keys:
                return
        failures: dict = {}
        try:
            vlog(4, "%s: reconciling batch %r", self.name, keys)
            with self.tracer.trace("reconcile"):
                if self.reconcile_batch_func is not None:
                    failures = self.reconcile_batch_func(keys) or {}
                else:
                    for key in keys:
                        try:
                            self.reconcile_func(key)
                        except Exception as e:
                            failures[key] = e
        except Exception as e:  # batch-level crash fails every key
            failures = {key: e for key in keys}
        for key in keys:
            if key in failures:
                self.workqueue.add_rate_limited(key)
                logger.error(
                    "error reconciling %r, requeuing", key, exc_info=failures[key]
                )
            else:
                self.workqueue.forget(key)
            self.workqueue.done(key)

    def _drain_more(self, first: str, first_hi: bool = False) -> List[str]:
        """Extend a drain batch. A PRIORITY first key takes the flip
        express: the drain extends with priority-lane keys ONLY, so a flip
        publication pays a few-key drain (aggregate flush + a handful of
        writes) instead of riding a full ``batch_max`` refresh cycle — at
        full scale that is the difference between ~20ms and ~100ms+ of
        flip lag. Refresh keys wait for the next normal drain; the lane is
        almost always near-empty, so express drains are tiny and cheap."""
        keys = [first]
        if self.reconcile_batch_func is not None:
            while len(keys) < self.batch_max:
                nxt = self.workqueue.try_get(hi_only=first_hi)
                if nxt is None:
                    break
                keys.append(nxt)
        return keys

    def _run_worker(self) -> None:
        while True:
            try:
                key, was_hi = self.workqueue.get_lane()
            except ShutDown:
                return
            # loop-level routing (threads checker): per-key reconcile
            # errors are requeued inside _process_batch; this backstop is
            # for the UNEXPECTED — a worker dying here would silently
            # stop reconciliation for its share of the queue while every
            # probe stayed green (the silent-death class)
            try:
                self._process_batch(self._drain_more(key, first_hi=was_hi))
            except Exception:  # noqa: BLE001 — keep the worker alive
                logger.exception(
                    "%s worker: unexpected reconcile-batch failure (key=%s)",
                    self.name, key,
                )

    def run_pending_once(self, max_items: int = 10000) -> int:
        """Synchronously drain currently-ready queue items on the calling
        thread (deterministic tests / single-threaded embedding). Returns the
        number of reconciles executed."""
        n = 0
        while len(self.workqueue) > 0 and n < max_items:
            key = self.workqueue.get(timeout=0.01)
            keys = self._drain_more(key)
            self._process_batch(keys)
            n += len(keys)
        return n
