"""GC hygiene for the serving daemon: freeze the startup heap, defer
full collections, and run them from a controlled background cadence.

Why this exists (measured at the 100k-pod × 10k-throttle scale, one CPU
core): a CPython generation-2 collection scans every tracked object, and
the daemon's steady-state heap is ~1.4M tracked objects — each automatic
full collection paused every thread 500-750 ms. Those pauses land inside
reconcile drains and are the single largest contributor to the
throttled-flip publication tail (a flip otherwise publishes in ~2 drain
periods; one GC pause multiplies that 5×).

The treatment is the standard long-lived-heap posture (cf. Instagram's
``gc.freeze`` deployment):

- ``freeze_startup_heap()`` — ONE full collection while the daemon is
  not yet serving, then ``gc.freeze()``: the startup object graph (store
  objects, device mirror planes, compiled-kernel caches) moves to the
  permanent generation and is never scanned again. Frozen objects that
  later become garbage are still freed by REFERENCE COUNTING — freezing
  only removes them from the cycle collector's scan set, so the only
  objects it can pin are members of cycles formed before the freeze, and
  those were just collected.
- generation-2 auto-collection is deferred (threshold raised so it
  effectively never self-triggers): the engine's churn is acyclic —
  frozen dataclasses replaced whole on every write — measured at ZERO
  cyclic objects over a full-scale paced window, so deferring the cycle
  collector does not grow the heap; gen-0/1 keep running (sub-25 ms).
- ``GcHygieneThread`` — the leak backstop: every ``interval_s`` it runs
  one full collection over the (small) unfrozen remainder and re-freezes
  the survivors. The pause cost scales with ONE interval's surviving
  allocations, not the whole heap, and the cadence bounds how much any
  future cyclic garbage could accumulate. Pause durations are observed
  into the phase tracer (``gc_full_collect``) so the tail is attributable
  from /metrics.

``KT_GC_FREEZE=0`` disables the whole posture (the only reason to do so
is debugging with ``gc.get_objects``, which cannot see the permanent
generation).

Re-measured on the columnar arena heap: the store no longer holds
a per-pod object graph (pods live in interned struct-of-arrays columns,
materialized lazily at the API edge and freed by refcounting), so a
full-scale 100k-pod serving heap drops from ~1.4M tracked objects to
~150-300k — a full collection over it is tens of ms, not 500-750 ms.
The posture is therefore CONDITIONAL now: ``freeze_startup_heap``
measures the post-collect tracked-object count and only freezes +
defers gen-2 when it exceeds ``KT_GC_FREEZE_MIN_OBJECTS`` (default
200k — see the floor's comment for the churn measurement that set it).
Below the floor the default generational GC is measurably cheaper than
carrying a permanent generation, and ``gc.get_objects`` keeps working
for debugging.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time

logger = logging.getLogger("kube_throttler_tpu")

# effectively-never for automatic gen2 self-triggering (collections still
# run explicitly from the hygiene thread); gen0/gen1 defaults are kept
_DEFERRED_GEN2_THRESHOLD = 1_000_000

# tracked-object floor below which the freeze posture is skipped.
# Re-measured on the columnar arena heap (bench --mega, 100k×10k rung):
# the PER-POD object population is gone, but a serving stack still
# carries ~300-400k tracked objects (throttle/status dataclasses,
# kernel caches, runtime) and an unfrozen gen-2 pass over them pauses
# ~300+ ms — churn throughput collapsed ~8× when the floor left that
# heap unfrozen. So the posture RETIRES only for genuinely small heaps
# (CLIs, tests, sub-10k-pod daemons land well under 200k); every real
# serving heap still freezes.
_DEFAULT_MIN_OBJECTS = 200_000


def enabled() -> bool:
    return os.environ.get("KT_GC_FREEZE", "1") != "0"


def freeze_min_objects() -> int:
    try:
        return int(os.environ.get("KT_GC_FREEZE_MIN_OBJECTS", _DEFAULT_MIN_OBJECTS))
    except ValueError:
        return _DEFAULT_MIN_OBJECTS


def freeze_startup_heap() -> int:
    """Collect, then freeze + defer gen-2 ONLY if the surviving tracked
    heap is large enough for full-collection pauses to matter (see
    module docstring — the columnar store keeps most serving heaps under
    the floor). Call once, after the daemon's stores/mirrors/caches are
    built but before it takes traffic (the collection itself is the last
    uncontrolled full-heap pause). Returns the frozen-object count, 0
    when the heap stayed below the floor (no freeze), or -1 when
    disabled via KT_GC_FREEZE=0."""
    if not enabled():
        return -1
    t0 = time.perf_counter()
    gc.collect()
    tracked = len(gc.get_objects())
    floor = freeze_min_objects()
    if tracked < floor:
        logger.info(
            "gc hygiene: %d tracked objects < %d floor — keeping default "
            "generational GC (no freeze; collected in %.0fms)",
            tracked, floor, (time.perf_counter() - t0) * 1e3,
        )
        return 0
    gc.freeze()
    g0, g1, _ = gc.get_threshold()
    gc.set_threshold(g0, g1, _DEFERRED_GEN2_THRESHOLD)
    frozen = gc.get_freeze_count()
    logger.info(
        "gc hygiene: froze %d startup objects in %.0fms; gen2 deferred",
        frozen, (time.perf_counter() - t0) * 1e3,
    )
    return frozen


class GcHygieneThread(threading.Thread):
    """Periodic collect-and-refreeze backstop (see module docstring).

    The interval trades pause size against cyclic-garbage residency: each
    tick's pause scans only allocations that survived since the last
    tick. The default (300 s) keeps the tick far rarer than status flips
    while bounding residency to minutes; latency-critical deployments
    can stretch it via KT_GC_COLLECT_INTERVAL_S."""

    def __init__(self, interval_s: float | None = None, tracer=None):
        super().__init__(name="gc-hygiene", daemon=True)
        if interval_s is None:
            try:
                interval_s = float(os.environ.get("KT_GC_COLLECT_INTERVAL_S", "300"))
            except ValueError:
                interval_s = 300.0
        self.interval_s = interval_s
        self.tracer = tracer
        self.last_pause_s: float | None = None
        self.ticks = 0
        self._stop_requested = threading.Event()

    def run(self) -> None:
        while not self._stop_requested.wait(self.interval_s):
            # loop-level routing (threads checker): the backstop must not
            # die of a tracer/logging hiccup — a silently dead hygiene
            # thread re-grows the gen2 heap for the process lifetime
            try:
                t0 = time.perf_counter()
                unreachable = gc.collect()
                gc.freeze()
                pause = time.perf_counter() - t0
                self.last_pause_s = pause
                self.ticks += 1
                if self.tracer is not None:
                    self.tracer.observe("gc_full_collect", pause)
                logger.info(
                    "gc hygiene: full collect freed %d cyclic objects in %.0fms "
                    "(%d now frozen)", unreachable, pause * 1e3, gc.get_freeze_count(),
                )
            except Exception:  # noqa: BLE001 — keep the backstop alive
                logger.exception("gc hygiene tick failed")

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_requested.set()
        self.join(timeout=timeout)
