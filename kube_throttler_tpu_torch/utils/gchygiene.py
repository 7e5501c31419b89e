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
  collector does not grow the heap; gen-0/1 keep running. Their pauses
  are measured per generation (the accounting below): on an H100 host's
  CPU, in the triage benchmark (100k pods, 10k throttles, a ~0.8-0.9 s
  ``pre_filter_batch`` that lists every pod), ~783 gen-0 collections a
  call took 33-34 ms in all (~43 µs each) and ~71 gen-1 collections
  64-67 ms (~0.9 ms each); gen 2 did not run.
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

Pause accounting: ``install_gc_accounting()`` adds ONE process-wide
``gc.callbacks`` hook (``freeze_startup_heap`` installs it in every
branch, and so does every plugin's metrics registry; installing twice
leaves one). It sums each collection's pause and count per generation
into preallocated totals, taking no lock and logging nothing (a
collection can start while its thread holds any lock, the registry's
included). The totals are ``PhaseTracer.snapshot("gc_gen0" | "gc_gen1"
| "gc_gen2")`` and, per generation, ``kube_throttler_gc_pause_seconds_total``
and ``kube_throttler_gc_collections_total`` on ``/metrics``. While a
``torch.profiler`` session records, a collection is also a ``gc_gen<N>``
annotation: every one of generations 1 and 2, and the first gen-0
collection after each older one (one per young cycle of
``gc.get_threshold()[1]`` gen-0 collections: a full-scale pod listing
runs ~780 gen-0 collections, and a mark for each would bury the span
it falls in under more nested annotations than a trace reader walks).

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
from typing import Optional, Tuple

from .lockorder import make_lock
from .tracing import profiling, record_function

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
    disabled via KT_GC_FREEZE=0. Installs the pause accounting in every
    case."""
    install_gc_accounting()
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


# per-generation pause seconds and collection counts since the hook was
# installed; written only by the hook and read without a lock (collections
# never overlap: the collector runs one at a time, under the GIL)
_PAUSE_S = [0.0, 0.0, 0.0]
_COLLECTIONS = [0, 0, 0]
_NOTE_NAMES = ("gc_gen0", "gc_gen1", "gc_gen2")
_install_lock = make_lock("gchygiene.install")


class _Running:
    """The running collection's start and profiler annotation (when
    marked), and whether the next gen-0 collection is marked."""

    __slots__ = ("started", "note", "mark_young")

    def __init__(self) -> None:
        self.started, self.note, self.mark_young = 0.0, None, True


def _account(phase, info, _now=time.perf_counter, _profiling=profiling,
             _annotation=record_function, _names=_NOTE_NAMES, _pause=_PAUSE_S,
             _count=_COLLECTIONS, _run=_Running()) -> None:
    """The ``gc.callbacks`` hook: it takes no lock and logs nothing. What
    it reads is bound as defaults, so that it still runs while the
    interpreter clears module globals at exit."""
    gen = info["generation"]
    if phase == "start":
        if (gen or _run.mark_young) and _profiling():
            _run.note = _annotation(_names[gen])
            _run.note.__enter__()
        _run.started = _now()
        return
    _pause[gen] += _now() - _run.started
    _count[gen] += 1
    _run.mark_young = gen > 0
    if _run.note is not None:
        note, _run.note = _run.note, None
        note.__exit__(None, None, None)


def install_gc_accounting() -> None:
    """Add the pause-accounting hook to ``gc.callbacks`` unless it is
    there already: one per process, however often called."""
    with _install_lock:
        if _account not in gc.callbacks:
            gc.callbacks.append(_account)


def gc_totals(generation: int) -> Optional[Tuple[float, int]]:
    """(pause seconds, collections) of ``generation`` since the hook was
    installed; None while it is not."""
    if _account not in gc.callbacks:
        return None
    return _PAUSE_S[generation], _COLLECTIONS[generation]


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
