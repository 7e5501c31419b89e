"""The collector's pause accounting (``utils/gchygiene.py``): one
``gc.callbacks`` hook a process, however it is installed, summing pauses
per generation into what ``PhaseTracer.snapshot("gc_gen<N>")`` and the
``kube_throttler_gc_*`` families read; safe under any lock; a profiler
annotation per marked collection while a ``torch.profiler`` session
records."""

from __future__ import annotations

import gc
import threading

import pytest
import torch

from kube_throttler_tpu_torch.api.pod import Namespace
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.metrics import Registry
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.utils import gchygiene
from kube_throttler_tpu_torch.utils.tracing import PhaseTracer


def _hooks():
    return gc.callbacks.count(gchygiene._account)


def _profiled_counts(body):
    """Annotation names → occurrences in a CPU profile of ``body()``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        body()
    return {e.key: e.count for e in prof.key_averages()}


def test_one_hook_however_often_installed(monkeypatch):
    gchygiene.install_gc_accounting()
    gchygiene.install_gc_accounting()
    monkeypatch.setenv("KT_GC_FREEZE", "0")  # the disabled branch installs too
    assert gchygiene.freeze_startup_heap() == -1
    store = Store()
    store.create_namespace(Namespace("default"))
    for _ in range(2):
        KubeThrottler(decode_plugin_args({"name": "kube-throttler",
                                          "targetSchedulerName": "my-scheduler"}),
                      store, use_device=False)
    assert _hooks() == 1


def test_the_floor_branch_installs(monkeypatch):
    gchygiene.install_gc_accounting()
    gc.callbacks.remove(gchygiene._account)
    assert PhaseTracer(Registry()).snapshot("gc_gen0") is None
    monkeypatch.setenv("KT_GC_FREEZE_MIN_OBJECTS", str(1 << 40))
    assert gchygiene.freeze_startup_heap() == 0
    assert _hooks() == 1


def test_a_collection_is_counted_in_its_generation():
    gchygiene.install_gc_accounting()
    tracer = PhaseTracer(Registry())
    before = {g: tracer.snapshot(f"gc_gen{g}") for g in range(3)}
    gc.collect(1)
    after = {g: tracer.snapshot(f"gc_gen{g}") for g in range(3)}
    assert after[1]["count"] > before[1]["count"]
    assert after[1]["sum"] > before[1]["sum"]
    assert after[1]["mean"] == pytest.approx(after[1]["sum"] / after[1]["count"])
    gc.collect()
    assert tracer.snapshot("gc_gen2")["count"] > after[2]["count"]


@pytest.mark.parametrize("profiled", [False, True], ids=["plain", "profiled"])
def test_a_collection_under_the_histogram_lock_returns(profiled):
    """The hook takes no lock: a collection that starts while its thread
    holds the phase histogram's (plain) lock finishes."""
    gchygiene.install_gc_accounting()
    tracer = PhaseTracer(Registry())
    with tracer.trace("warm"):
        pass
    done = threading.Event()

    def collect_under_the_lock():
        with tracer._hist._lock:  # noqa: SLF001 — the lock a collection may start under
            gc.collect()
        done.set()

    def body():
        worker = threading.Thread(target=collect_under_the_lock, daemon=True)
        worker.start()
        worker.join(timeout=60)

    if profiled:
        _profiled_counts(body)
    else:
        body()
    assert done.is_set(), "gc.collect() under the histogram lock did not return"


def test_a_profiled_collection_is_an_annotation():
    gchygiene.install_gc_accounting()

    def body():
        gc.collect(1)
        gc.collect(0)

    counts = _profiled_counts(body)
    assert counts.get("gc_gen0", 0) >= 1
    assert counts.get("gc_gen1", 0) >= 1


def test_one_young_collection_a_cycle_is_marked():
    """Every older collection is marked, and of the gen-0 collections
    only the first after each older one: an allocation run of ~40 young
    collections leaves far fewer gen-0 annotations than collections."""
    gchygiene.install_gc_accounting()
    tracer = PhaseTracer(Registry())
    before = [tracer.snapshot(f"gc_gen{g}")["count"] for g in range(3)]
    kept = []

    def body():
        kept.extend([i] for i in range(gc.get_threshold()[0] * 40))

    counts = _profiled_counts(body)
    runs = [tracer.snapshot(f"gc_gen{g}")["count"] - b for g, b in zip(range(3), before)]
    assert runs[0] >= 20
    assert 1 <= counts.get("gc_gen1", 0) <= runs[1]
    assert counts.get("gc_gen0", 0) <= runs[1] + runs[2] + 1 < runs[0]
