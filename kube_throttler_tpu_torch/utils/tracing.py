"""Tracing / profiling — the TPU build's observability beyond gauges.

The reference's only tracing is klog verbosity levels V(2)-V(5) plus a
dynamic log-level endpoint (SURVEY §5: plugin.go:157,
reserved_resource_amounts.go:197, Makefile:94-95). The TPU-native
equivalent here is richer, per the survey's prescription:

- :class:`PhaseTracer` — per-phase wall-clock histograms
  (``kube_throttler_phase_duration_seconds{phase=...}``) exported through
  the same registry that serves ``/metrics``; phases cover the scheduling
  hot path (prefilter/reserve/unreserve), the async state engine
  (reconcile), and host↔device sync.
- klog-style verbosity: :func:`set_verbosity` / :func:`v_enabled` /
  :func:`vlog` map V-levels onto the stdlib logger the way klog maps them
  onto --v (V(2)≈INFO detail … V(5)≈trace). The daemon's
  ``PUT /debug/flags/v`` analog calls ``set_verbosity`` at runtime.
- :func:`device_trace` — context manager around ``torch.profiler`` (CPU
  and CUDA activities) writing a Chrome trace into a directory; no-op
  when profiling is unavailable.

While a ``torch.profiler`` session records, every tracer span is also a
profiler annotation (``record_function``) of the phase's name, and the
collector's pauses are ``gc_gen<N>`` annotations (``utils/gchygiene.py``),
so a trace names what the host was doing in each of the device's idle
gaps. With no session recording, a span costs one check (~0.1 µs) and
creates no annotation.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, Optional

from torch._C._autograd import _profiler_enabled as profiling
from torch.autograd.profiler import record_function

from .lockorder import make_lock

logger = logging.getLogger("kube_throttler_tpu")

_verbosity_lock = make_lock("tracing.verbosity")
_verbosity = 0


def set_verbosity(level: int) -> int:
    """Set the global V-level (klog --v / PUT /debug/flags/v analog).
    Returns the previous level."""
    global _verbosity
    with _verbosity_lock:
        prev, _verbosity = _verbosity, int(level)
    return prev


def get_verbosity() -> int:
    return _verbosity


def v_enabled(level: int) -> bool:
    """klog ``klog.V(level).Enabled()``."""
    return _verbosity >= level


def vlog(level: int, msg: str, *args) -> None:
    """klog ``klog.V(level).Infof`` — emits at INFO when the global
    verbosity admits the level, else drops (lazily formatted)."""
    if _verbosity >= level:
        logger.info(msg, *args)


class PhaseTracer:
    """Per-phase wall-clock histograms over a metrics Registry.

    One family, labeled by phase, so dashboards slice p50/p99 per phase:
    ``kube_throttler_phase_duration_seconds_bucket{phase="prefilter",...}``.
    """

    FAMILY = "kube_throttler_phase_duration_seconds"
    # the collector's pauses, per generation, since the accounting hook
    # was installed (gchygiene.install_gc_accounting); not in FAMILY
    GC_PHASES = ("gc_gen0", "gc_gen1", "gc_gen2")

    def __init__(self, registry) -> None:
        self._hist = registry.histogram_vec(
            self.FAMILY,
            "Wall-clock duration of kube-throttler phases (scheduling hot "
            "path, reconcile, device sync)",
            ["phase"],
        )

    def trace(self, phase: str) -> "_Trace":
        # a slotted context object, not @contextmanager: the generator
        # protocol costs ~3µs per enter/exit and the serving hot path
        # crosses 6+ trace scopes per decision
        return _Trace(self._hist, phase)

    def observe(self, phase: str, seconds: float) -> None:
        self._hist.observe({"phase": phase}, seconds)

    def snapshot(self, phase: str) -> Optional[Dict[str, float]]:
        """{"sum": s, "count": n, "mean": s/n} or None if never observed.
        ``gc_gen0``..``gc_gen2`` read the process's collector pauses
        (None until the accounting hook is installed)."""
        if phase in self.GC_PHASES:
            from .gchygiene import gc_totals

            snap = gc_totals(int(phase[-1]))
        else:
            snap = self._hist.snapshot({"phase": phase})
        if snap is None:
            return None
        total, count = snap
        return {"sum": total, "count": count, "mean": total / count if count else 0.0}


class _Trace:
    """Slotted timing scope: observes phase duration into the histogram
    family on exit (plus V(5) logging when enabled), inside a profiler
    annotation of the phase while a profiler session records."""

    __slots__ = ("_hist", "_phase", "_start", "_note")

    def __init__(self, hist, phase: str) -> None:
        self._hist = hist
        self._phase = phase

    def __enter__(self) -> None:
        if profiling():
            self._note = record_function(self._phase)
            self._note.__enter__()
        else:
            self._note = None
        self._start = time.perf_counter()

    def __exit__(self, exc_type, exc, tb) -> None:
        elapsed = time.perf_counter() - self._start
        self._hist.observe_key((self._phase,), elapsed)
        if self._note is not None:
            self._note.__exit__(exc_type, exc, tb)
        if v_enabled(5):
            vlog(5, "phase %s took %.6fs", self._phase, elapsed)


class _NoopHist:
    def observe(self, labels, value) -> None:
        pass

    def observe_key(self, key, value) -> None:
        pass

    def snapshot(self, labels):
        return None


class NoopTracer(PhaseTracer):
    """Tracer that records nothing (for callers constructed without a
    registry)."""

    def __init__(self) -> None:  # deliberately no super().__init__
        self._hist = _NoopHist()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU
    activity, plus CUDA when a card is present) and write it as a Chrome
    trace, ``trace-<pid>-<ns>.json``, into ``log_dir``. No-op with one
    warning if the profiler cannot start or stop."""
    prof = None
    try:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:  # backend-dependent
        logger.warning("device_trace unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
                )
            except Exception as e:
                logger.warning("stop_trace failed: %s", e)
