"""Verdict-coherence assassin — the runtime half of the gen-4 ``epochs``
checker (``KT_EPOCH_ASSERT=1``, armed suite-wide by tests/conftest.py
like ``KT_LOCK_ASSERT``/``KT_RACE_DETECT``).

The static checker proves every *visible* write to a verdict plane is
dominated by an epoch bump; ``epoch_allow.txt`` waives the sites it
cannot prove. What neither can see: a waiver that is simply wrong, a
mutation reached through a path the AST resolution missed, or a future
plane that never made it into the registry. This module closes that gap
the way hold budgets keep ``blocking_allow.txt`` honest — by checking
the invariant the whole discipline exists to protect, at the exact
place it pays out:

- every Nth VerdictCache **hit** (sampled — ``KT_EPOCH_ASSERT_SAMPLE``,
  default 7) is shadow-recomputed through the uncached oracle route
  (``_pre_filter_uncached``, side-effect-free);
- a divergence means a verdict-affecting mutation landed WITHOUT
  bumping a covered epoch: the fingerprint still matches
  (``cached esum == current esum`` — that equality is the smoking gun)
  while the recomputed truth moved. A :class:`StaleVerdict` is raised
  at **first observation** with both epochs, both verdicts, and the
  file:line of the most recent covered mutations (devicestate's
  ``_note_thr_col`` reports them via :func:`note_mutation` when armed)
  — i.e. the mutation that should have bumped.

Production cost is one ``os.environ`` read at import: everything here
is behind the cached arming flag.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import deque
from typing import Deque, List, Optional, Tuple

__all__ = [
    "enabled",
    "should_check",
    "check_hit",
    "note_mutation",
    "reports",
    "reset",
    "set_sample",
    "StaleVerdict",
]


def enabled() -> bool:
    return os.environ.get("KT_EPOCH_ASSERT", "") == "1"


def _sample_rate() -> int:
    try:
        n = int(os.environ.get("KT_EPOCH_ASSERT_SAMPLE", "7"))
    except ValueError:
        n = 7  # malformed override must not kill serving
    return max(1, n)


_lock = threading.Lock()
_sample = _sample_rate()
_hits = 0
_reports: List[str] = []
_fired_keys: set = set()
# (file, line, function) of recent covered mutations, newest last
_recent_mutations: Deque[Tuple[str, int, str]] = deque(maxlen=8)


class StaleVerdict(AssertionError):
    """A cache hit served a verdict the oracle no longer agrees with at
    an UNCHANGED epoch sum — some covered mutation skipped its bump."""


def set_sample(n: int) -> None:
    """Override the sampling rate (tests: 1 = shadow-check every hit)."""
    global _sample
    _sample = max(1, int(n))


def reset() -> None:
    global _hits, _sample
    with _lock:
        _hits = 0
        _reports.clear()
        _fired_keys.clear()
        _recent_mutations.clear()
    _sample = _sample_rate()


def reports() -> List[str]:
    return list(_reports)


def should_check() -> bool:
    """Deterministic counter sampling: True on every Nth cache hit."""
    global _hits
    with _lock:
        _hits += 1
        return _hits % _sample == 0


def note_mutation(depth: int = 2) -> None:
    """Record the call site of a covered verdict-plane mutation
    (devicestate ``_note_thr_col`` calls this when armed; ``depth``
    skips the noting helper so the recorded frame is the mutator)."""
    try:
        frame = sys._getframe(depth)
    except ValueError:
        frame = sys._getframe()
    site = (
        frame.f_code.co_filename,
        frame.f_lineno,
        frame.f_code.co_name,
    )
    with _lock:
        _recent_mutations.append(site)


def _normalize(status) -> Tuple:
    return (status.code, tuple(sorted(status.reasons)))


def check_hit(plugin, pod, key: tuple, esum: int, cached) -> None:
    """Shadow-recompute a sampled cache hit through the uncached oracle
    route and raise :class:`StaleVerdict` on first-observed divergence."""
    fresh = plugin._pre_filter_uncached(pod, emit_events=False)
    from ..plugin.framework import StatusCode

    if fresh.code is StatusCode.ERROR:
        return  # transient oracle error — not coherence evidence
    if _normalize(fresh) == _normalize(cached):
        return
    current = plugin.device_manager.verdict_fingerprint(pod)
    if current != (key, esum):
        # a covered mutation bumped its epoch between the lookup and the
        # recompute: the recompute saw newer state, not a missed bump
        return
    with _lock:
        if key in _fired_keys:
            return  # first observation already reported for this key
        _fired_keys.add(key)
        sites = "\n".join(
            f"    {f}:{ln} in {fn}()" for f, ln, fn in _recent_mutations
        ) or "    <none recorded — mutation predates arming or bypassed _note_thr_col>"
        report = (
            "StaleVerdict: cache hit diverges from the oracle at an "
            "unchanged epoch sum (a verdict-affecting mutation skipped "
            "its bump)\n"
            f"  key={key!r}\n"
            f"  cached esum={esum} current esum={esum} (UNCHANGED)\n"
            f"  cached verdict: code={cached.code} reasons={cached.reasons!r}\n"
            f"  oracle verdict: code={fresh.code} reasons={fresh.reasons!r}\n"
            "  recent covered mutations (the bump that should have "
            "happened belongs at one of these):\n"
            f"{sites}"
        )
        _reports.append(report)
    raise StaleVerdict(report)
