"""Arithmetic the per-layer metric readers share. A reader returns None
when its run holds nothing to read, and the harness leaves the metric
out of the line."""

from __future__ import annotations

from typing import Optional


def mean_ms(rec, phase: str) -> Optional[float]:
    """The program span ``phase``'s mean time in ms."""
    total, count = rec.spans.get(phase, (0.0, 0))
    return total / count * 1e3 if count else None


def idle_pct(rec) -> Optional[float]:
    t = rec.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(rec) -> Optional[float]:
    """The least time of one unit of work over the card's busy time per
    unit, in percent; None without a trace, device time or peaks."""
    t = rec.trace
    if not t or not t["busy_s"] or not rec.calls or rec.least_s_per_unit is None:
        return None
    return 100.0 * rec.least_s_per_unit / (t["busy_s"] / rec.calls)
