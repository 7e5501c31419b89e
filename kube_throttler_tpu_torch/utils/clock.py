"""Injectable clock (the reference threads k8s.io/utils/clock through its
controllers for exactly this reason — deterministic override-boundary tests,
plugin.go:97/109)."""

from __future__ import annotations

import time as _time
from datetime import datetime, timedelta, timezone

from .lockorder import guard_attrs, make_condition, make_lock


class Clock:
    def now(self) -> datetime:  # pragma: no cover — interface
        raise NotImplementedError

    def monotonic(self) -> float:
        """Seconds on a monotonic axis — elapsed-time math (lease renew
        deadlines, staleness windows) must use THIS, never deltas of
        ``now()``: wall-clock NTP steps would stretch or shrink an
        interval measured in ``datetime`` space."""
        raise NotImplementedError  # pragma: no cover — interface

    def subscribe(self, callback) -> None:
        """Register a zero-arg callback fired when the clock jumps (FakeClock
        advance/set). Real time never jumps, so the default is a no-op —
        deadline waiters compute exact timeouts instead of polling."""

    def unsubscribe(self, callback) -> None:
        """Remove a subscribed callback (no-op when absent) so a shut-down
        waiter doesn't stay referenced by a long-lived clock."""


class RealClock(Clock):
    def now(self) -> datetime:
        return datetime.now(timezone.utc)

    def monotonic(self) -> float:
        return _time.monotonic()


@guard_attrs
class FakeClock(Clock):
    """Settable clock for tests; ``advance`` wakes subscribed waiters."""

    GUARDED_BY = {
        "_now": "self._cond",
        "_mono": "self._cond",
        "_listeners": "self._cond",
    }

    def __init__(self, start: datetime):
        self._now = start
        self._mono = 0.0
        self._cond = make_condition(make_lock("utils.fakeclock"))
        self._listeners = []

    def now(self) -> datetime:
        with self._cond:
            return self._now

    def monotonic(self) -> float:
        with self._cond:
            return self._mono

    def subscribe(self, callback) -> None:
        with self._cond:
            self._listeners.append(callback)

    def unsubscribe(self, callback) -> None:
        with self._cond:
            try:
                self._listeners.remove(callback)
            except ValueError:
                pass

    def _notify(self) -> None:
        # listeners run OUTSIDE the clock lock: a listener typically takes
        # its own lock (e.g. the workqueue condition) whose holders call
        # back into now() — calling under the clock lock would be an
        # ABBA deadlock
        with self._cond:
            self._cond.notify_all()
            listeners = list(self._listeners)
        for cb in listeners:
            cb()

    def advance(self, delta: timedelta) -> None:
        """Time passes: wall AND monotonic move together."""
        with self._cond:
            self._now += delta
            self._mono += delta.total_seconds()
        self._notify()

    def set(self, t: datetime) -> None:
        """Wall-clock JUMP (an NTP step): ``now()`` moves, ``monotonic()``
        does not — elapsed-time consumers must be unaffected."""
        with self._cond:
            self._now = t
        self._notify()

    def advance_monotonic(self, seconds: float) -> None:
        """Monotonic-only advance (a frozen wall clock that still ticks
        elapsed time — the inverse skew case)."""
        with self._cond:
            self._mono += float(seconds)
        self._notify()
