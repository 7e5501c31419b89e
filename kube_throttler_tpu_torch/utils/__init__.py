"""Small host-side utilities: clocks, keys."""

from .clock import Clock, FakeClock, RealClock  # noqa: F401
