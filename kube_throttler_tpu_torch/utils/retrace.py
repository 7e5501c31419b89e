"""Runtime retrace budget: no XLA recompiles after warmup.

The static ``retrace`` checker (analysis/retrace.py) pins the shape
discipline at call sites it can see; this module counts what the
compiler *actually did*. Every jit entry in ``ops/``/``parallel/``
registers itself (``register_all(globals(), __name__)`` at module
bottom); the per-entry compile-cache size (``PjitFunction._cache_size``)
is a monotone count of distinct compiled programs.

Arming: ``KT_JIT_RETRACE_BUDGET=<n>`` — after ``KT_JIT_RETRACE_WARMUP``
ticks (default 3; the padding ladders legitimately compile a handful of
rungs while capacities settle), a tick during which the total compile
count across entries grows by more than ``n`` (cumulatively since
warmup) raises :class:`RetraceBudgetExceeded` naming each entry with
its compile delta. ``n=0`` is the steady-state contract: one padded
dispatch per tick, zero recompiles. Unset disables (production default
— the check belongs to tests, soaks, and the bench's warm sections).

``DeviceStateManager.aggregate_used_for`` calls :func:`on_tick` once
per drain — the tick boundary the budget is defined over. Tests and the
bench can call :func:`snapshot`/:func:`on_tick` directly.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "RetraceBudgetExceeded",
    "register",
    "register_all",
    "registered",
    "cache_sizes",
    "budget",
    "warmup_ticks",
    "on_tick",
    "reset",
    "snapshot",
]


class RetraceBudgetExceeded(RuntimeError):
    """A tick recompiled a jit entry after warmup (budget exhausted)."""


_mu = threading.Lock()
_registry: Dict[str, object] = {}
_tick = 0
_baseline: Optional[Dict[str, int]] = None


def register(name: str, fn) -> object:
    """Track one jit entry. Returns ``fn`` so it can wrap a def site."""
    if hasattr(fn, "_cache_size"):
        with _mu:
            _registry[name] = fn
    return fn


def register_all(namespace: Dict[str, object], modname: str) -> int:
    """Register every jit entry in a module's globals (call at module
    bottom: ``register_all(globals(), __name__)``). Returns the count."""
    short = modname.rsplit(__name__.split(".", 1)[0] + ".", 1)[-1]
    n = 0
    for attr, obj in list(namespace.items()):
        if attr.startswith("_"):
            continue
        if hasattr(obj, "_cache_size") and callable(obj):
            register(f"{short}.{attr}", obj)
            n += 1
    return n


def registered() -> Tuple[str, ...]:
    with _mu:
        return tuple(sorted(_registry))


def cache_sizes() -> Dict[str, int]:
    """Entry -> count of distinct compiled programs, right now."""
    out: Dict[str, int] = {}
    with _mu:
        items = list(_registry.items())
    for name, fn in items:
        try:
            out[name] = int(fn._cache_size())
        except Exception:  # pragma: no cover - backend-dependent internals
            continue
    return out


def budget() -> Optional[int]:
    raw = os.environ.get("KT_JIT_RETRACE_BUDGET", "")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None  # malformed override must not arm OR crash (envguard)


def warmup_ticks() -> int:
    try:
        return int(os.environ.get("KT_JIT_RETRACE_WARMUP", "3"))
    except ValueError:
        return 3


def reset() -> None:
    global _tick, _baseline
    with _mu:
        _tick = 0
        _baseline = None


def snapshot() -> Dict[str, int]:
    """Pin the current per-entry compile counts as the warm baseline
    (what ``on_tick`` does automatically at the end of warmup)."""
    global _baseline
    sizes = cache_sizes()
    with _mu:
        _baseline = dict(sizes)
    return sizes


def on_tick() -> None:
    """Advance the tick counter; after warmup, fail the tick if compile
    counts grew past the budget since the warm baseline."""
    global _tick, _baseline
    b = budget()
    if b is None:
        return
    with _mu:
        _tick += 1
        tick = _tick
        baseline = _baseline
    warm = warmup_ticks()
    if tick <= warm or baseline is None:
        if tick >= warm or baseline is None:
            snapshot()
        return
    sizes = cache_sizes()
    grew: List[str] = []
    total_delta = 0
    for name, n in sizes.items():
        d = n - baseline.get(name, 0)
        if d > 0:
            grew.append(f"{name}: +{d} (now {n})")
            total_delta += d
    if total_delta > b:
        raise RetraceBudgetExceeded(
            f"tick {tick} recompiled after warmup ({warm} ticks, budget "
            f"{b}): {'; '.join(grew)} — a shape/static-arg leaked past the "
            "padding ladder (see analysis/retrace.py and "
            "docs/STATIC_ANALYSIS.md gen-3)"
        )
