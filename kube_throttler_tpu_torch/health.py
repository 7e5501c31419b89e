"""Per-component health state machine behind ``/readyz``.

kube-scheduler's healthz is a flat 200/500; a degraded throttler is more
nuanced — the device breaker being open is a latency regression, not
unreadiness (the host oracle serves); a reflector stuck in backoff is
stale-but-serving; a journal that skipped corrupt lines recovered lossily.
Operators need those distinctions without grepping logs, and probes need a
single verdict.

Components register a probe returning ``(state, detail)`` where state is
one of ``ok`` / ``degraded`` / ``down``:

- ``ok``       — fully functional;
- ``degraded`` — serving with reduced fidelity/latency (open breaker,
  reflector retrying, lossy journal recovery); /readyz stays 200 so the
  pod is NOT yanked from rotation while it can still answer;
- ``down``     — the component cannot serve (reflector never synced:
  admission verdicts would be fabricated from an empty cache); /readyz
  returns 503.

The aggregate verdict is the worst component state. Probes run at request
time on the serving thread — they must be cheap reads of existing state,
never RPCs.

``snapshot()`` also RECORDS state transitions: each time a component's
probed state differs from its last probed state, ``(component, old, new)``
is appended to a bounded transition log. The log is the scenario hunt's
coverage signal (scenarios/hunt/coverage.py) — a fault schedule that
drives a component through a transition nobody has seen before is, by
definition, new behavior worth keeping — and a cheap debugging timeline
("when did the reflector first degrade?") for everyone else.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

from .utils.lockorder import guard_attrs, make_lock

# probe return: "ok" | ("ok", {...detail}) — detail optional
ProbeResult = Union[str, Tuple[str, dict]]
Probe = Callable[[], ProbeResult]

_SEVERITY = {"ok": 0, "degraded": 1, "down": 2}
STATES = tuple(_SEVERITY)


@guard_attrs
class Health:
    """Registry of component probes + aggregate snapshot."""

    GUARDED_BY = {
        "_probes": "self._lock",
        "_last_states": "self._lock",
        "_transitions": "self._lock",
    }

    # bounded transition log: old entries are dropped FIFO so a flapping
    # component cannot grow the process unboundedly
    MAX_TRANSITIONS = 1000

    def __init__(self) -> None:
        self._lock = make_lock("health")
        self._probes: Dict[str, Probe] = {}
        self._last_states: Dict[str, str] = {}
        self._transitions: List[Tuple[str, str, str]] = []

    def register(self, component: str, probe: Probe) -> None:
        """Register (or replace) a component probe."""
        with self._lock:
            self._probes[component] = probe

    def unregister(self, component: str) -> None:
        with self._lock:
            self._probes.pop(component, None)

    def snapshot(self) -> dict:
        """Run every probe; returns ``{"state": worst, "components":
        {name: {"state": ..., ...detail}}}``. A probe that raises marks its
        component ``down`` (a broken health check is not evidence of
        health) rather than failing the endpoint."""
        with self._lock:
            probes = list(self._probes.items())
        components: Dict[str, dict] = {}
        worst = "ok"
        for name, probe in probes:
            try:
                result = probe()
            except Exception as e:  # noqa: BLE001 — probe bugs must not 500 /readyz
                state, detail = "down", {"error": f"{e.__class__.__name__}: {e}"}
            else:
                if isinstance(result, tuple):
                    state, detail = result
                else:
                    state, detail = result, {}
                if state not in _SEVERITY:
                    state, detail = "down", {"error": f"bad probe state {state!r}"}
            components[name] = {"state": state, **(detail or {})}
            if _SEVERITY[state] > _SEVERITY[worst]:
                worst = state
        with self._lock:
            for name, comp in components.items():
                prev = self._last_states.get(name)
                cur = comp["state"]
                if prev is not None and prev != cur:
                    self._transitions.append((name, prev, cur))
                self._last_states[name] = cur
            if len(self._transitions) > self.MAX_TRANSITIONS:
                del self._transitions[: -self.MAX_TRANSITIONS]
        return {"state": worst, "components": components}

    def transitions(self) -> List[Tuple[str, str, str]]:
        """Observed ``(component, old_state, new_state)`` transitions, in
        observation order. Transitions are only recorded at ``snapshot()``
        time — a consumer that wants a fine-grained timeline samples
        snapshots at its own cadence (the scenario engine samples on the
        replayer's tick)."""
        with self._lock:
            return list(self._transitions)

    def reset_transitions(self) -> None:
        """Drop the transition log and the last-seen states (a new
        measurement epoch: the next snapshot seeds fresh baselines)."""
        with self._lock:
            self._transitions.clear()
            self._last_states.clear()


__all__ = ["Health", "STATES"]
