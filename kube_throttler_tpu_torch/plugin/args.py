"""Plugin argument decoding (reference plugin_args.go:29-60).

Same field names (including the ``kubeconfig`` JSON key whose Go field is the
``KubeConifg`` typo — SURVEY §2.3 quirk 5), same defaults and validation:
``name`` and ``targetSchedulerName`` required; interval defaults to 15s;
threadiness defaults to CPU count.

``reconcileTemporaryThresholdInterval`` is decoded-but-unused in the
reference (plugin_args.go:53-55 → plugin.go:93,104 → dropped; override
wakeups are event-driven via NextOverrideHappensIn). Here it IS honored: the
plugin passes it to both controllers as ``resync_interval``, the periodic
enqueue-all backstop (controllers/base.py ``_resync``) that replaces the
reference's 5-minute informer resync. Note the cadence tradeoff: the 15s
default re-enqueues every responsible key 20× more often than the
reference's 5-minute resync — cheap here because the workqueue dedups and
the batched reconcile pays one device aggregate per drain, but deployments
with very large throttle counts that don't need fast staleness repair can
raise it (e.g. ``"5m"``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Mapping, Optional

DEFAULT_RECONCILE_TEMPORARY_THRESHOLD_INTERVAL = timedelta(seconds=15)


@dataclass(frozen=True)
class KubeThrottlerPluginArgs:
    name: str
    target_scheduler_name: str
    kubeconfig: str = ""
    reconcile_temporary_threshold_interval: timedelta = (
        DEFAULT_RECONCILE_TEMPORARY_THRESHOLD_INTERVAL
    )
    controller_threadiness: int = 0
    num_key_mutex: int = 0
    # optional expiry for scheduler-cycle reservations (None = the
    # reference's reserve-until-observed lifetime): a scheduler that dies
    # between Reserve and Bind must not pin capacity forever, and crash
    # recovery rebases the remaining budget on restore
    # (engine/reservations.py)
    reservation_ttl: Optional[timedelta] = None
    # expiry for GANG group reserves (engine/gang.py): a half-bound gang
    # whose scheduler died must free ALL ranks' capacity together. None
    # falls back to reservation_ttl (and to reserve-until-observed when
    # that is None too)
    gang_reservation_ttl: Optional[timedelta] = None
    # policy-as-data (policy/spec.py, docs/policy.md): the ``policies``
    # config key — a list of PolicySpec dicts with RFC3339 activation
    # windows (first active wins, the temporaryThresholdOverrides
    # discipline). Empty ⇒ the built-in default: weights 1.0, preemption
    # off. Hot-swappable at runtime via plugin.set_policy_specs.
    policy_specs: tuple = ()


def decode_plugin_args(config: Mapping[str, Any]) -> KubeThrottlerPluginArgs:
    name = str(config.get("name", "") or "")
    if not name:
        raise ValueError("Name must not be empty")
    target = str(config.get("targetSchedulerName", "") or "")
    if not target:
        raise ValueError("TargetSchedulerName must not be empty")

    raw_interval = config.get("reconcileTemporaryThresholdInterval", 0)
    if isinstance(raw_interval, str) and raw_interval:
        # Go duration strings: "15s", "1m30s", "500ms" (strict grammar)
        interval = _parse_go_duration(raw_interval)
    elif isinstance(raw_interval, (int, float)) and raw_interval:
        interval = timedelta(seconds=float(raw_interval))
    else:
        interval = timedelta(0)
    if interval < timedelta(0):
        # a negative interval would turn the resync backstop into a hot loop
        # (workqueue.add_after fires immediately for secs <= 0)
        raise ValueError(
            "reconcileTemporaryThresholdInterval must not be negative: "
            f"{raw_interval!r}"
        )
    if interval == timedelta(0):
        interval = DEFAULT_RECONCILE_TEMPORARY_THRESHOLD_INTERVAL

    threadiness = int(config.get("controllerThrediness", 0) or 0)
    if threadiness == 0:
        threadiness = os.cpu_count() or 1

    raw_ttl = config.get("reservationTTL", 0)
    if isinstance(raw_ttl, str) and raw_ttl:
        reservation_ttl = _parse_go_duration(raw_ttl)
    elif isinstance(raw_ttl, (int, float)) and raw_ttl:
        reservation_ttl = timedelta(seconds=float(raw_ttl))
    else:
        reservation_ttl = None
    if reservation_ttl is not None and reservation_ttl <= timedelta(0):
        # zero/negative would expire every reservation at birth — the
        # admission inequality's `reserved` term silently vanishes
        raise ValueError(f"reservationTTL must be positive: {raw_ttl!r}")

    raw_gang_ttl = config.get("gangReservationTTL", 0)
    if isinstance(raw_gang_ttl, str) and raw_gang_ttl:
        gang_ttl = _parse_go_duration(raw_gang_ttl)
    elif isinstance(raw_gang_ttl, (int, float)) and raw_gang_ttl:
        gang_ttl = timedelta(seconds=float(raw_gang_ttl))
    else:
        gang_ttl = None
    if gang_ttl is not None and gang_ttl <= timedelta(0):
        raise ValueError(f"gangReservationTTL must be positive: {raw_gang_ttl!r}")

    from ..policy.spec import policy_specs_from_config

    return KubeThrottlerPluginArgs(
        name=name,
        target_scheduler_name=target,
        kubeconfig=str(config.get("kubeconfig", "") or ""),
        reconcile_temporary_threshold_interval=interval,
        controller_threadiness=threadiness,
        num_key_mutex=int(config.get("numKeyMutex", 0) or 0) or 128,
        reservation_ttl=reservation_ttl,
        gang_reservation_ttl=gang_ttl,
        policy_specs=policy_specs_from_config(config.get("policies")),
    )


_GO_DURATION_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,  # U+00B5 micro sign
    "μs": 1e-6,  # U+03BC greek mu
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}

_GO_DURATION_TOKEN = None  # compiled lazily below


def _parse_go_duration(s: str) -> timedelta:
    """Strict Go ``time.ParseDuration`` grammar (reference validates args via
    it, plugin_args.go:177-195): optional sign, then one or more
    ``<decimal><unit>`` tokens consuming the WHOLE string. Trailing garbage
    ("15sgarbage"), missing units ("15"), and empty input all raise — config
    typos must fail loudly, not silently truncate.
    """
    import re

    global _GO_DURATION_TOKEN
    if _GO_DURATION_TOKEN is None:
        units = "|".join(sorted(_GO_DURATION_UNITS, key=len, reverse=True))
        _GO_DURATION_TOKEN = re.compile(
            r"(\d+(?:\.\d*)?|\.\d+)(" + units + r")"
        )

    orig, sign = s, 1.0
    if s[:1] in ("+", "-"):
        sign = -1.0 if s[0] == "-" else 1.0
        s = s[1:]
    if s == "0":  # Go's special case: bare zero needs no unit
        return timedelta(0)
    if not s:
        raise ValueError(f"invalid duration: {orig!r}")
    total, pos = 0.0, 0
    while pos < len(s):
        m = _GO_DURATION_TOKEN.match(s, pos)
        if m is None:
            raise ValueError(f"invalid duration: {orig!r}")
        total += float(m.group(1)) * _GO_DURATION_UNITS[m.group(2)]
        pos = m.end()
    return timedelta(seconds=sign * total)
