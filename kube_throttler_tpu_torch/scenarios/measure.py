"""Shared measurement anchors for the scenario engine and the benches.

These were born in the JAX package's bench serving rungs (``bench.py``,
which imports that package's copy under its historical underscore names)
so the scenario corpus and the bench ladder measure flip lag with ONE
implementation — a per-scenario flip-p99 that silently anchored
differently from the bench's would make the SLO gate incomparable with
every BENCH_*.json on record. A bench of this port imports these.
"""

from __future__ import annotations

from ..utils.lockorder import make_lock


def lag_tracker():
    """(pending, flip_pending, lock, lags, flip_lags, flip_walls,
    handler): handler pops a key's oldest pending timestamp on its
    MODIFIED event and records the lag sample — into ``lags`` always
    (total lag), and ALSO into ``flip_lags`` when the write changed the
    throttled flags or the calculated threshold (a FLIP: the only status
    change that alters admission verdicts); ``flip_walls[i]`` is flip
    sample i's publication wall time (perf_counter), which lets the
    scenario engine partition flips into steady-state vs outage-affected
    (a crossing stamped while the apiserver is restarting cannot publish
    before the relist closes the loop — the recovery gate owns that
    window, the flip gate owns steady state). The flip/total split is the
    bench-side mirror of the daemon's
    kube_throttler_status_flip_lag_seconds histograms.

    The two samples anchor to DIFFERENT events, deliberately:

    - total lag anchors to the key's OLDEST unpublished event (the
      staleness window — coalescing must not shrink it);
    - flip lag anchors to the LATEST crossing event (``flip_pending``,
      stamped by the churn generator when a group's running cpu sum
      actually crosses a throttle's threshold — see ``flip_watch_of``).
      A value-only refresh queued 2 s ago does not make the *flag* wrong;
      the flag is only wrong from the crossing onward, so pairing a flip
      write with the oldest refresh event would overstate flip lag by the
      whole refresh backlog. Latest-crossing (overwrite, not setdefault)
      handles cross-back sequences: after cross→cross-back→cross, the
      published flag is newly wrong from the LAST crossing, and anchoring
      the first would blame the daemon for the interval the flag was
      accidentally right. The stamp is popped only by a flip write —
      clearing it on value-only writes would race a write computed from
      pre-crossing aggregates landing just after the stamp. When no
      crossing is pending for a flipping key (e.g. a calculatedThreshold
      change), the sample falls back to the oldest-pending anchor
      (conservative: overstates, never understates)."""
    import time as _time

    from ..engine.store import EventType

    pending: dict = {}
    flip_pending: dict = {}
    lock = make_lock("scenarios.lagtracker")
    lags: list = []
    flip_lags: list = []
    flip_walls: list = []

    def on_write(event):
        if event.type != EventType.MODIFIED:
            return
        now = _time.perf_counter()
        key = event.obj.key
        old = event.old_obj
        flipped = old is not None and (
            old.status.throttled != event.obj.status.throttled
            or old.status.calculated_threshold.threshold
            != event.obj.status.calculated_threshold.threshold
        )
        with lock:
            t0 = pending.pop(key, None)
            tf = flip_pending.pop(key, None) if flipped else None
        if flipped:
            anchor = tf if tf is not None else t0
            if anchor is not None:
                flip_lags.append(now - anchor)
                flip_walls.append(now)
        if t0 is not None:
            lags.append(now - t0)

    return pending, flip_pending, lock, lags, flip_lags, flip_walls, on_write


def flip_watch_of(store):
    """(flip_watch, run_sums) for crossing-anchored flip-lag measurement:
    ``flip_watch`` maps group → [(throttle key, cpu threshold milli)] for
    every throttle with a cpu-requests threshold; ``run_sums`` seeds each
    group's running cpu sum (milli) from the stored pods — the same values
    the churn generator seeds its per-pod ``prev`` from, so the
    incremental sums track the daemon's ``status.used`` exactly."""
    from ..resourcelist import pod_request_resource_list

    flip_watch: dict = {}
    for thr in store.list_throttles():
        cpu = (thr.spec.threshold.resource_requests or {}).get("cpu")
        if cpu is None:
            continue
        g = thr.spec.selector.selector_terms[0].pod_selector.match_labels["grp"]
        flip_watch.setdefault(g, []).append((thr.key, int(cpu * 1000)))
    run_sums: dict = {}
    for pod in store.list_pods():
        g = pod.labels.get("grp")
        if g is None:
            continue
        cpu = pod_request_resource_list(pod).get("cpu")
        run_sums[g] = run_sums.get(g, 0) + (int(cpu * 1000) if cpu else 0)
    return flip_watch, run_sums


def count_watch_of(store):
    """(count_watch, run_counts) — the pod-COUNT analog of
    :func:`flip_watch_of`: ``count_watch`` maps group → [(throttle key,
    pod-count threshold)] for throttles with a FINITE count threshold
    (the 10^6 open-class sentinel is ignored until spec churn lowers it);
    ``run_counts`` seeds each group's live pod count. Creates/deletes
    crossing a count threshold are flips exactly like cpu-sum crossings —
    without this watch the drain/herd scenarios' count flips anchored to
    the oldest refresh and reported backlog age as flip lag."""
    watch: dict = {}
    for thr in store.list_throttles():
        cnt = thr.spec.threshold.resource_counts
        if cnt is None or cnt >= 10**5:
            continue
        g = thr.spec.selector.selector_terms[0].pod_selector.match_labels["grp"]
        watch.setdefault(g, []).append((thr.key, int(cnt)))
    counts: dict = {}
    for pod in store.list_pods():
        g = pod.labels.get("grp")
        if g is not None:
            counts[g] = counts.get(g, 0) + 1
    return watch, counts


def group_keys_of(store):
    """group label value → [throttle keys] (the pending-registration map
    the lag tracker pairs events with)."""
    group_keys: dict = {}
    for thr in store.list_throttles():
        g = thr.spec.selector.selector_terms[0].pod_selector.match_labels["grp"]
        group_keys.setdefault(g, []).append(thr.key)
    return group_keys


def served_throttle(i: int, groups: int, flip_band_mc: int = 0):
    """Throttle i selecting pod group g{i%groups}; threshold class varies so
    probe verdicts mix (open / tight cpu / pod-count).

    ``flip_band_mc`` > 0 carves a FLIP BAND out of the tight-cpu class:
    every 24th throttle's cpu threshold sits AT the expected group cpu sum
    (P/groups × the 400m churn mean), so the paced churn's random walk
    around that sum produces real throttled↔not-throttled crossings — the
    events the flip-lag percentiles measure. Without the band, a scale
    mismatch leaves every cpu threshold far from the live sum (at 100k×10k
    the group sum ~80 cpu dwarfs the 2-14 cpu class) and a whole window
    can pass with zero flips, making flip_lag_p99 unmeasurable."""
    from ..api.types import (
        LabelSelector,
        ResourceAmount,
        Throttle,
        ThrottleSelector,
        ThrottleSelectorTerm,
        ThrottleSpec,
    )

    if flip_band_mc and i % 24 == 1:
        threshold = ResourceAmount.of(requests={"cpu": f"{flip_band_mc}m"})
    elif i % 3 == 0:
        threshold = ResourceAmount.of(pod=10**6, requests={"cpu": "100000"})
    elif i % 3 == 1:
        threshold = ResourceAmount.of(requests={"cpu": f"{(i % 7 + 1) * 2}"})
    else:
        threshold = ResourceAmount.of(pod=(i % 50) + 5)
    return Throttle(
        name=f"t{i}",
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=threshold,
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(
                        LabelSelector(match_labels={"grp": f"g{i % groups}"})
                    ),
                )
            ),
        ),
    )


def flip_band_mc(P: int, groups: int) -> int:
    """Expected group cpu sum in milli: P/groups pods × the 400m mean of
    the churn generator's rng.randrange(1, 8) * 100 distribution."""
    return round(P / groups * 400)
