"""The long-horizon hunt tier: multi-virtual-day soak programs.

The budgeted random hunt explores breadth; this tier buys depth — the
failure classes that only appear when a cluster has been up for days:

- **compressed virtual days** — diurnal arrival with one sinusoid cycle
  per "day", several days per run, so day/night load swings (and the
  adaptive batcher's grow/shrink cycles) repeat many times;
- **reservation-TTL expiry waves** — recurring herd waves: a
  deployment-sized create burst lands near each day's peak and is torn
  down into the trough, so every group's used sum and pod count steps up
  and decays like a TTL expiry front;
- **journal compaction + snapshot cycles** — ``durable=True`` attaches
  the durability stack (journal, size-triggered snapshots, compaction) to the
  serving store, with the trigger cadence scaled so a run cuts several
  snapshots and crosses compaction at least once UNDER storm load;
- **rolling restarts** — a restart + watch-cut pair per virtual day
  (the control-plane rolling-restart shape; the sharded tier's
  ``shard.worker.kill`` is its process-level analog, armed when these
  programs replay through scenarios/sharded.py);
- **the 1M-pod columnar-arena rung** — the million-pod scale on the hunt's
  full stack. ~4 GB RSS and minutes of build time: nightly-soak
  material, never CI (``--mega-pods`` scales it down to smoke the
  mechanics).

``make scenario-hunt-long`` evaluates every tier program under the same
gates + fingerprinting as the hunt loop (findings shrink and promote the
same way), then mutates FROM them for whatever budget remains.
"""

from __future__ import annotations

from typing import List

from ..dsl import Arrival, FaultSpec, Scenario, SloGates, Topology

__all__ = ["MEGA_PODS_DEFAULT", "long_horizon_programs"]

MEGA_PODS_DEFAULT = 1_000_000


def long_horizon_programs(
    days: int = 3,
    day_s: float = 12.0,
    mega_pods: int = MEGA_PODS_DEFAULT,
    include_mega: bool = True,
) -> List[Scenario]:
    """The tier's program list. ``days`` compressed virtual days of
    ``day_s`` real seconds each (defaults: a 36 s replay standing in for
    a 3-day soak). NOTE: these are built RAW (no hunt-tier bound
    clamping) — the whole point of the mega rung is to exceed the search
    tier's envelope."""
    duration = days * day_s
    # one restart + one watch-cut storm per day, offset into each day so
    # the restart lands on the climb and the cuts ride the peak
    rolling: List[FaultSpec] = []
    for d in range(days):
        t_day = d * day_s
        rolling.append(
            FaultSpec(
                site="scenario.apiserver.restart", mode="restart",
                t=round(t_day + 0.35 * day_s, 2),
            )
        )
        rolling.append(
            FaultSpec(
                site="mock.watch.cut", mode="close",
                window=(round(t_day + 0.5 * day_s, 2), round(t_day + 0.7 * day_s, 2)),
                probability=0.05, times=2,
            )
        )
    programs = [
        Scenario(
            name="long_diurnal_days",
            description=(
                f"{days} compressed virtual days: diurnal churn with a "
                "TTL-expiry-shaped herd wave per day (create burst at the "
                "peak, torn down into the trough), journal compaction + "
                "snapshot cycles under load (durable), and a rolling "
                "restart + watch-cut pair per day"
            ),
            duration_s=duration,
            arrival=Arrival(
                kind="diurnal", rate_hz=450.0, trough_frac=0.15, cycles=float(days)
            ),
            topology=Topology(pods=5000, throttles=300, groups=150, nodes=10),
            pattern="herd",
            herd_size=1200,
            faults=tuple(rolling),
            durable=True,
            slo=SloGates(
                flip_p50_ms=250.0, flip_p99_ms=2500.0, recovery_s=20.0,
                min_pace_frac=0.4,
            ),
        ),
        Scenario(
            name="long_compaction_churn",
            description=(
                "sustained high-churn with the durability stack attached: "
                "several snapshot cuts and at least one journal compaction "
                "must land under storm load without touching a verdict"
            ),
            duration_s=duration * 0.6,
            arrival=Arrival(kind="constant", rate_hz=600.0),
            topology=Topology(pods=8000, throttles=360, groups=180, nodes=8),
            # delete/create-heavy mix: compaction pressure comes from
            # membership churn, not status echoes
            mix=(
                ("update", 0.70), ("create", 0.14), ("delete", 0.13), ("spec", 0.03),
            ),
            durable=True,
            slo=SloGates(flip_p99_ms=250.0),
        ),
    ]
    if include_mega:
        programs.append(
            Scenario(
                name="long_mega_arena",
                description=(
                    f"the {mega_pods:,}-pod columnar-arena rung: million-pod scale "
                    "through the whole remote stack — reflector relists, "
                    "micro-batched ingest, sparse selector index, device "
                    "planes — at a drizzle rate (the build IS the test; the "
                    "gates prove verdicts stay exact at population scale)"
                ),
                duration_s=30.0,
                arrival=Arrival(kind="constant", rate_hz=300.0),
                topology=Topology(
                    pods=mega_pods,
                    throttles=max(mega_pods // 10, 100),
                    groups=max(mega_pods // 200, 50),
                    nodes=16,
                ),
                slo=SloGates(
                    flip_p99_ms=2500.0, flip_p50_ms=500.0, min_pace_frac=0.2
                ),
            )
        )
    return programs
