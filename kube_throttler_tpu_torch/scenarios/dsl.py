"""The scenario DSL: arrival process × object topology × fault schedule.

A :class:`Scenario` is a pure, declarative value — everything a run needs
is derived deterministically from ``(scenario, seed)``:

- the **arrival process** shapes WHEN workload ops fire (diurnal
  sinusoids, linear ramps, thundering-herd bursts, constant pacing);
- the **object topology** shapes WHAT exists (pod/throttle counts, label
  groups, the hot-key group one throttle matches at scale, nodes for
  drain waves) — built once before the trace starts;
- the **fault schedule** shapes WHAT BREAKS and WHEN, as
  :class:`FaultSpec` entries compiled onto one seeded
  :class:`~kube_throttler_tpu_torch.faults.plan.FaultPlan` (virtual-time
  ``at_times``/``window`` rules — faults/plan.py) shared by the
  mockserver, the transport, and the engine's own ``scenario.*`` action
  sites (apiserver restart, continue-token expiry, churn stalls).

The composition is committed to a replayable trace file
(scenarios/trace.py) before anything runs; the SLO gates
(scenarios/slo.py) judge the replay. Corpus lives in scenarios/corpus.py.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional, Tuple

__all__ = [
    "Arrival",
    "Topology",
    "FaultSpec",
    "SloGates",
    "Scenario",
    "arrival_rate",
    "compile_fault_rules",
    "scenario_to_dict",
    "scenario_from_dict",
]


@dataclass(frozen=True)
class Arrival:
    """Workload op rate over virtual time.

    ``kind``:
    - ``constant`` — ``rate_hz`` throughout;
    - ``ramp`` — linear ``start_frac·rate_hz`` → ``rate_hz`` over the run;
    - ``diurnal`` — sinusoid between ``trough_frac·rate_hz`` and
      ``rate_hz``, ``cycles`` full periods over the run (the compressed
      day/night traffic shape);
    - ``bursts`` — ``rate_hz`` during each ``burst_s`` window, near-idle
      (``trough_frac·rate_hz``) for ``idle_s`` between (thundering herd).
    """

    kind: str = "constant"
    rate_hz: float = 1000.0
    start_frac: float = 0.1
    trough_frac: float = 0.2
    cycles: float = 2.0
    burst_s: float = 0.5
    idle_s: float = 1.0


def arrival_rate(a: Arrival, t: float, duration_s: float) -> float:
    """Instantaneous op rate at virtual time ``t`` (pure; the trace
    builder integrates it into op timestamps)."""
    if a.kind == "constant":
        return a.rate_hz
    if a.kind == "ramp":
        frac = a.start_frac + (1.0 - a.start_frac) * min(1.0, t / max(duration_s, 1e-9))
        return a.rate_hz * frac
    if a.kind == "diurnal":
        # trough at t=0, peak mid-cycle: (1-cos)/2 sweeps 0→1→0 per cycle
        phase = (1.0 - math.cos(2.0 * math.pi * a.cycles * t / max(duration_s, 1e-9))) / 2.0
        return a.rate_hz * (a.trough_frac + (1.0 - a.trough_frac) * phase)
    if a.kind == "bursts":
        period = a.burst_s + a.idle_s
        return a.rate_hz if (t % period) < a.burst_s else a.rate_hz * a.trough_frac
    raise ValueError(f"unknown arrival kind {a.kind!r}")


@dataclass(frozen=True)
class Topology:
    """What exists before the trace starts (built deterministically from
    the seed). ``hot_frac`` > 0 routes that fraction of all pods into one
    ``hot`` label group matched by a single throttle — the hot-key shape
    where one throttle's matched-column set dominates the (N,K) device
    encoding. ``nodes`` spreads pods for the rolling-drain waves.

    Gang / heterogeneity axes (the admission paths, searchable by the
    hunt mutators): ``gang_size`` > 0 stamps the initial population with
    PodGroup annotations — each label group's pods join gangs of that
    size — so replay traffic exercises the gang ledger's member
    bookkeeping; ``accel_classes`` > 0 spreads pods over that many
    ``accel-class`` annotations, and ``class_threshold_frac`` > 0 gives
    the flip-band throttles per-class ``accelClassThresholds`` entries
    (class c's threshold scaled down by up to that fraction), so the
    class-resolved admission inequality diverges from the base one.

    Priority axis (the preemption & policy paths): ``priority_levels``
    > 0 spreads the population over that many ``priority`` annotations
    (0..levels-1), the preemption-shaped distribution the policy layer's
    ordered lanes and victim ranking read. All four default OFF —
    committed traces stay byte-identical."""

    pods: int = 5000
    throttles: int = 300
    groups: int = 150
    hot_frac: float = 0.0
    nodes: int = 8
    gang_size: int = 0
    accel_classes: int = 0
    class_threshold_frac: float = 0.0
    priority_levels: int = 0


@dataclass(frozen=True)
class FaultSpec:
    """One fault-schedule entry, compiled to a FaultPlan rule. ``t`` is a
    single virtual-time instant (``at_times=[t]``); ``window`` a virtual
    interval for probabilistic storms. Engine-action sites (``scenario.*``)
    use ``mode`` to pick the action: ``restart`` (apiserver restart with
    RV-window reset), ``expire_continues`` (continue-token expiry
    mid-pagination), ``delay`` (churn stall)."""

    site: str
    mode: str = "error"
    t: Optional[float] = None
    window: Optional[Tuple[float, float]] = None
    probability: float = 1.0
    times: Optional[int] = None
    delay: float = 0.0


@dataclass(frozen=True)
class SloGates:
    """Per-scenario SLO bounds. A gate with a None bound is not evaluated
    (e.g. recovery on scenarios that never restart the apiserver)."""

    flip_p99_ms: float = 150.0
    # optional p50 gate: the stable center for scenarios whose p99 rides
    # the 1-core harness's co-tenant noise (drain/herd membership churn)
    flip_p50_ms: Optional[float] = None
    min_flip_samples: int = 3  # fewer ⇒ the flip gate FAILS as unmeasurable
    # ingest sustain: the replayer must achieve this fraction of the
    # trace's nominal rate, and the pipeline must apply (not shed) at
    # least this fraction of what reached the apiserver
    min_pace_frac: float = 0.5
    min_applied_frac: float = 0.98
    recovery_s: Optional[float] = None
    max_wrong_verdicts: int = 0
    failover_window_s: Optional[float] = None


@dataclass(frozen=True)
class Scenario:
    """One corpus entry. ``pattern`` shapes the op stream the arrival
    process paces: ``churn`` (update-heavy mix), ``drain`` (rolling
    node-drain waves over background churn), ``herd`` (a deployment-sized
    create burst, later deleted, over background churn). ``leader_kill``
    appends the process-level kill-the-leader episode (tools/harness.py +
    tools/hatest_torch.py, the ha.* machinery) after the in-process
    replay. ``durable`` attaches the durability stack (journal +
    size-triggered snapshots + compaction) to the serving store for the
    run — the long-horizon hunt tier's journal-compaction/snapshot-cycle
    pressure (scenarios/hunt/longhorizon.py)."""

    name: str
    description: str
    duration_s: float = 5.0
    arrival: Arrival = field(default_factory=Arrival)
    topology: Topology = field(default_factory=Topology)
    faults: Tuple[FaultSpec, ...] = ()
    slo: SloGates = field(default_factory=SloGates)
    pattern: str = "churn"
    # churn mix (update / create / delete / throttle-spec weights)
    mix: Tuple[Tuple[str, float], ...] = (
        ("update", 0.88), ("create", 0.05), ("delete", 0.04), ("spec", 0.03),
    )
    herd_size: int = 0
    leader_kill: bool = False
    durable: bool = False

    def mix_weights(self) -> Dict[str, float]:
        return dict(self.mix)


def compile_fault_rules(plan, scn: "Scenario") -> None:
    """Compile the scenario's fault schedule onto ``plan`` (one seeded
    FaultPlan shared by the mockserver, the transport, and the engine's
    scenario.* action sites). ONE implementation — the engine installs
    rules with it, the trace header commits the plan's canonical form
    through it (scenarios/trace.py), and the hunt dedupes mutants by that
    form — so the committed header can never drift from what actually
    runs."""
    for fs in scn.faults:
        plan.rule(
            fs.site,
            mode=fs.mode,
            probability=fs.probability,
            times=fs.times,
            delay=fs.delay,
            at_times=[fs.t] if fs.t is not None else None,
            window=fs.window,
        )
    if scn.leader_kill:
        plan.rule("scenario.leader.kill", mode="kill", times=1)


def scenario_to_dict(scn: "Scenario") -> Dict:
    """JSON-able program form (the hunt's corpus/promotion interchange and
    the ``run --file`` input). Pure dataclass data — round-trips through
    :func:`scenario_from_dict` losslessly."""
    return asdict(scn)


def scenario_from_dict(d: Dict) -> "Scenario":
    """Inverse of :func:`scenario_to_dict` (tuples rebuilt from JSON
    lists). Unknown keys are rejected — a promoted repro written by a
    newer DSL must fail loudly, not silently drop a program axis."""
    d = dict(d)
    arrival = Arrival(**d.pop("arrival", {}))
    topology = Topology(**d.pop("topology", {}))
    slo = SloGates(**d.pop("slo", {}))
    faults = []
    for f in d.pop("faults", ()) or ():
        f = dict(f)
        if f.get("window") is not None:
            f["window"] = (float(f["window"][0]), float(f["window"][1]))
        faults.append(FaultSpec(**f))
    mix = tuple((str(k), float(w)) for k, w in d.pop("mix", ()) or ())
    kwargs = dict(
        d,
        arrival=arrival,
        topology=topology,
        slo=slo,
        faults=tuple(faults),
    )
    if mix:
        kwargs["mix"] = mix
    return Scenario(**kwargs)
