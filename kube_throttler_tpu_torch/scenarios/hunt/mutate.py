"""Seeded, pure-function mutations of scenario DSL programs.

``mutate(program, seed)`` is byte-deterministic: the mutation RNG is
keyed by ``(program content sha, seed)`` and nothing else — no wall
clock, no global state — so the same (program, seed) pair produces the
same child on any host, any run. Children are content-addressed
(``hunt-<sha12>`` names derived from the program body with name and
description excluded), which gives the hunt loop exact dedupe for free:
two mutation paths that land on the same program collapse to one corpus
entry, and two mutants whose fault schedules differ only in surface form
collapse because the sha hashes the CANONICAL compiled fault plan
(trace.canonical_fault_plan), not the raw FaultSpec tuple.

Every mutator returns a program inside the hunt tier's validity envelope
(clamped topology/rate/duration bounds, fault sites restricted to the
registered ``MUTABLE_FAULT_SITES`` subset of ``faults.plan.KNOWN_SITES``)
so the trace property holds for every child: ``build_trace(child,
trace_seed)`` is pure, hence same seed ⇒ identical trace bytes — the
precondition that makes coverage comparison and shrinking sound.
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple

from ..dsl import Arrival, FaultSpec, Scenario, Topology, scenario_to_dict
from ..trace import canonical_fault_plan

__all__ = [
    "BOUNDS",
    "MUTABLE_FAULT_SITES",
    "MUTATORS",
    "SHARD_TIER_PREFIXES",
    "mutate",
    "needs_shard_tier",
    "normalize",
    "program_sha",
    "program_size",
]

# site → the modes a mutator may arm there. Every key MUST be a member of
# faults.plan.KNOWN_SITES (pinned by tests/test_hunt.py): an unregistered
# site silently never fires, which would make the mutant a wasted
# evaluation. shard.worker.kill and the reshard.* family only fire in the
# sharded replay tier — a program arming any of them routes through
# scenarios.sharded.run_sharded_program (scenarios/__main__.py), which
# replays the trace against the real multiprocess stack and drives one
# live rescale so the sites are actually reachable end to end.
# scenario.leader.kill is armed via the leader_kill flag, not a FaultSpec.
MUTABLE_FAULT_SITES: Dict[str, Tuple[str, ...]] = {
    "mock.list": ("error", "gone", "delay"),
    "mock.watch.cut": ("close",),
    "mock.watch.gone": ("gone",),
    "mock.status.conflict": ("conflict",),
    "mock.status.error": ("error",),
    "mock.status.delay": ("delay",),
    "mock.lease": ("conflict", "error", "delay"),
    "transport.request": ("error",),
    "transport.put.conflict": ("error",),
    "transport.watch.open": ("error",),
    "transport.watch.read": ("close", "gone", "error", "delay"),
    "ingest.batch.partial": ("error",),
    "scenario.apiserver.restart": ("restart", "expire_continues"),
    "scenario.churn.stall": ("delay",),
    "shard.worker.kill": ("kill",),
    "reshard.handoff.torn": ("torn", "error"),
    "reshard.dest.crash": ("kill", "error"),
    "reshard.fence.race": ("error",),
    "reshard.front.crash": ("error",),
    # the network-fault axis: net.* sites only fire on the TCP transport,
    # so a program arming any of them rides the sharded tier with a
    # transport="tcp" fleet (run_sharded_program arms them client-side)
    "net.connect.refused": ("error",),
    "net.send.torn_frame": ("torn",),
    "net.recv.stall": ("delay",),
    "net.partition": ("error",),
    "net.reconnect.storm": ("error",),
    # the shared-memory event-plane axis: shm.* sites live in the ring
    # transport (sharding/shmring.py) — socketpair fleets with the ring
    # enabled reach them; the sharded tier arms them supervisor-side
    "shm.ring.full": ("delay", "error"),
    "shm.slot.torn_commit": ("torn",),
    "shm.doorbell.lost": ("error",),
    "shm.reader.stall": ("delay",),
    "shm.segment.unlink": ("error",),
}

# the sharded-tier families: a program arming any of these is evaluated
# through the multiprocess replayer, not the single-process engine.
# net.* rides the same tier (the sites live in the TCP framing layer —
# a single-process replay could never reach them); shm.* likewise (the
# ring only exists between a real supervisor and a spawned worker)
SHARD_TIER_PREFIXES = ("shard.", "reshard.", "net.", "shm.")


def needs_shard_tier(scn: Scenario) -> bool:
    return any(f.site.startswith(SHARD_TIER_PREFIXES) for f in scn.faults)

# the hunt tier's validity envelope: wide enough to reach interesting
# regimes (the 1-core composed-stack knee, hot-key dominance, relist
# storms), bounded so one mutant cannot eat the whole wall-clock budget
BOUNDS = {
    "pods": (200, 20_000),
    "throttles": (24, 600),
    "groups": (8, 300),
    "nodes": (2, 16),
    "rate_hz": (100.0, 900.0),
    "duration_s": (1.2, 15.0),
    "max_faults": 6,
    "gang_size": (0, 48),
    "accel_classes": (0, 6),
    "class_threshold_frac": (0.0, 0.8),
    "priority_levels": (0, 10),
}


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def _fault_sort_key(f: FaultSpec):
    return (
        f.site,
        f.mode,
        -1.0 if f.t is None else f.t,
        f.window or (),
        f.probability,
        -1 if f.times is None else f.times,
        f.delay,
    )


def program_sha(scn: Scenario) -> str:
    """Content address of the program BODY: name/description excluded
    (they are derived from this sha), raw faults replaced by the canonical
    compiled plan so surface-form schedule differences collapse."""
    body = scenario_to_dict(scn)
    body.pop("name", None)
    body.pop("description", None)
    body["faults"], _ = canonical_fault_plan(scn)
    blob = json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def program_size(scn: Scenario) -> int:
    """The shrinker's minimality measure, in DSL ops: one per fault entry
    plus one per non-default structural axis (pattern, leader-kill,
    non-constant arrival, hot-key group). Topology/duration magnitude is
    shed by the shrinker but doesn't count as an op — a minimal repro is
    'few program constructs', not 'few pods'."""
    return (
        len(scn.faults)
        + int(scn.pattern != "churn")
        + int(scn.leader_kill)
        + int(scn.arrival.kind != "constant")
        + int(scn.topology.hot_frac > 0)
    )


def normalize(scn: Scenario) -> Scenario:
    """Normal form shared by every mutator output: faults sorted into the
    canonical order (order-only schedule differences collapse — the
    sorted form IS the program, so what dedupes is also what runs),
    bounds clamped, gates made meaningful for whatever the schedule now
    arms (a mutant that inserts a restart gets a recovery bound; one that
    arms leader_kill gets a failover window), and the content-addressed
    ``hunt-<sha12>`` identity stamped last."""
    topo = scn.topology
    topo = replace(
        topo,
        pods=_clamp(topo.pods, *BOUNDS["pods"]),
        throttles=_clamp(topo.throttles, *BOUNDS["throttles"]),
        groups=_clamp(min(topo.groups, max(topo.pods // 8, 8)), *BOUNDS["groups"]),
        nodes=_clamp(topo.nodes, *BOUNDS["nodes"]),
        hot_frac=_clamp(topo.hot_frac, 0.0, 0.5),
        gang_size=_clamp(int(topo.gang_size), *BOUNDS["gang_size"]),
        accel_classes=_clamp(int(topo.accel_classes), *BOUNDS["accel_classes"]),
        class_threshold_frac=round(
            _clamp(float(topo.class_threshold_frac),
                   *BOUNDS["class_threshold_frac"]), 3
        ),
        priority_levels=_clamp(
            int(topo.priority_levels), *BOUNDS["priority_levels"]
        ),
    )
    arrival = replace(
        scn.arrival, rate_hz=_clamp(scn.arrival.rate_hz, *BOUNDS["rate_hz"])
    )
    duration = _clamp(scn.duration_s, *BOUNDS["duration_s"])
    faults = []
    for f in scn.faults[: BOUNDS["max_faults"]]:
        t = None if f.t is None else round(_clamp(f.t, 0.1, duration * 0.9), 3)
        window = f.window
        if window is not None:
            # the end clamp leaves generous overrun slop: virtual time is
            # wall time, a loaded host replays slower than the trace's
            # nominal pacing, and a window that silently closed mid-overrun
            # would make the same program behave differently on a busy box
            w0 = round(_clamp(window[0], 0.0, duration), 3)
            w1 = round(_clamp(window[1], w0 + 0.1, duration + 10.0), 3)
            window = (w0, w1)
        faults.append(replace(f, t=t, window=window))
    faults.sort(key=_fault_sort_key)
    slo = scn.slo
    if slo.recovery_s is None and any(
        f.site == "scenario.apiserver.restart" for f in faults
    ):
        slo = replace(slo, recovery_s=20.0)
    if scn.leader_kill and slo.failover_window_s is None:
        slo = replace(slo, failover_window_s=15.0)
    herd = scn.herd_size if scn.pattern == "herd" else 0
    if scn.pattern == "herd" and herd <= 0:
        herd = max(topo.pods // 4, 50)
    out = replace(
        scn,
        arrival=arrival,
        topology=topo,
        duration_s=duration,
        faults=tuple(faults),
        slo=slo,
        herd_size=herd,
    )
    sha12 = program_sha(out)[:12]
    return replace(
        out,
        name=f"hunt-{sha12}",
        description=f"hunt-generated program {sha12}",
    )


# -- mutators ----------------------------------------------------------------
# Each is (program, rng) → program | None (None = inapplicable here).
# They operate on the RAW program; normalize() runs after every mutation.


def _mut_arrival_kind(scn: Scenario, rng: random.Random):
    kinds = ["constant", "ramp", "diurnal", "bursts"]
    if scn.arrival.kind in kinds:
        kinds.remove(scn.arrival.kind)
    kind = kinds[rng.randrange(len(kinds))]
    return replace(
        scn,
        arrival=replace(
            scn.arrival,
            kind=kind,
            trough_frac=rng.choice([0.1, 0.2, 0.35]),
            cycles=rng.choice([1.0, 2.0, 3.0]),
            burst_s=rng.choice([0.3, 0.5, 1.0]),
            idle_s=rng.choice([0.5, 1.0, 2.0]),
        ),
    )


def _mut_arrival_rate(scn: Scenario, rng: random.Random):
    factor = rng.choice([0.5, 0.75, 1.25, 1.5, 2.0])
    return replace(
        scn, arrival=replace(scn.arrival, rate_hz=scn.arrival.rate_hz * factor)
    )


def _mut_duration(scn: Scenario, rng: random.Random):
    return replace(scn, duration_s=scn.duration_s * rng.choice([0.6, 1.4]))


def _mut_topology_scale(scn: Scenario, rng: random.Random):
    factor = rng.choice([0.5, 2.0])
    topo = scn.topology
    return replace(
        scn,
        topology=replace(
            topo,
            pods=int(topo.pods * factor),
            throttles=int(topo.throttles * (factor if factor < 1 else 1.5)),
            groups=int(topo.groups * (factor if factor < 1 else 1.5)),
        ),
    )


def _mut_topology_hot(scn: Scenario, rng: random.Random):
    choices = [0.0, 0.25, 0.5]
    if scn.topology.hot_frac in choices:
        choices.remove(scn.topology.hot_frac)
    return replace(
        scn,
        topology=replace(scn.topology, hot_frac=rng.choice(choices)),
    )


def _mut_topology_nodes(scn: Scenario, rng: random.Random):
    return replace(
        scn, topology=replace(scn.topology, nodes=rng.choice([2, 4, 8, 12, 16]))
    )


def _mut_topology_gang(scn: Scenario, rng: random.Random):
    """Gang axis: toggle/resize the PodGroup cohorts the initial
    population is stamped with — group-size choices cross the per-group
    pod counts, so mutants cover never-completable and exactly-fitting
    gangs alike."""
    choices = [0, 2, 4, 8, 16, 32]
    if scn.topology.gang_size in choices:
        choices.remove(scn.topology.gang_size)
    return replace(
        scn, topology=replace(scn.topology, gang_size=rng.choice(choices))
    )


def _mut_topology_accel(scn: Scenario, rng: random.Random):
    """Heterogeneity axis: the accel-class mix and the per-class
    threshold skew — class-resolved admission diverges from the base
    inequality once both are on."""
    n = rng.choice([0, 2, 3, 4, 6])
    frac = 0.0 if n == 0 else rng.choice([0.2, 0.4, 0.6, 0.8])
    return replace(
        scn,
        topology=replace(
            scn.topology, accel_classes=n, class_threshold_frac=frac
        ),
    )


def _mut_topology_priority(scn: Scenario, rng: random.Random):
    """Priority-distribution axis (the policy paths): spread the
    population over N priority annotations — level choices cross the
    ordered-lane and victim-ranking code paths with both shallow and deep
    priority ladders."""
    choices = [0, 2, 3, 5, 8]
    if scn.topology.priority_levels in choices:
        choices.remove(scn.topology.priority_levels)
    return replace(
        scn,
        topology=replace(scn.topology, priority_levels=rng.choice(choices)),
    )


def _mut_preempt_shape(scn: Scenario, rng: random.Random):
    """Preemption-toggle axis: arm (or disarm) the preemption-SHAPED
    topology — gangs AND a priority ladder together, the precondition for
    every gang-aware preemption path (a gang axis alone never ranks
    victims; a priority axis alone never forms groups)."""
    if scn.topology.gang_size > 0 and scn.topology.priority_levels > 0:
        return replace(
            scn,
            topology=replace(scn.topology, gang_size=0, priority_levels=0),
        )
    return replace(
        scn,
        topology=replace(
            scn.topology,
            gang_size=rng.choice([2, 4, 8]),
            priority_levels=rng.choice([2, 3, 5]),
        ),
    )


def _mut_pattern(scn: Scenario, rng: random.Random):
    patterns = ["churn", "drain", "herd"]
    if scn.pattern in patterns:
        patterns.remove(scn.pattern)
    pattern = patterns[rng.randrange(len(patterns))]
    herd = max(scn.topology.pods // 4, 50) if pattern == "herd" else 0
    return replace(scn, pattern=pattern, herd_size=herd)


def _mut_mix(scn: Scenario, rng: random.Random):
    # rebalance toward one op class (membership churn vs status churn vs
    # spec churn stress different pipelines)
    boosted = rng.choice(["update", "create", "delete", "spec"])
    mix = []
    for k, w in scn.mix:
        mix.append((k, round(w * (2.5 if k == boosted else 1.0), 4)))
    total = sum(w for _, w in mix) or 1.0
    return replace(scn, mix=tuple((k, round(w / total, 4)) for k, w in mix))


def _mut_leader_kill(scn: Scenario, rng: random.Random):
    return replace(scn, leader_kill=not scn.leader_kill)


def _mut_epoch_churn(scn: Scenario, rng: random.Random):
    """Epoch-churn/cache axis (the interned-verdict cache): push the
    op mix toward throttle-SPEC edits (every edit bumps the covered cols'
    epochs, invalidating cached verdicts) while collapsing the group
    count toward the degenerate-shape regime where the cache serves most
    decisions. Jointly this is the adversarial shape for a stale-verdict
    bug — maximal cache hit traffic under maximal invalidation pressure —
    and the existing zero-wrong-verdicts sweep is the judge (the serving
    plugin replays WITH its cache; the oracle rebuild recomputes)."""
    lo, _hi = BOUNDS["groups"]
    groups = max(lo, scn.topology.groups // rng.choice([4, 8, 16]))
    spec_w = rng.choice([0.25, 0.4, 0.6])
    rest = {k: w for k, w in scn.mix if k != "spec"}
    total = sum(rest.values()) or 1.0
    mix = tuple(
        [(k, round(w / total * (1.0 - spec_w), 4)) for k, w in rest.items()]
        + [("spec", round(spec_w, 4))]
    )
    return replace(scn, topology=replace(scn.topology, groups=groups), mix=mix)


def _draw_fault(scn: Scenario, rng: random.Random) -> FaultSpec:
    # Stratified site draw: the shard-tier axis keeps growing (shard.*,
    # reshard.*, net.*, now shm.*) and a flat draw would crowd out the
    # single-process bug classes a little more with every transport PR
    # — and convert that many more replays to the expensive sharded
    # tier. Pick the tier first (bounded share), then uniform within.
    ordered = sorted(MUTABLE_FAULT_SITES)
    tier = [s for s in ordered if s.startswith(SHARD_TIER_PREFIXES)]
    core = [s for s in ordered if not s.startswith(SHARD_TIER_PREFIXES)]
    pool = tier if (tier and rng.random() < 1.0 / 3.0) else core
    site = pool[rng.randrange(len(pool))]
    mode = rng.choice(MUTABLE_FAULT_SITES[site])
    delay = rng.choice([0.05, 0.1, 0.2, 0.3]) if mode == "delay" else (
        rng.choice([0.0, 0.2]) if site == "scenario.apiserver.restart" else 0.0
    )
    if site in ("scenario.apiserver.restart", "scenario.churn.stall"):
        # one-shot action sites: a single virtual instant
        return FaultSpec(
            site=site,
            mode=mode,
            t=round(rng.uniform(0.3, max(scn.duration_s * 0.8, 0.4)), 2),
            delay=delay,
        )
    t0 = round(rng.uniform(0.2, max(scn.duration_s * 0.7, 0.3)), 2)
    t1 = round(t0 + rng.uniform(0.4, max(scn.duration_s * 0.5, 0.5)), 2)
    return FaultSpec(
        site=site,
        mode=mode,
        window=(t0, t1),
        probability=rng.choice([1.0, 0.5, 0.25, 0.1]),
        times=rng.choice([1, 2, 3, None]),
        delay=delay,
    )


def _mut_fault_insert(scn: Scenario, rng: random.Random):
    if len(scn.faults) >= BOUNDS["max_faults"]:
        return None
    return replace(scn, faults=scn.faults + (_draw_fault(scn, rng),))


def _mut_fault_remove(scn: Scenario, rng: random.Random):
    if not scn.faults:
        return None
    idx = rng.randrange(len(scn.faults))
    return replace(scn, faults=scn.faults[:idx] + scn.faults[idx + 1 :])


def _mut_fault_move(scn: Scenario, rng: random.Random):
    if not scn.faults:
        return None
    idx = rng.randrange(len(scn.faults))
    f = scn.faults[idx]
    shift = rng.uniform(-scn.duration_s * 0.3, scn.duration_s * 0.3)
    if f.t is not None:
        f = replace(f, t=round(f.t + shift, 2))
    elif f.window is not None:
        f = replace(
            f,
            window=(round(f.window[0] + shift, 2), round(f.window[1] + shift, 2)),
        )
    else:
        return None
    faults = list(scn.faults)
    faults[idx] = f
    return replace(scn, faults=tuple(faults))


def _mut_fault_widen(scn: Scenario, rng: random.Random):
    """Escalate one schedule entry: widen its window, raise its firing
    probability, or lift its times cap."""
    candidates = [i for i, f in enumerate(scn.faults) if f.window is not None]
    if not candidates:
        return None
    idx = candidates[rng.randrange(len(candidates))]
    f = scn.faults[idx]
    kind = rng.choice(["window", "probability", "times"])
    if kind == "window":
        w0, w1 = f.window
        span = (w1 - w0) * rng.choice([1.5, 2.0])
        f = replace(f, window=(w0, round(w0 + span, 2)))
    elif kind == "probability":
        f = replace(f, probability=min(1.0, f.probability * 2.0))
    else:
        f = replace(f, times=None if f.times is None else f.times * 2)
    faults = list(scn.faults)
    faults[idx] = f
    return replace(scn, faults=tuple(faults))


MUTATORS: List[Tuple[str, Callable[[Scenario, random.Random], Optional[Scenario]]]] = [
    ("arrival_kind", _mut_arrival_kind),
    ("arrival_rate", _mut_arrival_rate),
    ("duration", _mut_duration),
    ("topology_scale", _mut_topology_scale),
    ("topology_hot", _mut_topology_hot),
    ("topology_nodes", _mut_topology_nodes),
    ("topology_gang", _mut_topology_gang),
    ("topology_accel", _mut_topology_accel),
    ("topology_priority", _mut_topology_priority),
    ("preempt_shape", _mut_preempt_shape),
    ("pattern", _mut_pattern),
    ("mix", _mut_mix),
    ("epoch_churn", _mut_epoch_churn),
    ("leader_kill", _mut_leader_kill),
    ("fault_insert", _mut_fault_insert),
    # fault insertion carries triple weight: faults are the point, and the
    # structural axes above (gang/accel/priority/epoch-churn) would
    # otherwise dilute the draw below the discovery rate the seeded
    # planted-bug search budget assumes
    ("fault_insert2", _mut_fault_insert),
    ("fault_insert3", _mut_fault_insert),
    ("fault_remove", _mut_fault_remove),
    ("fault_move", _mut_fault_move),
    ("fault_widen", _mut_fault_widen),
]


def mutate(program: Scenario, seed: int) -> Scenario:
    """One seeded mutation step: pure in (program content, seed). Draws
    mutators until one applies and actually changes the program (≤8
    attempts — a fixpoint draw sequence returns the normalized program
    itself, which the loop's dedupe then skips)."""
    base_sha = program_sha(program)
    rng = random.Random(f"{base_sha}/{seed}/mutate")
    for _ in range(8):
        _, fn = MUTATORS[rng.randrange(len(MUTATORS))]
        child = fn(program, rng)
        if child is None:
            continue
        child = normalize(child)
        if program_sha(child) != base_sha:
            return child
    return normalize(program)
