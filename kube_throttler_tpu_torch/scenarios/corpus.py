"""The starter scenario corpus (≥6 entries) plus the tier-1 smoke.

Each entry composes arrival × topology × fault schedule into a shape
production control planes actually see, with
per-scenario SLO bounds the slow tier gates on. Scales are chosen so the
full matrix (6 scenarios × 3 seeds, ``make scenario-test``) runs in
minutes on one CPU core while still forcing the behaviors the gates
exist to catch: a full relist mid-churn, one throttle matching half the
pod population, a deployment-sized create burst, a composed bad day.

``smoke`` is the tier-1 determinism scenario: small enough for two
back-to-back runs in the fast tier, still crossing thresholds (flip
samples) and restarting the apiserver (recovery gate).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from .dsl import Arrival, FaultSpec, Scenario, SloGates, Topology, scenario_from_dict

__all__ = [
    "REGRESSIONS_DIR",
    "SCENARIOS",
    "corpus",
    "get_scenario",
    "load_regressions",
]

# hunt-promoted minimal repros (scenarios/hunt/): each JSON file is one
# shrunk, gate-failing program plus its pinned verdict — a PERMANENT tier
# gate replayed by `python -m kube_throttler_tpu_torch.scenarios regressions`
# (wired into `make scenario-test`). Plain data directory, not a package.
REGRESSIONS_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "corpus", "regressions"
)


def _scenarios() -> List[Scenario]:
    return [
        Scenario(
            name="smoke",
            description=(
                "tier-1 determinism smoke: small diurnal churn with one "
                "mid-run apiserver restart (RV reset) — two runs of the same "
                "seed must produce byte-identical traces and identical gate "
                "verdicts"
            ),
            duration_s=2.0,
            arrival=Arrival(kind="diurnal", rate_hz=500.0, trough_frac=0.35, cycles=1.0),
            topology=Topology(pods=600, throttles=48, groups=24, nodes=4),
            faults=(
                FaultSpec(site="scenario.apiserver.restart", mode="restart", t=0.9),
            ),
            # tier-1 bounds are deliberately loose: this scenario proves
            # determinism + pipeline correctness inside a busy test
            # process; the strict flip SLO is the corpus' job (slow tier)
            slo=SloGates(flip_p99_ms=400.0, recovery_s=15.0, min_pace_frac=0.3),
        ),
        Scenario(
            name="diurnal_ramp",
            description=(
                "compressed day/night traffic: sinusoidal arrival between "
                "20% and 100% of peak, two cycles — the baseline 'nothing "
                "broken, load just moves' scenario every other gate is "
                "compared against"
            ),
            duration_s=6.0,
            arrival=Arrival(kind="diurnal", rate_hz=600.0, trough_frac=0.2, cycles=2.0),
            topology=Topology(pods=6000, throttles=300, groups=150, nodes=8),
            slo=SloGates(flip_p99_ms=150.0),
        ),
        Scenario(
            name="relist_storm",
            description=(
                "post-restart relist storm: the apiserver restarts mid-churn "
                "with a fresh RV horizon (410 on every re-watch ⇒ full "
                "paginated relists of the whole object population) and then "
                "expires outstanding continue tokens mid-pagination (410 ⇒ "
                "unpaginated fallback) — the reflector's full relist must "
                "not starve the flip express lane"
            ),
            duration_s=7.0,
            arrival=Arrival(kind="constant", rate_hz=500.0),
            topology=Topology(pods=12000, throttles=360, groups=180, nodes=10),
            faults=(
                FaultSpec(site="scenario.apiserver.restart", mode="restart", t=2.5),
                FaultSpec(
                    site="scenario.apiserver.restart", mode="expire_continues", t=3.1
                ),
            ),
            slo=SloGates(flip_p99_ms=150.0, recovery_s=15.0, min_pace_frac=0.4),
        ),
        Scenario(
            name="rolling_drain",
            description=(
                "rolling node drain: every node's pods deleted in waves and "
                "recreated on replacement nodes while background churn "
                "continues — sustained delete/create pressure with correct "
                "used-sum convergence"
            ),
            duration_s=8.0,
            arrival=Arrival(kind="constant", rate_hz=350.0),
            topology=Topology(pods=4800, throttles=300, groups=150, nodes=12),
            pattern="drain",
            # membership churn (deletes + recreates) keeps the 1-core
            # harness near its knee and the p99 rides co-tenant noise:
            # gate the stable center tightly and BOUND the degradation
            slo=SloGates(flip_p50_ms=250.0, flip_p99_ms=2500.0),
        ),
        Scenario(
            name="thundering_herd",
            description=(
                "thundering-herd deployment: an 1800-pod create wave lands "
                "at 25% of the run over ~2s, is deleted again at 65% — "
                "admission verdicts and flip publication must survive the "
                "step change in every group's used sum"
            ),
            duration_s=8.0,
            arrival=Arrival(kind="constant", rate_hz=350.0),
            topology=Topology(pods=4000, throttles=240, groups=120, nodes=8),
            pattern="herd",
            herd_size=1800,
            # same posture as rolling_drain: the herd window saturates the
            # harness by design — tight p50, bounded p99 degradation
            slo=SloGates(flip_p50_ms=250.0, flip_p99_ms=2500.0),
        ),
        Scenario(
            name="hotkey_throttle",
            description=(
                "hot-key throttle: HALF the pod population shares one label "
                "group matched by a single throttle whose cpu threshold sits "
                "at the group's expected sum — the dominant (N,K) column "
                "flips under churn and its publication must stay inside the "
                "SLO while every event in the cluster touches its key"
            ),
            duration_s=6.0,
            arrival=Arrival(kind="constant", rate_hz=550.0),
            topology=Topology(
                pods=10000, throttles=300, groups=150, hot_frac=0.5, nodes=8
            ),
            slo=SloGates(flip_p99_ms=150.0),
        ),
        Scenario(
            name="bad_day",
            description=(
                "the composed bad day: diurnal churn + an apiserver restart "
                "storm (RV reset) + a status-409 conflict burst while the "
                "backlog drains + watch cuts, then a process-level "
                "kill-the-leader failover episode through the PR 6 ha.* "
                "sites (tools/harness.py + tools/hatest.py)"
            ),
            duration_s=7.0,
            arrival=Arrival(kind="diurnal", rate_hz=700.0, trough_frac=0.3, cycles=1.5),
            topology=Topology(pods=6000, throttles=300, groups=150, nodes=8),
            faults=(
                FaultSpec(site="scenario.apiserver.restart", mode="restart", t=2.0),
                FaultSpec(
                    site="mock.status.conflict", mode="conflict",
                    window=(2.6, 4.2), probability=0.25,
                ),
                FaultSpec(
                    site="mock.watch.cut", mode="close",
                    window=(4.5, 5.0), probability=0.02, times=2,
                ),
            ),
            # 250ms: flips here pay the INJECTED 409-retry storms by
            # design (refresh+retry per conflict); the clean-storm 150ms
            # SLO is relist_storm's and hotkey_throttle's gate
            slo=SloGates(
                flip_p99_ms=250.0, recovery_s=15.0, min_pace_frac=0.4,
                failover_window_s=10.0,
            ),
            leader_kill=True,
        ),
        Scenario(
            name="partition_bad_day",
            description=(
                "the composed bad day replayed through a TCP shard fleet "
                "(transport='tcp' supervisor) with a seeded ASYMMETRIC "
                "network partition mid-storm: one shard's client-side "
                "net.partition window blackholes front→worker sends while "
                "the worker stays healthy, then heals into an epoch-bumped "
                "resync (stale frames fenced), plus one post-heal torn "
                "frame so reconnect runs twice. Trace bytes are IDENTICAL "
                "to bad_day (the net faults live client-side, outside the "
                "trace) — the gates are the deterministic ones: zero wrong "
                "verdicts, zero lost flips, bounded heal→converged "
                "recovery, clean two-phase audits, real fencing evidence. "
                "Driven by scenarios/partition.py — excluded from the "
                "generic replay matrix (like preempt_storm), wired into "
                "`make scenario-test` via its own runner"
            ),
            duration_s=7.0,
            arrival=Arrival(kind="diurnal", rate_hz=700.0, trough_frac=0.3, cycles=1.5),
            topology=Topology(pods=6000, throttles=300, groups=150, nodes=8),
            faults=(
                FaultSpec(
                    site="net.partition", mode="error", window=(3.5, 5.5)
                ),
                FaultSpec(site="net.send.torn_frame", mode="torn", times=1),
            ),
            # no flip SLO: the partition window IS the latency story; the
            # runner gates recovery + the zero-wrong/zero-lost invariants
            slo=SloGates(flip_p99_ms=10_000.0, recovery_s=20.0),
        ),
        Scenario(
            name="rolling_upgrade",
            description=(
                "a live fleet rolled one process at a time under the "
                "composed bad-day storm: a 3-worker TCP shard fleet takes "
                "diurnal churn while tools/upgradetest.py bounces every "
                "worker front-first AND worker-first behind the resync "
                "barrier (ShardSupervisor.rolling_restart), stages version "
                "skew via KT_PROTO_CAPS_MASK (old-caps workers speak the "
                "pickle fallback while new ones speak columnar frames), "
                "SIGKILLs one non-bouncing shard mid-roll, and refuses an "
                "incompatible KT_PROTO_MAJOR cleanly (typed VersionMismatch, "
                "degraded health, paced restarts — no crash loop). Gates: "
                "zero wrong verdicts, zero lost flips, zero orphan "
                "reservations, bounded per-bounce recovery. Driven by "
                "tools/upgradetest.py (`make upgrade-test`) — excluded from "
                "the generic replay matrix (like partition_bad_day): it "
                "needs the live fleet its runner builds"
            ),
            duration_s=7.0,
            arrival=Arrival(kind="diurnal", rate_hz=700.0, trough_frac=0.3, cycles=1.5),
            topology=Topology(pods=6000, throttles=300, groups=150, nodes=8),
            # no flip SLO: bounces ARE the latency story; the runner gates
            # per-bounce recovery + the zero-wrong/zero-lost invariants
            slo=SloGates(flip_p99_ms=10_000.0, recovery_s=20.0),
        ),
        Scenario(
            name="preempt_storm",
            description=(
                "preemption storm: waves of high-priority gangs land on "
                "throttles filled by low-priority running work (some of it "
                "gang-shaped), each wave forcing gang-aware victim "
                "selection, whole-gang eviction, and delete-then-requeue "
                "admission; evicted victims are recreated between waves so "
                "the no-thrash SLO gate (evicted-then-readmitted rate "
                "bounded) has a real churn signal. Driven by "
                "scenarios/preemption.py through a real plugin + scheduler "
                "stack with a preemption-enabled policy — excluded from "
                "the generic replay matrix (like smoke), wired into "
                "`make scenario-test` via its own runner"
            ),
            duration_s=6.0,
            arrival=Arrival(kind="bursts", rate_hz=400.0, burst_s=0.5, idle_s=1.0),
            topology=Topology(
                pods=480, throttles=24, groups=12, nodes=8,
                gang_size=4, priority_levels=4,
            ),
            slo=SloGates(flip_p99_ms=2500.0),
        ),
    ]


def load_regressions() -> List[Dict]:
    """The committed regression corpus, parsed and validated. Each entry:

    - ``scenario`` — the shrunk minimal repro (a full DSL program);
    - ``seed`` — the trace seed it was found and shrunk under;
    - ``expect`` — the pinned verdict: ``"fail:<gate>"`` while the
      underlying bug (or the injected fault class the gate must catch) is
      live — the replay must STILL fail exactly that gate, proving the
      gate still gates this trace; or ``"pass"`` once a real bug is fixed
      — the repro becomes an ordinary always-green regression test.
      Maintainers flip fail→pass in the committed file when they land the
      fix (the lifecycle is documented in docs/scenarios.md);
    - ``provenance`` — how the hunt found it (parent sha, hunt seed,
      iteration, shrink steps, original trace sha).

    A malformed file raises: a promoted repro that silently fails to load
    is a regression gate that silently stopped gating."""
    entries: List[Dict] = []
    if not os.path.isdir(REGRESSIONS_DIR):
        return entries
    for fn in sorted(os.listdir(REGRESSIONS_DIR)):
        if not fn.endswith(".json"):
            continue
        path = os.path.join(REGRESSIONS_DIR, fn)
        with open(path) as f:
            raw = json.load(f)
        expect = raw.get("expect", "pass")
        if expect != "pass" and not expect.startswith("fail:"):
            raise ValueError(f"{path}: bad expect {expect!r}")
        entries.append(
            {
                "path": path,
                "name": os.path.splitext(fn)[0],
                "scenario": scenario_from_dict(raw["scenario"]),
                "seed": int(raw.get("seed", 0)),
                "expect": expect,
                "provenance": raw.get("provenance", {}),
            }
        )
    return entries


def corpus(include_smoke: bool = False) -> List[Scenario]:
    # preempt_storm never rides the generic replay matrix: its gates need
    # the scheduler+preemption stack its dedicated runner builds
    # (scenarios/preemption.py, its own `make scenario-test` line).
    # partition_bad_day likewise: it needs the TCP fleet its runner builds
    # (scenarios/partition.py, its own `make scenario-test` line).
    # rolling_upgrade likewise: it needs the live fleet + process bounces
    # its runner builds (tools/upgradetest.py, `make upgrade-test`)
    out = [
        s for s in _scenarios()
        if s.name not in ("preempt_storm", "partition_bad_day", "rolling_upgrade")
    ]
    return out if include_smoke else [s for s in out if s.name != "smoke"]


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in _scenarios()}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(sorted(SCENARIOS))}"
        )
