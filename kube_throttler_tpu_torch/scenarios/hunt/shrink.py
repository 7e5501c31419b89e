"""Shrink a gate-failing scenario program to a minimal repro.

Classic delta-debugging, made *sound* by the trace determinism property:
``build_trace(program, seed)`` is pure and every candidate re-replays in
a FRESH interpreter (the hunt's evaluator), so "the candidate still fails
the same gate" is a statement about the program, not about scheduler
noise in a polluted process. The transform ladder sheds structure in
order of explanatory weight:

1. **faults** — drop schedule entries one at a time (the usual culprit
   is one entry; everything else is camouflage);
2. **flags** — strip the leader-kill episode, collapse drain/herd
   patterns to plain churn, drop the hot-key group;
3. **arrival** — flatten the arrival process to constant at the same
   nominal rate;
4. **scale** — halve topology mass (pods/throttles/groups) toward the
   tier floors;
5. **duration** — halve the run length.

A candidate is accepted iff its re-replay still fails at least one of
the ORIGINAL failing gates; accepted candidates restart the ladder
(greedy fixpoint) until nothing reduces or the attempt budget runs out.
The result carries the accepted-step history — the repro's provenance
trail committed alongside it at promotion.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..dsl import Arrival, Scenario
from .mutate import normalize, program_sha, program_size

__all__ = ["failed_gates_of", "shrink"]

DEFAULT_STAGES: Tuple[str, ...] = ("faults", "flags", "arrival", "scale", "duration")

# Evaluator contract: (program, trace_seed) → report dict | None.
# None (crashed / no report) is treated as "does not reproduce" — a
# shrink step may never be accepted on missing evidence.
Evaluator = Callable[[Scenario, int], Optional[Dict]]


def failed_gates_of(report: Optional[Dict]) -> List[str]:
    if not report:
        return []
    return sorted(
        name for name, g in (report.get("gates") or {}).items() if not g.get("pass")
    )


def _candidates(scn: Scenario, stage: str) -> List[Tuple[str, Scenario]]:
    """Deterministically-ordered transform candidates for one stage."""
    out: List[Tuple[str, Scenario]] = []
    if stage == "faults":
        for i in range(len(scn.faults)):
            out.append(
                (
                    f"drop_fault[{scn.faults[i].site}]",
                    replace(scn, faults=scn.faults[:i] + scn.faults[i + 1 :]),
                )
            )
    elif stage == "flags":
        if scn.leader_kill:
            out.append(("drop_leader_kill", replace(scn, leader_kill=False)))
        if scn.pattern != "churn":
            out.append(
                ("pattern_to_churn", replace(scn, pattern="churn", herd_size=0))
            )
        if scn.topology.hot_frac > 0:
            out.append(
                (
                    "drop_hot_group",
                    replace(scn, topology=replace(scn.topology, hot_frac=0.0)),
                )
            )
    elif stage == "arrival":
        if scn.arrival.kind != "constant":
            out.append(
                (
                    "arrival_to_constant",
                    replace(scn, arrival=Arrival(rate_hz=scn.arrival.rate_hz)),
                )
            )
    elif stage == "scale":
        topo = scn.topology
        if topo.pods > 400:
            out.append(
                (
                    "halve_pods",
                    replace(
                        scn,
                        topology=replace(
                            topo,
                            pods=max(topo.pods // 2, 200),
                            groups=max(min(topo.groups, topo.pods // 16), 8),
                        ),
                    ),
                )
            )
        if topo.throttles > 48:
            out.append(
                (
                    "halve_throttles",
                    replace(
                        scn,
                        topology=replace(topo, throttles=max(topo.throttles // 2, 24)),
                    ),
                )
            )
    elif stage == "duration":
        if scn.duration_s > 2.4:
            out.append(("halve_duration", replace(scn, duration_s=scn.duration_s / 2)))
    return out


def shrink(
    program: Scenario,
    seed: int,
    evaluate: Evaluator,
    target_gates: Sequence[str],
    stages: Sequence[str] = DEFAULT_STAGES,
    max_attempts: int = 24,
) -> Dict:
    """Greedy fixpoint shrink of ``program`` under ``evaluate``.

    ``target_gates`` are the gates the original run failed; a candidate
    survives iff its fresh re-replay fails at least one of them. Returns
    ``{"program", "seed", "steps", "attempts", "size", "failed_gates",
    "history"}`` where ``history`` lists every accepted transform."""
    target = set(target_gates)
    if not target:
        raise ValueError("shrink needs the failing gate set (nothing to preserve)")
    current = normalize(program)
    attempts = 0
    steps = 0
    history: List[Dict] = []
    last_failed = sorted(target)
    progress = True
    while progress and attempts < max_attempts:
        progress = False
        for stage in stages:
            if attempts >= max_attempts:
                break
            for label, candidate in _candidates(current, stage):
                if attempts >= max_attempts:
                    break
                candidate = normalize(candidate)
                if program_sha(candidate) == program_sha(current):
                    continue
                attempts += 1
                report = evaluate(candidate, seed)
                failed = failed_gates_of(report)
                if target & set(failed):
                    steps += 1
                    history.append(
                        {
                            "transform": label,
                            "size": program_size(candidate),
                            "failed_gates": failed,
                        }
                    )
                    current = candidate
                    last_failed = failed
                    progress = True
                    break  # restart this stage's candidate list on the new program
            if progress:
                break  # restart the ladder from stage 1
    return {
        "program": current,
        "seed": seed,
        "steps": steps,
        "attempts": attempts,
        "size": program_size(current),
        "failed_gates": last_failed,
        "history": history,
    }
