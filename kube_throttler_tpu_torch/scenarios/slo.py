"""Per-scenario SLO gates and their evaluation.

A gate is a named bound over the replay's measurements; a scenario's
verdict is the AND of its gates. Gates (bounds per scenario,
scenarios/dsl.py SloGates):

- ``flip_p99`` — crossing-anchored flip-publication p99 ≤ the bound
  (150 ms is the corpus default, the serving SLO). A run with
  fewer than ``min_flip_samples`` flip samples FAILS the gate as
  unmeasurable rather than passing vacuously;
- ``ingest_sustain`` — the replayer achieved at least ``min_pace_frac``
  of the trace's nominal op rate AND the full pipeline converged (local
  mirror ≡ apiserver truth) inside the quiesce deadline, with at least
  ``min_applied_frac`` of fired ops surviving shedding (shed-then-relist
  repairs count as applied once the relist lands them);
- ``recovery`` — after every scheduled apiserver restart: every
  reflector relisted past the reset RV floor, the wire backlog drained,
  and — when anything remained to publish — the first post-resync
  status publication landed, all within ``recovery_s`` of the restart
  (the watch → relist → reconcile → PUT loop closed again);
- ``verdicts`` — ZERO wrong admission verdicts: the serving stack's
  batch triage over its reflected state equals an oracle rebuilt from
  apiserver truth, full-population, plus a seeded per-pod host-oracle
  spot check (``thr.check_throttled_for`` against the written statuses —
  independent of every device plane and batch kernel);
- ``failover`` — the process-level kill-the-leader episode (bad-day
  scenario) promoted a standby within ``failover_window_s``.

``diff_reports`` renders the clean-vs-regressed comparison the
injected-regression acceptance check prints: per gate, both runs' values
against the shared bound, and which gates changed verdict.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from .dsl import Scenario

__all__ = ["evaluate_gates", "host_spot_check", "diff_reports"]


def _gate(value, bound, ok: bool, note: str = "") -> Dict:
    out = {"pass": bool(ok), "value": value, "bound": bound}
    if note:
        out["note"] = note
    return out


def _latency_gates_enforced() -> bool:
    """The corpus flip-lag bounds are wall-clock SLOs calibrated against
    hosts with at least KT_SCENARIO_LATENCY_CORE_FLOOR cores (default 2
    — the replayer, the serving stack, and the apiserver twin each need
    scheduling headroom). On a more starved host the p99 overshoots with
    no code regression, so below the floor the latency gates report
    their measured values as ADVISORY (pass, with a would-FAIL note)
    instead of enforcing; correctness gates (verdicts, recovery,
    ingest_sustain) are host-speed-independent and always enforce.
    KT_SCENARIO_ENFORCE_LATENCY=1 forces enforcement regardless — the
    injected-regression acceptance test sets it so the gate demonstrably
    still gates."""
    if os.environ.get("KT_SCENARIO_ENFORCE_LATENCY") == "1":
        return True
    try:
        floor = int(os.environ.get("KT_SCENARIO_LATENCY_CORE_FLOOR", "2"))
    except ValueError:
        floor = 2  # malformed override must not change the gate contract
    return len(os.sched_getaffinity(0)) >= floor


def evaluate_gates(scn: Scenario, m: Dict) -> Dict[str, Dict]:
    """``m`` is the engine's measurement dict (scenarios/engine.py). Gates
    whose bound is None (or whose fault never fired) are skipped."""
    slo = scn.slo
    gates: Dict[str, Dict] = {}

    p99 = m.get("flip_lag_p99_ms")
    samples = m.get("flip_samples", 0)
    if samples < slo.min_flip_samples:
        gates["flip_p99"] = _gate(
            None, slo.flip_p99_ms, False,
            f"unmeasurable: {samples} flip samples < {slo.min_flip_samples}",
        )
    else:
        enforced = _latency_gates_enforced()
        ok99 = p99 <= slo.flip_p99_ms
        note99 = f"{samples} samples from {m.get('flip_crossings', 0)} crossings"
        if not enforced and not ok99:
            note99 += "; ADVISORY (host below latency core floor) — would FAIL"
        gates["flip_p99"] = _gate(
            round(p99, 2), slo.flip_p99_ms, ok99 or not enforced, note99
        )
        if slo.flip_p50_ms is not None:
            p50 = m.get("flip_lag_p50_ms", 0.0)
            ok50 = p50 <= slo.flip_p50_ms
            gates["flip_p50"] = _gate(
                round(p50, 2), slo.flip_p50_ms, ok50 or not enforced,
                ""
                if enforced or ok50
                else "ADVISORY (host below latency core floor) — would FAIL",
            )

    pace_frac = m.get("pace_frac", 0.0)
    applied_frac = m.get("applied_frac", 0.0)
    converged = bool(m.get("converged"))
    gates["ingest_sustain"] = _gate(
        {
            "pace_frac": round(pace_frac, 3),
            "applied_frac": round(applied_frac, 3),
            "converged": converged,
            "events_per_sec": round(m.get("events_per_sec", 0.0), 1),
            "shed": m.get("ingest_dropped", 0),
        },
        {
            "min_pace_frac": slo.min_pace_frac,
            "min_applied_frac": slo.min_applied_frac,
        },
        converged
        and pace_frac >= slo.min_pace_frac
        and applied_frac >= slo.min_applied_frac,
    )

    if slo.recovery_s is not None and m.get("restarts", 0) > 0:
        rec = m.get("recovery_s")
        gates["recovery"] = _gate(
            None if rec is None else round(rec, 3),
            slo.recovery_s,
            rec is not None and rec <= slo.recovery_s,
            f"{m.get('restarts')} restart(s)",
        )

    wrong = m.get("wrong_verdicts")
    gates["verdicts"] = _gate(
        {
            "wrong": wrong,
            "checked": m.get("verdicts_checked", 0),
            "spot_checked": m.get("spot_checked", 0),
            "examples": m.get("wrong_examples", [])[:5],
        },
        slo.max_wrong_verdicts,
        wrong is not None and wrong <= slo.max_wrong_verdicts,
    )

    if scn.leader_kill and slo.failover_window_s is not None:
        window = m.get("failover_window_s")
        gates["failover"] = _gate(
            None if window is None else round(window, 3),
            slo.failover_window_s,
            window is not None and window <= slo.failover_window_s,
        )
    return gates


def host_spot_check(serving_verdicts: Dict[str, bool], oracle_store,
                    sample: List, throttles=None, cluster_throttles=None,
                    ) -> List[str]:
    """Independent per-pod admission oracle over ``sample`` pods: a plain
    Python walk of the oracle store's throttles — selector match +
    ``check_throttled_for`` against the WRITTEN statuses, no device
    planes, no batch kernels, no listers. Returns the pod keys whose
    serving verdict disagrees."""
    from ..api.pod import accel_class_of
    from ..api.types import ResourceAmount

    if throttles is None:
        throttles = oracle_store.list_throttles()
    if cluster_throttles is None:
        cluster_throttles = oracle_store.list_cluster_throttles()
    empty = ResourceAmount()
    wrong: List[str] = []
    for pod in sample:
        accel = accel_class_of(pod)
        blocked = False
        for thr in throttles:
            if thr.namespace != pod.namespace:
                continue
            if not thr.spec.selector.matches_to_pod(pod):
                continue
            if (
                thr.check_throttled_for(pod, empty, False, accel_class=accel)
                != "not-throttled"
            ):
                blocked = True
                break
        if not blocked:
            for thr in cluster_throttles:
                if not thr.spec.selector.matches_to_pod(pod):
                    continue
                if (
                thr.check_throttled_for(pod, empty, False, accel_class=accel)
                != "not-throttled"
            ):
                    blocked = True
                    break
        want = not blocked
        got = serving_verdicts.get(pod.key)
        if got is not want:
            wrong.append(pod.key)
    return wrong


def diff_reports(clean: Dict, regressed: Dict) -> str:
    """Human-readable per-gate diff between a clean run's report and an
    injected-regression run's — the acceptance artifact proving a broken
    SLO demonstrably fails its gate."""
    lines = [
        f"scenario {clean['scenario']} seed {clean['seed']}: "
        "clean vs injected-regression",
        f"  regression: {regressed.get('regression') or '(none)'}",
    ]
    names = sorted(set(clean["gates"]) | set(regressed["gates"]))
    flipped = []
    for name in names:
        c = clean["gates"].get(name)
        r = regressed["gates"].get(name)
        cs = "-" if c is None else ("PASS" if c["pass"] else "FAIL")
        rs = "-" if r is None else ("PASS" if r["pass"] else "FAIL")
        cv = None if c is None else c["value"]
        rv = None if r is None else r["value"]
        bound = (c or r)["bound"]
        lines.append(
            f"  {name:<14} clean={cs:<4} {cv!r:<40} regressed={rs:<4} {rv!r} "
            f"(bound {bound!r})"
        )
        if cs == "PASS" and rs == "FAIL":
            flipped.append(name)
    lines.append(
        f"  verdict: clean all_pass={clean['all_pass']} regressed "
        f"all_pass={regressed['all_pass']}; gates flipped by the "
        f"regression: {flipped or 'NONE'}"
    )
    lines.extend(_diff_fingerprints(clean, regressed))
    return "\n".join(lines)


def _diff_fingerprints(clean: Dict, regressed: Dict) -> List[str]:
    """Behavioral diff from the structured run fingerprints (engine
    ``report["fingerprint"]``): fault sites fired in only one run (or at
    different hit counts), health transitions unique to either side, and
    metric families only one run touched — the "what actually changed"
    companion to the per-gate value diff."""
    cf = clean.get("fingerprint")
    rf = regressed.get("fingerprint")
    if not cf or not rf:
        return []
    lines: List[str] = ["  fingerprint diff:"]
    c_sites, r_sites = cf.get("fault_sites", {}), rf.get("fault_sites", {})
    site_diffs = [
        f"{s}({c_sites.get(s, 0)}→{r_sites.get(s, 0)})"
        for s in sorted(set(c_sites) | set(r_sites))
        if c_sites.get(s, 0) != r_sites.get(s, 0)
    ]
    lines.append(f"    fault sites:  {', '.join(site_diffs) or '(identical)'}")

    def _tset(fp):
        return {tuple(t) for t in fp.get("health_transitions", [])}

    only_c = _tset(cf) - _tset(rf)
    only_r = _tset(rf) - _tset(cf)
    if only_c or only_r:
        for tag, ts in (("clean-only", only_c), ("regressed-only", only_r)):
            if ts:
                rendered = ", ".join(
                    f"{c}:{old}->{new}" for c, old, new in sorted(ts)
                )
                lines.append(f"    transitions {tag}: {rendered}")
    else:
        lines.append("    transitions:  (identical)")
    c_fams = set(cf.get("metric_families", {}))
    r_fams = set(rf.get("metric_families", {}))
    fam_bits = []
    if r_fams - c_fams:
        fam_bits.append(f"regressed-only: {', '.join(sorted(r_fams - c_fams))}")
    if c_fams - r_fams:
        fam_bits.append(f"clean-only: {', '.join(sorted(c_fams - r_fams))}")
    lines.append(
        f"    metric families: {'; '.join(fam_bits) or '(same set touched)'}"
    )
    return lines
