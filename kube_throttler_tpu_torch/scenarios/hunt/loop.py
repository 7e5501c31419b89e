"""The budgeted adversarial search loop: mutate → evaluate → cover →
shrink → promote.

One sequential loop (evaluations are the cost unit; each runs the FULL
remote stack in a fresh interpreter, so parallelizing on a 1-core host
would only contaminate the SLO gates):

1. pop the most-promising parent from the novelty-weighted corpus
   (priority = novelty of its own run, decayed per use so the search
   keeps widening instead of strip-mining one lineage);
2. ``mutate(parent, iteration)`` — deterministic child, content-addressed
   dedupe against everything already evaluated;
3. evaluate the child (fresh interpreter, full SLO gates + structured
   fingerprint);
4. ``CoverageMap.observe`` — children that reach new behavior join the
   corpus with their novelty as weight; barren children are dropped;
5. any gate failure is CONFIRMED by one re-evaluation (determinism means
   a real failure reproduces; a co-tenant noise spike does not), then
   shrunk (shrink.py) and promoted into ``scenarios/corpus/regressions/``
   as a permanent tier gate.

The loop emits a machine-readable coverage report (fault sites reached,
metric families touched, health transitions seen, per-iteration log) —
the CI artifact `hack/ci.sh` archives.

Every evaluation runs the stack on ``HuntConfig.device`` (``cuda`` by
default; the fresh interpreter gets ``--device``, and without a CUDA
device it exits non-zero, which the loop reads as an evaluation with no
report).
"""

from __future__ import annotations

import heapq
import json
import logging
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence

from ..corpus import REGRESSIONS_DIR
from ..dsl import Arrival, FaultSpec, Scenario, SloGates, Topology, scenario_to_dict
from .coverage import CoverageMap, fingerprint_keys
from .mutate import mutate, normalize, program_sha
from .shrink import failed_gates_of, shrink

logger = logging.getLogger(__name__)

__all__ = [
    "HuntConfig",
    "InProcessEvaluator",
    "SubprocessEvaluator",
    "base_programs",
    "hunt",
    "planted_bug_program",
    "promote",
]


def base_programs() -> List[Scenario]:
    """The hunt tier's seed corpus: small programs (fast evaluations —
    the budget buys iterations, not pods) spanning the three arrival
    regimes the mutators then cross with the fault space. Gate bounds are
    the corpus' steady-state posture with headroom for the smaller
    topology (fresh-interpreter runs, so no test-process contamination
    allowance needed)."""
    slo = SloGates(flip_p99_ms=250.0, min_pace_frac=0.3, min_flip_samples=3)
    base = Scenario(
        name="hunt-base",
        description="hunt seed: small constant churn",
        duration_s=2.5,
        arrival=Arrival(kind="constant", rate_hz=350.0),
        topology=Topology(pods=900, throttles=60, groups=30, nodes=4),
        slo=slo,
    )
    return [
        normalize(base),
        normalize(
            replace(
                base,
                arrival=Arrival(kind="diurnal", rate_hz=400.0, trough_frac=0.3),
            )
        ),
        normalize(
            replace(base, topology=replace(base.topology, hot_frac=0.5))
        ),
    ]


def planted_bug_program() -> Scenario:
    """The planted-bug fixture: a minimal program whose schedule stalls
    every status PUT through the REAL mockserver fault verb
    (``mock.status.delay``) for longer than the flip SLO — the known
    regression class the engine's gate demonstration injects via a knob; here
    it lives IN the searched program space, so finding it, shrinking it,
    and promoting it exercises the whole hunt lifecycle end to end
    against a failure that is genuinely detected by the gates, not
    assumed."""
    base = base_programs()[0]
    return normalize(
        replace(
            base,
            faults=(
                FaultSpec(
                    site="mock.status.delay",
                    mode="delay",
                    delay=0.4,
                    # covers the replay AND its overrun/quiesce on a busy
                    # host (virtual time is wall time; see normalize())
                    window=(0.2, base.duration_s + 10.0),
                ),
            ),
        )
    )


# -- evaluators ---------------------------------------------------------------


class SubprocessEvaluator:
    """Evaluate a program in a FRESH interpreter (the soundness
    requirement: sequential same-process runs contaminate each other's
    heaps — scenarios/__main__._run_isolated measured 79→440 ms flip p99
    by run five). Each call writes the program JSON and runs
    ``python -m kube_throttler_tpu_torch.scenarios run --file …
    --device <device>``."""

    def __init__(self, workdir: str, timeout_s: float = 900.0,
                 device: str = "cuda"):
        self.workdir = workdir
        self.timeout_s = timeout_s
        self.device = device
        self.evals = 0

    def __call__(self, scn: Scenario, seed: int) -> Optional[Dict]:
        self.evals += 1
        wd = os.path.join(self.workdir, f"eval-{self.evals:04d}-{scn.name}")
        os.makedirs(wd, exist_ok=True)
        program_path = os.path.join(wd, "program.json")
        with open(program_path, "w") as f:
            json.dump(scenario_to_dict(scn), f, indent=2)
        env = dict(os.environ)
        # the hunt DETECTS regressions by latency gates failing through
        # the real stack; the slow-host advisory calibration in
        # scenarios/slo.py would blind it, so evals always enforce
        env.setdefault("KT_SCENARIO_ENFORCE_LATENCY", "1")
        try:
            proc = subprocess.run(
                [
                    sys.executable, "-m", "kube_throttler_tpu_torch.scenarios", "run",
                    "--file", program_path, "--seed", str(seed), "--workdir", wd,
                    "--device", self.device,
                ],
                capture_output=True, text=True, timeout=self.timeout_s, env=env,
            )
        except subprocess.TimeoutExpired:
            logger.warning("hunt eval timed out: %s", scn.name)
            return None
        report_path = os.path.join(wd, f"report-{scn.name}-s{seed}.json")
        if not os.path.exists(report_path):
            logger.warning(
                "hunt eval produced no report (rc=%s): %s\n%s",
                proc.returncode, scn.name, proc.stdout[-1500:],
            )
            return None
        with open(report_path) as f:
            return json.load(f)


class InProcessEvaluator:
    """Evaluate by calling run_scenario in THIS process. Orders of
    magnitude cheaper (no interpreter + torch import per run) but runs
    contaminate each other's timing — use only where the failing gates
    under test are timing-insensitive or bounds are loose (the tier-1
    hunt tests), never for the nightly soak. ``device=None`` means CUDA
    (each evaluation then raises without it, and counts as crashed)."""

    def __init__(self, workdir: str, device=None):
        self.workdir = workdir
        self.device = device
        self.evals = 0

    def __call__(self, scn: Scenario, seed: int) -> Optional[Dict]:
        from ..engine import run_scenario

        self.evals += 1
        wd = os.path.join(self.workdir, f"eval-{self.evals:04d}-{scn.name}")
        # same contract as SubprocessEvaluator: hunt evals enforce the
        # latency gates (advisory mode would hide every planted stall)
        had = os.environ.get("KT_SCENARIO_ENFORCE_LATENCY")
        if had is None:
            os.environ["KT_SCENARIO_ENFORCE_LATENCY"] = "1"
        try:
            return run_scenario(scn, seed, wd, device=self.device)
        except Exception:
            logger.warning("in-process hunt eval crashed", exc_info=True)
            return None
        finally:
            if had is None:
                os.environ.pop("KT_SCENARIO_ENFORCE_LATENCY", None)


# -- promotion ----------------------------------------------------------------


def promote(
    minimal: Scenario,
    seed: int,
    failed_gates: Sequence[str],
    provenance: Dict,
    promote_dir: str,
) -> str:
    """Write the shrunk repro into the regression corpus
    (corpus.load_regressions' schema). ``expect`` pins the verdict the
    replay must keep producing: ``fail:<gate>`` — the permanent proof
    that this trace still trips that gate. When a promoted repro's
    underlying bug is FIXED, the maintainer flips the committed file to
    ``"expect": "pass"`` and it becomes an always-green regression test
    (lifecycle: docs/scenarios.md)."""
    os.makedirs(promote_dir, exist_ok=True)
    entry = {
        "scenario": scenario_to_dict(minimal),
        "seed": seed,
        "expect": f"fail:{sorted(failed_gates)[0]}",
        "provenance": dict(provenance, found_by="scenario-hunt"),
    }
    path = os.path.join(promote_dir, f"{minimal.name}.json")
    with open(path, "w") as f:
        json.dump(entry, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


# -- the loop -----------------------------------------------------------------


@dataclass
class HuntConfig:
    workdir: str
    budget_s: float = 600.0
    max_iterations: int = 40
    hunt_seed: int = 0
    trace_seed: int = 0
    bases: Optional[List[Scenario]] = None
    extra_programs: List[Scenario] = field(default_factory=list)
    promote_dir: str = REGRESSIONS_DIR
    do_promote: bool = True
    max_findings: int = 3
    shrink_stages: Sequence[str] = ("faults", "flags", "arrival", "scale", "duration")
    shrink_max_attempts: int = 16
    confirm_findings: bool = True
    # CI smoke posture: end the run as soon as one finding is confirmed,
    # shrunk, and handled (the lifecycle is proven; iterations are money)
    stop_on_finding: bool = False
    report_path: Optional[str] = None
    # where the default evaluator's interpreters run the stack
    device: str = "cuda"


def hunt(
    cfg: HuntConfig,
    evaluate: Optional[Callable[[Scenario, int], Optional[Dict]]] = None,
    registry=None,
) -> Dict:
    """Run the budgeted search; returns (and writes) the coverage report.

    ``evaluate`` defaults to the fresh-interpreter SubprocessEvaluator;
    tests inject cheaper ones. ``registry`` (metrics.Registry) receives
    the kube_throttler_hunt_* families when given."""
    os.makedirs(cfg.workdir, exist_ok=True)
    if evaluate is None:
        evaluate = SubprocessEvaluator(
            os.path.join(cfg.workdir, "evals"), device=cfg.device
        )
    fams = None
    if registry is not None:
        from ...metrics import register_hunt_metrics

        fams = register_hunt_metrics(registry)

    coverage = CoverageMap()
    seen: Dict[str, int] = {}  # program sha → iteration first seen
    # corpus priority queue: (-priority, tiebreak, program); parents are
    # re-pushed with decayed priority so high-novelty lineages dominate
    # but never monopolize
    heap: List = []
    push_seq = 0

    def push(program: Scenario, priority: float) -> None:
        nonlocal push_seq
        push_seq += 1
        heapq.heappush(heap, (-priority, push_seq, program))

    t0 = time.monotonic()
    iterations = 0
    findings: List[Dict] = []
    promoted: List[str] = []
    log_lines: List[Dict] = []
    corpus_programs: Dict[str, Scenario] = {}

    def budget_left() -> bool:
        if cfg.stop_on_finding and findings:
            return False
        return (
            time.monotonic() - t0 < cfg.budget_s
            and iterations < cfg.max_iterations
        )

    def evaluate_program(program: Scenario, origin: str) -> None:
        nonlocal iterations
        sha = program_sha(program)
        if sha in seen:
            return
        seen[sha] = iterations
        iterations += 1
        report = evaluate(program, cfg.trace_seed)
        keys = fingerprint_keys(report) if report else frozenset()
        novelty = coverage.observe(keys)
        failed = failed_gates_of(report)
        log_lines.append(
            {
                "iteration": iterations,
                "origin": origin,
                "program": program.name,
                "sha": sha[:12],
                "evaluated": report is not None,
                "novelty": novelty,
                "failed_gates": failed,
            }
        )
        if fams is not None:
            fams["iterations"].inc({}, 1.0)
            fams["coverage"].set({}, float(len(coverage)))
            fams["corpus"].set({}, float(len(corpus_programs)))
        if report is None:
            return
        if novelty > 0:
            corpus_programs[sha] = program
            push(program, float(novelty))
        if failed and len(findings) < cfg.max_findings:
            _handle_finding(program, report, failed, origin)

    def _handle_finding(
        program: Scenario, report: Dict, failed: List[str], origin: str
    ) -> None:
        if cfg.confirm_findings:
            confirm = evaluate(program, cfg.trace_seed)
            confirmed = sorted(set(failed) & set(failed_gates_of(confirm)))
            if not confirmed:
                log_lines.append(
                    {
                        "iteration": iterations,
                        "program": program.name,
                        "unconfirmed_failure": failed,
                    }
                )
                return
            failed = confirmed
        if fams is not None:
            fams["findings"].inc({}, 1.0)
        res = shrink(
            program,
            cfg.trace_seed,
            evaluate,
            failed,
            stages=cfg.shrink_stages,
            max_attempts=cfg.shrink_max_attempts,
        )
        if fams is not None:
            fams["shrink_steps"].inc({}, float(res["steps"]))
        finding = {
            "origin": origin,
            "found_program": program.name,
            "found_sha": program_sha(program),
            "failed_gates": failed,
            "minimal_program": res["program"].name,
            "minimal_sha": program_sha(res["program"]),
            "minimal_size": res["size"],
            "shrink_steps": res["steps"],
            "shrink_attempts": res["attempts"],
            "shrink_history": res["history"],
            "trace_sha256": report.get("trace_sha256"),
        }
        findings.append(finding)
        if cfg.do_promote:
            path = promote(
                res["program"],
                cfg.trace_seed,
                res["failed_gates"] or failed,
                {
                    "hunt_seed": cfg.hunt_seed,
                    "iteration": iterations,
                    "parent": program.name,
                    "parent_sha": program_sha(program),
                    "shrink_steps": res["steps"],
                    "shrink_history": res["history"],
                    "original_trace_sha256": report.get("trace_sha256"),
                },
                cfg.promote_dir,
            )
            promoted.append(path)
            finding["promoted_path"] = path

    # seed the corpus: the base programs plus any planted extras — all
    # evaluated through the same pipeline (a seeded program that fails a
    # gate is a finding like any other)
    for program in (cfg.bases if cfg.bases is not None else base_programs()):
        if not budget_left():
            break
        evaluate_program(normalize(program), "base")
    for program in cfg.extra_programs:
        if not budget_left():
            break
        evaluate_program(normalize(program), "seeded")

    mutation_counter = 0
    while budget_left() and heap:
        neg_priority, _, parent = heapq.heappop(heap)
        mutation_counter += 1
        child = mutate(parent, cfg.hunt_seed * 100_000 + mutation_counter)
        evaluate_program(child, f"mutant-of-{parent.name}")
        # decay and re-offer the parent (half weight per use, floor 0.25)
        decayed = max(-neg_priority / 2.0, 0.25)
        push(parent, decayed)

    report = {
        "hunt_seed": cfg.hunt_seed,
        "trace_seed": cfg.trace_seed,
        "budget_s": cfg.budget_s,
        "wall_s": round(time.monotonic() - t0, 3),
        "iterations": iterations,
        "corpus_size": len(corpus_programs),
        "findings": findings,
        "promoted": promoted,
        "coverage": coverage.report(),
        "log": log_lines,
    }
    path = cfg.report_path or os.path.join(cfg.workdir, "hunt-report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    report["report_path"] = path
    return report
