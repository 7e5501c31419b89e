"""Adversarial scenario hunt of the PyTorch port: mutator purity and bounds,
canonical fault-plan dedupe, coverage-map novelty accounting, shrinker
soundness, the search loop (stub-evaluated: the synthetic model makes
hundreds of iterations affordable), the planted-bug fixture through the
REAL engine (found → confirmed → shrunk → promoted → replays red), the
committed regression corpus, and the hunt metric families.

A copy of ``tests/test_hunt.py`` with the port's imports: the real-engine
evaluator runs on ``device="cpu"``; the assertions are the reference's."""

from __future__ import annotations

import json
import os

import pytest

from kube_throttler_tpu_torch.faults.plan import KNOWN_SITES, FaultPlan, FaultRule
from kube_throttler_tpu_torch.scenarios.corpus import (
    REGRESSIONS_DIR,
    load_regressions,
)
from kube_throttler_tpu_torch.scenarios.dsl import (
    FaultSpec,
    Scenario,
    scenario_from_dict,
    scenario_to_dict,
)
from kube_throttler_tpu_torch.scenarios.hunt.coverage import (
    CoverageMap,
    fingerprint_keys,
    hit_bucket,
)
from kube_throttler_tpu_torch.scenarios.hunt.loop import (
    HuntConfig,
    InProcessEvaluator,
    base_programs,
    hunt,
    planted_bug_program,
)
from kube_throttler_tpu_torch.scenarios.hunt.mutate import (
    BOUNDS,
    MUTABLE_FAULT_SITES,
    mutate,
    normalize,
    program_sha,
    program_size,
)
from kube_throttler_tpu_torch.scenarios.hunt.shrink import failed_gates_of, shrink
from kube_throttler_tpu_torch.scenarios.trace import (
    build_trace,
    canonical_fault_plan,
    serialize_trace,
)
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


# ---------------------------------------------------------------- mutators


class TestMutatePurity:
    def test_same_seed_identical_child_and_trace_bytes(self):
        base = base_programs()[0]
        for seed in (0, 3, 11):
            a = mutate(base, seed)
            b = mutate(base, seed)
            assert a == b
            # the trace property holds for every child: same (child, trace
            # seed) ⇒ identical committed trace bytes
            assert serialize_trace(*build_trace(a, 0)) == serialize_trace(
                *build_trace(b, 0)
            )

    def test_seeds_explore(self):
        base = base_programs()[0]
        children = {program_sha(mutate(base, s)) for s in range(16)}
        assert len(children) >= 4, "mutation space collapsed"

    def test_children_stay_in_bounds(self):
        program = base_programs()[0]
        for seed in range(40):
            program = mutate(program, seed)
            topo = program.topology
            assert BOUNDS["pods"][0] <= topo.pods <= BOUNDS["pods"][1]
            assert BOUNDS["throttles"][0] <= topo.throttles <= BOUNDS["throttles"][1]
            assert BOUNDS["duration_s"][0] <= program.duration_s <= BOUNDS["duration_s"][1]
            assert len(program.faults) <= BOUNDS["max_faults"]
            assert program.name == f"hunt-{program_sha(program)[:12]}"

    def test_mutable_sites_are_registered(self):
        assert set(MUTABLE_FAULT_SITES) <= KNOWN_SITES

    def test_order_permuted_schedules_dedupe(self):
        base = base_programs()[0]
        f1 = FaultSpec(site="mock.watch.cut", mode="close", window=(0.5, 1.5))
        f2 = FaultSpec(site="mock.status.conflict", mode="conflict", window=(1.0, 2.0))
        from dataclasses import replace

        a = normalize(replace(base, faults=(f1, f2)))
        b = normalize(replace(base, faults=(f2, f1)))
        assert program_sha(a) == program_sha(b)
        assert a == b  # the sorted normal form IS the program

    def test_serialization_round_trip(self):
        child = mutate(base_programs()[1], 5)
        assert scenario_from_dict(scenario_to_dict(child)) == child


class TestCanonicalFaultPlan:
    def test_rule_canonical_drops_defaults(self):
        rule = FaultRule(site="mock.list")
        assert rule.canonical() == {"site": "mock.list"}
        rule = FaultRule(
            site="mock.list", mode="delay", delay=0.1, window=(1.0, 2.0),
            probability=0.5, times=2, at_times=[3.0, 1.0],
        )
        assert rule.canonical() == {
            "site": "mock.list", "mode": "delay", "delay": 0.1,
            "window": [1.0, 2.0], "probability": 0.5, "times": 2,
            "at_times": [1.0, 3.0],
        }

    def test_plan_order_preserved(self):
        plan = FaultPlan(seed=0)
        plan.rule("mock.*", mode="error")
        plan.rule("mock.status.*", mode="delay", delay=0.1)
        rules = plan.canonical_rules()
        assert [r["site"] for r in rules] == ["mock.*", "mock.status.*"]

    def test_trace_header_commits_plan(self):
        scn = planted_bug_program()
        header, _ = build_trace(scn, 0)
        rules, sha = canonical_fault_plan(scn)
        assert header["fault_plan"] == rules
        assert header["fault_plan_sha256"] == sha
        assert rules[0]["site"] == "mock.status.delay"


# ------------------------------------------------------ FaultPlan hygiene


class TestPlanResetRearm:
    def test_reset_rearms_overlapping_windows_and_at_times(self):
        """The mutated-schedule hygiene regression: a plan whose rules
        carry OVERLAPPING windows plus an at_times instant must replay the
        exact same firing sequence after reset() — the shrinker re-replays
        schedules in fresh plans, but a soak reusing one plan relies on
        reset() re-arming every virtual-time rule."""
        plan = FaultPlan(seed=0)
        now = [0.0]
        plan.set_time_source(lambda: now[0])
        plan.rule("mock.list", mode="error", window=(1.0, 3.0), times=1)
        plan.rule("mock.list", mode="delay", window=(2.0, 4.0), times=1)
        plan.rule("mock.list", mode="gone", at_times=[2.5])

        def sequence():
            fired = []
            for t in (0.5, 1.5, 2.2, 2.6, 2.7, 3.5, 4.5):
                now[0] = t
                f = plan.check("mock.list")
                fired.append((t, None if f is None else f.mode))
            return fired

        first = sequence()
        # in the overlap, rule priority decides; each times=1 rule fires
        # once, the at_times rule once at the first hit ≥ 2.5, and the
        # second window keeps serving until it closes at 4.0
        assert first == [
            (0.5, None),
            (1.5, "error"),   # rule 0's window, first firing consumes times=1
            (2.2, "delay"),   # overlap: rule 0 exhausted → rule 1 fires
            (2.6, "gone"),    # at_times 2.5 due (window rules exhausted)
            (2.7, None),      # everything spent
            (3.5, None),
            (4.5, None),
        ]
        plan.reset()
        assert sequence() == first  # every virtual-time rule re-armed
        assert plan.fired("mock.list") == 3


# ---------------------------------------------------------------- coverage


class TestCoverage:
    def test_hit_bucket(self):
        assert [hit_bucket(n) for n in (0, 1, 2, 3, 4, 7, 8, 100)] == [
            0, 1, 2, 2, 4, 4, 8, 64,
        ]

    def test_fingerprint_keys(self):
        report = {
            "fingerprint": {
                "fault_sites": {"mock.list": 3},
                "metric_families": {"kube_throttler_status_lag_seconds": {}},
                "health_transitions": [["reflector/Pod", "ok", "degraded"]],
            },
            "gates": {"flip_p99": {"pass": False}, "verdicts": {"pass": True}},
        }
        keys = fingerprint_keys(report)
        assert keys == {
            "fault:mock.list:2",
            "metric:kube_throttler_status_lag_seconds",
            "health:reflector/Pod:ok->degraded",
            "gate:flip_p99:fail",
            "gate:verdicts:pass",
        }

    def test_novelty_accounting(self):
        cm = CoverageMap()
        assert cm.observe({"a", "b"}) == 2
        assert cm.observe({"a"}) == 0
        assert cm.observe({"a", "c"}) == 1
        assert len(cm) == 3
        rep = cm.report()
        assert rep["coverage_keys"] == 3
        assert rep["keys"] == ["a", "b", "c"]


# --------------------------------------------- stub-evaluated loop + shrink

# The synthetic stack model: a program is "buggy" iff its schedule stalls
# status PUTs hard enough (the planted class). Everything else passes.
# Fingerprints derive from the schedule so coverage-guided search has a
# real gradient to climb — all deterministic, thousands of evals/second.


def _stub_evaluate(scn: Scenario, seed: int):
    buggy = any(
        f.site == "mock.status.delay" and f.delay >= 0.2 for f in scn.faults
    )
    sites = {}
    for f in scn.faults:
        sites[f.site] = sites.get(f.site, 0) + (3 if f.window is not None else 1)
    fams = {"kube_throttler_status_lag_seconds": {"series": 2, "delta": 1.0}}
    if scn.pattern != "churn":
        fams["kube_throttler_ingest_events_total"] = {"series": 1, "delta": 9.0}
    transitions = (
        [["committer", "ok", "degraded"]] if buggy else []
    )
    gates = {
        "flip_p99": {"pass": not buggy, "value": 2000 if buggy else 20, "bound": 250},
        "verdicts": {"pass": True, "value": {"wrong": 0}, "bound": 0},
    }
    return {
        "scenario": scn.name,
        "all_pass": not buggy,
        "gates": gates,
        "trace_sha256": program_sha(scn),
        "fingerprint": {
            "fault_sites": sites,
            "metric_families": fams,
            "health_transitions": transitions,
        },
    }


class TestShrinker:
    def _camouflaged(self) -> Scenario:
        from dataclasses import replace

        base = base_programs()[1]  # diurnal arrival (shrinkable structure)
        return normalize(
            replace(
                base,
                pattern="drain",
                faults=(
                    FaultSpec(site="mock.status.delay", mode="delay",
                              delay=0.3, window=(0.2, 2.0)),
                    FaultSpec(site="mock.watch.cut", mode="close",
                              window=(0.5, 1.5), probability=0.1),
                    FaultSpec(site="scenario.apiserver.restart",
                              mode="restart", t=1.0),
                ),
            )
        )

    def test_shrinks_to_minimal_and_stays_red(self):
        program = self._camouflaged()
        assert program_size(program) > 3
        res = shrink(
            program, 0, _stub_evaluate,
            target_gates=["flip_p99"], max_attempts=40,
        )
        minimal = res["program"]
        assert res["size"] == program_size(minimal) == 1
        assert len(minimal.faults) == 1
        assert minimal.faults[0].site == "mock.status.delay"
        assert minimal.pattern == "churn"
        assert minimal.arrival.kind == "constant"
        assert res["steps"] >= 4
        assert "flip_p99" in res["failed_gates"]
        # soundness: the minimal program still fails under a FRESH eval
        assert failed_gates_of(_stub_evaluate(minimal, 0)) == ["flip_p99"]

    def test_never_accepts_a_green_candidate(self):
        """Every accepted step's recorded failed_gates must intersect the
        target set — a candidate whose re-replay went green is rejected
        even when it would reduce size."""
        res = shrink(
            self._camouflaged(), 0, _stub_evaluate,
            target_gates=["flip_p99"], max_attempts=40,
        )
        for step in res["history"]:
            assert "flip_p99" in step["failed_gates"]

    def test_requires_target_gates(self):
        with pytest.raises(ValueError):
            shrink(base_programs()[0], 0, _stub_evaluate, target_gates=[])


class TestHuntLoopStub:
    def test_search_finds_plants_and_promotes(self, tmp_path):
        """Open-ended search (nothing seeded): the fault-insert mutators
        must DISCOVER the buggy schedule class, the loop must confirm +
        shrink it, and the promotion must land in the corpus dir."""
        cfg = HuntConfig(
            workdir=str(tmp_path / "hunt"),
            budget_s=60.0,
            max_iterations=300,
            hunt_seed=1,
            promote_dir=str(tmp_path / "regressions"),
            shrink_stages=("faults", "flags", "arrival"),
            shrink_max_attempts=20,
            max_findings=1,
            stop_on_finding=True,
        )
        from kube_throttler_tpu_torch.metrics import METRIC_NAMES, Registry

        registry = Registry()
        report = hunt(cfg, evaluate=_stub_evaluate, registry=registry)
        assert report["findings"], "search never found the planted bug class"
        finding = report["findings"][0]
        assert "flip_p99" in finding["failed_gates"]
        assert finding["minimal_size"] <= 2
        assert report["promoted"]
        # the promoted entry round-trips through the corpus loader
        entries = [
            e for e in _load_dir(str(tmp_path / "regressions"))
        ]
        assert len(entries) == 1
        entry = entries[0]
        assert entry["expect"] == "fail:flip_p99"
        assert any(
            f.site == "mock.status.delay" for f in entry["scenario"].faults
        )
        # coverage artifact shape
        cov = report["coverage"]
        assert cov["coverage_keys"] > 0
        assert "mock.status.delay" in cov["fault_sites_reached"]
        assert cov["metric_families_touched"]
        assert "committer:ok->degraded" in cov["health_transitions_seen"]
        assert os.path.exists(report["report_path"])
        # hunt metric families moved and are all registered names
        fams = registry.family_totals()
        for name in (
            "kube_throttler_hunt_iterations_total",
            "kube_throttler_hunt_coverage_size",
            "kube_throttler_hunt_findings_total",
        ):
            assert name in fams and name in METRIC_NAMES
        assert fams["kube_throttler_hunt_iterations_total"][1] == report["iterations"]

    def test_deterministic_given_seed(self, tmp_path):
        reports = []
        for run in ("a", "b"):
            cfg = HuntConfig(
                workdir=str(tmp_path / run),
                budget_s=60.0,
                max_iterations=60,
                hunt_seed=7,
                do_promote=False,
                max_findings=1,
                stop_on_finding=True,
            )
            reports.append(hunt(cfg, evaluate=_stub_evaluate))
        trail_a = [(l["program"], l["novelty"]) for l in reports[0]["log"]]
        trail_b = [(l["program"], l["novelty"]) for l in reports[1]["log"]]
        assert trail_a == trail_b
        assert reports[0]["coverage"]["keys"] == reports[1]["coverage"]["keys"]

    def test_novelty_gates_corpus_admission(self, tmp_path):
        """A child whose fingerprint adds nothing new never joins the
        corpus queue (iteration log novelty 0 and corpus size stays at
        what novel programs earned)."""
        cfg = HuntConfig(
            workdir=str(tmp_path),
            budget_s=30.0,
            max_iterations=40,
            hunt_seed=3,
            do_promote=False,
            max_findings=0,
        )
        report = hunt(cfg, evaluate=_stub_evaluate)
        novel = [l for l in report["log"] if l.get("novelty", 0) > 0]
        assert report["corpus_size"] == len(novel)
        assert any(l.get("novelty", 1) == 0 for l in report["log"])


def _load_dir(path):
    """load_regressions against an arbitrary directory (the loader reads
    the committed dir; tests point it elsewhere via monkey-free reuse)."""
    import importlib

    # (attribute access via the package resolves the corpus FUNCTION the
    # scenarios __init__ re-exports, not the module — go through importlib)
    corpus_mod = importlib.import_module("kube_throttler_tpu_torch.scenarios.corpus")

    old = corpus_mod.REGRESSIONS_DIR
    corpus_mod.REGRESSIONS_DIR = path
    try:
        return corpus_mod.load_regressions()
    finally:
        corpus_mod.REGRESSIONS_DIR = old


# --------------------------------------- the planted bug through the REAL engine


class TestPlantedBugRealEngine:
    def test_find_shrink_promote_and_replay_red(self, tmp_path):
        """Tier-1 end-to-end on the real stack: the planted
        mock.status.delay program (seeded into the corpus — `make
        scenario-hunt-smoke` proves the same lifecycle in fresh
        interpreters) fails flip_p99 through the REAL mockserver fault
        verb, is confirmed, shrunk to ≤2 DSL ops, promoted — and the
        promoted repro replays RED (pre-fix) via the corpus loader."""
        from dataclasses import replace as _replace

        evaluator = InProcessEvaluator(str(tmp_path / "evals"), device="cpu")
        # loosen the flip bound to the tier-1 in-process allowance (the
        # smoke scenario's 400 ms): this test shares a busy interpreter,
        # and the planted stall fails at ~3000 ms either way — the loose
        # bound only protects the shrinker's CLEAN candidates from
        # co-tenant noise
        plant = planted_bug_program()
        plant = normalize(
            _replace(plant, slo=_replace(plant.slo, flip_p99_ms=400.0))
        )
        cfg = HuntConfig(
            workdir=str(tmp_path / "hunt"),
            budget_s=600.0,
            max_iterations=2,
            bases=[],  # in-process runs are pricey: evaluate only the plant
            extra_programs=[plant],
            promote_dir=str(tmp_path / "regressions"),
            shrink_stages=("faults",),
            shrink_max_attempts=3,
            max_findings=1,
            stop_on_finding=True,
        )
        report = hunt(cfg, evaluate=evaluator)
        assert report["findings"], report["log"]
        finding = report["findings"][0]
        assert "flip_p99" in finding["failed_gates"]
        assert finding["minimal_size"] <= 2
        assert report["promoted"]

        entries = _load_dir(str(tmp_path / "regressions"))
        assert len(entries) == 1
        entry = entries[0]
        assert entry["expect"].startswith("fail:")
        replay = evaluator(entry["scenario"], entry["seed"])
        assert replay is not None
        gate = entry["expect"].split(":", 1)[1]
        assert gate in failed_gates_of(replay), (
            "promoted repro no longer replays red — the regression gate "
            "stopped gating"
        )


# ------------------------------------------------- the committed corpus


class TestCommittedRegressionCorpus:
    def test_committed_entries_load_and_are_valid(self):
        entries = load_regressions()
        assert entries, (
            f"no committed regression repros under {REGRESSIONS_DIR} — "
            "the hunt's promotion acceptance artifact is missing"
        )
        for entry in entries:
            scn = entry["scenario"]
            assert isinstance(scn, Scenario)
            for f in scn.faults:
                assert f.site in KNOWN_SITES
            assert entry["expect"] == "pass" or entry["expect"].startswith("fail:")
            assert entry["provenance"].get("found_by") == "scenario-hunt"
            # determinism: the committed program still builds byte-stable
            # traces (two builds, identical bytes)
            a = serialize_trace(*build_trace(scn, entry["seed"]))
            b = serialize_trace(*build_trace(scn, entry["seed"]))
            assert a == b
