"""Scenario engine of the PyTorch port: trace determinism, virtual-time
fault rules, mockserver restart semantics, the verdict-safe ingest
overload posture, chunked batched relists, the tier-1 determinism smoke,
and the injected-regression gate demonstration. The full corpus matrix
runs behind ``-m slow`` (``make scenario-test`` drives 3 seeds).

A copy of ``tests/test_scenarios.py`` with the port's imports: every
runner gets ``device="cpu"`` and every CLI call ``--device cpu``; the
assertions and bounds are the reference's."""

from __future__ import annotations

import threading
import time

import pytest

from kube_throttler_tpu_torch.faults.plan import FaultPlan
from kube_throttler_tpu_torch.scenarios.corpus import SCENARIOS, corpus, get_scenario
from kube_throttler_tpu_torch.scenarios.dsl import Arrival, arrival_rate
from kube_throttler_tpu_torch.scenarios.trace import (
    build_trace,
    serialize_trace,
    trace_sha256,
)
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


# ---------------------------------------------------------------- traces


class TestTraceDeterminism:
    def test_same_seed_byte_identical(self):
        scn = get_scenario("smoke")
        a = serialize_trace(*build_trace(scn, 3))
        b = serialize_trace(*build_trace(scn, 3))
        assert a == b
        assert trace_sha256(a) == trace_sha256(b)

    def test_different_seed_differs(self):
        scn = get_scenario("smoke")
        assert serialize_trace(*build_trace(scn, 0)) != serialize_trace(
            *build_trace(scn, 1)
        )

    def test_ops_time_ordered_and_bounded(self):
        scn = get_scenario("smoke")
        header, ops = build_trace(scn, 0)
        ts = [op["t_us"] for op in ops]
        assert ts == sorted(ts)
        assert header["ops"] == len(ops) > 0

    def test_patterns_emit_their_shapes(self):
        drain = get_scenario("rolling_drain")
        _, ops = build_trace(drain, 0)
        verbs = {op["verb"] for op in ops}
        assert "delete_pod" in verbs and "create_pod" in verbs
        herd = get_scenario("thundering_herd")
        _, hops = build_trace(herd, 0)
        herd_creates = [
            op for op in hops if op["verb"] == "create_pod" and op["name"].startswith("h")
        ]
        assert len(herd_creates) == herd.herd_size

    def test_prev_chain_exact(self):
        """Each pod's prev_m must equal its last emitted cpu_m — the
        crossing bookkeeping the replayer trusts."""
        scn = get_scenario("rolling_drain")
        _, ops = build_trace(scn, 1)
        last: dict = {}
        for op in ops:
            if op["verb"] == "update_throttle":
                continue
            name = op["name"]
            if name in last:
                assert op["prev_m"] == last[name], op
            if op["verb"] == "delete_pod":
                last[name] = 0
            else:
                last[name] = op["cpu_m"]

    def test_corpus_has_six_scenarios(self):
        assert len(corpus()) >= 6
        assert "smoke" in SCENARIOS


class TestArrival:
    def test_shapes(self):
        assert arrival_rate(Arrival(kind="constant", rate_hz=100), 3, 10) == 100
        ramp = Arrival(kind="ramp", rate_hz=100, start_frac=0.1)
        assert arrival_rate(ramp, 0, 10) == pytest.approx(10)
        assert arrival_rate(ramp, 10, 10) == pytest.approx(100)
        di = Arrival(kind="diurnal", rate_hz=100, trough_frac=0.2, cycles=1)
        assert arrival_rate(di, 0, 10) == pytest.approx(20)
        assert arrival_rate(di, 5, 10) == pytest.approx(100)
        bu = Arrival(kind="bursts", rate_hz=100, trough_frac=0.1, burst_s=1, idle_s=1)
        assert arrival_rate(bu, 0.5, 10) == 100
        assert arrival_rate(bu, 1.5, 10) == pytest.approx(10)


# ------------------------------------------------- virtual-time fault rules


class TestVirtualTimeRules:
    def test_at_times_fires_once_per_instant(self):
        plan = FaultPlan(seed=0)
        now = [0.0]
        plan.set_time_source(lambda: now[0])
        plan.rule("scenario.churn.stall", mode="delay", at_times=[1.0, 2.0])
        assert plan.check("scenario.churn.stall") is None  # t=0: not due
        now[0] = 1.2
        f = plan.check("scenario.churn.stall")
        assert f is not None and f.mode == "delay"
        assert plan.check("scenario.churn.stall") is None  # 1.0 consumed
        now[0] = 5.0
        assert plan.check("scenario.churn.stall") is not None  # 2.0 due
        assert plan.check("scenario.churn.stall") is None  # schedule spent

    def test_window_gates_probability_rule(self):
        plan = FaultPlan(seed=0)
        now = [0.0]
        plan.set_time_source(lambda: now[0])
        plan.rule("mock.status.conflict", window=(1.0, 2.0), probability=1.0)
        assert plan.check("mock.status.conflict") is None
        now[0] = 1.5
        assert plan.check("mock.status.conflict") is not None
        now[0] = 2.0
        assert plan.check("mock.status.conflict") is None  # half-open interval

    def test_virtual_rule_inert_without_time_source(self):
        plan = FaultPlan(seed=0)
        plan.rule("scenario.churn.stall", at_times=[0.0])
        plan.rule("mock.list", window=(0.0, 10.0))
        assert plan.check("scenario.churn.stall") is None
        assert plan.check("mock.list") is None

    def test_reset_rearms_at_times(self):
        plan = FaultPlan(seed=0)
        now = [5.0]
        plan.set_time_source(lambda: now[0])
        plan.rule("scenario.churn.stall", at_times=[1.0])
        assert plan.check("scenario.churn.stall") is not None
        plan.reset()
        assert plan.check("scenario.churn.stall") is not None


# ---------------------------------------------------- mockserver restart


class TestMockserverRestart:
    def _server(self):
        from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
        from kube_throttler_tpu_torch.client.mockserver import MockApiServer

        server = MockApiServer(bookmark_interval=0.1)
        server.store.create_namespace(Namespace("default"))
        for i in range(6):
            server.store.create_pod(make_pod(f"p{i}"))
        server.start()
        return server

    def test_restart_same_port_and_rv_reset_410(self):
        from kube_throttler_tpu_torch.client.transport import (
            ApiClient,
            GoneError,
            RestConfig,
        )

        server = self._server()
        try:
            port = server.port
            client = ApiClient(RestConfig(server=server.url), qps=None)
            items, rv = client.list("Pod")
            assert len(items) == 6
            server.restart(reset_rv_window=True)
            assert server.port == port  # same address across the restart
            # a pre-restart resume point is below the fresh RV horizon
            with pytest.raises(GoneError):
                for _ in client.watch("Pod", "1", read_timeout=5.0):
                    break
            # LIST works and a from-now watch resumes cleanly
            items2, rv2 = client.list("Pod")
            assert len(items2) == 6
        finally:
            server.stop()

    def test_continue_token_expires_on_restart(self):
        from kube_throttler_tpu_torch.client.transport import (
            ApiClient,
            GoneError,
            RestConfig,
        )

        server = self._server()
        try:
            client = ApiClient(RestConfig(server=server.url), qps=None)
            pages = client.list_pages("Pod", page_size=2)
            first, _ = next(pages)
            assert len(first) == 2
            server.reset_rv_window()  # outstanding continue tokens expire
            with pytest.raises(GoneError):
                next(pages)
        finally:
            server.stop()

    def test_reflector_recovers_through_restart(self):
        from kube_throttler_tpu_torch.api.pod import make_pod
        from kube_throttler_tpu_torch.client.transport import (
            ApiClient,
            Reflector,
            RestConfig,
        )
        from kube_throttler_tpu_torch.engine.store import Store

        server = self._server()
        local = Store()
        refl = Reflector(
            ApiClient(RestConfig(server=server.url), qps=None),
            "Pod",
            local,
            backoff=0.05,
            backoff_cap=0.2,
        )
        try:
            refl.start()
            assert refl.wait_for_sync(10)
            server.restart(reset_rv_window=True)
            server.store.create_pod(make_pod("after-restart"))
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if any(p.name == "after-restart" for p in local.list_pods()):
                    break
                time.sleep(0.05)
            else:
                raise AssertionError(
                    "reflector never recovered the post-restart pod "
                    "(410 → relist path broken)"
                )
        finally:
            refl.stop()
            server.stop()

    def test_status_delay_verb_stalls_put(self):
        from kube_throttler_tpu_torch.client.transport import ApiClient, RestConfig
        from kube_throttler_tpu_torch.api.serialization import object_to_dict
        from kube_throttler_tpu_torch.api.types import (
            LabelSelector,
            ResourceAmount,
            Throttle,
            ThrottleSelector,
            ThrottleSelectorTerm,
            ThrottleSpec,
        )

        server = self._server()
        try:
            thr = Throttle(
                name="t1",
                spec=ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(pod=3),
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(LabelSelector(match_labels={"a": "b"})),
                        )
                    ),
                ),
            )
            server.store.create_throttle(thr)
            server.faults = FaultPlan(seed=0).rule(
                "mock.status.delay", mode="delay", delay=0.3
            )
            client = ApiClient(RestConfig(server=server.url), qps=None)
            body = object_to_dict(thr)
            body["metadata"]["resourceVersion"] = str(
                server.store.resource_version("Throttle", "default/t1")
            )
            t0 = time.monotonic()
            client.put(
                "/apis/schedule.k8s.everpeace.github.com/v1alpha1/"
                "namespaces/default/throttles/t1/status",
                body,
            )
            assert time.monotonic() - t0 >= 0.3  # the stall landed
        finally:
            server.stop()


# ------------------------------------------- ingest overload shed posture


class TestIngestShedPolicy:
    def _blocked_pipeline(self, maxsize=4):
        from kube_throttler_tpu_torch.engine.ingest import MicroBatchIngest
        from kube_throttler_tpu_torch.engine.store import Store

        pipeline = MicroBatchIngest(Store(), maxsize=maxsize)
        gate = threading.Event()
        entered = threading.Event()
        orig = pipeline._apply_ops

        def blocking(ops):
            entered.set()
            gate.wait(10)
            return orig(ops)

        pipeline._apply_ops = blocking
        # park the dispatcher inside an apply so the queue backs up
        pipeline.submit("upsert", "Pod", object())
        assert entered.wait(5)
        return pipeline, gate

    def test_sheds_oldest_pod_upsert_only(self):
        pipeline, gate = self._blocked_pipeline(maxsize=3)
        try:
            pipeline.submit("upsert", "Pod", "p1")
            pipeline.submit("delete", "Pod", "p2")       # critical: a delete
            pipeline.submit("upsert", "Throttle", "t1")  # critical: a throttle
            # queue is now full (3); this pod upsert sheds the OLDEST pod
            # upsert (p1), never the delete or the throttle op
            pipeline.submit("upsert", "Pod", "p3")
            with pipeline._cond:
                queued = list(pipeline._queue)
            assert ("upsert", "Pod", "p1") not in queued
            assert ("delete", "Pod", "p2") in queued
            assert ("upsert", "Throttle", "t1") in queued
            assert ("upsert", "Pod", "p3") in queued
            assert pipeline.dropped == 1 and pipeline.overflowed
        finally:
            gate.set()
            pipeline.stop()

    def test_critical_ops_exceed_bound_rather_than_shed(self):
        pipeline, gate = self._blocked_pipeline(maxsize=2)
        try:
            pipeline.submit("delete", "Pod", "d1")
            pipeline.submit("upsert", "Throttle", "t1")
            # full of critical ops: an incoming POD upsert is dropped...
            pipeline.submit("upsert", "Pod", "px")
            with pipeline._cond:
                assert ("upsert", "Pod", "px") not in list(pipeline._queue)
            # ...but an incoming CRITICAL op exceeds the bound instead
            pipeline.submit("delete", "Throttle", "t2")
            with pipeline._cond:
                queued = list(pipeline._queue)
            assert ("delete", "Throttle", "t2") in queued
            assert len(queued) == 3  # bound exceeded by the critical op
            assert pipeline.dropped == 1
        finally:
            gate.set()
            pipeline.stop()

    def test_take_overflow_consumes_per_kind(self):
        pipeline, gate = self._blocked_pipeline(maxsize=2)
        try:
            for i in range(5):
                pipeline.submit("upsert", "Pod", f"p{i}")
            assert pipeline.take_overflow("Pod") is True
            assert pipeline.take_overflow("Pod") is False  # consumed
            assert pipeline.take_overflow("Throttle") is False
            assert pipeline.overflowed  # sticky stat survives consumption
        finally:
            gate.set()
            pipeline.stop()

    def test_overflow_forces_relist_and_repairs_gap(self):
        """E2E: a pod storm through a TINY ingest queue sheds events; the
        reflector consumes the overflow marker, forces a relist, and the
        local cache converges to apiserver truth anyway."""
        from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
        from kube_throttler_tpu_torch.client.mockserver import MockApiServer
        from kube_throttler_tpu_torch.client.transport import (
            ApiClient,
            Reflector,
            RestConfig,
        )
        from kube_throttler_tpu_torch.engine.ingest import MicroBatchIngest
        from kube_throttler_tpu_torch.engine.store import Store

        server = MockApiServer(bookmark_interval=0.1)
        server.store.create_namespace(Namespace("default"))
        server.start()
        local = Store()
        pipeline = MicroBatchIngest(local, maxsize=8, max_batch=4)
        # slow the dispatcher so the storm outruns it and sheds
        orig = pipeline._apply_ops

        def slow(ops):
            time.sleep(0.002 * len(ops))
            return orig(ops)

        pipeline._apply_ops = slow
        refl = Reflector(
            ApiClient(RestConfig(server=server.url), qps=None),
            "Pod",
            local,
            backoff=0.05,
            backoff_cap=0.2,
            ingest_batcher=pipeline,
        )
        try:
            refl.start()
            assert refl.wait_for_sync(10)
            for i in range(300):
                server.store.create_pod(make_pod(f"storm{i}"))
            deadline = time.monotonic() + 30
            want = {p.key for p in server.store.list_pods()}
            while time.monotonic() < deadline:
                pipeline.flush(1.0)
                if {p.key for p in local.list_pods()} == want:
                    break
                time.sleep(0.1)
            else:
                raise AssertionError(
                    f"local cache never converged: {len(local.list_pods())}"
                    f"/{len(want)} pods (dropped={pipeline.dropped})"
                )
            assert pipeline.dropped > 0, "storm never overflowed the tiny queue"
        finally:
            refl.stop()
            pipeline.stop()
            server.stop()


# ----------------------------------------------- chunked batched relists


class TestChunkedRelist:
    def test_batched_relist_equivalent_to_direct(self):
        from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
        from kube_throttler_tpu_torch.api.serialization import object_to_dict
        from kube_throttler_tpu_torch.client.transport import Reflector
        from kube_throttler_tpu_torch.engine.ingest import MicroBatchIngest
        from kube_throttler_tpu_torch.engine.store import Store

        def page_of(pods, rv="9"):
            items = []
            for p in pods:
                d = object_to_dict(p)
                d.setdefault("metadata", {})["resourceVersion"] = "5"
                items.append(d)
            return iter([(items, rv)])

        pods = [make_pod(f"p{i}", labels={"x": str(i)}) for i in range(300)]
        results = {}
        for batched in (False, True):
            store = Store()
            store.create_namespace(Namespace("default"))
            store.create_pod(make_pod("stale"))  # must be relist-deleted
            store.create_pod(pods[0])  # unchanged-content upsert path
            pipeline = MicroBatchIngest(store) if batched else None
            refl = Reflector(None, "Pod", store, ingest_batcher=pipeline)
            rv = refl._sync_pages(page_of(pods))
            assert rv == "9"
            results[batched] = sorted(p.key for p in store.list_pods())
            if pipeline is not None:
                pipeline.stop()
        assert results[False] == results[True]
        assert "default/stale" not in results[True]
        assert len(results[True]) == 300


# --------------------------------------------- the engine: tier-1 smokes


def _run_smoke(seed, workdir, regression=None):
    from kube_throttler_tpu_torch.scenarios.engine import run_scenario

    return run_scenario(
        get_scenario("smoke"), seed, str(workdir), regression=regression,
        device="cpu",
    )


class TestScenarioEngineSmoke:
    def test_determinism_same_seed_twice(self, tmp_path):
        """Same scenario + seed twice: byte-identical committed traces and
        identical SLO gate verdicts (the tier-1 determinism smoke)."""
        r1 = _run_smoke(11, tmp_path / "a")
        r2 = _run_smoke(11, tmp_path / "b")
        assert r1["trace_sha256"] == r2["trace_sha256"]
        with open(r1["trace_path"], "rb") as f1, open(r2["trace_path"], "rb") as f2:
            assert f1.read() == f2.read()
        v1 = {k: g["pass"] for k, g in r1["gates"].items()}
        v2 = {k: g["pass"] for k, g in r2["gates"].items()}
        assert v1 == v2
        assert r1["all_pass"] and r2["all_pass"], (r1["gates"], r2["gates"])
        # the gates the smoke must exercise
        assert {"flip_p99", "ingest_sustain", "recovery", "verdicts"} <= set(v1)
        assert r1["measurements"]["restarts"] == 1
        assert r1["measurements"]["wrong_verdicts"] == 0

    def test_injected_regression_fails_its_gate(self, tmp_path, monkeypatch):
        """The gate-actually-gates check: a deliberate per-PUT stall must
        demonstrably fail the flip-p99 gate the clean run passes, and the
        diff report must name it. Enforcement is forced so the check is
        deterministic on hosts below the latency core floor (where the
        flip gates otherwise degrade to advisory — see slo.py)."""
        from kube_throttler_tpu_torch.scenarios.slo import diff_reports

        monkeypatch.setenv("KT_SCENARIO_ENFORCE_LATENCY", "1")
        clean = _run_smoke(0, tmp_path / "clean")
        regressed = _run_smoke(0, tmp_path / "reg", regression="flip_stall")
        assert clean["gates"]["flip_p99"]["pass"], clean["gates"]
        assert not regressed["gates"]["flip_p99"]["pass"], regressed["gates"]
        assert clean["all_pass"] and not regressed["all_pass"]
        diff = diff_reports(clean, regressed)
        assert "flip_p99" in diff and "flip_stall" in diff


# -------------------------------------------- host-speed gate calibration


class TestLatencyGateCalibration:
    """Flip-lag gates degrade to advisory below the host core floor
    (slo._latency_gates_enforced) — correctness gates never do."""

    def _measurements(self, p99):
        return {
            "flip_lag_p99_ms": p99,
            "flip_lag_p50_ms": p99 / 2,
            "flip_samples": 50,
            "flip_crossings": 10,
            "pace_frac": 1.0,
            "applied_frac": 1.0,
            "converged": True,
            "events_per_sec": 100.0,
            "wrong_verdicts": 0,
            "verdicts_checked": 10,
        }

    def test_slow_host_overshoot_is_advisory_not_enforced(self, monkeypatch):
        from kube_throttler_tpu_torch.scenarios.slo import evaluate_gates

        monkeypatch.delenv("KT_SCENARIO_ENFORCE_LATENCY", raising=False)
        monkeypatch.setenv("KT_SCENARIO_LATENCY_CORE_FLOOR", str(10**6))
        scn = get_scenario("smoke")
        gates = evaluate_gates(scn, self._measurements(scn.slo.flip_p99_ms * 5))
        assert gates["flip_p99"]["pass"]  # advisory, not enforced
        assert "ADVISORY" in gates["flip_p99"]["note"]
        assert "would FAIL" in gates["flip_p99"]["note"]
        # the measured value is still reported for calibration
        assert gates["flip_p99"]["value"] == scn.slo.flip_p99_ms * 5
        # correctness gates stay enforced on any host
        assert gates["verdicts"]["pass"] and gates["ingest_sustain"]["pass"]

    def test_enforce_env_overrides_core_floor(self, monkeypatch):
        from kube_throttler_tpu_torch.scenarios.slo import evaluate_gates

        monkeypatch.setenv("KT_SCENARIO_ENFORCE_LATENCY", "1")
        monkeypatch.setenv("KT_SCENARIO_LATENCY_CORE_FLOOR", str(10**6))
        scn = get_scenario("smoke")
        gates = evaluate_gates(scn, self._measurements(scn.slo.flip_p99_ms * 5))
        assert not gates["flip_p99"]["pass"]

    def test_fast_host_in_bound_has_no_advisory_marker(self, monkeypatch):
        from kube_throttler_tpu_torch.scenarios.slo import evaluate_gates

        monkeypatch.delenv("KT_SCENARIO_ENFORCE_LATENCY", raising=False)
        monkeypatch.setenv("KT_SCENARIO_LATENCY_CORE_FLOOR", "1")
        scn = get_scenario("smoke")
        gates = evaluate_gates(scn, self._measurements(scn.slo.flip_p99_ms / 2))
        assert gates["flip_p99"]["pass"]
        assert "ADVISORY" not in gates["flip_p99"].get("note", "")

    def test_unmeasurable_still_fails_below_floor(self, monkeypatch):
        """Too few flip samples is a trace-content defect, not host
        speed — the unmeasurable branch never degrades to advisory."""
        from kube_throttler_tpu_torch.scenarios.slo import evaluate_gates

        monkeypatch.delenv("KT_SCENARIO_ENFORCE_LATENCY", raising=False)
        monkeypatch.setenv("KT_SCENARIO_LATENCY_CORE_FLOOR", str(10**6))
        scn = get_scenario("smoke")
        m = self._measurements(1.0)
        m["flip_samples"] = 0
        assert not evaluate_gates(scn, m)["flip_p99"]["pass"]

    def test_malformed_floor_env_falls_back(self, monkeypatch):
        from kube_throttler_tpu_torch.scenarios.slo import _latency_gates_enforced

        monkeypatch.delenv("KT_SCENARIO_ENFORCE_LATENCY", raising=False)
        monkeypatch.setenv("KT_SCENARIO_LATENCY_CORE_FLOOR", "many")
        assert _latency_gates_enforced() in (True, False)  # no raise
        monkeypatch.setenv("KT_SCENARIO_LATENCY_CORE_FLOOR", "1")
        assert _latency_gates_enforced()  # every host has ≥1 core

    def test_hunt_inprocess_evaluator_forces_enforcement(
        self, tmp_path, monkeypatch
    ):
        """The hunt DETECTS regressions by latency gates failing —
        advisory mode would hide every planted stall, so the evaluator
        enforces for the duration of the eval (and restores after)."""
        import os as _os

        from kube_throttler_tpu_torch.scenarios.hunt.loop import (
            InProcessEvaluator,
            base_programs,
        )

        monkeypatch.delenv("KT_SCENARIO_ENFORCE_LATENCY", raising=False)
        seen = {}

        def fake_run(scn, seed, wd, device=None):
            seen["enforce"] = _os.environ.get("KT_SCENARIO_ENFORCE_LATENCY")
            seen["device"] = device
            return {"gates": {}}

        monkeypatch.setattr(
            "kube_throttler_tpu_torch.scenarios.engine.run_scenario", fake_run
        )
        out = InProcessEvaluator(str(tmp_path), device="cpu")(base_programs()[0], 0)
        assert out == {"gates": {}}
        assert seen["enforce"] == "1"
        assert seen["device"] == "cpu"
        assert "KT_SCENARIO_ENFORCE_LATENCY" not in _os.environ  # restored

    def test_hunt_subprocess_evaluator_forces_enforcement(
        self, tmp_path, monkeypatch
    ):
        from kube_throttler_tpu_torch.scenarios.hunt import loop as hunt_loop

        monkeypatch.delenv("KT_SCENARIO_ENFORCE_LATENCY", raising=False)
        captured = {}

        def fake_run(cmd, **kw):
            captured["env"] = kw["env"]
            captured["cmd"] = cmd

            class P:
                returncode = 0
                stdout = ""
                stderr = ""

            return P()

        monkeypatch.setattr(hunt_loop.subprocess, "run", fake_run)
        ev = hunt_loop.SubprocessEvaluator(str(tmp_path), device="cpu")
        assert ev(hunt_loop.base_programs()[0], 0) is None  # no report file
        assert captured["env"]["KT_SCENARIO_ENFORCE_LATENCY"] == "1"
        assert captured["cmd"][-2:] == ["--device", "cpu"]


# ------------------------------------------------------- slow: the corpus


@pytest.mark.slow
class TestScenarioCorpus:
    @pytest.mark.parametrize("name", [s.name for s in corpus()])
    def test_corpus_gates_green(self, name, tmp_path):
        """Each corpus scenario in a FRESH interpreter (sequential
        in-process runs contaminate each other's heaps — see
        scenarios/__main__._run_isolated). ``make scenario-test`` runs
        the full 3-seed matrix; this slow-tier pass pins seed 0."""
        import json
        import os
        import subprocess
        import sys

        env = dict(os.environ)
        proc = subprocess.run(
            [
                sys.executable, "-m", "kube_throttler_tpu_torch.scenarios", "run",
                "--name", name, "--seed", "0", "--workdir", str(tmp_path),
                "--device", "cpu",
            ],
            capture_output=True, text=True, timeout=1200, env=env,
        )
        report_path = tmp_path / f"report-{name}-s0.json"
        assert report_path.exists(), proc.stdout[-3000:]
        with open(report_path) as f:
            report = json.load(f)
        assert report["all_pass"], {
            k: g for k, g in report["gates"].items() if not g["pass"]
        }
