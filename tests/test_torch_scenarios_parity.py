"""The port's scenario engine held against the JAX package's, exactly.

- Every scenario of the corpus (``SCENARIOS``: the replay corpus with its
  smoke entry, plus the entries that dedicated runners replay) compiles,
  at seeds 0 and 1, to the same trace bytes, the same topology and the
  same canonical fault plan in both packages.
- The hunt's mutator children and a shrink under a stub evaluator carry
  the same content addresses (``program_sha``) in both packages.
- The port's ``run_scenario`` of ``smoke`` on ``device="cpu"``: at
  quiescence its serving plugin's batch verdicts equal those of the JAX
  package's ``KubeThrottler(use_device=True)`` (on its CPU backend) built
  over the same apiserver objects, each decoded by its own package's
  ``api/serialization``.
- The preemption storm's in-situ sweep (the ``victim_select`` wrapper ≡
  the sequential oracle) passes on CPU tensors.
- The regression corpus ships with the port's package.

There is no tolerance anywhere: every comparison is equality.
"""

from __future__ import annotations

import importlib

import pytest

import kube_throttler_tpu.api.serialization as jser
import kube_throttler_tpu.engine.store as jstore
import kube_throttler_tpu.plugin as jplugin
import kube_throttler_tpu.scenarios.hunt.loop as jloop
import kube_throttler_tpu.scenarios.trace as jtrace
import kube_throttler_tpu_torch.api.serialization as tser
import kube_throttler_tpu_torch.scenarios.hunt.loop as tloop
import kube_throttler_tpu_torch.scenarios.trace as ttrace
from kube_throttler_tpu.scenarios.corpus import SCENARIOS as J_SCENARIOS
from kube_throttler_tpu.scenarios.corpus import load_regressions as j_load_regressions
from kube_throttler_tpu_torch.scenarios.corpus import SCENARIOS as T_SCENARIOS
from kube_throttler_tpu_torch.scenarios.corpus import corpus as t_corpus
from kube_throttler_tpu_torch.scenarios.corpus import load_regressions as t_load_regressions
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

# the hunt package re-exports its functions ``mutate`` and ``shrink`` under
# the names of their modules, so the modules come through importlib
jmutate = importlib.import_module("kube_throttler_tpu.scenarios.hunt.mutate")
jshrink = importlib.import_module("kube_throttler_tpu.scenarios.hunt.shrink")
tmutate = importlib.import_module("kube_throttler_tpu_torch.scenarios.hunt.mutate")
tshrink = importlib.import_module("kube_throttler_tpu_torch.scenarios.hunt.shrink")

ARGS = {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}


def test_the_corpus_is_the_same_list():
    assert list(T_SCENARIOS) == list(J_SCENARIOS)
    assert {s.name for s in t_corpus(include_smoke=True)} <= set(T_SCENARIOS)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(J_SCENARIOS))
def test_trace_topology_and_fault_plan_are_identical(name, seed):
    port, ref = T_SCENARIOS[name], J_SCENARIOS[name]
    assert ttrace.serialize_trace(*ttrace.build_trace(port, seed)) == (
        jtrace.serialize_trace(*jtrace.build_trace(ref, seed))
    )
    assert ttrace.build_topology(port, seed) == jtrace.build_topology(ref, seed)
    assert ttrace.canonical_fault_plan(port) == jtrace.canonical_fault_plan(ref)


def _parents():
    """(port, reference) pairs: the hunt's base programs and its planted
    bug, each built by its own package."""
    pairs = list(zip(tloop.base_programs(), jloop.base_programs()))
    pairs.append((tloop.planted_bug_program(), jloop.planted_bug_program()))
    return pairs


@pytest.mark.parametrize("seed", range(5))
def test_mutator_children_have_the_same_program_sha(seed):
    for port, ref in _parents():
        assert tmutate.program_sha(port) == jmutate.program_sha(ref)
        child_t = tmutate.mutate(port, seed)
        child_j = jmutate.mutate(ref, seed)
        assert child_t.name == child_j.name
        assert tmutate.program_sha(child_t) == jmutate.program_sha(child_j)
        assert ttrace.serialize_trace(*ttrace.build_trace(child_t, 0)) == (
            jtrace.serialize_trace(*jtrace.build_trace(child_j, 0))
        )


def _stub(program_sha):
    """The hunt tests' synthetic model: a program fails flip_p99 iff it
    stalls status PUTs for ≥ 200 ms."""

    def evaluate(scn, seed):
        buggy = any(
            f.site == "mock.status.delay" and f.delay >= 0.2 for f in scn.faults
        )
        return {
            "scenario": scn.name,
            "all_pass": not buggy,
            "gates": {
                "flip_p99": {"pass": not buggy, "value": 2000 if buggy else 20, "bound": 250},
                "verdicts": {"pass": True, "value": {"wrong": 0}, "bound": 0},
            },
            "trace_sha256": program_sha(scn),
        }

    return evaluate


def _camouflaged(loop_mod, mutate_mod, dsl_mod):
    from dataclasses import replace

    base = loop_mod.base_programs()[1]
    return mutate_mod.normalize(replace(
        base,
        pattern="drain",
        faults=(
            dsl_mod.FaultSpec(site="mock.status.delay", mode="delay",
                              delay=0.3, window=(0.2, 2.0)),
            dsl_mod.FaultSpec(site="mock.watch.cut", mode="close",
                              window=(0.5, 1.5), probability=0.1),
            dsl_mod.FaultSpec(site="scenario.apiserver.restart",
                              mode="restart", t=1.0),
        ),
    ))


def test_shrink_under_a_stub_evaluator_is_identical():
    import kube_throttler_tpu.scenarios.dsl as jdsl
    import kube_throttler_tpu_torch.scenarios.dsl as tdsl

    res_t = tshrink.shrink(
        _camouflaged(tloop, tmutate, tdsl), 0, _stub(tmutate.program_sha),
        target_gates=["flip_p99"], max_attempts=40,
    )
    res_j = jshrink.shrink(
        _camouflaged(jloop, jmutate, jdsl), 0, _stub(jmutate.program_sha),
        target_gates=["flip_p99"], max_attempts=40,
    )
    assert tmutate.program_sha(res_t["program"]) == jmutate.program_sha(res_j["program"])
    assert (res_t["size"], res_t["steps"], res_t["failed_gates"]) == (
        res_j["size"], res_j["steps"], res_j["failed_gates"]
    )
    assert res_t["history"] == res_j["history"]


def _jax_plugin_over(remote):
    """The JAX package's served stack over the port apiserver's objects,
    each decoded from its manifest dict by the JAX package's own
    serialization, statuses included."""
    store = jstore.Store()
    for ns in remote.list_namespaces():
        store.create_namespace(jser.object_from_dict(tser.object_to_dict(ns)))
    for thr in remote.list_throttles():
        store.create_throttle(jser.object_from_dict(tser.object_to_dict(thr)))
    for thr in remote.list_cluster_throttles():
        store.create_cluster_throttle(jser.object_from_dict(tser.object_to_dict(thr)))
    for pod in remote.list_pods():
        store.create_pod(jser.object_from_dict(tser.object_to_dict(pod)))
    return jplugin.KubeThrottler(
        jplugin.decode_plugin_args(ARGS), store, use_device=True, start_workers=False
    )


def test_smoke_run_serves_the_jax_verdicts(tmp_path, monkeypatch):
    from kube_throttler_tpu_torch.scenarios import engine
    from kube_throttler_tpu_torch.scenarios.corpus import get_scenario

    # the engine's verdict sweep runs at quiescence: keep a handle on the
    # stack there, and keep the stack up past the report
    stacks = []
    sweep = engine._Engine.verdict_sweep

    def keep(self):
        stacks.append(self)
        return sweep(self)

    monkeypatch.setattr(engine._Engine, "verdict_sweep", keep)
    # without the verdict cache both plugins' batches take the device route
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    report = engine.run_scenario(
        get_scenario("smoke"), 0, str(tmp_path), device="cpu", keep_stack=True
    )
    eng = stacks[0]
    ref = None
    try:
        assert report["measurements"]["wrong_verdicts"] == 0
        assert eng.device.type == "cpu"
        assert eng.plugin.device_manager.device.type == "cpu"
        served = eng.plugin.pre_filter_batch()
        assert eng.plugin.device_manager.last_batch_routes["throttle"] == "sparse"
        ref = _jax_plugin_over(eng.remote)
        want = ref.pre_filter_batch()
        assert len(served["schedulable"]) == report["measurements"]["verdicts_checked"]
        assert served["schedulable"] == want["schedulable"]
        assert sorted(served["errors"]) == sorted(want["errors"])
        # both sides judged something: smoke's flip band leaves some pods
        # throttled and some schedulable
        assert set(served["schedulable"].values()) == {True, False}
    finally:
        if ref is not None:
            ref.stop()
        eng.teardown()


@pytest.mark.parametrize("seed", range(4))
def test_preemption_oracle_sweep_passes_on_cpu_tensors(seed):
    from kube_throttler_tpu_torch.scenarios.preemption import _oracle_sweep

    assert _oracle_sweep(seed, device="cpu")


def test_the_regression_corpus_ships_with_the_port():
    import tomllib
    from pathlib import Path

    pyproject = tomllib.loads(
        (Path(__file__).resolve().parent.parent / "pyproject.toml").read_text()
    )
    package_data = pyproject["tool"]["setuptools"]["package-data"]
    assert package_data["kube_throttler_tpu_torch.scenarios"] == ["corpus/regressions/*.json"]
    port, ref = t_load_regressions(), j_load_regressions()
    assert [e["name"] for e in port] == ["hunt-1f81ec0658fb"]
    assert [(e["name"], e["seed"], e["expect"]) for e in port] == [
        (e["name"], e["seed"], e["expect"]) for e in ref
    ]
    assert tmutate.program_sha(port[0]["scenario"]) == jmutate.program_sha(ref[0]["scenario"])
