"""The ``clusterthrottles-1k`` configuration (BASELINE config 3: OR-ed
namespaceSelector ∧ podSelector terms) against the program on the CPU at
tiny sizes and against its own control at full size, the
``first_term_only`` control, and the readers of the per-kind merge and
launch spans its cell reports."""

from __future__ import annotations

import copy
from datetime import datetime, timezone

import numpy as np
import pytest

from gpubench import adapter, cluster as cluster_mod, run, terms_control
from gpubench.drivers import triage
from gpubench.drivers.common import map_mismatches, reference_states
from gpubench.reference import semantics as S
from gpubench.tests.test_gpubench_faults import _flip_one, _half
from gpubench.tests.test_gpubench_isolation import JAX_SIDE, PROGRAM, _modules_after
from gpubench.tests.test_gpubench_reference import (
    test_every_status_occurs_at_full_size as every_status_occurs_at_full_size,
    test_pairs_and_statuses_equal_the_programs_oracle as pairs_and_statuses_equal_the_oracle,
)
from gpubench.tests.tiny import SEED, tiny_cell

CONFIG = "clusterthrottles-1k"
CELL = f"{CONFIG}.triage"
NEW = ("merge_clusterthrottle_ms.triage", "merge_throttle_ms.triage",
       "merge_ns_route_ms.triage", "launch_clusterthrottle_ms.triage")
MERGE_PARTS = NEW[:3]
# the first cell's readers this cell reports too (the listing's is silent here)
SHARED = ("dedupe_ms.triage", "merge_ms.triage", "dispatch_ms.triage", "device_roofline.triage",
          "device_idle_pct.triage", "handles_ms.triage", "gc_pause_ms.triage")


def dense_tiny_cell():
    """``tiny_cell(CELL)`` with 3 teams instead of 100, so that the tiny
    cluster's 6 namespaces are selected by many of its 40 ClusterThrottles
    through either term (with 100 teams few select any)."""
    cell = tiny_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["namespaces"]["labels"]["team"]["values"] = 3
    return cell


def _plugin_cls():
    from kube_throttler_tpu_torch.plugin import KubeThrottler

    return KubeThrottler


@pytest.fixture
def device_route(monkeypatch):
    """The dedupe probe declines, so a tiny run takes the device dispatch
    and the merge, the route the full-size cell takes."""
    monkeypatch.setattr(_plugin_cls(), "BATCH_DEDUPE_MAX_PODS", 0)


# --------------------------------------------------------- the configuration


def test_the_configuration_is_listed_with_its_cell():
    cell = run.resolve_cell(CELL)
    assert cell.config["name"] == CONFIG and cell.config["reduced"] == []
    assert cell.config["control"] == terms_control.FIRST_TERM_ONLY
    terms = cell.config["cluster_throttles"]["terms"]
    assert len(terms) == 2 and all("namespace" in term for term in terms)
    assert cell.traffic["driver"] == "triage"


@pytest.mark.parametrize("seed", [SEED, 7, 2**31 + 3])
def test_pairs_and_statuses_equal_the_programs_oracle(seed):
    pairs_and_statuses_equal_the_oracle(CONFIG, seed)


def test_every_status_occurs_at_full_size():
    every_status_occurs_at_full_size(CONFIG)


def test_full_size_mask_takes_the_gather_route():
    """Each pod matches about 5.9 ClusterThrottles and the widest row at
    most 16, so the kind's match width K stays far under a quarter of its
    1,024 columns (the gather route's condition)."""
    cl = cluster_mod.generate(cluster_mod.load_config(CONFIG), SEED)
    ks = S.kind_state(cl.cluster_throttles, cl.pods, cl.namespaces, datetime.now(timezone.utc))
    per_pod = np.bincount(ks.pairs[0], minlength=len(cl.pods.names))
    assert 5.0 < per_pod.mean() < 7.0
    K = 4  # the mirror's width: the power of two at or above the widest row
    while K < per_pod.max():
        K *= 2
    assert K <= 32 and 4 * K < 1024


# ------------------------------------------------------------ the whole run


@pytest.mark.parametrize("make", [lambda: tiny_cell(CELL), dense_tiny_cell])
@pytest.mark.parametrize("probe", ["grouped", "declined"])
def test_whole_run_is_correct_on_the_cpu(make, probe, monkeypatch):
    if probe == "declined":
        monkeypatch.setattr(_plugin_cls(), "BATCH_DEDUPE_MAX_PODS", 0)
    out = run.run_cell(make(), SEED, 0.3, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_the_clusterthrottle_kind_takes_the_gather_route(device_route):
    """As at full size, where each pod matches a few of 1,000 (the dense
    tiny cell's pods match too many of its 40 for the gather route)."""
    cl = cluster_mod.generate(tiny_cell(CELL).config, SEED)
    _, plugin = adapter.build_plugin(cl, "cpu")
    try:
        plugin.pre_filter_batch()
        dm = plugin.device_manager
        assert dm.last_batch_routes["clusterthrottle"] == "sparse"
        assert dm.batch_width_gauge.get({"kind": "clusterthrottle"}) >= 4
    finally:
        plugin.stop()


@pytest.mark.parametrize("fault", [_half, _flip_one])
def test_triage_fault_is_not_correct(fault, monkeypatch):
    cls = _plugin_cls()
    real = cls.pre_filter_batch
    monkeypatch.setattr(cls, "pre_filter_batch", lambda self: fault(real(self)))
    assert run.run_cell(dense_tiny_cell(), SEED, 0.3, False, "cpu")["correct"] is False


def test_a_whole_run_loads_no_jax_side():
    mods = _modules_after(
        "from gpubench import run\n"
        "from gpubench.tests.test_gpubench_clusterthrottles import dense_tiny_cell\n"
        "assert run.run_cell(dense_tiny_cell(), 5, 0.3, False, 'cpu')['correct']"
    )
    assert PROGRAM in mods
    assert not mods & JAX_SIDE, mods & JAX_SIDE


# -------------------------------------------------------------- the control


def test_first_term_only_is_not_correct_at_full_size():
    cl = cluster_mod.generate(cluster_mod.load_config(CONFIG), SEED)
    want = S.verdicts(reference_states(cl), cl.pods, cl.namespaces)
    cut = terms_control.first_term_only(cl)
    got = S.verdicts(reference_states(cut), cut.pods, cut.namespaces)
    assert map_mismatches(got, want) > 1000
    assert cl.cluster_throttles.terms[0][1].namespace  # the whole cluster is left as it was


@pytest.mark.parametrize("seed", [7, 11])
def test_first_term_only_reads_mismatches_on_the_tiny_cell(seed):
    """At 72 pods a seed may give no restrictive ClusterThrottle a pod
    that only its second term selects (``SEED`` gives none, seed 7 gives
    19 such verdicts); at full size every seed reads thousands."""
    cell = dense_tiny_cell()
    cell.driver = terms_control.with_control(cell.driver)
    out = run.run_cell(cell, seed, 0.3, False, "cpu", control=terms_control.FIRST_TERM_ONLY)
    assert out["correct"], out["checks"]
    assert out["control_checks"]["verdict_mismatches"]["value"] > 0


def test_main_is_gpubench_controls_with_the_cut(monkeypatch):
    """``terms_control.main`` runs ``gpubench.control``'s main, whose cells
    resolve with the wrapped driver, and leaves the harness as it was."""
    from gpubench import control

    seen = {}

    def main(argv):
        seen["argv"], seen["driver"] = argv, run.resolve_cell(CELL).driver
        return 0

    monkeypatch.setattr(control, "main", main)
    plain = run.resolve_cell
    argv = ["--workload", CELL, "--seconds", "1", "--seeds", "3"]
    assert terms_control.main(argv) == 0
    assert run.resolve_cell is plain and seen["argv"] == argv
    assert seen["driver"].Driver.__qualname__ == "with_control.<locals>.Driver"


@pytest.mark.parametrize("control", [None, "ignore_overrides"])
def test_other_controls_pass_through_on_throttles_100k(control):
    """On the other configuration the wrapped driver judges as the plain
    one does; and with single-term throttles the cut changes nothing."""
    cl = cluster_mod.generate(tiny_cell("throttles-100k.triage").config, SEED)
    right = S.verdicts(reference_states(cl), cl.pods, cl.namespaces)
    wrong = dict(right, **{k: not v for k, v in list(right.items())[:3]})
    plain = triage.Driver(cl, None, None, {}, SEED, 0.0)
    wrapped = terms_control.with_control(triage).Driver(cl, None, None, {}, SEED, 0.0)
    for drv in (plain, wrapped):
        drv.outputs = [{"schedulable": right, "errors": []},
                       {"schedulable": wrong, "errors": []}]
    assert wrapped.check(control=control) == plain.check(control=control)
    assert (wrapped.check(control=terms_control.FIRST_TERM_ONLY)
            == plain.check(control=None) == {"verdict_mismatches": {"value": 3, "limit": 0}})


# -------------------------------------------------------------- the readers


def _reader(name):
    return run.load_module(run.PKG / "metrics" / f"{name}.py")


def test_the_cells_entries_name_the_readers():
    cell = run.resolve_cell(CELL)
    entries = {entry["name"]: (entry, reader) for entry, reader in cell.per_layer}
    assert set(entries) == set(NEW) | set(SHARED)
    for name in NEW:
        entry, reader = entries[name]
        assert entry["source"] == "program_span" and entry["moves"] == "triage_pods_per_s"
        assert entry["workloads"] == [CELL]
        assert reader.SPANS
    for name in SHARED:
        assert entries[name][0]["workloads"] == ["throttles-100k.triage", CELL]
    assert {n for n, (e, _) in entries.items()
            if e["layer"] == "plugin"} == set(MERGE_PARTS) | {"dedupe_ms.triage", "merge_ms.triage"}


def test_a_traced_run_carries_the_new_metrics(device_route):
    cell = dense_tiny_cell()
    cell.per_layer = run.resolve_cell(CELL).per_layer
    out = run.run_cell(cell, SEED, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in NEW:
        assert m[name] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
    assert sum(m[name] for name in MERGE_PARTS) <= m["merge_ms.triage"]
    assert m["launch_clusterthrottle_ms.triage"] <= m["dispatch_ms.triage"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_nothing(name):
    reader = _reader(name)
    rec = run.RunRecord(calls=3, spans={phase: (0.0, 0) for phase in reader.SPANS})
    assert reader.read(rec) is None
    assert reader.read(run.RunRecord(calls=3)) is None
