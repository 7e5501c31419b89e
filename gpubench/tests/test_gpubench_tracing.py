"""The readers of the program's triage spans and collector pauses: a
traced run on the CPU carries them beside the spans they nest in, and a
record without them (a program that lacks the spans or the accounting)
gives nothing."""

from __future__ import annotations

import pytest

from gpubench import run
from gpubench.tests.tiny import ROOT, SEED, tiny_cell

NEW = ("list_pods_ms.triage", "handles_ms.triage", "gc_pause_ms.triage")


def _reader(name):
    return run.load_module(ROOT / "gpubench" / "metrics" / f"{name}.py")


def test_a_traced_run_carries_the_new_metrics(monkeypatch):
    from kube_throttler_tpu_torch.plugin import KubeThrottler

    monkeypatch.setattr(KubeThrottler, "BATCH_DEDUPE_MAX_PODS", 0)  # the full-size route
    cell = tiny_cell("throttles-100k.triage")
    cell.per_layer = run.resolve_cell("throttles-100k.triage").per_layer
    out = run.run_cell(cell, SEED, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in NEW:
        assert m[name] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
    assert m["list_pods_ms.triage"] <= m["dedupe_ms.triage"]
    assert m["handles_ms.triage"] <= m["dispatch_ms.triage"]
    labels = [label for label, _ in out["breakdown"]["idle_gaps"]]
    assert any(label.startswith("list_pods:") for label in labels), labels


def test_the_cells_entries_name_the_readers():
    cell = run.resolve_cell("throttles-100k.triage")
    entries = {entry["name"]: (entry, reader) for entry, reader in cell.per_layer}
    for name in NEW:
        entry, reader = entries[name]
        assert entry["source"] == "program_span" and entry["moves"] == "triage_pods_per_s"
        assert reader.SPANS


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_nothing(name):
    reader = _reader(name)
    rec = run.RunRecord(calls=3, spans={phase: (0.0, 0) for phase in reader.SPANS})
    assert reader.read(rec) is None
    assert reader.read(run.RunRecord(calls=3)) is None


def test_pauses_are_summed_over_generations_per_call():
    rec = run.RunRecord(calls=4, spans={"gc_gen0": (0.01, 40), "gc_gen1": (0.03, 4),
                                        "gc_gen2": (0.0, 0)})
    assert _reader("gc_pause_ms.triage").read(rec) == pytest.approx(10.0)
