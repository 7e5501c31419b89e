"""The chip smoke's ``[props]`` and ``[soak]`` phases rehearsed on the CPU:
``chip_smoke.drive_props`` with a quarter of each property's examples and
``chip_smoke.drive_soak`` over the pinned seeds (both set through the
smoke's own PROPS and SOAK_MAX_SEEDS), in this process. On the
CPU the wrappers run their plain versions, so no kernel launch is counted
and the kernel-against-plain comparisons hold trivially; what this holds
is that the phases' strategies draw, their oracles agree (the single cell
against the ordered 4-state oracle, the victim problems against the
sequential host oracle, the device stack's batch against the host
stack's) and their lines carry what the smoke's kernels line reads."""

import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    return chip_smoke


def test_props_phase_on_the_cpu(chip_smoke, capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke, "PROPS", tuple(
        (name, kernel, max(1, examples // 4)) for name, kernel, examples in chip_smoke.PROPS))
    out = chip_smoke.drive_props(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    per_property = [x for x in lines if x.startswith("[props] property=")]
    assert len(per_property) == len(chip_smoke.PROPS)
    assert all("mismatches=0" in x for x in lines if "mismatches=" in x)
    routes = next(x for x in lines if "victim_routes=" in x)
    assert all(f'"{r}"' in routes
               for r in ("warp", "ring", "wide_regs", "wide_smem", "wide_device"))
    assert set(out["kernels"]) == {"check_dense", "check_gather", "victim_select"}
    assert set(out["kernels"]["check_gather"]["launches"]) == {"check_gather",
                                                               "pack_gather_rows"}
    for name, _, examples in chip_smoke.PROPS:
        assert any(re.search(rf"property={name} .*examples=[1-9]", x) for x in per_property)


def test_soak_phase_on_the_cpu(chip_smoke, capsys, monkeypatch):
    _, ts = chip_smoke.property_helpers()
    monkeypatch.setattr(chip_smoke, "SOAK_MAX_SEEDS", len(ts.PINNED_SEEDS))
    out = chip_smoke.drive_soak(device="cpu")
    assert out["seeds"] == list(ts.PINNED_SEEDS) and out["cut"] == []
    assert out["checkpoints"] == 11 * len(ts.PINNED_SEEDS)
    (line,) = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[soak]")]
    assert "mismatches=0" in line and "cut=0" in line


def test_soak_phase_cuts_only_seeds_past_the_pinned(chip_smoke, capsys, monkeypatch):
    _, ts = chip_smoke.property_helpers()
    seeds = chip_smoke.soak_seeds()
    assert len(seeds) == chip_smoke.SOAK_MAX_SEEDS == len(set(seeds))
    assert seeds[:4] == list(ts.PINNED_SEEDS) and seeds[4:7] == [4, 5, 6]
    monkeypatch.setattr(chip_smoke, "SOAK_MAX_SEEDS", 6)
    monkeypatch.setattr(chip_smoke, "SOAK_BUDGET_S", 0.0)
    out = chip_smoke.drive_soak(device="cpu")
    assert out["seeds"] == list(ts.PINNED_SEEDS) and out["cut"] == seeds[4:6]


def test_victim_routes_are_the_launch_shapes_routes(chip_smoke):
    tp, _ = chip_smoke.property_helpers()
    for route, (lo, hi) in tp.VICTIM_ROUTES.items():
        assert tp.victim_route(lo) == tp.victim_route(hi) == route
    ends = sorted(tp.VICTIM_ROUTES.values())
    assert ends[0][0] == 1
    assert all(a[1] + 1 == b[0] for a, b in zip(ends, ends[1:]))


def test_soak_phase_counts_a_divergence_and_fails(chip_smoke, capsys, monkeypatch):
    _, ts = chip_smoke.property_helpers()
    monkeypatch.setattr(chip_smoke, "SOAK_MAX_SEEDS", len(ts.PINNED_SEEDS))

    def diverge(seed, stacks, batch=False):
        raise AssertionError(f"seed {seed}")

    monkeypatch.setattr(ts, "churn", diverge)
    with pytest.raises(chip_smoke.SmokeFailure, match="seed 1 diverged"):
        chip_smoke.drive_soak(device="cpu")
    (line,) = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[soak]")]
    assert "mismatches=1" in line
