"""The check that decides ``correct`` catches what it is there for.

Each test drives the rest of a run on the CPU at a tiny size, skipping
only the look for a card, with the timed path broken underneath, and
sees ``correct`` come out false: half of the batch left out and an
answer altered where it is produced. (The triage cell keeps no state from
step to step, so it has no step that could return its state unchanged;
it runs on one card, so no exchange between cards exists to leave out.)
The control test holds the reference with the configuration's stated
guarantee broken against the reference at the full size, where the
control has to come out not correct."""

from __future__ import annotations

from datetime import datetime, timezone

import pytest

from gpubench import cluster as cluster_mod
from gpubench.drivers.common import map_mismatches
from gpubench.reference import semantics as S
from gpubench.tests.tiny import SEED, run_tiny


def _plugin_cls():
    from kube_throttler_tpu_torch.plugin import KubeThrottler

    return KubeThrottler


def _half(out: dict) -> dict:
    keys = sorted(out["schedulable"])
    return dict(out, schedulable={k: out["schedulable"][k] for k in keys[::2]})


def _flip_one(out: dict) -> dict:
    sched = dict(out["schedulable"])
    k = sorted(sched)[0]
    sched[k] = not sched[k]
    return dict(out, schedulable=sched)


@pytest.mark.parametrize("fault", [_half, _flip_one])
@pytest.mark.parametrize("cell", ["throttles-100k.triage", "selector-terms.triage"])
def test_triage_fault_is_not_correct(cell, fault, monkeypatch):
    cls = _plugin_cls()
    real = cls.pre_filter_batch
    monkeypatch.setattr(cls, "pre_filter_batch", lambda self: fault(real(self)))
    assert run_tiny(cell)["correct"] is False


# ---------------------------------------------------------------- controls


def _states(cl, control=None):
    now = datetime.now(timezone.utc)
    return [S.kind_state(ts, cl.pods, cl.namespaces, now, control)
            for ts in (cl.throttles, cl.cluster_throttles)]


def test_triage_control_is_not_correct():
    cfg = cluster_mod.load_config("throttles-100k")
    cl = cluster_mod.generate(cfg, SEED)
    want = S.verdicts(_states(cl), cl.pods, cl.namespaces)
    got = S.verdicts(_states(cl, cfg["control"]), cl.pods, cl.namespaces)
    assert map_mismatches(got, want) > 0
