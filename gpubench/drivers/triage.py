"""Bulk admission triage: one caller calls ``pre_filter_batch`` back to
back on a static store, as a scheduler triages its backlog between
reconciles. A unit is a pod given a verdict. Every call's output is kept
and, once the window has closed, each distinct one is compared with the
reference's verdict for every pod (and an empty error list)."""

from __future__ import annotations

from gpubench import roofline
from gpubench.drivers.common import distinct, map_mismatches, reference_states
from gpubench.reference.semantics import verdicts


class Driver:
    def __init__(self, cluster, store, plugin, params, seed, seconds):
        self.cluster, self.plugin, self.params = cluster, plugin, params
        self.outputs = []
        self.calls = self.failed = 0

    def warm(self) -> None:
        self.plugin.pre_filter_batch()

    def step(self) -> int:
        out = self.plugin.pre_filter_batch()
        self.outputs.append(out)
        self.calls += 1
        return len(out["schedulable"]) + len(out["errors"])

    def release(self) -> None:
        self.plugin = None

    def end_to_end(self, units: int, elapsed_s: float) -> dict:
        return {"triage_pods_per_s": (units / elapsed_s, "pods/s")}

    def check(self, control=None) -> dict:
        states = reference_states(self.cluster, control=control)
        want = verdicts(states, self.cluster.pods, self.cluster.namespaces)
        bad = 0
        outs = distinct(self.outputs)
        for out in outs:
            bad += map_mismatches(out["schedulable"], want) + len(out["errors"])
        self._states = states
        return {"verdict_mismatches": {"value": bad, "limit": 0}}

    def least_s(self, card: str):
        return roofline.least_s(*roofline.check_work(self._states, self.cluster.pods), card)
