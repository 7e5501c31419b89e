"""Cluster-scale scenario engine: trace-driven storms, SLO gates, and a
replayable corpus (docs/scenarios.md).

Composition: a :class:`~.dsl.Scenario` (arrival process × object topology
× fault schedule) compiles to a committed byte-deterministic trace
(trace.py), replays through the real remote-mode stack — mock apiserver →
reflectors → micro-batched ingest → controllers → device planes → async
committer — (engine.py), and is judged by per-scenario SLO gates
(slo.py): flip p99, ingest sustain, bounded post-restart recovery, zero
wrong admission verdicts, bounded leader failover.

CLI: ``python -m kube_throttler_tpu_torch.scenarios`` (``make scenario-test``
runs the corpus matrix). Heavy imports stay inside the submodules — this
package root is import-cheap for the analyzer and the test collector.
"""

from .dsl import Arrival, FaultSpec, Scenario, SloGates, Topology  # noqa: F401
from .corpus import SCENARIOS, corpus, get_scenario  # noqa: F401

__all__ = [
    "Arrival",
    "FaultSpec",
    "Scenario",
    "SloGates",
    "Topology",
    "SCENARIOS",
    "corpus",
    "get_scenario",
]
