"""Coverage-guided adversarial scenario search over the scenario DSL.

The scenario engine replays the scenarios somebody wrote; production breaks
systems with the scenario nobody wrote. This package searches the
(arrival × topology × fault-schedule) space for it:

- **mutate.py** — seeded, pure-function mutations of ``dsl.Scenario``
  programs. ``mutate(program, seed)`` is byte-deterministic: the child is
  a pure function of (program content, seed), children are
  content-addressed (``hunt-<sha12>`` names), and every child preserves
  the trace property (``build_trace`` purity holds for any valid
  program, so same child + same trace seed ⇒ identical trace bytes).
- **coverage.py** — the novelty signal: a run fingerprints as the set of
  fired fault sites (log-bucketed hit counts), ``kube_throttler_*``
  metric-family deltas, and health-component state transitions (the
  engine's structured ``report["fingerprint"]``). The corpus keeps only
  children that reach coverage nobody reached before, weighted by how
  much new behavior they found.
- **shrink.py** — when a run fails an SLO gate (or the zero-wrong-verdicts
  sweep trips), bisect the program — drop faults, strip pattern/arrival
  structure, shed topology mass, shorten — re-replaying each candidate in
  a FRESH interpreter; byte-determinism makes every re-replay exact, so
  shrinking is sound. The minimal repro is promoted into
  ``scenarios/corpus/regressions/`` as a permanent tier gate
  (corpus.load_regressions).
- **loop.py** — the budgeted search loop + coverage-report artifact.
- **longhorizon.py** — the multi-virtual-day soak tier (diurnal day
  cycles, restart waves, durability churn, the 1M-pod columnar rung).

Drivers: ``make scenario-hunt`` (budgeted random search),
``make scenario-hunt-smoke`` (CI: planted-bug find → shrink → promote),
``make scenario-hunt-long`` (the long-horizon tier).
"""

from .coverage import CoverageMap, fingerprint_keys  # noqa: F401
from .mutate import MUTABLE_FAULT_SITES, mutate, program_sha, program_size  # noqa: F401
from .shrink import shrink  # noqa: F401

__all__ = [
    "CoverageMap",
    "MUTABLE_FAULT_SITES",
    "fingerprint_keys",
    "mutate",
    "program_sha",
    "program_size",
    "shrink",
]
