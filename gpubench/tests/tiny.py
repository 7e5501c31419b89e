"""Cells of the benchmark cut to a size a CPU test run holds, with the
structure of their configuration and mix kept."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import cluster as cluster_mod, run  # noqa: E402

FIXTURES = Path(__file__).resolve().parent  # configs/<name>.json: test data, no cell
SEED = 2**33 + 17  # wider than 32 bits, as the benchmark's seeds are


def tiny_cell(name: str) -> "run.Cell":
    """The cell ``<config>.<traffic>`` (listed in BENCHMARK.json or not;
    the configuration from ``configs/`` or the tests' own): 6 namespaces
    of 12 pods (8 Running), 4 Throttles a namespace, 40 ClusterThrottles
    where the configuration has many, 4 override windows."""
    config, _, traffic = name.partition(".")
    fixture = (FIXTURES / "configs" / f"{config}.json").exists()
    cell = run.make_cell(name, "throttles-100k" if fixture else config, traffic)
    c = copy.deepcopy(cluster_mod.load_config(config, FIXTURES) if fixture else cell.config)
    c["namespaces"]["count"] = 6
    c["pods"]["per_namespace"], c["pods"]["running"] = 12, 8
    if "per_namespace" in c["throttles"]:
        c["throttles"]["per_namespace"] = max(1, min(4, c["throttles"]["per_namespace"]))
    if "overrides" in c["throttles"]:
        c["throttles"]["overrides"]["count"] = 4
    c["cluster_throttles"]["count"] = min(40, c["cluster_throttles"]["count"])
    cell.config = c
    return cell


def run_tiny(name: str, seed: int = SEED, seconds: float = 0.3, trace: bool = False) -> dict:
    return run.run_cell(tiny_cell(name), seed, seconds, trace, "cpu")
