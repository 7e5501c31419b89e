"""The hunt's coverage signal: run fingerprints → novelty accounting.

A run's behavior is fingerprinted by the engine's structured
``report["fingerprint"]`` (scenarios/engine.py): which fault sites
actually fired and how often, which ``kube_throttler_*`` metric families
the run moved, and which health-component state transitions it drove.
``fingerprint_keys`` flattens that into a set of discrete coverage keys:

- ``fault:<site>:<bucket>`` — fired sites, hit counts log2-bucketed
  (1, 2, 4, 8, …) so "fired a lot more" is new coverage but "fired 37 vs
  38 times" is not;
- ``metric:<family>`` — a family whose series/values moved during the
  run (post-convergence baseline delta);
- ``health:<component>:<old>-><new>`` — an observed state transition;
- ``gate:<name>:<pass|fail>`` — each SLO gate's verdict (a mutant that
  makes a *different gate* fail is novel even at equal fault coverage).

``CoverageMap`` is the accumulator: ``observe(keys)`` returns how many
keys were globally new — the child's novelty score, the corpus
admission criterion, and its priority-queue weight in the loop.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List

__all__ = ["CoverageMap", "fingerprint_keys", "hit_bucket"]


def hit_bucket(hits: int) -> int:
    """Log2 bucket of a hit count: 0→0, 1→1, 2-3→2, 4-7→4, 8-15→8, …"""
    if hits <= 0:
        return 0
    b = 1
    while b * 2 <= hits:
        b *= 2
    return b


def fingerprint_keys(report: Dict) -> FrozenSet[str]:
    """Flatten one run report (engine schema) into coverage keys."""
    keys = set()
    fp = report.get("fingerprint") or {}
    for site, hits in (fp.get("fault_sites") or {}).items():
        keys.add(f"fault:{site}:{hit_bucket(int(hits))}")
    for family in fp.get("metric_families") or {}:
        keys.add(f"metric:{family}")
    for item in fp.get("health_transitions") or []:
        comp, old, new = item[0], item[1], item[2]
        keys.add(f"health:{comp}:{old}->{new}")
    for gate, g in (report.get("gates") or {}).items():
        keys.add(f"gate:{gate}:{'pass' if g.get('pass') else 'fail'}")
    return frozenset(keys)


class CoverageMap:
    """Global coverage accumulator. Single-threaded by design (the hunt
    loop is sequential — one fresh-interpreter evaluation at a time, so
    coverage order is deterministic given the iteration order)."""

    def __init__(self) -> None:
        self._seen: Dict[str, int] = {}  # key → times observed

    def observe(self, keys: Iterable[str]) -> int:
        """Record a run's keys; returns the count of globally-new ones
        (the run's novelty)."""
        new = 0
        for key in keys:
            if key not in self._seen:
                new += 1
            self._seen[key] = self._seen.get(key, 0) + 1
        return new

    def __len__(self) -> int:
        return len(self._seen)

    def __contains__(self, key: str) -> bool:
        return key in self._seen

    def keys_by_class(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for key in sorted(self._seen):
            out.setdefault(key.split(":", 1)[0], []).append(key)
        return out

    def report(self) -> Dict:
        """The coverage-report artifact body: totals per key class plus
        the full sorted key list (the CI artifact diffable across
        nights)."""
        by_class = self.keys_by_class()
        return {
            "coverage_keys": len(self._seen),
            "by_class": {cls: len(ks) for cls, ks in sorted(by_class.items())},
            "fault_sites_reached": sorted(
                {k.split(":")[1] for k in by_class.get("fault", [])}
            ),
            "metric_families_touched": sorted(
                k.split(":", 1)[1] for k in by_class.get("metric", [])
            ),
            "health_transitions_seen": sorted(
                k.split(":", 1)[1] for k in by_class.get("health", [])
            ),
            "keys": sorted(self._seen),
        }
