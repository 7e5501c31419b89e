"""What the drivers share: the reference's state of a cluster at a time,
and the comparison of a verdict map with the reference's."""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Dict, List, Optional

from gpubench.reference.semantics import kind_state


def reference_states(cluster, now: Optional[datetime] = None, control: Optional[str] = None):
    now = now or datetime.now(timezone.utc)
    return [
        kind_state(ts, cluster.pods, cluster.namespaces, now, control)
        for ts in (cluster.throttles, cluster.cluster_throttles)
    ]


def map_mismatches(got: Dict[str, object], want: Dict[str, object]) -> int:
    """Keys whose value differs, plus keys only one side has."""
    missing = len(want.keys() - got.keys()) + len(got.keys() - want.keys())
    return missing + sum(1 for k, v in want.items() if k in got and got[k] != v)


def distinct(outputs: List[dict]) -> List[dict]:
    """The outputs with repeats of the previous one dropped."""
    out: List[dict] = []
    for o in outputs:
        if not out or o != out[-1]:
            out.append(o)
    return out
