"""Consistent-hash ring over the Throttle/ClusterThrottle keyspace.

Two properties matter for the scatter-gather front:

- **Stability**: ownership must be a pure function of (route key,
  shard count) — identical across processes and runs, so the front, the
  workers, and a restarted supervisor all agree without coordination.
  Python's builtin ``hash`` is salted per process; we hash with
  blake2b instead.
- **Selector affinity**: the per-event cost the sharding exists to
  divide is proportional to the number of *matching* throttles on each
  shard. Throttles with byte-identical selectors match exactly the same
  pods, so hashing the ROUTE KEY of a throttle as its canonical
  selector fingerprint (instead of its object key) co-locates them —
  a pod event then lands on the few shards owning its selector classes
  rather than on every shard that drew one of its 20 throttles. The
  partition is still a consistent hash of the keyspace: the fingerprint
  is a deterministic function of the stored object, and ownership by
  object key is recorded by the front (``AdmissionFront.owner_of``).

Virtual nodes smooth the partition (~128 points per shard keeps the
max/mean shard load under ~1.2 for uniform keys).
"""

from __future__ import annotations

import bisect
import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from ..api.types import ClusterThrottle, Throttle

__all__ = [
    "stable_hash64",
    "selector_fingerprint",
    "route_key_for",
    "HashRing",
    "RangeMove",
    "ReshardPlan",
    "plan_reshard",
    "TransitionRouting",
]


def stable_hash64(key: str) -> int:
    """Process-stable 64-bit hash (blake2b; builtin hash is salted)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


def _selector_term_dict(term, cluster: bool) -> dict:
    from ..api.serialization import label_selector_to_dict

    out = {"podSelector": label_selector_to_dict(term.pod_selector)}
    if cluster:
        out["namespaceSelector"] = label_selector_to_dict(term.namespace_selector)
    return out


def selector_fingerprint(thr: Union[Throttle, ClusterThrottle]) -> str:
    """Canonical, order-stable serialization of a throttle's selector.

    Throttles additionally fold in their namespace (a Throttle only ever
    matches pods of its own namespace, so same-selector throttles in
    different namespaces share no matching work and need not co-locate).
    """
    cluster = isinstance(thr, ClusterThrottle)
    terms = [
        _selector_term_dict(t, cluster) for t in thr.spec.selector.selector_terms
    ]
    scope = "c" if cluster else f"t:{thr.namespace}"
    return f"{scope}|" + json.dumps(terms, sort_keys=True, separators=(",", ":"))


def route_key_for(kind: str, obj) -> str:
    """The ring key an object shards by.

    - Throttle / ClusterThrottle: selector fingerprint (affinity above);
    - gang groups (``kind="Gang"``, obj = group key string): the group
      id — a gang's ledger lives on exactly one shard;
    - anything else keyed by a plain string: that string.
    """
    if kind in ("Throttle", "ClusterThrottle"):
        return selector_fingerprint(obj)
    if kind == "Gang":
        return f"gang|{obj}"
    return f"{kind}|{obj}"


class HashRing:
    """Immutable consistent-hash ring: ``shard_of(route_key) -> shard id``.

    Analyzer note: every field is written once in ``__init__``
    and only read afterwards — immutability IS the concurrency
    discipline here, so there is deliberately no ``GUARDED_BY`` table
    and no lock. Do not add mutating methods; rebuild a new ring for a
    new shard count (shard-count rebalancing is restart + resync by
    design)."""

    def __init__(self, n_shards: int, vnodes: int = 128):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = int(n_shards)
        self.vnodes = int(vnodes)
        points: List[Tuple[int, int]] = []
        for shard in range(self.n_shards):
            for v in range(self.vnodes):
                points.append((stable_hash64(f"shard-{shard}-vnode-{v}"), shard))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._shards = [s for _, s in points]

    def shard_of(self, route_key: str) -> int:
        if self.n_shards == 1:
            return 0
        h = stable_hash64(route_key)
        i = bisect.bisect_right(self._hashes, h)
        if i == len(self._hashes):
            i = 0
        return self._shards[i]

    def shard_of_object(self, kind: str, obj) -> int:
        return self.shard_of(route_key_for(kind, obj))

    def spread(self, keys) -> List[int]:
        """Shard load histogram for a key sample (diagnostics/tests)."""
        counts = [0] * self.n_shards
        for k in keys:
            counts[self.shard_of(k)] += 1
        return counts

    def owner_of_hash(self, h: int) -> int:
        """Shard owning a raw 64-bit ring position (resharding plumbing:
        the plan and the transition router reason in hash space, not key
        space, so a range statement covers keys that do not exist yet)."""
        if self.n_shards == 1:
            return 0
        i = bisect.bisect_right(self._hashes, int(h))
        if i == len(self._hashes):
            i = 0
        return self._shards[i]

    def boundaries(self) -> List[int]:
        """The sorted vnode positions (plan_reshard merges old+new)."""
        return list(self._hashes)


# --------------------------------------------------------------------------
# live resharding: retarget plans + the dual-ring transition router
# --------------------------------------------------------------------------

_HASH_SPACE = 1 << 64


@dataclass(frozen=True)
class RangeMove:
    """One moving keyspace range: the half-open hash interval
    ``[lo, hi)`` whose owner changes from ``src`` to ``dst`` when the
    ring retargets. ``hi == 2**64`` closes the top of the circle (the
    wrap segment is split at 0 so every move is a plain interval)."""

    index: int  # position in the plan (the coordinator's range id)
    lo: int
    hi: int
    src: int
    dst: int

    def covers(self, h: int) -> bool:
        return self.lo <= h < self.hi


@dataclass(frozen=True)
class ReshardPlan:
    """The minimal transfer set between two rings: only intervals whose
    owner differs appear (a key outside every move never transfers), and
    the plan is a pure function of the two ring parameter tuples — any
    two processes that agree on (n_old, n_new, vnodes) agree on the plan
    byte for byte (tests/test_reshard.py pins this)."""

    old_shards: int
    new_shards: int
    moves: Tuple[RangeMove, ...]

    def move_for_hash(self, h: int) -> Optional[RangeMove]:
        lows = [m.lo for m in self.moves]
        i = bisect.bisect_right(lows, h) - 1
        if i >= 0 and self.moves[i].covers(h):
            return self.moves[i]
        return None

    def moves_from(self, src: int) -> List[RangeMove]:
        return [m for m in self.moves if m.src == src]


def plan_reshard(old: HashRing, new: HashRing) -> ReshardPlan:
    """Compute the split/merge plan between two rings. Walk the merged
    boundary set: between consecutive boundaries ownership is constant
    under BOTH rings, so each elementary interval is wholly moving or
    wholly staying; adjacent moving intervals with the same (src, dst)
    coalesce into one :class:`RangeMove`."""
    cuts = sorted(set(old.boundaries()) | set(new.boundaries()) | {0, _HASH_SPACE})
    raw: List[Tuple[int, int, int, int]] = []  # (lo, hi, src, dst)
    for lo, hi in zip(cuts, cuts[1:]):
        if lo >= hi:
            continue
        src = old.owner_of_hash(lo)
        dst = new.owner_of_hash(lo)
        if src == dst:
            continue
        if raw and raw[-1][1] == lo and raw[-1][2] == src and raw[-1][3] == dst:
            raw[-1] = (raw[-1][0], hi, src, dst)
        else:
            raw.append((lo, hi, src, dst))
    moves = tuple(
        RangeMove(index=i, lo=lo, hi=hi, src=src, dst=dst)
        for i, (lo, hi, src, dst) in enumerate(raw)
    )
    return ReshardPlan(
        old_shards=old.n_shards, new_shards=new.n_shards, moves=moves
    )


class TransitionRouting:
    """Dual-ring routing during a live reshard: every key has exactly ONE
    authoritative owner at every instant (the zero-owner-never invariant
    the retarget tests sweep) — the old ring's owner until the covering
    range cuts over, the new ring's after. ``mirror_of`` names the
    destination while its range is warming (streaming + double-routing),
    so the front can mirror events without consulting the destination's
    verdicts.

    State transitions per range: ``pending`` → ``mirroring`` → ``cut``
    (success) or back to ``pending`` (abort-back-to-source). Mutation
    happens only under the front's route lock; readers race-free snapshot
    via the plain dict (CPython dict reads are atomic; a torn read is at
    worst one-event-late routing, repaired by the cutover's fence)."""

    PENDING = "pending"
    MIRRORING = "mirroring"
    CUT = "cut"

    def __init__(self, old_ring: HashRing, new_ring: HashRing,
                 plan: Optional[ReshardPlan] = None):
        self.old_ring = old_ring
        self.new_ring = new_ring
        self.plan = plan if plan is not None else plan_reshard(old_ring, new_ring)
        self.state: Dict[int, str] = {m.index: self.PENDING for m in self.plan.moves}

    def set_state(self, index: int, state: str) -> None:
        self.state[index] = state

    def owner_of_hash(self, h: int) -> int:
        move = self.plan.move_for_hash(h)
        if move is None:
            return self.new_ring.owner_of_hash(h)  # == old owner by plan
        return move.dst if self.state.get(move.index) == self.CUT else move.src

    def mirror_of_hash(self, h: int) -> Optional[RangeMove]:
        move = self.plan.move_for_hash(h)
        if move is not None and self.state.get(move.index) == self.MIRRORING:
            return move
        return None

    def owner_of(self, route_key: str) -> int:
        return self.owner_of_hash(stable_hash64(route_key))

    def complete(self) -> bool:
        return all(s == self.CUT for s in self.state.values())
