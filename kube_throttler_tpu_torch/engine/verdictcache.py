"""Interned-verdict cache: the serving hot path as a hash probe.

The columnar arena proved the admission workload is massively degenerate —
100k pods collapse to ~7 request shapes and ~500 label shapes — and a
PreFilter verdict is a pure function of (request-shape id, accel class,
matched-throttle cols, per-col state). This module memoizes that pure
function behind an epoch-versioned key:

- **key** = (request-shape id, accel class, throttle-cols bytes,
  clusterthrottle-cols bytes) — the function's domain, produced by
  ``DeviceStateManager.verdict_fingerprint`` (or the front's routing
  mirror);
- **version** = the epoch-sum over the key's cols (+ both kinds' global
  epochs). Every mutation that can change a verdict bumps a covered
  epoch under the owner's main lock (row encodes, removals, reservation
  writes, namespace events), and epochs are monotonic, so for a fixed
  cols set an equal sum proves elementwise equality — stale entries are
  unreachable by construction, not by eviction ("invalidation by
  epoch"). Eviction exists only to bound memory.

Concurrency: probes are LOCK-FREE — a probe is one ``dict.get`` per
segment (atomic under the GIL; CPython never leaves a dict observable
mid-resize), so readers never serialize behind each other or behind
inserts. Inserts take a small lock only to keep the size/rotation
bookkeeping coherent. Callers must follow the **validate-after-compute**
protocol: read ``(key, esum)``, compute the verdict OUTSIDE any lock,
re-read the fingerprint, and insert only if the sum is unchanged — a
concurrent mutation then suppresses the insert instead of poisoning the
cache.

Eviction is two-generation rotation (LRU-ish, O(1), no per-probe
bookkeeping): inserts fill the ``new`` segment; when it reaches half the
capacity the segments rotate (``new`` → ``old``, fresh ``new``, previous
``old`` dropped). Probes check ``new`` then ``old`` and promote old hits
forward, so keys hot across a rotation window survive and cold keys age
out after two rotations. Correctness never depends on any of this — a
dropped entry is a miss, a surviving entry is still epoch-checked.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..utils.lockorder import guard_attrs, make_lock

__all__ = ["VerdictCache"]


@guard_attrs
class VerdictCache:
    """Bounded (key → (epoch-sum, verdict)) map with lock-free probes.

    The cached "verdict" is opaque to this module — the plugin stores
    composed ``Status`` objects, the sharded front stores its own merged
    composition. Stats counters are plain ints: the probe side updates
    them without a lock (a torn ``+=`` can lose a rare increment, which
    is acceptable for monitoring and keeps the hit path at zero lock
    acquisitions); the insert side updates them under ``_lock``.
    """

    # _new/_old are REBOUND only under _lock (rotation/clear); probes read
    # them lock-free by design — attribute loads and dict.get are atomic
    # under the GIL, and a probe that races a rotation at worst consults
    # the just-demoted segment (a benign extra miss/hit of valid data).
    # Deliberately NOT in the GUARDED_BY table for that reason; likewise
    # hits/misses, which the lock-free probe side bumps by contract (a
    # torn increment loses a monitoring count, never a verdict). The
    # insert-side counters below ARE lock-owned: stats() reads them
    # racily at scrape (waived in baseline.txt / race_allow.txt).
    GUARDED_BY = {
        "insertions": "self._lock",
        "rotations": "self._lock",
        "invalidations": "self._lock",
    }

    def __init__(self, capacity: int = 65536) -> None:
        self.capacity = max(2, int(capacity))
        self._seg_cap = self.capacity // 2
        self._lock = make_lock("verdictcache.insert")
        self._new: dict = {}
        self._old: dict = {}
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.invalidations = 0  # explicit invalidate_all() calls
        self.rotations = 0

    # ------------------------------------------------------------- probe

    def get(self, key: tuple, esum: int) -> Optional[Any]:
        """The cached verdict for ``key`` at epoch-sum ``esum``, else None.

        An entry whose stored sum differs is a miss — never returned and
        left for rotation to recycle (epochs are monotonic, so it can
        never become valid again; overwriting is the insert's job)."""
        entry = self._new.get(key)
        if entry is None:
            entry = self._old.get(key)
            if entry is not None and entry[0] == esum:
                # promote across the rotation boundary so keys hot in the
                # previous window survive the next rotation; a lost race
                # with a concurrent rotation just skips the promotion
                self._new[key] = entry
        if entry is not None and entry[0] == esum:
            self.hits += 1
            return entry[1]
        self.misses += 1
        return None

    # ------------------------------------------------------------ insert

    def put(self, key: tuple, esum: int, verdict: Any) -> None:
        """Insert under the validate-after-compute protocol (see module
        docstring — the CALLER re-validated ``esum`` after computing)."""
        with self._lock:
            new = self._new
            new[key] = (esum, verdict)
            self.insertions += 1
            if len(new) >= self._seg_cap:
                self._old = new
                self._new = {}
                self.rotations += 1

    def invalidate_all(self) -> None:
        """Drop every entry (policy-spec swaps, replica rebootstrap).
        Belt-and-braces only — epoch bumps already fence every covered
        mutation; a probe racing this swap can serve one pre-swap verdict,
        exactly as if it had probed a moment earlier."""
        with self._lock:
            self._new = {}
            self._old = {}
            self.invalidations += 1

    # ------------------------------------------------------------- stats

    def __len__(self) -> int:
        return len(self._new) + len(self._old)

    def stats(self) -> Tuple[int, int, int, int, int]:
        """(hits, misses, entries, invalidations, insertions) — sampled
        racily, for metrics."""
        return (self.hits, self.misses, len(self), self.invalidations, self.insertions)
