"""Incremental [P,T] selector-mask maintenance.

The reference re-evaluates label selectors linearly on every pod event and
every reconcile (affectedThrottles — throttle_controller.go:248-269 — is an
O(#throttles) Python-equivalent scan). At the 100k-pod × 10k-throttle target
that is 10⁹ selector evaluations per full pass, so the new framework keeps
the match matrix *materialized* and maintains it incrementally:

- **fast tier**: every VALID selector — matchLabels conjunctions AND
  matchExpressions (In/NotIn/Exists/DoesNotExist) — compiles to interned
  (label-key → value-id) requirements over columnar int32 label arrays.
  A pod event recomputes one mask row via the native C++ engine's
  inverted-index candidate pruning; a throttle event recomputes one
  column with O(P) vectorized numpy ops.
- **general tier**: selectors that fail validation fall back to per-object
  oracle evaluation, confined to the affected row/column — the exact
  error-confinement semantics of the reference.

Namespacing: a Throttle only ever matches pods in its own namespace
(affectedThrottles lists the pod's namespace); ClusterThrottle terms AND a
namespaceSelector over the pod's namespace labels
(clusterthrottle_selector.go:71-87). Both are folded into the same row/column
updates.

Capacity management: arrays grow geometrically and rows/columns are
free-listed, so the mask object handed to the device keeps a stable shape
between growth events (no kernel recompilation on object churn).

Storage: the match matrix is SPARSE — per-row sorted matched-col
arrays ``int32[pcap, kcap]`` (sentinel-padded) with per-row counts,
where ``kcap`` tracks the max per-pod match count. A dense ``[P, T]``
bool plane is 100 GB at the 1M-pod × 100k-throttle target; the sparse
rows are ~K×4 bytes/pod and double as the device's ``[P, K]`` cols
encoding directly. ``mask`` remains available as a property that
materializes the dense plane on demand (tests, the dense-kernel batch
route at small scale); hot consumers read the sparse accessors
(``row_cols`` / ``rows_of_col`` / ``row_cols_block``).

Object retention: with a ``pod_resolver`` wired (the columnar
store's ``materialize_pod``), the index retains NO Pod objects — per row
it keeps only the key, namespace, and a reference to the store's shared
interned labels dict. The rare consumers that need a full object
(general-tier selector evaluation, ``matched_pods``) materialize through
the resolver at call time. Without a resolver (standalone use) the
index retains event objects exactly as before.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from ..utils.lockorder import assert_held, guard_attrs, make_rlock
from ..api.pod import Namespace, Pod
from ..api.types import (
    ClusterThrottle,
    SelectorError,
    Throttle,
)
from ..native import NativeRowEngine

AnyThrottle = Union[Throttle, ClusterThrottle]

_MISSING = -1  # pod lacks the label key
_ANY = -2  # term does not constrain this key
# sparse-row padding sentinel: sorts AFTER every valid column id, so a
# plain ascending sort keeps valid cols as a sorted prefix
_SENT = np.iinfo(np.int32).max


class _Interner:
    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}

    def id_of(self, value: str) -> int:
        idx = self._ids.get(value)
        if idx is None:
            idx = len(self._ids)
            self._ids[value] = idx
        return idx


def _simple_terms(thr: AnyThrottle) -> Optional[List[Tuple[Dict[str, str], Dict[str, str]]]]:
    """Return [(pod_pairs, ns_pairs)] if every term is matchLabels-only."""
    terms = []
    for term in thr.spec.selector.selector_terms:
        if term.pod_selector.match_expressions:
            return None
        ns_pairs: Dict[str, str] = {}
        if isinstance(thr, ClusterThrottle):
            if term.namespace_selector.match_expressions:
                return None
            ns_pairs = dict(term.namespace_selector.match_labels)
        terms.append((dict(term.pod_selector.match_labels), ns_pairs))
    return terms


@guard_attrs
class SelectorIndex:
    """One index instance per kind (mirroring the two controllers)."""

    # every row/column plane, interner, and cache below moves only under
    # the single per-index RLock; `*_locked` helpers run with it held
    # (callers outside this class take it explicitly — see
    # devicestate's `with ks.index._lock:` probe path)
    GUARDED_BY = {
        "_probe_cache": "self._lock",
        "_gen": "self._lock",
        "_pod_rows": "self._lock",
        "_row_pods": "self._lock",
        "_row_keys": "self._lock",
        "_row_ns_names": "self._lock",
        "_row_labels": "self._lock",
        "_row_prev": "self._lock",
        "_free_rows": "self._lock",
        "_pcap": "self._lock",
        "_pod_valid": "self._lock",
        "_pod_ns": "self._lock",
        "_pod_ns_exists": "self._lock",
        "_pod_label": "self._lock",
        "_ns_label": "self._lock",
        "_thr_cols": "self._lock",
        "_col_thrs": "self._lock",
        "_col_keys": "self._lock",
        "_free_cols": "self._lock",
        "_tcap": "self._lock",
        "_thr_valid": "self._lock",
        "_namespaces": "self._lock",
        "_ns_label_ids": "self._lock",
    }

    def __init__(
        self,
        kind: str,
        pod_capacity: int = 64,
        throttle_capacity: int = 16,
        use_native: bool = True,
        interner=None,
    ):
        assert kind in ("throttle", "clusterthrottle")
        self.kind = kind
        self._lock = make_rlock(f"index.{kind}")

        # label keys+values share one pool with the store's arena when the
        # owner wires it (``interner``) — one interning per string per
        # process instead of one per kind
        self._values = interner if interner is not None else _Interner()
        self._ns_ids = _Interner()
        self._key_ids = self._values if interner is not None else _Interner()
        # columnar-store materializer (Store.materialize_pod). When set,
        # the index retains NO pod objects (see module docstring).
        self.pod_resolver: Optional[callable] = None

        # probe-row cache for NOT-stored pods (the PreFilter common case):
        # a selector match depends only on (namespace, labels), and the
        # scheduler retries the same Pending pod across backoff cycles, so
        # repeats skip the O(T) compiled-column evaluation. Invalidated
        # wholesale by bumping _gen on any column/namespace change.
        self._probe_cache: "OrderedDict[tuple, Tuple[int, np.ndarray]]" = OrderedDict()
        self._gen = 0

        # native C++ row-match tier (kube_throttler_tpu/native/ktnative.cpp); None → pure Python
        self._native: Optional[NativeRowEngine] = None
        if use_native:
            try:
                self._native = NativeRowEngine(kind)
            except RuntimeError:
                pass

        # pods
        self._pod_rows: Dict[str, int] = {}
        # row → retained event object (LEGACY/standalone mode only: with a
        # pod_resolver the index retains no objects and the three light
        # row-meta dicts below carry what matching needs — the key, the
        # namespace name, and a reference to the store's SHARED interned
        # labels dict)
        self._row_pods: Dict[int, Pod] = {}
        self._row_keys: Dict[int, str] = {}
        self._row_ns_names: Dict[int, str] = {}
        self._row_labels: Dict[int, dict] = {}
        # single-slot previous (row, object, mask-row) cache: lets the
        # MODIFIED handler's old-side affected query reuse the row the index
        # JUST replaced instead of re-evaluating T columns. One slot is
        # enough — the consumer runs inside the SAME store dispatch (store
        # lock held), before the next pod event can overwrite it — and keeps
        # the cache O(tcap) bytes instead of growing per churned row. It is
        # dropped on any column/namespace change (it must never outlive the
        # compiled columns it was computed against).
        self._row_prev: Optional[Tuple[int, Pod, np.ndarray]] = None
        self._free_rows: List[int] = []
        self._pcap = pod_capacity
        self._pod_valid = np.zeros(self._pcap, dtype=bool)
        self._pod_ns = np.full(self._pcap, _MISSING, dtype=np.int32)
        self._pod_ns_exists = np.zeros(self._pcap, dtype=bool)
        # label columns: key -> int32[pcap] (pod labels / pod's-ns labels)
        self._pod_label: Dict[str, np.ndarray] = {}
        self._ns_label: Dict[str, np.ndarray] = {}

        # throttles
        self._thr_cols: Dict[str, int] = {}
        self._col_thrs: Dict[int, AnyThrottle] = {}
        # col -> key mirror of _col_thrs: affected-throttle lookups are the
        # per-event ingest hot path (20+ matched cols per pod at full
        # scale), and thr.key re-derives the "ns/name" string per call
        self._col_keys: Dict[int, str] = {}
        self._free_cols: List[int] = []
        self._tcap = throttle_capacity
        self._thr_valid = np.zeros(self._tcap, dtype=bool)

        # namespaces (labels, for clusterthrottle ns selectors)
        self._namespaces: Dict[str, Namespace] = {}
        # interned {key_id: value_id} per namespace, for the native row path
        self._ns_label_ids: Dict[str, Dict[int, int]] = {}

        # sparse match matrix: per-row SORTED matched cols (sentinel-padded)
        # + per-row counts; kcap tracks the max per-pod match count.
        # DELIBERATELY outside the GUARDED_BY table: mutations all run
        # under self._lock, but the public sparse accessors below read
        # lock-free under the owner's single-mutator coherence — exactly
        # the stance external consumers of the former dense ``mask``
        # plane took (devicestate reads these under ITS main lock, which
        # serializes against the mutating dispatch path).
        self._kcap = 8
        self._row_cols = np.full((self._pcap, self._kcap), _SENT, dtype=np.int32)
        self._row_n = np.zeros(self._pcap, dtype=np.int32)

    @property
    def mask(self) -> np.ndarray:
        """Dense ``bool[pcap, tcap]`` materialized from the sparse rows —
        compatibility/readout surface (tests, the dense-kernel device
        mask). O(P×T) memory: production hot paths use the sparse
        accessors instead (``row_cols`` / ``rows_of_col`` / ...)."""
        with self._lock:
            dense = np.zeros((self._pcap, self._tcap), dtype=bool)
            valid = self._row_cols != _SENT
            if valid.any():
                rows = np.nonzero(valid)[0]
                dense[rows, self._row_cols[valid]] = True
            return dense

    # ----------------------------------------------------- sparse row plane

    def _grow_k_locked(self) -> None:
        new_k = self._kcap * 2
        grown = np.full((self._row_cols.shape[0], new_k), _SENT, dtype=np.int32)
        grown[:, : self._kcap] = self._row_cols
        self._row_cols = grown
        self._kcap = new_k

    def _set_row_sparse_locked(self, row: int, cols: np.ndarray) -> None:
        """Replace one row's matched-col set (``cols`` sorted ascending,
        no sentinel)."""
        n = int(cols.size)
        while n > self._kcap:
            self._grow_k_locked()
        rc = self._row_cols[row]
        rc[:] = _SENT
        rc[:n] = cols
        self._row_n[row] = n

    def _rows_of_col_locked(self, col: int) -> np.ndarray:
        """Rows currently containing ``col`` — O(P×kcap) vectorized scan
        (column membership changes are the rare direction; rows are the
        hot one)."""
        return np.nonzero((self._row_cols == col).any(axis=1))[0]

    def _set_col_sparse_locked(self, col: int, match: np.ndarray) -> None:
        """Make column ``col``'s membership equal ``match`` (bool[pcap])
        by diffing against the rows that currently hold it."""
        new_rows = np.flatnonzero(match[: self._row_cols.shape[0]])
        old_rows = self._rows_of_col_locked(col)
        remove = np.setdiff1d(old_rows, new_rows, assume_unique=True)
        insert = np.setdiff1d(new_rows, old_rows, assume_unique=True)
        if remove.size:
            sub = self._row_cols[remove]
            sub[sub == col] = _SENT
            sub.sort(axis=1)
            self._row_cols[remove] = sub
            self._row_n[remove] -= 1
        if insert.size:
            while int(self._row_n[insert].max()) + 1 > self._kcap:
                self._grow_k_locked()
            sub = self._row_cols[insert]
            sub[np.arange(insert.size), self._row_n[insert]] = col
            sub.sort(axis=1)
            self._row_cols[insert] = sub
            self._row_n[insert] += 1

    # public sparse accessors (devicestate's hot-path reads; all return
    # COPIES unless noted — callers run outside this lock by the same
    # single-mutator coherence the dense mask relied on)

    def row_cols(self, row: int) -> np.ndarray:
        """Sorted matched cols of one row (copy)."""
        return self._row_cols[row, : self._row_n[row]].copy()

    def rows_of_col(self, col: int) -> np.ndarray:
        return np.nonzero((self._row_cols == col).any(axis=1))[0]

    def row_has_col(self, row: int, col: int) -> bool:
        n = int(self._row_n[row])
        rc = self._row_cols[row, :n]
        i = int(np.searchsorted(rc, col))
        return i < n and rc[i] == col

    def row_cols_block(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(cols block with sentinel padding, per-row counts) for a set of
        rows — the aggregate-rebase gather."""
        return self._row_cols[rows], self._row_n[rows]

    def sparse_snapshot(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """(row_cols, row_n, kcap) LIVE references — the device cols
        rebuild reads them under the owner's coherence rules."""
        return self._row_cols, self._row_n, self._kcap

    def nnz_max(self) -> int:
        return int(self._row_n.max()) if self._row_n.size else 0

    def mask_rows(self, rows: np.ndarray) -> np.ndarray:
        """Dense bool[len(rows), tcap] of the given rows."""
        with self._lock:
            out = np.zeros((len(rows), self._tcap), dtype=bool)
            sub = self._row_cols[rows]
            valid = sub != _SENT
            if valid.any():
                rr = np.nonzero(valid)[0]
                out[rr, sub[valid]] = True
            return out

    # ------------------------------------------------------------------ pods

    def _pod_col_array_locked(self, store: Dict[str, np.ndarray], key: str) -> np.ndarray:
        arr = store.get(key)
        if arr is None:
            arr = np.full(self._pcap, _MISSING, dtype=np.int32)
            store[key] = arr
        return arr

    def _grow_pods_locked(self) -> None:
        assert_held(self._lock, "SelectorIndex._grow_pods_locked")
        new_cap = self._pcap * 2
        self._pod_valid = np.resize(self._pod_valid, new_cap)
        self._pod_valid[self._pcap :] = False
        grown_ns = np.full(new_cap, _MISSING, dtype=np.int32)
        grown_ns[: self._pcap] = self._pod_ns
        self._pod_ns = grown_ns
        grown_exists = np.zeros(new_cap, dtype=bool)
        grown_exists[: self._pcap] = self._pod_ns_exists
        self._pod_ns_exists = grown_exists
        for store in (self._pod_label, self._ns_label):
            for key, arr in store.items():
                grown = np.full(new_cap, _MISSING, dtype=np.int32)
                grown[: self._pcap] = arr
                store[key] = grown
        grown_rc = np.full((new_cap, self._kcap), _SENT, dtype=np.int32)
        grown_rc[: self._pcap] = self._row_cols
        self._row_cols = grown_rc
        grown_n = np.zeros(new_cap, dtype=np.int32)
        grown_n[: self._pcap] = self._row_n
        self._row_n = grown_n
        self._pcap = new_cap

    def _upsert_pod_locked(self, pod: Pod) -> Tuple[int, bool]:
        """Row assignment + label-column writes for one pod (no re-match).
        Returns ``(row, needs_recompute)`` — False when the update could
        not have moved the mask row (labels+namespace unchanged)."""
        assert_held(self._lock, "SelectorIndex._upsert_pod_locked")
        row = self._pod_rows.get(pod.key)
        fresh = row is None
        if fresh:
            if self._free_rows:
                row = self._free_rows.pop()
            else:
                row = len(self._pod_rows)
                while row >= self._pcap:
                    self._grow_pods_locked()
            self._pod_rows[pod.key] = row
        if self.pod_resolver is None:
            prev = self._row_pods.get(row)
            if prev is not None and prev is not pod:
                self._row_prev = (row, prev, self.row_cols(row))
            self._row_pods[row] = pod
            prev_labels = prev.labels if prev is not None else None
            prev_ns = prev.namespace if prev is not None else None
        else:
            # no-retention mode: remember only (key, ns, shared-labels-ref)
            prev_labels = None if fresh else self._row_labels.get(row)
            prev_ns = None if fresh else self._row_ns_names.get(row)
            self._row_keys[row] = pod.key
            self._row_ns_names[row] = pod.namespace
            self._row_labels[row] = pod.labels
        self._pod_valid[row] = True

        # Selector matching reads only (pod.labels, pod.namespace) — the
        # namespace-side inputs (existence, ns labels) are maintained by
        # upsert_namespace, which recomputes affected rows itself. So a
        # pod update that changes neither (the dominant churn shape:
        # requests/status-only updates) cannot flip this mask row, and
        # the O(T) column sweep is skipped entirely. With an arena-backed
        # store the labels compare is usually an identity hit (shared
        # interned dicts).
        if (
            prev_labels is not None
            and (prev_labels is pod.labels or prev_labels == pod.labels)
            and prev_ns == pod.namespace
        ):
            return row, False

        self._pod_ns[row] = self._ns_ids.id_of(pod.namespace)
        self._pod_ns_exists[row] = pod.namespace in self._namespaces

        seen: Set[str] = set()
        for key, value in pod.labels.items():
            self._pod_col_array_locked(self._pod_label, key)[row] = self._values.id_of(value)
            seen.add(key)
        for key, arr in self._pod_label.items():
            if key not in seen:
                arr[row] = _MISSING

        ns = self._namespaces.get(pod.namespace)
        ns_labels = ns.labels if ns else {}
        seen = set()
        for key, value in ns_labels.items():
            self._pod_col_array_locked(self._ns_label, key)[row] = self._values.id_of(value)
            seen.add(key)
        for key, arr in self._ns_label.items():
            if key not in seen:
                arr[row] = _MISSING
        return row, True

    def upsert_pod(self, pod: Pod) -> int:
        """Insert or update a pod; recomputes its mask row. Returns the row."""
        with self._lock:
            row, recompute = self._upsert_pod_locked(pod)
            if recompute:
                self._recompute_row_locked(row, pod=pod)
            return row

    def upsert_pods_batch(self, pods: Sequence[Pod]) -> List[int]:
        """Batch upsert under ONE lock hold: every pod's label columns are
        written FIRST, then one re-match pass recomputes exactly the rows
        whose matching inputs moved. Correctness rests on row independence
        — a row's re-match reads only its own label entries and the
        compiled columns, so deferring it past the other pods' column
        writes cannot change its result (the per-event path interleaves
        them; both orders are property-tested equal). Returns the rows in
        input order."""
        with self._lock:
            rows: List[int] = []
            pending: List[Tuple[int, Pod]] = []
            for pod in pods:
                row, recompute = self._upsert_pod_locked(pod)
                rows.append(row)
                if recompute:
                    pending.append((row, pod))
            for row, pod in pending:
                self._recompute_row_locked(row, pod=pod)
            return rows

    def remove_pod(self, pod_key: str) -> None:
        with self._lock:
            row = self._pod_rows.pop(pod_key, None)
            if row is None:
                return
            self._row_pods.pop(row, None)
            self._row_keys.pop(row, None)
            self._row_ns_names.pop(row, None)
            self._row_labels.pop(row, None)
            if self._row_prev is not None and self._row_prev[0] == row:
                self._row_prev = None
            self._pod_valid[row] = False
            self._row_cols[row, :] = _SENT
            self._row_n[row] = 0
            self._free_rows.append(row)

    # ------------------------------------------------------------- throttles

    def upsert_throttle(self, thr: AnyThrottle) -> int:
        with self._lock:
            self._gen += 1  # compiled columns change → probe cache stale
            key = thr.key
            col = self._thr_cols.get(key)
            if col is None:
                if self._free_cols:
                    col = self._free_cols.pop()
                else:
                    col = len(self._thr_cols)
                    while col >= self._tcap:
                        self._grow_throttles_locked()
                self._thr_cols[key] = col
            self._col_thrs[col] = thr
            self._col_keys[col] = key
            self._thr_valid[col] = True
            self._row_prev = None  # compiled columns changed
            if self._native is not None:
                self._native_sync_col_locked(col, thr)
            self._recompute_col_locked(col)
            return col

    def refresh_throttle_object(self, thr: AnyThrottle) -> Optional[int]:
        """Swap the stored object for an update that did NOT change the
        selector (e.g. a status write-back): no column recompute, no mask
        change — a [P]-wide re-match per status echo would make every
        reconcile O(pods). Returns the column, or None if not indexed."""
        with self._lock:
            col = self._thr_cols.get(thr.key)
            if col is None:
                return None
            self._col_thrs[col] = thr
            return col

    def _grow_throttles_locked(self) -> None:
        new_cap = self._tcap * 2
        grown_valid = np.zeros(new_cap, dtype=bool)
        grown_valid[: self._tcap] = self._thr_valid
        self._thr_valid = grown_valid
        # sparse rows carry column IDS — tcap growth changes nothing there
        self._tcap = new_cap
        if self._native is not None:
            self._native.reserve(new_cap)

    def remove_throttle(self, throttle_key: str) -> None:
        with self._lock:
            self._gen += 1
            col = self._thr_cols.pop(throttle_key, None)
            if col is None:
                return
            self._col_thrs.pop(col, None)
            self._col_keys.pop(col, None)
            self._thr_valid[col] = False
            self._row_prev = None  # compiled columns changed
            self._set_col_sparse_locked(col, np.zeros(self._pcap, dtype=bool))
            self._free_cols.append(col)
            if self._native is not None:
                self._native.clear_col(col)

    # ------------------------------------------------------------ namespaces

    def upsert_namespace(self, ns: Namespace) -> None:
        """Namespace (re)definition: refresh ns-label columns of its pods and
        recompute their rows (cluster selectors may flip)."""
        with self._lock:
            if self.kind == "clusterthrottle":
                # ns existence/labels feed clusterthrottle probe matches;
                # throttle matching reads only thr.namespace == pod.namespace
                # (in the cache key), so that kind's cache survives ns churn
                self._gen += 1
            self._namespaces[ns.name] = ns
            self._ns_label_ids.pop(ns.name, None)
            self._row_prev = None  # ns labels feed clusterthrottle matches
            if self.kind != "clusterthrottle":
                return
            ns_id = self._ns_ids.id_of(ns.name)
            rows = np.nonzero(self._pod_valid & (self._pod_ns == ns_id))[0]
            self._pod_ns_exists[rows] = True
            for row in rows:
                seen: Set[str] = set()
                for key, value in ns.labels.items():
                    self._pod_col_array_locked(self._ns_label, key)[row] = self._values.id_of(value)
                    seen.add(key)
                for key, arr in self._ns_label.items():
                    if key not in seen:
                        arr[row] = _MISSING
                self._recompute_row_locked(int(row))

    def remove_namespace(self, name: str) -> None:
        """Namespace deletion: its pods can no longer match any
        ClusterThrottle (the oracle requires the Namespace object —
        clusterthrottle_controller.go:273-276 answers ERROR for pods of an
        unknown namespace, and an unknown namespace matches no selector).
        Throttle-kind matching ignores Namespace objects entirely, so that
        kind only drops its bookkeeping."""
        with self._lock:
            self._namespaces.pop(name, None)
            self._ns_label_ids.pop(name, None)
            self._row_prev = None
            if self.kind != "clusterthrottle":
                return
            self._gen += 1  # existence feeds clusterthrottle probe matches
            ns_id = self._ns_ids.id_of(name)
            rows = np.nonzero(self._pod_valid & (self._pod_ns == ns_id))[0]
            self._pod_ns_exists[rows] = False
            # every match path returns False for an absent Namespace (native
            # gate ktnative.cpp ns_exists; _match_one_locked/_eval_general_locked ns None),
            # so the rows' recompute result is provably all-False — clear
            # vectorized instead of O(rows × T) selector evaluations
            self._row_cols[rows, :] = _SENT
            self._row_n[rows] = 0

    # ------------------------------------------------------------- recompute

    def _term_col_match_locked(self, pairs: Dict[str, str], store: Dict[str, np.ndarray]) -> np.ndarray:
        """Vectorized: which pods satisfy all (key,value) pairs."""
        out = self._pod_valid.copy()
        for key, value in pairs.items():
            arr = store.get(key)
            if arr is None:
                out[:] = False
                return out
            out &= arr == self._values.id_of(value)
        return out

    def _selector_col_match_locked(self, selector, store: Dict[str, np.ndarray]) -> np.ndarray:
        """Vectorized column evaluation of one LabelSelector over interned
        label arrays — matchLabels AND matchExpressions, mirroring
        LabelSelector.matches (api/types.py:303-322). The caller validates
        the selector first (invalid → general tier)."""
        out = self._term_col_match_locked(selector.match_labels, store)
        for req in selector.match_expressions:
            arr = store.get(req.key)
            present = (
                (arr != _MISSING) if arr is not None
                else np.zeros(self._pcap, dtype=bool)
            )
            if req.operator == "In":
                if arr is None:
                    out[:] = False
                    return out
                ids = [self._values.id_of(v) for v in req.values]
                out &= present & np.isin(arr, ids)
            elif req.operator == "NotIn":
                if arr is not None:
                    ids = [self._values.id_of(v) for v in req.values]
                    out &= ~(present & np.isin(arr, ids))
            elif req.operator == "Exists":
                out &= present
            else:  # DoesNotExist
                out &= ~present
        return out

    def _recompute_col_locked(self, col: int) -> None:
        thr = self._col_thrs[col]
        try:
            # vectorized tier covers the full valid selector surface
            # (matchLabels + matchExpressions); validation errors fall to
            # the per-pod general tier for exact error confinement
            for term in thr.spec.selector.selector_terms:
                term.pod_selector.validate()
                if self.kind == "clusterthrottle":
                    term.namespace_selector.validate()
            match = np.zeros(self._pcap, dtype=bool)
            for term in thr.spec.selector.selector_terms:
                m = self._selector_col_match_locked(term.pod_selector, self._pod_label)
                if self.kind == "clusterthrottle":
                    m &= self._pod_ns_exists  # unknown namespace → no match
                    m &= self._selector_col_match_locked(
                        term.namespace_selector, self._ns_label
                    )
                match |= m
        except SelectorError:
            match = np.zeros(self._pcap, dtype=bool)
            for key, row in self._pod_rows.items():
                pod = self._resolve_row_pod_locked(row)
                if pod is not None:
                    match[row] = self._eval_general_locked(thr, pod)
        if isinstance(thr, Throttle):
            match &= self._pod_ns == self._ns_ids.id_of(thr.namespace)
        self._set_col_sparse_locked(col, match)

    def _resolve_row_pod_locked(self, row: int) -> Optional[Pod]:
        """The row's full Pod object: the retained one (legacy mode) or a
        lazy materialization through the store resolver (rare paths —
        general-tier evaluation, matched_pods)."""
        pod = self._row_pods.get(row)
        if pod is not None or self.pod_resolver is None:
            return pod
        key = self._row_keys.get(row)
        return self.pod_resolver(key) if key is not None else None

    _NATIVE_OPS = {
        "In": NativeRowEngine.OP_IN,
        "NotIn": NativeRowEngine.OP_NOT_IN,
        "Exists": NativeRowEngine.OP_EXISTS,
        "DoesNotExist": NativeRowEngine.OP_DOES_NOT_EXIST,
    }

    def _native_reqs_locked(self, selector) -> List[Tuple[int, int, Tuple[int, ...]]]:
        """Compile one LabelSelector to native requirements; raises
        SelectorError for invalid selectors (the caller routes those to the
        general tier, which preserves the exact error-confinement
        semantics of _eval_general_locked)."""
        selector.validate()
        reqs = [
            (
                self._key_ids.id_of(k),
                NativeRowEngine.OP_EQ,
                (self._values.id_of(v),),
            )
            for k, v in selector.match_labels.items()
        ]
        for expr in selector.match_expressions:
            reqs.append(
                (
                    self._key_ids.id_of(expr.key),
                    self._NATIVE_OPS[expr.operator],
                    tuple(self._values.id_of(v) for v in expr.values),
                )
            )
        return reqs

    def _native_sync_col_locked(self, col: int, thr: AnyThrottle) -> None:
        """Compile a throttle's selector into the native engine's column —
        matchLabels AND matchExpressions (In/NotIn/Exists/DoesNotExist);
        only selectors that fail validation stay on the Python general
        tier."""
        assert self._native is not None
        thr_ns = self._ns_ids.id_of(thr.namespace) if isinstance(thr, Throttle) else -1
        try:
            terms = []
            for term in thr.spec.selector.selector_terms:
                pr = self._native_reqs_locked(term.pod_selector)
                nr = (
                    self._native_reqs_locked(term.namespace_selector)
                    if isinstance(thr, ClusterThrottle)
                    else []
                )
                terms.append((pr, nr))
        except SelectorError:
            self._native.set_col_general(col, thr_ns)
            return
        self._native.set_col(col, thr_ns, terms)

    def _match_row_arbitrary_locked(self, pod: Pod) -> np.ndarray:
        """Evaluate a pod (not necessarily stored) against every compiled
        column → bool[tcap]. Native C++ tier when available."""
        return self._match_parts_locked(pod.namespace, pod.labels, lambda: pod)

    def _match_parts_locked(self, ns_name: str, labels: dict, pod_supplier) -> np.ndarray:
        """Row evaluation from its matching INPUTS — (namespace, labels) —
        so the no-retention index can recompute a stored row without
        materializing its pod. ``pod_supplier`` produces the full object
        only when a column needs the general tier (invalid selectors) or
        the pure-Python fallback; it may return None (row reads
        no-match)."""
        if self._native is not None:
            ns = self._namespaces.get(ns_name)
            pod_labels = {
                self._key_ids.id_of(k): self._values.id_of(v) for k, v in labels.items()
            }
            ns_labels = self._ns_label_ids.get(ns_name)
            if ns_labels is None:
                ns_labels = {
                    self._key_ids.id_of(k): self._values.id_of(v)
                    for k, v in (ns.labels if ns else {}).items()
                }
                self._ns_label_ids[ns_name] = ns_labels
            match, general = self._native.match_row(
                self._ns_ids.id_of(ns_name), ns is not None, pod_labels, ns_labels
            )
            out = np.zeros(self._tcap, dtype=bool)
            out[: len(match)] = match.astype(bool)
            gen_cols = np.nonzero(general)[0]
            if gen_cols.size:
                pod = pod_supplier()
                for col in gen_cols:
                    out[col] = (
                        self._eval_general_locked(self._col_thrs[int(col)], pod)
                        if pod is not None
                        else False
                    )
            return out
        out = np.zeros(self._tcap, dtype=bool)
        pod = pod_supplier()
        if pod is None:
            return out
        for key, col in self._thr_cols.items():
            out[col] = self._match_one_locked(self._col_thrs[col], pod)
        return out

    _PROBE_CACHE_MAX = 4096

    def match_row_cached_locked(self, pod: Pod) -> np.ndarray:
        """``_match_row_arbitrary_locked`` behind a (namespace, labels)-keyed LRU.

        Caller must hold ``_lock``. The returned array is SHARED with the
        cache — treat it as read-only. Correctness: a selector match reads
        nothing of the pod beyond namespace + labels (``_match_one_locked``), and
        ``_gen`` is bumped by every column or namespace mutation, so a hit
        can never serve a stale compiled-column evaluation."""
        assert_held(self._lock, "SelectorIndex.match_row_cached_locked")
        key = (pod.namespace, frozenset(pod.labels.items()))
        hit = self._probe_cache.get(key)
        if hit is not None and hit[0] == self._gen:
            self._probe_cache.move_to_end(key)
            return hit[1]
        row = self._match_row_arbitrary_locked(pod)
        self._probe_cache[key] = (self._gen, row)
        # assignment to an existing (gen-stale) key keeps its old LRU slot;
        # a just-refreshed hot entry must not be the next eviction victim
        self._probe_cache.move_to_end(key)
        if len(self._probe_cache) > self._PROBE_CACHE_MAX:
            self._probe_cache.popitem(last=False)
        return row

    def _recompute_row_locked(self, row: int, pod: Optional[Pod] = None) -> None:
        """Re-match one stored row. ``pod`` (the upsert paths always have
        it in hand) short-circuits any materialization; without it the
        matching inputs come from the row meta and the full object is
        resolved lazily only if a general-tier column demands it."""
        if pod is not None:
            match = self._match_row_arbitrary_locked(pod)
        elif self.pod_resolver is None:
            match = self._match_row_arbitrary_locked(self._row_pods[row])
        else:
            match = self._match_parts_locked(
                self._row_ns_names.get(row, ""),
                self._row_labels.get(row, {}),
                lambda: self._resolve_row_pod_locked(row),
            )
        self._set_row_sparse_locked(row, np.flatnonzero(match).astype(np.int32))

    def _match_one_locked(self, thr: AnyThrottle, pod: Pod) -> bool:
        """Single-pair oracle used by row recompute AND external callers
        (e.g. the not-yet-indexed-pod fallback) — it must apply the FULL
        affected-throttle predicate, including Throttle namespace equality
        and ClusterThrottle namespace existence."""
        if isinstance(thr, Throttle) and thr.namespace != pod.namespace:
            return False
        simple = _simple_terms(thr)
        if simple is not None:
            if self.kind == "clusterthrottle":
                ns = self._namespaces.get(pod.namespace)
                if ns is None:
                    # a pod whose Namespace object is unknown can never match
                    # a ClusterThrottle (the oracle path errors; the mask
                    # reads no-match — clusterthrottle_controller.go:273-276)
                    return False
                ns_labels = ns.labels
            else:
                ns_labels = {}
            for pod_pairs, ns_pairs in simple:
                if all(pod.labels.get(k) == v for k, v in pod_pairs.items()):
                    if self.kind == "clusterthrottle":
                        if all(ns_labels.get(k) == v for k, v in ns_pairs.items()):
                            return True
                    else:
                        return True
            return False
        return self._eval_general_locked(thr, pod)

    def _eval_general_locked(self, thr: AnyThrottle, pod: Pod) -> bool:
        try:
            if isinstance(thr, Throttle):
                return thr.spec.selector.matches_to_pod(pod)
            ns = self._namespaces.get(pod.namespace)
            if ns is None:
                return False
            return thr.spec.selector.matches_to_pod(pod, ns)
        except SelectorError:
            # an invalid selector term fails that term; the reference
            # propagates the error per-call — confining it to no-match keeps
            # the index total (callers re-raise on direct evaluation paths)
            return False

    # --------------------------------------------------------------- queries

    def affected_throttle_keys(self, pod_key: str) -> List[str]:
        """Keys of throttles matching the pod (affectedThrottles batched).
        O(K) via the col→object map — an inverted {col: key} dict built
        per call would be O(T) and dominated full-scale event ingest."""
        with self._lock:
            if not self._col_thrs:
                return []
            row = self._pod_rows.get(pod_key)
            if row is None:
                return []
            cols = self._row_cols[row, : self._row_n[row]]
            ck = self._col_keys
            return [ck[c] for c in cols.tolist() if c in ck]

    def affected_throttle_keys_for(self, pod: Pod) -> List[str]:
        """affectedThrottles for an ARBITRARY pod object.

        When the queried object is exactly the indexed one, this is an O(K)
        mask-row read. Otherwise (a pod version the index has moved past —
        e.g. the old side of a MODIFIED event — or a pod not yet stored) the
        row is evaluated fresh against every compiled column, without
        mutating the index."""
        with self._lock:
            if not self._col_thrs:
                return []
            row = self._pod_rows.get(pod.key)
            if row is not None and (
                self._row_pods.get(row) is pod
                # no-retention identity: the arena canonicalizes labels to
                # shared dicts, so the current row version is recognizable
                # by (labels identity, namespace) without keeping the object
                or (
                    self.pod_resolver is not None
                    and self._row_labels.get(row) is pod.labels
                    and self._row_ns_names.get(row) == pod.namespace
                )
            ):
                cols = self._row_cols[row, : self._row_n[row]]
            else:
                prev = self._row_prev
                if prev is not None and prev[0] == row and prev[1] is pod:
                    # the old side of the MODIFIED event the index just
                    # processed: its row was saved before the overwrite
                    pc = prev[2]
                    cols = pc[self._thr_valid[pc]]
                else:
                    cols = np.nonzero(self.match_row_cached_locked(pod) & self._thr_valid)[0]
            ck = self._col_keys
            return [ck[c] for c in cols.tolist() if c in ck]

    def matched_pod_keys(self, throttle_key: str) -> List[str]:
        """Pod keys matching a throttle (affectedPods' selector part)."""
        with self._lock:
            col = self._thr_cols.get(throttle_key)
            if col is None:
                return []
            rows = self._rows_of_col_locked(col)
            if self.pod_resolver is not None:
                rk = self._row_keys
                return [rk[int(r)] for r in rows if int(r) in rk]
            row_to_key = {row: key for key, row in self._pod_rows.items()}
            return [row_to_key[r] for r in rows if r in row_to_key]

    def matched_pods(self, throttle_key: str) -> List[Pod]:
        """The indexed Pod objects matching a throttle (latest store
        state). In no-retention mode the objects are materialized through
        the resolver OUTSIDE the index lock (lock order: the resolver
        takes the store lock, which must never nest inside this one)."""
        keys: Optional[List[str]] = None
        with self._lock:
            col = self._thr_cols.get(throttle_key)
            if col is None:
                return []
            rows = self._rows_of_col_locked(col)
            if self.pod_resolver is None:
                return [self._row_pods[int(r)] for r in rows if int(r) in self._row_pods]
            rk = self._row_keys
            keys = [rk[int(r)] for r in rows if int(r) in rk]
        out = []
        for key in keys:
            pod = self.pod_resolver(key)
            if pod is not None:
                out.append(pod)
        return out

    def indexed_pod(self, pod_key: str) -> Optional[Pod]:
        with self._lock:
            row = self._pod_rows.get(pod_key)
            if row is None:
                return None
            pod = self._row_pods.get(row)
            if pod is not None or self.pod_resolver is None:
                return pod
        return self.pod_resolver(pod_key)

    def mask_cell(self, pod_key: str, throttle_key: str) -> bool:
        """Does the indexed pod currently match the throttle?"""
        with self._lock:
            row = self._pod_rows.get(pod_key)
            col = self._thr_cols.get(throttle_key)
            if row is None or col is None:
                return False
            return self.row_has_col(row, col)

    def pod_row(self, pod_key: str) -> Optional[int]:
        with self._lock:
            return self._pod_rows.get(pod_key)

    def throttle_col(self, throttle_key: str) -> Optional[int]:
        with self._lock:
            return self._thr_cols.get(throttle_key)

    def throttle_cols_snapshot(self) -> Dict[str, int]:
        """One-lock-hold copy of the live throttle-key → column map (the
        snapshot/recovery plane walk iterates it outside the lock)."""
        with self._lock:
            return dict(self._thr_cols)

    def generation(self) -> int:
        """Monotonic matching generation: bumped by every column or
        namespace mutation (exactly the probe-cache invalidation signal).
        The verdict cache's per-pod fingerprint memo revalidates against
        this — a stale memo would key verdicts on an outdated matched-cols
        set, which is a correctness bug, not just a perf one."""
        with self._lock:
            return self._gen

    def has_namespace(self, name: str) -> bool:
        """Is the Namespace object known to this index? The clusterthrottle
        oracle answers ERROR for pods of an unknown namespace
        (clusterthrottle_controller.go:273-276) — the verdict cache must
        refuse to fingerprint those pods, or they would collide with
        known-ns pods sharing the same (shape, accel, cols) key."""
        with self._lock:
            return name in self._namespaces

    @property
    def capacities(self) -> Tuple[int, int]:
        with self._lock:
            return self._pcap, self._tcap
