"""Columnar arena object store — the interned, struct-of-arrays hot core.

Why (measured, docs/PERFORMANCE.md "What bounds each path"): the
frozen-dict object model was the ceiling everywhere the kernels aren't —
~8k Python status writes/s/core, a 1.4M-object steady-state heap that
forced the gc.freeze posture (500-750 ms gen-2 pauses), per-event
hydration costs, and — since the sharding front keeps a merged store
while each shard keeps its slice — full-object RSS that multiplied with
shard count. A Pod here is ~10 heap objects (Pod, PodSpec, PodStatus,
labels/annotations dicts, container list + Container + requests dict,
strings); at the 1M-pod target that is >10M tracked objects before the
first throttle exists.

The arena replaces per-pod object graphs with columns:

- **InternPool** — one append-only str↔id pool shared by the store's
  pod arena and the selector indexes (names, namespaces, uids, label
  keys AND values intern here);
- **shape tables** — a pod's label set, annotation set, and request
  structure (containers × init-containers × overhead) intern as whole
  shapes: all pods with the same labels share ONE canonical dict, all
  pods with the same resource requests share ONE tuple of Container
  objects and ONE cached ``[(dim, milli)]`` device-encoding row — the
  struct-of-arrays ``[P, R]`` feed with zero per-pod dict hydration;
- **PodArena** — int32 parallel arrays (name/ns/uid/sched/node/phase
  ids + the three shape ids) over recycled slots with generation
  counters; per-pod marginal cost is ~40 bytes of array plus one dict
  entry in the key→slot map.

Full API objects are materialized **lazily at the serialization/API
edge only** (``materialize``): store reads, snapshot/journal writes, and
wire serialization build a real ``api.pod.Pod`` on demand (sharing the
canonical label/annotation dicts and container tuples), and the object
dies young — reference counting frees it without the cycle collector
ever seeing the pod population.

Equivalence: ``materialize(absorb(pod))`` round-trips every field the
wire format carries (pinned by tests/test_columnar_store.py, the
seeded columnar-vs-frozen-dict sweeps, and the snapshot fixtures).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.pod import Container, Pod, PodSpec, PodStatus
from ..quantity import format_quantity, parse_quantity
from ..resourcelist import ResourceList, add, set_max
from ..utils.lockorder import make_lock

__all__ = [
    "InternPool",
    "PodArena",
    "ColumnarEventFrame",
    "render_request_shape",
    "parse_request_shape",
]


def render_request_shape(containers, init_containers, overhead) -> dict:
    """JSON-able render of one request shape — the canonical columnar
    wire form shared by the snapshot-v2 pod block and the shared-memory
    event plane (sharding/shmring.py): quantities out as
    ``format_quantity`` strings, keys sorted, empty sections omitted."""

    def ctrs(cs):
        return [
            [
                c.name,
                {k: format_quantity(v) for k, v in sorted((c.requests or {}).items())},
            ]
            for c in cs
        ]

    out = {"containers": ctrs(containers)}
    if init_containers:
        out["initContainers"] = ctrs(init_containers)
    if overhead:
        out["overhead"] = {
            k: format_quantity(v) for k, v in sorted(overhead.items())
        }
    return out


def parse_request_shape(d: dict) -> tuple:
    """Inverse of :func:`render_request_shape`:
    ``(containers, init_containers, overhead)`` with shared Container
    tuples and parsed quantities — every pod of the same shape can share
    one decode."""

    def parse_ctrs(items):
        return tuple(
            Container(
                requests={k: parse_quantity(v) for k, v in reqs.items()}, name=name
            )
            for name, reqs in items
        )

    return (
        parse_ctrs(d.get("containers", [])),
        parse_ctrs(d.get("initContainers", [])),
        {k: parse_quantity(v) for k, v in d["overhead"].items()}
        if d.get("overhead")
        else None,
    )


class InternPool:
    """Append-only string interner: ``id_of`` assigns dense ids,
    ``name_of`` reverses them. Thread-safe: misses take the lock; hits
    are plain dict reads (coherent under the GIL — the dict only ever
    grows). Compatible with SelectorIndex's ``_Interner`` duck type so
    one pool can back both the arena and the label indexes."""

    __slots__ = ("_ids", "_names", "_lock")

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._names: List[str] = []
        self._lock = threading.Lock()

    def id_of(self, value: str) -> int:
        idx = self._ids.get(value)
        if idx is not None:
            return idx
        with self._lock:
            idx = self._ids.get(value)
            if idx is None:
                idx = len(self._names)
                self._names.append(value)
                self._ids[value] = idx
            return idx

    def name_of(self, idx: int) -> str:
        return self._names[idx]

    def __len__(self) -> int:
        return len(self._names)


class _ReqShape:
    """One interned request structure: the canonical containers /
    init-containers / overhead triple, its materialized (shared)
    objects, and the derived encodings every consumer of "what does
    this pod request" needs — computed once per distinct shape instead
    of once per pod event."""

    __slots__ = ("containers", "init_containers", "overhead", "_eff", "_entries")

    def __init__(self, containers, init_containers, overhead) -> None:
        self.containers: Tuple[Container, ...] = containers
        self.init_containers: Tuple[Container, ...] = init_containers
        self.overhead: Optional[ResourceList] = overhead
        self._eff: Optional[ResourceList] = None
        # {id(dims): [(dim index, milli)]} — see PodArena.entries_for
        self._entries: Dict[int, list] = {}

    def effective(self) -> ResourceList:
        """The pod's effective request (resourcelist.go:27-46 semantics:
        max(per-init max, sum of app containers) + overhead), cached.
        Returns the SHARED dict — callers must not mutate."""
        if self._eff is None:
            ic: ResourceList = {}
            for c in self.init_containers:
                set_max(ic, c.requests)
            res: ResourceList = {}
            for c in self.containers:
                add(res, c.requests)
            set_max(res, ic)
            if self.overhead:
                add(res, self.overhead)
            self._eff = res
        return self._eff


class ColumnarEventFrame:
    """The columnar batch payload accompanying one dispatched event
    batch: parallel columns (verb/kind codes, keys, rvs, arena slots)
    instead of N object-bearing Events. Batch listeners that prefer
    flat arrays (the sharding front's router, and the zero-copy IPC
    rings of ``sharding/shmring.py``) read this; everyone else keeps consuming
    the Event list. Slots are -1 for non-pod events and for the
    frozen-dict reference store."""

    VERBS = {"ADDED": 0, "MODIFIED": 1, "DELETED": 2}
    KINDS = {"Pod": 0, "Namespace": 1, "Throttle": 2, "ClusterThrottle": 3}

    __slots__ = ("verbs", "kinds", "keys", "rvs", "slots", "arena")

    def __init__(self, events, key_of: Callable, arena: Optional["PodArena"]) -> None:
        n = len(events)
        self.verbs = np.empty(n, dtype=np.int8)
        self.kinds = np.empty(n, dtype=np.int8)
        self.rvs = np.empty(n, dtype=np.int64)
        self.slots = np.full(n, -1, dtype=np.int32)
        self.keys: List[str] = []
        self.arena = arena
        slot_of = arena.slot_of if arena is not None else None
        for i, ev in enumerate(events):
            self.verbs[i] = self.VERBS[ev.type.value]
            self.kinds[i] = self.KINDS[ev.kind]
            self.rvs[i] = ev.rv if ev.rv is not None else -1
            key = key_of(ev.kind, ev.obj)
            self.keys.append(key)
            if slot_of is not None and ev.kind == "Pod" and ev.type.value != "DELETED":
                slot = slot_of(key)
                if slot is not None:
                    self.slots[i] = slot

    def __len__(self) -> int:
        return len(self.keys)


def _canon_requests(requests) -> tuple:
    return tuple(sorted(requests.items()))


def _canon_containers(containers) -> tuple:
    return tuple((c.name, _canon_requests(c.requests)) for c in containers)


class PodArena:
    """Struct-of-arrays pod storage with slot recycling and generation
    counters.

    Locking: the arena carries its own LEAF lock — it never acquires
    another lock while held (the intern pool's internal mutex is a plain
    untracked primitive), so any component may materialize through it
    regardless of what else it holds. Mutations (absorb/free) happen
    under the store lock AND the arena lock; lazy readers (resolvers,
    metrics, snapshot export) take only the arena lock, which is what
    lets the selector indexes resolve pods without a store→index /
    index→store order cycle."""

    _GROW = 2

    # every column/table below moves only under the arena's leaf lock
    GUARDED_BY = {
        "_free": "self.lock",
        "_next": "self.lock",
        # _cap/_slots are deliberately unlisted: _grow_locked/_absorb_locked
        # mutate them under the lock, while slot_of/__contains__/keys serve
        # GIL-coherent lock-free dict reads (single-mutator via the store)
        "_label_ids": "self.lock",
        "_label_shapes": "self.lock",
        "_ann_ids": "self.lock",
        "_ann_shapes": "self.lock",
        "_req_ids": "self.lock",
        "_dims_refs": "self.lock",
        # _req_shapes is deliberately unlisted: the list is append-only
        # under the lock and hot readers (req_shape_of / entries_for's
        # first probe) index it lock-free — GIL-coherent like the intern
        # pool's dict reads
    }

    def __init__(self, pool: Optional[InternPool] = None, capacity: int = 64) -> None:
        self.lock = make_lock("store.arena")
        self.pool = pool or InternPool()
        # identity token stamped on absorbed/materialized pods next to
        # their request-shape id: a shape id is meaningless outside ITS
        # arena (a pickled pod crossing the shard IPC, or an oracle
        # store's pod probed against the serving stack, would otherwise
        # resolve against the wrong shape table — silently wrong request
        # rows). Unpickling clones the token, so foreign pods always
        # fail the identity check and take the full encode path.
        self.token = object()
        self._cap = max(8, int(capacity))
        # parallel columns: identity + spec scalars + the three shape ids
        zi = lambda: np.full(self._cap, -1, dtype=np.int32)
        self.name_id = zi()
        self.ns_id = zi()
        self.uid_id = zi()
        self.sched_id = zi()
        self.node_id = zi()
        self.phase_id = zi()
        self.labels_sid = zi()
        self.ann_sid = zi()
        self.req_sid = zi()
        self.gen = np.zeros(self._cap, dtype=np.int32)
        self.valid = np.zeros(self._cap, dtype=bool)
        self._free: List[int] = []
        self._next = 0
        self._slots: Dict[str, int] = {}  # store key -> live slot

        # shape tables: canonical key -> shape id; shape id -> shared object
        self._label_ids: Dict[tuple, int] = {}
        self._label_shapes: List[Dict[str, str]] = []
        self._ann_ids: Dict[tuple, int] = {}
        self._ann_shapes: List[Dict[str, str]] = []
        self._req_ids: Dict[tuple, int] = {}
        self._req_shapes: List[_ReqShape] = []
        # strong refs to DimRegistry objects entries_for has cached
        # against (keyed by id() — the ref pins the id)
        self._dims_refs: Dict[int, object] = {}

        # stats (metrics.register_store_metrics samples these)
        self.materializations_total = 0
        self.recycled_total = 0
        self.absorbed_total = 0

    # -- capacity ---------------------------------------------------------

    def _grow_locked(self) -> None:
        new_cap = self._cap * self._GROW
        for name in (
            "name_id", "ns_id", "uid_id", "sched_id", "node_id", "phase_id",
            "labels_sid", "ann_sid", "req_sid",
        ):
            arr = getattr(self, name)
            grown = np.full(new_cap, -1, dtype=np.int32)
            grown[: self._cap] = arr
            setattr(self, name, grown)
        grown_gen = np.zeros(new_cap, dtype=np.int32)
        grown_gen[: self._cap] = self.gen
        self.gen = grown_gen
        grown_valid = np.zeros(new_cap, dtype=bool)
        grown_valid[: self._cap] = self.valid
        self.valid = grown_valid
        self._cap = new_cap

    # -- shape interning --------------------------------------------------

    def _labels_shape_locked(self, labels: Dict[str, str], table, ids) -> int:
        key = tuple(sorted(labels.items()))
        sid = ids.get(key)
        if sid is None:
            sid = len(table)
            table.append(dict(key))
            ids[key] = sid
        return sid

    def _req_shape_locked(self, spec: PodSpec) -> int:
        key = (
            _canon_containers(spec.containers),
            _canon_containers(spec.init_containers),
            _canon_requests(spec.overhead) if spec.overhead else None,
        )
        sid = self._req_ids.get(key)
        if sid is None:
            sid = len(self._req_shapes)
            containers = tuple(
                Container(requests=dict(reqs), name=name) for name, reqs in key[0]
            )
            init = tuple(
                Container(requests=dict(reqs), name=name) for name, reqs in key[1]
            )
            overhead = dict(key[2]) if key[2] is not None else None
            self._req_shapes.append(_ReqShape(containers, init, overhead))
            self._req_ids[key] = sid
        return sid

    def request_shape_id(self, spec: PodSpec) -> int:
        """Intern ``spec``'s request shape and return its id — the public
        entry for consumers holding a pod that was never absorbed (e.g. a
        scheduler-fresh PreFilter pod): the verdict cache keys on the
        shape id, and an unpickled/foreign pod object carries no stamped
        ``_kt_req_sid``. Interning (not hashing) keeps the id space shared
        with absorbed pods, so fresh and stored pods of the same shape
        land on the same cache rows."""
        with self.lock:
            return self._req_shape_locked(spec)

    # -- absorb / free ----------------------------------------------------

    def absorb(self, key: str, pod: Pod) -> int:
        """Write ``pod`` into the arena (new slot, or overwriting the key's
        live slot) and CANONICALIZE the object in place: its labels and
        annotations are swapped for the equal shared shape dicts, and the
        request-shape id is stamped on it (``_kt_req_sid``) so downstream
        consumers (index retention, the device encode) key into shared
        state instead of keeping per-pod copies alive."""
        with self.lock:
            return self._absorb_locked(key, pod)

    def _absorb_locked(self, key: str, pod: Pod) -> int:
        slot = self._slots.get(key)
        if slot is None:
            if self._free:
                slot = self._free.pop()
            else:
                slot = self._next
                self._next += 1
                while slot >= self._cap:
                    self._grow_locked()
            self._slots[key] = slot
        pool = self.pool
        self.name_id[slot] = pool.id_of(pod.name)
        self.ns_id[slot] = pool.id_of(pod.namespace)
        self.uid_id[slot] = pool.id_of(pod.uid)
        self.sched_id[slot] = pool.id_of(pod.spec.scheduler_name)
        self.node_id[slot] = pool.id_of(pod.spec.node_name)
        self.phase_id[slot] = pool.id_of(pod.status.phase)
        lsid = self._labels_shape_locked(pod.labels, self._label_shapes, self._label_ids)
        asid = self._labels_shape_locked(pod.annotations, self._ann_shapes, self._ann_ids)
        rsid = self._req_shape_locked(pod.spec)
        self.labels_sid[slot] = lsid
        self.ann_sid[slot] = asid
        self.req_sid[slot] = rsid
        self.gen[slot] += 1
        self.valid[slot] = True
        self.absorbed_total += 1
        # canonicalize: share the interned dicts (equal content, shared
        # identity — makes the index's unchanged-labels check an identity
        # hit and drops the per-pod dict from the live heap)
        pod.labels = self._label_shapes[lsid]
        pod.annotations = self._ann_shapes[asid]
        pod.__dict__["_kt_req_sid"] = rsid
        pod.__dict__["_kt_arena"] = self.token
        return slot

    def free(self, key: str) -> Optional[int]:
        with self.lock:
            return self._free_locked(key)

    def _free_locked(self, key: str) -> Optional[int]:
        slot = self._slots.pop(key, None)
        if slot is None:
            return None
        self.valid[slot] = False
        self.gen[slot] += 1
        self._free.append(slot)
        self.recycled_total += 1
        return slot

    # -- reads ------------------------------------------------------------

    def slot_of(self, key: str) -> Optional[int]:
        return self._slots.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._slots

    def __len__(self) -> int:
        return len(self._slots)

    def keys(self):
        return self._slots.keys()

    def materialize(self, slot: int) -> Pod:
        """Build a full API Pod from the columns (the lazy edge). The
        labels/annotations dicts and Container objects are the SHARED
        canonical shapes — immutable by store convention."""
        with self.lock:
            return self._materialize_locked(slot)

    def _materialize_locked(self, slot: int) -> Pod:
        self.materializations_total += 1
        names = self.pool.name_of
        shape = self._req_shapes[self.req_sid[slot]]
        rsid = int(self.req_sid[slot])
        pod = Pod(
            name=names(self.name_id[slot]),
            namespace=names(self.ns_id[slot]),
            labels=self._label_shapes[self.labels_sid[slot]],
            annotations=self._ann_shapes[self.ann_sid[slot]],
            uid=names(self.uid_id[slot]),
            spec=PodSpec(
                scheduler_name=names(self.sched_id[slot]),
                node_name=names(self.node_id[slot]),
                containers=list(shape.containers),
                init_containers=list(shape.init_containers),
                overhead=shape.overhead,
            ),
            status=PodStatus(phase=names(self.phase_id[slot])),
        )
        pod.__dict__["_kt_req_sid"] = rsid
        pod.__dict__["_kt_arena"] = self.token
        return pod

    def materialize_key(self, key: str) -> Optional[Pod]:
        with self.lock:
            slot = self._slots.get(key)
            return self._materialize_locked(slot) if slot is not None else None

    # -- derived encodings -------------------------------------------------

    def req_shape_of(self, sid: int) -> _ReqShape:
        return self._req_shapes[sid]

    def entries_for(self, sid: int, dims) -> list:
        """``[(dim index, milli)]`` of request shape ``sid`` against the
        given DimRegistry — the canonical device row encode, computed
        once per (shape, registry) instead of once per pod event (dim
        indexes are append-only stable, so the cache never invalidates).
        This is the zero-hydration feed from the arena into the device
        staging's ``[P, R]`` planes."""
        from ..ops.schema import to_milli

        shape = self._req_shapes[sid]
        entries = shape._entries.get(id(dims))
        if entries is None:
            with self.lock:
                entries = shape._entries.get(id(dims))
                if entries is None:
                    self._dims_refs[id(dims)] = dims
                    entries = [
                        (dims.index_of(name), to_milli(q))
                        for name, q in shape.effective().items()
                    ]
                    shape._entries[id(dims)] = entries
        return entries

    # -- stats -------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self.lock:
            return self._stats_locked()

    def _stats_locked(self) -> Dict[str, int]:
        return {
            "slots_live": len(self._slots),
            "slots_recycled_total": self.recycled_total,
            "intern_pool_size": len(self.pool),
            "label_shapes": len(self._label_shapes),
            "annotation_shapes": len(self._ann_shapes),
            "request_shapes": len(self._req_shapes),
            "materializations_total": self.materializations_total,
            "absorbed_total": self.absorbed_total,
        }

    # -- snapshot v2 columnar block ----------------------------------------

    def export_columns(self, keys: Sequence[str]) -> Dict[str, Any]:
        """JSON-able columnar pod block for snapshot v2 — a LOCAL string
        table plus per-pod id rows in ``keys`` order. ~30 bytes of JSON
        per pod instead of ~1 KB of manifest dict (and no per-pod object
        materialization on the write path). Caller coherence: runs under
        the store lock (the snapshot gather), plus the arena lock here."""
        with self.lock:
            return self._export_columns_locked(keys)

    def _export_columns_locked(self, keys: Sequence[str]) -> Dict[str, Any]:
        local: Dict[int, int] = {}
        strings: List[str] = []

        def lid(gid: int) -> int:
            out = local.get(gid)
            if out is None:
                out = len(strings)
                strings.append(self.pool.name_of(gid))
                local[gid] = out
            return out

        cols: Dict[str, List[int]] = {
            f: [] for f in ("name", "ns", "uid", "sched", "node", "phase",
                            "labels", "ann", "req")
        }
        used_label: Dict[int, int] = {}
        used_ann: Dict[int, int] = {}
        used_req: Dict[int, int] = {}
        label_shapes: List[list] = []
        ann_shapes: List[list] = []
        req_shapes: List[dict] = []

        def shape_lid(sid, used, out_list, render):
            out = used.get(sid)
            if out is None:
                out = len(out_list)
                out_list.append(render(sid))
                used[sid] = out
            return out

        def render_labels(table):
            return lambda sid: [[k, v] for k, v in sorted(table[sid].items())]

        def render_req(sid):
            shape = self._req_shapes[sid]
            return render_request_shape(
                shape.containers, shape.init_containers, shape.overhead
            )

        for key in keys:
            slot = self._slots[key]
            cols["name"].append(lid(int(self.name_id[slot])))
            cols["ns"].append(lid(int(self.ns_id[slot])))
            cols["uid"].append(lid(int(self.uid_id[slot])))
            cols["sched"].append(lid(int(self.sched_id[slot])))
            cols["node"].append(lid(int(self.node_id[slot])))
            cols["phase"].append(lid(int(self.phase_id[slot])))
            cols["labels"].append(
                shape_lid(int(self.labels_sid[slot]), used_label, label_shapes,
                          render_labels(self._label_shapes))
            )
            cols["ann"].append(
                shape_lid(int(self.ann_sid[slot]), used_ann, ann_shapes,
                          render_labels(self._ann_shapes))
            )
            cols["req"].append(
                shape_lid(int(self.req_sid[slot]), used_req, req_shapes, render_req)
            )
        return {
            "strings": strings,
            "labelShapes": label_shapes,
            "annotationShapes": ann_shapes,
            "requestShapes": req_shapes,
            **cols,
        }


def pods_from_columns(block: Dict[str, Any]):
    """Yield ``Pod`` objects from a snapshot-v2 columnar block (the
    migration/read edge — replication bootstrap and recovery both
    consume this). Label/annotation dicts and container objects are
    shared across pods of the same shape, like the live arena."""
    strings = block["strings"]
    label_shapes = [dict(pairs) for pairs in block.get("labelShapes", [])]
    ann_shapes = [dict(pairs) for pairs in block.get("annotationShapes", [])]

    req_shapes = [parse_request_shape(d) for d in block.get("requestShapes", [])]
    n = len(block.get("name", []))
    for i in range(n):
        containers, init, overhead = req_shapes[block["req"][i]]
        yield Pod(
            name=strings[block["name"][i]],
            namespace=strings[block["ns"][i]],
            labels=label_shapes[block["labels"][i]],
            annotations=ann_shapes[block["ann"][i]],
            uid=strings[block["uid"][i]],
            spec=PodSpec(
                scheduler_name=strings[block["sched"][i]],
                node_name=strings[block["node"][i]],
                containers=list(containers),
                init_containers=list(init),
                overhead=overhead,
            ),
            status=PodStatus(phase=strings[block["phase"][i]]),
        )
