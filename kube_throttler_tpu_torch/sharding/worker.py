"""One keyspace shard: a full engine vertical behind the IPC server.

Each worker process owns its slice of the Throttle/ClusterThrottle
keyspace end to end — store + SelectorIndex + journal + snapshot/
recovery + device planes + micro-batch ingest + both controllers — and
answers the front's scatter-gather RPCs. Nothing is shared between
workers: no locks, no memory, no GIL. Fenced leadership runs
independently per shard when a data dir is given (per-shard epoch file,
per-shard journal fencing; a standby for shard *i* replicates from
shard *i* alone).

Run as a process:

    python -m kube_throttler_tpu_torch.sharding.worker \
        --shard-id 0 --shards 4 --ipc-fd 3 [--data-dir DIR] \
        [--device {cuda,cpu}] [--no-device]

The supervisor passes the socketpair fd; everything else arrives over
the socket (events to ingest, RPCs to answer). A cross-host fleet
worker listens instead of inheriting:

    python -m kube_throttler_tpu_torch.sharding.worker \
        --shard-id 0 --shards 4 --listen 0.0.0.0:7781 [--port-file F]

and serves the SAME framed protocol over TCP (``serve_tcp``): each
accepted connection is one front lane; frames carry the fencing epoch
so a partitioned-then-healed peer is fenced, not trusted.

Two-phase reserve, shard side: ``reserve_prepare`` performs the real
reserve on this shard's matching throttles and parks the transaction in
a pending table; ``txn_commit`` finalizes (drops the table entry, the
reservation stays); ``txn_abort`` unreserves. A prepared transaction
whose front died before deciding is ABORTED by the reaper once it ages
past ``prepare_ttl`` — a prepare-crash can never leave an orphan
reservation (tests/test_sharding.py pins this).

Live resharding, shard side (the ``reshard_*`` RPC family —
sharding/reshard.py drives it): a SOURCE stages its moving keyspace
slice with ``reshard_prepare`` (store objects + reservation ledger
entries + gang records + published statuses, pickled once) and serves it
in prefix-sha-verified chunks (``reshard_chunk``, the StandbyReplicator
chunk contract over the framed-pickle IPC); ``reshard_fence`` makes the
range-scoped fence refuse every later authoritative write for the moved
ranges; ``reshard_retire`` drops the slice after cutover (fence lifted
with it). A DESTINATION assembles chunks (``reshard_import``), applies
the slice into its own engine stack (statuses suppressed — its verdicts
are advisory while warming), and on ``reshard_activate`` re-enqueues
every moved key through the two-lane PRIORITY path so every flip it
computed during warm-up is re-published. ``reshard_abort`` rolls either
side back to the pre-handoff state, and the txn reaper TTLs any handoff
orphaned by a front crash between prepare and cutover — zero orphan
reservations by the same clock that reaps two-phase reserves.

The device is explicit, as everywhere in the port: ``ShardCore(...,
device=None)`` means CUDA and raises without it; the CPU is used only
when ``device="cpu"`` is passed (``--device cpu``). A worker whose device
cannot be resolved, or whose kernels fail to build or launch, exits
non-zero before it serves a frame.
"""

from __future__ import annotations

import argparse
import logging
import os
import socket
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.lockorder import guard_attrs, make_lock

logger = logging.getLogger(__name__)

# control verbs carried in-stream with store ops (front → shard)
RESYNC_PRUNE = "__prune__"


@guard_attrs
class ShardCore:
    """The shard's engine stack + RPC dispatch, transport-agnostic.

    ``push(items)`` (settable) receives ``[(kind, obj), ...]`` status
    events the shard's controllers wrote — the worker main sends them to
    the front as ``push`` frames; tests wire it straight into the
    front's applier.
    """

    GUARDED_BY = {
        "_pending_txns": "self._txn_lock",
        "_pending_gangs": "self._txn_lock",
        "_gang_members": "self._txn_lock",
        "reaped_txns": "self._txn_lock",
        "_handoffs_out": "self._txn_lock",
        "_handoffs_in": "self._txn_lock",
        "reshard_aborts": "self._txn_lock",
        "reaped_handoffs": "self._txn_lock",
        "_push_buf": "self._push_lock",
        "wire_epoch": "self._epoch_lock",
        "fenced_events": "self._epoch_lock",
        "fenced_reqs": "self._epoch_lock",
        "negotiated_proto": "self._epoch_lock",
        "negotiated_caps": "self._epoch_lock",
        "peer_build": "self._epoch_lock",
        "version_mismatches": "self._epoch_lock",
    }

    def __init__(
        self,
        shard_id: int,
        n_shards: int,
        name: str = "kube-throttler",
        target_scheduler: str = "my-scheduler",
        use_device: bool = True,
        data_dir: Optional[str] = None,
        ingest_batch="adaptive",
        faults=None,
        prepare_ttl: float = 30.0,
        snapshot_every: int = 5000,
        device=None,
    ):
        from ..engine.store import Store
        from ..engine.ingest import MicroBatchIngest
        from ..plugin import KubeThrottler, decode_plugin_args

        self.shard_id = shard_id
        self.n_shards = n_shards
        self.faults = faults
        self.prepare_ttl = prepare_ttl
        self.store = Store()
        self.journal = None
        self.recovery = None
        self.snapshotter = None
        self.epoch = None
        self.ha = None
        if data_dir:
            from ..engine.recovery import RecoveryManager
            from ..engine.replication import FencingEpoch, HaCoordinator
            from ..engine.snapshot import SnapshotManager

            os.makedirs(data_dir, exist_ok=True)
            self.recovery = RecoveryManager(data_dir)
            self.journal = self.recovery.recover_store(self.store)
            self.snapshotter = SnapshotManager(data_dir, self.store)
            # fenced leadership, per shard: this process claims a
            # term for ITS keyspace slice; journal appends and snapshot
            # cuts refuse once the epoch goes stale
            self.epoch = FencingEpoch(data_dir)
            self.epoch.observe(self.recovery.report.epoch)
            self.journal.fencing = self.epoch
            self.snapshotter.fencing = self.epoch
            self.ha = HaCoordinator(
                self.epoch, role="leader", journal=self.journal,
                snapshotter=self.snapshotter,
            )
            self.ha.become_leader()
        self.plugin = KubeThrottler(
            decode_plugin_args(
                {"name": name, "targetSchedulerName": target_scheduler}
            ),
            self.store,
            use_device=use_device,
            start_workers=True,
            device=device,
        )
        if self.recovery is not None:
            caches = {
                "throttle": self.plugin.throttle_ctr.cache,
                "clusterthrottle": self.plugin.cluster_throttle_ctr.cache,
            }
            self.recovery.restore_reservations(caches)
            self.plugin.gang.journal = self.journal
            self.recovery.restore_gangs(self.plugin.gang, self.journal)
            self.recovery.reconcile(
                self.plugin.informers,
                device_manager=self.plugin.device_manager,
                enqueue={
                    "throttle": self.plugin.throttle_ctr.enqueue,
                    "clusterthrottle": self.plugin.cluster_throttle_ctr.enqueue,
                },
            )
            self.snapshotter.reservations = caches
            self.snapshotter.gang_ledger = self.plugin.gang
            self.snapshotter.device_manager = self.plugin.device_manager
            self.snapshotter.bind_journal(self.journal, every_lines=snapshot_every)
        if self.plugin.device_manager is not None:
            # as the single daemon does before serving: build and load the
            # kernels and launch each route once, so the first scatter pays
            # no build or first launch; a kernel fault raises here
            self.plugin.device_manager.prewarm()
        if ingest_batch in ("off", "none", "", None):
            ingest_batch = 1
        self.pipeline = MicroBatchIngest(
            self.store, batch_policy=ingest_batch, faults=faults
        )
        # two-phase reserve bookkeeping
        self._txn_lock = make_lock(f"shard.txn.{shard_id}")
        self._pending_txns: Dict[str, Tuple[object, float]] = {}  # txn → (pod, t)
        self._pending_gangs: Dict[str, Tuple[str, float]] = {}  # txn → (group, t)
        # NON-owner shards hold a gang's member reservations as plain
        # reservations (the authoritative ledger record lives only on the
        # group's hash-owner shard): group → member pods, so a rollback
        # releases them without a ledger
        self._gang_members: Dict[str, List[object]] = {}
        self.reaped_txns = 0
        # live resharding: staged outbound slices (this shard is a handoff
        # SOURCE), assembling inbound slices (DESTINATION), and the
        # range-scoped fence the event path consults post-cutover
        from ..engine.replication import RangeFence

        self._handoffs_out: Dict[str, dict] = {}  # handoff → staged slice
        self._handoffs_in: Dict[str, dict] = {}  # handoff → assembling sink
        self.range_fence = RangeFence()
        self.reshard_aborts = 0
        # bound by worker main() when a shared-memory event ring is
        # attached (ShmEventPump); stats/metrics sample it read-only
        self.shm_pump = None
        self.reaped_handoffs = 0
        # status push plumbing: handlers append under the push lock (they
        # run inside the store lock and must stay informer-cheap); the
        # pusher thread flushes batches to ``push``
        self.push = None  # set by the transport wrapper
        self._push_lock = make_lock(f"shard.push.{shard_id}")
        self._push_cond = threading.Condition(self._push_lock)
        self._push_buf: List[Tuple[str, object]] = []
        # wire fencing (sharding/ipc.py): the max fencing epoch seen on
        # ANY connection. The front bumps its counter at the head of
        # every resync, so a frame stamped below this watermark is from
        # before a heal/reshard — fenced, not trusted
        self._epoch_lock = make_lock(f"shard.wire_epoch.{shard_id}")
        self.wire_epoch = 0
        self.fenced_events = 0  # stale-epoch evt ops dropped
        self.fenced_reqs = 0  # stale-epoch RPCs refused (the wire 409)
        # rolling-upgrade handshake outcome (version.py): the negotiated
        # (major, minor) + capability intersection for the current
        # primary lane, and the count of incompatible-major hellos this
        # worker refused with a typed VersionMismatch frame
        self.negotiated_proto: Optional[Tuple[int, int]] = None
        self.negotiated_caps: frozenset = frozenset()
        self.peer_build: Optional[str] = None
        self.version_mismatches = 0
        self._stop = threading.Event()
        for kind in ("Throttle", "ClusterThrottle"):
            self.store.add_event_handler(kind, self._on_status_event, replay=False)
        self._pusher = threading.Thread(
            target=self._push_loop, name=f"shard{shard_id}-push", daemon=True
        )
        self._pusher.start()
        self._reaper = threading.Thread(
            target=self._reap_loop, name=f"shard{shard_id}-reaper", daemon=True
        )
        self._reaper.start()

    # ----------------------------------------------------------- status push

    def _on_status_event(self, event) -> None:
        from ..engine.store import EventType

        if event.type is not EventType.MODIFIED or event.old_obj is None:
            return
        if event.obj.status == event.old_obj.status:
            return  # spec echo routed by the front — not ours to re-publish
        if self._import_pending_covers(event.kind, event.obj):
            # warming destination: verdicts are ADVISORY until cutover —
            # don't push statuses for not-yet-activated ranges (activation
            # re-enqueues every moved key priority-first, so every flip
            # computed during warm-up is re-published then)
            return
        with self._push_cond:
            self._push_buf.append((event.kind, event.obj))
            self._push_cond.notify()

    def _import_pending_covers(self, kind: str, obj) -> bool:
        with self._txn_lock:
            ranges = [
                rng
                for entry in self._handoffs_in.values()
                for rng in entry["ranges"]
            ]
        if not ranges:
            return False
        from .ring import route_key_for, stable_hash64

        h = stable_hash64(route_key_for(kind, obj))
        return any(lo <= h < hi for lo, hi in ranges)

    def _push_loop(self) -> None:
        while not self._stop.is_set():
            # loop-level routing (threads checker): a pusher killed by an
            # unexpected exception would silently stop ALL status flow to
            # the front while every probe stayed green — the silent-
            # replicator-death class, shard-flavored
            try:
                with self._push_cond:
                    while not self._push_buf and not self._stop.is_set():
                        self._push_cond.wait(0.2)
                    buf, self._push_buf = self._push_buf, []
                if buf and self.push is not None:
                    try:
                        self.push(buf)
                    except Exception:  # noqa: BLE001 — front gone; supervisor acts
                        logger.warning("shard %d: status push failed", self.shard_id,
                                       exc_info=True)
            except Exception:  # noqa: BLE001 — keep the pusher alive
                logger.exception("shard %d: push loop error", self.shard_id)
                self._stop.wait(0.05)

    # ---------------------------------------------------------------- fencing

    def observe_epoch(self, epoch: int, mtype: str = "req", n: int = 1) -> bool:
        """Track the max fencing epoch seen on the wire; ``False`` means
        the frame is from the PAST — a partitioned-then-healed peer (or
        bytes that sat in a kernel buffer across a heal) replaying a view
        that missed a resync/reshard — and must be fenced, not trusted."""
        with self._epoch_lock:
            if epoch >= self.wire_epoch:
                self.wire_epoch = epoch
                return True
            if mtype == "evt":
                self.fenced_events += n
            else:
                self.fenced_reqs += 1
            return False

    def current_epoch(self) -> int:
        with self._epoch_lock:
            return self.wire_epoch

    # ------------------------------------------------------------ handshake

    def record_negotiation(self, proto, caps, build) -> None:
        with self._epoch_lock:
            self.negotiated_proto = (int(proto[0]), int(proto[1]))
            self.negotiated_caps = frozenset(caps)
            self.peer_build = build

    def record_version_mismatch(self) -> None:
        with self._epoch_lock:
            self.version_mismatches += 1

    def negotiated_state(self) -> Dict[str, object]:
        """The build_info view: this build's identity plus the current
        primary lane's negotiated version/caps (version.py contracts)."""
        from ..version import BUILD_ID, local_proto_version

        with self._epoch_lock:
            proto = self.negotiated_proto
            caps = self.negotiated_caps
            build = self.peer_build
            mismatches = self.version_mismatches
        return {
            "build": BUILD_ID,
            "proto": list(local_proto_version()),
            "negotiated_proto": None if proto is None else list(proto),
            "negotiated_caps": sorted(caps),
            "peer_build": build,
            "version_mismatches": mismatches,
        }

    # ---------------------------------------------------------------- events

    def handle_events(self, ops: Sequence[Tuple[str, str, object]]) -> None:
        """Apply a routed event batch through the micro-batch pipeline.
        Control ops (resync prune) are handled in-stream, in order."""
        if self.faults is not None:
            fault = self.faults.check("shard.worker.kill")
            if fault is not None and fault.mode == "kill":
                fault.kill()
        fenced = self.range_fence.fenced_handoffs()
        batch: List[Tuple[str, str, object]] = []
        for op in ops:
            if op[0] == RESYNC_PRUNE:
                if batch:
                    self._submit_batch(batch)
                    batch = []
                self._prune(op[2])
                continue
            if fenced and self._fence_refuses(op):
                continue
            batch.append(op)
        if batch:
            self._submit_batch(batch)

    def _submit_batch(self, batch: List[Tuple[str, str, object]]) -> None:
        """Apply a routed batch — and, while a handoff slice is still
        streaming IN, buffer a copy per unsealed handoff: a mirrored
        event that lands mid-stream would otherwise be overwritten by the
        (older) slice snapshot at seal time; the seal replays the buffer
        after the snapshot so the race always resolves newest-last."""
        with self._txn_lock:
            for entry in self._handoffs_in.values():
                if not entry.get("sealed"):
                    entry["evbuf"].append(list(batch))
        self.pipeline.submit_many(batch)

    def _fence_refuses(self, op: Tuple[str, str, object]) -> bool:
        """Post-cutover write refusal: an authoritative throttle-keyspace
        write whose route hash lands in a fenced range is dropped and
        counted — the destination owns that range now; a racing event the
        front routed pre-cutover must not mutate the retiring slice (it
        was mirrored to the destination, so nothing is lost). Pod events
        pass: pods have no range identity and a non-matching pod is inert."""
        verb, kind, payload = op
        if kind not in ("Throttle", "ClusterThrottle"):
            return False
        if verb == "delete":
            return False  # cleanup is always allowed (retire uses it)
        from .ring import route_key_for, stable_hash64

        h = stable_hash64(route_key_for(kind, payload))
        if self.range_fence.covers(h):
            self.range_fence.refuse()
            return True
        return False

    def _prune(self, want: Dict[str, Sequence[str]]) -> None:
        """Resync epilogue: everything this shard holds that the front's
        replay did not name was deleted while the shard was down — drop
        it (the StandbyReplicator bootstrap rule, applied over IPC)."""
        from ..engine.store import key_of

        self.pipeline.flush(timeout=30.0)
        ops = []
        for kind, lister in (
            ("Pod", self.store.list_pods),
            ("Throttle", self.store.list_throttles),
            ("ClusterThrottle", self.store.list_cluster_throttles),
            ("Namespace", self.store.list_namespaces),
        ):
            have = set(want.get(kind, ()))
            for obj in lister():
                if key_of(kind, obj) not in have:
                    ops.append(("delete", kind, key_of(kind, obj)))
        if ops:
            self.store.apply_events(ops)

    # ------------------------------------------------------------------- RPC

    def rpc(self, op: str, payload) -> Tuple[bool, object]:
        """Dispatch one RPC; returns (ok, body). Never raises."""
        try:
            handler = getattr(self, f"_rpc_{op}", None)
            if handler is None:
                return False, f"unknown rpc {op!r}"
            return True, handler(payload)
        except Exception as e:  # noqa: BLE001 — reported to the front
            return False, f"{e.__class__.__name__}: {e}"

    def _rpc_ping(self, _payload):
        return {
            "shard": self.shard_id,
            "epoch": self.epoch.current() if self.epoch is not None else 0,
        }

    def _rpc_pre_filter(self, pod):
        """Shard-local admission check: both kinds' ``check_throttled``
        against this shard's throttles. Returns per-kind name lists —
        the front AND-merges and composes the reason strings."""
        out = {}
        for kind, ctr in (
            ("throttle", self.plugin.throttle_ctr),
            ("clusterthrottle", self.plugin.cluster_throttle_ctr),
        ):
            try:
                active, insufficient, exceeds, _ = ctr.check_throttled(pod, False)
            except Exception as e:  # noqa: BLE001 — the per-kind error contract
                out[kind] = {"error": str(e)}
                continue
            out[kind] = {
                "active": [t.key for t in active],
                "insufficient": [t.key for t in insufficient],
                "exceeds": [t.key for t in exceeds],
            }
        return out

    def _rpc_pre_filter_batch(self, _payload):
        return self.plugin.pre_filter_batch()

    def _rpc_reserve_prepare(self, payload):
        txn, pod = payload["txn"], payload["pod"]
        status = self.plugin.reserve(pod)
        if not status.is_success():
            raise RuntimeError("; ".join(status.reasons) or "reserve failed")
        with self._txn_lock:
            self._pending_txns[txn] = (pod, time.monotonic())
        return True

    def _rpc_txn_commit(self, payload):
        with self._txn_lock:
            self._pending_txns.pop(payload["txn"], None)
            self._pending_gangs.pop(payload["txn"], None)
        return True

    def _rpc_txn_abort(self, payload):
        with self._txn_lock:
            entry = self._pending_txns.pop(payload["txn"], None)
            gang = self._pending_gangs.pop(payload["txn"], None)
        if entry is not None:
            self.plugin.unreserve(entry[0])
        if gang is not None:
            self._gang_release(gang[0])
        return True

    def _rpc_unreserve(self, pod):
        self.plugin.unreserve(pod)
        return True

    def _rpc_gang_check(self, payload):
        status = self.plugin.pre_filter_gang(payload["group"], payload["pods"])
        return {"code": status.code.value, "reasons": list(status.reasons)}

    def _rpc_gang_prepare(self, payload):
        """Gang prepare. On the group's hash-OWNER shard this is the real
        ledger reserve (all-or-nothing locally, GANG journal stamps, TTL
        authority). On other matching shards the members reserve as plain
        reservations — the ledger record exists on exactly one shard."""
        txn, group, pods = payload["txn"], payload["group"], payload["pods"]
        owner = bool(payload.get("owner", True))
        if owner:
            status = self.plugin.reserve_gang(group, pods)
            if not status.is_success():
                raise RuntimeError("; ".join(status.reasons) or "gang reserve failed")
        else:
            reserved: List[object] = []
            try:
                for pod in pods:
                    st = self.plugin.reserve(pod)
                    if not st.is_success():
                        raise RuntimeError("; ".join(st.reasons) or "member reserve failed")
                    reserved.append(pod)
            except Exception:
                for pod in reserved:
                    self.plugin.unreserve(pod)
                raise
            with self._txn_lock:
                self._gang_members[group] = list(pods)
        with self._txn_lock:
            self._pending_gangs[txn] = (group, time.monotonic())
        return True

    def _gang_release(self, group: str) -> None:
        with self._txn_lock:
            members = self._gang_members.pop(group, None)
        if members is not None:
            for pod in members:
                self.plugin.unreserve(pod)
        self.plugin.unreserve_gang(group)  # no-op where no ledger record

    def _rpc_gang_rollback(self, payload):
        self._gang_release(payload["group"])
        return True

    def _rpc_gang_groups(self, _payload):
        """Group keys with live ledger records on this shard (tests pin
        the one-owner property of the authoritative ledger entry)."""
        return sorted(self.plugin.gang.snapshot_state().keys())

    def _rpc_stats(self, _payload):
        from ..metrics import kernel_launch_counts

        ps = self.pipeline.stats()
        dm = self.plugin.device_manager
        with self._txn_lock:
            reaped = self.reaped_txns
            pending = len(self._pending_txns) + len(self._pending_gangs)
            pending_handoffs = len(self._handoffs_out) + len(self._handoffs_in)
            reshard_aborts = self.reshard_aborts
            reaped_handoffs = self.reaped_handoffs
        reservations = sum(
            len(ctr.cache.reserved_pod_keys(tk))
            for ctr in (self.plugin.throttle_ctr, self.plugin.cluster_throttle_ctr)
            for tk in ctr.cache.throttle_keys()
        )
        return {
            "pending_handoffs": pending_handoffs,
            "reshard_aborts": reshard_aborts,
            "reaped_handoffs": reaped_handoffs,
            "fenced_writes_refused": self.range_fence.refused(),
            "fenced_handoffs": self.range_fence.fenced_handoffs(),
            "reservations": reservations,
            "gang_groups": len(self.plugin.gang.snapshot_state()),
            "shard": self.shard_id,
            "ingest": ps,
            "workqueues": {
                "throttle": len(self.plugin.throttle_ctr.workqueue),
                "clusterthrottle": len(self.plugin.cluster_throttle_ctr.workqueue),
            },
            "objects": {
                "pods": len(self.store.list_pods()),
                "throttles": len(self.store.list_throttles()),
                "clusterthrottles": len(self.store.list_cluster_throttles()),
            },
            "reaped_txns": reaped,
            "pending_txns": pending,
            "epoch": self.epoch.current() if self.epoch is not None else 0,
            "wire_epoch": self.current_epoch(),
            "fenced_frames": self._fenced_counts(),
            "version": self.negotiated_state(),
            "shm": (
                {
                    "frames": self.shm_pump.frames,
                    "events": self.shm_pump.events,
                    "depth": self.shm_pump.depth(),
                }
                if self.shm_pump is not None
                else None
            ),
            # where this shard's device data plane runs (None: host
            # oracle only), and its process's kernel launches so far
            "device": str(dm.device) if dm is not None else None,
            "kernel_launches": kernel_launch_counts(),
        }

    def _fenced_counts(self) -> Dict[str, int]:
        with self._epoch_lock:
            return {"events": self.fenced_events, "reqs": self.fenced_reqs}

    def _rpc_drain(self, payload):
        timeout = float(payload.get("timeout", 5.0)) if payload else 5.0
        flushed = self.pipeline.flush(timeout=timeout)
        return {
            "flushed": flushed,
            "queue": self.pipeline.qsize(),
            "workqueues": {
                "throttle": len(self.plugin.throttle_ctr.workqueue),
                "clusterthrottle": len(self.plugin.cluster_throttle_ctr.workqueue),
            },
            "applied": self.pipeline.stats()["events_applied"],
        }

    # ------------------------------------------------- live resharding RPCs

    @staticmethod
    def _parse_ranges(raw) -> List[Tuple[int, int]]:
        return [(int(lo), int(hi)) for lo, hi in raw]

    @staticmethod
    def _hash_in(ranges: Sequence[Tuple[int, int]], h: int) -> bool:
        return any(lo <= h < hi for lo, hi in ranges)

    def _rpc_reshard_prepare(self, payload):
        """SOURCE: stage the moving slice as one pickled blob behind a
        prefix-sha chunk source. The pipeline is flushed first so the
        slice reflects every event routed before the front turned
        double-routing on — the mirror stream covers everything after."""
        import pickle

        from ..engine.store import key_of
        from .ipc import PICKLE_PROTO
        from .ring import route_key_for, stable_hash64

        handoff = payload["handoff"]
        ranges = self._parse_ranges(payload["ranges"])
        self.pipeline.flush(timeout=30.0)
        moved: Dict[str, List[Tuple[str, str]]] = {}  # kind → [(store_key, t.key)]
        objects: Dict[str, list] = {}
        for kind, lister in (
            ("Throttle", self.store.list_throttles),
            ("ClusterThrottle", self.store.list_cluster_throttles),
        ):
            moved[kind] = []
            objects[kind] = []
            for thr in lister():
                h = stable_hash64(route_key_for(kind, thr))
                if self._hash_in(ranges, h):
                    moved[kind].append((key_of(kind, thr), thr.key))
                    objects[kind].append(thr)
        moved_keys = {
            "throttle": {tk for _, tk in moved["Throttle"]},
            "clusterthrottle": {tk for _, tk in moved["ClusterThrottle"]},
        }
        reservations = {}
        for rkind, ctr in (
            ("throttle", self.plugin.throttle_ctr),
            ("clusterthrottle", self.plugin.cluster_throttle_ctr),
        ):
            state = ctr.cache.snapshot_state()
            reservations[rkind] = {
                tk: entry for tk, entry in state.items() if tk in moved_keys[rkind]
            }
        gangs = {
            gk: entry
            for gk, entry in self.plugin.gang.snapshot_state().items()
            if self._hash_in(ranges, stable_hash64(route_key_for("Gang", gk)))
        }
        # pods travel as the full population: every pod on this shard
        # matches SOME local throttle; one matching both a moving and a
        # staying throttle must exist on both sides, and a non-matching
        # extra is inert for verdicts (aggregation is per throttle). The
        # front's routing deletes prune the leftovers on later pod events.
        blob = pickle.dumps(
            {
                "throttles": objects["Throttle"],
                "clusterthrottles": objects["ClusterThrottle"],
                "pods": self.store.list_pods(),
                "reservations": reservations,
                "gangs": gangs,
            },
            protocol=PICKLE_PROTO,
        )
        from ..engine.replication import SliceChunkSource

        entry = {
            "source": SliceChunkSource(blob),
            "ranges": ranges,
            "t0": time.monotonic(),
            "moved": moved,
            "gang_keys": sorted(gangs),
        }
        with self._txn_lock:
            self._handoffs_out[handoff] = entry
        return {
            "bytes": len(blob),
            "throttles": len(moved["Throttle"]) + len(moved["ClusterThrottle"]),
            "pods": len(self.store.list_pods()),
            "gangs": len(gangs),
        }

    def _rpc_reshard_chunk(self, payload):
        """SOURCE: serve one verified slice chunk (the replication wire's
        offset+hash continuity). ``reshard.handoff.torn`` mode ``torn``
        flips a byte so the sink's hash check MUST catch it; mode
        ``error`` tears the stream outright."""
        with self._txn_lock:
            entry = self._handoffs_out.get(payload["handoff"])
        if entry is None:
            raise RuntimeError(f"unknown handoff {payload['handoff']!r}")
        chunk = entry["source"].chunk(payload.get("offset", 0), payload.get("sha", ""))
        if self.faults is not None:
            fault = self.faults.check("reshard.handoff.torn")
            if fault is not None:
                if fault.mode == "torn" and chunk["data"]:
                    data = bytearray(chunk["data"])
                    data[len(data) // 2] ^= 0xFF
                    chunk = dict(chunk, data=bytes(data))
                else:
                    raise OSError(
                        f"injected handoff stream tear (hit {fault.hit})"
                    )
        return chunk

    def _rpc_reshard_import(self, payload):
        """DESTINATION: assemble verified chunks; on the final one, apply
        the slice into this shard's engine stack (objects through the
        normal event path — index/planes follow via handler fan-out —
        then reservation ledgers and gang records). Statuses for these
        ranges stay suppressed until ``reshard_activate``."""
        import pickle

        from ..engine.replication import SliceChunkSink

        handoff = payload["handoff"]
        if self.faults is not None:
            fault = self.faults.check("reshard.dest.crash")
            if fault is not None:
                if fault.mode == "kill":
                    fault.kill()
                raise fault.make_error()
        with self._txn_lock:
            entry = self._handoffs_in.get(handoff)
            if entry is None:
                entry = {
                    "sink": SliceChunkSink(),
                    "ranges": self._parse_ranges(payload["ranges"]),
                    "t0": time.monotonic(),
                    "applied": None,
                    "sealed": False,
                    "evbuf": [],
                }
                self._handoffs_in[handoff] = entry
        entry["sink"].feed(payload["chunk"])
        if not entry["sink"].done:
            return {"done": False, "offset": entry["sink"].offset()}
        slice_doc = pickle.loads(entry["sink"].payload())
        # everything already routed to us must be applied before the
        # snapshot lands (FIFO on the socket guarantees nothing newer is
        # still queued behind this RPC only AFTER the pipeline drains)
        self.pipeline.flush(timeout=30.0)
        ops = [("upsert", "Throttle", t) for t in slice_doc["throttles"]]
        ops += [("upsert", "ClusterThrottle", t) for t in slice_doc["clusterthrottles"]]
        ops += [("upsert", "Pod", p) for p in slice_doc["pods"]]
        for i in range(0, len(ops), 512):
            self.store.apply_events(ops[i : i + 512])
        # seal: replay every routed batch that raced the stream (they
        # post-date the snapshot — newest content re-asserts itself),
        # draining until no new batch sneaks in, then stop buffering
        while True:
            with self._txn_lock:
                evbuf, entry["evbuf"] = entry["evbuf"], []
                if not evbuf:
                    entry["sealed"] = True
                    break
            for batch in evbuf:
                replay = [op for op in batch if op[0] != RESYNC_PRUNE]
                for i in range(0, len(replay), 512):
                    self.store.apply_events(replay[i : i + 512])
        restored = {}
        for rkind, ctr in (
            ("throttle", self.plugin.throttle_ctr),
            ("clusterthrottle", self.plugin.cluster_throttle_ctr),
        ):
            state = slice_doc["reservations"].get(rkind) or {}
            ctr.cache.restore_state(state)
            for tk in state:
                if self.plugin.device_manager is not None:
                    self.plugin.device_manager.on_reservation_change(
                        ctr.KIND, tk, ctr.cache
                    )
            restored[rkind] = sorted(state)
        self.plugin.gang.restore_state(slice_doc["gangs"])
        entry["applied"] = {
            "throttle_keys": {
                "Throttle": [t.key for t in slice_doc["throttles"]],
                "ClusterThrottle": [t.key for t in slice_doc["clusterthrottles"]],
            },
            "reservations": restored,
            "gang_keys": sorted(slice_doc["gangs"]),
        }
        return {
            "done": True,
            "objects": len(ops),
            "gangs": len(slice_doc["gangs"]),
        }

    def _rpc_reshard_fence(self, payload):
        """SOURCE: fence the moved ranges at the handoff's epoch — every
        later authoritative write for them is refused (range-scoped
        FencedEpoch semantics). The fence lifts on retire or abort, or by
        the TTL reaper if the front dies before deciding."""
        handoff = payload["handoff"]
        self.range_fence.fence(
            handoff, self._parse_ranges(payload["ranges"]),
            int(payload.get("epoch", 0)),
        )
        with self._txn_lock:
            entry = self._handoffs_out.get(handoff)
            if entry is not None:
                entry["fenced"] = True
        return True

    def _rpc_reshard_activate(self, payload):
        """DESTINATION cutover: adopt the warmed slice as authoritative
        and re-enqueue every moved key on BOTH controllers' priority
        lanes — every flip computed during warm-up (suppressed as
        advisory) re-publishes flips-first through the two-lane path, so
        nothing the source never committed is lost."""
        handoff = payload["handoff"]
        with self._txn_lock:
            entry = self._handoffs_in.pop(handoff, None)
        if entry is None or entry["applied"] is None:
            raise RuntimeError(f"handoff {handoff!r} not warmed on shard "
                               f"{self.shard_id}")
        requeued = 0
        for kind, ctr in (
            ("Throttle", self.plugin.throttle_ctr),
            ("ClusterThrottle", self.plugin.cluster_throttle_ctr),
        ):
            keys = entry["applied"]["throttle_keys"][kind]
            if keys:
                ctr.workqueue.add_all_priority(keys)
                requeued += len(keys)
        return {"requeued": requeued}

    def _rpc_reshard_retire(self, payload):
        """SOURCE post-cutover: the slice left with the range — delete the
        moved objects, release their reservations, forget their gang
        records, lift the fence. The destination re-published everything;
        keeping a fenced zombie copy would only feed the next resync."""
        handoff = payload["handoff"]
        with self._txn_lock:
            entry = self._handoffs_out.pop(handoff, None)
        if entry is None:
            raise RuntimeError(f"unknown handoff {payload['handoff']!r}")
        dropped = self._drop_slice(
            entry["moved"],
            {
                "throttle": [tk for _, tk in entry["moved"]["Throttle"]],
                "clusterthrottle": [tk for _, tk in entry["moved"]["ClusterThrottle"]],
            },
            entry["gang_keys"],
        )
        self.range_fence.lift(handoff)
        return dropped

    def _rpc_reshard_abort(self, payload):
        """Either side, abort-back-to-source. SOURCE: lift the fence and
        unstage — authority never left. DESTINATION: drop whatever the
        torn handoff imported (objects, reservations, gang records) so no
        orphan reservation and no stale verdict state survives the
        abort."""
        handoff = payload["handoff"]
        with self._txn_lock:
            out_entry = self._handoffs_out.pop(handoff, None)
            in_entry = self._handoffs_in.pop(handoff, None)
            if out_entry is not None or in_entry is not None:
                self.reshard_aborts += 1
        if out_entry is not None:
            self.range_fence.lift(handoff)
        if in_entry is not None and in_entry["applied"] is not None:
            self._drop_imported(in_entry["applied"])
        return {
            "aborted_out": out_entry is not None,
            "aborted_in": in_entry is not None,
        }

    def _rpc_reshard_audit(self, _payload):
        """The zero-orphan witness: reservations held against throttle
        keys this shard's store no longer carries (a handoff that dropped
        the object but leaked its ledger entry), plus any pending handoff
        or standing fence. All three must be zero/empty after every abort
        path — the resharding scenario and the kill matrix gate on it."""
        from ..engine.store import NotFoundError

        orphans = []
        for ctr, getter in (
            (
                self.plugin.throttle_ctr,
                lambda k: self.store.get_throttle(*k.split("/", 1)),
            ),
            (
                self.plugin.cluster_throttle_ctr,
                lambda k: self.store.get_cluster_throttle(k.lstrip("/")),
            ),
        ):
            for tk in ctr.cache.throttle_keys():
                if not ctr.cache.reserved_pod_keys(tk):
                    continue
                try:
                    getter(tk)
                except NotFoundError:
                    orphans.append(tk)
        with self._txn_lock:
            pending = len(self._handoffs_out) + len(self._handoffs_in)
        return {
            "orphan_reservations": sorted(orphans),
            "pending_handoffs": pending,
            "fenced_handoffs": self.range_fence.fenced_handoffs(),
            "fenced_writes_refused": self.range_fence.refused(),
        }

    def _drop_slice(self, moved: Dict[str, list], res_keys: Dict[str, list],
                    gang_keys) -> Dict[str, int]:
        """Remove a slice's footprint from this shard: reservations first
        (so the delete-driven aggregate recompute sees them gone), then
        gang records, then the objects themselves."""
        released = 0
        for rkind, ctr in (
            ("throttle", self.plugin.throttle_ctr),
            ("clusterthrottle", self.plugin.cluster_throttle_ctr),
        ):
            for tk in res_keys.get(rkind, ()):
                for pk in ctr.cache.reserved_pod_keys(tk):
                    if ctr.cache.remove_pod_key(tk, pk):
                        released += 1
                if self.plugin.device_manager is not None:
                    self.plugin.device_manager.on_reservation_change(
                        ctr.KIND, tk, ctr.cache
                    )
        gangs_dropped = self.plugin.gang.drop_groups(gang_keys)
        ops = []
        for kind in ("Throttle", "ClusterThrottle"):
            for store_key, _tk in moved.get(kind, ()):
                ops.append(("delete", kind, store_key))
        if ops:
            self.store.apply_events(ops)
        return {
            "objects": len(ops),
            "reservations": released,
            "gangs": gangs_dropped,
        }

    def _drop_imported(self, applied: Dict) -> None:
        from ..engine.store import NotFoundError, key_of

        moved = {"Throttle": [], "ClusterThrottle": []}
        for kind, getter in (
            ("Throttle", lambda k: self.store.get_throttle(*k.split("/", 1))),
            ("ClusterThrottle", lambda k: self.store.get_cluster_throttle(k.lstrip("/"))),
        ):
            for tk in applied["throttle_keys"][kind]:
                try:
                    obj = getter(tk)
                except NotFoundError:
                    continue
                moved[kind].append((key_of(kind, obj), tk))
        self._drop_slice(moved, applied["reservations"], applied["gang_keys"])

    # ---------------------------------------------------------------- reaper

    def _reap_loop(self) -> None:
        while not self._stop.wait(min(1.0, self.prepare_ttl / 4 or 1.0)):
            # loop-level routing (threads checker): a dead reaper means
            # orphaned prepares hold reservations forever — silently
            try:
                self.reap_stale_txns()
            except Exception:  # noqa: BLE001 — keep the reaper alive
                logger.exception("shard %d: txn reaper error", self.shard_id)

    def reap_stale_txns(self, now: Optional[float] = None) -> int:
        """Abort prepared transactions older than ``prepare_ttl`` (the
        front died between prepare and commit). Returns aborts done."""
        now = time.monotonic() if now is None else now
        stale_pods, stale_gangs = [], []
        with self._txn_lock:
            for txn, (pod, t0) in list(self._pending_txns.items()):
                if now - t0 >= self.prepare_ttl:
                    stale_pods.append(pod)
                    del self._pending_txns[txn]
            for txn, (group, t0) in list(self._pending_gangs.items()):
                if now - t0 >= self.prepare_ttl:
                    stale_gangs.append(group)
                    del self._pending_gangs[txn]
            if stale_pods or stale_gangs:  # an idle pass writes nothing
                self.reaped_txns += len(stale_pods) + len(stale_gangs)
        for pod in stale_pods:
            self.plugin.unreserve(pod)
        for group in stale_gangs:
            self._gang_release(group)
        return len(stale_pods) + len(stale_gangs) + self.reap_stale_handoffs(now)

    def reap_stale_handoffs(self, now: Optional[float] = None) -> int:
        """The two-phase handoff reaper: a handoff orphaned past
        ``prepare_ttl`` (front crashed between prepare and cutover) is
        aborted on whichever side this shard played — the SOURCE lifts
        its fence and unstages (authority never left, so the front's
        still-source routing stays correct), the DESTINATION drops the
        imported slice including every imported reservation. Zero orphan
        reservations by the same clock that reaps two-phase reserves."""
        now = time.monotonic() if now is None else now
        stale_out, stale_in = [], []
        with self._txn_lock:
            for handoff, entry in list(self._handoffs_out.items()):
                if now - entry["t0"] >= self.prepare_ttl:
                    stale_out.append(handoff)
                    del self._handoffs_out[handoff]
            for handoff, entry in list(self._handoffs_in.items()):
                if now - entry["t0"] >= self.prepare_ttl:
                    stale_in.append((handoff, entry))
                    del self._handoffs_in[handoff]
            if stale_out or stale_in:
                self.reaped_handoffs += len(stale_out) + len(stale_in)
        for handoff in stale_out:
            self.range_fence.lift(handoff)
            logger.warning("shard %d: reaped orphaned outbound handoff %s",
                           self.shard_id, handoff)
        for handoff, entry in stale_in:
            if entry["applied"] is not None:
                self._drop_imported(entry["applied"])
            logger.warning("shard %d: reaped orphaned inbound handoff %s",
                           self.shard_id, handoff)
        return len(stale_out) + len(stale_in)

    # ------------------------------------------------------------- lifecycle

    def stop(self) -> None:
        self._stop.set()
        with self._push_cond:
            self._push_cond.notify_all()
        self.pipeline.stop()
        self.plugin.stop()
        if self.snapshotter is not None:
            self.snapshotter.write(reason="shutdown")
        if self.journal is not None:
            self.journal.close()


class ShmEventPump:
    """Worker-side consumer of the shared-memory event ring
    (sharding/shmring.py): one thread pops columnar frames, decodes
    them through a persistent :class:`~.shmring.FrameDecoder`, and
    feeds the batches into the core's ingest path — the same
    ``observe_epoch`` fence and ``handle_events`` entry the socket
    ``evt`` frames use, so the two lanes are semantically identical.

    The reader advances its cursor only AFTER the batch reached the
    ingest pipeline: ``widx - ridx`` stays an honest in-flight count
    for the front's drain gate, and the writer never reclaims arena
    bytes under a frame still being decoded.

    A torn slot commit (or any decode failure) is unrecoverable in
    place — the ring's write cursor is beyond repair from this side —
    so the pump routes it into the worker's own death (``on_fatal``
    shuts the control socket): the supervisor's restart + resync with a
    fresh segment is the repair, exactly like a dead socket.

    ``frames``/``events`` are pump-thread single-writer stats, read at
    scrape by the worker-side shm metrics and the stats RPC."""

    def __init__(self, core: ShardCore, reader, on_fatal):
        self.core = core
        self.reader = reader
        self.on_fatal = on_fatal
        from .shmring import FrameDecoder

        self.decoder = FrameDecoder()
        self.frames = 0
        self.events = 0
        self._stop = False

    def stop(self) -> None:
        self._stop = True

    def depth(self) -> int:
        try:
            return self.reader.depth()
        except (ValueError, OSError):
            return 0

    def run(self) -> None:
        from .shmring import TornSlotError

        try:
            while not self._stop:
                try:
                    view = self.reader.peek(timeout=0.2)
                except TornSlotError as e:
                    logger.error(
                        "shard %d: shm ring torn, dying for restart+resync: %s",
                        self.core.shard_id, e,
                    )
                    self.on_fatal()
                    return
                if view is None:
                    continue
                try:
                    epoch, _seq, ops = self.decoder.decode(view)
                finally:
                    del view  # release the exported segment view
                if self.core.observe_epoch(epoch, "evt", len(ops)):
                    self.core.handle_events(ops)
                self.reader.advance()
                self.frames += 1
                self.events += len(ops)
        except Exception:  # noqa: BLE001 — route the death, don't hide it
            logger.exception("shard %d: shm pump died", self.core.shard_id)
            self.on_fatal()


def serve(
    core: ShardCore, sock: socket.socket, bind_push: bool = True,
    auth_key: Optional[bytes] = None,
) -> None:
    """The worker's IPC loop: read frames until EOF. Events apply via the
    ingest pipeline (non-blocking); RPCs answer from a small pool so a
    long batch call cannot park the event stream.

    Over TCP every accepted connection runs its own ``serve()`` against
    the shared core (``bind_push=False``): the client's primary lane
    subscribes to the push stream with a ``sub`` frame, extra lanes are
    parallel RPC lanes. Responses and pushes are stamped with the max
    fencing epoch the core has seen; stale-epoch frames are fenced —
    ``evt`` batches dropped, ``req`` refused with a ``FencedError`` body
    (the wire-level 409).

    ``auth_key`` arms per-frame HMAC auth (cross-host mode): inbound
    frames that fail the MAC die as a torn stream BEFORE the pickle
    deserializer runs, outbound frames are stamped so the front's keyed
    reader accepts them. Keyless is the trusted-local posture
    (socketpair children, loopback test rigs)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..version import (
        BUILD_ID,
        NegotiationError,
        advertised_capabilities,
        local_proto_version,
        negotiate,
    )
    from .ipc import decode_evt_batch, read_frame, send_frame

    send_lock = make_lock(f"shard.serve.{core.shard_id}")

    def push(items) -> None:
        send_frame(sock, send_lock, "push", 0, items,
                   epoch=core.current_epoch(), faults=core.faults,
                   key=auth_key)

    if bind_push:
        core.push = push
    pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="shard-rpc")
    rfile = sock.makefile("rb")

    def answer(rid: int, op: str, payload) -> None:
        result = core.rpc(op, payload)
        try:
            send_frame(sock, send_lock, "res", rid, result,
                       epoch=core.current_epoch(), faults=core.faults,
                       key=auth_key)
        except OSError:
            pass  # front went away; the supervisor restarts us if needed

    def refuse(rid: int, stale_epoch: int) -> None:
        body = (
            False,
            f"FencedError: stale epoch {stale_epoch} < {core.current_epoch()}",
        )
        try:
            send_frame(sock, send_lock, "res", rid, body,
                       epoch=core.current_epoch(), faults=core.faults,
                       key=auth_key)
        except OSError:
            pass

    try:
        while True:
            frame = read_frame(rfile, core.faults, key=auth_key)
            if frame is None:
                return
            mtype, rid, body, epoch = frame
            if mtype == "evt":
                ops = decode_evt_batch(body)
                if not core.observe_epoch(epoch, "evt", len(ops)):
                    continue  # a stale peer's events must not touch state
                core.handle_events(ops)
            elif mtype == "req":
                if not core.observe_epoch(epoch):
                    pool.submit(refuse, rid, epoch)
                    continue
                op, payload = body
                pool.submit(answer, rid, op, payload)
            elif mtype == "sub":
                if not core.observe_epoch(epoch, "sub"):
                    # a STALE sub is counted fenced and must not rebind
                    # the push stream: a partitioned-then-healed (not yet
                    # resynced) peer's subscribe would otherwise steal
                    # the lane from the current primary and route every
                    # flip to a connection the fencing contract says not
                    # to trust
                    continue
                # version/capability handshake (version.py): the sub body
                # is the front's hello, or None from a pre-handshake
                # build (negotiates as the zero-capability 1.0 baseline,
                # no reply — it would not understand a hello frame).
                if body is None:
                    core.record_negotiation(
                        (local_proto_version()[0], 0), frozenset(), None
                    )
                    core.push = push
                    continue
                try:
                    proto, caps = negotiate(
                        local_proto_version(), advertised_capabilities(),
                        body.get("proto"), body.get("caps"),
                    )
                except NegotiationError as e:
                    # typed refusal, then DROP this connection: redialing
                    # cannot help until an operator upgrades one side.
                    # Over TCP the process stays up (only this lane
                    # dies); a socketpair child exits and the
                    # supervisor's jittered backoff paces the restarts —
                    # degraded and counted either way, never a hot loop
                    core.record_version_mismatch()
                    logger.warning(
                        "shard %d: refusing handshake: %s", core.shard_id, e
                    )
                    try:
                        send_frame(sock, send_lock, "hello", 0,
                                   {"error": f"VersionMismatch: {e}"},
                                   epoch=core.current_epoch(), key=auth_key)
                    except OSError:
                        pass
                    return
                core.record_negotiation(proto, caps, body.get("build"))
                core.push = push
                try:
                    send_frame(sock, send_lock, "hello", 0,
                               {"proto": list(proto), "caps": sorted(caps),
                                "build": BUILD_ID},
                               epoch=core.current_epoch(), key=auth_key)
                except OSError:
                    pass  # front gone; the reconnect re-handshakes
    except OSError:
        return
    finally:
        pool.shutdown(wait=False)
        rfile.close()


def serve_tcp(
    core: ShardCore, srv: socket.socket, auth_key: Optional[bytes] = None,
) -> None:
    """The worker's TCP accept loop (``--listen``): each accepted
    connection is one front lane served by :func:`serve` against the
    shared core. Returns when the listener socket is closed."""

    def lane(conn: socket.socket, peer) -> None:
        try:
            serve(core, conn, bind_push=False, auth_key=auth_key)
        except Exception:  # noqa: BLE001 — route the death, don't hide it
            logger.exception(
                "shard %d: connection from %s died", core.shard_id, peer
            )
        finally:
            try:
                conn.close()
            except OSError:
                pass

    while True:
        try:
            conn, peer = srv.accept()
        except OSError:
            return  # listener closed: shutdown
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        threading.Thread(
            target=lane, args=(conn, peer),
            name=f"shard{core.shard_id}-conn", daemon=True,
        ).start()


_LOOPBACK_HOSTS = frozenset({"", "localhost", "127.0.0.1", "::1"})


def listen_requires_auth(host: str) -> bool:
    """True when binding ``host`` exposes the framed-pickle protocol
    beyond this machine: a non-loopback listener without frame auth
    hands arbitrary-code-execution to anything that can reach the port
    (see the ipc.py trust-boundary docstring), so :func:`main` refuses
    that combination unless ``--insecure-no-auth`` is explicit."""
    return host not in _LOOPBACK_HOSTS and not host.startswith("127.")


def build_parser() -> argparse.ArgumentParser:
    """The shard worker's argument parser."""
    from ..utils.platform import DEVICE_CHOICES

    parser = argparse.ArgumentParser(prog="kube-throttler-shard")
    parser.add_argument("--shard-id", type=int, required=True)
    parser.add_argument("--shards", type=int, required=True)
    parser.add_argument(
        "--ipc-fd", type=int, default=None,
        help="inherited socketpair fd (supervisor child mode)",
    )
    parser.add_argument(
        "--listen", default="",
        help="serve the framed shard protocol over TCP on host:port "
        "(port 0 = ephemeral) instead of an inherited fd — the "
        "cross-host fleet worker mode",
    )
    parser.add_argument(
        "--port-file", default="",
        help="with --listen: atomically write the bound host:port here "
        "once listening (the spawner's rendezvous, race-free even with "
        "an ephemeral port)",
    )
    parser.add_argument(
        "--auth-key-file", default="",
        help="file holding the fleet's frame-auth pre-shared key (a "
        "mounted Secret); falls back to $KT_SHARD_AUTH_KEY. The frame "
        "payload is pickle — over TCP every frame is HMAC-authenticated "
        "with this key BEFORE deserialization, so only key holders can "
        "speak to the worker. Required for a non-loopback --listen",
    )
    parser.add_argument(
        "--insecure-no-auth", action="store_true",
        help="allow a non-loopback --listen WITHOUT a frame-auth key. "
        "DANGEROUS: any peer that can reach the port gets arbitrary "
        "code execution via a crafted pickle frame — only for networks "
        "where reachability is already locked down out-of-band",
    )
    parser.add_argument(
        "--shm-ring", default="",
        help="name of the supervisor's shared-memory event ring segment "
        "(socketpair child mode); attach failure falls back to pickle "
        "evt frames on the socket and masks the evt-shm capability",
    )
    parser.add_argument(
        "--shm-doorbell-fd", type=int, default=-1,
        help="inherited read end of the ring's doorbell pipe",
    )
    parser.add_argument("--name", default="kube-throttler")
    parser.add_argument("--target-scheduler-name", default="my-scheduler")
    parser.add_argument("--data-dir", default="")
    parser.add_argument("--no-device", action="store_true")
    parser.add_argument(
        "--device", choices=DEVICE_CHOICES, default="cuda",
        help="where the shard's device data plane runs: 'cuda' (default; "
        "exits non-zero without a CUDA device, never falls back) or "
        "'cpu'. Ignored with --no-device",
    )
    parser.add_argument("--ingest-batch", default="adaptive")
    parser.add_argument("--prepare-ttl", type=float, default=30.0)
    parser.add_argument("--fault-seed", type=int, default=0)
    parser.add_argument(
        "--fault-site", default="",
        help="arm one seeded fault rule (site[:mode[:after[:delay]]]) — the "
        "chaos harness's kill/err injection, e.g. shard.worker.kill:kill:25 "
        "or shm.reader.stall:delay:2:0.5",
    )
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from ..utils.platform import select_device

    parser = build_parser()
    args = parser.parse_args(argv)
    if bool(args.listen) == (args.ipc_fd is not None):
        parser.error("exactly one of --ipc-fd and --listen is required")
    auth_key = None
    if args.listen:
        from .ipc import load_auth_key

        auth_key = load_auth_key(args.auth_key_file)
        listen_host = args.listen.rpartition(":")[0]
        if auth_key is None and listen_requires_auth(listen_host):
            if not args.insecure_no_auth:
                parser.error(
                    f"--listen {args.listen}: a non-loopback listener "
                    "requires a frame-auth key (--auth-key-file or "
                    "$KT_SHARD_AUTH_KEY) — the shard protocol is pickled "
                    "Python, and without per-frame HMAC any peer that "
                    "can reach the port gets arbitrary code execution. "
                    "Pass --insecure-no-auth only if reachability is "
                    "locked down out-of-band (NetworkPolicy, private "
                    "network)"
                )

    # the device, resolved before the engine is built: without a CUDA
    # device '--device cuda' exits here rather than serving from the CPU
    try:
        device = select_device(args.device, use_device=not args.no_device)
    except RuntimeError as e:
        print(f"shard {args.shard_id}: device unavailable: {e}",
              file=sys.stderr, flush=True)
        return 1
    # on the card, the kernel libraries are built (or found built) before
    # the engine prewarms them, so a failed build or a kernel folder that
    # cannot be made is reported as serve reports it, not raised; a
    # KernelLaunchError once serving has begun still propagates
    if device is not None and device.type == "cuda":
        from ..kernels import build_all

        try:
            build_all()
        except (RuntimeError, OSError) as e:
            print(f"shard {args.shard_id}: kernel build failed: {e}",
                  file=sys.stderr, flush=True)
            return 1

    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s %(levelname).1s shard{args.shard_id} %(name)s] %(message)s",
    )
    faults = None
    if args.fault_site:
        from ..faults.plan import FaultPlan

        parts = args.fault_site.split(":")
        site = parts[0]
        mode = parts[1] if len(parts) > 1 else "error"
        after = int(parts[2]) if len(parts) > 2 else 0
        delay = float(parts[3]) if len(parts) > 3 else 0.0
        faults = FaultPlan(seed=args.fault_seed).rule(
            site, mode=mode, after=after, times=1, delay=delay
        )
    ingest_batch = args.ingest_batch
    if ingest_batch not in ("adaptive", "off", "none", ""):
        ingest_batch = int(ingest_batch)
    core = ShardCore(
        args.shard_id,
        args.shards,
        name=args.name,
        target_scheduler=args.target_scheduler_name,
        use_device=not args.no_device,
        data_dir=args.data_dir or None,
        ingest_batch=ingest_batch,
        faults=faults,
        prepare_ttl=args.prepare_ttl,
        device=device,
    )
    if args.listen:
        # TCP workers have no shared-memory ring with their front —
        # never advertise the capability
        from ..version import advertised_capabilities

        os.environ["KT_PROTO_CAPS_MASK"] = ",".join(
            sorted(advertised_capabilities() - {"evt-shm"})
        )
        host, _, port = args.listen.rpartition(":")
        if auth_key is None and listen_requires_auth(host):
            logger.warning(
                "listening on %s WITHOUT frame auth (--insecure-no-auth): "
                "any peer that can reach this port can execute arbitrary "
                "code via a crafted pickle frame", args.listen,
            )
        srv = socket.create_server((host or "127.0.0.1", int(port)))
        bound_host, bound_port = srv.getsockname()[:2]
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(f"{bound_host}:{bound_port}\n")
            os.replace(tmp, args.port_file)
        print(
            f"shard {args.shard_id}/{args.shards} listening on "
            f"{bound_host}:{bound_port}",
            flush=True,
        )
        try:
            serve_tcp(core, srv, auth_key=auth_key)
        finally:
            core.stop()
            srv.close()
        return 0
    sock = socket.socket(fileno=args.ipc_fd)
    pump = None
    try:
        if args.shm_ring:
            from .shmring import ShmRingReader

            try:
                reader = ShmRingReader(
                    args.shm_ring,
                    doorbell_rfd=(
                        args.shm_doorbell_fd
                        if args.shm_doorbell_fd >= 0
                        else None
                    ),
                    faults=faults,
                    untrack=True,  # the supervisor owns the segment name
                )
            except Exception:  # noqa: BLE001 — attach fail ⇒ pickle fallback
                logger.exception(
                    "shard %d: shm ring %r attach failed — pickle fallback",
                    args.shard_id, args.shm_ring,
                )
                reader = None
            if reader is not None:

                def _ring_fatal() -> None:
                    # die as a unit: the supervisor's restart + resync
                    # with a fresh segment is the only repair for a
                    # broken ring
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

                pump = ShmEventPump(core, reader, on_fatal=_ring_fatal)
                pump_thread = threading.Thread(
                    target=pump.run,
                    name=f"shard{args.shard_id}-shm",
                    daemon=True,
                )
                pump_thread.start()
                pump.thread = pump_thread
        if pump is None:
            # no attached ring: never advertise the capability — the
            # front must keep evt batches on the socket (pickle
            # fallback)
            from ..version import advertised_capabilities

            os.environ["KT_PROTO_CAPS_MASK"] = ",".join(
                sorted(advertised_capabilities() - {"evt-shm"})
            )
        core.shm_pump = pump  # stats RPC / worker metrics sample this
        if pump is not None:
            from ..metrics import register_shm_worker_metrics

            register_shm_worker_metrics(
                core.plugin.metrics_registry, core, args.shard_id
            )
        print(f"shard {args.shard_id}/{args.shards} ready", flush=True)
        serve(core, sock)
    finally:
        if pump is not None:
            pump.stop()
            thread = getattr(pump, "thread", None)
            if thread is not None:
                thread.join(timeout=1.0)  # let a mid-peek pass finish
            pump.reader.close()
        core.stop()
        sock.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
