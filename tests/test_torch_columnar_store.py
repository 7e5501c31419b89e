"""Columnar arena store: intern/arena semantics, lazy-edge
materialization round trips, zero per-pod retention, the sparse selector
index vs its dense readout, snapshot v2 + the committed pre-bump (v1)
fixture's migration read path, and the seeded columnar ≡ frozen-dict ≡
batched ≡ sequential equivalence sweep over store dumps, published
``st_*`` planes, and ``pre_filter`` verdicts.
"""

from __future__ import annotations

import gc
import json
import os
import random
import weakref
from dataclasses import replace as _replace

import numpy as np
import pytest

from kube_throttler_tpu_torch.api.pod import Container, Namespace, Pod, PodSpec, PodStatus, make_pod
from kube_throttler_tpu_torch.api.serialization import object_to_dict
from kube_throttler_tpu_torch.engine.columnar import (
    ColumnarEventFrame,
    InternPool,
    PodArena,
    pods_from_columns,
)
from kube_throttler_tpu_torch.engine.index import SelectorIndex
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.quantity import parse_quantity

from tools.harness_torch import (
    build_plugin,
    dump_store,
    make_throttle,
    recompute_status,
    verdicts,
)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _pod(i: int, grp: str = "a", cpu: str = "100m", phase: str = "Running") -> Pod:
    pod = make_pod(
        f"p{i}", labels={"grp": grp}, requests={"cpu": cpu},
        annotations={"note": "x"} if i % 2 else None,
    )
    pod = _replace(pod, spec=_replace(pod.spec, node_name="node-1"))
    pod.status.phase = phase
    return pod


class TestInternPool:
    def test_ids_dense_and_reversible(self):
        pool = InternPool()
        ids = [pool.id_of(s) for s in ("a", "b", "a", "c")]
        assert ids == [0, 1, 0, 2]
        assert [pool.name_of(i) for i in (0, 1, 2)] == ["a", "b", "c"]
        assert len(pool) == 3


class TestPodArena:
    def test_materialize_round_trips_every_wire_field(self):
        arena = PodArena()
        pod = Pod(
            name="rt", namespace="ns1", labels={"a": "1", "b": "2"},
            annotations={"k": "v"}, uid="uid-rt",
            spec=PodSpec(
                scheduler_name="sched", node_name="n1",
                containers=[Container.of({"cpu": "250m", "memory": "1Gi"}, name="app")],
                init_containers=[Container.of({"cpu": "1"}, name="init")],
                overhead={"cpu": parse_quantity("10m")},
            ),
            status=PodStatus(phase="Pending"),
        )
        slot = arena.absorb("ns1/rt", pod)
        out = arena.materialize(slot)
        assert object_to_dict(out) == object_to_dict(pod)
        assert out == pod

    def test_shapes_shared_across_pods(self):
        arena = PodArena()
        a, b = _pod(1, grp="g"), _pod(2, grp="g")
        arena.absorb(a.key, a)
        arena.absorb(b.key, b)
        # canonicalization: both live pods share ONE labels dict and one
        # request shape
        assert a.labels is b.labels
        assert a.__dict__["_kt_req_sid"] == b.__dict__["_kt_req_sid"]
        st = arena.stats()
        assert st["label_shapes"] == 1 and st["request_shapes"] == 1

    def test_slot_recycling_and_generations(self):
        arena = PodArena()
        a = _pod(1)
        slot = arena.absorb(a.key, a)
        gen0 = int(arena.gen[slot])
        assert arena.free(a.key) == slot
        assert arena.stats()["slots_recycled_total"] == 1
        b = _pod(99)
        slot2 = arena.absorb(b.key, b)
        assert slot2 == slot  # recycled
        assert int(arena.gen[slot]) > gen0  # generation moved

    def test_entries_for_cached_per_shape(self):
        from kube_throttler_tpu_torch.ops.schema import DimRegistry

        arena = PodArena()
        dims = DimRegistry()
        a, b = _pod(1, cpu="300m"), _pod(2, cpu="300m")
        arena.absorb(a.key, a)
        arena.absorb(b.key, b)
        e1 = arena.entries_for(a.__dict__["_kt_req_sid"], dims)
        e2 = arena.entries_for(b.__dict__["_kt_req_sid"], dims)
        assert e1 is e2  # same shape → the cached list, not a recompute
        assert e1 == [(dims.index_of("cpu"), 300)]


class TestColumnarStore:
    def test_get_list_materialize_lazily(self):
        store = Store(columnar=True)
        pod = _pod(3)
        store.create_pod(pod)
        before = store.pod_arena.materializations_total
        got = store.get_pod("default", "p3")
        assert got == pod and got is not pod
        assert store.pod_arena.materializations_total == before + 1

    def test_update_event_carries_materialized_old(self):
        store = Store(columnar=True)
        seen = []
        store.create_pod(_pod(4, cpu="100m"))
        store.add_event_handler("Pod", lambda e: seen.append(e), replay=False)
        store.update_pod(_pod(4, cpu="700m"))
        (ev,) = seen
        assert ev.old_obj is not None
        assert ev.old_obj.spec.containers[0].requests["cpu"] == parse_quantity("100m")
        assert ev.obj.spec.containers[0].requests["cpu"] == parse_quantity("700m")

    def test_no_per_pod_object_retention(self):
        # the tentpole invariant: once the event dispatch ends, the full
        # serving stack (store + informers + device mirror + controllers)
        # retains NO per-pod Python objects
        store = Store(columnar=True)
        plugin = build_plugin(store)
        store.create_namespace(Namespace("default"))
        store.create_throttle(make_throttle(0))
        pods = [_pod(i, grp="g0") for i in range(8)]
        refs = [weakref.ref(p) for p in pods]
        for p in pods:
            store.create_pod(p)
        # one more event so devicestate's last-event affected-keys cache
        # (strong ref by design) moves off the batch's final pod
        store.create_pod(_pod(99, grp="zzz"))
        del pods, p
        gc.collect()
        alive = [r for r in refs if r() is not None]
        assert not alive, f"{len(alive)} pod objects still retained"
        # the stack still answers for them (materialized on demand)
        assert len(store.list_pods()) == 9
        assert plugin.device_manager.matched_pods("throttle", "default/t0")

    def test_mutate_and_status_subresource_semantics_unchanged(self):
        store = Store(columnar=True)
        store.create_pod(_pod(5))
        out = store.mutate(
            "Pod", "default/p5", lambda cur: _replace(cur, labels={"grp": "moved"})
        )
        assert out.labels == {"grp": "moved"}
        assert store.get_pod("default", "p5").labels == {"grp": "moved"}

    def test_frame_built_for_on_frame_listeners(self):
        store = Store(columnar=True)
        frames = []

        class L:
            def on_frame(self, frame, events):
                frames.append((frame, events))

            def on_batch(self, events):  # pragma: no cover — on_frame wins
                raise AssertionError("on_frame listeners must get the frame")

        store.add_batch_listener(L())
        store.apply_events(
            [("create", "Pod", _pod(6)), ("create", "Namespace", Namespace("n2"))]
        )
        (frame, events) = frames[0]
        assert isinstance(frame, ColumnarEventFrame)
        assert len(frame) == 2
        assert frame.keys == ["default/p6", "n2"]
        assert frame.kinds.tolist() == [
            ColumnarEventFrame.KINDS["Pod"], ColumnarEventFrame.KINDS["Namespace"]
        ]
        assert frame.slots[0] == store.pod_arena.slot_of("default/p6")
        assert frame.slots[1] == -1
        assert frame.rvs.tolist() == [e.rv for e in events]


class TestSparseIndex:
    def _seeded(self, n_pods=40, n_thr=12, seed=3):
        rng = random.Random(seed)
        idx = SelectorIndex("throttle")
        pods = []
        for i in range(n_pods):
            pod = _pod(i, grp=f"g{rng.randrange(5)}")
            pods.append(pod)
            idx.upsert_pod(pod)
        thrs = []
        for i in range(n_thr):
            t = _replace(make_throttle(i % 5), name=f"t{i}")
            thrs.append(t)
            idx.upsert_throttle(t)
        return idx, pods, thrs, rng

    def test_dense_property_matches_sparse_accessors(self):
        idx, pods, thrs, rng = self._seeded()
        dense = idx.mask
        for pod in pods:
            row = idx.pod_row(pod.key)
            np.testing.assert_array_equal(
                np.flatnonzero(dense[row]), idx.row_cols(row)
            )
        for t in thrs:
            col = idx.throttle_col(t.key)
            np.testing.assert_array_equal(
                np.flatnonzero(dense[:, col]), idx.rows_of_col(col)
            )

    def test_churn_keeps_sparse_consistent(self):
        idx, pods, thrs, rng = self._seeded()
        for _ in range(120):
            verb = rng.choice(["pod", "thr", "rm_pod", "rm_thr"])
            if verb == "pod":
                i = rng.randrange(len(pods))
                pods[i] = _pod(i, grp=f"g{rng.randrange(5)}")
                idx.upsert_pod(pods[i])
            elif verb == "thr":
                i = rng.randrange(len(thrs))
                thrs[i] = _replace(make_throttle(rng.randrange(5)), name=f"t{i}")
                idx.upsert_throttle(thrs[i])
            elif verb == "rm_pod":
                idx.remove_pod(pods[rng.randrange(len(pods))].key)
            else:
                idx.remove_throttle(thrs[rng.randrange(len(thrs))].key)
        dense = idx.mask
        # row/col readouts agree with the dense materialization after churn
        for key, row in list(idx._pod_rows.items()):
            np.testing.assert_array_equal(np.flatnonzero(dense[row]), idx.row_cols(row))
        nnz = dense.sum(axis=1).max() if dense.size else 0
        assert idx.nnz_max() == nnz
        sub_rows = np.array(sorted(idx._pod_rows.values()))[:7]
        if sub_rows.size:
            np.testing.assert_array_equal(dense[sub_rows], idx.mask_rows(sub_rows))

    def test_kcap_growth_on_wide_rows(self):
        idx = SelectorIndex("throttle")
        pod = _pod(0, grp="g0")
        idx.upsert_pod(pod)
        # 20 throttles all matching the one pod: the row outgrows the
        # initial kcap (8) and the sparse plane doubles
        for i in range(20):
            idx.upsert_throttle(_replace(make_throttle(0), name=f"w{i}"))
        row = idx.pod_row(pod.key)
        assert idx.row_cols(row).size == 20
        assert idx.nnz_max() == 20


class TestSnapshotV2Migration:
    def test_prebump_v1_fixture_recovers_bit_identically(self, tmp_path):
        """The committed pre-bump snapshot (pods as manifest dicts,
        header version 1) must recover through engine/recovery.py into
        exactly the store a v2 writer → v2 reader round trip produces."""
        import shutil

        from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
        from kube_throttler_tpu_torch.engine.snapshot import SnapshotManager, load_snapshot

        fixture = os.path.join(FIXTURES, "snapshot-v1-prebump.ktsnap")
        payload = load_snapshot(fixture)  # version-1 header parses
        assert payload["rv"] == 42

        v1_dir = tmp_path / "v1"
        v1_dir.mkdir()
        shutil.copy(fixture, v1_dir / "snapshot-000000000001.ktsnap")
        store_v1 = Store(columnar=True)
        rec = RecoveryManager(str(v1_dir))
        journal = rec.recover_store(store_v1)
        journal.close()
        assert rec.report.snapshot_objects == 9
        assert store_v1.latest_resource_version >= 42

        # the SAME state written by the v2 writer and recovered again
        v2_dir = tmp_path / "v2"
        v2_dir.mkdir()
        mgr = SnapshotManager(str(v2_dir), store_v1)
        path = mgr.write(reason="migrate")
        payload2 = load_snapshot(path)
        assert "podColumns" in payload2  # columnar block, v2 shape
        assert not any(d["kind"] == "Pod" for d in payload2["objects"])
        store_v2 = Store(columnar=True)
        rec2 = RecoveryManager(str(v2_dir))
        rec2.recover_store(store_v2).close()
        assert dump_store(store_v2) == dump_store(store_v1)

    def test_v2_round_trip_frozen_dict_reader(self, tmp_path):
        # a frozen-dict (reference-mode) store recovers a v2 columnar
        # snapshot identically — the migration path runs both directions
        from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
        from kube_throttler_tpu_torch.engine.snapshot import SnapshotManager

        src = Store(columnar=True)
        src.create_namespace(Namespace("default"))
        for i in range(4):
            src.create_pod(_pod(i, grp=f"g{i % 2}", cpu=f"{(i + 1) * 100}m"))
        SnapshotManager(str(tmp_path), src).write()
        dst = Store(columnar=False)
        RecoveryManager(str(tmp_path)).recover_store(dst).close()
        assert dump_store(dst)["Pod"] == dump_store(src)["Pod"]

    def test_unsupported_version_still_rejected(self, tmp_path):
        import hashlib

        from kube_throttler_tpu_torch.engine.snapshot import SnapshotError, parse_snapshot_bytes

        data = json.dumps({"objects": []}).encode()
        header = json.dumps(
            {
                "format": "kube-throttler-snapshot",
                "version": 3,
                "sha256": hashlib.sha256(data).hexdigest(),
                "length": len(data),
            }
        ).encode()
        with pytest.raises(SnapshotError):
            parse_snapshot_bytes(header + b"\n" + data + b"\n")

    def test_pods_from_columns_shares_shapes(self):
        arena = PodArena()
        pods = [_pod(i, grp="same") for i in range(3)]
        for p in pods:
            arena.absorb(p.key, p)
        block = arena.export_columns([p.key for p in pods])
        out = list(pods_from_columns(block))
        assert [object_to_dict(o) for o in out] == [object_to_dict(p) for p in pods]
        assert out[0].labels is out[1].labels  # shared shape on the read side


class TestEquivalenceSweep:
    """Columnar ≡ frozen-dict ≡ batched ≡ sequential, pinned on store
    dumps, published st_* planes, and pre_filter verdicts (the bench
    --mega sweep's committed twin)."""

    def _stream(self, seed, n_pods, n_thr):
        rng = random.Random(seed)
        ops = []
        for i in range(n_thr):
            ops.append(("create", "Throttle", _replace(make_throttle(i % 6), name=f"t{i}")))
        for i in range(n_pods):
            ops.append(("create", "Pod", _pod(i, grp=f"g{rng.randrange(6)}",
                                              cpu=f"{rng.randrange(1, 8) * 100}m")))
        for _ in range(n_pods):
            i = rng.randrange(n_pods)
            verb = rng.choice(["relabel", "resize", "delete", "revive", "finish"])
            if verb == "delete":
                ops.append(("delete", "Pod", f"default/p{i}"))
            elif verb == "finish":
                ops.append(("upsert", "Pod", _pod(i, grp=f"g{rng.randrange(6)}",
                                                  phase="Succeeded")))
            else:
                ops.append(("upsert", "Pod", _pod(i, grp=f"g{rng.randrange(6)}",
                                                  cpu=f"{rng.randrange(1, 8) * 100}m")))
        return ops

    @pytest.mark.parametrize("seed", [0, 7])
    def test_sweep(self, seed):
        ops = self._stream(seed, n_pods=60, n_thr=18)
        ns = Namespace("default")

        def run(columnar, chunk):
            store = Store(columnar=columnar)
            plugin = build_plugin(store)
            store.create_namespace(ns)
            for s in range(0, len(ops), chunk):
                store.apply_events(ops[s : s + chunk])
            for thr in store.list_throttles():
                store.update_throttle_status(recompute_status(store, thr))
            return (
                dump_store(store),
                plugin.device_manager.published_flags(),
                verdicts(plugin, store),
            )

        col_batched = run(True, 32)
        col_seq = run(True, 1)
        ref = run(False, 1)
        assert col_batched[0] == col_seq[0] == ref[0]  # dumps
        assert col_batched[1] == col_seq[1] == ref[1]  # st_* planes
        assert col_batched[2] == col_seq[2] == ref[2]  # verdicts


class TestCrossArenaProbe:
    def test_foreign_pod_never_resolves_against_local_shape_table(self):
        """Regression (found by the sharded bad-day oracle): a pod
        materialized from one store and probed against another stack —
        the front→shard IPC shape, and every oracle sweep — carries its
        OWN arena's request-shape id. Resolving that id against the
        serving arena's table silently encodes the wrong request row;
        the arena token must gate the fast path."""
        # store A interns shapes in the order [7cpu]; store B in the
        # order [100m] — the same sid means different shapes
        store_a = Store(columnar=True)
        store_a.create_pod(_pod(0, grp="g0", cpu="7"))
        probe = store_a.get_pod("default", "p0")  # sid 0 in A = 7 cpu

        store_b = Store(columnar=True)
        plugin_b = build_plugin(store_b)
        store_b.create_namespace(Namespace("default"))
        thr = make_throttle(0)  # grp g0, cpu threshold 1
        store_b.create_throttle(thr)
        store_b.create_pod(_pod(1, grp="g0", cpu="100m"))  # sid 0 in B = 100m

        assert probe.__dict__["_kt_req_sid"] == 0  # ids collide across arenas
        status = plugin_b.pre_filter(probe)
        # 7 cpu > the 1-cpu threshold: pod-requests-exceeds-threshold —
        # with the bug the probe read B's sid-0 shape (100m) and passed
        assert status.code.value != "Success", status
        assert any("exceeds" in r for r in status.reasons), status.reasons

    def test_unpickled_pod_token_never_matches(self):
        import pickle

        store = Store(columnar=True)
        store.create_pod(_pod(0))
        pod = store.get_pod("default", "p0")
        clone = pickle.loads(pickle.dumps(pod))
        assert clone.__dict__.get("_kt_arena") is not store.pod_arena.token


class TestStoreMetrics:
    def test_families_registered_and_sampled(self):
        from kube_throttler_tpu_torch.metrics import METRIC_NAMES, Registry, register_store_metrics

        for fam in (
            "kube_throttler_store_arena_slots_live",
            "kube_throttler_store_arena_slots_recycled_total",
            "kube_throttler_store_intern_pool_size",
            "kube_throttler_store_materializations_total",
        ):
            assert fam in METRIC_NAMES
        store = Store(columnar=True)
        reg = Registry()
        register_store_metrics(reg, store)
        store.create_pod(_pod(1))
        store.get_pod("default", "p1")
        store.delete_pod("default", "p1")
        text = reg.exposition()
        assert "kube_throttler_store_arena_slots_live 0" in text
        assert "kube_throttler_store_arena_slots_recycled_total 1" in text
        assert "kube_throttler_store_materializations_total" in text

    def test_reference_store_is_a_noop(self):
        from kube_throttler_tpu_torch.metrics import Registry, register_store_metrics

        reg = Registry()
        register_store_metrics(reg, Store(columnar=False))
        assert "kube_throttler_store_arena_slots_live" not in reg.exposition()
