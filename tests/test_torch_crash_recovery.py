"""Crash-consistent snapshot/recovery subsystem (engine/snapshot.py,
engine/recovery.py) + the SIGKILL crash-point harness (tools/crashtest.py).

Fast tier covers the snapshot file format (atomicity, checksum fallback,
pruning), the three recovery modes (tail / genesis / snapshot-only), the
divergence reconcile, graceful-shutdown /readyz draining, and ONE seeded
subprocess crash cycle. The full ≥6-site × 3-seed SIGKILL matrix runs
behind ``-m slow`` (also: ``make crash-test``).
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import replace
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.engine.journal import attach
from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
from kube_throttler_tpu_torch.engine.reservations import ReservedResourceAmounts
from kube_throttler_tpu_torch.engine.snapshot import (
    SnapshotError,
    SnapshotManager,
    find_snapshots,
    load_snapshot,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.utils.clock import FakeClock
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

ROOT = Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location(
    "crashtest", ROOT / "tools" / "crashtest_torch.py"
)
crashtest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(crashtest)


def _throttle(name, labels, **threshold):
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(**threshold),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels=labels)),
                )
            ),
        ),
    )


def _bound(pod):
    bound = replace(pod, spec=replace(pod.spec, node_name="node-1"))
    bound.status.phase = "Running"
    return bound


def _populate(store, n_pods=3):
    store.create_namespace(Namespace("default"))
    store.create_throttle(_throttle("t1", {"grp": "a"}, pod=10, requests={"cpu": "2"}))
    for i in range(n_pods):
        store.create_pod(
            _bound(make_pod(f"p{i}", labels={"grp": "a"}, requests={"cpu": "300m"}))
        )


def _dump(store):
    return crashtest._dump_store(store)


class TestSnapshotFile:
    def test_write_load_roundtrip_and_payload_shape(self, tmp_path):
        store = Store()
        journal = attach(store, str(tmp_path / "store.journal"))
        _populate(store)
        cache = ReservedResourceAmounts(4)
        cache.add_pod("default/t1", make_pod("r1", labels={"grp": "a"}), ttl=60.0)
        mgr = SnapshotManager(
            str(tmp_path), store, reservations={"throttle": cache}
        )
        mgr.journal = journal
        path = mgr.write(reason="test")
        assert path is not None and os.path.exists(path)
        payload = load_snapshot(path)
        assert payload["seq"] == 1 and payload["reason"] == "test"
        assert payload["rv"] == store.latest_resource_version
        kinds = [d["kind"] for d in payload["objects"]]
        # namespaces first (replay creation-order dependency); pods live in
        # the v2 columnar block, not the objects list
        assert kinds[0] == "Namespace" and kinds.count("Pod") == 0
        assert len(payload["podColumns"]["name"]) == 3
        # every pod of one test shape interns to ONE request/label shape
        assert len(payload["podColumns"]["requestShapes"]) == 1
        assert len(payload["podColumns"]["labelShapes"]) == 1
        res = payload["reservations"]["throttle"]["default/t1"]["default/r1"]
        assert 0 < res["ttlRemainingSeconds"] <= 60.0
        off, sha = payload["journal"]["offset"], payload["journal"]["sha256"]
        assert off == os.path.getsize(tmp_path / "store.journal") and len(sha) == 64
        journal.close()

    def test_corrupt_snapshot_detected_and_pruning_keeps_newest(self, tmp_path):
        store = Store()
        _populate(store)
        mgr = SnapshotManager(str(tmp_path), store, keep=2)
        paths = [mgr.write() for _ in range(4)]
        kept = find_snapshots(str(tmp_path))
        assert [seq for seq, _ in kept] == [4, 3]  # newest two survive pruning
        # flip one payload byte: the checksum gate must refuse the file
        with open(paths[-1], "r+b") as f:
            f.seek(os.path.getsize(paths[-1]) - 10)
            f.write(b"X")
        with pytest.raises(SnapshotError):
            load_snapshot(paths[-1])

    def test_mid_write_tmp_never_visible_as_snapshot(self, tmp_path):
        # a torn tmp file (crash mid-write) must neither list nor load
        store = Store()
        mgr = SnapshotManager(str(tmp_path), store)
        (tmp_path / "garbage.tmp").write_bytes(b'{"format": "kube-thr')
        assert find_snapshots(str(tmp_path)) == []
        mgr.write()
        assert len(find_snapshots(str(tmp_path))) == 1


class TestRecoveryModes:
    def _churn(self, store, start, n):
        for i in range(start, start + n):
            store.create_pod(
                _bound(
                    make_pod(f"c{i}", labels={"grp": "a"}, requests={"cpu": "100m"})
                )
            )

    def test_tail_replay_equals_genesis_replay(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        store = Store()
        journal = attach(store, str(data / "store.journal"))
        _populate(store)
        mgr = SnapshotManager(str(data), store)
        mgr.journal = journal
        mgr.write()
        self._churn(store, 100, 5)  # tail the snapshot does not carry
        journal.close()

        recovered = Store()
        rec = RecoveryManager(str(data))
        rec.recover_store(recovered).close()
        assert rec.report.journal_mode == "tail"
        assert rec.report.journal_lines_replayed == 5
        assert rec.report.snapshot_objects > 0

        pure = Store()
        attach(pure, str(data / "store.journal")).close()
        assert _dump(recovered) == _dump(pure)

    def test_compaction_after_snapshot_forces_genesis(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        store = Store()
        journal = attach(store, str(data / "store.journal"), compact_after=10_000)
        _populate(store)
        # create+delete BEFORE the snapshot: compaction drops the pair, so
        # the rewritten journal's prefix can no longer hash-match the
        # snapshot's recorded anchor (a pure-ADDED history would compact to
        # a byte-identical prefix and tail mode would stay legitimate)
        store.create_pod(make_pod("ephemeral", labels={"grp": "a"}))
        store.delete_pod("default", "ephemeral")
        mgr = SnapshotManager(str(data), store)
        mgr.journal = journal
        mgr.write()
        self._churn(store, 100, 3)
        journal.compact()  # rewrites the file: the snapshot's anchor is stale
        journal.close()

        recovered = Store()
        rec = RecoveryManager(str(data))
        rec.recover_store(recovered).close()
        assert rec.report.journal_mode == "genesis"
        pure = Store()
        attach(pure, str(data / "store.journal")).close()
        assert _dump(recovered) == _dump(pure)

    def test_snapshot_only_mode_rebuilds_a_complete_journal(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        store = Store()
        journal = attach(store, str(data / "store.journal"))
        _populate(store)
        mgr = SnapshotManager(str(data), store)
        mgr.journal = journal
        mgr.write()
        journal.close()
        os.unlink(data / "store.journal")  # journal lost; snapshot survives

        recovered = Store()
        rec = RecoveryManager(str(data))
        rec.recover_store(recovered).close()
        assert rec.report.journal_mode == "snapshot-only"
        assert len(recovered.list_pods()) == 3

        # invariant: after recovery the journal ALONE reproduces the store
        # (recover_store compacts the fresh log), so a second crash before
        # the next snapshot loses nothing
        pure = Store()
        attach(pure, str(data / "store.journal")).close()
        assert _dump(recovered) == _dump(pure)

    def test_newest_corrupt_snapshot_falls_back_to_older(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        store = Store()
        journal = attach(store, str(data / "store.journal"))
        _populate(store)
        mgr = SnapshotManager(str(data), store, keep=3)
        mgr.journal = journal
        mgr.write()
        self._churn(store, 100, 2)
        newest = mgr.write()
        journal.close()
        with open(newest, "r+b") as f:  # bit rot on the newest snapshot
            f.seek(os.path.getsize(newest) - 5)
            f.write(b"?")

        recovered = Store()
        rec = RecoveryManager(str(data))
        rec.recover_store(recovered).close()
        assert rec.report.snapshots_rejected == 1
        assert rec.report.snapshot_seq == 1  # the older, valid one
        state, detail = rec.health_state()
        assert state == "degraded" and detail["snapshotsRejected"] == 1
        pure = Store()
        attach(pure, str(data / "store.journal")).close()
        assert _dump(recovered) == _dump(pure)

    def test_reservation_restore_via_recovery_rebases_ttls(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        t0 = datetime(2026, 8, 4, tzinfo=timezone.utc)
        clock = FakeClock(t0)
        store = Store()
        journal = attach(store, str(data / "store.journal"))
        _populate(store)
        cache = ReservedResourceAmounts(4, clock=clock)
        cache.add_pod("default/t1", make_pod("keep", labels={"grp": "a"}), ttl=100.0)
        cache.add_pod("default/t1", make_pod("die", labels={"grp": "a"}), ttl=10.0)
        cache.add_pod("default/t1", make_pod("eternal", labels={"grp": "a"}))
        mgr = SnapshotManager(
            str(data), store, reservations={"throttle": cache}, clock=clock
        )
        mgr.journal = journal
        mgr.write()
        journal.close()

        # the process is dead for 50s: "die" (ttl 10s) must NOT resurrect
        restore_clock = FakeClock(t0 + timedelta(seconds=50))
        recovered = Store()
        rec = RecoveryManager(str(data), clock=restore_clock)
        rec.recover_store(recovered).close()
        fresh = ReservedResourceAmounts(4, clock=restore_clock)
        rec.restore_reservations({"throttle": fresh})
        keys = fresh.reserved_pod_keys("default/t1")
        assert keys == {"default/keep", "default/eternal"}
        assert rec.report.reservations_restored == 2
        assert rec.report.reservations_expired_dropped == 1
        # the survivor's budget was rebased, not re-anchored: ~90s remain
        restore_clock.advance(timedelta(seconds=95))
        assert fresh.reserved_pod_keys("default/t1") == {"default/eternal"}


class TestReconcile:
    def _plugin(self, store):
        return KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            store,
            use_device=True,
            start_workers=False,
            device="cpu",
        )

    def test_clean_recovery_reconciles_with_zero_divergence(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        store = Store()
        journal = attach(store, str(data / "store.journal"))
        _populate(store)
        plugin = self._plugin(store)
        plugin.run_pending_once()  # real statuses through the real reconcile
        SnapshotManager(
            str(data), store, device_manager=plugin.device_manager
        ).write()
        plugin.stop()
        journal.close()

        recovered = Store()
        rec = RecoveryManager(str(data))
        rec.recover_store(recovered).close()
        plugin2 = self._plugin(recovered)
        try:
            assert rec.reconcile(plugin2.informers, plugin2.device_manager) == 0
            assert rec.report.divergences == 0
        finally:
            plugin2.stop()

    def test_forced_plane_divergence_is_counted_and_repaired(self, tmp_path):
        import numpy as np

        store = Store()
        _populate(store)
        plugin = self._plugin(store)
        try:
            plugin.run_pending_once()
            dm = plugin.device_manager
            ks = dm.throttle
            col = ks.index.throttle_col("default/t1")
            # sabotage the published plane behind the store's back — the
            # exact artifact a buggy restore would leave
            ks.st_cnt_throttled[col] = not ks.st_cnt_throttled[col]
            rec = RecoveryManager(str("unused-dir"))
            enqueued = []
            n = rec.reconcile(
                plugin.informers,
                dm,
                enqueue={"throttle": enqueued.append, "clusterthrottle": lambda k: None},
            )
            assert n == 1
            assert enqueued == ["default/t1"]
            assert rec.report.repaired_keys == ["throttle/default/t1"]
            state, detail = rec.health_state()
            assert state == "degraded" and detail["reconcileDivergences"] == 1
        finally:
            plugin.stop()


class TestGracefulShutdown:
    def test_mark_draining_flips_readyz_to_503(self):
        import urllib.error
        import urllib.request

        from kube_throttler_tpu_torch.server import ThrottlerHTTPServer

        store = Store()
        _populate(store)
        plugin = self._plugin(store)
        server = ThrottlerHTTPServer(plugin, port=0)
        server.start()
        try:
            url = f"http://127.0.0.1:{server.port}/readyz"
            with urllib.request.urlopen(url, timeout=5) as resp:
                assert resp.status == 200
            server.mark_draining()
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(url, timeout=5)
            assert err.value.code == 503
            body = json.loads(err.value.read())
            assert body["state"] == "down"
            assert body["components"]["shutdown"]["state"] == "down"
            # liveness must stay green: killing the process mid-drain would
            # defeat the final snapshot + journal fsync
            with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=5
            ) as resp:
                assert resp.status == 200
        finally:
            server.stop()
            plugin.stop()

    _plugin = TestReconcile._plugin

    def test_readyz_carries_recovery_and_snapshot_components(self, tmp_path):
        import urllib.request

        from kube_throttler_tpu_torch.server import ThrottlerHTTPServer

        data = tmp_path / "data"
        data.mkdir()
        seed = Store()
        journal = attach(seed, str(data / "store.journal"))
        _populate(seed)
        SnapshotManager(str(data), seed).write()
        journal.close()

        store = Store()
        rec = RecoveryManager(str(data))
        journal2 = rec.recover_store(store)
        plugin = self._plugin(store)
        snapshotter = SnapshotManager(str(data), store)
        snapshotter.bind_journal(journal2, every_lines=1000)
        plugin.health.register("recovery", rec.health_state)
        plugin.health.register("snapshot", snapshotter.health_state)
        plugin.health.register("journal", journal2.health_state)
        server = ThrottlerHTTPServer(plugin, port=0)
        server.start()
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/readyz", timeout=5
            ) as resp:
                body = json.loads(resp.read())
            recovery = body["components"]["recovery"]
            assert recovery["state"] == "ok"
            assert recovery["journalLinesReplayed"] == rec.report.journal_lines_replayed
            assert recovery["snapshotAgeSeconds"] is not None
            assert "reconcileDivergences" in recovery
            assert body["components"]["snapshot"]["state"] == "ok"
            assert body["components"]["journal"]["tornTails"] == 0
        finally:
            server.stop()
            plugin.stop()


class TestCrashHarness:
    def test_seeded_sigkill_smoke(self, tmp_path):
        """Tier-1 smoke: one SIGKILL crash point, full invariant oracle
        (replay + admission + plane + reservation equivalence)."""
        report = crashtest.run_crash_cycle(
            "crash.snapshot.post_rename", 0, str(tmp_path), events=80
        )
        assert report["killed"] is True
        assert report["mode"] in ("tail", "genesis", "snapshot-only")

    def test_gang_partial_reserve_smoke(self, tmp_path):
        """Tier-1 smoke for the gang crash site: SIGKILL mid-group-reserve
        recovers to fully-reserved or fully-rolled-back — run_crash_cycle's
        oracle 5 asserts no partial group and no orphan member
        reservations."""
        report = crashtest.run_crash_cycle(
            "crash.gang.partial_reserve", 0, str(tmp_path), events=120
        )
        assert report["killed"] is True
        assert report["mode"] in ("tail", "genesis", "snapshot-only")

    @pytest.mark.slow
    @pytest.mark.parametrize("site", crashtest.CRASH_SITES)
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sigkill_matrix(self, site, seed, tmp_path):
        """The acceptance matrix: every registered crash.* site × 3 seeds
        recovers with zero invariant-oracle divergence."""
        crashtest.run_crash_cycle(site, seed, str(tmp_path))


class TestSnapshotTailProperty:
    """Property: snapshot-then-replay-tail state equals pure
    replay-from-genesis for arbitrary event sequences."""

    def test_property_snapshot_tail_equals_genesis(self, tmp_path_factory):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=20, deadline=None)
        @given(
            ops=st.lists(
                st.tuples(st.integers(0, 3), st.integers(0, 5)),
                min_size=1,
                max_size=40,
            ),
            cut=st.integers(0, 39),
        )
        def prop(ops, cut):
            data = tmp_path_factory.mktemp("prop")
            store = Store()
            journal = attach(store, str(data / "store.journal"))
            store.create_namespace(Namespace("default"))
            store.create_throttle(
                _throttle("t1", {"grp": "a"}, pod=3, requests={"cpu": "1"})
            )
            mgr = SnapshotManager(str(data), store)
            mgr.journal = journal
            for i, (op, x) in enumerate(ops):
                if i == min(cut, len(ops) - 1):
                    mgr.write()
                name = f"p{x}"
                if op == 0:
                    try:
                        store.create_pod(
                            _bound(
                                make_pod(
                                    name,
                                    labels={"grp": "a"},
                                    requests={"cpu": f"{100 + x}m"},
                                )
                            )
                        )
                    except ValueError:
                        pass
                elif op == 1:
                    try:
                        store.delete_pod("default", name)
                    except KeyError:
                        pass
                elif op == 2:
                    thr = store.get_throttle("default", "t1")
                    store.update_throttle_status(
                        thr.with_status(
                            replace(
                                thr.status, used=ResourceAmount.of(pod=x)
                            )
                        )
                    )
                else:
                    thr = store.get_throttle("default", "t1")
                    store.update_throttle_spec(
                        replace(
                            thr,
                            spec=replace(
                                thr.spec,
                                threshold=ResourceAmount.of(pod=1 + x),
                            ),
                        )
                    )
            journal.close()

            recovered = Store()
            rec = RecoveryManager(str(data))
            rec.recover_store(recovered).close()
            pure = Store()
            attach(pure, str(data / "store.journal")).close()
            assert _dump(recovered) == _dump(pure)

        prop()
