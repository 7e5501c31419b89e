"""Active/standby HA subsystem (engine/replication.py + tools/hatest.py):
fenced leadership epochs, journal-tail streaming to warm standbys, and the
kill-the-leader chaos matrix.

Fast tier covers: FencingEpoch persistence + staleness, EPOCH journal
control lines (append/replay/compaction), stale-epoch gates (journal,
snapshot, mockserver status + lease writes, transport FencedError, the
async committer's demotion), the mock.lease fault verbs, the
HttpLeaseElector's monotonic-clock staleness (NTP-step regressions),
FileLeaseElector fd hygiene, in-process leader→standby streaming
convergence (incl. restart resync and divergence detection), the
plugin-less standby HTTP server, promotion flip re-publication, and ONE
seeded kill-the-leader subprocess cycle. The full ha.* site × seed matrix
runs behind ``-m slow`` (also: ``make ha-test``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import threading
import time
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.journal import attach
from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
from kube_throttler_tpu_torch.engine.replication import (
    FencingEpoch,
    HaCoordinator,
    ReplicationDiverged,
    ReplicationServer,
    ReplicationSource,
    StandbyReplicator,
)
from kube_throttler_tpu_torch.engine.snapshot import SnapshotManager, load_snapshot
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.faults.plan import FaultPlan
from kube_throttler_tpu_torch.utils.clock import FakeClock

ROOT = Path(__file__).parent.parent

_spec = importlib.util.spec_from_file_location(
    "hatest", ROOT / "tools" / "hatest_torch.py"
)
hatest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(hatest)
# the workload/oracle helpers live in the shared tools/harness_torch.py;
# keep the historical local names the fixtures below use
from types import SimpleNamespace  # noqa: E402
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

crashtest = SimpleNamespace(
    _throttle=hatest.harness.make_throttle,
    _recompute_status=hatest.harness.recompute_status,
    _dump_store=hatest.harness.dump_store,
    _verdicts=hatest.harness.verdicts,
    _build_plugin=hatest.harness.build_plugin,
)


def _wait(predicate, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


# --------------------------------------------------------------------------
# FencingEpoch
# --------------------------------------------------------------------------


class TestFencingEpoch:
    def test_bump_persists_across_restarts(self, tmp_path):
        e = FencingEpoch(str(tmp_path))
        assert e.current() == 0 and not e.is_stale()
        assert e.bump() == 1
        assert e.bump() == 2
        # a new process over the same data dir resumes past the old term
        e2 = FencingEpoch(str(tmp_path))
        assert e2.current() == 2
        assert e2.bump() == 3

    def test_observe_higher_epoch_fences(self, tmp_path):
        e = FencingEpoch(str(tmp_path))
        e.bump()  # we lead term 1
        e.observe(1)  # our own term echoing back: no-op
        assert not e.is_stale()
        e.observe(3)  # someone took over twice: we are deposed
        assert e.is_stale() and e.current() == 3
        # bump clears staleness (a NEW term we own)
        assert e.bump() == 4 and not e.is_stale()

    def test_memory_only_epoch(self):
        e = FencingEpoch()
        assert e.bump() == 1  # no data dir: no persistence, no crash

    def test_standby_never_claimed_does_not_self_fence(self):
        """A streaming standby legitimately observes every new leader term
        (a leader restart bumps N→N+1 mid-stream). Only a process that
        CLAIMED a term via bump() is deposed by a higher observation —
        a self-fenced standby would reject every replicated event into
        its own journal and silently lose them at the next promotion."""
        e = FencingEpoch()
        e.observe(1)
        e.observe(2)  # leader restarted: new term — normal standby diet
        assert e.current() == 2 and not e.is_stale()
        # once it claims (promotion), a higher term DOES depose it
        assert e.bump() == 3
        e.observe(4)
        assert e.is_stale()


# --------------------------------------------------------------------------
# journal EPOCH lines + fencing gate
# --------------------------------------------------------------------------


class TestJournalEpoch:
    def _journal(self, tmp_path, **kw):
        store = Store()
        journal = attach(store, str(tmp_path / "j.journal"), **kw)
        return store, journal

    def test_epoch_line_roundtrip(self, tmp_path):
        store, journal = self._journal(tmp_path)
        journal.set_epoch(7)
        store.create_namespace(Namespace("default"))
        journal.close()
        store2 = Store()
        j2 = attach(store2, str(tmp_path / "j.journal"))
        assert j2.last_epoch == 7
        assert store2.get_namespace("default") is not None
        j2.close()

    def test_set_epoch_is_monotonic(self, tmp_path):
        _, journal = self._journal(tmp_path)
        journal.set_epoch(5)
        journal.set_epoch(3)  # stale term: ignored
        journal.set_epoch(5)  # duplicate: ignored
        assert journal.last_epoch == 5
        journal.close()
        # exactly ONE epoch line hit the file
        lines = (tmp_path / "j.journal").read_bytes().splitlines()
        assert sum(1 for ln in lines if b'"EPOCH"' in ln) == 1

    def test_compaction_preserves_epoch(self, tmp_path):
        store, journal = self._journal(tmp_path)
        journal.set_epoch(4)
        store.create_namespace(Namespace("default"))
        store.create_pod(make_pod("p1"))
        journal.compact()
        journal.close()
        store2 = Store()
        j2 = attach(store2, str(tmp_path / "j.journal"))
        assert j2.last_epoch == 4, "compaction dropped the fencing term"
        assert len(store2.list_pods()) == 1
        j2.close()

    def test_stale_epoch_append_rejected(self, tmp_path):
        store, journal = self._journal(tmp_path)
        epoch = FencingEpoch()
        epoch.bump()
        journal.fencing = epoch
        store.create_namespace(Namespace("default"))
        pos_before = journal.position()
        epoch.observe(2)  # deposed
        assert epoch.is_stale()
        store.create_pod(make_pod("zombie"))  # store mutates...
        assert journal.stale_epoch_rejected == 1  # ...but the log refuses
        assert journal.position() == pos_before
        state, detail = journal.health_state()
        assert state == "down" and detail["staleEpochRejected"] == 1
        journal.close()

    def test_stale_epoch_batch_rejected(self, tmp_path):
        store, journal = self._journal(tmp_path)
        epoch = FencingEpoch()
        epoch.bump()
        journal.fencing = epoch
        store.create_namespace(Namespace("default"))
        epoch.fence("test")
        store.apply_events(
            [("upsert", "Pod", make_pod(f"z{i}")) for i in range(3)]
        )
        assert journal.stale_epoch_rejected == 3
        journal.close()


# --------------------------------------------------------------------------
# snapshot epoch + fencing gate
# --------------------------------------------------------------------------


class TestSnapshotEpoch:
    def test_epoch_in_header_and_payload(self, tmp_path):
        store = Store()
        journal = attach(store, str(tmp_path / "store.journal"))
        epoch = FencingEpoch(str(tmp_path))
        epoch.bump()
        epoch.bump()
        snap = SnapshotManager(str(tmp_path), store)
        snap.fencing = epoch
        snap.bind_journal(journal, every_lines=0)
        store.create_namespace(Namespace("default"))
        path = snap.write(reason="test")
        payload = load_snapshot(path)
        assert payload["epoch"] == 2
        header = json.loads(open(path, "rb").readline())
        assert header["epoch"] == 2
        journal.close()

    def test_stale_epoch_snapshot_refused(self, tmp_path):
        store = Store()
        epoch = FencingEpoch()
        epoch.bump()
        snap = SnapshotManager(str(tmp_path), store)
        snap.fencing = epoch
        epoch.fence("test")
        assert snap.write(reason="zombie") is None
        assert snap.stale_epoch_rejected == 1
        assert snap.snapshot_failures == 0  # a refusal is not an I/O failure
        state, _ = snap.health_state()
        assert state == "down"

    def test_recovery_surfaces_max_epoch(self, tmp_path):
        store = Store()
        journal = attach(store, str(tmp_path / "store.journal"))
        epoch = FencingEpoch(str(tmp_path))
        epoch.bump()
        snap = SnapshotManager(str(tmp_path), store)
        snap.fencing = epoch
        snap.bind_journal(journal, every_lines=0)
        store.create_namespace(Namespace("default"))
        snap.write(reason="test")
        journal.set_epoch(5)  # journal outran the snapshot's term
        journal.close()
        store2 = Store()
        rec = RecoveryManager(str(tmp_path))
        j2 = rec.recover_store(store2)
        assert rec.report.epoch == 5
        j2.close()


# --------------------------------------------------------------------------
# mockserver fencing + lease fault verbs
# --------------------------------------------------------------------------


@pytest.fixture()
def apiserver():
    from kube_throttler_tpu_torch.client.mockserver import MockApiServer

    server = MockApiServer()
    server.store.create_namespace(Namespace("default"))
    server.start()
    yield server
    server.stop()


class TestMockserverFencing:
    def _client(self, apiserver, epoch=None):
        from kube_throttler_tpu_torch.client.transport import ApiClient, RestConfig

        return ApiClient(
            RestConfig(server=apiserver.url),
            qps=None,
            epoch_provider=(lambda: epoch) if epoch is not None else None,
        )

    def _status_put(self, apiserver, client, thr):
        from kube_throttler_tpu_torch.api.serialization import object_to_dict

        key = f"{thr.namespace}/{thr.name}"
        rv = apiserver.store.resource_version("Throttle", key)
        body = object_to_dict(thr)
        body.setdefault("metadata", {})["resourceVersion"] = str(rv)
        return client.put(
            f"/apis/schedule.k8s.everpeace.github.com/v1alpha1/"
            f"namespaces/{thr.namespace}/throttles/{thr.name}/status",
            body,
        )

    def test_stale_status_write_rejected_and_state_untouched(self, apiserver):
        from kube_throttler_tpu_torch.api.serialization import object_to_dict
        from kube_throttler_tpu_torch.client.transport import FencedError

        thr = crashtest._throttle(0)
        apiserver.store.create_throttle(thr)
        live = apiserver.store.get_throttle("default", thr.name)
        self._status_put(
            apiserver, self._client(apiserver, epoch=2),
            crashtest._recompute_status(apiserver.store, live),
        )
        assert apiserver.fencing_epoch == 2
        before = object_to_dict(apiserver.store.get_throttle("default", thr.name))
        with pytest.raises(FencedError):
            self._status_put(
                apiserver, self._client(apiserver, epoch=1),
                crashtest._recompute_status(apiserver.store, live),
            )
        assert apiserver.stale_rejections() == 1
        assert (
            object_to_dict(apiserver.store.get_throttle("default", thr.name))
            == before
        )

    def test_equal_and_higher_epochs_accepted(self, apiserver):
        thr = crashtest._throttle(1)
        apiserver.store.create_throttle(thr)
        live = apiserver.store.get_throttle("default", thr.name)
        for epoch in (3, 3, 4):
            live = apiserver.store.get_throttle("default", thr.name)
            self._status_put(
                apiserver, self._client(apiserver, epoch=epoch),
                crashtest._recompute_status(apiserver.store, live),
            )
        assert apiserver.fencing_epoch == 4
        assert apiserver.stale_rejections() == 0

    def test_no_header_passes(self, apiserver):
        thr = crashtest._throttle(2)
        apiserver.store.create_throttle(thr)
        live = apiserver.store.get_throttle("default", thr.name)
        # raise the gate, then write without any epoch header: unaffected
        self._status_put(
            apiserver, self._client(apiserver, epoch=5),
            crashtest._recompute_status(apiserver.store, live),
        )
        live = apiserver.store.get_throttle("default", thr.name)
        self._status_put(
            apiserver, self._client(apiserver),
            crashtest._recompute_status(apiserver.store, live),
        )
        assert apiserver.stale_rejections() == 0

    def test_stale_lease_write_rejected(self, apiserver):
        from kube_throttler_tpu_torch.client.transport import FencedError

        doc = {"metadata": {"name": "kt"}, "spec": {"holderIdentity": "a"}}
        self._client(apiserver, epoch=2).post(
            "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases", doc
        )
        with pytest.raises(FencedError):
            self._client(apiserver, epoch=1).put(
                "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases/kt",
                doc,
            )
        assert apiserver.stale_rejections() == 1


class TestMockLeaseFaults:
    def _elector(self, apiserver, identity, **kw):
        from kube_throttler_tpu_torch.client.transport import ApiClient, RestConfig
        from kube_throttler_tpu_torch.utils.leaderelect import HttpLeaseElector

        kw.setdefault("lease_duration", 1.5)
        kw.setdefault("renew_period", 0.1)
        kw.setdefault("retry_period", 0.05)
        return HttpLeaseElector(
            ApiClient(RestConfig(server=apiserver.url)),
            name="kt", identity=identity, **kw,
        )

    def test_lease_error_verb_blocks_acquisition(self, apiserver):
        apiserver.faults = FaultPlan(seed=0).rule(
            "mock.lease", mode="error", times=2
        )
        a = self._elector(apiserver, "a")
        assert not a.try_acquire()  # 500 on the GET: not leader, no crash
        assert not a.try_acquire()  # 500 on the create path too
        assert a.try_acquire()  # plan exhausted: wins normally
        a.release()
        assert apiserver.faults.fired("mock.lease") == 2

    def test_lease_conflict_verb_survived_by_renewer(self, apiserver):
        a = self._elector(apiserver, "a")
        assert a.acquire()
        apiserver.faults = FaultPlan(seed=0).rule(
            "mock.lease", mode="conflict", times=1
        )
        # one injected 409 on a renew: the renewer re-reads and re-renews
        # (its own identity still holds) instead of demoting
        assert _wait(lambda: apiserver.faults.fired("mock.lease") >= 1, 3.0)
        time.sleep(0.3)
        assert a.is_leader
        a.release()


# --------------------------------------------------------------------------
# HttpLeaseElector monotonic staleness (NTP-step regressions)
# --------------------------------------------------------------------------


class TestHttpElectorMonotonicClock:
    def _elector(self, apiserver, clock, **kw):
        from kube_throttler_tpu_torch.client.transport import ApiClient, RestConfig
        from kube_throttler_tpu_torch.utils.leaderelect import HttpLeaseElector

        kw.setdefault("lease_duration", 2.0)
        kw.setdefault("renew_period", 0.1)
        kw.setdefault("retry_period", 0.05)
        return HttpLeaseElector(
            ApiClient(RestConfig(server=apiserver.url)),
            name="kt", identity="standby", clock=clock, **kw,
        )

    def _plant_lease(self, apiserver, renew_time: str):
        from kube_throttler_tpu_torch.client.transport import ApiClient, RestConfig

        ApiClient(RestConfig(server=apiserver.url)).post(
            "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases",
            {
                "metadata": {"name": "kt"},
                "spec": {
                    "holderIdentity": "other",
                    "leaseDurationSeconds": 2,
                    "renewTime": renew_time,
                },
            },
        )

    def test_ancient_renew_time_does_not_cause_instant_takeover(self, apiserver):
        """The holder's renewTime is hours in the past by OUR wall clock
        (their clock may simply be skewed). Takeover must wait a full
        lease_duration of LOCAL monotonic observation, not trust the
        wall-clock delta."""
        self._plant_lease(apiserver, "1999-01-01T00:00:00Z")
        clock = FakeClock(datetime.now(timezone.utc))
        b = self._elector(apiserver, clock)
        assert not b.try_acquire()  # first sight: window starts NOW
        clock.advance_monotonic(1.0)
        assert not b.try_acquire()  # window not yet over
        clock.advance_monotonic(1.5)
        assert b.try_acquire()  # unchanged for > duration: holder is dead
        b.release()

    def test_wall_clock_jump_does_not_expire_lease(self, apiserver):
        """An NTP step (wall jumps forward by hours, monotonic untouched)
        must not fabricate staleness — the old datetime-delta math took
        over here."""
        self._plant_lease(apiserver, datetime.now(timezone.utc).isoformat())
        clock = FakeClock(datetime.now(timezone.utc))
        b = self._elector(apiserver, clock)
        assert not b.try_acquire()
        clock.set(datetime.now(timezone.utc) + timedelta(hours=6))  # NTP step
        assert not b.try_acquire(), "wall-clock jump caused premature takeover"
        clock.advance_monotonic(2.5)  # real elapsed time without renewal
        assert b.try_acquire()
        b.release()

    def test_renewal_change_restarts_window(self, apiserver):
        self._plant_lease(apiserver, "2000-01-01T00:00:00Z")
        clock = FakeClock(datetime.now(timezone.utc))
        b = self._elector(apiserver, clock)
        assert not b.try_acquire()
        clock.advance_monotonic(1.5)
        # the holder renews (any CHANGE to the heartbeat string)
        self._heartbeat(apiserver)
        assert not b.try_acquire()  # window restarted at the new pair
        clock.advance_monotonic(1.5)
        assert not b.try_acquire()  # only 1.5s since the change
        clock.advance_monotonic(1.0)
        assert b.try_acquire()
        b.release()

    def _heartbeat(self, apiserver):
        with apiserver._lock:
            doc, rv = apiserver._leases[("kube-system", "kt")]
            doc = dict(doc)
            doc["spec"] = {**doc["spec"], "renewTime": "2000-01-01T00:00:01Z"}
            apiserver._lease_rv += 1
            apiserver._leases[("kube-system", "kt")] = (doc, apiserver._lease_rv)

    def test_renew_deadline_on_monotonic_clock(self, apiserver):
        """A leader that cannot reach the apiserver demotes only when the
        MONOTONIC renew deadline passes — a frozen monotonic clock means
        no demotion regardless of real time, and advancing it past the
        deadline demotes promptly."""
        from kube_throttler_tpu_torch.client.transport import ApiClient, RestConfig

        clock = FakeClock(datetime.now(timezone.utc))
        lost = threading.Event()
        a = self._elector(apiserver, clock, renew_period=0.05, retry_period=0.02)
        a.on_lost = lost.set
        assert a.acquire()
        # sever connectivity: renews fail from here on
        a.client = ApiClient(RestConfig(server="http://127.0.0.1:1"), timeout=0.1)
        time.sleep(0.5)  # many real seconds of failed renews...
        assert not lost.is_set() and a.is_leader  # ...frozen monotonic: no demote
        clock.advance_monotonic(a.renew_deadline + 1.0)
        assert lost.wait(3.0)
        assert not a.is_leader
        a.release()


# --------------------------------------------------------------------------
# FileLeaseElector fd hygiene
# --------------------------------------------------------------------------


class TestFileElectorFdHygiene:
    def test_double_release_is_idempotent(self, tmp_path):
        from kube_throttler_tpu_torch.utils.leaderelect import FileLeaseElector

        a = FileLeaseElector(str(tmp_path / "l.lock"))
        assert a.try_acquire()
        a.release()
        a.release()  # second release: no-op, no EBADF double-close
        assert not a.is_leader
        # the lease is actually free again
        b = FileLeaseElector(str(tmp_path / "l.lock"))
        assert b.try_acquire()
        b.release()

    def test_release_without_acquire(self, tmp_path):
        from kube_throttler_tpu_torch.utils.leaderelect import FileLeaseElector

        FileLeaseElector(str(tmp_path / "l.lock")).release()  # no-op

    def test_exception_during_flock_closes_fd(self, tmp_path, monkeypatch):
        """A non-OSError escaping between open and flock must not leak the
        descriptor (a leaked fd holds the flock for the process lifetime,
        wedging every later acquire on this host)."""
        import fcntl as _fcntl

        from kube_throttler_tpu_torch.utils.leaderelect import FileLeaseElector

        def count_fds():
            return len(os.listdir("/proc/self/fd"))

        class Boom(BaseException):  # the KeyboardInterrupt class itself
            pass  # aborts the pytest session, so stand in for it

        def boom(*a, **k):
            raise Boom

        real_flock = _fcntl.flock  # capture BEFORE the patch mutates the module
        a = FileLeaseElector(str(tmp_path / "l.lock"))
        before = count_fds()
        monkeypatch.setattr(
            "kube_throttler_tpu_torch.utils.leaderelect.fcntl.flock", boom
        )
        with pytest.raises(Boom):
            a.try_acquire()
        monkeypatch.setattr(
            "kube_throttler_tpu_torch.utils.leaderelect.fcntl.flock", real_flock
        )
        assert count_fds() == before, "fd leaked on acquire exception"
        assert not a.is_leader
        assert a.try_acquire()  # the path is not wedged
        a.release()


# --------------------------------------------------------------------------
# in-process replication: leader → standby streaming
# --------------------------------------------------------------------------


class _Pair:
    """Leader (store+journal+snapshot+source+HTTP) and standby
    (store+journal+replicator) over two tmp dirs."""

    def __init__(self, tmp_path, snapshot_first=True):
        self.leader_dir = str(tmp_path / "A")
        self.standby_dir = str(tmp_path / "B")
        os.makedirs(self.leader_dir)
        os.makedirs(self.standby_dir)
        self.ls = Store()
        lrec = RecoveryManager(self.leader_dir)
        self.lj = lrec.recover_store(self.ls)
        self.lepoch = FencingEpoch(self.leader_dir)
        self.lj.fencing = self.lepoch
        self.snap = SnapshotManager(self.leader_dir, self.ls)
        self.snap.fencing = self.lepoch
        self.snap.bind_journal(self.lj, every_lines=0)
        self.ha = HaCoordinator(
            self.lepoch, role="leader", journal=self.lj, snapshotter=self.snap
        )
        self.ha.become_leader()
        self.ls.create_namespace(Namespace("default"))
        if snapshot_first:
            self.snap.write(reason="bootstrap")
        self.source = ReplicationSource(self.leader_dir, self.lj, self.lepoch)
        self.server = ReplicationServer(self.source)
        self.server.start()
        self.url = f"http://127.0.0.1:{self.server.port}"
        self.ss = Store()
        srec = RecoveryManager(self.standby_dir)
        self.sj = srec.recover_store(self.ss)
        self.sepoch = FencingEpoch(self.standby_dir)
        self.sj.fencing = self.sepoch
        self.rep = StandbyReplicator(
            self.ss, self.sj, self.url, epoch=self.sepoch, poll_interval=0.02
        )

    def converge(self, timeout=5.0):
        def caught_up():
            try:
                self.rep.poll_once()
            except OSError:
                return False
            return self.rep.consumed_offset() >= self.lj.position()[0]

        assert _wait(caught_up, timeout), "standby never caught up"

    def close(self):
        self.rep.stop()
        self.server.stop()
        self.sj.close()
        self.lj.close()


class TestReplicationStreaming:
    def test_bootstrap_and_tail_convergence(self, tmp_path):
        pair = _Pair(tmp_path)
        try:
            for i in range(8):
                pair.ls.create_pod(make_pod(f"p{i}", labels={"grp": "g0"}))
            assert pair.rep.bootstrap(5.0)
            # snapshot bootstrap: some objects arrived without streaming
            assert pair.rep.bootstrapped
            for i in range(8, 20):
                pair.ls.create_pod(make_pod(f"p{i}", labels={"grp": "g0"}))
            pair.ls.delete_pod("default", "p3")
            thr = crashtest._throttle(0)
            pair.ls.create_throttle(thr)
            live = pair.ls.get_throttle("default", thr.name)
            pair.ls.update_throttle_status(
                crashtest._recompute_status(pair.ls, live)
            )
            pair.converge()
            assert crashtest._dump_store(pair.ss) == crashtest._dump_store(pair.ls)
            assert pair.sepoch.current() == pair.lepoch.current()
            # the standby's own journal reproduces its store from genesis
            pure = Store()
            pj = attach(pure, os.path.join(pair.standby_dir, "store.journal"))
            assert crashtest._dump_store(pure) == crashtest._dump_store(pair.ss)
            assert pj.last_epoch == pair.lepoch.current()
            pj.close()
        finally:
            pair.close()

    def test_no_snapshot_streams_from_genesis(self, tmp_path):
        pair = _Pair(tmp_path, snapshot_first=False)
        try:
            pair.ls.create_pod(make_pod("p0"))
            assert pair.rep.bootstrap(5.0)
            pair.converge()
            assert {p.key for p in pair.ss.list_pods()} == {"default/p0"}
        finally:
            pair.close()

    def test_restart_resync_drops_stale_extras(self, tmp_path):
        pair = _Pair(tmp_path)
        try:
            pair.ls.create_pod(make_pod("keep"))
            pair.ls.create_pod(make_pod("doomed"))
            assert pair.rep.bootstrap(5.0)
            pair.converge()
            # standby goes down; the leader deletes + creates while it's out
            pair.rep.stop()
            pair.ls.delete_pod("default", "doomed")
            pair.ls.create_pod(make_pod("newborn"))
            pair.snap.write(reason="turnover")
            # a NEW replicator over the same (recovered) standby state
            rep2 = StandbyReplicator(
                pair.ss, pair.sj, pair.url, epoch=pair.sepoch, poll_interval=0.02
            )
            assert rep2.bootstrap(5.0)
            keys = {p.key for p in pair.ss.list_pods()}
            assert keys == {"default/keep", "default/newborn"}, (
                "restart resync must drop objects the leader deleted"
            )
        finally:
            pair.close()

    def test_compaction_under_stream_detected_as_divergence(self, tmp_path):
        pair = _Pair(tmp_path)
        try:
            for i in range(5):
                pair.ls.create_pod(make_pod(f"p{i}"))
            assert pair.rep.bootstrap(5.0)
            pair.converge()
            # deletes make the compacted log DIFFER from the append log
            # (a pure-ADDED history compacts to byte-identical content)
            pair.ls.delete_pod("default", "p1")
            pair.ls.delete_pod("default", "p3")
            pair.converge()
            pair.lj.compact()  # rewrites the journal under the stream
            with pytest.raises((ReplicationDiverged, OSError)):
                for _ in range(3):
                    pair.rep.poll_once()
            assert pair.rep.diverged
            state, detail = pair.rep.health_state()
            assert state == "down"
        finally:
            pair.close()

    def test_leader_term_bump_does_not_fence_streaming_standby(self, tmp_path):
        """A restarting leader bumps its term while the standby streams at
        the old one. The standby must track the higher epoch WITHOUT
        fencing itself: its journal keeps accepting the re-journaled
        replicated events, so nothing is lost at a later promotion."""
        pair = _Pair(tmp_path)
        try:
            pair.ls.create_pod(make_pod("p0"))
            assert pair.rep.bootstrap(5.0)
            pair.converge()
            pair.ha.become_leader()  # leader restart: term 1 → 2
            pair.ls.create_pod(make_pod("p1"))
            pair.converge()
            assert pair.sepoch.current() == pair.lepoch.current() == 2
            assert not pair.sepoch.is_stale(), (
                "standby fenced itself on a normal leader term bump"
            )
            assert pair.sj.stale_epoch_rejected == 0
            assert {p.key for p in pair.ss.list_pods()} == {
                "default/p0", "default/p1",
            }
            # the replicated events actually landed in the standby's OWN
            # journal (a fenced journal drops them while the store mutates)
            pure = Store()
            pj = attach(pure, os.path.join(pair.standby_dir, "store.journal"))
            assert {p.key for p in pure.list_pods()} == {
                "default/p0", "default/p1",
            }
            pj.close()
        finally:
            pair.close()

    def test_compaction_rebootstraps_running_standby(self, tmp_path):
        """A leader compaction rewrites the journal under the stream; the
        BACKGROUND replicator must re-bootstrap from the freshly cut
        post-compaction snapshot and converge again — not freeze at its
        last verified offset until someone restarts the process."""
        pair = _Pair(tmp_path)
        try:
            for i in range(5):
                pair.ls.create_pod(make_pod(f"p{i}"))
            assert pair.rep.bootstrap(5.0)
            pair.rep.start()

            def caught_up():
                return pair.rep.consumed_offset() >= pair.lj.position()[0]

            assert _wait(caught_up, 5.0)
            # deletes make the compacted log differ from the append log
            pair.ls.delete_pod("default", "p1")
            pair.ls.delete_pod("default", "p3")
            assert _wait(caught_up, 5.0)
            pair.lj.compact()  # rewrite + fresh post-compaction snapshot
            pair.ls.create_pod(make_pod("post-compact"))

            def converged_again():
                return (
                    pair.rep.rebootstraps >= 1
                    and not pair.rep.diverged
                    and {p.key for p in pair.ss.list_pods()}
                    == {p.key for p in pair.ls.list_pods()}
                )

            assert _wait(converged_again, 10.0), (
                "standby never re-bootstrapped after leader compaction"
            )
            state, detail = pair.rep.health_state()
            assert state == "ok" and detail["rebootstraps"] >= 1
        finally:
            pair.close()

    def test_torn_chunk_read_surfaces_as_oserror(self):
        """A leader dying mid-send leaves a short body under a declared
        Content-Length; http.client raises IncompleteRead — an
        HTTPException, NOT an OSError — from read(). The replicator must
        normalize it so every retry path (bootstrap, _run, catch_up)
        treats it like any other transport failure instead of the
        replicator thread dying silently."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Torn(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", "1000")
                self.end_headers()
                self.wfile.write(b'{"half": true}')  # then the socket closes

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), Torn)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            rep = StandbyReplicator(
                Store(), None,
                f"http://127.0.0.1:{httpd.server_address[1]}",
                request_timeout=2.0,
            )
            with pytest.raises(OSError):
                rep.poll_once()
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_bootstrap_retries_non_200_and_reports_false(self):
        """A transient 500 on the snapshot fetch must not raise out of
        bootstrap (the daemon's clean 'standby bootstrap failed' path
        only handles the False return); it retries until the deadline."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Err(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                body = b'{"message": "boom"}'
                self.send_response(500)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), Err)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            rep = StandbyReplicator(
                Store(), None,
                f"http://127.0.0.1:{httpd.server_address[1]}",
            )
            assert rep.bootstrap(deadline_s=0.5) is False
            assert not rep.bootstrapped
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_promotion_bumps_epoch_and_stamps_journal(self, tmp_path):
        pair = _Pair(tmp_path)
        try:
            pair.ls.create_pod(make_pod("p0"))
            assert pair.rep.bootstrap(5.0)
            pair.converge()
            coord = HaCoordinator(
                pair.sepoch, role="standby", replicator=pair.rep, journal=pair.sj
            )
            new_epoch = coord.promote()
            assert new_epoch == pair.lepoch.current() + 1
            assert coord.role == "leader"
            assert pair.sj.last_epoch == new_epoch
            assert coord.failover_duration_s is not None
            # the deposed leader learns the new term and fences
            pair.lepoch.observe(new_epoch)
            assert pair.lepoch.is_stale()
            pair.ls.create_pod(make_pod("zombie"))
            assert pair.lj.stale_epoch_rejected == 1
            assert pair.snap.write(reason="zombie") is None
        finally:
            pair.close()


# --------------------------------------------------------------------------
# standby HTTP server + promotion reconcile + metrics
# --------------------------------------------------------------------------


class TestStandbyServer:
    def test_standby_surface_then_promotion_flip(self, tmp_path):
        import urllib.error
        import urllib.request

        from kube_throttler_tpu_torch.server import ThrottlerHTTPServer

        store = Store()
        rec = RecoveryManager(str(tmp_path))
        journal = rec.recover_store(store)
        epoch = FencingEpoch(str(tmp_path))
        ha = HaCoordinator(
            epoch, role="standby", journal=journal,
            replicator=StandbyReplicator(store, journal, "http://127.0.0.1:1"),
        )
        ha.source = ReplicationSource(str(tmp_path), journal, epoch)
        srv = ThrottlerHTTPServer(None, port=0, ha=ha)
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        try:
            assert urllib.request.urlopen(f"{url}/healthz").status == 200
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{url}/readyz")
            body = json.loads(e.value.read())
            assert e.value.code == 503 and body["state"] == "standby"
            assert body["components"]["ha"]["role"] == "standby"
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{url}/v1/throttles")
            assert e.value.code == 503
            st = json.loads(
                urllib.request.urlopen(f"{url}/v1/replication/status").read()
            )
            assert st["journalOffset"] == journal.position()[0]

            # promotion: build the real plugin with a STALE status (the
            # flip the dead leader never committed) and let the two-lane
            # pipeline re-publish it
            store.create_namespace(Namespace("default"))
            thr = crashtest._throttle(0)  # pod threshold 3
            store.create_throttle(thr)
            for i in range(4):  # over threshold: truth is THROTTLED
                store.create_pod(
                    make_pod(
                        f"p{i}", labels={"grp": "g0"},
                        requests={"cpu": "100m"}, node_name="node-1",
                        phase="Running",
                    )
                )
            from kube_throttler_tpu_torch.plugin import (
                KubeThrottler,
                decode_plugin_args,
            )

            plugin = KubeThrottler(
                decode_plugin_args(
                    {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
                ),
                store,
                use_device=True,
                start_workers=True,
                device="cpu",
            )
            try:
                ha.promote()
                n = ha.promote_reconcile(plugin)
                assert n >= 1
                srv.set_plugin(plugin)

                def flipped():
                    t = store.get_throttle("default", thr.name)
                    return t.status.throttled.resource_counts_pod

                assert _wait(flipped, 10.0), (
                    "promotion reconcile never re-published the flip"
                )
                ready = json.loads(urllib.request.urlopen(f"{url}/readyz").read())
                assert ready["role"] == "leader" and ready["epoch"] == 1
                listing = json.loads(
                    urllib.request.urlopen(f"{url}/v1/throttles").read()
                )
                assert len(listing) == 1
            finally:
                plugin.stop()
        finally:
            srv.stop()
            journal.close()

    def test_standby_metrics_scrapeable_before_promotion(self, tmp_path):
        """/metrics must answer on a plugin-less standby — replication lag
        is exactly the family that only matters pre-promotion."""
        import urllib.request

        from kube_throttler_tpu_torch.metrics import Registry, register_ha_metrics
        from kube_throttler_tpu_torch.server import ThrottlerHTTPServer

        store = Store()
        rec = RecoveryManager(str(tmp_path))
        journal = rec.recover_store(store)
        epoch = FencingEpoch(str(tmp_path))
        rep = StandbyReplicator(store, journal, "http://127.0.0.1:1")
        ha = HaCoordinator(epoch, role="standby", replicator=rep, journal=journal)
        registry = Registry()
        register_ha_metrics(registry, ha)
        srv = ThrottlerHTTPServer(None, port=0, ha=ha, metrics_registry=registry)
        srv.start()
        try:
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics"
            ).read().decode()
            assert "kube_throttler_replication_lag_bytes" in text
            assert "kube_throttler_leader_state 0" in text
        finally:
            srv.stop()
            journal.close()

    def test_ha_metrics_families(self, tmp_path):
        from kube_throttler_tpu_torch.metrics import Registry, register_ha_metrics

        store = Store()
        rec = RecoveryManager(str(tmp_path))
        journal = rec.recover_store(store)
        epoch = FencingEpoch(str(tmp_path))
        rep = StandbyReplicator(store, journal, "http://127.0.0.1:1")
        ha = HaCoordinator(epoch, role="standby", replicator=rep, journal=journal)
        registry = Registry()
        register_ha_metrics(registry, ha)
        text = registry.exposition()
        assert "kube_throttler_leader_state 0" in text
        assert "kube_throttler_failover_duration_seconds -1" in text
        assert "kube_throttler_replication_lag_bytes" in text
        assert "kube_throttler_stale_epoch_rejections_total 0" in text
        ha.promote()
        text = registry.exposition()
        assert "kube_throttler_leader_state 1" in text
        journal.close()


# --------------------------------------------------------------------------
# the chaos harness: one smoke cycle in tier-1, the matrix behind -m slow
# --------------------------------------------------------------------------


class TestKillTheLeaderSmoke:
    def test_one_failover_cycle(self, tmp_path):
        report = hatest.run_ha_cycle(
            "ha.status.commit", seed=0, workdir=str(tmp_path), events=90
        )
        assert report["killed"]
        assert report["epoch"] >= 2
        assert report["window_s"] <= hatest.DEFAULT_WINDOW_S

    def test_splitbrain_fencing(self):
        report = hatest.run_splitbrain(seed=0)
        assert report["stale_rejected"] >= 2
        assert report["fencing_epoch"] == 2


@pytest.mark.slow
class TestCliHaPair:
    def test_two_daemons_replicate_and_fail_over(self, tmp_path):
        """The README quickstart, end to end: a leader daemon with
        ``--ha-role leader`` and a standby with ``--ha-role standby
        --replicate-from`` over a shared flock lease. An object created on
        the leader is visible on the standby after a SIGKILL failover,
        /readyz flips standby→leader with a bumped epoch."""
        import json as _json
        import re
        import subprocess
        import sys as _sys
        import urllib.error
        import urllib.request

        from tests.conftest import ProcReader

        lock = str(tmp_path / "lease.lock")

        def launch(role, datadir, port, extra):
            os.makedirs(datadir, exist_ok=True)
            env = dict(os.environ)
            env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
            env["JAX_PLATFORMS"] = "cpu"
            return subprocess.Popen(
                [
                    _sys.executable, "-m", "kube_throttler_tpu_torch.cli", "serve", "--device", "cpu",
                    "--name", "kt", "--target-scheduler-name", "my-scheduler",
                    "--no-device", "--data-dir", datadir, "--port", str(port),
                    "--lock-file", lock, "--ha-role", role,
                ] + extra,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, cwd=str(tmp_path),
            )

        a = b = None
        try:
            a = launch("leader", str(tmp_path / "A"), 0, [])
            ra = ProcReader(a)
            lines = ra.wait_for(r"serving on")
            port_a = int(
                re.search(r"serving on [\d.]+:(\d+)", "".join(lines)).group(1)
            )
            body = _json.dumps(
                {
                    "kind": "Throttle",
                    "metadata": {"name": "t1", "namespace": "default"},
                    "spec": {
                        "throttlerName": "kt",
                        "threshold": {"resourceCounts": {"pod": 2}},
                        "selector": {
                            "selectorTerms": [
                                {"podSelector": {"matchLabels": {"g": "x"}}}
                            ]
                        },
                    },
                }
            ).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port_a}/v1/objects",
                data=body, headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req).read()

            b = launch(
                "standby", str(tmp_path / "B"), 0,
                ["--replicate-from", f"http://127.0.0.1:{port_a}"],
            )
            rb = ProcReader(b)
            lines = rb.wait_for(r"standing by")
            port_b = int(
                re.search(
                    r"standby on [\d.]+:(\d+)", "".join(rb.seen)
                ).group(1)
            )
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"http://127.0.0.1:{port_b}/readyz")
            assert e.value.code == 503
            assert _json.loads(e.value.read())["state"] == "standby"

            a.kill()
            a.wait(timeout=10)
            rb.wait_for(r"serving on", timeout_s=60)
            ready = _json.loads(
                urllib.request.urlopen(f"http://127.0.0.1:{port_b}/readyz").read()
            )
            assert ready["role"] == "leader" and ready["epoch"] >= 2
            thr = _json.loads(
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port_b}/v1/throttles"
                ).read()
            )
            assert [t["metadata"]["name"] for t in thr] == ["t1"]
        finally:
            for p in (a, b):
                if p is not None:
                    p.kill()
                    p.wait(timeout=10)


@pytest.mark.slow
class TestKillTheLeaderMatrix:
    @pytest.mark.parametrize("site", hatest.HA_SITES)
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_site_seed(self, site, seed, tmp_path):
        report = hatest.run_ha_cycle(site, seed, str(tmp_path))
        assert report["window_s"] <= hatest.DEFAULT_WINDOW_S

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_splitbrain(self, seed):
        hatest.run_splitbrain(seed)
