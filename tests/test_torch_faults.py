"""Fault-injection subsystem (faults/plan.py) + the hardening it exists to
exercise: FaultPlan determinism, transport/client fault sites, mockserver
server-side fault verbs, bounded Watch overflow, journal interior-corruption
replay, and the device breaker's half-open probe state."""

from __future__ import annotations

import threading
import time
from dataclasses import replace

import pytest

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.serialization import object_to_dict
from kube_throttler_tpu_torch.api.types import (
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.client.mockserver import MockApiServer
from kube_throttler_tpu_torch.client.transport import (
    ApiClient,
    ApiError,
    Backoff,
    GoneError,
    Reflector,
    RemoteStatusWriter,
    RemoteVersions,
    RestConfig,
)
from kube_throttler_tpu_torch.client.watch import Watch
from kube_throttler_tpu_torch.engine.journal import attach
from kube_throttler_tpu_torch.engine.store import ConflictError, Store
from kube_throttler_tpu_torch.faults import FaultInjected, FaultPlan
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


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


def _wait(predicate, timeout=10.0, every=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(every)
    return predicate()


class TestFaultPlanDeterminism:
    def _drive(self, seed):
        plan = FaultPlan(seed)
        plan.rule("transport.watch.read", mode="close", probability=0.3)
        plan.rule("journal.append", mode="torn", schedule=[3, 7], times=2)
        plan.rule("mock.*", probability=0.5, times=4)
        for _ in range(40):
            plan.check("transport.watch.read")
        for _ in range(10):
            plan.check("journal.append")
        for _ in range(20):
            plan.check("mock.list")
            plan.check("mock.status.conflict")
        return plan.snapshot()

    def test_same_seed_same_sequence(self):
        assert self._drive(42) == self._drive(42)

    def test_different_seed_different_sequence(self):
        # probabilistic rules must actually depend on the seed
        assert self._drive(1) != self._drive(2)

    def test_reproducible_across_threads(self):
        """Per-site sequences are pure functions of (seed, site, hit):
        concurrent hits on OTHER sites cannot perturb a site's fault
        sequence — the property the chaos soak's reproducibility rests on."""

        def run(with_noise):
            plan = FaultPlan(7)
            plan.rule("site.a", probability=0.4)
            plan.rule("site.noise", probability=0.9)
            noise_stop = threading.Event()

            def noise():
                while not noise_stop.is_set():
                    plan.check("site.noise")

            t = threading.Thread(target=noise)
            if with_noise:
                t.start()
            fired = [bool(plan.check("site.a")) for _ in range(200)]
            if with_noise:
                noise_stop.set()
                t.join()
            return fired

        assert run(False) == run(True)

    def test_schedule_times_after(self):
        plan = FaultPlan(0)
        plan.rule("s", schedule=[2, 4, 6], times=2, after=1)
        # hit 1 skipped (after); schedule counts from hit-after
        fired = [plan.check("s") is not None for _ in range(10)]
        # hits 3 and 5 fire ((hit-after) in {2,4,6}), then times=2 caps it
        assert fired == [False, False, True, False, True, False, False, False, False, False]

    def test_maybe_raise_default_and_custom(self):
        plan = FaultPlan(0)
        plan.rule("a", times=1)
        plan.rule("b", error=lambda: ConnectionResetError("boom"), times=1)
        with pytest.raises(FaultInjected):
            plan.maybe_raise("a")
        plan.maybe_raise("a")  # exhausted: passes through
        with pytest.raises(ConnectionResetError):
            plan.maybe_raise("b")

    def test_reset_replays_identically(self):
        plan = FaultPlan(3)
        plan.rule("s", probability=0.5)
        first = [bool(plan.check("s")) for _ in range(30)]
        witness = plan.snapshot()
        plan.reset()
        assert [bool(plan.check("s")) for _ in range(30)] == first
        assert plan.snapshot() == witness


class TestBackoff:
    def test_exponential_jittered_capped_reset(self):
        import random

        b = Backoff(base=1.0, cap=8.0, rng=random.Random(0))
        delays = [b.next() for _ in range(6)]
        raws = [1.0, 2.0, 4.0, 8.0, 8.0, 8.0]
        for d, raw in zip(delays, raws):
            assert raw / 2 <= d <= raw, (d, raw)
        b.reset()
        assert b.next() <= 1.0  # back to base after a healthy stream

    def test_reflector_resets_backoff_on_event(self):
        server = MockApiServer(bookmark_interval=0.05)
        server.store.create_namespace(Namespace("default"))
        server.start()
        try:
            client = ApiClient(RestConfig(server=server.url))
            local = Store()
            refl = Reflector(client, "Namespace", local, backoff=0.01)
            refl._backoff._attempts = 5  # pretend we were mid-ladder
            refl.consecutive_failures = 5
            refl.start()
            assert refl.wait_for_sync(5)
            server.store.create_namespace(Namespace("fresh"))
            assert _wait(lambda: local.get_namespace("fresh") is not None)
            assert refl._backoff.attempts == 0
            assert refl.consecutive_failures == 0
            assert refl.health_state() == "ok"
        finally:
            refl.stop()
            server.stop()


class TestTransportFaultSites:
    @pytest.fixture()
    def apiserver(self):
        server = MockApiServer(bookmark_interval=0.05)
        server.store.create_namespace(Namespace("default"))
        server.start()
        yield server
        server.stop()

    def test_request_site_raises_connection_reset(self, apiserver):
        plan = FaultPlan(0)
        plan.rule("transport.request", times=1)
        client = ApiClient(RestConfig(server=apiserver.url), faults=plan)
        with pytest.raises(ConnectionResetError):
            client.list("Namespace")
        items, _ = client.list("Namespace")  # exhausted: next call lands
        assert len(items) == 1

    def test_put_conflict_storm_site(self, apiserver):
        apiserver.store.create_throttle(_throttle("t1", {"a": "b"}, pod=5))
        plan = FaultPlan(0)
        plan.rule("transport.put.conflict", times=2)
        client = ApiClient(RestConfig(server=apiserver.url), faults=plan)
        writer = RemoteStatusWriter(client, RemoteVersions())
        thr = apiserver.store.get_throttle("default", "t1")
        for _ in range(2):
            with pytest.raises(ConflictError):
                writer.update_throttle_status(thr)
        writer.update_throttle_status(thr)  # storm over

    def test_watch_read_gone_site_forces_relist(self, apiserver):
        plan = FaultPlan(0)
        plan.rule("transport.watch.read", mode="gone", schedule=[2])
        client = ApiClient(RestConfig(server=apiserver.url), faults=plan)
        from kube_throttler_tpu_torch.metrics import Registry
        from kube_throttler_tpu_torch.client.transport import ReflectorMetrics

        registry = Registry()
        local = Store()
        refl = Reflector(
            client, "Namespace", local, backoff=0.01,
            metrics=ReflectorMetrics(registry),
        )
        refl.start()
        try:
            assert refl.wait_for_sync(5)
            apiserver.store.create_namespace(Namespace("n1"))
            assert _wait(lambda: local.get_namespace("n1") is not None)
            # the injected 410 forced (at least) one gone→relist round trip
            assert _wait(
                lambda: (registry.flush() or True)
                and registry.counter_vec(
                    "kube_throttler_reflector_gone_total", "", ["kind"]
                ).collect().get(("Namespace",), 0) >= 1
            )
            # and the cache is still correct after the relist
            apiserver.store.create_namespace(Namespace("n2"))
            assert _wait(lambda: local.get_namespace("n2") is not None)
        finally:
            refl.stop()

    def test_watch_close_site_reconnects_without_losing_events(self, apiserver):
        plan = FaultPlan(5)
        plan.rule("transport.watch.read", mode="close", probability=0.3)
        client = ApiClient(RestConfig(server=apiserver.url), faults=plan)
        local = Store()
        refl = Reflector(client, "Namespace", local, backoff=0.01)
        refl.start()
        try:
            assert refl.wait_for_sync(5)
            for i in range(30):
                apiserver.store.create_namespace(Namespace(f"ns-{i:02d}"))
            assert _wait(lambda: len(local.list_namespaces()) == 31)
            assert plan.fired("transport.watch.read") > 0, "faults never fired"
        finally:
            refl.stop()


class TestMockserverFaultVerbs:
    def test_list_error_verb(self):
        server = MockApiServer()
        server.store.create_namespace(Namespace("default"))
        plan = FaultPlan(0)
        plan.rule("mock.list", mode="error", times=1)
        server.faults = plan
        server.start()
        try:
            client = ApiClient(RestConfig(server=server.url))
            with pytest.raises(ApiError) as exc:
                client.list("Namespace")
            assert exc.value.status == 500
            items, _ = client.list("Namespace")  # exhausted → serves
            assert len(items) == 1
        finally:
            server.stop()

    def test_list_gone_verb(self):
        server = MockApiServer()
        plan = FaultPlan(0)
        plan.rule("mock.list", mode="gone", times=1)
        server.faults = plan
        server.start()
        try:
            client = ApiClient(RestConfig(server=server.url))
            with pytest.raises(GoneError):
                client.list("Namespace")
        finally:
            server.stop()

    def test_status_conflict_verb(self):
        server = MockApiServer()
        server.store.create_namespace(Namespace("default"))
        server.store.create_throttle(_throttle("t1", {"a": "b"}, pod=5))
        plan = FaultPlan(0)
        plan.rule("mock.status.conflict", times=1)
        server.faults = plan
        server.start()
        try:
            client = ApiClient(RestConfig(server=server.url))
            writer = RemoteStatusWriter(client, RemoteVersions())
            thr = server.store.get_throttle("default", "t1")
            with pytest.raises(ConflictError):
                writer.update_throttle_status(thr)
            writer.update_throttle_status(thr)  # storm over → lands
            assert (
                server.store.get_throttle("default", "t1").status.used
                == thr.status.used
            )
        finally:
            server.stop()

    def test_watch_cut_verb_reflector_recovers(self):
        """The server severs watch streams mid-flight; the reflector must
        re-watch from its resume point and end with a complete cache (no
        lost events across reconnects)."""
        server = MockApiServer(bookmark_interval=0.02)
        server.store.create_namespace(Namespace("default"))
        plan = FaultPlan(9)
        plan.rule("mock.watch.cut", probability=0.3, times=5)
        server.faults = plan
        server.start()
        try:
            client = ApiClient(RestConfig(server=server.url))
            local = Store()
            refl = Reflector(client, "Namespace", local, backoff=0.01)
            refl.start()
            assert refl.wait_for_sync(5)
            for i in range(25):
                server.store.create_namespace(Namespace(f"cut-{i:02d}"))
                time.sleep(0.005)  # let the stream interleave with cuts
            assert _wait(lambda: len(local.list_namespaces()) == 26)
            assert plan.fired("mock.watch.cut") > 0, "cut verb never fired"
        finally:
            refl.stop()
            server.stop()

    def test_watch_gone_verb_forces_relist(self):
        server = MockApiServer(bookmark_interval=0.02)
        plan = FaultPlan(0)
        plan.rule("mock.watch.gone", schedule=[2], times=1)
        server.faults = plan
        server.start()
        try:
            client = ApiClient(RestConfig(server=server.url))
            local = Store()
            refl = Reflector(client, "Namespace", local, backoff=0.01)
            refl.start()
            assert refl.wait_for_sync(5)
            assert _wait(lambda: plan.fired("mock.watch.gone") == 1, timeout=5)
            server.store.create_namespace(Namespace("after-gone"))
            assert _wait(lambda: local.get_namespace("after-gone") is not None)
        finally:
            refl.stop()
            server.stop()


class TestWatchOverflow:
    def test_slow_consumer_does_not_block_dispatch(self):
        """The store's dispatch thread must never block on a full watch
        queue: drop-oldest sheds, counts, and flags the gap."""
        store = Store()
        w = Watch(store, "Namespace", maxsize=4)
        t0 = time.monotonic()
        for i in range(100):  # nobody consuming
            store.create_namespace(Namespace(f"ns-{i:03d}"))
        elapsed = time.monotonic() - t0
        assert elapsed < 2.0, f"dispatch blocked on a slow consumer ({elapsed:.1f}s)"
        assert w.dropped == 96
        assert w.overflowed
        # the consumer sees the NEWEST 4 events (oldest shed)
        kept = [w.next(timeout=1) for _ in range(4)]
        assert [e.obj.name for e in kept] == [f"ns-{i:03d}" for i in range(96, 100)]
        w.stop()

    def test_no_overflow_under_capacity(self):
        store = Store()
        w = Watch(store, "Namespace", maxsize=16)
        for i in range(10):
            store.create_namespace(Namespace(f"n-{i}"))
        assert w.dropped == 0 and not w.overflowed
        assert [e.obj.name for e in (w.next(timeout=1) for _ in range(10))]
        w.stop()

    def test_stop_on_full_queue_still_terminates(self):
        store = Store()
        w = Watch(store, "Namespace", maxsize=2)
        for i in range(5):
            store.create_namespace(Namespace(f"x-{i}"))
        w.stop()  # full queue: stop must shed one event, never block
        drained = []
        with pytest.raises(StopIteration):
            while True:
                drained.append(w.next(timeout=1))
        assert len(drained) <= 2

    def test_block_policy_preserves_every_event(self):
        store = Store()
        w = Watch(store, "Namespace", maxsize=8, overflow="block")
        seen = []
        done = threading.Event()

        def consume():
            for event in w:
                seen.append(event.obj.name)
                if len(seen) == 50:
                    done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        for i in range(50):
            store.create_namespace(Namespace(f"b-{i:02d}"))
        assert done.wait(5), f"only {len(seen)} events arrived"
        assert seen == [f"b-{i:02d}" for i in range(50)]  # no loss, in order
        assert w.dropped == 0
        w.stop()
        t.join(timeout=2)

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError):
            Watch(Store(), "Namespace", overflow="banana")

    def test_stats_and_metrics_exposition(self):
        from kube_throttler_tpu_torch.metrics import Registry, register_watch_metrics

        store = Store()
        w = Watch(store, "Namespace", maxsize=2)
        for i in range(5):
            store.create_namespace(Namespace(f"m-{i}"))
        registry = Registry()
        register_watch_metrics(registry)
        expo = registry.exposition()
        assert "kube_throttler_watch_queue_depth" in expo
        assert "kube_throttler_watch_overflow_total" in expo
        stats = Watch.stats()
        assert stats["dropped_total"] >= 3
        assert stats["depth"] >= 2
        w.stop()


class TestJournalCorruption:
    def _populate(self, store):
        store.create_namespace(Namespace("default"))
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=10))
        store.create_pod(make_pod("p1", labels={"grp": "a"}))
        store.create_pod(make_pod("p2", labels={"grp": "a"}))

    def test_interior_corruption_skipped_and_counted(self, tmp_path):
        path = str(tmp_path / "j")
        store = Store()
        journal = attach(store, path)
        self._populate(store)
        journal.close()
        # corrupt an INTERIOR line (the throttle), keep everything after
        lines = open(path, "rb").read().splitlines(keepends=True)
        lines[1] = b'{"type": "ADDED", "kind": "Thro\xff GARBAGE\n'
        open(path, "wb").write(b"".join(lines))
        recovered = Store()
        j2 = attach(recovered, path)
        # the pods AFTER the corrupt line survived — replay did not abort
        assert {p.key for p in recovered.list_pods()} == {"default/p1", "default/p2"}
        assert recovered.get_namespace("default") is not None
        assert recovered.list_throttles() == []  # the corrupted event is lost
        assert j2.replay_skipped == 1
        state, detail = j2.health_state()
        assert state == "degraded" and detail["replaySkipped"] == 1
        # the file was NOT truncated at the corruption point
        assert len(open(path, "rb").read().splitlines()) == len(lines)
        j2.close()

    def test_interior_plus_torn_tail(self, tmp_path):
        path = str(tmp_path / "j")
        store = Store()
        journal = attach(store, path)
        self._populate(store)
        journal.close()
        lines = open(path, "rb").read().splitlines(keepends=True)
        lines[2] = b"NOT JSON AT ALL\n"  # interior
        with open(path, "wb") as f:
            f.write(b"".join(lines))
            f.write(b'{"type": "ADDED", "kind": "Pod", "obj')  # torn tail
        recovered = Store()
        j2 = attach(recovered, path)
        assert j2.replay_skipped == 1  # interior skipped
        # tail truncated so post-recovery appends aren't stranded
        recovered.create_namespace(Namespace("late"))
        j2.close()
        third = Store()
        j3 = attach(third, path)
        assert third.get_namespace("late") is not None
        assert j3.replay_skipped == 1  # interior line still there, still skipped
        j3.close()

    def test_torn_write_fault_produces_interior_corruption(self, tmp_path):
        """The journal.append 'torn' fault forges the exact artifact a
        crash mid-write leaves: fragment + next line = one corrupt interior
        line; replay skips it and keeps everything else."""
        path = str(tmp_path / "j")
        plan = FaultPlan(0)
        plan.rule("journal.append", mode="torn", schedule=[3], times=1)
        store = Store()
        journal = attach(store, path, faults=plan)
        self._populate(store)  # 4 events; #3 is torn, #4 merges into it
        store.create_namespace(Namespace("late"))  # a good line AFTER the merge
        assert journal.torn_writes == 1
        journal.close()
        recovered = Store()
        j2 = attach(recovered, path)
        # events 1-2 fine; 3+4 became one corrupt INTERIOR line (both lost);
        # event 5 after the gap survived
        assert recovered.get_namespace("default") is not None
        assert recovered.get_namespace("late") is not None
        assert len(recovered.list_throttles()) == 1
        assert recovered.list_pods() == []
        assert j2.replay_skipped == 1
        j2.close()

    def test_write_error_fault_drops_event(self, tmp_path):
        path = str(tmp_path / "j")
        plan = FaultPlan(0)
        plan.rule("journal.append", mode="error", schedule=[2], times=1)
        store = Store()
        journal = attach(store, path, faults=plan)
        self._populate(store)
        assert journal.write_errors == 1
        journal.close()
        recovered = Store()
        attach(recovered, path).close()
        # event #2 (the throttle) never hit the log
        assert recovered.list_throttles() == []
        assert {p.key for p in recovered.list_pods()} == {"default/p1", "default/p2"}

    def test_fsync_fault_fails_compaction_but_not_dispatch(self, tmp_path):
        path = str(tmp_path / "j")
        plan = FaultPlan(0)
        plan.rule("journal.fsync", times=1)
        store = Store()
        journal = attach(store, path, compact_after=6, faults=plan)
        self._populate(store)  # 4 events
        # two more events cross compact_after → compaction runs, fsync fails
        store.create_pod(make_pod("p3", labels={"grp": "a"}))
        store.create_pod(make_pod("p4", labels={"grp": "a"}))
        assert journal.compact_failures == 1
        # dispatch survived; the uncompacted log is intact and still grows
        store.create_pod(make_pod("p5", labels={"grp": "a"}))
        journal.close()
        recovered = Store()
        attach(recovered, path).close()
        assert {p.name for p in recovered.list_pods()} == {"p1", "p2", "p3", "p4", "p5"}

    def test_compact_heals_torn_log(self, tmp_path):
        path = str(tmp_path / "j")
        plan = FaultPlan(1)
        plan.rule("journal.append", mode="torn", probability=0.3)
        store = Store()
        journal = attach(store, path, faults=plan)
        self._populate(store)
        for i in range(20):
            store.create_pod(make_pod(f"extra-{i:02d}", labels={"grp": "a"}))
        assert journal.torn_writes > 0, "torn faults never fired"
        journal.compact()  # snapshot from the live store: gaps erased
        journal.close()
        recovered = Store()
        j2 = attach(recovered, path)
        assert j2.replay_skipped == 0
        assert {p.name for p in recovered.list_pods()} == {
            p.name for p in store.list_pods()
        }
        assert [object_to_dict(t) for t in recovered.list_throttles()] == [
            object_to_dict(t) for t in store.list_throttles()
        ]
        j2.close()


class TestBreakerHalfOpen:
    def _dm(self):
        from kube_throttler_tpu_torch.engine.devicestate import DeviceStateManager

        store = Store()
        dm = DeviceStateManager(store, "kt", "sched", device="cpu")
        now = [1000.0]
        dm._monotonic = lambda: now[0]
        return dm, now

    def test_closed_open_halfopen_closed_cycle(self):
        dm, now = self._dm()
        assert dm.breaker_state() == "closed"
        calls = []

        def ok():
            calls.append("ok")
            return {"fine": True}

        def boom():
            calls.append("boom")
            raise RuntimeError("tunnel died")

        assert dm.guarded("t", ok) == {"fine": True}
        assert dm.guarded("t", boom) is None  # opens
        assert dm.breaker_state() == "open"
        assert dm.guarded("t", ok) is None  # open: not dispatched
        assert calls == ["ok", "boom"]
        now[0] += dm.device_retry_cooldown + 1
        assert dm.breaker_state() == "half-open"
        assert dm.device_available()
        assert dm.guarded("t", ok) == {"fine": True}  # the probe
        assert dm.breaker_state() == "closed"
        assert calls == ["ok", "boom", "ok"]

    def test_failed_probe_reopens(self):
        dm, now = self._dm()

        def boom():
            raise RuntimeError("still dead")

        dm.guarded("t", boom)
        now[0] += dm.device_retry_cooldown + 1
        assert dm.breaker_state() == "half-open"
        assert dm.guarded("t", boom) is None  # probe fails
        assert dm.breaker_state() == "open"
        assert not dm.device_available()

    def test_single_probe_no_stampede(self):
        """While one thread's probe is in flight, every other guarded call
        must fall back WITHOUT dispatching (exactly one probe per
        half-open window)."""
        dm, now = self._dm()
        dm.guarded("t", lambda: (_ for _ in ()).throw(RuntimeError("die")))
        now[0] += dm.device_retry_cooldown + 1

        probe_entered = threading.Event()
        release_probe = threading.Event()
        dispatches = []

        def slow_probe():
            dispatches.append("probe")
            probe_entered.set()
            release_probe.wait(5)
            return {"ok": True}

        t = threading.Thread(target=lambda: dm.guarded("t", slow_probe))
        t.start()
        assert probe_entered.wait(5)
        # probe in flight: other callers are rejected without dispatch
        for _ in range(5):
            assert dm.guarded("t", lambda: dispatches.append("stampede")) is None
        release_probe.set()
        t.join(timeout=5)
        assert dispatches == ["probe"]
        assert dm.breaker_state() == "closed"

    def test_injected_device_fault_site(self):
        dm, now = self._dm()
        plan = FaultPlan(0)
        plan.rule("device.dispatch", times=1)
        dm.faults = plan
        assert dm.guarded("t", lambda: {"x": 1}) is None  # injected failure
        assert dm.breaker_state() == "open"
        now[0] += dm.device_retry_cooldown + 1
        assert dm.guarded("t", lambda: {"x": 1}) == {"x": 1}  # plan exhausted
        assert dm.breaker_state() == "closed"

    def test_breaker_state_gauge_exported(self):
        from kube_throttler_tpu_torch.metrics import Registry, register_breaker_metrics

        dm, now = self._dm()
        registry = Registry()
        register_breaker_metrics(registry, dm)
        assert "kube_throttler_device_breaker_state 0" in registry.exposition()
        dm.note_device_failure("t", RuntimeError("die"))
        assert "kube_throttler_device_breaker_state 1" in registry.exposition()
        now[0] += dm.device_retry_cooldown + 1
        assert "kube_throttler_device_breaker_state 2" in registry.exposition()


class TestReadyzHealth:
    def test_degraded_stays_200_down_503(self):
        import json as _json
        import urllib.error
        import urllib.request

        from kube_throttler_tpu_torch.plugin import (
            KubeThrottler,
            RecordingEventRecorder,
            decode_plugin_args,
        )
        from kube_throttler_tpu_torch.server import ThrottlerHTTPServer

        store = Store()
        store.create_namespace(Namespace("default"))
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            store,
            event_recorder=RecordingEventRecorder(), device="cpu",
        )
        server = ThrottlerHTTPServer(plugin, port=0)
        server.start()
        try:
            url = f"http://127.0.0.1:{server.port}/readyz"

            def readyz():
                with urllib.request.urlopen(url, timeout=5) as resp:
                    return resp.status, _json.load(resp)

            code, body = readyz()
            assert code == 200 and body["ok"] and body["state"] == "ok"
            assert body["components"]["device"]["state"] == "ok"
            assert body["components"]["workqueues"]["state"] == "ok"

            # open the breaker → degraded, still 200 (host oracle serves)
            plugin.device_manager.note_device_failure("t", RuntimeError("die"))
            code, body = readyz()
            assert code == 200 and body["state"] == "degraded"
            assert body["components"]["device"]["breaker"] == "open"
            assert body["device"]["breaker"] == "open"

            # a down component → 503 (probes yank the pod)
            plugin.health.register("reflector.Pod", lambda: ("down", {}))
            with pytest.raises(urllib.error.HTTPError) as exc:
                readyz()
            assert exc.value.code == 503
            assert _json.load(exc.value)["state"] == "down"
        finally:
            server.stop()
            plugin.stop()
