"""Two-lane status pipeline: priority-drained flip publication.

Covers the stack bottom-up:

- workqueue priority lane (promote/move/requeue semantics, enqueue
  timestamps);
- AsyncStatusCommitter lanes: flips overtake the refresh backlog, per-key
  ordering holds ACROSS lanes, promote-never-demote, refresh conflict
  storms never starve flips (the PR-1 fault-injection plan drives the
  409s/watch cuts in the end-to-end case);
- devicestate classification-delta flip detection (drained vs promote);
- controller commit ordering (a flipping key's status write dispatches
  before the refresh keys drained in the same batch, regardless of
  enqueue order);
- two regressions: mid-batch R growth in check_pods_multi,
  and the KT_GATHER_CHUNK_ELEMS import-time env parse.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
    ThrottleStatus,
)
from kube_throttler_tpu_torch.client.mockserver import MockApiServer
from kube_throttler_tpu_torch.client.transport import AsyncStatusCommitter, RemoteSession, RestConfig
from kube_throttler_tpu_torch.engine.store import ConflictError, EventType, Store
from kube_throttler_tpu_torch.engine.workqueue import RateLimitingQueue
from kube_throttler_tpu_torch.faults import FaultPlan
from kube_throttler_tpu_torch.metrics import Registry
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _wait(predicate, timeout=10.0, every=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(every)
    return predicate()


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


def _bound(name, labels, cpu="100m", **kw):
    return make_pod(
        name, labels=labels, requests={"cpu": cpu},
        node_name="node-1", phase="Running", **kw,
    )


def _stack():
    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True, device="cpu",
    )
    store.create_namespace(Namespace("default"))
    return store, plugin


# ---------------------------------------------------------------------------
# workqueue priority lane
# ---------------------------------------------------------------------------


class TestWorkqueuePriorityLane:
    def test_priority_lane_drains_first(self):
        q = RateLimitingQueue("t")
        q.add("a")
        q.add("b")
        q.add_priority("hot")
        assert [q.get(0.1), q.get(0.1), q.get(0.1)] == ["hot", "a", "b"]

    def test_promote_moves_item_out_of_normal_lane(self):
        q = RateLimitingQueue("t")
        for k in ("a", "b", "c"):
            q.add(k)
        q.add_priority("b")
        got = [q.get(0.1), q.get(0.1), q.get(0.1)]
        assert got == ["b", "a", "c"]
        # moved, not duplicated
        assert q.try_get() is None

    def test_promote_while_processing_requeues_into_hi(self):
        q = RateLimitingQueue("t")
        q.add("a")
        assert q.get(0.1) == "a"  # processing
        q.add("b")
        q.add_priority("a")  # dirty-while-processing, flagged hi
        q.done("a")
        assert q.get(0.1) == "a"  # re-queued ahead of b
        assert q.get(0.1) == "b"

    def test_promote_unknown_item_enqueues_hi(self):
        q = RateLimitingQueue("t")
        q.add("a")
        q.add_all_priority(["x", "y"])
        assert [q.get(0.1), q.get(0.1), q.get(0.1)] == ["x", "y", "a"]

    def test_len_counts_both_lanes(self):
        q = RateLimitingQueue("t")
        q.add("a")
        q.add_priority("b")
        assert len(q) == 2

    def test_claim_ts_pops_first_event_time(self):
        q = RateLimitingQueue("t")
        before = time.monotonic()
        q.add("a")
        q.add("a")  # dedup: must not advance the first-event time
        assert q.get(0.1) == "a"
        ts = q.claim_ts("a")
        assert ts is not None and before <= ts <= time.monotonic()
        assert q.claim_ts("a") is None  # one sample per hand-out


# ---------------------------------------------------------------------------
# two-lane committer
# ---------------------------------------------------------------------------


class _FakeWriter:
    """RemoteStatusWriter stand-in recording _put calls; can be armed to
    raise per-key and to gate (block) the first call."""

    def __init__(self, gate=None):
        self.calls = []  # (kind, key, obj)
        self.fail_plan = {}  # key -> list of exceptions to raise first
        self.lock = threading.Lock()
        self.gate = gate  # threading.Event: first _put blocks on it
        self.entered = threading.Event()

    def _put(self, kind, obj):
        from kube_throttler_tpu_torch.engine.store import key_of

        key = key_of(kind, obj)
        gate = None
        with self.lock:
            plan = self.fail_plan.get(key)
            if plan:
                raise plan.pop(0)
            if self.gate is not None:
                gate, self.gate = self.gate, None
        if gate is not None:
            self.entered.set()
            gate.wait(10)
        with self.lock:
            self.calls.append((kind, key, obj))

    def refresh_version(self, kind, obj):
        pass


def _thr_status(name, pods, throttled=False):
    from kube_throttler_tpu_torch.api.types import IsResourceAmountThrottled

    return Throttle(
        name=name,
        namespace="default",
        spec=ThrottleSpec(throttler_name="kt"),
        status=ThrottleStatus(
            used=ResourceAmount.of(pod=pods),
            throttled=IsResourceAmountThrottled(resource_counts_pod=throttled),
        ),
    )


class TestCommitterTwoLane:
    def test_flip_overtakes_refresh_backlog(self):
        gate = threading.Event()
        w = _FakeWriter(gate=gate)
        c = AsyncStatusCommitter(w, workers=1)
        c.start()
        try:
            c.update_throttle_status(_thr_status("hold", 1))
            assert w.entered.wait(5)  # worker is parked inside the PUT
            for i in range(50):
                c.update_throttle_status(_thr_status(f"ref{i:02d}", i))
            c.update_throttle_statuses_prioritized(
                [_thr_status("flip", 9, throttled=True)],
                flip_keys={"default/flip"},
            )
            gate.set()
            assert c.flush(10.0)
        finally:
            c.stop()
        keys = [k for (_, k, _) in w.calls]
        # the flip is the very next PUT after the parked one, ahead of all
        # 50 queued refreshes
        assert keys[0] == "default/hold"
        assert keys[1] == "default/flip"

    def test_per_key_ordering_across_lanes(self):
        w = _FakeWriter()
        c = AsyncStatusCommitter(w, workers=4)
        c.start()
        try:
            for i in range(30):
                # alternate lanes for the same two keys
                if i % 2:
                    c.update_throttle_statuses_prioritized(
                        [_thr_status("x", i), _thr_status("y", i)],
                        flip_keys={"default/x", "default/y"},
                    )
                else:
                    c.update_throttle_status(_thr_status("x", i))
                    c.update_throttle_status(_thr_status("y", i))
            assert c.flush(10.0)
        finally:
            c.stop()
        for key in ("default/x", "default/y"):
            seq = [o.status.used.resource_counts for (_, k, o) in w.calls if k == key]
            assert seq == sorted(seq), seq  # never out of submission order
            assert seq[-1] == 29  # newest landed last

    def test_refresh_never_demotes_pending_flip(self):
        w = _FakeWriter()
        c = AsyncStatusCommitter(w, workers=1)
        # no start: inspect lane assignment directly
        c.update_throttle_statuses_prioritized(
            [_thr_status("a", 1, throttled=True)], flip_keys={"default/a"}
        )
        c.update_throttle_status(_thr_status("a", 2))  # value-only follow-up
        (hi,) = [s for s in c._hi_shards if s]
        assert list(hi) == ["default/a"]
        assert sum(len(s) for s in c._lo_shards) == 0
        # the single PUT carries the NEWEST object (which includes the flip)
        c.start()
        assert c.flush(5.0)
        c.stop()
        assert len(w.calls) == 1
        assert w.calls[0][2].status.used.resource_counts == 2

    def test_refresh_conflict_storm_does_not_starve_flip(self):
        w = _FakeWriter()
        # a refresh key stuck in a 409 storm must hand the shard to the
        # flip between attempts (re-stage), not retry-sleep through it
        w.fail_plan["default/stuck"] = [ConflictError("rv")] * 3
        c = AsyncStatusCommitter(w, workers=1)
        c.start()
        try:
            c.update_throttle_status(_thr_status("stuck", 1))
            time.sleep(0.02)  # let the worker enter the retry loop
            c.update_throttle_statuses_prioritized(
                [_thr_status("flip", 5, throttled=True)],
                flip_keys={"default/flip"},
            )
            assert c.flush(10.0)
        finally:
            c.stop()
        keys = [k for (_, k, _) in w.calls]
        assert "default/flip" in keys and "default/stuck" in keys
        assert keys.index("default/flip") < keys.index("default/stuck")

    def test_lag_histograms_observed_per_lane(self):
        reg = Registry()
        w = _FakeWriter()
        c = AsyncStatusCommitter(w, workers=1, metrics_registry=reg)
        c.start()
        try:
            now = time.monotonic()
            c.update_throttle_statuses_prioritized(
                [_thr_status("f", 1, throttled=True), _thr_status("r", 2)],
                flip_keys={"default/f"},
                event_ts={"default/f": now, "default/r": now},
            )
            assert c.flush(5.0)
        finally:
            c.stop()
        total = reg.histogram_vec(
            "kube_throttler_status_lag_seconds", "", ["kind", "path"]
        ).snapshot({"kind": "Throttle", "path": "remote"})
        flip = reg.histogram_vec(
            "kube_throttler_status_flip_lag_seconds", "", ["kind", "path"]
        ).snapshot({"kind": "Throttle", "path": "remote"})
        assert total is not None and total[1] == 2
        assert flip is not None and flip[1] == 1


# ---------------------------------------------------------------------------
# devicestate classification-delta flip detection
# ---------------------------------------------------------------------------


class TestFlipDetection:
    def test_drained_flip_detected_and_cleared_by_publication(self):
        store, plugin = _stack()
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=1))
        store.create_pod(_bound("p0", {"grp": "a"}))
        plugin.run_pending_once()  # publish used=1, throttled (1 >= 1)
        dm = plugin.device_manager
        # second pod: used 2 — no flag change (still throttled); then
        # delete both: used 0 — flips OFF
        store.create_pod(_bound("p1", {"grp": "a"}))
        flips: dict = {}
        dm.aggregate_used_for("throttle", ["default/t1"], flips_out=flips)
        assert "default/t1" not in flips["drained"]  # 2 ≥ 1 == 1 ≥ 1: no flip
        plugin.run_pending_once()
        store.delete_pod("default", "p0")
        store.delete_pod("default", "p1")
        flips = {}
        dm.aggregate_used_for("throttle", ["default/t1"], flips_out=flips)
        assert "default/t1" in flips["drained"]

    def test_unrelated_drain_promotes_flipping_key(self):
        store, plugin = _stack()
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=1))
        store.create_throttle(_throttle("t2", {"grp": "b"}, pod=100))
        plugin.run_pending_once()
        dm = plugin.device_manager
        store.create_pod(_bound("p0", {"grp": "a"}))  # flips t1, not drained
        flips: dict = {}
        dm.aggregate_used_for("throttle", ["default/t2"], flips_out=flips)
        assert flips["drained"] == set()
        assert "default/t1" in flips["promote"]

    def test_published_state_yields_no_candidates(self):
        store, plugin = _stack()
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=1))
        store.create_pod(_bound("p0", {"grp": "a"}))
        plugin.run_pending_once()  # status + its echo land in the st planes
        dm = plugin.device_manager
        flips: dict = {}
        dm.aggregate_used_for("throttle", ["default/t1"], flips_out=flips)
        assert flips["drained"] == set() and flips["promote"] == set()


# ---------------------------------------------------------------------------
# controller commit ordering (local batched path)
# ---------------------------------------------------------------------------


class TestControllerFlipFirstCommit:
    def test_flip_key_commits_before_refresh_keys(self):
        store, plugin = _stack()
        # tflip: pod-count threshold 2 over grp a (flips when p2 arrives);
        # trefresh_*: huge thresholds over grp b (value-only refreshes)
        store.create_throttle(_throttle("tflip", {"grp": "a"}, pod=2))
        for i in range(8):
            store.create_throttle(_throttle(f"tref{i}", {"grp": "b"}, pod=10**6))
        store.create_pod(_bound("pa", {"grp": "a"}))
        store.create_pod(_bound("pb", {"grp": "b"}))
        plugin.run_pending_once()

        order = []

        def record(event):
            if event.type == EventType.MODIFIED:
                order.append(event.obj.key)

        store.add_event_handler("Throttle", record, replay=False)
        # enqueue the REFRESH keys first (cpu-value change in grp b), the
        # flip trigger last — FIFO alone would commit the refreshes first
        store.update_pod(_bound("pb", {"grp": "b"}, cpu="200m"))
        store.create_pod(_bound("pa2", {"grp": "a"}))  # used 2 ≥ 2: flip
        plugin.run_pending_once()
        store.remove_event_handler("Throttle", record)

        assert "default/tflip" in order
        flip_at = order.index("default/tflip")
        ref_ats = [order.index(k) for k in order if k.startswith("default/tref")]
        assert ref_ats, "refresh writes missing"
        assert flip_at < min(ref_ats), order
        flipped = store.get_throttle("default", "tflip")
        assert flipped.status.throttled.resource_counts_pod is True


# ---------------------------------------------------------------------------
# end-to-end remote loop under the PR-1 fault plan (409 storm + watch cuts)
# ---------------------------------------------------------------------------


class TestRemoteFlipUnderFaults:
    def test_flip_publishes_through_conflict_storm_and_watch_cuts(self):
        server = MockApiServer(bookmark_interval=0.05)
        remote = server.store
        remote.create_namespace(Namespace("default"))
        remote.create_throttle(_throttle("tflip", {"grp": "a"}, pod=2))
        remote.create_throttle(_throttle("tref", {"grp": "a"}, pod=10**6))
        remote.create_pod(_bound("p0", {"grp": "a"}))
        plan = FaultPlan(3)
        plan.rule("mock.status.conflict", probability=0.5, times=20)
        plan.rule("mock.watch.cut", probability=0.2, times=3)
        server.faults = plan
        server.start()

        # per-key PUT arrival order at the apiserver: used counts for one
        # key must never regress (flip and refresh never race out of order)
        seq: dict = {}

        def record(event):
            if event.type == EventType.MODIFIED:
                counts = event.obj.status.used.resource_counts
                seq.setdefault(event.obj.key, []).append(counts)

        remote.add_event_handler("Throttle", record, replay=False)
        local = Store()
        session = RemoteSession(RestConfig(server=server.url), local, qps=None)
        plugin = None
        try:
            session.start(sync_timeout=15)
            plugin = KubeThrottler(
                decode_plugin_args(
                    {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
                ),
                local,
                use_device=True,
                start_workers=True,
                status_writer=session.status_committer, device="cpu",
            )
            assert _wait(
                lambda: (
                    remote.get_throttle("default", "tflip").status.used.resource_counts
                    == 1
                ),
                timeout=15,
            )
            remote.create_pod(_bound("p1", {"grp": "a"}))  # used 2 ≥ 2: flip
            assert _wait(
                lambda: remote.get_throttle(
                    "default", "tflip"
                ).status.throttled.resource_counts_pod,
                timeout=15,
            ), "flip never published through the fault storm"
        finally:
            if plugin is not None:
                plugin.stop()
            session.stop()
            server.stop()
            remote.remove_event_handler("Throttle", record)
        assert plan.fired("mock.status.conflict") > 0, "conflict verb never fired"
        for key, counts in seq.items():
            present = [c for c in counts if c is not None]
            assert present == sorted(present), (key, counts)


# ---------------------------------------------------------------------------
# regressions: mid-batch R growth, the import-time env parse
# ---------------------------------------------------------------------------


class TestCheckPodsMultiRGrowth:
    def _grown_batch(self):
        store, plugin = _stack()
        store.create_throttle(_throttle("t1", {"grp": "a"}, requests={"cpu": "1"}))
        store.create_pod(_bound("p0", {"grp": "a"}, cpu="900m"))
        plugin.run_pending_once()
        # probe pods NOT in the store; the second introduces a never-seen
        # resource name mid-batch, growing ks.R after p-first was encoded
        first = make_pod("probe-a", labels={"grp": "a"}, requests={"cpu": "200m"})
        grower = make_pod(
            "probe-b",
            labels={"grp": "a"},
            requests={"cpu": "200m", "vendor.example/widget": "3"},
        )
        third = make_pod("probe-c", labels={"grp": "a"}, requests={"cpu": "200m"})
        return plugin, [first, grower, third]

    def test_host_route_matches_single_pod_checks(self):
        plugin, pods = self._grown_batch()
        dm = plugin.device_manager
        multi = dm.check_pods_multi(pods, "throttle")
        # fresh equivalent objects so the per-pod path re-encodes at the
        # grown R rather than hitting the batch's memo entries
        import copy

        singles = [dm.check_pod(copy.deepcopy(p), "throttle") for p in pods]
        assert multi == singles
        # every verdict present: 0.9 + 0.2 ≥ 1 cpu ⇒ insufficient for all
        for res in multi:
            assert res == {"default/t1": "insufficient"}

    def test_device_route_survives_mid_batch_growth(self, monkeypatch):
        # the fused-kernel route previously crashed on the row-width
        # mismatch (req[i] = rq[0] broadcast error); with the re-encode it
        # must return the same verdicts as the host route
        plugin, pods = self._grown_batch()
        dm = plugin.device_manager
        monkeypatch.setattr(dm, "_single_check_device", True)
        multi = dm.check_pods_multi(pods, "throttle")
        for res in multi:
            assert res == {"default/t1": "insufficient"}


class TestGcHygiene:
    def test_disabled_via_env(self, monkeypatch):
        from kube_throttler_tpu_torch.utils import gchygiene

        monkeypatch.setenv("KT_GC_FREEZE", "0")
        assert not gchygiene.enabled()
        assert gchygiene.freeze_startup_heap() == -1

    def test_freeze_and_backstop_thread(self, monkeypatch):
        import gc

        from kube_throttler_tpu_torch.utils.gchygiene import (
            GcHygieneThread,
            freeze_startup_heap,
        )

        # floor 1: any heap qualifies, so the freeze branch is exercised
        # deterministically regardless of the test process's heap size
        monkeypatch.setenv("KT_GC_FREEZE_MIN_OBJECTS", "1")
        thresholds = gc.get_threshold()
        try:
            frozen = freeze_startup_heap()
            assert frozen > 0
            assert gc.get_threshold()[2] == 1_000_000  # gen2 deferred
            t = GcHygieneThread(interval_s=0.05)
            t.start()
            assert _wait(lambda: t.ticks >= 1, timeout=5)
            t.stop()
            assert t.last_pause_s is not None and t.last_pause_s >= 0
        finally:
            # don't leak the posture into the rest of the test process
            gc.set_threshold(*thresholds)
            gc.unfreeze()

    def test_small_heap_skips_freeze(self, monkeypatch):
        # the columnar-arena retune: below the tracked-object floor the
        # posture is a no-op — default generational GC stays in charge
        import gc

        from kube_throttler_tpu_torch.utils.gchygiene import freeze_startup_heap

        monkeypatch.setenv("KT_GC_FREEZE_MIN_OBJECTS", str(1 << 40))
        thresholds = gc.get_threshold()
        frozen_before = gc.get_freeze_count()
        assert freeze_startup_heap() == 0
        assert gc.get_threshold() == thresholds  # gen2 NOT deferred
        assert gc.get_freeze_count() == frozen_before

    def test_malformed_floor_env_falls_back(self, monkeypatch):
        from kube_throttler_tpu_torch.utils.gchygiene import freeze_min_objects

        monkeypatch.setenv("KT_GC_FREEZE_MIN_OBJECTS", "half-a-million")
        assert freeze_min_objects() == 200_000


class TestGatherChunkEnvGuard:
    def test_malformed_env_falls_back_to_default(self):
        code = (
            "import kube_throttler_tpu_torch.ops.check_gather as m\n"
            "print(m._GATHER_CHUNK_ELEMS)\n"
        )
        env = dict(os.environ)
        env["KT_GATHER_CHUNK_ELEMS"] = "sixty-four-million"
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True, timeout=120, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        assert r.stdout.decode().strip() == str(64 * 1024 * 1024)
