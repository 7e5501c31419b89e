"""Micro-batched ingest equivalence + group-commit semantics.

The load-bearing contract: for ANY partition of an event stream into
micro-batches, the batched pipeline is observably identical to
one-at-a-time ingest — same final store dump, same published ``st_*``
device planes, same ``pre_filter`` verdicts. Deterministic cases pin the
coalescing edge shapes (same-pod runs, delete-after-update, mixed kinds);
the hypothesis property test (importorskip, like test_property_oracle.py)
randomizes streams AND partitions. The batched pending-delta application
is additionally pinned bit-for-bit against the REAL
``apply_pod_deltas_batched`` device kernel.
"""

from __future__ import annotations

import queue
from dataclasses import replace

import numpy as np
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
from kube_throttler_tpu_torch.client.watch import Watch
from kube_throttler_tpu_torch.engine import devicestate as ds_mod
from kube_throttler_tpu_torch.engine.ingest import MicroBatchIngest
from kube_throttler_tpu_torch.engine.store import Event, EventType, Store
from kube_throttler_tpu_torch.faults.plan import FaultPlan
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _throttle(i: int, grp: str, pods: int = 3, cpu: str = "1") -> Throttle:
    return Throttle(
        name=f"t{i}",
        namespace="default",
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(pod=pods, requests={"cpu": cpu}),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels={"grp": grp})),
                )
            ),
        ),
    )


def _pod(name: str, grp: str, cpu_m: int, running: bool = True):
    pod = make_pod(name, labels={"grp": grp}, requests={"cpu": f"{cpu_m}m"})
    if running:
        pod = replace(pod, spec=replace(pod.spec, node_name="node-1"))
        pod.status.phase = "Running"
    return pod


def _build(n_throttles: int = 4):
    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True,
        start_workers=False, device="cpu",
    )
    store.create_namespace(Namespace("default"))
    for i in range(n_throttles):
        store.create_throttle(_throttle(i, f"g{i % 2}", pods=2 + i, cpu=str(1 + i)))
    return store, plugin


_NONDETERMINISTIC_KEYS = ("uid", "calculatedAt")


def _strip_uid(doc):
    if isinstance(doc, dict):
        return {
            k: _strip_uid(v)
            for k, v in doc.items()
            if k not in _NONDETERMINISTIC_KEYS
        }
    if isinstance(doc, list):
        return [_strip_uid(v) for v in doc]
    return doc


def _dump(store: Store) -> dict:
    # uids are process-global counters — two independently built stacks
    # assign different ones, so they are normalized out of the comparison
    return _strip_uid(
        {
            "Namespace": {n.name: object_to_dict(n) for n in store.list_namespaces()},
            "Throttle": {t.key: object_to_dict(t) for t in store.list_throttles()},
            "Pod": {p.key: object_to_dict(p) for p in store.list_pods()},
        }
    )


def _verdicts(plugin, store) -> dict:
    out = {}
    for pod in sorted(store.list_pods(), key=lambda p: p.key):
        status = plugin.pre_filter(pod)
        out[pod.key] = (status.code.value, tuple(sorted(status.reasons)))
    return out


def _assert_equivalent(seq, bat):
    """seq/bat = (store, plugin): full observable-equivalence oracle."""
    store_a, plugin_a = seq
    store_b, plugin_b = bat
    assert _dump(store_a) == _dump(store_b)
    # published st_* planes (throttled flags per key, both kinds)
    assert (
        plugin_a.device_manager.published_flags()
        == plugin_b.device_manager.published_flags()
    )
    # aggregates observed through a reconcile settle both sides equally
    plugin_a.run_pending_once()
    plugin_b.run_pending_once()
    assert _dump(store_a) == _dump(store_b)
    assert _verdicts(plugin_a, store_a) == _verdicts(plugin_b, store_b)


def _apply_sequential(store, ops):
    for verb, kind, payload in ops:
        res = store.apply_events([(verb, kind, payload)])
        assert len(res) == 1


def _apply_partition(store, ops, sizes):
    i = 0
    for n in sizes:
        if i >= len(ops):
            break
        store.apply_events(ops[i : i + n])
        i += n
    if i < len(ops):
        store.apply_events(ops[i:])


class TestBatchedIngestEquivalence:
    def _ops_basic(self):
        ops = []
        for i in range(8):
            ops.append(("create", "Pod", _pod(f"p{i}", f"g{i % 2}", 100 * (1 + i % 7))))
        # same-pod run: three updates + the telescoping edge
        for cpu in (300, 500, 200):
            ops.append(("update", "Pod", _pod("p0", "g0", cpu)))
        # relabel mid-batch (mask row moves; row_stable must NOT trigger)
        ops.append(("update", "Pod", _pod("p1", "g0", 400)))
        # delete-after-update in one batch
        ops.append(("update", "Pod", _pod("p2", "g0", 700)))
        ops.append(("delete", "Pod", "default/p2"))
        # a pod that matches nothing
        ops.append(("create", "Pod", _pod("px", "nomatch", 100)))
        # pending (not scheduled) pod — not counted, still indexed
        ops.append(("create", "Pod", _pod("py", "g1", 100, running=False)))
        return ops

    @pytest.mark.parametrize("sizes", [(1,), (2, 3), (5,), (64,), (1, 7, 2)])
    def test_partitions_equivalent(self, sizes):
        seq = _build()
        bat = _build()
        ops = self._ops_basic()
        _apply_sequential(seq[0], ops)
        _apply_partition(bat[0], ops, sizes * 20)
        _assert_equivalent(seq, bat)
        seq[1].stop()
        bat[1].stop()

    def test_mixed_kind_batch_preserves_order(self):
        """A batch interleaving pod events with a throttle selector change
        must apply in order: pods before the selector edit match the OLD
        column, pods after match the NEW one."""
        seq = _build()
        bat = _build()
        moved = _throttle(0, "g1", pods=2, cpu="1")  # t0 now selects g1
        ops = [
            ("create", "Pod", _pod("a", "g0", 100)),
            ("update", "Throttle", moved),
            ("create", "Pod", _pod("b", "g0", 100)),
            ("create", "Pod", _pod("c", "g1", 100)),
        ]
        _apply_sequential(seq[0], ops)
        bat[0].apply_events(ops)
        _assert_equivalent(seq, bat)
        seq[1].stop()
        bat[1].stop()

    def test_per_op_failure_never_tears_batch(self):
        store, plugin = _build()
        ops = [
            ("create", "Pod", _pod("ok1", "g0", 100)),
            ("create", "Pod", _pod("ok1", "g0", 100)),  # duplicate → ValueError
            ("delete", "Pod", "default/never-existed"),  # NotFoundError
            ("create", "Pod", _pod("ok2", "g1", 200)),
        ]
        res = store.apply_events(ops)
        assert not isinstance(res[0], Exception)
        assert isinstance(res[1], Exception)
        assert isinstance(res[2], Exception)
        assert not isinstance(res[3], Exception)
        assert {p.name for p in store.list_pods()} == {"ok1", "ok2"}
        plugin.stop()

    def test_event_rv_stamped_and_ordered(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        seen = []
        store.add_event_handler("Pod", lambda e: seen.append(e.rv))
        store.apply_events(
            [("create", "Pod", _pod(f"r{i}", "g0", 100)) for i in range(5)]
        )
        assert all(rv is not None for rv in seen)
        assert seen == sorted(seen)
        assert seen[-1] == store.latest_resource_version


class TestPropertyEquivalence:
    def test_random_streams_random_partitions(self):
        """hypothesis (importorskip, like test_property_oracle.py): random
        event streams × random batch partitions — batched ingest ≡
        one-at-a-time ingest on store dump, st_* planes, and pre_filter
        verdicts."""
        pytest.importorskip("hypothesis")
        from hypothesis import HealthCheck, given, settings, strategies as st

        pod_names = [f"p{i}" for i in range(5)]
        groups = ["g0", "g1", "nomatch"]

        op_st = st.one_of(
            st.tuples(
                st.just("upsert"),
                st.sampled_from(pod_names),
                st.sampled_from(groups),
                st.integers(1, 8),
                st.booleans(),
            ),
            st.tuples(st.just("delete"), st.sampled_from(pod_names)),
        )

        @settings(
            max_examples=10,
            deadline=None,
            suppress_health_check=[HealthCheck.too_slow],
        )
        @given(
            ops_raw=st.lists(op_st, min_size=1, max_size=25),
            sizes=st.lists(st.integers(1, 9), min_size=1, max_size=8),
        )
        def run(ops_raw, sizes):
            ops = []
            for raw in ops_raw:
                if raw[0] == "delete":
                    ops.append(("delete", "Pod", f"default/{raw[1]}"))
                else:
                    _, name, grp, cpu, running = raw
                    ops.append(
                        ("upsert", "Pod", _pod(name, grp, cpu * 100, running=running))
                    )
            seq = _build(n_throttles=3)
            bat = _build(n_throttles=3)
            try:
                # deletes of absent pods fail per-op on both sides alike
                _apply_sequential(seq[0], ops)
                _apply_partition(bat[0], ops, sizes * 5)
                _assert_equivalent(seq, bat)
            finally:
                seq[1].stop()
                bat[1].stop()

        run()


class TestPendingDeltaKernelParity:
    def test_host_route_matches_device_kernel(self):
        """apply_pending_batched's host mirror is bit-identical to the real
        apply_pod_deltas_batched kernel over the same encoded burst."""
        rng = np.random.default_rng(7)
        store, plugin = _build()
        ks = plugin.device_manager.throttle
        # build a synthetic pending burst in the capture format
        pending = []
        for _ in range(17):
            k = int(rng.integers(1, 4))
            cols = rng.choice(ks.tcap - 1, size=k, replace=False).astype(np.int32)
            sign = int(rng.choice([-1, 1]))
            req = rng.integers(0, 10**9, size=ks.R).astype(np.int64)
            present = rng.random(ks.R) > 0.5
            pending.append((cols, sign, req, present))
        # seed both routes from the same aggregate state
        base_cnt = rng.integers(0, 50, size=ks.tcap).astype(np.int64)
        base_req = rng.integers(0, 10**10, size=(ks.tcap, ks.R)).astype(np.int64)
        base_ctb = rng.integers(0, 20, size=(ks.tcap, ks.R)).astype(np.int32)

        def run(device: bool):
            old = ds_mod._AGG_DEVICE_DELTAS
            ds_mod._AGG_DEVICE_DELTAS = device
            try:
                ks.agg_cnt = base_cnt.copy()
                ks.agg_req = base_req.copy()
                ks.agg_contrib = base_ctb.copy()
                ks.apply_pending_batched(list(pending))
                return ks.agg_cnt.copy(), ks.agg_req.copy(), ks.agg_contrib.copy()
            finally:
                ds_mod._AGG_DEVICE_DELTAS = old

        h_cnt, h_req, h_ctb = run(False)
        d_cnt, d_req, d_ctb = run(True)
        np.testing.assert_array_equal(h_cnt, d_cnt)
        np.testing.assert_array_equal(h_req, d_req)
        np.testing.assert_array_equal(h_ctb, d_ctb)
        plugin.stop()


class TestIngestPipeline:
    def test_adaptive_collapses_to_single_when_idle(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        pipe = MicroBatchIngest(store)
        for i in range(3):
            pipe.submit("upsert", "Pod", _pod(f"i{i}", "g0", 100))
            assert pipe.flush(5)
        st = pipe.stats()
        assert st["events_applied"] == 3
        assert st["cur_max"] == 1  # idle between submits → no batch growth
        pipe.stop()

    def test_backlog_grows_batches_and_drains(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        pipe = MicroBatchIngest(store, max_batch=16)
        pipe.submit_many(
            [("upsert", "Pod", _pod(f"b{i}", "g0", 100)) for i in range(200)]
        )
        assert pipe.flush(10)
        st = pipe.stats()
        assert st["events_applied"] == 200
        assert st["max_batch_seen"] > 1
        assert st["batches"] < 200  # amortization actually happened
        assert len(store.list_pods()) == 200
        pipe.stop()

    def test_overflow_drops_oldest_counting_per_event(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        # stall the dispatcher behind a slow handler so the queue fills
        import threading

        gate = threading.Event()
        store.add_event_handler("Pod", lambda e: gate.wait(2))
        pipe = MicroBatchIngest(store, maxsize=8)
        pipe.submit_many(
            [("upsert", "Pod", _pod(f"o{i}", "g0", 100)) for i in range(30)]
        )
        st = pipe.stats()
        assert st["dropped"] >= 30 - 8 - 2  # per-event accounting (±in-flight)
        assert st["overflowed"]
        gate.set()
        pipe.flush(10)
        pipe.stop()

    def test_partial_batch_fault_splits_and_continues(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        plan = FaultPlan(seed=0).rule("ingest.batch.partial", times=1)
        pipe = MicroBatchIngest(store, faults=plan)
        pipe.submit_many(
            [("upsert", "Pod", _pod(f"f{i}", "g0", 100)) for i in range(9)]
        )
        assert pipe.flush(10)
        st = pipe.stats()
        assert st["op_errors"] >= 1  # the poisoned op
        # every op around the poisoned one landed
        assert len(store.list_pods()) + st["op_errors"] == 9
        pipe.stop()


class TestJournalGroupCommit:
    def test_batch_replay_and_position(self, tmp_path):
        from kube_throttler_tpu_torch.engine.journal import attach, hash_prefix

        path = str(tmp_path / "j.journal")
        store = Store()
        journal = attach(store, path)
        store.create_namespace(Namespace("default"))
        store.apply_events(
            [("create", "Pod", _pod(f"j{i}", "g0", 100)) for i in range(6)]
            + [("delete", "Pod", "default/j3")]
        )
        nbytes, sha = journal.position()
        # the running position matches the on-disk content exactly
        h = hash_prefix(path, nbytes)
        assert h is not None and h.hexdigest() == sha
        journal.close()
        replayed = Store()
        attach(replayed, path).close()
        assert _dump(replayed) == _dump(store)

    def test_torn_line_inside_batch_is_interior_corruption(self, tmp_path):
        from kube_throttler_tpu_torch.engine.journal import attach

        path = str(tmp_path / "j.journal")
        store = Store()
        plan = FaultPlan(seed=0).rule(
            "journal.append", mode="torn", schedule=[3]
        )
        journal = attach(store, path, faults=plan)
        store.create_namespace(Namespace("default"))
        store.apply_events(
            [("create", "Pod", _pod(f"t{i}", "g0", 100)) for i in range(5)]
        )
        assert journal.torn_writes == 1
        journal.close()
        replayed = Store()
        j2 = attach(replayed, path)
        # the torn line ate itself AND the next line (concatenated) — every
        # other event replays; corruption is counted, not fatal
        assert j2.replay_skipped >= 1
        names = {p.name for p in replayed.list_pods()}
        assert "t0" in names and "t4" in names
        j2.close()


class TestWatchBatchDelivery:
    def test_batch_events_delivered_in_order(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        w = Watch(store, "Pod")
        store.apply_events(
            [("create", "Pod", _pod(f"w{i}", "g0", 100)) for i in range(5)]
        )
        got = [w.next(timeout=1).obj.name for _ in range(5)]
        assert got == [f"w{i}" for i in range(5)]
        # batch went in as ONE queue item
        assert w.dropped == 0
        w.stop()

    def test_shed_batch_counts_per_event(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        w = Watch(store, "Pod", maxsize=2)
        # two batches of 4: the second shed the first (4 events), etc.
        for b in range(3):
            store.apply_events(
                [("create", "Pod", _pod(f"s{b}-{i}", "g0", 100)) for i in range(4)]
            )
        # queue holds 2 items (batches); 1 batch of 4 events was shed
        assert w.dropped == 4
        assert w.overflowed
        w.stop()

    def test_next_batch_drains(self):
        store = Store()
        store.create_namespace(Namespace("default"))
        w = Watch(store, "Pod")
        store.apply_events(
            [("create", "Pod", _pod(f"n{i}", "g0", 100)) for i in range(3)]
        )
        store.create_pod(_pod("n3", "g0", 100))
        batch = w.next_batch(timeout=1)
        assert [e.obj.name for e in batch] == ["n0", "n1", "n2", "n3"]
        with pytest.raises(queue.Empty):
            w.next(timeout=0.05)
        w.stop()


class TestReflectorBatching:
    def test_remote_session_routes_watch_through_batcher(self):
        """Remote mode with ``ingest_batch="adaptive"``: watch events reach
        the local mirror through the micro-batcher; deletes and relists
        stay coherent (the relist flushes the queue first)."""
        import time as _time

        from kube_throttler_tpu_torch.client.mockserver import MockApiServer
        from kube_throttler_tpu_torch.client.transport import RemoteSession, RestConfig

        server = MockApiServer()
        remote = server.store
        remote.create_namespace(Namespace("default"))
        remote.create_throttle(_throttle(0, "g0"))
        server.start()
        local = Store()
        session = RemoteSession(
            RestConfig(server=server.url), local, qps=None,
            ingest_batch="adaptive",
        )
        try:
            session.start(sync_timeout=30)
            assert session.ingest is not None
            for i in range(20):
                remote.create_pod(_pod(f"r{i}", "g0", 100))
            remote.delete_pod("default", "r3")

            def _wait(pred, timeout=15.0):
                deadline = _time.monotonic() + timeout
                while _time.monotonic() < deadline:
                    if pred():
                        return True
                    _time.sleep(0.05)
                return pred()

            assert _wait(lambda: len(local.list_pods()) == 19)
            assert {p.name for p in local.list_pods()} == {
                f"r{i}" for i in range(20) if i != 3
            }
            assert session.ingest.stats()["events_applied"] >= 20
        finally:
            session.stop()
            server.stop()


class TestIngestFlipPromotion:
    def test_batch_crossing_promotes_to_priority_lane(self):
        """A micro-batch whose deltas flip a throttle's classification must
        land that key in the controller's PRIORITY lane before any
        reconcile runs (one flip detection + one add_all_priority per
        batch)."""
        store, plugin = _build(n_throttles=2)
        # settle initial state so the st_* planes are published
        plugin.run_pending_once()
        wq = plugin.throttle_ctr.workqueue
        # t0: threshold pod=2 over g0 — two running pods cross it
        store.apply_events(
            [
                ("create", "Pod", _pod("f1", "g0", 100)),
                ("create", "Pod", _pod("f2", "g0", 100)),
                ("create", "Pod", _pod("f3", "g0", 100)),
            ]
        )
        with wq._lock:  # noqa: SLF001 — lane introspection
            hi = [item for _, _, item in wq._queue_hi]  # heap of (-prio, seq, item)
        assert "default/t0" in hi
        plugin.run_pending_once()
        thr = store.get_throttle("default", "t0")
        assert thr.status.throttled.resource_counts_pod
        plugin.stop()


class TestCommitterPerKeyFlipOrdering:
    def test_multiple_same_key_flips_in_one_batch(self):
        """One batch submitting flip(v1), refresh(v2), flip(v3) for one key
        must publish newest-wins in order, never demote the key's lane,
        and never PUT an older object after a newer one."""
        from kube_throttler_tpu_torch.client.transport import AsyncStatusCommitter

        puts = []

        class _Writer:
            def _put(self, kind, obj):
                puts.append((kind, obj.name, obj.status.used.resource_counts))

            def refresh_version(self, kind, obj):
                pass

        committer = AsyncStatusCommitter(_Writer(), workers=1)
        thrs = []
        for used in (1, 2, 3):
            t = _throttle(0, "g0")
            t = t.with_status(
                replace(t.status, used=ResourceAmount(resource_counts=used))
            )
            thrs.append(t)
        # one batch: flip, refresh, flip — all same key, workers not started
        committer.update_throttle_statuses_prioritized(
            [thrs[0]], flip_keys={thrs[0].key}
        )
        committer.update_throttle_statuses_prioritized([thrs[1]])  # refresh
        committer.update_throttle_statuses_prioritized(
            [thrs[2]], flip_keys={thrs[2].key}
        )
        i = hash(thrs[0].key) % 1
        assert thrs[0].key in committer._hi_shards[i]  # never demoted
        slot = committer._hi_shards[i][thrs[0].key]
        assert slot[3] is True and slot[1] is thrs[2]  # newest wins, flip kept
        committer.start()
        assert committer.flush(5)
        committer.stop()
        # exactly one PUT: the newest object; no stale write followed it
        assert puts == [("Throttle", "t0", 3)]
