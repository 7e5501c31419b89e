"""Zero-copy shared-memory event plane: ring mechanics + fleet contract.

Unit half exercises the SPSC ring and the columnar codec directly:
wraparound, slot exhaustion (counted backpressure, never a silent
drop), torn-commit detection, close-under-peek, and codec round-trips
including the ``ROW_BLOB`` escape hatch and the whole-pod row cache.

Fleet half drives the REAL multiprocess stack (front + ShardSupervisor
+ worker subprocesses) and pins the repair/fallback contract:

- a worker SIGKILLed mid-stream comes back on a FRESH segment (the old
  one unlinked — no ``/dev/shm`` leak) with the lane active again;
- a peer that masks the ``evt-shm`` capability never gets a lane: evt
  batches ride the HMAC-framed pickle socket (the fallback counter
  proves it) and verdicts still equal the single-process oracle.
"""

from __future__ import annotations

import os
import pickle
import signal
import time

import pytest

import tools.harness_torch as H
from kube_throttler_tpu_torch.api.pod import Namespace, Pod, make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.faults.plan import FaultPlan
from kube_throttler_tpu_torch.sharding import ipc
from kube_throttler_tpu_torch.sharding.front import AdmissionFront
from kube_throttler_tpu_torch.sharding.shmring import (
    FrameDecoder,
    FrameEncoder,
    ShmEventLane,
    ShmRingReader,
    ShmRingWriter,
    TornSlotError,
    shm_available,
    sweep_segments,
)
from kube_throttler_tpu_torch.sharding.supervisor import ShardSupervisor
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

pytestmark = pytest.mark.skipif(
    not shm_available(), reason="POSIX shared memory unavailable"
)


def _ring(slots=8, arena=1 << 16, faults=None):
    w = ShmRingWriter(slots=slots, arena_bytes=arena, faults=faults)
    r = ShmRingReader(w.name, faults=faults)
    return w, r


def _drain_one(r, timeout=1.0):
    view = r.peek(timeout=timeout)
    assert view is not None
    out = bytes(view)
    view.release()
    r.advance()
    return out


# ------------------------------------------------------------ ring mechanics


class TestRingMechanics:
    def test_fifo_roundtrip(self):
        w, r = _ring()
        try:
            frames = [bytes([i]) * (100 + i) for i in range(5)]
            for f in frames:
                assert w.push(f, timeout=1.0)
            assert [_drain_one(r) for _ in frames] == frames
            assert r.depth() == 0
        finally:
            r.close()
            w.close()

    def test_wraparound_preserves_frames(self):
        # arena fits ~4 frames: steady-state streaming must wrap the
        # allocator cursor and every frame must still arrive intact
        # keep 2 frames in flight so the allocator can't reset to
        # offset 0 on a drained arena — it must WRAP past live bytes
        w, r = _ring(slots=64, arena=4096)
        try:
            expected = []
            for i in range(64):
                payload = bytes([i % 251]) * 900
                assert w.push(payload, timeout=2.0), f"push {i} stalled"
                expected.append(payload)
                if len(expected) > 2:
                    assert _drain_one(r) == expected.pop(0)
            while expected:
                assert _drain_one(r) == expected.pop(0)
            assert w.stats()["wraps"] >= 1, "arena never wrapped — vacuous"
            assert w.stats()["frames"] == 64
        finally:
            r.close()
            w.close()

    def test_slot_exhaustion_is_counted_backpressure_not_a_drop(self):
        w, r = _ring(slots=4, arena=1 << 16)
        try:
            for i in range(4):
                assert w.push(b"x" * 64, timeout=1.0)
            # no reader progress: the 5th frame must block, count the
            # wait, and report failure — never silently vanish
            t0 = time.monotonic()
            assert w.push(b"y" * 64, timeout=0.25) is False
            assert time.monotonic() - t0 >= 0.2
            stats = w.stats()
            assert stats["backpressure"] >= 1
            assert stats["frames"] == 4  # the failed frame was not committed
            # a consuming reader unblocks the writer again
            _drain_one(r)
            assert w.push(b"y" * 64, timeout=1.0)
        finally:
            r.close()
            w.close()

    def test_torn_commit_raises_and_counts(self):
        plan = FaultPlan(seed=3).rule(
            "shm.slot.torn_commit", mode="torn", times=1
        )
        w, r = _ring(faults=plan)
        try:
            assert w.push(b"doomed", timeout=1.0)  # commit word is garbage
            with pytest.raises(TornSlotError):
                r.peek(timeout=0.5)
            assert r.torn == 1
            assert plan.fired("shm.slot.torn_commit") == 1
        finally:
            r.close()
            w.close()

    def test_push_after_close_returns_false(self):
        w, r = _ring()
        r.close()
        w.close()
        assert w.push(b"late", timeout=0.1) is False

    def test_reader_close_under_peek_reports_empty(self):
        w, r = _ring()
        w.push(b"frame", timeout=1.0)
        _drain_one(r)
        r.close()
        # teardown race: a racing peek on a released buffer must read
        # as empty, never as a torn slot
        assert r.peek(timeout=0.05) is None
        w.close()

    def test_frame_larger_than_arena_rejected(self):
        w, r = _ring(slots=4, arena=4096)
        try:
            with pytest.raises(ValueError):
                w.push(b"z" * 8192, timeout=0.1)
        finally:
            r.close()
            w.close()


# ------------------------------------------------------------------- codec


def _canonical_store(n_pods=6):
    store = Store()
    store.create_namespace(Namespace("default"))
    for i in range(n_pods):
        store.create_pod(
            make_pod(
                f"p{i}",
                labels={"grp": f"g{i % 3}", "tier": "web"},
                requests={"cpu": f"{(i + 1) * 100}m", "memory": "64Mi"},
                node_name=f"node-{i % 2}",
                phase="Running",
            )
        )
    return store


def _assert_pod_equal(got: Pod, want: Pod):
    assert got.name == want.name and got.namespace == want.namespace
    assert got.labels == want.labels and got.annotations == want.annotations
    assert got.uid == want.uid
    assert got.status.phase == want.status.phase
    assert got.spec.node_name == want.spec.node_name
    assert got.spec.scheduler_name == want.spec.scheduler_name
    assert [c.requests for c in got.spec.containers or ()] == [
        c.requests for c in want.spec.containers or ()
    ]


class TestColumnarCodec:
    def test_roundtrip_canonical_pods_keys_and_blobs(self):
        store = _canonical_store()
        pods = sorted(store.list_pods(), key=lambda p: p.name)
        sparse = Pod(name="sparse", namespace="default")  # no spec: blob row
        throttle = H.make_throttle(0)
        ops = (
            [("update", "Pod", p) for p in pods]
            + [
                ("delete", "Pod", "default/p0"),
                ("update", "Pod", sparse),
                ("update", "Throttle", throttle),
            ]
        )
        enc, dec = FrameEncoder(), FrameDecoder()
        epoch, seq, out = dec.decode(enc.encode(ops, epoch=7, seq=0))
        assert (epoch, seq) == (7, 0)
        assert len(out) == len(ops)
        for got, want in zip(out[: len(pods)], pods):
            assert got[:2] == ("update", "Pod")
            _assert_pod_equal(got[2], want)
        assert out[len(pods)] == ("delete", "Pod", "default/p0")
        assert out[len(pods) + 1][2].name == "sparse"  # blob round-trip
        assert out[len(pods) + 2][2].key == throttle.key

    def test_row_cache_reencodes_identically(self):
        store = _canonical_store(n_pods=3)
        pods = store.list_pods()
        ops = [("update", "Pod", p) for p in pods]
        enc, dec = FrameEncoder(), FrameDecoder()
        _, _, first = dec.decode(enc.encode(ops, epoch=1, seq=0))
        assert enc._row_by_obj  # second pass hits the whole-pod cache
        _, _, second = dec.decode(enc.encode(ops, epoch=1, seq=1))
        for (_, _, a), (_, _, b) in zip(first, second):
            _assert_pod_equal(a, b)

    def test_lane_splits_oversized_batches(self):
        w = ShmRingWriter(slots=256, arena_bytes=1 << 20)
        r = ShmRingReader(w.name)
        lane = ShmEventLane(w)
        try:
            store = _canonical_store(n_pods=4)
            pods = store.list_pods()
            ops = [("update", "Pod", pods[i % 4]) for i in range(300)]
            assert lane.send(ops, epoch=1)
            dec = FrameDecoder()
            got = []
            frames = 0
            while len(got) < len(ops):
                view = r.peek(timeout=2.0)
                assert view is not None, "lane lost events across the split"
                _, _, decoded = dec.decode(view)
                got.extend(decoded)
                view.release()
                r.advance()
                frames += 1
            assert frames >= 2  # the batch really split
            assert len(got) == len(ops)
        finally:
            r.close()
            lane.close()


# --------------------------------------------------- fan-out dedup (pickle)


def test_fanout_dedup_serializes_shared_payload_once():
    store = _canonical_store(n_pods=1)
    pod = store.list_pods()[0]
    # the router fanned the same payload object into three shard buffers
    buffers = {sid: [("update", "Pod", pod)] for sid in range(3)}
    AdmissionFront._dedup_fanout(buffers)
    wrapped = {id(buffers[sid][0][2]) for sid in range(3)}
    assert len(wrapped) == 1, "fan-out must share ONE wrapper"
    payload = buffers[0][0][2]
    assert isinstance(payload, ipc.PrepickledPayload)
    before = ipc.PREPICKLE_SERIALIZATIONS
    for sid in range(3):  # each shard sender pickles its own evt frame
        pickle.loads(
            pickle.dumps(ipc.encode_evt_batch(buffers[sid]),
                         protocol=ipc.PICKLE_PROTO)
        )
    assert ipc.PREPICKLE_SERIALIZATIONS - before == 1, (
        "shared payload must serialize exactly once across the fan-out"
    )


def test_fanout_dedup_leaves_singletons_alone():
    store = _canonical_store(n_pods=2)
    a, b = sorted(store.list_pods(), key=lambda p: p.name)
    buffers = {0: [("update", "Pod", a)], 1: [("update", "Pod", b)],
               2: [("delete", "Pod", "default/p0")]}
    AdmissionFront._dedup_fanout(buffers)
    assert buffers[0][0][2] is a  # single-shard payloads stay unwrapped
    assert buffers[1][0][2] is b
    assert buffers[2][0][2] == "default/p0"


# ------------------------------------------------------------- fleet tests


N_SHARDS = 2


def _seed(front, n_pods=24):
    front.store.create_namespace(Namespace("default"))
    for i in range(3):
        front.store.create_throttle(H.make_throttle(i))
    for i in range(n_pods):
        front.store.create_pod(
            make_pod(
                f"p{i}",
                labels={"grp": f"g{i % 3}"},
                requests={"cpu": "200m"},
                node_name="node-1",
                phase="Running",
            )
        )


def _wait_health(front, state, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got, _ = front._shards_health()
        if got == state:
            return True
        time.sleep(0.1)
    return False


def _fleet(env_extra=None):
    front = AdmissionFront(N_SHARDS)
    env = {**os.environ, "KT_SHARD_QUIET": "1", "KT_LOCK_ASSERT": "0"}
    env.update(env_extra or {})
    sup = ShardSupervisor(
        front, use_device=False, restart_backoff=0.3, env=env
    )
    sup.start(ready_timeout=180.0)
    return front, sup


def _lanes_active(front, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(
            getattr(front.shards[s], "_shm_active", False)
            and getattr(front.shards[s], "shm_lane", None) is not None
            for s in range(front.n_shards)
        ):
            return True
        time.sleep(0.05)
    return False


def test_worker_crash_restarts_on_fresh_segment_no_shm_leak():
    front, sup = _fleet()
    try:
        _seed(front)
        assert front.drain(60.0)
        assert _lanes_active(front), "event plane never went live"
        victim = 0
        old_name = front.shards[victim].shm_lane.writer.name
        os.kill(sup.shard_proc(victim).pid, signal.SIGKILL)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if sup.restart_counts()[victim] >= 1:
                break
            time.sleep(0.1)
        assert sup.restart_counts()[victim] >= 1, "monitor never restarted"
        assert _wait_health(front, "ok", timeout=120.0)
        # the replacement worker must ride a FRESH segment (the ring is
        # die-as-a-unit: a restarted reader never resumes a stale ring)
        assert _lanes_active(front), "lane not re-promoted after restart"
        new_name = front.shards[victim].shm_lane.writer.name
        assert new_name != old_name
        # the dead incarnation's segment is gone from /dev/shm already
        assert not os.path.exists(os.path.join("/dev/shm", old_name))
        front.store.update_pod(
            make_pod("p0", labels={"grp": "g0"}, requests={"cpu": "300m"},
                     node_name="node-1", phase="Running")
        )
        assert front.drain(60.0)
    finally:
        sup.stop()
        front.stop()
    leftovers = [
        n for n in os.listdir("/dev/shm") if n.startswith(f"kt_evt_{os.getpid()}_")
    ] if os.path.isdir("/dev/shm") else []
    assert not leftovers, f"leaked segments after stop: {leftovers}"


def test_capability_masked_peer_falls_back_to_pickle_equivalently():
    from kube_throttler_tpu_torch.version import advertised_capabilities

    masked = ",".join(sorted(advertised_capabilities() - {"evt-shm"}))
    front, sup = _fleet(env_extra={"KT_PROTO_CAPS_MASK": masked})
    try:
        _seed(front)
        for i in range(12):  # churn so evt batches actually flow
            front.store.update_pod(
                make_pod(f"p{i}", labels={"grp": f"g{i % 3}"},
                         requests={"cpu": f"{(i % 8 + 1) * 100}m"},
                         node_name="node-1", phase="Running")
            )
        assert front.drain(60.0)
        time.sleep(0.5)
        for sid in range(front.n_shards):
            handle = front.shards[sid]
            assert not getattr(handle, "_shm_active", False), (
                f"shard {sid}: lane promoted despite masked evt-shm"
            )
            assert getattr(handle, "shm_fallback_batches", 0) > 0, (
                f"shard {sid}: no evt batches took the pickle fallback"
            )
        # fallback path is verdict-equivalent to a single-process oracle
        oracle_store = Store()
        oracle_store.create_namespace(Namespace("default"))
        for thr in front.store.list_throttles():
            oracle_store.create_throttle(thr)
        for pod in front.store.list_pods():
            oracle_store.create_pod(pod)
        oracle = H.build_plugin(oracle_store)
        oracle.run_pending_once()
        for pod in oracle_store.list_pods():
            got, want = front.pre_filter(pod), oracle.pre_filter(pod)
            assert got.code == want.code, (pod.key, got.reasons, want.reasons)
    finally:
        sup.stop()
        front.stop()


def test_sweep_segments_removes_only_our_prefix():
    w1 = ShmRingWriter(name=f"kt_evt_swp_{os.getpid()}_a")
    w2 = ShmRingWriter(name=f"kt_other_{os.getpid()}_b")
    try:
        # simulate a creator killed before cleanup: nobody unlinks w1
        w1.close(unlink=False)
        removed = sweep_segments(f"kt_evt_swp_{os.getpid()}_")
        assert f"kt_evt_swp_{os.getpid()}_a" in removed
        assert not os.path.exists(f"/dev/shm/kt_evt_swp_{os.getpid()}_a")
        assert os.path.exists(f"/dev/shm/kt_other_{os.getpid()}_b")
    finally:
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(w1._shm._name, "shared_memory")
        except Exception:
            pass
        w2.close(unlink=True)
