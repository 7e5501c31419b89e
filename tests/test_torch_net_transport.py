"""Cross-host TCP shard transport: framing faults, reconnect/backoff,
per-op deadlines, epoch fencing over the wire, and transport
equivalence (TCP ≡ socketpair ≡ single-process).

The in-process harness here runs the REAL wire stack — ``serve_tcp``
accept loops against :class:`ShardCore`, dialed by
:class:`TcpShardClient` over loopback — with no subprocesses, so every
failure path (torn frame, partition, refused dial, flapping link,
stale epoch) is deterministic under a seeded :class:`FaultPlan`. The
subprocess fleet is covered by the chaos smoke at the bottom (one
small ``tools/netchaostest.py`` case; the full matrix is
``make net-chaos``).
"""

from __future__ import annotations

import io
import pickle
import socket
import threading
import time

import pytest

import tools.harness_torch as H
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.faults.plan import FaultPlan
from kube_throttler_tpu_torch.sharding.front import AdmissionFront
from kube_throttler_tpu_torch.sharding.ipc import (
    _LEN,
    MAX_FRAME,
    FencedError,
    ShardClient,
    ShardUnavailable,
    TcpShardClient,
    read_frame,
    send_frame,
)
from kube_throttler_tpu_torch.sharding.worker import ShardCore, serve, serve_tcp
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def wait_until(pred, timeout=10.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def start_tcp_worker(core):
    """Listen on an ephemeral loopback port and serve the core — the
    in-process analog of ``kube-throttler-shard --listen``."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    threading.Thread(
        target=serve_tcp, args=(core, srv),
        name=f"test-shard{core.shard_id}-accept", daemon=True,
    ).start()
    return srv, port


class WorkerRig:
    """One in-process ShardCore behind a real TCP listener, plus a
    client factory that tears everything down in reverse order."""

    def __init__(self, shard_id=0, n_shards=1, prepare_ttl=30.0):
        self.core = ShardCore(shard_id, n_shards, use_device=False,
                              prepare_ttl=prepare_ttl)
        self.srv, self.port = start_tcp_worker(self.core)
        self.clients = []

    def client(self, **kw):
        kw.setdefault("connect_timeout", 2.0)
        c = TcpShardClient(self.core.shard_id, "127.0.0.1", self.port, **kw)
        self.clients.append(c)
        return c

    def close(self):
        for c in self.clients:
            c.close()
        self.srv.close()
        self.core.stop()


@pytest.fixture
def rig():
    r = WorkerRig()
    try:
        yield r
    finally:
        r.close()


# --------------------------------------------------------------------------
# framing-layer fault sites (net.*) — unit level, socketpair
# --------------------------------------------------------------------------


class TestFramingFaults:
    def test_torn_frame_surfaces_as_eof(self):
        """net.send.torn_frame writes only a prefix and raises; the peer
        must see a clean EOF, never a partial frame."""
        a, b = socket.socketpair()
        try:
            plan = FaultPlan(seed=0).rule("net.send.torn_frame", mode="torn",
                                          times=1)
            lock = threading.Lock()
            with pytest.raises(OSError, match="torn frame"):
                send_frame(a, lock, "evt", 1, ["x" * 64], faults=plan)
            assert plan.fired("net.send.torn_frame") == 1
            a.close()  # the sender's lane dies with the torn write
            assert read_frame(b.makefile("rb")) is None
        finally:
            b.close()

    def test_corrupt_payload_surfaces_as_eof(self):
        """A tear can leave the stream mid-frame: the bytes after the
        tear parse as a length + garbage payload. read_frame must treat
        undecodable bytes as EOF (framing lost), not raise."""
        a, b = socket.socketpair()
        try:
            garbage = b"\x00\x01\x02" * 11
            a.sendall(_LEN.pack(len(garbage)) + garbage)
            assert read_frame(b.makefile("rb")) is None
        finally:
            a.close()
            b.close()

    def test_partition_blackholes_the_send(self):
        """net.partition raises without writing a byte — an asymmetric
        blackhole, not a tear."""
        a, b = socket.socketpair()
        try:
            plan = FaultPlan(seed=0).rule("net.partition", mode="error",
                                          times=1)
            with pytest.raises(OSError, match="partition"):
                send_frame(a, threading.Lock(), "req", 1, ("ping", None),
                           faults=plan)
            b.settimeout(0.05)
            with pytest.raises((socket.timeout, TimeoutError)):
                b.recv(1)
        finally:
            a.close()
            b.close()

    def test_recv_stall_delays_delivery(self):
        """net.recv.stall sleeps the reader — the slow-link shape the
        per-op deadlines exist for. The frame still arrives intact."""
        a, b = socket.socketpair()
        try:
            send_frame(a, threading.Lock(), "res", 9, (True, "pong"), epoch=4)
            plan = FaultPlan(seed=0).rule("net.recv.stall", mode="delay",
                                          times=1, delay=0.25)
            t0 = time.monotonic()
            frame = read_frame(b.makefile("rb"), faults=plan)
            assert time.monotonic() - t0 >= 0.25
            assert frame == ("res", 9, (True, "pong"), 4)
        finally:
            a.close()
            b.close()


# --------------------------------------------------------------------------
# TcpShardClient against a live in-process worker
# --------------------------------------------------------------------------


class TestTcpClient:
    def test_rpc_roundtrip_and_push_subscription(self, rig):
        pushes = []
        client = rig.client(on_push=lambda sid, items: pushes.append((sid, items)))
        wait_until(lambda: client.alive, msg="client up")
        assert client.request("ping")["shard"] == 0
        # lane 0's sub frame nominated it as the push stream
        wait_until(lambda: rig.core.push is not None, msg="sub bound")
        rig.core.push([("Throttle", "marker")])
        wait_until(lambda: pushes, msg="push delivered")
        assert pushes[0] == (0, [("Throttle", "marker")])

    def test_per_op_deadline_fires_and_counts(self, rig):
        client = rig.client(deadlines={"ping": 0.2})
        wait_until(lambda: client.alive, msg="client up")

        orig = rig.core._rpc_ping

        def slow(payload):
            time.sleep(0.8)
            return orig(payload)

        rig.core._rpc_ping = slow
        try:
            with pytest.raises(ShardUnavailable, match="within 0.2s"):
                client.request("ping")
            assert client.deadline_exceeded == 1
            # the link itself is fine: the lane survives a deadline miss
            assert client.alive
        finally:
            rig.core._rpc_ping = orig
        assert client.request("stats")["shard"] == 0

    def test_reconnect_after_drop_fires_on_up(self, rig):
        down, up = threading.Event(), threading.Event()
        client = rig.client(pool_size=1, on_down=lambda sid: down.set(),
                            on_up=lambda sid: up.set())
        wait_until(lambda: client.alive, msg="client up")
        plan = FaultPlan(seed=0).rule("net.send.torn_frame", mode="torn",
                                      times=1)
        client.faults = plan
        with pytest.raises(ShardUnavailable):
            client.request("ping")
        assert down.wait(5.0), "on_down never fired"
        assert up.wait(5.0), "on_up (the resync trigger) never fired"
        wait_until(lambda: client.alive, msg="reconnect")
        assert client.reconnects == 1
        assert client.request("ping")["shard"] == 0

    def test_connect_refused_is_retried_through_backoff(self, rig):
        plan = FaultPlan(seed=0).rule("net.connect.refused", mode="error",
                                      times=2)
        client = rig.client(faults=plan)
        wait_until(lambda: client.alive, timeout=15.0,
                   msg="client up after refused dials")
        assert plan.fired("net.connect.refused") == 2
        assert client.reconnects == 0  # first establishment, not a heal

    def test_reconnect_storm_converges(self, rig):
        """Every fresh connection dies at birth (flapping link): the
        jittered backoff must keep dialing through to the heal."""
        up = threading.Event()
        client = rig.client(pool_size=1, on_up=lambda sid: up.set())
        wait_until(lambda: client.alive, msg="client up")
        plan = (
            FaultPlan(seed=1)
            .rule("net.send.torn_frame", mode="torn", times=1)
            .rule("net.reconnect.storm", mode="error", times=2)
        )
        client.faults = plan
        with pytest.raises(ShardUnavailable):
            client.request("ping")
        assert up.wait(15.0), "client never healed through the storm"
        assert plan.fired("net.reconnect.storm") == 2
        assert client.reconnects == 1
        assert client.outage_seconds() > 0.0


# --------------------------------------------------------------------------
# epoch fencing over the wire (the acceptance pin)
# --------------------------------------------------------------------------


class TestWireFencing:
    def test_stale_epoch_request_is_fenced_over_tcp(self, rig):
        """A front whose epoch is behind the worker's max-seen epoch is
        a peer from the past (healed after missing a resync): its RPCs
        must be REFUSED with the wire-level 409, not answered from
        untrusted state."""
        client = rig.client()
        wait_until(lambda: client.alive, msg="client up")
        assert client.request("ping")["shard"] == 0  # epoch 1 accepted
        # another front resynced this worker at a higher epoch while we
        # were partitioned away
        assert rig.core.observe_epoch(5)
        with pytest.raises(FencedError, match="stale epoch 1 < 5"):
            client.request("ping")
        assert rig.core._fenced_counts()["reqs"] == 1
        # the heal path: resync bumps the front's epoch past the fence
        while client.epoch < 5:
            client.bump_epoch()
        assert client.request("ping")["shard"] == 0
        assert client.request("stats")["wire_epoch"] == 5

    def test_stale_evt_batch_is_dropped(self, rig):
        """Stale-epoch event batches (bytes that sat in a kernel buffer
        across a heal) must not touch worker state."""
        client = rig.client()
        wait_until(lambda: client.alive, msg="client up")
        assert rig.core.observe_epoch(3)
        pod = make_pod("stale", labels={"grp": "g0"}, requests={"cpu": "1"})
        client.enqueue_ops([("upsert", "Pod", pod)])
        wait_until(lambda: rig.core._fenced_counts()["events"] >= 1,
                   msg="evt batch fenced")
        assert rig.core.store.list_pods() == []

    def test_stale_push_is_dropped_client_side(self, rig):
        """Pushes stamped with a pre-resync epoch are a healed worker
        replaying its pre-partition view — the front must drop them and
        let the resync re-push carry the truth."""
        pushes = []
        client = rig.client(on_push=lambda sid, items: pushes.append(items))
        wait_until(lambda: client.alive, msg="client up")
        wait_until(lambda: rig.core.push is not None, msg="sub bound")
        client.bump_epoch()  # front is at 2; the worker still pushes at 1
        rig.core.push([("Throttle", "stale-view")])
        wait_until(lambda: client.fenced_pushes >= 1, msg="push fenced")
        assert pushes == []


    def test_stale_sub_cannot_steal_the_push_stream(self, rig):
        """A partitioned-then-healed (not yet resynced) peer's ``sub``
        is a frame from the past: it must be counted fenced AND must not
        rebind the worker's push stream — otherwise every flip would
        stream to a connection the fencing contract says not to trust
        until the next resync."""
        pushes = []
        client = rig.client(on_push=lambda sid, items: pushes.append(items))
        wait_until(lambda: client.alive, msg="client up")
        wait_until(lambda: rig.core.push is not None, msg="sub bound")
        # the fleet moved on while some peer was partitioned away
        assert rig.core.observe_epoch(4)
        while client.epoch < 4:
            client.bump_epoch()
        stale = socket.create_connection(("127.0.0.1", rig.port), timeout=2.0)
        try:
            send_frame(stale, threading.Lock(), "sub", 0, None, epoch=2)
            wait_until(lambda: rig.core._fenced_counts()["reqs"] >= 1,
                       msg="stale sub fenced")
            rig.core.push([("Throttle", "truth")])
            wait_until(lambda: pushes, msg="push still rides the primary")
            assert pushes[0] == [("Throttle", "truth")]
        finally:
            stale.close()


# --------------------------------------------------------------------------
# frame auth — the pickle trust boundary (cross-host mode)
# --------------------------------------------------------------------------


_EVIL_CALLS: list = []


def _evil_sink(marker):
    _EVIL_CALLS.append(marker)


class _EvilPayload:
    """The RCE shape: unpickling this executes attacker-chosen code
    (a module-level callable, so it pickles by reference and fires in
    the reader's process)."""

    def __reduce__(self):
        return (_evil_sink, ("executed",))


class TestFrameAuth:
    KEY = b"test-fleet-psk"

    def test_authenticated_roundtrip(self):
        a, b = socket.socketpair()
        try:
            send_frame(a, threading.Lock(), "res", 7, (True, "pong"),
                       epoch=3, key=self.KEY)
            frame = read_frame(b.makefile("rb"), key=self.KEY)
            assert frame == ("res", 7, (True, "pong"), 3)
        finally:
            a.close()
            b.close()

    def test_unauthenticated_frame_never_reaches_the_deserializer(self):
        """A crafted pickle from a peer WITHOUT the key must die at the
        MAC check — pickle.loads on it would be arbitrary code
        execution in the worker."""
        del _EVIL_CALLS[:]
        payload = pickle.dumps(_EvilPayload(), protocol=5)
        raw = _LEN.pack(len(payload)) + payload
        assert read_frame(io.BytesIO(raw), key=self.KEY) is None
        assert _EVIL_CALLS == []  # the deserializer never ran
        # sanity check on the threat model: the SAME bytes execute on a
        # keyless reader — which is exactly why a non-loopback --listen
        # refuses to start without a key
        read_frame(io.BytesIO(raw))
        assert _EVIL_CALLS == ["executed"]

    def test_wrong_key_is_a_torn_stream(self):
        a, b = socket.socketpair()
        try:
            send_frame(a, threading.Lock(), "req", 1, ("ping", None),
                       key=b"some-other-key")
            assert read_frame(b.makefile("rb"), key=self.KEY) is None
        finally:
            a.close()
            b.close()

    def test_keyed_frame_is_noise_to_a_keyless_reader(self):
        a, b = socket.socketpair()
        try:
            send_frame(a, threading.Lock(), "req", 1, ("ping", None),
                       key=self.KEY)
            assert read_frame(b.makefile("rb")) is None
        finally:
            a.close()
            b.close()

    def test_keyed_fleet_end_to_end(self):
        """A keyed worker serves keyed clients; a keyless client can
        connect but never speak — its frames fail the MAC before the
        deserializer and the lane dies."""
        core = ShardCore(0, 1, use_device=False)
        srv = socket.create_server(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        threading.Thread(
            target=serve_tcp, args=(core, srv),
            kwargs={"auth_key": self.KEY},
            name="test-keyed-accept", daemon=True,
        ).start()
        client = keyless = None
        try:
            pushes = []
            client = TcpShardClient(
                0, "127.0.0.1", port, auth_key=self.KEY,
                connect_timeout=2.0,
                on_push=lambda sid, items: pushes.append(items),
            )
            wait_until(lambda: client.alive, msg="keyed client up")
            assert client.request("ping")["shard"] == 0
            wait_until(lambda: core.push is not None, msg="sub bound")
            core.push([("Throttle", "keyed")])
            wait_until(lambda: pushes, msg="keyed push delivered")
            keyless = TcpShardClient(
                0, "127.0.0.1", port, connect_timeout=2.0,
                default_deadline=0.5,
            )
            with pytest.raises(ShardUnavailable):
                keyless.request("ping")
        finally:
            if client is not None:
                client.close()
            if keyless is not None:
                keyless.close()
            srv.close()
            core.stop()

    def test_worker_refuses_keyless_nonloopback_listen(self, monkeypatch):
        monkeypatch.delenv("KT_SHARD_AUTH_KEY", raising=False)
        from kube_throttler_tpu_torch.sharding import worker as worker_mod

        with pytest.raises(SystemExit):
            worker_mod.main([
                "--shard-id", "0", "--shards", "1",
                "--listen", "0.0.0.0:0", "--no-device",
            ])
        assert worker_mod.listen_requires_auth("0.0.0.0")
        assert worker_mod.listen_requires_auth("10.0.0.7")
        assert not worker_mod.listen_requires_auth("127.0.0.1")
        assert not worker_mod.listen_requires_auth("localhost")
        assert not worker_mod.listen_requires_auth("")


# --------------------------------------------------------------------------
# framing hygiene + sender resilience
# --------------------------------------------------------------------------


class TestFramingHygiene:
    def test_bogus_length_header_is_rejected_before_the_payload_read(self):
        """A misaligned tear (or garbage) parses as a length up to
        4 GiB; read_frame must reject it as a torn stream BEFORE
        buffering toward it — no reader stall, no allocation spike."""
        buf = io.BytesIO(_LEN.pack(MAX_FRAME + 1) + b"x" * 64)
        assert read_frame(buf) is None
        assert buf.tell() == _LEN.size  # not one payload byte was read

    def test_max_frame_boundary_still_decodes(self):
        payload = pickle.dumps(("evt", 0, ["ok"], 1), protocol=5)
        buf = io.BytesIO(_LEN.pack(len(payload)) + payload)
        assert read_frame(buf) == ("evt", 0, ["ok"], 1)

    def test_sender_unexpected_error_degrades_fail_safe(self, rig, monkeypatch):
        """A non-OSError escaping the TCP send path must tear down the
        primary lane (on_down fires, the front degrades fail-safe, heal
        resyncs) and the sender must SURVIVE to drain after the heal —
        never a live-looking handle with events queued behind a dead
        thread."""
        import kube_throttler_tpu_torch.sharding.ipc as ipc_mod

        down, up = threading.Event(), threading.Event()
        client = rig.client(pool_size=1, on_down=lambda sid: down.set(),
                            on_up=lambda sid: up.set())
        wait_until(lambda: client.alive, msg="client up")
        real = ipc_mod.send_frame
        fired = threading.Event()

        def boom(sock, lock, mtype, rid, body, **kw):
            if mtype == "evt" and not fired.is_set():
                fired.set()
                raise ValueError("injected non-OSError sender bug")
            return real(sock, lock, mtype, rid, body, **kw)

        monkeypatch.setattr(ipc_mod, "send_frame", boom)
        pod = make_pod("p0", labels={"grp": "g"}, requests={"cpu": "1"})
        client.enqueue_ops([("upsert", "Pod", pod)])
        assert down.wait(5.0), "sender death never degraded the shard"
        assert up.wait(10.0), "sender death was permanent (no heal)"
        wait_until(lambda: client.alive, msg="reconnect after sender bug")
        assert client.is_dirty()  # the lost batch is a resync's problem
        client.enqueue_ops([("upsert", "Pod", pod)])
        wait_until(lambda: client.events_sent >= 1,
                   msg="sender survived and drains after the heal")


# --------------------------------------------------------------------------
# transport equivalence: TCP ≡ socketpair ≡ single-process
# --------------------------------------------------------------------------


def build_tcp_front(n_shards, rpc_deadlines=None, prepare_ttl=30.0):
    """An AdmissionFront over in-process cores behind REAL TCP
    listeners — the full wire stack, deterministic teardown."""
    front = AdmissionFront(n_shards, rpc_deadlines=rpc_deadlines)
    cores, servers = [], []
    for i in range(n_shards):
        core = ShardCore(i, n_shards, use_device=False,
                         prepare_ttl=prepare_ttl)
        srv, port = start_tcp_worker(core)
        cores.append(core)
        servers.append(srv)
        front.attach_shard(
            i,
            TcpShardClient(i, "127.0.0.1", port,
                           on_push=front.apply_status_push,
                           on_up=front.resync_shard, connect_timeout=2.0),
        )
    wait_until(lambda: all(h.alive for h in front.shards.values()),
               msg="tcp fleet up")
    return front, cores, servers


def teardown_tcp_front(front, cores, servers):
    front.stop()  # closes the TcpShardClient handles
    for srv in servers:
        srv.close()
    for core in cores:
        core.stop()


def build_socketpair_front(n_shards):
    """An AdmissionFront over ShardClient socketpairs served by
    in-process cores — the child-process transport without the child."""
    front = AdmissionFront(n_shards)
    cores = []
    for i in range(n_shards):
        core = ShardCore(i, n_shards, use_device=False)
        cores.append(core)
        a, b = socket.socketpair()
        threading.Thread(target=serve, args=(core, b),
                         name=f"test-shard{i}-serve", daemon=True).start()
        front.attach_shard(
            i, ShardClient(i, a, on_push=front.apply_status_push)
        )
    return front, cores


def settle(front, timeout=60.0):
    assert front.drain(timeout=timeout)
    time.sleep(0.3)  # push loops flush on their own cadence


@pytest.mark.parametrize("seed", [0, 3])
def test_transport_equivalence(seed):
    """Identical populations through (a) single-process oracle, (b) a
    2-shard socketpair fleet, (c) a 2-shard TCP fleet: every pod's
    verdict must agree on code + normalized reasons — the wire must be
    invisible to admission semantics."""
    from test_torch_sharding import apply_population, seeded_population

    ops = seeded_population(seed)
    oracle_store = Store()
    apply_population(oracle_store, ops)
    oracle = H.build_plugin(oracle_store)
    oracle.run_pending_once()
    sp_front, sp_cores = build_socketpair_front(2)
    tcp_front, tcp_cores, tcp_servers = build_tcp_front(2)
    try:
        for front in (sp_front, tcp_front):
            apply_population(front.store, ops)
            settle(front)
        for pod in oracle_store.list_pods():
            want = oracle.pre_filter(pod)
            for label, front in (("socketpair", sp_front), ("tcp", tcp_front)):
                got = front.pre_filter(pod)
                assert got.code == want.code, (label, pod.key, got.reasons)
                assert H.normalized_reasons(got.reasons) == H.normalized_reasons(
                    want.reasons
                ), (label, pod.key)
    finally:
        oracle.stop()
        for core in sp_cores:
            core.stop()
        sp_front.stop()
        teardown_tcp_front(tcp_front, tcp_cores, tcp_servers)


def test_tcp_reservations_match_single_process():
    """Two-phase reserve over real TCP changes downstream verdicts
    exactly like the oracle's local reserve; unreserve restores them."""
    oracle_store = Store()
    tcp_front, tcp_cores, tcp_servers = build_tcp_front(2)
    try:
        for store in (tcp_front.store, oracle_store):
            store.create_namespace(Namespace("default"))
            for i in range(4):
                store.create_throttle(H.make_throttle(i))
        oracle = H.build_plugin(oracle_store)
        oracle.run_pending_once()
        settle(tcp_front)
        held = [
            make_pod(f"r{i}", labels={"grp": f"g{i % 4}"},
                     requests={"cpu": "600m"})
            for i in range(6)
        ]
        for pod in held:
            assert tcp_front.reserve(pod).is_success()
            assert oracle.reserve(pod).is_success()
        probe = make_pod("probe", labels={"grp": "g2"}, requests={"cpu": "600m"})
        got, want = tcp_front.pre_filter(probe), oracle.pre_filter(probe)
        assert got.code == want.code
        assert H.normalized_reasons(got.reasons) == H.normalized_reasons(
            want.reasons
        )
        for pod in held:
            tcp_front.unreserve(pod)
            oracle.unreserve(pod)
        got2, want2 = tcp_front.pre_filter(probe), oracle.pre_filter(probe)
        assert got2.code == want2.code
        oracle.stop()
    finally:
        teardown_tcp_front(tcp_front, tcp_cores, tcp_servers)


# --------------------------------------------------------------------------
# prepare-timeout regression: deadline fires ⇒ abort, never an orphan
# --------------------------------------------------------------------------


def _slow_after(core, op, extra=1.0):
    """Wrap an RPC so it does its real work, then outlives the caller's
    deadline before answering — the 'prepare LANDED, the answer did
    not' shape front.reserve's abort-to-all-targets exists for."""
    orig = getattr(core, f"_rpc_{op}")

    def slow(payload):
        result = orig(payload)
        time.sleep(extra)
        return result

    setattr(core, f"_rpc_{op}", slow)
    return orig


class TestPrepareDeadlineAbort:
    def _population(self, store):
        store.create_namespace(Namespace("default"))
        for i in range(4):
            store.create_throttle(H.make_throttle(i))

    def _assert_no_orphans(self, front):
        def clean():
            for sid in range(front.n_shards):
                stats = front.shards[sid].request("stats")
                if stats["pending_txns"] or stats["reservations"]:
                    return False
                audit = front.shards[sid].request("reshard_audit")
                if audit["orphan_reservations"]:
                    return False
            return True

        wait_until(clean, timeout=10.0,
                   msg="aborted txn fully released on every shard")

    def test_reserve_prepare_timeout_aborts_everywhere(self):
        front, cores, servers = build_tcp_front(
            2, rpc_deadlines={"reserve_prepare": 0.3}
        )
        try:
            self._population(front.store)
            settle(front)
            pod = make_pod("slowpod", labels={"grp": "g1"},
                           requests={"cpu": "100m"})
            origs = [_slow_after(core, "reserve_prepare") for core in cores]
            aborts_before = front.two_phase_aborts
            status = front.reserve(pod)
            assert not status.is_success()
            assert any("within 0.3s" in r for r in status.reasons), status.reasons
            assert front.two_phase_aborts == aborts_before + 1
            assert any(h.deadline_exceeded >= 1 for h in front.shards.values())
            self._assert_no_orphans(front)
            # the fleet is not wedged: a normal reserve goes through
            for core, orig in zip(cores, origs):
                core._rpc_reserve_prepare = orig
            assert front.reserve(pod).is_success()
            front.unreserve(pod)
        finally:
            teardown_tcp_front(front, cores, servers)

    def test_gang_prepare_timeout_aborts_everywhere(self):
        front, cores, servers = build_tcp_front(
            2, rpc_deadlines={"gang_prepare": 0.3}
        )
        try:
            self._population(front.store)
            settle(front)
            members = [
                make_pod(f"gm{i}", labels={"grp": "g2"},
                         requests={"cpu": "100m"}, group="job1", group_size=3)
                for i in range(3)
            ]
            origs = [_slow_after(core, "gang_prepare") for core in cores]
            status = front.reserve_gang("default/job1", members)
            assert not status.is_success()
            self._assert_no_orphans(front)
            wait_until(
                lambda: all(
                    front.shards[sid].request("gang_groups") == []
                    for sid in range(2)
                ),
                msg="gang ledger record released",
            )
            for core, orig in zip(cores, origs):
                core._rpc_gang_prepare = orig
            assert front.reserve_gang("default/job1", members).is_success()
            front.unreserve_gang("default/job1")
        finally:
            teardown_tcp_front(front, cores, servers)


# --------------------------------------------------------------------------
# mid-reshard partition over TCP: abort-back-to-source, then retry lands
# --------------------------------------------------------------------------


def test_reshard_partition_aborts_back_to_source_over_tcp():
    """A destination partitioned mid-handoff must abort the handoff back
    to the source (the abort path, over real TCP); once the link
    heals the coordinator's retry completes the retarget with
    oracle-equivalent verdicts and zero orphan reservations."""
    from kube_throttler_tpu_torch.sharding.reshard import ReshardCoordinator
    from kube_throttler_tpu_torch.sharding.ring import HashRing

    front, cores, servers = build_tcp_front(2)
    try:
        front.store.create_namespace(Namespace("default"))
        for i in range(8):
            front.store.create_throttle(H.make_throttle(i))
        pods = [
            make_pod(f"p{i}", labels={"grp": f"g{i % 8}"},
                     requests={"cpu": "100m"})
            for i in range(48)
        ]
        for pod in pods:
            front.store.create_pod(pod)
        settle(front)
        for pod in pods[:6]:
            assert front.reserve(pod).is_success()

        # attach the destination shard over TCP, then blackhole its link
        core = ShardCore(2, 3, use_device=False)
        srv, port = start_tcp_worker(core)
        cores.append(core)
        servers.append(srv)
        handle = TcpShardClient(2, "127.0.0.1", port,
                                on_push=front.apply_status_push,
                                on_up=front.resync_shard, connect_timeout=2.0)
        front.attach_shard(2, handle)
        wait_until(lambda: handle.alive, msg="shard 2 up")
        front.resync_shard(2)
        front.n_shards = 3

        plan = FaultPlan(seed=0).rule("net.partition", mode="error", times=6)
        handle.faults = plan
        report = ReshardCoordinator(front).rescale(HashRing(3), deadline_s=60.0)
        assert plan.fired("net.partition") >= 1, "partition never fired"
        assert report["aborts"] >= 1, (
            "partitioned destination never aborted a handoff back to source"
        )
        assert front.drain(60.0)
        time.sleep(0.4)

        # oracle equivalence + clean audits after the heal-and-retry
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
        oracle.stop()
        for sid in range(3):
            audit = front.shards[sid].request("reshard_audit")
            assert not audit["orphan_reservations"], (sid, audit)
            assert not audit["pending_handoffs"], (sid, audit)
    finally:
        teardown_tcp_front(front, cores, servers)


# --------------------------------------------------------------------------
# subprocess fleet smoke (the full matrix is `make net-chaos`)
# --------------------------------------------------------------------------


def test_net_chaos_smoke_torn_frame():
    """One small netchaostest case through a LIVE 2-worker TCP fleet
    (real processes, real loopback sockets): a torn frame mid-churn,
    then the full recovery contract — no supervisor restart, zero wrong
    verdicts, zero lost flips, zero orphan reservations."""
    from tools.netchaostest_torch import run_case

    result = run_case("net.send.torn_frame", "torn", seed=0,
                      rule_kwargs={"times": 2}, n_pods=48, rounds=3)
    assert result["ok"]
    assert result["fired"] >= 1
    assert result["reconnects"] >= 1
