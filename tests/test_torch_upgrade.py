"""Rolling-upgrade safety: the version/capability handshake
(version.py ↔ sharding/ipc.py ↔ sharding/worker.py), the durable
FORMAT_REGISTRY contract (journal/snapshot refusals by name, never
silent corruption-skips), the replication protocol stamp, the
supervisor's crash-loop backoff guard, the build_info exposition, and
the committed pre-bump journal fixture's bit-identical replay.

The live subprocess roll (front-first / worker-first orders, mid-roll
SIGKILL, incompatible-major refusal under storm load) is
``tools/upgradetest.py`` (``make upgrade-test``; smoke tier in
hack/ci.sh) — this file covers the deterministic in-process layers.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import pytest

import tools.harness_torch as H
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.journal import (
    JournalFormatError,
    attach,
)
from kube_throttler_tpu_torch.engine.replication import (
    PROTO_HEADER,
    ReplicationDiverged,
    ReplicationServer,
    ReplicationSource,
    SliceChunkSink,
    SliceChunkSource,
    StandbyReplicator,
)
from kube_throttler_tpu_torch.engine.snapshot import (
    SnapshotManager,
    SUPPORTED_SNAPSHOT_VERSIONS,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.metrics import Registry, register_build_metrics
from kube_throttler_tpu_torch.sharding.front import AdmissionFront
from kube_throttler_tpu_torch.sharding.ipc import VersionMismatch
from kube_throttler_tpu_torch.sharding.supervisor import ShardSupervisor
from kube_throttler_tpu_torch.version import (
    BUILD_ID,
    CAPABILITIES,
    FORMAT_REGISTRY,
    NegotiationError,
    PROTO_MAJOR,
    PROTO_VERSION,
    advertised_capabilities,
    local_hello,
    local_proto_version,
    min_reader_version,
    negotiate,
)
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

NS_OBJ = {
    "apiVersion": "v1",
    "kind": "Namespace",
    "metadata": {"name": "default", "uid": "uid-1"},
}


def _write_journal(path, lines):
    with open(path, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")


# --------------------------------------------------------------------------
# negotiation unit contract (version.py)
# --------------------------------------------------------------------------


class TestNegotiate:
    def test_minor_negotiates_down_caps_intersect(self):
        proto, caps = negotiate(
            (1, 3), {"a", "b", "c"}, [1, 1], ["b", "c", "d"]
        )
        assert proto == (1, 1)
        assert caps == frozenset({"b", "c"})

    def test_no_hello_is_the_zero_cap_baseline(self):
        proto, caps = negotiate((1, 2), CAPABILITIES, None, None)
        assert proto == (1, 0)
        assert caps == frozenset()

    def test_major_mismatch_refused(self):
        with pytest.raises(NegotiationError, match="incompatible protocol major"):
            negotiate((1, 1), CAPABILITIES, [2, 0], [])

    def test_malformed_hello_refused(self):
        with pytest.raises(NegotiationError, match="malformed"):
            negotiate((1, 1), CAPABILITIES, "banana", [])

    def test_non_string_caps_dropped(self):
        _, caps = negotiate((1, 1), {"x"}, [1, 1], ["x", 7, None])
        assert caps == frozenset({"x"})

    def test_env_caps_mask(self):
        assert advertised_capabilities({}) == CAPABILITIES
        assert advertised_capabilities({"KT_PROTO_CAPS_MASK": ""}) == frozenset()
        assert advertised_capabilities(
            {"KT_PROTO_CAPS_MASK": "evt-columnar"}
        ) == frozenset({"evt-columnar"})
        # unknown names mask to nothing extra — the intersection with
        # CAPABILITIES is what the hello carries
        assert advertised_capabilities(
            {"KT_PROTO_CAPS_MASK": "warp-drive"}
        ) == frozenset()

    def test_env_major_override(self):
        assert local_proto_version({}) == PROTO_VERSION
        assert local_proto_version({"KT_PROTO_MAJOR": "99"})[0] == 99
        # a non-integer override is ignored, never a crash
        assert local_proto_version({"KT_PROTO_MAJOR": "banana"}) == PROTO_VERSION

    def test_local_hello_shape(self):
        hello = local_hello({})
        assert hello["proto"] == [PROTO_MAJOR, PROTO_VERSION[1]]
        assert hello["caps"] == sorted(CAPABILITIES)
        assert hello["build"] == BUILD_ID

    def test_registry_covers_durable_formats(self):
        from kube_throttler_tpu_torch.engine.journal import _KNOWN_LINE_TYPES

        for ctype in _KNOWN_LINE_TYPES - {"ADDED", "MODIFIED", "DELETED"}:
            assert min_reader_version("journal", ctype) == 1, ctype
        for v in SUPPORTED_SNAPSHOT_VERSIONS:
            assert min_reader_version("snapshot", v) == 1, v
        assert min_reader_version("frame", "hello") == 1
        assert min_reader_version("frame", "warp") is None
        # durable rows only ever ADD — this count can grow, never shrink
        assert len(FORMAT_REGISTRY) >= 11


# --------------------------------------------------------------------------
# journal: unknown-but-versioned control lines refuse replay by name
# --------------------------------------------------------------------------


class TestJournalFormatRefusal:
    def test_unknown_control_line_stops_replay(self, tmp_path):
        path = str(tmp_path / "store.journal")
        _write_journal(path, [
            {"type": "EPOCH", "epoch": 1},
            {"type": "ADDED", "kind": "Namespace", "object": NS_OBJ},
            {"type": "QUORUM", "op": "begin", "minReader": "2.0"},
            {
                "type": "ADDED",
                "kind": "Namespace",
                "object": {
                    "apiVersion": "v1",
                    "kind": "Namespace",
                    "metadata": {"name": "late"},
                },
            },
        ])
        store = Store()
        j = attach(store, path)
        try:
            assert j.format_refused == 1
            assert "QUORUM" in j.format_refused_reason
            assert "2.0" in j.format_refused_reason  # the named demand
            # replay stopped AT the boundary: the prefix applied, the
            # suffix did not (skipping it could misapply semantics the
            # refused control line was meant to bracket)
            assert store.get_namespace("default") is not None
            assert store.get_namespace("late") is None
            state, detail = j.health_state()
            assert state == "down"
            assert "QUORUM" in detail["formatRefusedReason"]
            # accounted position still covers the whole file, so a later
            # (upgraded) attach replays from genesis, not mid-file
            assert j.position()[0] == os.path.getsize(path)
        finally:
            j.close()

    def test_corruption_still_skips_not_refuses(self, tmp_path):
        path = str(tmp_path / "store.journal")
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(
                {"type": "ADDED", "kind": "Namespace", "object": NS_OBJ}
            ) + "\n")
            f.write("this is not json\n")  # bit rot: skip and count
            # unknown uppercase type WITH an object payload is an event
            # from an unknown kind, not a control line: corruption-skip
            f.write(json.dumps({"type": "ZAPPED", "object": {"x": 1}}) + "\n")
            f.write(json.dumps(
                {
                    "type": "ADDED",
                    "kind": "Namespace",
                    "object": {
                        "apiVersion": "v1",
                        "kind": "Namespace",
                        "metadata": {"name": "after"},
                    },
                }
            ) + "\n")
        store = Store()
        j = attach(store, path)
        try:
            assert j.format_refused == 0
            assert j.replay_skipped == 2
            assert store.get_namespace("after") is not None
            assert j.health_state()[0] != "down"
        finally:
            j.close()

    def test_non_string_type_is_corruption_not_a_crash(self, tmp_path):
        path = str(tmp_path / "store.journal")
        _write_journal(path, [
            {"type": 5, "zap": 1},
            {"type": "ADDED", "kind": "Namespace", "object": NS_OBJ},
        ])
        store = Store()
        j = attach(store, path)
        try:
            assert j.format_refused == 0
            assert store.get_namespace("default") is not None
        finally:
            j.close()


class TestJournalPrebumpFixture:
    def test_prebump_journal_replays_bit_identically(self, tmp_path):
        """The committed pre-bump journal (every v1 line type: the three
        watch events plus EPOCH/GANG/PREEMPT control lines) must replay
        cleanly — zero skips, zero refusals — into the same store twice
        over, with the accounted (offset, sha) exactly the file's bytes.
        Re-keying or dropping a FORMAT_REGISTRY row breaks this forever."""
        import shutil

        fixture = os.path.join(FIXTURES, "journal-v1-prebump")
        with open(fixture, "rb") as f:
            raw = f.read()
        dumps = []
        for d in ("a", "b"):
            wdir = tmp_path / d
            wdir.mkdir()
            path = str(wdir / "store.journal")
            shutil.copy(fixture, path)
            store = Store()
            j = attach(store, path)
            try:
                assert j.format_refused == 0
                assert j.replay_skipped == 0 and j.torn_tails == 0
                assert j.last_epoch == 4
                assert j.gang_ops["default/gang-a"]["op"] == "commit"
                assert j.gang_ops["default/gang-a"]["members"] == ["default/p0"]
                assert j.preempt_ops["preempt-7"]["op"] == "commit"
                # the replayed state: p1 was preempted away, p0 moved nodes
                assert store.get_namespace("default") is not None
                assert store.get_throttle("default", "t0") is not None
                keys = {p.key for p in store.list_pods()}
                assert keys == {"default/p0"}
                assert store.get_pod("default", "p0").spec.node_name == "node-3"
                offset, sha = j.position()
                assert offset == len(raw)
                assert sha == hashlib.sha256(raw).hexdigest()
            finally:
                j.close()
            dumps.append(H.dump_store(store))
        assert dumps[0] == dumps[1]

    def test_prebump_pair_is_committed(self):
        # the PAIR the upgrade contract pins: one pre-bump snapshot, one
        # pre-bump journal, both under tests/fixtures/
        assert os.path.exists(os.path.join(FIXTURES, "snapshot-v1-prebump.ktsnap"))
        assert os.path.exists(os.path.join(FIXTURES, "journal-v1-prebump"))


# --------------------------------------------------------------------------
# replication: proto stamp + snapshot/control-line refusals (satellite:
# unsupported-snapshot bootstrap fails FAST with the version named)
# --------------------------------------------------------------------------


def _standby(tmp_path, name="standby"):
    sdir = tmp_path / name
    sdir.mkdir()
    store = Store()
    journal = attach(store, str(sdir / "store.journal"))
    rep = StandbyReplicator(
        store, journal, "http://127.0.0.1:1", poll_interval=0.02
    )
    return store, journal, rep


def _v99_snapshot_bytes():
    body = json.dumps({"objects": [], "rv": 1}).encode()
    header = json.dumps({
        "format": "kube-throttler-snapshot",
        "version": 99,
        "sha256": hashlib.sha256(body).hexdigest(),
        "length": len(body),
    }).encode()
    return header + b"\n" + body + b"\n"


class TestReplicationSkew:
    def test_bootstrap_unsupported_snapshot_fails_fast(self, tmp_path, monkeypatch):
        _, journal, rep = _standby(tmp_path)
        blob = _v99_snapshot_bytes()
        calls = []

        def fake_get(path):
            calls.append(path)
            return 200, blob, {PROTO_HEADER: "%d.%d" % local_proto_version()}

        monkeypatch.setattr(rep, "_get", fake_get)
        t0 = time.monotonic()
        try:
            assert rep.bootstrap(deadline_s=30.0) is False
            # deterministic refusal: ONE fetch, no retry-until-deadline
            # (every retry would fetch the same bytes and then report a
            # generic timeout instead of the named version)
            assert time.monotonic() - t0 < 5.0
            assert calls == ["/v1/replication/snapshot"]
            assert rep.format_refused == 1
            assert "unsupported snapshot version" in rep.format_refused_reason
            assert "99" in rep.format_refused_reason
            state, detail = rep.health_state()
            assert state == "down"
            assert "format refused" in detail["error"]
            assert "99" in detail["error"]
        finally:
            journal.close()

    def test_bootstrap_incompatible_proto_major_refused(self, tmp_path, monkeypatch):
        _, journal, rep = _standby(tmp_path)

        monkeypatch.setattr(
            rep, "_get", lambda path: (200, b"", {PROTO_HEADER: "99.0"})
        )
        try:
            assert rep.bootstrap(deadline_s=30.0) is False
            assert "incompatible major" in rep.format_refused_reason
            assert "99.0" in rep.format_refused_reason
            assert rep.health_state()[0] == "down"
        finally:
            journal.close()

    def test_poll_refuses_major_before_offset_advances(self, tmp_path, monkeypatch):
        _, journal, rep = _standby(tmp_path)
        line = json.dumps(
            {"type": "ADDED", "kind": "Namespace", "object": NS_OBJ}
        ).encode() + b"\n"
        monkeypatch.setattr(
            rep, "_get",
            lambda path: (200, line, {PROTO_HEADER: "99.0", "X-KT-Position": "64"}),
        )
        try:
            with pytest.raises(OSError, match="replication refused"):
                rep.poll_once()
            assert rep.consumed_offset() == 0  # nothing half-applied
            assert rep.format_refused >= 1
            assert rep.health_state()[0] == "down"
        finally:
            journal.close()

    def test_missing_or_malformed_stamp_is_baseline_not_refusal(self, tmp_path):
        _, journal, rep = _standby(tmp_path)
        try:
            assert rep._proto_refusal({}) is None
            assert rep._proto_refusal({PROTO_HEADER: "banana"}) is None
            assert rep._proto_refusal(
                {PROTO_HEADER: "%d.7" % PROTO_MAJOR}
            ) is None
            assert rep._proto_refusal({PROTO_HEADER: "99.0"}) is not None
        finally:
            journal.close()

    def test_unknown_control_line_in_stream_refused(self, tmp_path):
        _, journal, rep = _standby(tmp_path)
        data = (
            json.dumps({"type": "ADDED", "kind": "Namespace", "object": NS_OBJ})
            + "\n"
            + json.dumps({"type": "QUORUM", "op": "begin", "minReader": "2.0"})
            + "\n"
        ).encode()
        try:
            with pytest.raises(JournalFormatError):
                rep._apply_lines(data)
            assert "QUORUM" in rep.format_refused_reason
            assert rep.lines_skipped == 0  # refused, NOT corruption-skipped
            assert rep.health_state()[0] == "down"
        finally:
            journal.close()

    def test_replication_server_stamps_proto(self, tmp_path):
        ldir = tmp_path / "leader"
        ldir.mkdir()
        store = Store()
        journal = attach(store, str(ldir / "store.journal"))
        store.create_namespace(Namespace("default"))
        from kube_throttler_tpu_torch.engine.replication import FencingEpoch

        source = ReplicationSource(str(ldir), journal, FencingEpoch(str(ldir)))
        server = ReplicationServer(source)
        server.start()
        try:
            from http.client import HTTPConnection

            conn = HTTPConnection("127.0.0.1", server.port, timeout=5.0)
            conn.request("GET", "/v1/replication/status")
            resp = conn.getresponse()
            resp.read()
            stamp = resp.getheader(PROTO_HEADER)
            conn.close()
            assert stamp == "%d.%d" % local_proto_version()
        finally:
            server.stop()
            journal.close()

    def test_slice_stream_stamps_and_refuses_major(self):
        blob = b"x" * 5000
        source = SliceChunkSource(blob, max_chunk=2048)
        sink = SliceChunkSink()
        while not sink.done:
            sink.feed(source.chunk(sink.offset(), sink.sha_hex()))
        assert sink.payload() == blob
        # a chunk stamped with a foreign major aborts back to the source
        bad = source.chunk(0)
        bad["proto"] = [99, 0]
        with pytest.raises(ReplicationDiverged, match="incompatible major"):
            SliceChunkSink().feed(bad)
        # an UNSTAMPED chunk is the pre-versioning baseline: accepted
        old = source.chunk(0)
        del old["proto"]
        assert SliceChunkSink().feed(old) == 2048


# --------------------------------------------------------------------------
# supervisor crash-loop guard + build_info exposition
# --------------------------------------------------------------------------


class TestRestartBackoff:
    def _supervisor(self):
        front = AdmissionFront(2)
        return ShardSupervisor(front, use_device=False,
                               restart_backoff=0.25, restart_backoff_cap=4.0)

    def test_backoff_grows_and_resets(self):
        sup = self._supervisor()
        delays = [sup._restart_delay(0) for _ in range(6)]
        assert all(0.0 < d <= 4.0 for d in delays)
        # jittered-exponential: by the 5th consecutive death the delay
        # has left the base band; shard 1's pacing is independent
        assert max(delays) > 0.5
        assert delays[-1] >= delays[0]
        assert sup.backoff_seconds()[0] == delays[-1]
        assert sup.backoff_seconds()[1] == 0.0
        sup._reset_backoff(0)
        assert sup.backoff_seconds()[0] == 0.0
        # post-reset the guard restarts from the base band
        assert sup._restart_delay(0) <= 0.5

    def test_backoff_metric_exported(self):
        sup = self._supervisor()
        sup._restart_delay(1)
        registry = Registry()
        register_build_metrics(registry, role="front", front=sup.front)
        text = registry.exposition()
        assert "kube_throttler_shard_restart_backoff_seconds" in text
        line = next(
            ln for ln in text.splitlines()
            if ln.startswith("kube_throttler_shard_restart_backoff_seconds")
            and 'shard="1"' in ln
        )
        assert float(line.rsplit(" ", 1)[1]) > 0.0


class TestBuildInfo:
    def test_build_info_row_for_this_process(self):
        registry = Registry()
        register_build_metrics(registry, role="worker")
        text = registry.exposition()
        assert "kube_throttler_build_info" in text
        line = next(
            ln for ln in text.splitlines()
            if ln.startswith("kube_throttler_build_info")
        )
        assert BUILD_ID in line
        assert 'role="worker"' in line
        assert "%d.%d" % local_proto_version() in line

    def test_per_shard_rows_and_mismatch_counter(self):
        from types import SimpleNamespace

        handle = SimpleNamespace(
            negotiated_proto=(1, 0), negotiated_caps=frozenset({"build-info"}),
            peer_build="kube-throttler-tpu/old", version_mismatches=3,
        )
        front = SimpleNamespace(
            n_shards=1, shards={0: handle}, supervisor_ref=None
        )
        registry = Registry()
        register_build_metrics(registry, role="front", front=front)
        text = registry.exposition()
        assert 'proto="1.0"' in text
        assert "kube-throttler-tpu/old" in text
        mline = next(
            ln for ln in text.splitlines()
            if ln.startswith("kube_throttler_shard_version_mismatch_total")
            and 'shard="0"' in ln
        )
        assert float(mline.rsplit(" ", 1)[1]) == 3.0


# --------------------------------------------------------------------------
# wire handshake over real TCP: refusal, fallback, and skew equivalence
# --------------------------------------------------------------------------

from test_torch_net_transport import (  # noqa: E402
    WorkerRig,
    build_tcp_front,
    settle,
    teardown_tcp_front,
    wait_until,
)


class TestWireHandshake:
    def test_incompatible_major_typed_refusal_no_crash_loop(self, monkeypatch):
        import kube_throttler_tpu_torch.sharding.ipc as ipc_mod

        real_hello = ipc_mod.local_hello
        monkeypatch.setattr(
            ipc_mod, "local_hello",
            lambda env=None: {"proto": [99, 0], "caps": [], "build": "test-skew"},
        )
        rig = WorkerRig()
        try:
            skewed = rig.client()
            wait_until(lambda: skewed.version_refused is not None,
                       msg="typed refusal")
            assert "VersionMismatch" in skewed.version_refused
            assert "99" in skewed.version_refused
            assert skewed.version_mismatches >= 1
            with pytest.raises(VersionMismatch):
                skewed.request("ping", timeout=2.0)
            # read under the core's epoch lock, which its writer holds: a
            # bare read here is a lockset race the race gate reports
            assert rig.core.negotiated_state()["version_mismatches"] >= 1
            # the refusal killed ONE lane, not the process: a compatible
            # client handshakes and serves on the same listener
            monkeypatch.setattr(ipc_mod, "local_hello", real_hello)
            healthy = rig.client()
            # the hello lands on lane 0's reader before the reconnector has
            # dialed the other lanes and marked the link up; a request
            # needs both
            wait_until(lambda: healthy.negotiated_proto is not None and healthy.alive,
                       msg="healthy handshake")
            assert healthy.negotiated_proto == PROTO_VERSION
            assert healthy.negotiated_caps == CAPABILITIES
            assert healthy.peer_build == BUILD_ID
            assert healthy.request("ping", timeout=5.0)
        finally:
            rig.close()

    def test_a_refusal_is_counted_before_it_is_published(self):
        """Fault (p): the client's hello reader set ``version_refused``
        and only then counted it, so a thread that saw the refusal could
        still read ``version_mismatches == 0`` (the test above, under
        load). Every reader that sees the refusal must see it counted."""
        from kube_throttler_tpu_torch.sharding.ipc import _apply_hello

        counted_when_published = []

        class Handle:
            shard_id = 0
            version_refused = None
            version_mismatches = 0

            def __setattr__(self, name, value):
                if name == "version_refused" and value is not None:
                    counted_when_published.append(self.version_mismatches)
                object.__setattr__(self, name, value)

        _apply_hello(Handle(), {"error": "VersionMismatch: major 99 != 1"})
        assert counted_when_published == [1]

    def test_front_health_names_the_version_mismatch(self, monkeypatch):
        import kube_throttler_tpu_torch.sharding.ipc as ipc_mod

        monkeypatch.setattr(
            ipc_mod, "local_hello",
            lambda env=None: {"proto": [99, 0], "caps": [], "build": "test-skew"},
        )
        rig = WorkerRig()
        front = AdmissionFront(1)
        try:
            front.attach_shard(0, rig.client())
            wait_until(
                lambda: front.shards[0].version_refused is not None,
                msg="refusal recorded",
            )
            state, detail = front._shards_health()
            assert state != "ok"
            assert "version-mismatch" in detail["shard-0"]
            assert "99" in detail["shard-0"]  # the refusal names the major
        finally:
            front.stop()
            rig.close()

    @pytest.mark.parametrize("seed", [0])
    def test_masked_caps_fleet_matches_oracle(self, seed, monkeypatch):
        """A fleet rolled back to the zero-capability 1.0 baseline
        (KT_PROTO_CAPS_MASK="") must produce verdicts identical to the
        full-capability fleet and the single-process oracle: capabilities
        gate ENCODINGS, never admission semantics."""
        from test_torch_sharding import apply_population, seeded_population

        ops = seeded_population(seed)
        oracle_store = Store()
        apply_population(oracle_store, ops)
        oracle = H.build_plugin(oracle_store)
        oracle.run_pending_once()

        monkeypatch.setenv("KT_PROTO_CAPS_MASK", "")
        old_front, old_cores, old_servers = build_tcp_front(2)
        monkeypatch.delenv("KT_PROTO_CAPS_MASK")
        new_front, new_cores, new_servers = build_tcp_front(2)
        try:
            for h in old_front.shards.values():
                wait_until(lambda h=h: h.negotiated_proto is not None,
                           msg="old fleet handshake")
                assert h.negotiated_caps == frozenset()
            for h in new_front.shards.values():
                wait_until(lambda h=h: h.negotiated_proto is not None,
                           msg="new fleet handshake")
                assert h.negotiated_caps == CAPABILITIES
            for front in (old_front, new_front):
                apply_population(front.store, ops)
                settle(front)
            for pod in oracle_store.list_pods():
                want = oracle.pre_filter(pod)
                for label, front in (("masked", old_front), ("full", new_front)):
                    got = front.pre_filter(pod)
                    assert got.code == want.code, (label, pod.key, got.reasons)
                    assert H.normalized_reasons(got.reasons) == (
                        H.normalized_reasons(want.reasons)
                    ), (label, pod.key)
        finally:
            oracle.stop()
            teardown_tcp_front(old_front, old_cores, old_servers)
            teardown_tcp_front(new_front, new_cores, new_servers)

    def test_reservations_survive_masked_caps(self, monkeypatch):
        monkeypatch.setenv("KT_PROTO_CAPS_MASK", "")
        front, cores, servers = build_tcp_front(2)
        try:
            front.store.create_namespace(Namespace("default"))
            for i in range(4):
                front.store.create_throttle(H.make_throttle(i))
            settle(front)
            held = [
                make_pod(f"r{i}", labels={"grp": "g0"}, requests={"cpu": "600m"})
                for i in range(2)
            ]
            for pod in held:
                assert front.reserve(pod).is_success()
            probe = make_pod("probe", labels={"grp": "g0"},
                             requests={"cpu": "600m"})
            throttled = front.pre_filter(probe)  # 1.2 reserved > t0's 1 cpu
            for pod in held:
                front.unreserve(pod)
            released = front.pre_filter(probe)
            # the reserves were visible downstream and the unreserves undid
            # them — two-phase reservation does not ride any minor capability
            assert not throttled.is_success()
            assert released.is_success()
        finally:
            teardown_tcp_front(front, cores, servers)
