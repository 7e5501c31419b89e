"""Stateless read-replica admission tier (PERFORMANCE.md "Verdict cache &
read replicas"): a replica bootstraps from the owner's snapshot, streams
its journal tail, serves ``/v1/prefilter*`` from its mirrored planes +
verdict cache, FORWARDS every write surface to the owner, and refuses
reads with 503 once replication lag exceeds the staleness bound.

Covers: the ReplicaGate lag/admit/health contract, replica HTTP serving
(verdicts agree with the owner's), forward-on-write (reserve + object
writes land on the owner, responses relayed with the forwarded-by
marker), /readyz role reporting, and the staleness refusal path.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from kube_throttler_tpu_torch.api.pod import Namespace
from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
from kube_throttler_tpu_torch.engine.replication import (
    FencingEpoch,
    HaCoordinator,
    ReplicaGate,
    ReplicationServer,
    ReplicationSource,
    StandbyReplicator,
)
from kube_throttler_tpu_torch.engine.snapshot import SnapshotManager
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.server import ThrottlerHTTPServer
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _wait(predicate, timeout=10.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _req(port, method, path, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            payload = resp.read().decode()
            headers = dict(resp.headers)
            status = resp.status
    except urllib.error.HTTPError as e:
        payload = e.read().decode()
        headers = dict(e.headers)
        status = e.code
    try:
        return status, json.loads(payload), headers
    except json.JSONDecodeError:
        return status, payload, headers


# --------------------------------------------------------------------------
# gate contract
# --------------------------------------------------------------------------


class TestReplicaGate:
    def _gate(self, max_lag_s=5.0, **rep_attrs):
        rep = SimpleNamespace(
            diverged=False, bootstrapped=True, last_contact_monotonic=100.0
        )
        for k, v in rep_attrs.items():
            setattr(rep, k, v)
        gate = ReplicaGate(rep, max_lag_s=max_lag_s)
        return gate, rep

    def test_fresh_replica_admits(self):
        gate, _ = self._gate()
        gate._monotonic = lambda: 102.0  # lag 2s < 5s
        assert gate.current_lag() == pytest.approx(2.0)
        assert gate.admit()
        assert gate.served_total == 1 and gate.refused_total == 0
        state, detail = gate.health_state()
        assert state == "ok"

    def test_stale_replica_refuses_and_counts(self):
        gate, _ = self._gate()
        gate._monotonic = lambda: 110.0  # lag 10s > 5s
        assert not gate.admit()
        assert gate.refused_total == 1 and gate.lag_events_total == 1
        state, detail = gate.health_state()
        assert state == "down"
        assert "staleness" in detail.get("error", "")

    def test_unbootstrapped_and_diverged_are_infinitely_stale(self):
        gate, rep = self._gate(bootstrapped=False)
        assert gate.current_lag() == float("inf")
        rep.bootstrapped = True
        rep.diverged = True
        assert gate.current_lag() == float("inf")
        rep.diverged = False
        rep.last_contact_monotonic = None
        assert gate.current_lag() == float("inf")

    def test_clock_never_goes_negative(self):
        gate, _ = self._gate()
        gate._monotonic = lambda: 99.0  # contact "in the future"
        assert gate.current_lag() == 0.0


# --------------------------------------------------------------------------
# replica rig: owner (admission + replication) + replica (serving tier)
# --------------------------------------------------------------------------


class _Rig:
    def __init__(self, tmp_path, max_lag_s=5.0):
        self.owner_dir = str(tmp_path / "owner")
        self.replica_dir = str(tmp_path / "replica")
        os.makedirs(self.owner_dir)
        os.makedirs(self.replica_dir)
        args = decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        )
        # owner: store + journal + snapshot + admission HTTP + replication
        self.ls = Store()
        lrec = RecoveryManager(self.owner_dir)
        self.lj = lrec.recover_store(self.ls)
        self.lepoch = FencingEpoch(self.owner_dir)
        self.lj.fencing = self.lepoch
        self.snap = SnapshotManager(self.owner_dir, self.ls)
        self.snap.fencing = self.lepoch
        self.snap.bind_journal(self.lj, every_lines=0)
        self.ha = HaCoordinator(
            self.lepoch, role="leader", journal=self.lj, snapshotter=self.snap
        )
        self.ha.become_leader()
        self.ls.create_namespace(Namespace("default"))
        self.snap.write(reason="bootstrap")
        self.owner_plugin = KubeThrottler(args, self.ls, use_device=True, device="cpu")
        self.owner_http = ThrottlerHTTPServer(self.owner_plugin, port=0)
        self.owner_http.start()
        self.source = ReplicationSource(self.owner_dir, self.lj, self.lepoch)
        self.repl_server = ReplicationServer(self.source)
        self.repl_server.start()
        # replica: bootstrap + stream, then the gated serving tier
        self.rs = Store()
        rrec = RecoveryManager(self.replica_dir)
        self.rj = rrec.recover_store(self.rs)
        self.repoch = FencingEpoch(self.replica_dir)
        self.rj.fencing = self.repoch
        self.rep = StandbyReplicator(
            self.rs,
            self.rj,
            f"http://127.0.0.1:{self.repl_server.port}",
            epoch=self.repoch,
            poll_interval=0.02,
        )
        assert self.rep.bootstrap(10.0)
        self.rep.start()
        self.replica_plugin = KubeThrottler(args, self.rs, use_device=True, device="cpu")
        self.gate = ReplicaGate(self.rep, max_lag_s=max_lag_s)
        self.replica_http = ThrottlerHTTPServer(
            self.replica_plugin,
            port=0,
            replica_gate=self.gate,
            owner_url=f"http://127.0.0.1:{self.owner_http.port}",
        )
        self.replica_http.start()

    def close(self):
        self.replica_http.stop()
        self.rep.stop()
        self.owner_http.stop()
        self.repl_server.stop()
        self.replica_plugin.stop()
        self.owner_plugin.stop()
        self.rj.close()
        self.lj.close()


THROTTLE_MANIFEST = {
    "kind": "Throttle",
    "metadata": {"name": "t1", "namespace": "default"},
    "spec": {
        "throttlerName": "kube-throttler",
        "threshold": {"resourceRequests": {"cpu": "200m"}},
        "selector": {
            "selectorTerms": [{"podSelector": {"matchLabels": {"grp": "a"}}}]
        },
    },
}


def _pod_manifest(name, cpu="100m", labels=None):
    return {
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": "default",
            "labels": {"grp": "a"} if labels is None else labels,
        },
        "spec": {
            "schedulerName": "my-scheduler",
            "containers": [
                {"name": "c", "resources": {"requests": {"cpu": cpu}}}
            ],
        },
    }


class TestReplicaServing:
    def test_replica_serves_reads_and_forwards_writes(self, tmp_path):
        rig = _Rig(tmp_path)
        try:
            owner, replica = rig.owner_http.port, rig.replica_http.port
            # /readyz reports the role
            code, ready, _ = _req(replica, "GET", "/readyz")
            assert ready.get("role") == "replica"

            # seed the OWNER; the stream mirrors it to the replica
            code, _, _ = _req(owner, "POST", "/v1/objects", THROTTLE_MANIFEST)
            assert code == 200
            code, _, _ = _req(owner, "POST", "/v1/objects", _pod_manifest("p1"))
            assert code == 200
            assert _wait(
                lambda: any(t.name == "t1" for t in rig.rs.list_throttles())
                and any(p.name == "p1" for p in rig.rs.list_pods("default"))
            ), "replica never mirrored the owner's objects"

            # the replica answers prefilter LOCALLY, agreeing with owner
            def verdicts_agree():
                _, ov, _ = _req(owner, "POST", "/v1/prefilter", {"podKey": "default/p1"})
                _, rv, _ = _req(replica, "POST", "/v1/prefilter", {"podKey": "default/p1"})
                return ov["code"] == rv["code"]

            assert _wait(verdicts_agree), "replica verdict diverged from owner"
            assert rig.gate.served_total > 0

            # a second identical probe is a verdict-cache hit replica-side
            hits0 = rig.replica_plugin.verdict_cache.stats()[0]
            _req(replica, "POST", "/v1/prefilter", {"podKey": "default/p1"})
            assert rig.replica_plugin.verdict_cache.stats()[0] > hits0

            # WRITES forward to the owner: reserve through the replica
            code, _, headers = _req(
                replica, "POST", "/v1/reserve", {"podKey": "default/p1"}
            )
            assert code == 200
            assert headers.get("X-KT-Forwarded-By") == "replica"
            assert _wait(
                lambda: "default/p1"
                in rig.owner_plugin.throttle_ctr.cache.reserved_pod_keys(
                    "default/t1"
                )
            ), "forwarded reserve never landed on the owner"

            # object writes forward too, then stream back to the replica
            code, _, headers = _req(
                replica, "POST", "/v1/objects", _pod_manifest("p2", cpu="50m")
            )
            assert code == 200
            assert headers.get("X-KT-Forwarded-By") == "replica"
            owner_pods = lambda: {p.name for p in rig.ls.list_pods("default")}  # noqa: E731
            assert "p2" in owner_pods()
            assert _wait(
                lambda: any(p.name == "p2" for p in rig.rs.list_pods("default"))
            ), "forwarded object write never streamed back"

            # DELETE forwards as well
            code, _, headers = _req(
                replica, "DELETE", "/v1/objects/pods/default/p2"
            )
            assert code == 200
            assert headers.get("X-KT-Forwarded-By") == "replica"
            assert _wait(lambda: "p2" not in owner_pods())
        finally:
            rig.close()

    def test_stale_replica_refuses_reads_with_503(self, tmp_path):
        rig = _Rig(tmp_path)
        try:
            replica = rig.replica_http.port
            _req(rig.owner_http.port, "POST", "/v1/objects", THROTTLE_MANIFEST)
            _req(rig.owner_http.port, "POST", "/v1/objects", _pod_manifest("p1"))
            assert _wait(
                lambda: any(p.name == "p1" for p in rig.rs.list_pods("default"))
            )
            code, _, _ = _req(replica, "POST", "/v1/prefilter", {"podKey": "default/p1"})
            assert code == 200
            # freeze the gate's clock far past the staleness bound: reads
            # refuse, health flips, but writes still forward
            rig.gate._monotonic = (
                lambda: rig.rep.last_contact_monotonic + rig.gate.max_lag_s + 60.0
            )
            code, body, _ = _req(
                replica, "POST", "/v1/prefilter", {"podKey": "default/p1"}
            )
            assert code == 503
            assert "stale" in body["error"]
            assert body["maxLagSeconds"] == rig.gate.max_lag_s
            code, body, _ = _req(replica, "POST", "/v1/prefilter-batch", {})
            assert code == 503
            assert rig.gate.refused_total >= 2
            code, _, headers = _req(
                replica, "POST", "/v1/reserve", {"podKey": "default/p1"}
            )
            assert code == 200  # forwarded writes are never staleness-gated
            assert headers.get("X-KT-Forwarded-By") == "replica"
        finally:
            rig.close()

    def test_dead_owner_makes_forwards_502(self, tmp_path):
        rig = _Rig(tmp_path)
        try:
            replica = rig.replica_http.port
            rig.owner_http.stop()
            code, body, _ = _req(
                replica, "POST", "/v1/reserve", {"podKey": "default/nope"}
            )
            assert code == 502
            assert "owner unreachable" in body["error"]
        finally:
            rig.close()

    def test_replica_metrics_families_export(self, tmp_path):
        from kube_throttler_tpu_torch.metrics import (
            register_replica_metrics,
            register_verdict_cache_metrics,
        )

        rig = _Rig(tmp_path)
        try:
            registry = rig.replica_plugin.metrics_registry
            register_replica_metrics(registry, rig.gate)
            register_verdict_cache_metrics(
                registry, rig.replica_plugin.verdict_cache
            )
            _req(rig.owner_http.port, "POST", "/v1/objects", THROTTLE_MANIFEST)
            _req(rig.owner_http.port, "POST", "/v1/objects", _pod_manifest("p1"))
            assert _wait(
                lambda: any(p.name == "p1" for p in rig.rs.list_pods("default"))
            )
            _req(rig.replica_http.port, "POST", "/v1/prefilter", {"podKey": "default/p1"})
            text = registry.exposition()
            assert 'kube_throttler_replica_verdicts_total{outcome="served"}' in text
            assert "kube_throttler_replica_lag_events_total" in text
            assert "kube_throttler_replica_lag_seconds" in text
            assert "kube_throttler_verdict_cache_hits_total" in text
            assert "kube_throttler_verdict_cache_entries" in text
        finally:
            rig.close()
