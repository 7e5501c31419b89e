"""Wire-protocol transport: reflectors (list+watch+resume+410),
remote status writer (optimistic concurrency), kubeconfig parsing, and the
end-to-end remote-mode daemon against the in-process mock apiserver
(reference integration tier: plugin.go:71-130 + test/integration/, but
deterministic — no kind cluster)."""

from __future__ import annotations

import time
from dataclasses import replace

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
from kube_throttler_tpu_torch.client.mockserver import MockApiServer
from kube_throttler_tpu_torch.client.transport import (
    ApiClient,
    GoneError,
    Reflector,
    RemoteSession,
    RemoteStatusWriter,
    RemoteVersions,
    RestConfig,
    parse_kubeconfig,
)
from kube_throttler_tpu_torch.engine.store import ConflictError, Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
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


def _bound(pod):
    bound = replace(pod, spec=replace(pod.spec, node_name="node-1"))
    bound.status.phase = "Running"
    return bound


@pytest.fixture()
def apiserver():
    server = MockApiServer(bookmark_interval=0.05)
    server.store.create_namespace(Namespace("default"))
    server.start()
    yield server
    server.stop()


def _wait(predicate, timeout=10.0, every=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(every)
    return predicate()


class TestKubeconfig:
    def test_parse(self, tmp_path):
        path = tmp_path / "kubeconfig"
        path.write_text(
            """
apiVersion: v1
kind: Config
current-context: target
clusters:
- name: c1
  cluster:
    server: http://127.0.0.1:8443
- name: c2
  cluster:
    server: https://other:6443
    insecure-skip-tls-verify: true
contexts:
- name: other
  context: {cluster: c2, user: u2}
- name: target
  context: {cluster: c1, user: u1}
users:
- name: u1
  user: {token: sekrit}
- name: u2
  user: {}
"""
        )
        cfg = parse_kubeconfig(str(path))
        assert cfg.server == "http://127.0.0.1:8443"
        assert cfg.token == "sekrit"
        assert cfg.verify_tls

    def test_parse_client_certs_inline_and_file(self, tmp_path):
        """client-certificate/key as file paths AND as inline *-data base64
        (the shape kubeadm/minikube kubeconfigs actually use)."""
        import base64

        cert_file = tmp_path / "crt.pem"
        cert_file.write_text("CERT")
        path = tmp_path / "kubeconfig"
        path.write_text(
            f"""
clusters:
- name: c1
  cluster:
    server: https://h:6443
    certificate-authority-data: {base64.b64encode(b"CADATA").decode()}
contexts:
- name: ctx
  context: {{cluster: c1, user: u1}}
current-context: ctx
users:
- name: u1
  user:
    client-certificate: {cert_file}
    client-key-data: {base64.b64encode(b"KEYDATA").decode()}
"""
        )
        cfg = parse_kubeconfig(str(path))
        assert cfg.cert_file == str(cert_file)
        assert open(cfg.key_file, "rb").read() == b"KEYDATA"
        assert open(cfg.ca_file, "rb").read() == b"CADATA"

    def test_parse_first_context_when_current_missing(self, tmp_path):
        path = tmp_path / "kubeconfig"
        path.write_text(
            """
clusters:
- name: c1
  cluster: {server: "http://h:1"}
contexts:
- name: only
  context: {cluster: c1}
"""
        )
        assert parse_kubeconfig(str(path)).server == "http://h:1"

    def test_in_cluster_config_from_sa_mount(self, tmp_path, monkeypatch):
        from kube_throttler_tpu_torch.client.transport import in_cluster_config

        (tmp_path / "token").write_text("sa-token\n")
        (tmp_path / "ca.crt").write_text("CERT")
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
        cfg = in_cluster_config(sa_dir=str(tmp_path))
        assert cfg.server == "https://10.0.0.1:6443"
        assert cfg.token_file == str(tmp_path / "token")
        assert cfg.verify_tls

    def test_in_cluster_config_requires_env_and_token(self, tmp_path, monkeypatch):
        from kube_throttler_tpu_torch.client.transport import in_cluster_config

        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        with pytest.raises(ValueError, match="KUBERNETES_SERVICE_HOST"):
            in_cluster_config(sa_dir=str(tmp_path))
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
        with pytest.raises(ValueError, match="token missing"):
            in_cluster_config(sa_dir=str(tmp_path))

    def test_token_file_rotation_picked_up(self, apiserver, tmp_path):
        apiserver.token = "tok-2"
        token_path = tmp_path / "token"
        token_path.write_text("tok-1\n")
        client = ApiClient(
            RestConfig(server=apiserver.url, token_file=str(token_path))
        )
        with pytest.raises(Exception):  # 401 with the stale token
            client.list("Pod")
        import os as _os

        token_path.write_text("tok-2\n")
        # force a new mtime even on coarse-granularity filesystems
        st = _os.stat(token_path)
        _os.utime(token_path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        items, _ = client.list("Pod")  # rotated token honored mid-process
        assert items == []


class TestListWatch:
    def test_list_returns_items_and_rv(self, apiserver):
        apiserver.store.create_throttle(_throttle("t1", {"a": "b"}, pod=5))
        client = ApiClient(RestConfig(server=apiserver.url))
        items, rv = client.list("Throttle")
        assert len(items) == 1
        assert items[0]["metadata"]["name"] == "t1"
        assert int(rv) >= int(items[0]["metadata"]["resourceVersion"])

    def test_reflector_syncs_and_follows(self, apiserver):
        local = Store()
        client = ApiClient(RestConfig(server=apiserver.url))
        refl = Reflector(client, "Throttle", local)
        refl.start()
        try:
            assert refl.wait_for_sync(5)
            apiserver.store.create_throttle(_throttle("t1", {"a": "b"}, pod=5))
            assert _wait(lambda: len(local.list_throttles()) == 1)
            # modification flows
            t1 = apiserver.store.get_throttle("default", "t1")
            apiserver.store.update_throttle(
                replace(t1, spec=replace(t1.spec, threshold=ResourceAmount.of(pod=7)))
            )
            assert _wait(
                lambda: local.list_throttles()
                and local.list_throttles()[0].spec.threshold.resource_counts == 7
            )
            # deletion flows
            apiserver.store.delete_throttle("default", "t1")
            assert _wait(lambda: len(local.list_throttles()) == 0)
        finally:
            refl.stop()

    def test_reflector_survives_stream_close_via_rv_resume(self, apiserver):
        local = Store()
        client = ApiClient(RestConfig(server=apiserver.url))
        refl = Reflector(client, "Pod", local)
        refl.start()
        try:
            assert refl.wait_for_sync(5)
            apiserver.store.create_pod(_bound(make_pod("p1")))
            assert _wait(lambda: len(local.list_pods()) == 1)
            # bounce every watch stream: server restart on the same store is
            # not possible (port changes), so force-close by shutting down
            # connections — the reflector re-watches from last_rv
            before_rv = refl.last_resource_version
            apiserver.store.create_pod(_bound(make_pod("p2")))
            assert _wait(lambda: len(local.list_pods()) == 2)
            assert int(refl.last_resource_version) > int(before_rv)
        finally:
            refl.stop()

    def test_watch_410_after_log_compaction(self):
        server = MockApiServer(log_size=4, bookmark_interval=0.05)
        server.start()
        try:
            for i in range(10):  # overflow the 4-entry log
                server.store.create_namespace(Namespace(f"ns-{i}"))
            client = ApiClient(RestConfig(server=server.url))
            with pytest.raises(GoneError):
                for _ in client.watch("Namespace", "1"):
                    pass
        finally:
            server.stop()

    def test_reflector_metrics_exported(self, apiserver):
        from kube_throttler_tpu_torch.metrics import Registry

        registry = Registry()
        local = Store()
        session = RemoteSession(
            RestConfig(server=apiserver.url), local, metrics_registry=registry
        )
        session.start(sync_timeout=10)
        try:
            apiserver.store.create_pod(_bound(make_pod("p1")))
            assert _wait(lambda: len(local.list_pods()) == 1)
            expo = registry.exposition()
            assert 'kube_throttler_reflector_lists_total{kind="Pod"}' in expo
            assert 'kube_throttler_reflector_events_total{kind="Pod"}' in expo
        finally:
            session.stop()

    def test_reflector_recovers_from_410_by_relisting(self):
        server = MockApiServer(log_size=4, bookmark_interval=0.05)
        server.start()
        local = Store()
        client = ApiClient(RestConfig(server=server.url))
        refl = Reflector(client, "Namespace", local)
        try:
            refl.start()
            assert refl.wait_for_sync(5)
            # compact far past the reflector's resume point while it holds
            # an open stream; events still arrive live, but ALSO drive the
            # rv-too-old path by bouncing: stop and restart with a stale rv
            for i in range(10):
                server.store.create_namespace(Namespace(f"ns-{i}"))
            assert _wait(lambda: len(local.list_namespaces()) == 10)
            refl.stop()
            refl2 = Reflector(client, "Namespace", local)
            refl2.last_resource_version = "1"  # stale → watch 410s → relist
            refl2.start()
            server.store.create_namespace(Namespace("late"))
            assert _wait(lambda: local.get_namespace("late") is not None)
            refl2.stop()
        finally:
            refl.stop()
            server.stop()

    def test_bearer_token_enforced(self, apiserver):
        apiserver.token = "sekrit"
        client_bad = ApiClient(RestConfig(server=apiserver.url))
        with pytest.raises(Exception):
            client_bad.list("Pod")
        client_ok = ApiClient(RestConfig(server=apiserver.url, token="sekrit"))
        items, _ = client_ok.list("Pod")
        assert items == []


class TestPaginatedList:
    """Chunked LIST via limit/continue (client-go pager semantics; the
    reference's client layer takes ListOptions on every List —
    throttle.go:82-103)."""

    def test_list_accumulates_across_pages(self, apiserver):
        for i in range(25):
            apiserver.store.create_namespace(Namespace(f"pg-{i:02d}"))
        client = ApiClient(RestConfig(server=apiserver.url), page_size=10)
        items, rv = client.list("Namespace")
        # 25 namespaces + the fixture's "default"
        assert len(items) == 26
        assert int(rv) > 0
        assert apiserver.max_list_page_items == 10  # never one giant body
        assert apiserver.list_requests == 3

    def test_list_pages_streams_with_constant_rv(self, apiserver):
        for i in range(7):
            apiserver.store.create_namespace(Namespace(f"st-{i}"))
        client = ApiClient(RestConfig(server=apiserver.url))
        pages = list(client.list_pages("Namespace", page_size=3))
        assert [len(p) for p, _ in pages] == [3, 3, 2]
        # every page reports the RV of the snapshot the first page was cut at
        assert len({rv for _, rv in pages}) == 1

    def test_expired_continue_token_410s(self, apiserver):
        for i in range(6):
            apiserver.store.create_namespace(Namespace(f"ex-{i}"))
        client = ApiClient(RestConfig(server=apiserver.url))
        pages = client.list_pages("Namespace", page_size=2)
        next(pages)  # first page cut, token outstanding
        assert apiserver.expire_continue_tokens() == 1
        with pytest.raises(GoneError):
            next(pages)

    def test_relist_survives_token_expiry_via_full_list_fallback(self):
        server = MockApiServer()
        for i in range(10):
            server.store.create_namespace(Namespace(f"fb-{i}"))
        server.start()
        try:
            client = ApiClient(RestConfig(server=server.url), page_size=4)
            sabotaged = client.list_pages

            def expiring_pages(kind, page_size=None):
                for page in sabotaged(kind, page_size):
                    yield page
                    server.expire_continue_tokens()  # token dies between pages

            client.list_pages = expiring_pages
            local = Store()
            refl = Reflector(client, "Namespace", local)
            refl._relist()  # paged relist 410s mid-way → unpaginated fallback
            assert len(local.list_namespaces()) == 10
            assert server.max_list_page_items == 10  # the fallback full LIST
        finally:
            server.stop()

    def test_streaming_relist_bounded_pages_at_scale(self, apiserver):
        # 5k objects through a 500-item pager: the reflector's memory
        # high-water is one page + the seen-key set, and the server never
        # serializes more than one page per response
        n = 5_000
        for i in range(n):
            apiserver.store.create_namespace(Namespace(f"big-{i:05d}"))
        client = ApiClient(RestConfig(server=apiserver.url))  # default 500/page
        local = Store()
        local.create_namespace(Namespace("stale-entry"))  # must be deleted
        refl = Reflector(client, "Namespace", local)
        rv = refl._relist()
        assert int(rv) > 0
        assert len(local.list_namespaces()) == n + 1  # n big + fixture default
        assert local.get_namespace("stale-entry") is None
        assert apiserver.max_list_page_items == 500
        assert apiserver.list_requests == (n + 1) // 500 + 1


class TestStatusWriter:
    def test_put_status_and_echo(self, apiserver):
        apiserver.store.create_throttle(_throttle("t1", {"a": "b"}, pod=5))
        local = Store()
        client = ApiClient(RestConfig(server=apiserver.url))
        versions = RemoteVersions()
        refl = Reflector(client, "Throttle", local, versions=versions)
        refl.start()
        try:
            assert refl.wait_for_sync(5)
            assert _wait(lambda: len(local.list_throttles()) == 1)
            writer = RemoteStatusWriter(client, versions)
            thr = local.get_throttle("default", "t1")
            new_status = replace(thr.status, used=ResourceAmount.of(pod=3))
            writer.update_throttle_status(thr.with_status(new_status))
            # the write lands on the REMOTE store...
            remote = apiserver.store.get_throttle("default", "t1")
            assert remote.status.used.resource_counts == 3
            # ...and echoes back into the local cache via the watch
            assert _wait(
                lambda: local.get_throttle("default", "t1").status.used.resource_counts
                == 3
            )
        finally:
            refl.stop()

    def test_stale_rv_conflicts(self, apiserver):
        apiserver.store.create_throttle(_throttle("t1", {"a": "b"}, pod=5))
        client = ApiClient(RestConfig(server=apiserver.url))
        versions = RemoteVersions()
        versions.set("Throttle", "default/t1", "999999")  # stale
        writer = RemoteStatusWriter(client, versions)
        thr = apiserver.store.get_throttle("default", "t1")
        with pytest.raises(ConflictError):
            writer.update_throttle_status(thr)


class TestWriteRateLimit:
    def test_token_bucket_burst_then_paced(self):
        from kube_throttler_tpu_torch.client.transport import _TokenBucket

        tb = _TokenBucket(qps=100.0, burst=5)
        t0 = time.monotonic()
        for _ in range(5):
            tb.take()  # burst: immediate
        burst_t = time.monotonic() - t0
        assert burst_t < 0.05, f"burst takes should not wait ({burst_t:.3f}s)"
        t0 = time.monotonic()
        for _ in range(10):
            tb.take()  # drained: ~1/qps each
        paced_t = time.monotonic() - t0
        assert paced_t >= 0.08, f"drained takes must pace at qps ({paced_t:.3f}s)"

    def test_writes_pass_the_bucket_reads_do_not(self, apiserver):
        apiserver.store.create_throttle(_throttle("t1", {"a": "b"}, pod=5))
        client = ApiClient(RestConfig(server=apiserver.url), qps=10_000.0, burst=1)
        taken = []
        orig = client._write_bucket.take
        client._write_bucket.take = lambda: (taken.append(1), orig())[1]
        client.list("Throttle")  # read: no bucket
        assert taken == []
        thr = apiserver.store.get_throttle("default", "t1")
        # no tracked rv → the PUT omits resourceVersion (no optimistic check)
        RemoteStatusWriter(client, RemoteVersions()).update_throttle_status(thr)
        assert len(taken) == 1  # the PUT took a token

    def test_disabled_bucket(self, apiserver):
        client = ApiClient(RestConfig(server=apiserver.url), qps=None)
        assert client._write_bucket is None
        client.list("Throttle")  # still works


class TestRemoteModeGuards:
    def test_http_surface_refuses_local_writes_in_remote_mode(self, apiserver):
        import json as _json
        import urllib.request

        from kube_throttler_tpu_torch.server import ThrottlerHTTPServer

        local = Store()
        session = RemoteSession(RestConfig(server=apiserver.url), local)
        session.start(sync_timeout=10)
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            local,
            use_device=False,
            status_writer=session.status_writer, device="cpu",
        )
        server = ThrottlerHTTPServer(plugin, port=0, remote=True)
        server.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/objects",
                data=_json.dumps(
                    {"kind": "Namespace", "metadata": {"name": "x"}}
                ).encode(),
                headers={"Content-Type": "application/json"},
            )
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req)
            assert exc.value.code == 409
            # admission endpoints still work
            body = {
                "kind": "Pod",
                "metadata": {"name": "p", "namespace": "default"},
                "spec": {"schedulerName": "my-scheduler", "containers": []},
            }
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/prefilter",
                data=_json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
            )
            resp = _json.load(urllib.request.urlopen(req))
            assert resp["code"] == "Success"
        finally:
            server.stop()
            plugin.stop()
            session.stop()


class TestRemoteEvents:
    def test_warning_events_reach_the_apiserver(self, apiserver):
        """pod-requests-exceeds-threshold emits a Warning event; in remote
        mode it lands as a v1 Event on the cluster (plugin.go:190-201),
        with repeats aggregated into a count."""
        remote = apiserver.store
        remote.create_throttle(_throttle("t1", {"grp": "a"}, requests={"cpu": "100m"}))

        local = Store()
        session = RemoteSession(RestConfig(server=apiserver.url), local)
        session.start(sync_timeout=10)
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            local,
            use_device=True,
            event_recorder=session.event_recorder,
            status_writer=session.status_writer, device="cpu",
        )
        try:
            probe = make_pod("big", labels={"grp": "a"}, requests={"cpu": "5"})
            for _ in range(3):  # repeats aggregate, not multiply
                verdict = plugin.pre_filter(probe)
                assert not verdict.is_success()
            # emission is async (the hot path must never block on the
            # apiserver) — drain the recorder queue before asserting
            session.event_recorder.flush()
            # flush drains the queue; the last PUT may still be in flight —
            # wait on the observable count
            assert _wait(
                lambda: apiserver.events_in("default")
                and apiserver.events_in("default")[0].get("count") == 3
            )
            events = apiserver.events_in("default")
            assert len(events) == 1
            ev = events[0]
            assert ev["type"] == "Warning"
            assert ev["reason"] == "ResourceRequestsExceedsThrottleThreshold"
            assert ev["involvedObject"]["name"] == "big"
        finally:
            plugin.stop()
            session.stop()


class TestStandaloneWireServer:
    def test_daemon_serves_wire_protocol(self):
        """`serve --apiserver-port`: the standalone daemon's store doubles
        as a real list+watch control plane — a reflector client syncs its
        objects and observes the daemon's own status writes live."""
        import json as _json
        import re
        import subprocess
        import sys as _sys
        import urllib.request

        proc = subprocess.Popen(
            [
                _sys.executable, "-m", "kube_throttler_tpu_torch.cli", "serve",
                "--name", "kube-throttler", "--target-scheduler-name", "my-scheduler",
                "--port", "0", "--apiserver-port", "0", "--no-device",
            ],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        try:
            from tests.conftest import ProcReader

            reader = ProcReader(proc)
            lines = reader.wait_for(r"serving on [^:]+:\d+", timeout_s=60)
            wire_port = api_port = None
            for line in lines:
                m = re.search(r"wire-protocol apiserver on [^:]+:(\d+)", line)
                if m:
                    wire_port = int(m.group(1))
                m = re.search(r"serving on [^:]+:(\d+)", line)
                if m:
                    api_port = int(m.group(1))
            assert wire_port and api_port, f"daemon did not start: {lines}"

            def post(doc):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{api_port}/v1/objects",
                    data=_json.dumps(doc).encode(),
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=10).read()

            post({
                "kind": "Throttle",
                "metadata": {"name": "t1", "namespace": "default"},
                "spec": {
                    "throttlerName": "kube-throttler",
                    "threshold": {"resourceRequests": {"cpu": "1"}},
                    "selector": {"selectorTerms": [{"podSelector": {"matchLabels": {"grp": "a"}}}]},
                },
            })
            post({
                "kind": "Pod",
                "metadata": {"name": "p1", "namespace": "default", "labels": {"grp": "a"}},
                "spec": {
                    "schedulerName": "my-scheduler", "nodeName": "node-1",
                    "containers": [{"resources": {"requests": {"cpu": "700m"}}}],
                },
                "status": {"phase": "Running"},
            })

            # a reflector client syncs from the daemon's wire server and
            # sees the daemon's OWN status write land
            local = Store()
            session = RemoteSession(
                RestConfig(server=f"http://127.0.0.1:{wire_port}"), local
            )
            session.start(sync_timeout=15)
            try:
                assert _wait(
                    lambda: local.list_throttles()
                    and local.list_throttles()[0].status.used.resource_counts == 1,
                    timeout=15,
                )
            finally:
                session.stop()
        finally:
            proc.terminate()
            proc.wait(timeout=10)


class TestRemoteModeEndToEnd:
    def test_daemon_throttles_external_cluster(self, apiserver):
        """A daemon running against a
        simulated EXTERNAL cluster (over real HTTP list+watch) throttles its
        pods and writes status back to the remote status subresource."""
        remote = apiserver.store
        remote.create_throttle(_throttle("t1", {"grp": "a"}, requests={"cpu": "1"}))

        local = Store()
        session = RemoteSession(RestConfig(server=apiserver.url), local)
        session.start(sync_timeout=10)
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            local,
            use_device=True,
            start_workers=True,
            status_writer=session.status_writer, device="cpu",
        )
        try:
            # cache warmed by the reflectors
            assert local.get_namespace("default") is not None
            assert len(local.list_throttles()) == 1

            # a running pod appears on the REMOTE cluster
            remote.create_pod(
                _bound(make_pod("p1", labels={"grp": "a"}, requests={"cpu": "800m"}))
            )
            # ... flows to the local cache, reconciles, and the status write
            # lands on the REMOTE apiserver (used=800m, throttled=False).
            # 20s: a status-write Conflict (racing our own spec edit below
            # on a loaded host) takes a requeue-backoff + reflector-echo
            # round trip to converge — observed flaking at 10s under full
            # CPU contention
            assert _wait(
                lambda: remote.get_throttle("default", "t1").status.used.resource_counts
                == 1,
                timeout=20.0,
            )
            assert _wait(
                lambda: local.get_throttle("default", "t1").status.used.resource_counts
                == 1  # echo closed the loop
            )

            # admission: a 300m pod would exceed 1 cpu → insufficient
            verdict = plugin.pre_filter(
                make_pod("p2", labels={"grp": "a"}, requests={"cpu": "300m"})
            )
            assert not verdict.is_success()
            assert "throttle[insufficient]=default/t1" in verdict.reasons

            # threshold edit on the remote opens capacity
            t1 = remote.get_throttle("default", "t1")
            remote.update_throttle_spec(
                replace(
                    t1,
                    spec=replace(
                        t1.spec, threshold=ResourceAmount.of(requests={"cpu": "2"})
                    ),
                )
            )
            assert _wait(
                lambda: plugin.pre_filter(
                    make_pod("p2", labels={"grp": "a"}, requests={"cpu": "300m"})
                ).is_success(),
                timeout=20.0,
            )
        finally:
            plugin.stop()
            session.stop()


class TestClientConnectionConfig:
    def test_config_block_sets_defaults_flags_win(self):
        """KubeSchedulerConfiguration clientConnection.{qps,burst} parity."""
        import argparse

        import pytest as _pytest

        from kube_throttler_tpu_torch.cli import _resolve_client_connection

        def fail(msg):
            raise AssertionError(msg)

        raw = {"clientConnection": {"qps": 25, "burst": 40}}
        ns = argparse.Namespace(api_qps=None, api_burst=None)  # flags unset
        _resolve_client_connection(raw, ns, fail)
        assert (ns.api_qps, ns.api_burst) == (25.0, 40)

        # an explicit flag wins EVEN at the default value (50)
        ns = argparse.Namespace(api_qps=50.0, api_burst=None)
        _resolve_client_connection(raw, ns, fail)
        assert (ns.api_qps, ns.api_burst) == (50.0, 40)

        ns = argparse.Namespace(api_qps=None, api_burst=None)
        _resolve_client_connection({}, ns, fail)  # no block: defaults
        assert (ns.api_qps, ns.api_burst) == (50.0, 100)

        # non-numeric values report through fail, not a raw traceback
        errs = []
        _resolve_client_connection(
            {"clientConnection": {"qps": "unlimited"}},
            argparse.Namespace(api_qps=None, api_burst=None),
            errs.append,
        )
        assert errs and "numeric" in errs[0]


class TestAsyncStatusCommitter:
    """AsyncStatusCommitter: coalescing, per-key ordering, conflict retry,
    drop-after-retries (transport.py; the remote-mode analog of the
    reference's synchronous UpdateStatus, throttle_controller.go:157-173)."""

    class _FakeWriter:
        """RemoteStatusWriter stand-in recording _put calls; can be armed
        to raise per-call."""

        def __init__(self):
            import threading

            self.calls = []  # (kind, key, status.used counts)
            self.fail_plan = {}  # key -> list of exceptions to raise first
            self.lock = threading.Lock()

        def _put(self, kind, obj):
            from kube_throttler_tpu_torch.engine.store import key_of

            key = key_of(kind, obj)
            with self.lock:
                plan = self.fail_plan.get(key)
                if plan:
                    raise plan.pop(0)
                self.calls.append((kind, key, obj))

        def refresh_version(self, kind, obj):
            pass

    def _mk(self, **kw):
        from kube_throttler_tpu_torch.client.transport import AsyncStatusCommitter

        w = self._FakeWriter()
        c = AsyncStatusCommitter(w, **kw)
        return w, c

    def _thr(self, name, pods):
        from kube_throttler_tpu_torch.api import ResourceAmount, Throttle, ThrottleSpec
        from kube_throttler_tpu_torch.api.types import ThrottleStatus

        return Throttle(
            name=name,
            namespace="default",
            spec=ThrottleSpec(throttler_name="kt"),
            status=ThrottleStatus(used=ResourceAmount.of(pod=pods)),
        )

    def test_newest_wins_coalescing(self):
        w, c = self._mk(workers=1)
        # submit 50 versions of one key BEFORE starting the worker: exactly
        # one PUT must go out, carrying the newest status
        for i in range(50):
            c.update_throttle_status(self._thr("a", pods=i))
        c.start()
        assert c.flush(5.0)
        c.stop()
        assert len(w.calls) == 1
        assert w.calls[0][2].status.used.resource_counts == 49

    def test_batch_interface_returns_all_keys(self):
        w, c = self._mk(workers=2)
        thrs = [self._thr(f"t{i}", pods=i) for i in range(8)]
        out = c.update_throttle_statuses(thrs)
        assert set(out) == {t.key for t in thrs}
        c.start()
        assert c.flush(5.0)
        c.stop()
        assert {k for (_, k, _) in w.calls} == {t.key for t in thrs}

    def test_per_key_ordering_single_worker_per_key(self):
        # keys hash to fixed shards: interleave two keys' submissions and
        # verify each key's PUT sequence is monotone in submission order
        w, c = self._mk(workers=4)
        c.start()
        for i in range(30):
            c.update_throttle_status(self._thr("x", pods=i))
            c.update_throttle_status(self._thr("y", pods=i))
        assert c.flush(5.0)
        c.stop()
        for key in ("default/x", "default/y"):
            seq = [o.status.used.resource_counts for (_, k, o) in w.calls if k == key]
            assert seq == sorted(seq), seq
            assert seq[-1] == 29  # newest landed last

    def test_conflict_retries_then_lands(self):
        from kube_throttler_tpu_torch.engine.store import ConflictError
        from kube_throttler_tpu_torch.metrics import Registry

        reg = Registry()
        w, c = self._mk(workers=1, metrics_registry=reg)
        w.fail_plan["default/a"] = [ConflictError("a"), ConflictError("a")]
        c.start()
        c.update_throttle_status(self._thr("a", pods=7))
        assert c.flush(5.0)
        c.stop()
        assert len(w.calls) == 1
        assert w.calls[0][2].status.used.resource_counts == 7
        counts = c._commits.collect()
        assert counts[("Throttle", "conflict")] == 2.0
        assert counts[("Throttle", "ok")] == 1.0

    def test_drop_after_retry_budget(self):
        w, c = self._mk(workers=1, max_retries=2)
        w.fail_plan["default/a"] = [RuntimeError("boom")] * 10
        c.start()
        c.update_throttle_status(self._thr("a", pods=1))
        assert c.flush(10.0)
        c.stop()
        assert w.calls == []  # dropped; resync re-plans it
