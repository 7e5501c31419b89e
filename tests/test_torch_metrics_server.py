"""Metrics recorders (reference value semantics) + HTTP daemon surface."""

import json
import urllib.request

import pytest

from kube_throttler_tpu_torch.api import (
    IsResourceAmountThrottled,
    LabelSelector,
    Namespace,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.api.types import ThrottleStatus
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.metrics import Registry, ThrottleMetricsRecorder
from kube_throttler_tpu_torch.plugin import KubeThrottler, RecordingEventRecorder, decode_plugin_args
from kube_throttler_tpu_torch.server import ThrottlerHTTPServer
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


class TestMetrics:
    def test_reference_value_semantics(self):
        registry = Registry()
        recorder = ThrottleMetricsRecorder(registry)
        thr = Throttle(
            name="t1",
            namespace="ns1",
            uid="u1",
            spec=ThrottleSpec(
                threshold=ResourceAmount.of(pod=5, requests={"cpu": "1500m", "memory": "1Gi"})
            ),
            status=ThrottleStatus(
                used=ResourceAmount.of(pod=2, requests={"cpu": "300m", "memory": "512Mi"}),
                throttled=IsResourceAmountThrottled(False, {"cpu": True, "memory": False}),
            ),
        )
        recorder.record(thr)
        text = registry.exposition()
        labels = 'namespace="ns1",name="t1",uid="u1"'
        # CPU in milli (MilliValue), memory in whole bytes (Value)
        assert f'throttle_spec_threshold_resourceRequests{{{labels},resource="cpu"}} 1500' in text
        assert f'throttle_spec_threshold_resourceRequests{{{labels},resource="memory"}} {1024**3}' in text
        assert f'throttle_spec_threshold_resourceCounts{{{labels},resource="pod"}} 5' in text
        assert f'throttle_status_used_resourceRequests{{{labels},resource="cpu"}} 300' in text
        assert f'throttle_status_throttled_resourceRequests{{{labels},resource="cpu"}} 1' in text
        assert f'throttle_status_throttled_resourceRequests{{{labels},resource="memory"}} 0' in text

    def test_nil_counts_records_zero(self):
        registry = Registry()
        recorder = ThrottleMetricsRecorder(registry)
        recorder.record(Throttle(name="t2", namespace="ns1", uid="u2"))
        text = registry.exposition()
        assert 'throttle_spec_threshold_resourceCounts{namespace="ns1",name="t2",uid="u2",resource="pod"} 0' in text


@pytest.fixture
def server():
    store = Store()
    store.create_namespace(Namespace("default"))
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler", "controllerThrediness": 2}
        ),
        store,
        event_recorder=RecordingEventRecorder(),
        start_workers=True,
        device="cpu",
    )
    srv = ThrottlerHTTPServer(plugin, port=0)  # ephemeral port
    srv.start()
    yield srv
    srv.stop()
    plugin.stop()


def _req(srv, method, path, body=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=10) as resp:
        payload = resp.read().decode()
        try:
            return resp.status, json.loads(payload)
        except json.JSONDecodeError:
            return resp.status, payload


class TestHTTPServer:
    def test_end_to_end_over_http(self, server):
        import time

        code, _ = _req(server, "GET", "/healthz")
        assert code == 200
        code, ready = _req(server, "GET", "/readyz")
        assert code == 200 and ready["ok"]
        assert ready["device"]["enabled"] and ready["device"]["available"]
        assert set(ready["workqueues"]) == {"throttle", "clusterthrottle"}

        # apply a throttle and two pods via manifests
        code, out = _req(
            server,
            "POST",
            "/v1/objects",
            {
                "kind": "Throttle",
                "metadata": {"name": "t1", "namespace": "default"},
                "spec": {
                    "throttlerName": "kube-throttler",
                    "threshold": {"resourceRequests": {"cpu": "200m"}},
                    "selector": {"selectorTerms": [{"podSelector": {"matchLabels": {"throttle": "t1"}}}]},
                },
            },
        )
        assert code == 200

        pod1 = {
            "kind": "Pod",
            "metadata": {"name": "pod1", "namespace": "default", "labels": {"throttle": "t1"}},
            "spec": {
                "schedulerName": "my-scheduler",
                "containers": [{"name": "c", "resources": {"requests": {"cpu": "200m"}}}],
            },
        }
        code, _ = _req(server, "POST", "/v1/objects", pod1)
        assert code == 200

        code, out = _req(server, "POST", "/v1/prefilter", {"podKey": "default/pod1"})
        assert code == 200 and out["code"] == "Success"
        code, _ = _req(server, "POST", "/v1/reserve", {"podKey": "default/pod1"})
        assert code == 200
        code, _ = _req(server, "POST", "/v1/bind", {"podKey": "default/pod1", "nodeName": "n1"})
        assert code == 200

        # wait for the async reconcile to mark the throttle active
        deadline = time.time() + 10
        while time.time() < deadline:
            code, thrs = _req(server, "GET", "/v1/throttles")
            # .get chains: before the first reconcile lands (cold-JIT runs
            # take ~1s standalone) the stored status is the pre-reconcile
            # default, whose throttled map has no resourceRequests key
            if thrs and thrs[0]["status"]["throttled"].get("resourceRequests", {}).get("cpu"):
                break
            time.sleep(0.05)
        assert thrs[0]["status"]["used"]["resourceRequests"]["cpu"] == "200m"
        assert thrs[0]["status"]["throttled"]["resourceRequests"]["cpu"] is True

        # second pod is blocked with the reference reason string
        pod2 = dict(pod1, metadata={"name": "pod2", "namespace": "default", "labels": {"throttle": "t1"}})
        code, _ = _req(server, "POST", "/v1/objects", pod2)
        code, out = _req(server, "POST", "/v1/prefilter", {"podKey": "default/pod2"})
        assert out["code"] == "UnschedulableAndUnresolvable"
        assert out["reasons"] == ["throttle[active]=default/t1"]

        # metrics exposition includes the live gauge families
        code, text = _req(server, "GET", "/metrics")
        assert code == 200
        assert "throttle_status_used_resourceRequests" in text

        # spec edit via re-apply does not clobber status
        code, _ = _req(
            server,
            "POST",
            "/v1/objects",
            {
                "kind": "Throttle",
                "metadata": {"name": "t1", "namespace": "default"},
                "spec": {
                    "throttlerName": "kube-throttler",
                    "threshold": {"resourceRequests": {"cpu": "700m"}},
                    "selector": {"selectorTerms": [{"podSelector": {"matchLabels": {"throttle": "t1"}}}]},
                },
            },
        )
        deadline = time.time() + 10
        while time.time() < deadline:
            code, out = _req(server, "POST", "/v1/prefilter", {"podKey": "default/pod2"})
            if out["code"] == "Success":
                break
            time.sleep(0.05)
        assert out["code"] == "Success"

        # delete the pod; unreserve + reconcile clears usage
        code, _ = _req(server, "DELETE", "/v1/objects/pods/default/pod1")
        assert code == 200

    def test_prefilter_batch_agrees_with_per_pod(self, server):
        """/v1/prefilter-batch (one device pass over every stored pod) must
        agree with per-pod /v1/prefilter for each pod's schedulability."""
        import time

        _req(
            server,
            "POST",
            "/v1/objects",
            {
                "kind": "Throttle",
                "metadata": {"name": "tb", "namespace": "default"},
                "spec": {
                    "throttlerName": "kube-throttler",
                    "threshold": {"resourceRequests": {"cpu": "300m"}},
                    "selector": {"selectorTerms": [{"podSelector": {"matchLabels": {"grp": "b"}}}]},
                },
            },
        )
        for name, cpu, labeled in [
            ("bp1", "200m", True),   # fits
            ("bp2", "400m", True),   # alone exceeds threshold
            ("bp3", "200m", False),  # unmatched — always schedulable
        ]:
            _req(
                server,
                "POST",
                "/v1/objects",
                {
                    "kind": "Pod",
                    "metadata": {
                        "name": name,
                        "namespace": "default",
                        "labels": {"grp": "b"} if labeled else {},
                    },
                    "spec": {
                        "schedulerName": "my-scheduler",
                        "containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}],
                    },
                },
            )
        # wait until the async reconcile has observed the objects
        deadline = time.time() + 10
        while time.time() < deadline:
            code, batch = _req(server, "POST", "/v1/prefilter-batch", {})
            if len(batch["schedulable"]) >= 3:
                break
            time.sleep(0.05)
        assert code == 200
        for key in ("default/bp1", "default/bp2", "default/bp3"):
            code, single = _req(server, "POST", "/v1/prefilter", {"podKey": key})
            assert batch["schedulable"][key] == (single["code"] == "Success"), key

    @pytest.mark.parametrize("use_device", [True, False])
    def test_prefilter_batch_modes_and_missing_namespace(self, use_device):
        """Device and host-oracle batch paths agree, and a pod whose
        Namespace object is missing lands in errors (the per-pod path
        returns ERROR for it — review finding)."""
        from kube_throttler_tpu_torch.api import (
            LabelSelector,
            ResourceAmount,
            Throttle,
            ThrottleSelector,
            ThrottleSelectorTerm,
            ThrottleSpec,
        )
        from kube_throttler_tpu_torch.api.pod import make_pod

        store = Store()
        store.create_namespace(Namespace("default"))
        plugin = KubeThrottler(
            decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
            store,
            use_device=use_device,
            device="cpu",
        )
        store.create_throttle(
            Throttle(
                name="t",
                spec=ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(requests={"cpu": "300m"}),
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(LabelSelector(match_labels={"g": "x"})),
                        )
                    ),
                ),
            )
        )
        store.create_pod(make_pod("ok", labels={"g": "x"}, requests={"cpu": "100m"}))
        store.create_pod(make_pod("big", labels={"g": "x"}, requests={"cpu": "400m"}))
        # namespace object "ghost" is never created
        store.create_pod(make_pod("orphan", namespace="ghost", requests={"cpu": "100m"}))
        plugin.run_pending_once()

        out = plugin.pre_filter_batch()
        assert out["schedulable"]["default/ok"] is True
        assert out["schedulable"]["default/big"] is False
        assert "ghost/orphan" in out["errors"]
        assert "ghost/orphan" not in out["schedulable"]

    def test_pod_reapply_preserves_bound_state(self, server):
        """Re-applying a pod manifest must not clobber nodeName/phase."""
        import time

        pod = {
            "kind": "Pod",
            "metadata": {"name": "podx", "namespace": "default", "labels": {"a": "1"}},
            "spec": {
                "schedulerName": "my-scheduler",
                "containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}],
            },
        }
        _req(server, "POST", "/v1/objects", pod)
        _req(server, "POST", "/v1/bind", {"podKey": "default/podx", "nodeName": "n7"})
        # re-apply with a label tweak, no nodeName/status in the manifest
        pod["metadata"]["labels"] = {"a": "2"}
        _req(server, "POST", "/v1/objects", pod)
        _, pods = _req(server, "GET", "/v1/pods")
        got = [p for p in pods if p["key"] == "default/podx"][0]
        assert got["nodeName"] == "n7"
        assert got["phase"] == "Running"
        assert got["labels"] == {"a": "2"}
