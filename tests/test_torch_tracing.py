"""Tracing/profiling subsystem (SURVEY §5 TPU-native equivalent): phase
histograms through the metrics registry, klog-style verbosity, the
/debug/flags/v endpoint, and tracer wiring through plugin/controllers."""

import urllib.request

from kube_throttler_tpu_torch.api import (
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.metrics import Registry
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.utils import tracing
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _plugin(use_device=False):
    store = Store()
    store.create_namespace(Namespace("default"))
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store,
        use_device=use_device,
        device="cpu",
    )
    return store, plugin


class TestHistogram:
    def test_observe_buckets_sum_count(self):
        reg = Registry()
        h = reg.histogram_vec("h_test_seconds", "help", ["phase"], buckets=[0.1, 1.0])
        h.observe({"phase": "x"}, 0.05)
        h.observe({"phase": "x"}, 0.5)
        h.observe({"phase": "x"}, 5.0)
        counts, total, count = h.collect()[("x",)]
        assert counts == [1, 2]  # cumulative: ≤0.1 → 1, ≤1.0 → 2
        assert count == 3 and abs(total - 5.55) < 1e-9

    def test_exposition_format(self):
        reg = Registry()
        h = reg.histogram_vec("h_fmt_seconds", "help", ["phase"], buckets=[0.1])
        h.observe({"phase": "p"}, 0.01)
        text = reg.exposition()
        assert '# TYPE h_fmt_seconds histogram' in text
        assert 'h_fmt_seconds_bucket{phase="p",le="0.1"} 1' in text
        assert 'h_fmt_seconds_bucket{phase="p",le="+Inf"} 1' in text
        assert 'h_fmt_seconds_count{phase="p"} 1' in text


class TestVerbosity:
    def test_set_get_and_gate(self):
        prev = tracing.set_verbosity(3)
        try:
            assert tracing.get_verbosity() == 3
            assert tracing.v_enabled(2) and tracing.v_enabled(3)
            assert not tracing.v_enabled(4)
        finally:
            tracing.set_verbosity(prev)


class TestPhaseTracer:
    def test_trace_records_and_snapshot(self):
        reg = Registry()
        tr = tracing.PhaseTracer(reg)
        with tr.trace("phase_a"):
            pass
        snap = tr.snapshot("phase_a")
        assert snap is not None and snap["count"] == 1
        assert tr.snapshot("never") is None
        assert "kube_throttler_phase_duration_seconds" in reg.exposition()

    def test_noop_tracer(self):
        tr = tracing.NoopTracer()
        with tr.trace("x"):
            pass
        assert tr.snapshot("x") is None


class TestWiring:
    def test_plugin_phases_land_in_registry(self):
        store, plugin = _plugin()
        store.create_throttle(
            Throttle(
                name="t1",
                spec=ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(requests={"cpu": "100m"}),
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                        )
                    ),
                ),
            )
        )
        plugin.run_pending_once()
        pod = make_pod("p1", labels={"throttle": "t1"}, requests={"cpu": "50m"})
        store.create_pod(pod)
        plugin.pre_filter(pod)
        plugin.reserve(pod)
        plugin.unreserve(pod)
        for phase in ("prefilter", "reserve", "unreserve", "reconcile"):
            snap = plugin.tracer.snapshot(phase)
            assert snap is not None and snap["count"] >= 1, phase
        text = plugin.metrics_registry.exposition()
        assert 'phase="prefilter"' in text

    def test_device_check_phase(self):
        store, plugin = _plugin(use_device=True)
        store.create_throttle(
            Throttle(
                name="t1",
                spec=ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(requests={"cpu": "100m"}),
                    selector=ThrottleSelector(
                        selector_terms=(
                            ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                        )
                    ),
                ),
            )
        )
        plugin.run_pending_once()
        pod = make_pod("p1", labels={"throttle": "t1"}, requests={"cpu": "50m"})
        store.create_pod(pod)
        plugin.pre_filter(pod)
        snap = plugin.tracer.snapshot("device_check")
        assert snap is not None and snap["count"] >= 1


class TestDebugFlagsEndpoint:
    def test_put_debug_flags_v(self):
        from kube_throttler_tpu_torch.server import ThrottlerHTTPServer

        store, plugin = _plugin()
        server = ThrottlerHTTPServer(plugin, host="127.0.0.1", port=0)
        server.start()
        try:
            prev = tracing.get_verbosity()
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/debug/flags/v",
                data=b"4",
                method="PUT",
            )
            body = urllib.request.urlopen(req, timeout=5).read().decode()
            assert "verbosity to 4" in body
            assert tracing.get_verbosity() == 4
            tracing.set_verbosity(prev)
        finally:
            server.stop()
