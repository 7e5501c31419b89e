"""Tracing/profiling subsystem (SURVEY §5 TPU-native equivalent): phase
histograms through the metrics registry, klog-style verbosity, the
/debug/flags/v endpoint, tracer wiring through plugin/controllers, the
spans as profiler annotations while a ``torch.profiler`` session records,
and the batch-triage surfaces' spans and counters."""

import json
import urllib.request

import pytest
import torch

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


def _annotations(path):
    """The user annotations of a Chrome trace file."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    return [e for e in events if e.get("cat") == "user_annotation"]


def _profiled(prof, tmp_path):
    """The user annotations of a stopped profiler's Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return _annotations(path)


def _triage_plugin(pods=1):
    """A device-backed plugin (on the CPU) with one Throttle selecting
    ``pods`` pods, reconciled."""
    store, plugin = _plugin(use_device=True)
    store.create_throttle(
        Throttle(
            name="t1",
            spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(requests={"cpu": "100"}),
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels={"throttle": "t1"})),
                    )
                ),
            ),
        )
    )
    for i in range(pods):
        # a distinct request each, so no two pods share a verdict fingerprint
        store.create_pod(make_pod(f"p{i}", labels={"throttle": "t1"},
                                  requests={"cpu": f"{i + 1}m"}))
    plugin.run_pending_once()
    return store, plugin


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

    def test_no_annotation_object_without_a_profiler(self, monkeypatch):
        made = []

        def counting(name):
            made.append(name)
            return torch.autograd.profiler.record_function(name)

        monkeypatch.setattr(tracing, "record_function", counting)
        tr = tracing.PhaseTracer(Registry())
        span = tr.trace("quiet")
        with span:
            pass
        assert made == [] and span._note is None
        assert tr.snapshot("quiet")["count"] == 1
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tr.trace("loud"):
                pass
        assert made == ["loud"]

    def test_spans_nest_as_annotations(self, tmp_path):
        tr = tracing.PhaseTracer(Registry())
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tr.trace("outer"):
                with tr.trace("inner"):
                    pass
        spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in _profiled(prof, tmp_path)}
        (o0, o1), (i0, i1) = spans["outer"], spans["inner"]
        assert o0 <= i0 <= i1 <= o1
        assert tr.snapshot("outer")["count"] == tr.snapshot("inner")["count"] == 1


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


class TestTriageSpans:
    def test_a_profiled_batch_holds_the_program_spans(self, tmp_path):
        _, plugin = _triage_plugin()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = plugin.pre_filter_batch()
        assert out["schedulable"] == {"default/p0": True}
        names = [e["name"] for e in _profiled(prof, tmp_path)]
        for phase in ("prefilter_batch", "batch_dedupe", "list_pods"):
            assert phase in names, phase

    def test_batch_handles_when_the_probe_declines(self, monkeypatch):
        from kube_throttler_tpu_torch.plugin import KubeThrottler

        _, plugin = _triage_plugin()
        monkeypatch.setattr(KubeThrottler, "BATCH_DEDUPE_MAX_PODS", 0)
        out = plugin.pre_filter_batch()
        assert out["schedulable"] == {"default/p0": True}
        for phase in ("batch_dedupe", "batch_dispatch", "batch_handles"):
            assert _count(plugin, phase) == 1, phase
        assert _count(plugin, "list_pods") == 0  # the size gate reads the count
        assert (plugin.tracer.snapshot("batch_handles")["sum"]
                <= plugin.tracer.snapshot("batch_dispatch")["sum"])

    def test_device_trace_writes_the_program_spans(self, tmp_path):
        _, plugin = _triage_plugin()
        with tracing.device_trace(str(tmp_path)):
            plugin.pre_filter_batch()
        (path,) = tmp_path.glob("trace-*.json")
        names = {e["name"] for e in _annotations(path)}
        assert {"prefilter_batch", "batch_dedupe", "list_pods"} <= names


def _outcomes(plugin):
    return {key[0]: value for key, value in plugin.dedupe_outcomes.collect().items()}


def _count(plugin, phase):
    snap = plugin.tracer.snapshot(phase)
    return 0 if snap is None else snap["count"]


def _count_pod_reads(plugin, monkeypatch):
    """Count the pod indexer's listings and its resolver's calls."""
    indexer = plugin.listers.pods._indexer
    calls = {"list": 0, "resolve": 0}
    listing = indexer.list

    def counting_list():
        calls["list"] += 1
        return listing()

    monkeypatch.setattr(indexer, "list", counting_list)
    if indexer._resolver is not None:
        resolve = indexer._resolver

        def counting_resolve(key):
            calls["resolve"] += 1
            return resolve(key)

        monkeypatch.setattr(indexer, "_resolver", counting_resolve)
    return calls


class TestDedupeOutcomes:
    def test_served(self):
        _, plugin = _triage_plugin()
        plugin.pre_filter_batch()
        plugin.pre_filter_batch()
        assert _outcomes(plugin) == {"served": 2}

    def test_declined_size(self, monkeypatch):
        from kube_throttler_tpu_torch.plugin import KubeThrottler

        _, plugin = _triage_plugin()
        monkeypatch.setattr(KubeThrottler, "BATCH_DEDUPE_MAX_PODS", 0)
        plugin.pre_filter_batch()
        assert _outcomes(plugin) == {"declined_size": 1}

    def test_declined_size_lists_no_pod(self, monkeypatch):
        from kube_throttler_tpu_torch.plugin import KubeThrottler

        _, plugin = _triage_plugin(pods=3)
        calls = _count_pod_reads(plugin, monkeypatch)
        monkeypatch.setattr(KubeThrottler, "BATCH_DEDUPE_MAX_PODS", 0)
        out = plugin.pre_filter_batch()
        assert len(out["schedulable"]) == 3
        assert _outcomes(plugin) == {"declined_size": 1}
        assert calls == {"list": 0, "resolve": 0}
        assert _count(plugin, "list_pods") == 0
        assert _count(plugin, "batch_dispatch") == 1

    def test_declined_size_when_the_listing_outgrows_the_count(self, monkeypatch):
        """Pods created between the gate's count and the listing: the
        listing's own length still declines the probe."""
        from kube_throttler_tpu_torch.plugin import KubeThrottler

        _, plugin = _triage_plugin(pods=3)
        monkeypatch.setattr(KubeThrottler, "BATCH_DEDUPE_MAX_PODS", 2)
        monkeypatch.setattr(plugin.listers.pods, "count", lambda: 0)
        out = plugin.pre_filter_batch()
        assert len(out["schedulable"]) == 3
        assert _outcomes(plugin) == {"declined_size": 1}
        assert _count(plugin, "list_pods") == 1 and _count(plugin, "batch_dispatch") == 1

    def test_served_lists_once(self, monkeypatch):
        _, plugin = _triage_plugin(pods=3)
        calls = _count_pod_reads(plugin, monkeypatch)
        out = plugin.pre_filter_batch()
        assert len(out["schedulable"]) == 3
        assert _outcomes(plugin) == {"served": 1}
        assert calls["list"] == 1 and _count(plugin, "list_pods") == 1
        assert calls["resolve"] == (3 if plugin.store.columnar else 0)
        assert _count(plugin, "batch_dispatch") == 0

    @pytest.mark.parametrize("pods", [1, 300])
    def test_either_route_gives_the_same_verdicts(self, pods, monkeypatch):
        from kube_throttler_tpu_torch.plugin import KubeThrottler

        _, plugin = _triage_plugin(pods=pods)
        by_default = plugin.pre_filter_batch()
        monkeypatch.setattr(KubeThrottler, "BATCH_DEDUPE_MAX_PODS", 0)
        gated = plugin.pre_filter_batch()
        assert _outcomes(plugin)["declined_size"] == 1
        assert len(gated["schedulable"]) == pods
        assert gated["schedulable"] == by_default["schedulable"]
        assert sorted(gated["errors"]) == sorted(by_default["errors"])

    def test_declined_mix(self):
        _, plugin = _triage_plugin(pods=300)
        out = plugin.pre_filter_batch()
        assert len(out["schedulable"]) == 300
        assert _outcomes(plugin) == {"declined_mix": 1}
        assert plugin.tracer.snapshot("batch_handles")["count"] == 1

    def test_no_probe_without_a_device(self):
        store, plugin = _plugin()
        store.create_pod(make_pod("p0", requests={"cpu": "1m"}))
        out = plugin.pre_filter_batch()
        assert out["schedulable"] == {"default/p0": True}
        assert _outcomes(plugin) == {}
        assert plugin.tracer.snapshot("list_pods")["count"] == 1  # the host oracle's

    def test_families_in_the_exposition(self):
        _, plugin = _triage_plugin()
        plugin.pre_filter_batch()
        text = plugin.metrics_registry.exposition()
        assert 'kube_throttler_batch_dedupe_total{outcome="served"} 1' in text
        assert "# TYPE kube_throttler_gc_pause_seconds_total counter" in text
        assert "# TYPE kube_throttler_gc_collections_total counter" in text
        for gen in range(3):
            assert f'kube_throttler_gc_pause_seconds_total{{generation="{gen}"}}' in text
            assert f'kube_throttler_gc_collections_total{{generation="{gen}"}}' in text


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
