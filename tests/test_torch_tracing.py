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
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
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


def _kinds_plugin(use_device=True):
    """A device-backed plugin (on the CPU) over both kinds: 4 namespaces
    labelled ``team`` and ``env``, 8 pods each (6 Running and bound), one
    Throttle a namespace (ns-0's holds 3 pods, so its pods are blocked),
    and 24 ClusterThrottles of two OR-ed terms, ``namespaceSelector`` ∧
    ``podSelector`` then ``namespaceSelector`` alone (c0 and c1 hold a
    1-cpu threshold, the rest are open). A pod matches at most 4 of them,
    so the kind takes the gather route. One pod lies in a namespace with
    no Namespace object."""
    store, plugin = _plugin(use_device=use_device)
    for n in range(4):
        store.create_namespace(
            Namespace(f"ns-{n}", labels={"team": f"team-{n}", "env": f"env-{n % 2}"})
        )
        store.create_throttle(
            Throttle(
                name="t",
                namespace=f"ns-{n}",
                spec=ThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(pod=3 if n == 0 else 1000),
                    selector=ThrottleSelector(
                        selector_terms=(ThrottleSelectorTerm(LabelSelector()),)
                    ),
                ),
            )
        )
    for c in range(24):
        store.create_cluster_throttle(
            ClusterThrottle(
                name=f"c{c}",
                spec=ClusterThrottleSpec(
                    throttler_name="kube-throttler",
                    threshold=ResourceAmount.of(
                        requests={"cpu": "1" if c < 2 else "1000"}
                    ),
                    selector=ClusterThrottleSelector(
                        selector_terms=(
                            ClusterThrottleSelectorTerm(
                                pod_selector=LabelSelector(
                                    match_labels={"tier": f"tier-{c // 4}"}
                                ),
                                namespace_selector=LabelSelector(
                                    match_labels={"team": f"team-{c % 4}"}
                                ),
                            ),
                            ClusterThrottleSelectorTerm(
                                namespace_selector=LabelSelector(
                                    match_labels={"team": f"team-{c % 4}",
                                                  "env": f"env-{c // 12}"}
                                ),
                            ),
                        )
                    ),
                ),
            )
        )
    for n in range(4):
        for i in range(8):
            running = i < 6
            store.create_pod(
                make_pod(
                    f"p{i}", namespace=f"ns-{n}", labels={"tier": f"tier-{i % 4}"},
                    requests={"cpu": f"{100 * (i + 1)}m"},
                    node_name="node-0" if running else "",
                    phase="Running" if running else "Pending",
                )
            )
    store.create_pod(make_pod("stray", namespace="ns-gone", requests={"cpu": "1m"}))
    plugin.run_pending_once()
    return store, plugin


@pytest.fixture
def kinds(monkeypatch):
    """``_kinds_plugin``'s plugin with the dedupe probe declining, so the
    batch takes the device dispatch and the merge."""
    monkeypatch.setattr(KubeThrottler, "BATCH_DEDUPE_MAX_PODS", 0)
    _, plugin = _kinds_plugin()
    yield plugin
    plugin.stop()


def _spans(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name]


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def _kind_verdicts(plugin):
    """{kind: (schedulable bool[] over the row map's pods)} of a fresh
    ``check_batch_all`` on the same state."""
    import numpy as np

    out = {}
    for kind, (_, ok, rows) in plugin.device_manager.check_batch_all(False).items():
        out[kind] = ok.cpu().numpy()[np.fromiter(rows.values(), dtype=np.int64)]
    return out


MERGE_SPANS = ("merge_throttle", "merge_clusterthrottle", "merge_ns_route")
LAUNCH_SPANS = ("launch_throttle", "launch_clusterthrottle")


class TestBatchKindSpans:
    def test_merge_spans_nest_in_batch_merge(self, kinds, tmp_path):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = kinds.pre_filter_batch()
        assert out["errors"] == ["ns-gone/stray"]
        events = _profiled(prof, tmp_path)
        (merge,) = _spans(events, "batch_merge")
        for name in MERGE_SPANS:
            (span,) = _spans(events, name)
            assert _inside(span, merge), name
        total = sum(kinds.tracer.snapshot(name)["sum"] for name in MERGE_SPANS)
        assert total <= kinds.tracer.snapshot("batch_merge")["sum"]

    def test_launch_spans_nest_in_batch_dispatch(self, kinds, tmp_path):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            kinds.pre_filter_batch()
        events = _profiled(prof, tmp_path)
        (dispatch,) = _spans(events, "batch_dispatch")
        for name in LAUNCH_SPANS:
            (span,) = _spans(events, name)
            assert _inside(span, dispatch), name
            assert _count(kinds, name) == 1

    def test_merge_spans_under_the_full_tick(self, kinds, tmp_path):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = kinds.full_tick_sharded(1)
        assert out["errors"] == ["ns-gone/stray"]
        events = _profiled(prof, tmp_path)
        (tick,) = _spans(events, "full_tick")
        assert not _spans(events, "batch_merge")
        for name in MERGE_SPANS:
            (span,) = _spans(events, name)
            assert _inside(span, tick), name

    def test_batch_handles_wraps_the_row_table_grab(self, kinds, tmp_path, monkeypatch):
        """Each kind's row table is taken inside ``batch_handles``, on a
        call that builds it (a pod came in) and on one that reuses it."""
        from kube_throttler_tpu_torch.engine.index import SelectorIndex

        grab = SelectorIndex.pod_row_table

        def marked(index):
            with torch.profiler.record_function(f"row_table_{index.kind}"):
                return grab(index)

        monkeypatch.setattr(SelectorIndex, "pod_row_table", marked)
        kinds.pre_filter_batch()
        kinds.store.create_pod(make_pod("late", namespace="ns-1", requests={"cpu": "1m"}))
        builds = kinds.device_manager.row_table_build_counter
        before = {key[0]: v for key, v in builds.collect().items()}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            kinds.pre_filter_batch()
            kinds.pre_filter_batch()
        events = _profiled(prof, tmp_path)
        after = {key[0]: v for key, v in builds.collect().items()}
        assert after == {kind: n + 1 for kind, n in before.items()}
        handles = _spans(events, "batch_handles")
        assert len(handles) == 2
        for kind in ("throttle", "clusterthrottle"):
            grabs = _spans(events, f"row_table_{kind}")
            assert len(grabs) == 2
            for g, h in zip(sorted(grabs), sorted(handles)):
                assert _inside(g, h), kind

    def test_blocked_pods_count_each_kinds_false_verdicts(self, kinds):
        kinds.pre_filter_batch()
        got = {key[0]: v for key, v in kinds.batch_blocked_pods.collect().items()}
        want = {kind: int((~ok).sum()) for kind, ok in _kind_verdicts(kinds).items()}
        assert got == want
        assert want["throttle"] > 0 and want["clusterthrottle"] > 0
        kinds.pre_filter_batch()
        got = {key[0]: v for key, v in kinds.batch_blocked_pods.collect().items()}
        assert got == {kind: 2 * n for kind, n in want.items()}

    @pytest.mark.parametrize("registry", ["plugin", "none"])
    def test_route_counter_and_width_gauge(self, kinds, registry):
        if registry == "none":
            # a mirror built with no registry runs the batch, registers no
            # family and counts nothing into the plugin's
            from kube_throttler_tpu_torch.engine.devicestate import DeviceStateManager

            dm = DeviceStateManager(
                kinds.store, kinds.args.name, kinds.args.target_scheduler_name,
                device="cpu",
            )
            assert dm.batch_route_counter is None and dm.batch_width_gauge is None
            assert dm.row_table_build_counter is None
            assert dm.throttle.index.row_table_build_counter is None
            assert dm.clusterthrottle.index.row_table_build_counter is None
            families = (
                kinds.device_manager.batch_route_counter,
                kinds.device_manager.batch_width_gauge,
                kinds.device_manager.row_table_build_counter,
            )
            before = [f.collect() for f in families]
            out = dm.check_batch_all(False)
            assert set(out) == set(dm.last_batch_routes) == {"throttle", "clusterthrottle"}
            assert dm.last_batch_routes["clusterthrottle"] == "sparse"
            assert [f.collect() for f in families] == before
            return
        kinds.pre_filter_batch()
        dm = kinds.device_manager
        routes = {key: v for key, v in dm.batch_route_counter.collect().items()}
        assert routes == {(kind, route): 1 for kind, route in dm.last_batch_routes.items()}
        assert dm.last_batch_routes["clusterthrottle"] == "sparse"
        widths = {key[0]: v for key, v in dm.batch_width_gauge.collect().items()}
        for kind in ("throttle", "clusterthrottle"):
            ks = getattr(dm, kind)
            assert widths[kind] == (ks._cols_K if ks.device_cols() is not None else 0)
        assert widths["clusterthrottle"] >= 4

    def test_families_in_the_exposition(self, kinds):
        kinds.pre_filter_batch()
        text = kinds.metrics_registry.exposition()
        for kind in ("throttle", "clusterthrottle"):
            assert f'kube_throttler_batch_blocked_pods_total{{kind="{kind}"}}' in text
            assert f'kube_throttler_batch_match_width{{kind="{kind}"}}' in text
        assert 'kube_throttler_batch_route_total{kind="clusterthrottle",route="sparse"} 1' in text
        for kind in ("throttle", "clusterthrottle"):
            assert f'kube_throttler_pod_row_table_builds_total{{kind="{kind}"}}' in text

    def test_verdicts_are_the_same_with_the_tracer_on_and_off(self, kinds):
        traced = kinds.pre_filter_batch()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiled = kinds.pre_filter_batch()
        kinds.tracer = kinds.device_manager.tracer = tracing.NoopTracer()
        untraced = kinds.pre_filter_batch()
        assert traced == profiled == untraced
        assert kinds.tracer.snapshot("batch_merge") is None
        sched = traced["schedulable"]
        assert len(sched) == 32 and 0 < sum(sched.values()) < 32

    def test_device_verdicts_equal_the_host_oracle(self, kinds):
        _, host = _kinds_plugin(use_device=False)
        try:
            assert kinds.pre_filter_batch() == host.pre_filter_batch()
        finally:
            host.stop()


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
