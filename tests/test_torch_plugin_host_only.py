"""Fault (i): ``KubeThrottler(args, store, use_device=False)`` is the
host-oracle mode behind ``serve --no-device``. It must build with no
``device`` argument on a machine without CUDA, touch no torch device, and
answer ``pre_filter``, ``pre_filter_batch``, ``reserve`` and ``unreserve``
exactly as the JAX package's own host-only plugin does on one seeded
store."""

from datetime import datetime, timezone

import torch

import kube_throttler_tpu.api.serialization as jser
import kube_throttler_tpu.engine.store as jstore
import kube_throttler_tpu.plugin as jplugin
import kube_throttler_tpu.utils.clock as jclock
import kube_throttler_tpu_torch.api.serialization as tser
import kube_throttler_tpu_torch.engine.store as tstore
import kube_throttler_tpu_torch.plugin as tplugin
import kube_throttler_tpu_torch.utils.clock as tclock

from tests.conftest import normalize_reasons
from tests.torch_daemon_cases import SCHEDULER, THROTTLER, manifests, pod_keys

T0 = datetime(2026, 6, 1, tzinfo=timezone.utc)
ARGS = {"name": THROTTLER, "targetSchedulerName": SCHEDULER}


def _host_only(ser, store_mod, plugin_mod, clock_mod):
    store = store_mod.Store()
    plugin = plugin_mod.KubeThrottler(
        plugin_mod.decode_plugin_args(ARGS), store,
        clock=clock_mod.FakeClock(T0), use_device=False,
    )
    create = {
        "Namespace": store.create_namespace,
        "Throttle": store.create_throttle,
        "ClusterThrottle": store.create_cluster_throttle,
        "Pod": store.create_pod,
    }
    for d in manifests(seed=3):
        create[d["kind"]](ser.object_from_dict(d))
    plugin.run_pending_once()
    return plugin, store


def _verdicts(plugin, store):
    out = {}
    for pod in sorted(store.list_pods(), key=lambda p: p.key):
        st = plugin.pre_filter(pod)
        out[pod.key] = (st.code.name, normalize_reasons(st.reasons))
    return out


def test_host_only_plugin_builds_without_a_device(monkeypatch):
    """No device is resolved: the build succeeds even where asking for
    CUDA raises, and no CUDA call is made."""

    def no_cuda(*args, **kwargs):
        raise AssertionError("a host-only plugin must not touch CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    plugin = tplugin.KubeThrottler(
        tplugin.decode_plugin_args(ARGS), tstore.Store(), use_device=False,
    )
    try:
        assert plugin.device_manager is None
        assert plugin.pre_filter_batch() == {"schedulable": {}, "errors": []}
    finally:
        plugin.stop()


def test_host_only_answers_match_the_reference():
    ref, rstore = _host_only(jser, jstore, jplugin, jclock)
    port, pstore = _host_only(tser, tstore, tplugin, tclock)
    try:
        assert port.device_manager is None and ref.device_manager is None
        want, got = _verdicts(ref, rstore), _verdicts(port, pstore)
        assert got == want
        assert {code for code, _ in got.values()} == {"SUCCESS", "UNSCHEDULABLE_AND_UNRESOLVABLE"}
        assert port.pre_filter_batch() == ref.pre_filter_batch()

        pending = pod_keys(manifests(seed=3), pending_only=True)
        for key in pending[:12]:
            ns, _, name = key.partition("/")
            r = ref.reserve(rstore.get_pod(ns, name))
            p = port.reserve(pstore.get_pod(ns, name))
            assert (p.code.name, p.reasons) == (r.code.name, r.reasons)
        assert _verdicts(port, pstore) == _verdicts(ref, rstore)
        assert port.pre_filter_batch() == ref.pre_filter_batch()

        for key in pending[:12:3]:
            ns, _, name = key.partition("/")
            ref.unreserve(rstore.get_pod(ns, name))
            port.unreserve(pstore.get_pod(ns, name))
        assert _verdicts(port, pstore) == _verdicts(ref, rstore)
        assert port.pre_filter_batch() == ref.pre_filter_batch()
    finally:
        ref.stop()
        port.stop()

