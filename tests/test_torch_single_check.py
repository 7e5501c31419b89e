"""The port's single-pod device route and the coalescer's multi check
(``device="cpu"``), held against the host tiers and the JAX package.

Counterparts of ``tests/test_check_kernel.py::
test_host_single_check_matches_device_kernel`` and
``tests/test_concurrent_check.py::TestPreFilterCoalescer::
test_check_pods_multi_matches_check_pod``:

- ``check_pod`` on the host route (native C++, then numpy) ≡ the device
  route (``fast_check_pod_packed``) ≡ the JAX package's ``check_pod``;
- ``check_pods_multi`` on each route ≡ ``check_pod``. Its device route is
  ``check_pods_gather_statuses``, the statuses form of the ``check_gather``
  kernel's wrapper;
- on the two-route store of ``tests/test_torch_prefilter_batch.py`` with
  ``KT_SINGLE_CHECK_DEVICE=1``, ``check_pod`` and ``check_pods_multi`` ≡
  the JAX package for every pod, both kinds and both onEqual values, also
  when a pending pod in the middle of the batch carries 12 new extended
  resources that grow R from 8 to 16; ``pre_filter_batch`` still matches
  afterwards.
"""

import random
from dataclasses import replace

import pytest

import kube_throttler_tpu.api.pod as jpod
import kube_throttler_tpu.api.serialization as jser
import kube_throttler_tpu.api.types as jtypes
import kube_throttler_tpu.engine.store as jstore
import kube_throttler_tpu.plugin as jplugin
import kube_throttler_tpu.utils.clock as jclock
import kube_throttler_tpu_torch.api.pod as tpod
import kube_throttler_tpu_torch.api.serialization as tser
import kube_throttler_tpu_torch.api.types as ttypes
import kube_throttler_tpu_torch.engine.store as tstore
import kube_throttler_tpu_torch.plugin as tplugin
import kube_throttler_tpu_torch.utils.clock as tclock
from kube_throttler_tpu_torch.engine import devicestate as tds
from kube_throttler_tpu_torch.ops import check_gather as cg

from tests.test_torch_prefilter_batch import build_stack

ARGS = {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
PKGS = {
    "ref": (jpod, jtypes, jstore, jplugin, {}),
    "port": (tpod, ttypes, tstore, tplugin, {"device": "cpu"}),
}
KINDS = ("throttle", "clusterthrottle")


def _stack(pkg, seed, n_thr, n_pods, groups, memory):
    """One package's store of ``n_thr`` Throttles over ``groups`` label
    groups and ``n_pods`` running pods (cpu, and memory when ``memory``),
    reconciled; the same objects in either package for one seed."""
    pod_mod, types, store_mod, plugin_mod, kw = PKGS[pkg]
    rng = random.Random(seed)
    store = store_mod.Store()
    store.create_namespace(pod_mod.Namespace("default"))
    plugin = plugin_mod.KubeThrottler(plugin_mod.decode_plugin_args(ARGS), store,
                                      use_device=True, **kw)
    for i in range(n_thr):
        requests = {"cpu": f"{rng.randrange(1, 9) * 100}m"}
        if memory:
            requests["memory"] = f"{rng.randrange(1, 5)}Gi"
        store.create_throttle(types.Throttle(
            name=f"t{i}", namespace="default",
            spec=types.ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=types.ResourceAmount.of(
                    pod=rng.choice([None, 1, 2, 5] if memory else [None, 1, 3]),
                    requests=requests),
                selector=types.ThrottleSelector(selector_terms=(types.ThrottleSelectorTerm(
                    types.LabelSelector(match_labels={"grp": f"g{i % groups}"})),)),
            ),
        ))
    for i in range(n_pods):
        requests = {"cpu": f"{rng.randrange(1, 6) * 100}m"}
        if memory:
            requests["memory"] = f"{rng.randrange(1, 3)}Gi"
        p = pod_mod.make_pod(f"p{i}", namespace="default",
                             labels={"grp": f"g{rng.randrange(groups)}"}, requests=requests)
        p = replace(p, spec=replace(p.spec, node_name="n1"))
        p.status.phase = "Running"
        store.create_pod(p)
    plugin.run_pending_once()
    return plugin, rng


def _probes(pod_mod, rng, n, groups):
    return [pod_mod.make_pod(f"probe{i}", namespace="default", labels={"grp": f"g{i % groups}"},
                             requests={"cpu": f"{rng.randrange(1, 9) * 100}m"})
            for i in range(n)]


@pytest.fixture
def numpy_tier():
    """Run the body with the native host tier unloaded (the numpy tier)."""
    old = (tds._cls_lib, tds._cls_lib_tried)
    tds._cls_lib, tds._cls_lib_tried = None, True
    yield
    tds._cls_lib, tds._cls_lib_tried = old


@pytest.mark.parametrize("on_equal", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_host_single_check_matches_device_route(kind, on_equal):
    """check_pod's host route ≡ its device route ≡ the JAX package's
    check_pod, on randomized live state (40 Throttles, 120 pods, cpu and
    memory)."""
    want, ref_rng = _stack("ref", 23, 40, 120, 5, memory=True)
    port, rng = _stack("port", 23, 40, 120, 5, memory=True)
    dm = port.device_manager
    probes, jprobes = _probes(tpod, rng, 24, 5), _probes(jpod, ref_rng, 24, 5)
    for p, jp in zip(probes, jprobes):
        dm._single_check_device = False
        host = dm.check_pod(p, kind, on_equal)
        dm._single_check_device = True
        dev = dm.check_pod(p, kind, on_equal)
        assert host == dev == want.device_manager.check_pod(jp, kind, on_equal), p.name
    assert dm.breaker_state() == "closed"


def test_host_tiers_agree(numpy_tier):
    """The numpy host tier ≡ the native one (when it loads) ≡ the device
    route."""
    port, rng = _stack("port", 23, 40, 120, 5, memory=True)
    dm = port.device_manager
    probes = _probes(tpod, rng, 24, 5)
    dm._single_check_device = False
    numpy_res = [dm.check_pod(p, k, oe) for oe in (False, True) for k in KINDS for p in probes]
    dm._single_check_device = True
    device_res = [dm.check_pod(p, k, oe) for oe in (False, True) for k in KINDS for p in probes]
    assert numpy_res == device_res
    assert any(v != "not-throttled" for res in numpy_res for v in res.values())


@pytest.mark.parametrize("forced_device", [False, True])
def test_check_pods_multi_matches_check_pod(forced_device, monkeypatch):
    """Both routes of the multi check pinned against check_pod; the device
    route goes through the gather wrapper's statuses form once per kind."""
    port, rng = _stack("port", 11, 24, 60, 6, memory=False)
    dm = port.device_manager
    probes = _probes(tpod, rng, 13, 6)
    dm._single_check_device = forced_device
    calls = []
    real = cg.check_gather_reference

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(cg, "check_gather_reference", spy)
    for kind in KINDS:
        multi = dm.check_pods_multi(probes, kind)
        for pod, got in zip(probes, multi):
            assert got == dm.check_pod(pod, kind), (forced_device, kind, pod.name)
    assert calls == ([True, True] if forced_device else [])


def test_check_pods_multi_numpy_tier_matches_check_pod(numpy_tier):
    port, rng = _stack("port", 11, 24, 60, 6, memory=False)
    dm = port.device_manager
    probes = _probes(tpod, rng, 13, 6)
    dm._single_check_device = False
    for kind in KINDS:
        multi = dm.check_pods_multi(probes, kind)
        for pod, got in zip(probes, multi):
            assert got == dm.check_pod(pod, kind), ("numpy", kind, pod.name)


def _grow_pod(pod_mod):
    """A pending pod requesting 12 extended resources no object has named."""
    return pod_mod.make_pod(
        "grow", namespace="ns-a", labels={"app": "a1", "tier": "s1"},
        requests={"cpu": "100m", **{f"example.com/dev{i}": "1" for i in range(12)}},
    )


@pytest.mark.parametrize("on_equal", [False, True])
def test_two_route_store_device_route_matches_reference(on_equal, monkeypatch):
    """KT_SINGLE_CHECK_DEVICE=1 on the two-route store: check_pod and
    check_pods_multi ≡ the JAX package for all 300 pods and both kinds; a
    pod in the middle of the batch grows R from 8 to 16 mid-batch, and
    pre_filter_batch still matches afterwards."""
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    monkeypatch.setenv("KT_SINGLE_CHECK_DEVICE", "1")
    ref = build_stack(jser, jstore, jplugin, jclock)
    port = build_stack(tser, tstore, tplugin, tclock, device="cpu")
    rdm, pdm = ref.device_manager, port.device_manager

    def by_key(plugin):
        return sorted(plugin.listers.pods.list(), key=lambda p: p.key)

    rpods, ppods = by_key(ref), by_key(port)
    assert [p.key for p in rpods] == [p.key for p in ppods] and len(ppods) == 300
    for kind in KINDS:
        want = rdm.check_pods_multi(rpods, kind, on_equal)
        assert pdm.check_pods_multi(ppods, kind, on_equal) == want, kind
        assert [pdm.check_pod(p, kind, on_equal) for p in ppods] == want, kind
        assert any(want), kind
    assert pdm._single_check_device is True

    assert pdm.throttle.R == 8
    mid = len(ppods) // 2
    for kind in KINDS:
        want = rdm.check_pods_multi(rpods[:mid] + [_grow_pod(jpod)] + rpods[mid:], kind, on_equal)
        got = pdm.check_pods_multi(ppods[:mid] + [_grow_pod(tpod)] + ppods[mid:], kind, on_equal)
        assert got == want, kind
        assert pdm._kind(kind).R == 16
    assert port.pre_filter_batch() == ref.pre_filter_batch()
    ref.stop()
    port.stop()
