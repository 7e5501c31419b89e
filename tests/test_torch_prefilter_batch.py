"""Port parity end to end: ``KubeThrottler.pre_filter_batch`` and per-pod
``pre_filter`` of the port (``device="cpu"``) ≡ the JAX package, on one
store decoded from the same manifest dicts by each package's own
``api/serialization``.

The store has 3 namespaces, 300 pods (bound and pending, some reserved),
40 Throttles — sparse enough that the Throttle kind takes the sparse
gather route — and 6 ClusterThrottles, which at a capacity of 16 always
take the dense route (``check_dense``). One Throttle carries an active
``temporaryThresholdOverrides`` window, resolved by the reconcile at a
fixed clock.
"""

import random
from datetime import datetime, timezone

import pytest

import kube_throttler_tpu.api.serialization as jser
import kube_throttler_tpu.engine.store as jstore
import kube_throttler_tpu.plugin as jplugin
import kube_throttler_tpu.utils.clock as jclock
import kube_throttler_tpu_torch.api.serialization as tser
import kube_throttler_tpu_torch.engine.store as tstore
import kube_throttler_tpu_torch.plugin as tplugin
import kube_throttler_tpu_torch.utils.clock as tclock

from tests.conftest import normalize_reasons

T0 = datetime(2026, 6, 1, tzinfo=timezone.utc)
NAMESPACES = (("ns-a", {"team": "red"}), ("ns-b", {"team": "blue"}), ("ns-c", {"team": "red"}))
ARGS = {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}


def _threshold(rng, scale=1):
    pick = rng.randrange(4)
    if pick == 0:
        return {"resourceCounts": {"pod": rng.randrange(4, 16) * scale}}
    if pick == 1:
        return {"resourceRequests": {"cpu": f"{rng.randrange(10, 50) * 100 * scale}m"}}
    if pick == 2:
        return {"resourceRequests": {"memory": f"{rng.randrange(6, 20) * 256 * scale}Mi"}}
    return {
        "resourceCounts": {"pod": rng.randrange(6, 20) * scale},
        "resourceRequests": {"cpu": f"{rng.randrange(20, 50) * 100 * scale}m"},
    }


def manifests(seed=0, n_pods=300):
    rng = random.Random(seed)
    out = [
        {"kind": "Namespace", "metadata": {"name": name, "labels": labels}}
        for name, labels in NAMESPACES
    ]
    for i in range(40):
        spec = {
            "throttlerName": "kube-throttler",
            "threshold": _threshold(rng),
            "selector": {"selectorTerms": [
                {"podSelector": {"matchLabels": {"app": f"a{i % 8}"}}}
            ]},
        }
        if i == 5:
            spec["temporaryThresholdOverrides"] = [{
                "begin": "2026-01-01T00:00:00Z",
                "end": "2027-01-01T00:00:00Z",
                "threshold": {"resourceRequests": {"cpu": "300m"}},
            }]
        out.append({
            "kind": "Throttle",
            "metadata": {"name": f"t{i}", "namespace": NAMESPACES[i % 3][0]},
            "spec": spec,
        })
    for j in range(6):
        out.append({
            "kind": "ClusterThrottle",
            "metadata": {"name": f"c{j}"},
            "spec": {
                "throttlerName": "kube-throttler",
                # c0-c2 roomy, c3-c5 tight
                "threshold": _threshold(rng, scale=8 if j < 3 else 1),
                "selector": {"selectorTerms": [{
                    "podSelector": {"matchLabels": {"tier": f"s{j % 3}"}},
                    "namespaceSelector": {"matchLabels": {"team": "red" if j % 2 else "blue"}},
                }]},
            },
        })
    for k in range(n_pods):
        bound = k % 4 != 0
        out.append({
            "kind": "Pod",
            "metadata": {
                "name": f"p{k}",
                "namespace": NAMESPACES[k % 3][0],
                "labels": {"app": f"a{rng.randrange(8)}", "tier": f"s{rng.randrange(3)}"},
            },
            "spec": {
                "schedulerName": "my-scheduler",
                "nodeName": "node-1" if bound else "",
                "containers": [{"name": "c", "resources": {"requests": {
                    "cpu": f"{rng.randrange(1, 6) * 100}m",
                    "memory": f"{rng.randrange(1, 5) * 128}Mi",
                }}}],
            },
            "status": {"phase": "Running" if bound else "Pending"},
        })
    return out


def build_stack(ser, store_mod, plugin_mod, clock_mod, **device):
    """One package's served stack over the manifests: store → device
    mirror → controllers, reconciled, with every 20th pending pod
    reserved."""
    store = store_mod.Store()
    plugin = plugin_mod.KubeThrottler(
        plugin_mod.decode_plugin_args(ARGS), store,
        clock=clock_mod.FakeClock(T0), use_device=True, **device,
    )
    create = {
        "Namespace": store.create_namespace,
        "Throttle": store.create_throttle,
        "ClusterThrottle": store.create_cluster_throttle,
        "Pod": store.create_pod,
    }
    for d in manifests():
        create[d["kind"]](ser.object_from_dict(d))
    plugin.run_pending_once()
    for pod in sorted(plugin.listers.pods.list(), key=lambda p: p.key):
        if not pod.spec.node_name and int(pod.name[1:]) % 20 == 0:
            assert plugin.reserve(pod).code.name == "SUCCESS"
    plugin.run_pending_once()
    return plugin


def _stacks():
    ref = build_stack(jser, jstore, jplugin, jclock)
    port = build_stack(tser, tstore, tplugin, tclock, device="cpu")
    return ref, port


def _host_oracle(plugin):
    out = {}
    for pod in plugin.listers.pods.list():
        ta, ti, te, _ = plugin.throttle_ctr.check_throttled(pod, False)
        ca, ci, ce, _ = plugin.cluster_throttle_ctr.check_throttled(pod, False)
        out[pod.key] = not (ta or ti or te or ca or ci or ce)
    return out


def _statuses(plugin):
    out = {}
    for pod in plugin.listers.pods.list():
        st = plugin.pre_filter(pod)
        out[pod.key] = (st.code.name, normalize_reasons(st.reasons))
    return out


def test_batch_and_per_pod_match_reference_on_both_routes(monkeypatch):
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    ref, port = _stacks()
    assert port.verdict_cache is None and ref.verdict_cache is None

    want = ref.pre_filter_batch()
    got = port.pre_filter_batch()
    assert got["errors"] == want["errors"] == []
    assert got["schedulable"] == want["schedulable"]
    assert got["schedulable"] == _host_oracle(port)
    verdicts = set(got["schedulable"].values())
    assert verdicts == {True, False}

    # each kind took the expected route, in both packages
    assert port.device_manager.last_batch_routes == {
        "throttle": "sparse", "clusterthrottle": "dense",
    }
    assert ref.device_manager.throttle.device_cols() is not None
    assert ref.device_manager.clusterthrottle.device_cols() is None
    assert port.device_manager.breaker_state() == "closed"

    want_st, got_st = _statuses(ref), _statuses(port)
    assert got_st == want_st
    reasons = " ".join(r for _, rs in got_st.values() for r in rs)
    for needle in ("clusterthrottle[", "throttle[active]", "insufficient"):
        assert needle in reasons


def test_batch_matches_reference_with_verdict_cache(monkeypatch):
    monkeypatch.setenv("KT_VERDICT_CACHE", "1")
    ref, port = _stacks()
    assert port.verdict_cache is not None
    for _ in range(2):  # cold, then warm cache
        want = ref.pre_filter_batch()
        got = port.pre_filter_batch()
        assert got == want
    assert _statuses(port) == _statuses(ref)


def test_port_plugin_needs_an_explicit_device_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tplugin.KubeThrottler(tplugin.decode_plugin_args(ARGS), tstore.Store())


@pytest.mark.parametrize("failure", ["kernel_launch", "device_outage"])
def test_dense_dispatch_failure(monkeypatch, failure):
    """A dense kernel that fails to launch raises out of pre_filter_batch
    with the breaker closed: the batch is never served from the host. Any
    other dispatch failure still opens the breaker and the host oracle
    answers."""
    from kube_throttler_tpu_torch.ops import check_dense as cd

    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    port = build_stack(tser, tstore, tplugin, tclock, device="cpu")
    exc = (cd.KernelLaunchError("check_dense kernel launch failed: cudaError 9")
           if failure == "kernel_launch" else RuntimeError("device lost"))

    def failing(*args, **kwargs):
        raise exc

    monkeypatch.setattr(cd, "check_dense", failing)
    if failure == "kernel_launch":
        with pytest.raises(cd.KernelLaunchError, match="cudaError 9"):
            port.pre_filter_batch()
        assert port.device_manager.breaker_state() == "closed"
    else:
        out = port.pre_filter_batch()
        assert out["schedulable"] == _host_oracle(port)
        assert port.device_manager.breaker_state() == "open"


def test_unported_paths_raise(monkeypatch):
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    port = build_stack(tser, tstore, tplugin, tclock, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        port.full_tick_sharded()
    pods = [p for p in port.listers.pods.list() if not p.spec.node_name][:2]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        port.pre_filter_gang("g", pods)
    # an unported path is not a device failure: the breaker stays closed
    assert port.device_manager.breaker_state() == "closed"
