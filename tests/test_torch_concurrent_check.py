"""Hot-path concurrency: check_pod readers must not serialize on the
device-state lock (the reference keeps PreFilter
concurrent via RWMutex + hashed keymutexes,
reserved_resource_amounts.go:154-170; here the lock covers only the
host-side snapshot grab and the kernel runs on immutable device handles).

Correctness under churn: concurrent checkers race a writer that keeps
mutating pods/throttles; every verdict must be internally valid and the
final quiesced state must match the host oracle.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.ops.check import STATUS_NAMES
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


def _stack():
    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True,
        device="cpu",
    )
    store.create_namespace(Namespace("default"))
    return store, plugin


def _assert_device_matches_oracle(store, plugin, probe):
    """Quiescence check shared by the race tests: the device path's blocked
    verdicts for ``probe`` must equal the pure oracle's over the live
    throttle set."""
    device = plugin.device_manager.check_pod(probe, "throttle", False)
    ctr = plugin.throttle_ctr
    oracle = {}
    for thr in store.list_throttles():
        if not thr.spec.selector.matches_to_pod(probe):
            continue
        reserved, _ = ctr.cache.reserved_resource_amount(thr.key)
        status = thr.check_throttled_for(probe, reserved, False)
        if status != "not-throttled":
            oracle[thr.key] = status
    device_blocked = {k: v for k, v in device.items() if v != "not-throttled"}
    assert device_blocked == oracle


class TestConcurrentCheck:
    def test_readers_race_writer_without_torn_state(self):
        store, plugin = _stack()
        dm = plugin.device_manager
        for i in range(16):
            store.create_throttle(
                _throttle(f"t{i}", {"grp": f"g{i % 4}"}, pod=3, requests={"cpu": "1"})
            )
        for i in range(32):
            store.create_pod(
                _bound(
                    make_pod(f"p{i}", labels={"grp": f"g{i % 4}"}, requests={"cpu": "100m"})
                )
            )
        plugin.run_pending_once()

        stop = threading.Event()
        errors: list = []
        checks = [0]
        valid_names = set(STATUS_NAMES.values())

        def reader(tid: int) -> None:
            probe = make_pod(f"probe{tid}", labels={"grp": f"g{tid % 4}"}, requests={"cpu": "200m"})
            n = 0
            while not stop.is_set():
                try:
                    result = dm.check_pod(probe, "throttle", False)
                    assert all(v in valid_names for v in result.values()), result
                    # the probe matches exactly the 4 throttles of its group
                    assert all(k.startswith("default/t") for k in result), result
                    n += 1
                except Exception as e:  # noqa: BLE001 — collected for the assert
                    errors.append(e)
                    return
            checks[0] += n

        def writer() -> None:
            i = 0
            while not stop.is_set():
                i += 1
                pod = _bound(
                    make_pod(
                        f"p{i % 32}",
                        labels={"grp": f"g{i % 4}"},
                        requests={"cpu": f"{100 + (i % 5) * 50}m"},
                    )
                )
                try:
                    store.update_pod(pod)
                    if i % 7 == 0:
                        store.update_throttle(
                            _throttle(
                                f"t{i % 16}",
                                {"grp": f"g{i % 4}"},
                                pod=3 + i % 3,
                                requests={"cpu": "1"},
                            )
                        )
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return

        threads = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
        wt = threading.Thread(target=writer)
        for t in threads:
            t.start()
        wt.start()
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        wt.join(timeout=10)
        assert not errors, errors[:3]
        assert checks[0] > 0

        # quiesce and diff the device path against the host oracle
        plugin.run_pending_once()
        probe = make_pod("probe-final", labels={"grp": "g1"}, requests={"cpu": "200m"})
        _assert_device_matches_oracle(store, plugin, probe)

    def test_readers_race_capacity_growth(self):
        """Readers race a writer that CREATES throttles continuously, so
        the tcap ladder grows and the staging planes REALLOCATE mid-
        flight. This specifically exercises the native classifier's plane
        re-registration (devicestate._native_classify_cols identity check
        swaps the C-side handle under the main lock) against concurrent
        check_pod callers — a stale handle would read freed memory, a
        missed re-registration would classify against dead arrays.
        Correctness is pinned by the oracle diff at quiescence."""
        store, plugin = _stack()
        dm = plugin.device_manager
        for i in range(4):
            store.create_throttle(
                _throttle(f"t{i}", {"grp": f"g{i % 4}"}, pod=3, requests={"cpu": "1"})
            )
        for i in range(16):
            store.create_pod(
                _bound(
                    make_pod(f"p{i}", labels={"grp": f"g{i % 4}"}, requests={"cpu": "100m"})
                )
            )
        plugin.run_pending_once()

        stop = threading.Event()
        errors: list = []
        valid_names = set(STATUS_NAMES.values())
        checks = [0]

        def reader(tid: int) -> None:
            probe = make_pod(
                f"probe{tid}", labels={"grp": f"g{tid % 4}"}, requests={"cpu": "200m"}
            )
            n = 0
            while not stop.is_set():
                try:
                    result = dm.check_pod(probe, "throttle", False)
                    assert all(v in valid_names for v in result.values()), result
                    n += 1
                except Exception as e:  # noqa: BLE001 — collected for the assert
                    errors.append(e)
                    return
            checks[0] += n

        created = [4]

        def grower() -> None:
            i = 4
            while not stop.is_set():
                try:
                    store.create_throttle(
                        _throttle(
                            f"t{i}", {"grp": f"g{i % 4}"}, pod=2 + i % 4,
                            requests={"cpu": f"{1 + i % 3}"},
                        )
                    )
                    plugin.run_pending_once()
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return
                i += 1
                created[0] = i

        tcap0 = dm.throttle.tcap
        threads = [threading.Thread(target=reader, args=(t,)) for t in range(3)]
        gt = threading.Thread(target=grower)
        for t in threads:
            t.start()
        gt.start()
        # run until the tcap ladder actually CROSSED a rung (the event
        # under test — staging reallocation + native plane re-registration)
        # rather than a wall-clock guess; generous deadline for loaded CI
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if dm.throttle.tcap > tcap0 and created[0] > tcap0:
                break
            time.sleep(0.05)
        time.sleep(0.5)  # let readers race the post-growth state a little
        stop.set()
        for t in threads:
            t.join(timeout=10)
        gt.join(timeout=10)
        assert not gt.is_alive(), "grower thread hung"
        assert not any(t.is_alive() for t in threads), "reader thread hung"
        assert not errors, errors[:3]
        assert checks[0] > 0
        assert dm.throttle.tcap > tcap0, (
            f"ladder never grew ({created[0]} creates, tcap {tcap0})"
        )

        plugin.run_pending_once()
        probe = make_pod("probe-final", labels={"grp": "g1"}, requests={"cpu": "200m"})
        _assert_device_matches_oracle(store, plugin, probe)

    def test_check_batch_all_single_snapshot(self):
        """check_batch_all returns both kinds against one lock hold; the
        row maps must cover the same pod set for both kinds."""
        store, plugin = _stack()
        store.create_throttle(_throttle("t1", {"grp": "a"}, pod=10))
        for i in range(8):
            store.create_pod(
                _bound(make_pod(f"p{i}", labels={"grp": "a"}, requests={"cpu": "10m"}))
            )
        plugin.run_pending_once()
        out = plugin.device_manager.check_batch_all(False)
        assert set(out) == {"throttle", "clusterthrottle"}
        t_rows = out["throttle"][2]
        ct_rows = out["clusterthrottle"][2]
        assert set(t_rows) == set(ct_rows) == {f"default/p{i}" for i in range(8)}

    def test_reader_throughput_survives_reconcile_churn(self):
        """check_pod readers must not collapse while a writer continuously
        drives the reconcile data plane (pod deltas + aggregate
        flush/gather). The lock now covers only host-side snapshot grabs —
        kernel dispatch, the batch gather, and device reads run outside it —
        so reader throughput under churn stays a healthy fraction of idle
        throughput instead of queuing behind every reconcile transfer.
        (True thread-scaling is measured on the TPU bench, where device
        kernels dominate; under the CPU test backend the GIL bounds
        everything Python-side, so the bar here is no-collapse, not
        speedup.)"""
        store, plugin = _stack()
        dm = plugin.device_manager
        for i in range(64):
            store.create_throttle(
                _throttle(f"t{i}", {"grp": f"g{i % 8}"}, pod=100, requests={"cpu": "100"})
            )
        for i in range(128):
            store.create_pod(
                _bound(make_pod(f"p{i}", labels={"grp": f"g{i % 8}"}, requests={"cpu": "10m"}))
            )
        plugin.run_pending_once()
        probe = make_pod("probe", labels={"grp": "g0"}, requests={"cpu": "10m"})
        dm.check_pod(probe, "throttle", False)  # warm compile caches
        keys = [f"default/t{i}" for i in range(64)]
        dm.aggregate_used_for("throttle", keys)  # warm the aggregate path

        def measure_reader(duration: float, churn: bool) -> float:
            stop = threading.Event()
            count = [0]

            def reader() -> None:
                p = make_pod("probe-r", labels={"grp": "g0"}, requests={"cpu": "10m"})
                while not stop.is_set():
                    dm.check_pod(p, "throttle", False)
                    count[0] += 1

            def writer() -> None:
                # paced at the BASELINE cfg5 shape: ~1k pod events/sec with
                # periodic batch aggregates, not an unthrottled hot loop (a
                # writer burning a full core is GIL contention, not lock
                # contention — the CPU test backend can't separate those)
                i = 0
                while not stop.is_set():
                    i += 1
                    store.update_pod(
                        _bound(
                            make_pod(
                                f"p{i % 128}",
                                labels={"grp": f"g{i % 8}"},
                                requests={"cpu": f"{10 + i % 7}m"},
                            )
                        )
                    )
                    if i % 16 == 0:
                        dm.aggregate_used_for("throttle", keys)
                    time.sleep(0.001)

            rt = threading.Thread(target=reader)
            wt = threading.Thread(target=writer) if churn else None
            rt.start()
            if wt:
                wt.start()
            time.sleep(duration)
            stop.set()
            rt.join(timeout=10)
            if wt:
                wt.join(timeout=10)
            return count[0] / duration

        idle = measure_reader(1.0, churn=False)
        under_churn = measure_reader(1.5, churn=True)
        # measured ~0.45x idle on this backend (the paced writer's Python
        # work takes its GIL share); full serialization behind the ~14ms
        # aggregate flushes — the regression this guards — sits under 0.1x.
        # The generous bar keeps the test deterministic under suite load.
        assert under_churn > idle * 0.2, (idle, under_churn)


class TestPreFilterCoalescer:
    """The micro-batching front-end must be semantically invisible:
    identical Status (code + reason tuple) to the direct pre_filter for
    every pod, under real concurrency (plugin/coalesce.py)."""

    def _stack(self, n_thr=24, n_pods=60, groups=6):
        import random

        from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
        from kube_throttler_tpu_torch.api.types import (
            LabelSelector,
            ResourceAmount,
            Throttle,
            ThrottleSelector,
            ThrottleSelectorTerm,
            ThrottleSpec,
        )
        from kube_throttler_tpu_torch.engine.store import Store
        from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

        rng = random.Random(11)
        store = Store()
        store.create_namespace(Namespace("default"))
        plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            store,
            use_device=True,
            device="cpu",
        )
        for i in range(n_thr):
            store.create_throttle(
                Throttle(
                    name=f"t{i}",
                    namespace="default",
                    spec=ThrottleSpec(
                        throttler_name="kube-throttler",
                        threshold=ResourceAmount.of(
                            pod=rng.choice([None, 1, 3]),
                            requests={"cpu": f"{rng.randrange(1, 9) * 100}m"},
                        ),
                        selector=ThrottleSelector(
                            selector_terms=(
                                ThrottleSelectorTerm(
                                    LabelSelector(
                                        match_labels={"grp": f"g{i % groups}"}
                                    )
                                ),
                            )
                        ),
                    ),
                )
            )
        from dataclasses import replace

        for i in range(n_pods):
            p = make_pod(
                f"p{i}",
                namespace="default",
                labels={"grp": f"g{rng.randrange(groups)}"},
                requests={"cpu": f"{rng.randrange(1, 6) * 100}m"},
            )
            p = replace(p, spec=replace(p.spec, node_name="n1"))
            p.status.phase = "Running"
            store.create_pod(p)
        plugin.run_pending_once()
        return store, plugin, rng

    def _probes(self, rng, n, groups=6):
        from kube_throttler_tpu_torch.api.pod import make_pod

        return [
            make_pod(
                f"probe{i}",
                namespace="default",
                labels={"grp": f"g{i % groups}"},
                requests={"cpu": f"{rng.randrange(1, 9) * 100}m"},
            )
            for i in range(n)
        ]

    def test_check_pods_multi_matches_check_pod(self):
        """Both routes of the multi check pinned against check_pod: the
        HOST route (native B sub-µs passes — the default) and the fused
        DEVICE dispatch (forced; the remote-accelerator A/B side)."""
        import os

        from kube_throttler_tpu_torch.engine import devicestate as ds

        _, plugin, rng = self._stack()
        dm = plugin.device_manager
        probes = self._probes(rng, 13)
        # the False leg is the NATIVE host route only when the lib loaded;
        # a silent load failure would run the device path twice and the
        # native multi decode would lose coverage — so demand the lib
        # unless the numpy tier was explicitly requested
        native_available = ds._native_cls_lib() is not None
        assert native_available or os.environ.get("KT_TPU_NO_NATIVE") == "1", (
            "native lib failed to load — the host-route leg would not "
            "exercise the native multi path (run with a C++ toolchain)"
        )
        legs = ([False] if native_available else []) + [True]
        for forced_device in legs:
            dm._single_check_device = forced_device
            for kind in ("throttle", "clusterthrottle"):
                multi = dm.check_pods_multi(probes, kind)
                for pod, got in zip(probes, multi):
                    assert got == dm.check_pod(pod, kind), (
                        forced_device, kind, pod.name,
                    )
        # and the numpy host tier (no native lib) through the same surface
        old = (ds._cls_lib, ds._cls_lib_tried)
        ds._cls_lib, ds._cls_lib_tried = None, True
        try:
            dm._single_check_device = False
            for kind in ("throttle", "clusterthrottle"):
                multi = dm.check_pods_multi(probes, kind)
                for pod, got in zip(probes, multi):
                    assert got == dm.check_pod(pod, kind), ("numpy", kind, pod.name)
        finally:
            ds._cls_lib, ds._cls_lib_tried = old

    def test_coalesced_matches_direct_concurrent(self):
        import threading

        _, plugin, rng = self._stack()
        co = plugin.coalescer(window_s=2e-3)
        probes = self._probes(rng, 32)
        want = {p.name: plugin.pre_filter(p) for p in probes}

        got = {}
        lock = threading.Lock()
        barrier = threading.Barrier(8)

        def worker(idx):
            barrier.wait()
            for p in probes[idx::8]:
                s = co.pre_filter(p)
                with lock:
                    got[p.name] = s

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert len(got) == len(probes)
        for name, status in want.items():
            assert got[name].code == status.code, name
            assert got[name].reasons == status.reasons, name

    def test_coalesced_single_caller(self):
        _, plugin, rng = self._stack()
        co = plugin.coalescer()
        for p in self._probes(rng, 6):
            direct = plugin.pre_filter(p)
            coal = co.pre_filter(p)
            assert coal.code == direct.code and coal.reasons == direct.reasons
