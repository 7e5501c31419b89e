"""Device circuit breaker: a failed device dispatch (tunnel drop, backend
death) must degrade LATENCY, never availability — decisions and reconciles
fall back to the host-oracle paths, the breaker skips the device for a
cooldown, and service resumes on the device after it.
"""

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
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.plugin.framework import StatusCode
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _throttle(name="t1", cpu="200m"):
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(requests={"cpu": cpu}),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(
                        pod_selector=LabelSelector(match_labels={"grp": "a"})
                    ),
                )
            ),
        ),
    )


@pytest.fixture()
def stack():
    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True,
        start_workers=False,
        device="cpu",
    )
    store.create_namespace(Namespace("default"))
    store.create_throttle(_throttle())
    store.create_pod(
        make_pod(
            "running",
            labels={"grp": "a"},
            requests={"cpu": "150m"},
            node_name="n1",
            phase="Running",
        )
    )
    plugin.run_pending_once()
    # these tests count device dispatches to drive the circuit breaker —
    # the interned-verdict cache would (correctly) serve repeats without
    # dispatching at all, so it must sit out
    plugin.verdict_cache = None
    return store, plugin


class _Boom(RuntimeError):
    pass


def _break_device(dm, method):
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise _Boom("tunnel died")

    setattr(dm, method, boom)
    return calls


class TestCheckFallback:
    def test_prefilter_survives_device_failure(self, stack):
        store, plugin = stack
        dm = plugin.device_manager
        pending = make_pod("pending", labels={"grp": "a"}, requests={"cpu": "100m"})

        # healthy: device path serves, and the verdict is 'insufficient'
        # (150m used of 200m, +100m would exceed)
        st = plugin.pre_filter(pending)
        assert st.code == StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE
        assert st.reasons == ("throttle[insufficient]=default/t1",)

        calls = _break_device(dm, "check_pod")
        st = plugin.pre_filter(pending)
        assert st.code == StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE
        assert st.reasons == ("throttle[insufficient]=default/t1",)
        assert calls == [1], "first failing dispatch opens the breaker"

        # breaker open: the device is not touched again within the cooldown
        st = plugin.pre_filter(pending)
        assert st.code == StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE
        assert calls == [1]

        # fallback counted per surface
        counter = plugin.metrics_registry.counter_vec(
            "kube_throttler_device_fallback_total", "", ["surface"]
        )
        assert counter.collect()[("check",)] == 1.0

        # a schedulable pod stays schedulable host-side
        small = make_pod("small", labels={"grp": "a"}, requests={"cpu": "10m"})
        assert plugin.pre_filter(small).code == StatusCode.SUCCESS

    def test_breaker_reopens_after_cooldown(self, stack):
        _, plugin = stack
        dm = plugin.device_manager
        now = [100.0]
        dm._monotonic = lambda: now[0]

        calls = _break_device(dm, "check_pod")
        pending = make_pod("pending", labels={"grp": "a"}, requests={"cpu": "100m"})
        plugin.pre_filter(pending)
        assert calls == [1] and not dm.device_available()

        now[0] += dm.device_retry_cooldown + 1
        assert dm.device_available()
        plugin.pre_filter(pending)  # device retried (and fails again)
        assert calls == [1, 1]


class TestBatchFallback:
    def test_prefilter_batch_survives_device_failure(self, stack):
        store, plugin = stack
        dm = plugin.device_manager
        healthy = plugin.pre_filter_batch()
        # the running pod classifies against state already containing it
        # (used 150m + own 150m > 200m → insufficient): not schedulable
        assert healthy["schedulable"] == {"default/running": False}

        calls = _break_device(dm, "check_batch_all")
        out = plugin.pre_filter_batch()
        assert out["schedulable"] == healthy["schedulable"]
        assert calls == [1]
        out = plugin.pre_filter_batch()  # breaker open: device untouched
        assert out["schedulable"] == healthy["schedulable"]
        assert calls == [1]


class TestFlakyDeviceSoak:
    @pytest.mark.parametrize("seed", [11, 23])
    def test_verdicts_stay_oracle_correct_through_outages(self, seed):
        """Random churn while the device flips between healthy and failing:
        at every checkpoint the (possibly degraded) device stack must agree
        with a pure host-oracle stack — across outage windows, breaker
        cooldown reopenings, and post-recovery device serving (the staged
        aggregates must self-heal when the device returns)."""
        import random

        from dataclasses import replace

        rng = random.Random(seed)

        def _mk(use_device):
            store = Store()
            plugin = KubeThrottler(
                decode_plugin_args(
                    {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
                ),
                store,
                use_device=use_device,
                start_workers=False,
                device="cpu",
            )
            store.create_namespace(Namespace("default"))
            return store, plugin

        (store_d, plug_d), (store_h, plug_h) = _mk(True), _mk(False)
        dm = plug_d.device_manager
        now = [1000.0]
        dm._monotonic = lambda: now[0]
        down = [False]

        def flaky(real):
            def f(*a, **k):
                if down[0]:
                    raise RuntimeError("injected tunnel failure")
                return real(*a, **k)

            return f

        dm.check_pod = flaky(dm.check_pod)
        dm.aggregate_used_for = flaky(dm.aggregate_used_for)

        pods = []

        def both(fn):
            fn(store_d)
            fn(store_h)

        from conftest import normalize_reasons as norm

        def checkpoint():
            plug_d.run_pending_once()
            plug_h.run_pending_once()
            for pod in pods:
                sd, sh = plug_d.pre_filter(pod), plug_h.pre_filter(pod)
                assert sd.code == sh.code, (pod.key, down[0], sd.reasons, sh.reasons)
                assert norm(sd.reasons) == norm(sh.reasons), pod.key
            for thr_d in store_d.list_throttles():
                thr_h = store_h.get_throttle(thr_d.namespace, thr_d.name)
                assert thr_d.status.used.to_dict() == thr_h.status.used.to_dict(), (
                    thr_d.key,
                    down[0],
                )

        for step in range(90):
            op = rng.random()
            if op < 0.2:
                name = f"t{rng.randint(0, 4)}"
                thr = _throttle(name, cpu=f"{rng.randint(1, 6)}00m")

                def apply_thr(s, thr=thr):
                    try:
                        s.create_throttle(thr)
                    except ValueError:
                        cur = s.get_throttle("default", thr.name)
                        s.update_throttle(replace(thr, status=cur.status))

                both(apply_thr)
            elif op < 0.55 or not pods:
                pod = make_pod(
                    f"p{step}",
                    labels={"grp": rng.choice("ab")},
                    requests={"cpu": f"{rng.randint(1, 5)}00m"},
                    node_name="n1" if rng.random() < 0.6 else "",
                    phase="Running" if rng.random() < 0.5 else "Pending",
                )
                pods.append(pod)
                both(lambda s, pod=pod: s.create_pod(pod))
            elif op < 0.75:
                old = rng.choice(pods)
                moved = replace(old, labels={"grp": rng.choice("ab")})
                pods[pods.index(old)] = moved
                both(lambda s, moved=moved: s.update_pod(moved))
            elif op < 0.85:
                pod = rng.choice(pods)
                sd, sh = plug_d.reserve(pod), plug_h.reserve(pod)
                assert sd.code == sh.code
            else:
                pod = pods.pop(rng.randrange(len(pods)))
                both(lambda s, pod=pod: s.delete_pod(pod.namespace, pod.name))

            if step % 15 == 14:
                # flip device health; advancing past the cooldown lets the
                # breaker retry (and re-open if still down)
                down[0] = not down[0]
                now[0] += dm.device_retry_cooldown + 1
            if step % 9 == 8:
                checkpoint()
        down[0] = False
        now[0] += dm.device_retry_cooldown + 1
        checkpoint()  # final: device healthy again, healed state serves


class TestReconcileFallback:
    def test_status_converges_host_side(self, stack):
        store, plugin = stack
        dm = plugin.device_manager
        _break_device(dm, "aggregate_used_for")

        store.create_pod(
            make_pod(
                "running2",
                labels={"grp": "a"},
                requests={"cpu": "40m"},
                node_name="n1",
                phase="Running",
            )
        )
        plugin.run_pending_once()
        thr = store.get_throttle("default", "t1")
        # host-walk reconcile landed the fresh aggregate: 150m + 40m
        assert thr.status.used.resource_counts == 2
        assert str(thr.status.used.resource_requests["cpu"]) == "19/100"
        counter = plugin.metrics_registry.counter_vec(
            "kube_throttler_device_fallback_total", "", ["surface"]
        )
        assert counter.collect()[("reconcile",)] >= 1.0


def test_reservation_survives_throttle_recreation_on_device():
    """Reservations outlive the throttle object (the reference cache is
    keyed by name and never cleared on deletion): after delete + re-create,
    the device mirror's reserved row must be replayed from the cache, or
    the device check under-counts until the next reserve/unreserve (found
    by differential soak seed 20)."""
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

    def throttle():
        return Throttle(
            name="t1",
            spec=ThrottleSpec(
                throttler_name="kube-throttler",
                threshold=ResourceAmount.of(pod=2),
                selector=ThrottleSelector(
                    selector_terms=(
                        ThrottleSelectorTerm(LabelSelector(match_labels={"g": "a"})),
                    )
                ),
            ),
        )

    store = Store()
    store.create_namespace(Namespace("default"))
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True,
        start_workers=False,
        device="cpu",
    )
    store.create_throttle(throttle())
    plugin.run_pending_once()

    # two reservations fill the pod=2 threshold
    for name in ("r1", "r2"):
        assert plugin.reserve(make_pod(name, labels={"g": "a"})).is_success()

    probe = make_pod("probe", labels={"g": "a"})
    assert not plugin.pre_filter(probe).is_success()  # 2 reserved + 1 > 2

    # delete + re-create the throttle: reservations must still bind
    store.delete_throttle("default", "t1")
    store.create_throttle(throttle())
    plugin.run_pending_once()

    # 2 reserved ≥ pod=2 with the Throttle kind's hardcoded step-3
    # onEqual=True → active (throttle_types.go:143)
    verdict = plugin.pre_filter(probe)
    assert not verdict.is_success(), verdict.reasons
    assert "throttle[active]=default/t1" in verdict.reasons
    # host oracle agrees cell-for-cell
    active, insufficient, _, _ = plugin.throttle_ctr.check_throttled(probe, False)
    assert active and not insufficient
