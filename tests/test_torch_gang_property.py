"""Hypothesis property: the batched gang-feasibility kernel
(ops/gang_check.py, dispatched through DeviceStateManager.gang_check_groups)
is equivalent to the SEQUENTIAL per-pod oracle (engine/gang.py
sequential_gang_check — admit members one at a time through the reference
4-step check, counting earlier members as reserved) on:

- the all-or-nothing VERDICT, over generated thresholds (counts + cpu,
  including per-accel-class replacements), statuses (used + persisted
  throttled flags), pre-existing per-pod reservations, and group shapes;
- the LEDGER state and the published ``st_*`` planes across a
  reserve → rollback cycle: a rolled-back gang leaves the reservation
  ledger, the device reserved rows, and every per-pod admission verdict
  exactly as they were (the rollback path is bit-invisible).

Guarded by importorskip like tests/test_property_oracle.py.
"""

from __future__ import annotations

import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    AccelClassThreshold,
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
    ThrottleStatus,
)
from kube_throttler_tpu_torch.engine.gang import sequential_gang_check
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

GROUPS = ("g0", "g1")
ACCEL_CLASSES = (None, "v5e", "v5p")


@st.composite
def amounts(draw, max_pod=6):
    cnt = draw(st.one_of(st.none(), st.integers(min_value=0, max_value=max_pod)))
    cpu = draw(st.one_of(st.none(), st.integers(min_value=0, max_value=4000)))
    return ResourceAmount.of(
        pod=cnt, requests={"cpu": f"{cpu}m"} if cpu is not None else None
    )


@st.composite
def throttle_specs(draw, idx):
    threshold = draw(amounts())
    used = draw(amounts())
    accel = []
    for cls in ("v5e", "v5p"):
        if draw(st.booleans()):
            accel.append(AccelClassThreshold(cls, draw(amounts())))
    # selector: one group label, or match-all (both groups)
    grp = draw(st.sampled_from(GROUPS + ("*",)))
    labels = {} if grp == "*" else {"grp": grp}
    thr = Throttle(
        name=f"t{idx}",
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=threshold,
            accel_class_thresholds=tuple(accel),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels=labels)),
                )
            ),
        ),
        # persisted status: used + flags derived like a reconcile would
        # (flags against the base threshold, onEqual=True — the Throttle
        # kind's write path), calculated_at left None so the spec
        # threshold stays effective
        status=ThrottleStatus(
            used=used, throttled=threshold.is_throttled(used, True)
        ),
    )
    return thr


@st.composite
def scenarios(draw):
    throttles = [draw(throttle_specs(i)) for i in range(draw(st.integers(1, 3)))]
    n_members = draw(st.integers(1, 5))
    accel = draw(st.sampled_from(ACCEL_CLASSES))
    members = []
    for i in range(n_members):
        cpu = draw(st.integers(0, 2000))
        grp = draw(st.sampled_from(GROUPS))
        members.append((f"m{i}", grp, cpu))
    # optional pre-existing per-pod reservation
    filler = (
        (draw(st.sampled_from(GROUPS)), draw(st.integers(0, 1500)))
        if draw(st.booleans())
        else None
    )
    return throttles, members, accel, filler


def _build(throttles, filler):
    store = Store()
    store.create_namespace(Namespace("default"))
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True, device="cpu",
    )
    for thr in throttles:
        store.create_throttle(thr)
    if filler is not None:
        grp, cpu = filler
        plugin.reserve(
            make_pod("filler", labels={"grp": grp}, requests={"cpu": f"{cpu}m"})
        )
    return store, plugin


def _reservation_state(plugin, throttles):
    out = {}
    for thr in throttles:
        amt, keys = plugin.throttle_ctr.cache.reserved_resource_amount(thr.key)
        out[thr.key] = (amt, frozenset(keys))
    return out


@given(scenarios())
@settings(max_examples=40, deadline=None)
def test_batched_gang_kernel_equals_sequential_oracle(scenario):
    throttles, member_specs, accel, filler = scenario
    store, plugin = _build(throttles, filler)
    try:
        members = [
            make_pod(
                name,
                labels={"grp": grp},
                requests={"cpu": f"{cpu}m"},
                group="job",
                group_size=len(member_specs),
                accel_class=accel,
            )
            for name, grp, cpu in member_specs
        ]
        dm = plugin.device_manager
        kernel = dm.gang_check_groups([("default/job", members, accel)])
        kernel_ok = kernel["default/job"]["ok"]
        oracle_ok, blocked = sequential_gang_check(
            members,
            (
                ("throttle", plugin.throttle_ctr, False),
                ("clusterthrottle", plugin.cluster_throttle_ctr, False),
            ),
        )
        assert kernel_ok == oracle_ok, (
            f"kernel={kernel_ok} oracle={oracle_ok} blocked={blocked} "
            f"detail={kernel['default/job']['kinds']} accel={accel} "
            f"throttles={[ (t.key, t.spec.threshold, t.status.used) for t in throttles ]} "
            f"members={member_specs}"
        )

        # reserve → rollback leaves ledger, reserved planes, and per-pod
        # verdicts bit-identical (the rollback path is invisible)
        res_before = _reservation_state(plugin, throttles)
        flags_before = dm.published_flags()
        probe = make_pod("probe", labels={"grp": "g0"}, requests={"cpu": "500m"})
        verdict_before = plugin.pre_filter(probe).code
        assert plugin.reserve_gang("default/job", members).is_success()
        plugin.unreserve_gang("default/job")
        assert _reservation_state(plugin, throttles) == res_before
        assert dm.published_flags() == flags_before
        assert plugin.pre_filter(probe).code == verdict_before
        assert plugin.gang.pending_groups() == 0
    finally:
        plugin.stop()
