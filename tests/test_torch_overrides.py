"""Port parity: ``ops/overrides.py`` of the port (``device="cpu"``) ≡ the
JAX package's.

The same seeded specs are built in each package's own API types and go
through ``encode_override_schedule``, ``calculate_thresholds`` and
``encode_class_thresholds``; every output must be equal bit for bit, its
dtype included.
"""

import random
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import kube_throttler_tpu.api.types as jtypes
import kube_throttler_tpu.ops.overrides as jov
import kube_throttler_tpu.ops.schema as jschema
import kube_throttler_tpu_torch.api.types as ttypes
import kube_throttler_tpu_torch.ops.overrides as tov
import kube_throttler_tpu_torch.ops.schema as tschema
from tests.test_torch_ops import _assert_dataclass_same, _assert_same

CPU = "cpu"
NOW = datetime(2024, 1, 15, 12, 0, 0, tzinfo=timezone.utc)


def rfc(dt, frac=""):
    return dt.strftime("%Y-%m-%dT%H:%M:%S") + frac + "Z"


def plan_specs(seed, n, max_overrides):
    """A package-neutral plan of ``n`` specs: (threshold, overrides), each
    override (begin, end, threshold); thresholds are (pod, cpu, memory)."""
    rng = random.Random(seed)

    def threshold():
        return (
            rng.randrange(0, 6) if rng.random() < 0.6 else None,
            f"{rng.randrange(1, 9) * 100}m" if rng.random() < 0.7 else None,
            f"{rng.randrange(1, 2**20)}Ki" if rng.random() < 0.4 else None,
        )

    plans = []
    for _ in range(n):
        ovs = []
        for _ in range(rng.randrange(0, max_overrides + 1)):
            begin = NOW + timedelta(minutes=rng.randrange(-120, 120))
            end = begin + timedelta(minutes=rng.randrange(0, 120))
            pick = rng.random()
            if pick < 0.1:
                b, e = "garbage", ""
            elif pick < 0.2:
                b, e = rfc(begin), "9999-12-31T23:59:59Z"  # never expires
            elif pick < 0.35:
                # fractional-second bounds
                b, e = rfc(begin, ".000013"), rfc(end, ".999999")
            else:
                b = rfc(begin) if rng.random() < 0.8 else ""
                e = rfc(end) if rng.random() < 0.8 else ""
            ovs.append((b, e, threshold()))
        plans.append((threshold(), ovs))
    return plans


def amount(types, thr):
    pod, cpu, mem = thr
    reqs = {k: v for k, v in (("cpu", cpu), ("memory", mem)) if v is not None}
    return types.ResourceAmount.of(pod=pod, requests=reqs or None)


def build_specs(types, plans):
    return [
        None if plan is None else types.ThrottleSpecBase(
            threshold=amount(types, plan[0]),
            temporary_threshold_overrides=tuple(
                types.TemporaryThresholdOverride(begin=b, end=e, threshold=amount(types, t))
                for b, e, t in plan[1]
            ),
        )
        for plan in plans
    ]


def both(plans, **kw):
    """(JAX schedule, port schedule) of the same plans, each package with
    its own dim registry."""
    jd, td = jschema.DimRegistry(), tschema.DimRegistry()
    js = jov.encode_override_schedule(build_specs(jtypes, plans), jd, **kw)
    ts = tov.encode_override_schedule(build_specs(ttypes, plans), td, device=CPU, **kw)
    assert jd.names == td.names
    return js, ts


CASES = {
    "no_overrides": dict(seed=1, n=12, max_overrides=0),
    "one_override": dict(seed=2, n=20, max_overrides=1),
    "three_overrides": dict(seed=3, n=40, max_overrides=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_matches_jax(case):
    plans = plan_specs(**CASES[case])
    _assert_dataclass_same(*reversed(both(plans)))
    # padded capacity with unoccupied columns, and a wider override axis
    padded = plans[:5] + [None, None] + plans[5:]
    _assert_dataclass_same(
        *reversed(both(padded, throttle_capacity=len(padded) + 9, override_capacity=4))
    )


def _edges(sched):
    """Every finite window bound of the schedule, and one ns either side."""
    ns = set()
    for t in (sched.ov_begin, sched.ov_end):
        for v in np.asarray(t).ravel().tolist():
            if jov.NS_MIN < v < jov.NS_MAX:
                ns.update((v - 1, v, v + 1))
    return sorted(ns)


@pytest.mark.parametrize("case", sorted(CASES))
def test_calculate_thresholds_matches_jax_at_every_edge(case):
    js, ts = both(plan_specs(**CASES[case]))
    probes = _edges(js) + [int(jov._datetime_to_ns(NOW)), int(jov.NS_MIN), int(jov.NS_MAX)]
    assert case == "no_overrides" or len(probes) > 20
    for now in probes:
        want = jov.calculate_thresholds(js, np.int64(now))
        got = tov.calculate_thresholds(ts, torch.tensor(now, dtype=torch.int64))
        for name, g, w in zip(("thr_cnt", "thr_cnt_present", "thr_req", "thr_req_present"),
                              got, want):
            _assert_same(g, w, f"{name} at {now}")


def test_carried_schedule_resolves_like_jax():
    """``override_schedule_from_arrays``: the JAX schedule's numpy leaves
    carried into the port resolve to the same thresholds."""
    js, ts = both(plan_specs(seed=4, n=30, max_overrides=3))
    carried = tschema.override_schedule_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in tov.OverrideSchedule.__dataclass_fields__},
        device=CPU,
    )
    _assert_dataclass_same(carried, js)
    now = int(jov._datetime_to_ns(NOW + timedelta(minutes=7)))
    for g, w in zip(tov.calculate_thresholds(carried, torch.tensor(now)),
                    jov.calculate_thresholds(js, np.int64(now))):
        _assert_same(g, w)


def test_far_future_end_clamps_not_overflows():
    plans = [((1, None, None), [(rfc(NOW - timedelta(hours=1)), "9999-12-31T23:59:59Z",
                                 (1, None, None))])]
    js, ts = both(plans)
    # year 9999 is past int64 nanoseconds: the bound clamps to NS_MAX
    assert int(ts.ov_end[0, 0]) == int(np.asarray(js.ov_end)[0, 0]) == int(jov.NS_MAX)
    cnt, cnt_p, _, _ = tov.calculate_thresholds(ts, torch.tensor(int(jov._datetime_to_ns(NOW))))
    assert bool(cnt_p[0]) and int(cnt[0]) == 1  # still active at NOW


def test_fractional_second_boundary_exact():
    dt = ttypes.parse_rfc3339("2024-01-15T12:00:00.000013Z")
    assert int(tov._datetime_to_ns(dt)) % 10**9 == 13_000
    assert tov._datetime_to_ns(dt) == jov._datetime_to_ns(jtypes.parse_rfc3339(
        "2024-01-15T12:00:00.000013Z"))


def test_encode_class_thresholds_matches_jax():
    rng = np.random.default_rng(5)
    T, R = 24, 4
    base = (
        rng.integers(0, 50, T), rng.random(T) < 0.6,
        rng.integers(0, 2**40, (T, R)), rng.random((T, R)) < 0.5,
    )
    classes = ("v5e", "v5p", "h100")

    def entries(types):
        out = {}
        for col in (0, 3, 7, 19, 30):  # col 30 is past T: skipped
            out[col] = tuple(
                types.AccelClassThreshold(
                    accel_class=cls, threshold=amount(types, (col % 4, f"{col + 1}00m", None)),
                )
                for cls in (("v5e", "h100", "v5e") if col % 2 else ("v5p",))
            )
        return out

    jd, td = jschema.DimRegistry(), tschema.DimRegistry()
    for d in (jd, td):
        d.index_of("cpu")
    want = jov.encode_class_thresholds(*base, entries(jtypes), classes, jd)
    got = tov.encode_class_thresholds(*base, entries(ttypes), classes, td)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_capacity_overflow_raises():
    plans = [((None, None, None), [("", "", (i, None, None)) for i in range(3)])]
    with pytest.raises(ValueError, match="override_capacity"):
        tov.encode_override_schedule(
            build_specs(ttypes, plans), tschema.DimRegistry(), override_capacity=2, device=CPU
        )


def test_actionable_error_on_registry_growth():
    from kube_throttler_tpu_torch.api.pod import make_pod
    from kube_throttler_tpu_torch.ops import check_pods, encode_pods, encode_throttle_state

    dims = tschema.DimRegistry(capacity=2)
    state = encode_throttle_state(
        [ttypes.Throttle(name="t", spec=ttypes.ThrottleSpec(
            threshold=ttypes.ResourceAmount.of(requests={"a": "1", "b": "1"})))],
        dims, device=CPU,
    )
    # the pod introduces a 3rd dim → capacity doubles → R mismatch
    batch = encode_pods([make_pod("p", requests={"a": "1", "b": "1", "c": "1"})], dims,
                        device=CPU)
    with pytest.raises(ValueError, match="resource-dim mismatch"):
        check_pods(state, batch, torch.ones((1, 1), dtype=torch.bool))


def test_encode_needs_an_explicit_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tov.encode_override_schedule([], tschema.DimRegistry())
