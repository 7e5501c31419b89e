"""Hypothesis property tests: oracle algebraic laws and oracle ↔ kernel
equivalence over generated states.

SURVEY §4's template calls for "hypothesis/property tests for
Add/IsThrottled" — these cover: arbitrary quantities through the exact
decimal parser, ResourceAmount algebra (the reference's clamp/negative
quirks preserved — resource_amount.go:83-125), IsThrottled dimension
scoping (resource_amount.go:147-155), and randomized single-cell agreement
between ``_check_throttled_for`` and the batched kernel for all onEqual
variants. The quantity parser, the amount algebra and the single cell are
also held equal to the JAX package's on the same drawn inputs.
"""

from __future__ import annotations

import numpy as np
import pytest

# requirements-ci.txt lists hypothesis, but ad-hoc dev environments may
# lack it — skip at collection instead of erroring the whole session
pytest.importorskip("hypothesis")
from hypothesis import assume, given, settings, strategies as st

from kube_throttler_tpu_torch import quantity as qt
from kube_throttler_tpu_torch.ops.check import STATUS_NAMES, check_pods
# the strategies and the cell's oracle, shared with the chip smoke's [props]
from torch_props import amounts, pod_requests, quantities, single_cell

from kube_throttler_tpu import quantity as jqt
from kube_throttler_tpu.api import pod as jpod
from kube_throttler_tpu.api import types as jtypes


def _ref_amount(a):
    """The JAX package's ResourceAmount of the port's ``a`` (the same exact
    Fractions)."""
    reqs = a.resource_requests
    return jtypes.ResourceAmount(resource_counts=a.resource_counts,
                                 resource_requests=None if reqs is None else dict(reqs))


def _amount_fields(a):
    return a.resource_counts, a.resource_requests


def _flag_fields(f):
    return f.resource_counts_pod, f.resource_requests


# ----------------------------------------------------------------- quantity


@given(quantities())
@settings(max_examples=200, deadline=None)
def test_quantity_milli_roundtrip_exact(s):
    """to_milli is exact: re-parsing the milli value yields an equal
    quantity (never silently rounded)."""
    q = qt.parse_quantity(s)
    try:
        m = qt.to_milli(q)
    except qt.SubMilliPrecisionError:
        # the loud-rejection property itself: the value truly is
        # unrepresentable — sub-milli precision or outside int64 (never a
        # silent round/truncate)
        milli = q * 1000
        assert milli != int(milli) or not (-(2**63) <= int(milli) < 2**63)
        return
    assert qt.parse_quantity(f"{m}m") == q


@given(quantities())
@settings(max_examples=200, deadline=None)
def test_quantity_parse_matches_reference(s):
    """The port's parser and milli conversion ≡ the JAX package's."""
    q = qt.parse_quantity(s)
    assert q == jqt.parse_quantity(s)
    try:
        m = qt.to_milli(q)
    except qt.SubMilliPrecisionError:
        with pytest.raises(jqt.SubMilliPrecisionError):
            jqt.to_milli(q)
        return
    assert m == jqt.to_milli(q)


@given(quantities(), quantities())
@settings(max_examples=100, deadline=None)
def test_quantity_ordering_matches_milli(a, b):
    qa, qb = qt.parse_quantity(a), qt.parse_quantity(b)
    try:
        ma, mb = qt.to_milli(qa), qt.to_milli(qb)
    except qt.SubMilliPrecisionError:
        assume(False)  # count as filtered, not passed (health-checked)
    assert (qa < qb) == (ma < mb) and (qa == qb) == (ma == mb)


# ---------------------------------------------------------- amount algebra


@given(amounts(), amounts())
@settings(max_examples=150, deadline=None)
def test_add_sub_round_trip_quirks(a, b):
    """a.add(b).sub(b) restores ``a``'s dims EXCEPT the reference's
    deliberate asymmetries: pod count clamps at 0 on sub while request
    quantities may go negative; keys only in ``b`` remain at 0."""
    back = a.add(b).sub(b)
    if a.resource_counts is None and b.resource_counts is None:
        assert back.resource_counts is None
    else:
        assert back.resource_counts == max(a.resource_counts or 0, 0)
    for k, v in (a.resource_requests or {}).items():
        assert back.resource_requests[k] == v
    for k in (b.resource_requests or {}):
        if k not in (a.resource_requests or {}):
            assert back.resource_requests[k] == 0


@given(amounts(), amounts(), st.booleans())
@settings(max_examples=150, deadline=None)
def test_is_throttled_dimension_scoping(threshold, used, on_equal):
    """Only dims present in the threshold are evaluated; threshold dims
    absent from used evaluate to not-throttled; empty-but-present threshold
    request map yields a nil flag map (Go allocation quirk, preserved)."""
    flags = threshold.is_throttled(used, on_equal)
    treqs = threshold.resource_requests
    if treqs is None or not treqs:
        assert flags.resource_requests is None
    else:
        assert set(flags.resource_requests.keys()) == set(treqs.keys())
        for k in treqs:
            if k not in (used.resource_requests or {}):
                assert flags.resource_requests[k] is False
    if threshold.resource_counts is None or used.resource_counts is None:
        assert flags.resource_counts_pod is False


@given(amounts(), amounts(), st.booleans())
@settings(max_examples=150, deadline=None)
def test_amount_algebra_matches_reference(a, b, on_equal):
    """add, sub and is_throttled ≡ the JAX package's, quirks included."""
    ja, jb = _ref_amount(a), _ref_amount(b)
    assert _amount_fields(a.add(b)) == _amount_fields(ja.add(jb))
    assert _amount_fields(a.sub(b)) == _amount_fields(ja.sub(jb))
    assert _flag_fields(a.is_throttled(b, on_equal)) == _flag_fields(ja.is_throttled(jb, on_equal))


# ----------------------------------------------------- oracle ↔ kernel e2e


@given(amounts(), amounts(), amounts(), pod_requests(), st.booleans(), st.booleans())
@settings(max_examples=200, deadline=None)
def test_kernel_matches_oracle_single_cell(
    threshold, used, reserved, pod_reqs, on_equal, step3_on_equal
):
    """One (pod, throttle) cell through the batched kernel equals the
    ordered 4-state oracle for arbitrary generated amounts and both
    onEqual flags (covering the Throttle/ClusterThrottle asymmetry)."""
    # sub-milli-unrepresentable quantities are assume()d away in single_cell
    oracle, state, batch, mask = single_cell(
        threshold, used, reserved, pod_reqs, on_equal, step3_on_equal, device="cpu"
    )
    assert batch.req.shape[1] == state.thr_req.shape[1]  # ≤4 names, cap 8
    got = int(np.asarray(check_pods(state, batch, mask, on_equal, step3_on_equal))[0, 0])
    # the JAX package's oracle on the same cell
    j_threshold, j_used = _ref_amount(threshold), _ref_amount(used)
    j_status = jtypes.ThrottleStatus(used=j_used, throttled=j_threshold.is_throttled(j_used, True))
    reference = jtypes._check_throttled_for(
        j_threshold, j_status, jpod.make_pod("p", requests=pod_reqs), _ref_amount(reserved),
        on_equal, step3_on_equal,
    )
    assert oracle == reference, (oracle, reference)
    assert STATUS_NAMES[got] == oracle, (
        f"kernel={STATUS_NAMES[got]} oracle={oracle} thr={threshold} used={used} "
        f"res={reserved} pod={pod_reqs} onEqual={on_equal} step3={step3_on_equal}"
    )
