"""Port parity: the torch ops (schema, check, fastcheck) ≡ the JAX package.

The same seeded objects and masks go through the JAX function and its
counterpart in ``kube_throttler_tpu_torch`` on ``device="cpu"``; outputs
must be equal bit for bit (int8 statuses, int32 counts, int64 milli
values, bool planes), dtypes included.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from kube_throttler_tpu.ops import check as jcheck
from kube_throttler_tpu.ops import fastcheck as jfast
from kube_throttler_tpu.ops import schema as jschema
from kube_throttler_tpu_torch.ops import check as tcheck
from kube_throttler_tpu_torch.ops import check_gather as cg
from kube_throttler_tpu_torch.ops import fastcheck as tfast
from kube_throttler_tpu_torch.ops import schema as tschema

from tests.test_check_kernel import _build_objects

CPU = "cpu"

_NP_OF_TORCH = {torch.bool: np.bool_, torch.int8: np.int8, torch.int32: np.int32,
                torch.int64: np.int64}


def _assert_same(got, want, what=""):
    """torch tensor ≡ JAX/numpy array: dtype and every element."""
    assert isinstance(got, torch.Tensor), what
    want = np.asarray(want)
    assert _NP_OF_TORCH[got.dtype] == want.dtype.type, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def _assert_dataclass_same(got, want):
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for n in names:
        _assert_same(getattr(got, n), getattr(want, n), n)


def port_objects(objs):
    """The port's own API objects for JAX-package objects: each is written
    to its manifest dict by the JAX package's serializer and read back by
    the port's, so the two packages see the same objects."""
    from kube_throttler_tpu.api.serialization import object_to_dict
    from kube_throttler_tpu.api.types import ResourceAmount as JResourceAmount
    from kube_throttler_tpu_torch.api.serialization import (
        object_from_dict,
        resource_amount_from_dict,
    )

    return [
        resource_amount_from_dict(o.to_dict()) if isinstance(o, JResourceAmount)
        else object_from_dict(object_to_dict(o))
        for o in objs
    ]


def _arrays(dc):
    return {f.name: np.asarray(getattr(dc, f.name)) for f in dataclasses.fields(dc)}


def _encode_both(kind, seed, n_thr=40, n_pods=30, t_cap=None, p_cap=None):
    """Both packages' encodings of one seeded object set, padded to
    (p_cap, t_cap) with invalid rows, plus a seeded full-size mask."""
    rng = random.Random(seed)
    throttles, reserved, pods = _build_objects(rng, n_throttles=n_thr, n_pods=n_pods, kind=kind)
    jd, td = jschema.DimRegistry(), tschema.DimRegistry()
    jstate = jschema.encode_throttle_state(throttles, jd, reserved=reserved, capacity=t_cap)
    jpods = jschema.encode_pods(pods, jd, capacity=p_cap)
    tstate = tschema.encode_throttle_state(
        port_objects(throttles), td, reserved=port_objects(reserved), capacity=t_cap, device=CPU
    )
    tpods = tschema.encode_pods(port_objects(pods), td, capacity=p_cap, device=CPU)
    assert jd.names == td.names and jd.capacity == td.capacity
    P, T = jpods.req.shape[0], jstate.thr_req.shape[0]
    mask = np.random.default_rng(seed).random((P, T)) < 0.5
    return (jstate, jpods), (tstate, tpods), mask


def _cols_from_mask(mask, K):
    """[P,K] matched cols (-1 padded) describing ``mask``'s set bits."""
    P = mask.shape[0]
    cols = np.full((P, K), -1, dtype=np.int32)
    for i in range(P):
        nz = np.flatnonzero(mask[i])
        cols[i, : nz.size] = nz
    return cols


@pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
def test_encoders_match_jax(kind):
    (js, jp), (ts, tp), _ = _encode_both(kind, seed=3, t_cap=48, p_cap=40)
    _assert_dataclass_same(ts, js)
    _assert_dataclass_same(tp, jp)


def test_selector_mask_matches_jax():
    from kube_throttler_tpu.api.pod import Namespace, make_pod
    from kube_throttler_tpu.api.types import (
        ClusterThrottle, ClusterThrottleSelector, ClusterThrottleSelectorTerm,
        ClusterThrottleSpec, LabelSelector, Throttle, ThrottleSelector,
        ThrottleSelectorTerm, ThrottleSpec,
    )

    pods = [
        make_pod(f"p{i}", namespace=("a" if i % 2 else "b"), labels={"app": f"x{i % 3}"})
        for i in range(9)
    ]
    throttles = [
        Throttle(name=f"t{j}", namespace="a", spec=ThrottleSpec(selector=ThrottleSelector(
            selector_terms=(ThrottleSelectorTerm(LabelSelector(match_labels={"app": f"x{j}"})),))))
        for j in range(3)
    ] + [
        ClusterThrottle(name="c0", spec=ClusterThrottleSpec(selector=ClusterThrottleSelector(
            selector_terms=(ClusterThrottleSelectorTerm(
                pod_selector=LabelSelector(match_labels={"app": "x1"}),
                namespace_selector=LabelSelector(match_labels={"team": "t"})),))))
    ]
    namespaces = [Namespace("a", labels={"team": "t"}), Namespace("b")]
    want = jschema.selector_mask(
        pods, throttles, {ns.name: ns for ns in namespaces},
        pod_capacity=12, throttle_capacity=6,
    )
    got = tschema.selector_mask(
        port_objects(pods), port_objects(throttles),
        {ns.name: ns for ns in port_objects(namespaces)},
        pod_capacity=12, throttle_capacity=6, device=CPU,
    )
    _assert_same(got, want)
    assert got.any()


def test_carry_across_matches_port_encoding():
    (js, jp), (ts, tp), _ = _encode_both("clusterthrottle", seed=4, t_cap=48, p_cap=36)
    _assert_dataclass_same(tschema.throttle_state_from_arrays(_arrays(js), device=CPU), js)
    _assert_dataclass_same(tschema.pod_batch_from_arrays(_arrays(jp), device=CPU), jp)
    jpre = jfast.precompute_check_state(js)
    carried = tschema.check_precomp_from_arrays(_arrays(jpre), device=CPU)
    _assert_dataclass_same(carried, jpre)
    _assert_dataclass_same(tfast.precompute_check_state(ts), jpre)
    arrays = _arrays(jp)
    arrays["reqs"] = arrays.pop("req")
    with pytest.raises(ValueError, match="fields"):
        tschema.pod_batch_from_arrays(arrays, device=CPU)


@pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
@pytest.mark.parametrize("on_equal", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_check_pods_and_compact_match_jax(kind, on_equal, seed):
    # padded capacities: invalid throttle rows and pod rows under set
    # mask bits must come out NOT_AFFECTED in both
    (js, jp), (ts, tp), mask = _encode_both(kind, seed, t_cap=56, p_cap=44)
    step3 = True if kind == "throttle" else on_equal
    tmask = torch.from_numpy(mask)
    want = jcheck.check_pods(js, jp, mask, on_equal=on_equal, step3_on_equal=step3)
    got = tcheck.check_pods(ts, tp, tmask, on_equal=on_equal, step3_on_equal=step3)
    _assert_same(got, want, "statuses")
    wc, ws = jcheck.check_pods_compact(js, jp, mask, on_equal=on_equal, step3_on_equal=step3)
    gc, gs = tcheck.check_pods_compact(ts, tp, tmask, on_equal=on_equal, step3_on_equal=step3)
    _assert_same(gc, wc, "counts")
    _assert_same(gs, ws, "schedulable")
    # all four statuses and NOT_AFFECTED occur, so the parity is not vacuous
    assert set(np.unique(got.numpy()).tolist()) == {-1, 0, 1, 2, 3}


def test_check_step_matches_jax():
    (js, jp), (ts, tp), mask = _encode_both("throttle", seed=7)
    wc, ws = jcheck.check_step(js, jp, mask)
    gc, gs = tcheck.check_step(ts, tp, torch.from_numpy(mask))
    _assert_same(gc, wc)
    _assert_same(gs, ws)


@pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
@pytest.mark.parametrize("on_equal", [False, True])
@pytest.mark.parametrize("chunk", [None, 40])
def test_gather_forms_match_jax(kind, on_equal, chunk, monkeypatch):
    """Sparse gather forms over -1 padded cols, padded/invalid rows, and
    (chunk=40) a forced P-chunking of the port."""
    (js, jp), (ts, tp), mask = _encode_both(kind, seed=11, t_cap=48, p_cap=40)
    K = int(mask.sum(axis=1).max()) + 3  # extra -1 pad slots on every row
    cols = _cols_from_mask(mask, K)
    if chunk is not None:
        monkeypatch.setattr(cg, "_GATHER_CHUNK_ELEMS", chunk * K * ts.num_dims // 10)
    step3 = True if kind == "throttle" else on_equal
    tcols = torch.from_numpy(cols)
    want = jcheck.check_pods_gather_statuses(js, jp, cols, on_equal=on_equal, step3_on_equal=step3)
    got = tcheck.check_pods_gather_statuses(ts, tp, tcols, on_equal=on_equal, step3_on_equal=step3)
    _assert_same(got, want, "gather statuses")
    wc, ws = jcheck.check_pods_gather(js, jp, cols, on_equal=on_equal, step3_on_equal=step3)
    gc, gs = tcheck.check_pods_gather(ts, tp, tcols, on_equal=on_equal, step3_on_equal=step3)
    _assert_same(gc, wc, "gather counts")
    _assert_same(gs, ws, "gather schedulable")
    # the gather form agrees with the dense form on the same matches
    dc, ds = tcheck.check_pods_compact(ts, tp, torch.from_numpy(mask),
                                       on_equal=on_equal, step3_on_equal=step3)
    np.testing.assert_array_equal(gc.numpy(), dc.numpy())
    np.testing.assert_array_equal(gs.numpy(), ds.numpy())


def test_gather_rejects_mismatched_shapes():
    (_, _), (ts, tp), _ = _encode_both("throttle", seed=1)
    with pytest.raises(ValueError, match="cols shape"):
        tcheck.check_pods_gather(ts, tp, torch.zeros((3, 4), dtype=torch.int32))


@pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
@pytest.mark.parametrize("on_equal", [False, True])
def test_fastcheck_matches_jax(kind, on_equal):
    (js, jp), (ts, tp), mask = _encode_both(kind, seed=21, t_cap=48, p_cap=36)
    step3 = True if kind == "throttle" else on_equal
    jpre, tpre = jfast.precompute_check_state(js), tfast.precompute_check_state(ts)
    _assert_dataclass_same(tpre, jpre)
    tmask = torch.from_numpy(mask)
    _assert_same(
        tfast.fast_check_pods(tpre, tp, tmask, on_equal=on_equal, step3_on_equal=step3),
        jfast.fast_check_pods(jpre, jp, mask, on_equal=on_equal, step3_on_equal=step3),
    )
    gc, gs = tfast.fast_check_pods_compact(tpre, tp, tmask, on_equal=on_equal, step3_on_equal=step3)
    wc, ws = jfast.fast_check_pods_compact(jpre, jp, mask, on_equal=on_equal, step3_on_equal=step3)
    _assert_same(gc, wc)
    _assert_same(gs, ws)

    jpk, tpk = jfast.pack_check_state(jpre), tfast.pack_check_state(tpre)
    _assert_dataclass_same(tpk, jpk)
    rng = np.random.default_rng(5)
    for i in range(0, jp.req.shape[0], 5):
        idx = rng.integers(0, js.thr_req.shape[0], 9).astype(np.int32)
        idx_valid = rng.random(9) < 0.7
        args_j = (np.asarray(jp.req)[i], np.asarray(jp.req_present)[i], idx, idx_valid)
        args_t = tuple(torch.from_numpy(np.array(a)) for a in args_j)
        want = jfast.fast_check_pod_indexed(jpre, *args_j, on_equal=on_equal, step3_on_equal=step3)
        _assert_same(
            tfast.fast_check_pod_indexed(tpre, *args_t, on_equal=on_equal, step3_on_equal=step3),
            want,
        )
        _assert_same(
            tfast.fast_check_pod_packed(tpk, *args_t, on_equal=on_equal, step3_on_equal=step3),
            jfast.fast_check_pod_packed(jpk, *args_j, on_equal=on_equal, step3_on_equal=step3),
        )


def test_encoders_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tschema.encode_pods([], tschema.DimRegistry())
