"""Port parity: ``ops/aggregate.py`` of the port (``device="cpu"``) ≡ the
JAX package's, and the device-delta route of the port's reconcile data
plane ≡ its host route.

Seeded numpy inputs, with quantities up to 2^50 milli-units, go through
each JAX function and its port; outputs must be equal bit for bit, dtype
included. The ids carry the JAX package's pads on purpose: out-of-range
rows (T and beyond), which a JAX scatter drops and a JAX gather clamps,
and negative rows, which both count from the end. torch raises on such ids,
so these cases pin how the port maps them (ROADMAP hazard (a)).
"""

import random

import numpy as np
import pytest
import torch

import kube_throttler_tpu.ops.aggregate as jagg
import kube_throttler_tpu.ops.schema as jschema
import kube_throttler_tpu_torch.engine.devicestate as tds
import kube_throttler_tpu_torch.ops.aggregate as tagg
import kube_throttler_tpu_torch.ops.schema as tschema
from tests.test_torch_ops import _assert_same

CPU = "cpu"
BIG = 2**50


def case(seed, P=48, T=20, R=5):
    rng = np.random.default_rng(seed)
    pods = dict(
        valid=rng.random(P) < 0.9,
        req=rng.integers(0, BIG, (P, R)),
        req_present=rng.random((P, R)) < 0.7,
    )
    return rng, pods, rng.random((P, T)) < 0.4, rng.random(P) < 0.7


def jpods(pods):
    return jschema.PodBatch(**pods)


def tpods(pods):
    return tschema.pod_batch_from_arrays(pods, device=CPU)


def t(a):
    return torch.from_numpy(np.array(a))


def _same_all(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"{what}[{i}]")


def aggregates(rng, T, R):
    return (
        rng.integers(0, 1000, T),
        rng.integers(0, BIG, (T, R)),
        rng.integers(0, 50, (T, R)).astype(np.int32),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_used_matches_jax(seed):
    _, pods, mask, counted = case(seed)
    want = jagg.aggregate_used(jpods(pods), mask, counted)
    got = tagg.aggregate_used(tpods(pods), t(mask), t(counted))
    _same_all(got, want, "aggregate_used")


@pytest.mark.parametrize("chunk", [1, 7, None])
def test_chunked_masked_sums_match_unchunked(chunk):
    """The dense masked sums walk P in chunks; any chunk gives the one-shot
    result and JAX's (``None`` = P rows at once)."""
    _, pods, mask, counted = case(3, P=61)
    P = mask.shape[0]
    args = (t(mask), t(counted), t(pods["req"]), t(pods["req_present"]))
    whole = tagg._masked_sums(*args, chunk_rows=P)
    got = tagg._masked_sums(*args, chunk_rows=chunk or P)
    _same_all(got, whole, f"chunk={chunk}")
    want = jagg.aggregate_used(jpods(pods), mask, counted)
    _same_all(got, want, "vs JAX")


def test_default_chunk_caps_the_temporary():
    T, R = 16384, 8
    rows = tagg._chunk_rows(T, R)
    assert rows * T * R * 8 <= tagg.DENSE_CHUNK_BYTES < (rows + 1) * T * R * 8
    assert tagg._chunk_rows(1, 1) == tagg.DENSE_CHUNK_BYTES // 8
    assert tagg._chunk_rows(10**9, 64) == 1


def _padded_ids(rng, n, k, T):
    """int32[n,k] target rows: real rows, repeats, and the JAX pads — T,
    past T, and -1 (which counts from the end)."""
    ids = rng.integers(0, T, (n, k)).astype(np.int32)
    pads = rng.random((n, k))
    ids[pads < 0.25] = T
    ids[(pads >= 0.25) & (pads < 0.3)] = T + 3
    ids[(pads >= 0.3) & (pads < 0.33)] = -1
    return ids


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_pod_delta_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, R, K = 20, 5, 9
    base = aggregates(rng, T, R)
    ids = _padded_ids(rng, 1, K, T)[0]
    sign = rng.choice([-1, 0, 1], K).astype(np.int64)
    req = rng.integers(0, BIG, R)
    present = rng.random(R) < 0.6
    want = jagg.apply_pod_delta(*base, ids, sign, req, present)
    got = tagg.apply_pod_delta(*map(t, base), t(ids), t(sign), t(req), t(present))
    _same_all(got, want, "apply_pod_delta")


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_pod_deltas_batched_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, R, N, K = 20, 5, 13, 8
    base = aggregates(rng, T, R)
    ids = _padded_ids(rng, N, K, T)
    sign = rng.choice([-1, 0, 1], (N, K)).astype(np.int64)
    req = rng.integers(0, BIG, (N, R))
    present = rng.random((N, R)) < 0.6
    want = jagg.apply_pod_deltas_batched(*base, ids, sign, req, present)
    inputs = [t(a) for a in (*base, ids, sign, req, present)]
    snapshot = [a.clone() for a in inputs]
    got = tagg.apply_pod_deltas_batched(*inputs)
    _same_all(got, want, "apply_pod_deltas_batched")
    for a, b in zip(inputs, snapshot):  # the inputs are not written
        assert torch.equal(a, b)


def _cols(rng, T, K):
    cols = rng.integers(0, T, K).astype(np.int32)
    cols[::4] = T  # pads
    cols[1] = cols[2]  # a repeat
    cols[-1] = -1
    return cols


@pytest.mark.parametrize("seed", [0, 1])
def test_rebase_cols_matches_jax(seed):
    rng, pods, mask, counted = case(seed)
    T, R = mask.shape[1], pods["req"].shape[1]
    base = aggregates(rng, T, R)
    cols = _cols(rng, T, 11)
    want = jagg.rebase_cols(*base, jpods(pods), mask, counted, cols)
    got = tagg.rebase_cols(*map(t, base), tpods(pods), t(mask), t(counted), t(cols))
    _same_all(got, want, "rebase_cols")


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_cols_matches_jax(seed):
    rng, pods, mask, counted = case(seed)
    cols = _cols(rng, mask.shape[1], 11)
    want = jagg.aggregate_cols(jpods(pods), mask, counted, cols)
    got = tagg.aggregate_cols(tpods(pods), t(mask), t(counted), t(cols))
    _same_all(got, want, "aggregate_cols")


def test_throttled_flags_matches_jax():
    rng = np.random.default_rng(4)
    T, R = 40, 3
    args = (
        rng.integers(0, 5, T), rng.random(T) < 0.7,
        rng.integers(0, 4, (T, R)) * BIG, rng.random((T, R)) < 0.7,
        rng.integers(0, 5, T), rng.random(T) < 0.7,
        rng.integers(0, 4, (T, R)) * BIG, rng.random((T, R)) < 0.7,
    )
    _same_all(tagg.throttled_flags(*map(t, args)), jagg.throttled_flags(*args),
              "throttled_flags")


def test_streaming_deltas_equal_recompute():
    """Remove pod 3 and add a new pod through deltas: the aggregates equal a
    recompute from scratch over the changed pod set."""
    rng, pods, mask, _ = case(11, P=10, T=5, R=3)
    pods["valid"][:] = True
    counted = np.ones(10, dtype=bool)
    agg = tagg.aggregate_used(tpods(pods), t(mask), t(counted))

    T, K = 5, 5
    new_req = rng.integers(0, BIG, 3)
    new_present = np.array([True, False, True])
    new_row = rng.random(T) < 0.6
    for row, req, present, sign in (
        (mask[3], pods["req"][3], pods["req_present"][3], -1),
        (new_row, new_req, new_present, +1),
    ):
        hit = np.flatnonzero(row).astype(np.int32)
        ids = np.full(K, T, dtype=np.int32)  # pad out of range
        ids[: hit.size] = hit
        signs = np.zeros(K, dtype=np.int64)
        signs[: hit.size] = sign
        agg = tagg.apply_pod_delta(*agg, t(ids), t(signs), t(req), t(present))

    keep = [i for i in range(10) if i != 3]
    pods2 = dict(
        valid=np.ones(10, dtype=bool),
        req=np.vstack([pods["req"][keep], new_req]),
        req_present=np.vstack([pods["req_present"][keep], new_present]),
    )
    mask2 = np.vstack([mask[keep], new_row])
    want = tagg.aggregate_used(tpods(pods2), t(mask2), t(np.ones(10, dtype=bool)))
    for g, w in zip(agg, want):
        assert torch.equal(g, w)


def _pending(seed, ks, n=17):
    rng = np.random.default_rng(seed)
    pending = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        cols = rng.choice(ks.tcap - 1, size=k, replace=False).astype(np.int32)
        pending.append((cols, int(rng.choice([-1, 1])),
                        rng.integers(0, 10**9, size=ks.R).astype(np.int64),
                        rng.random(ks.R) > 0.5))
    base = (
        rng.integers(0, 50, size=ks.tcap).astype(np.int64),
        rng.integers(0, 10**10, size=(ks.tcap, ks.R)).astype(np.int64),
        rng.integers(0, 20, size=(ks.tcap, ks.R)).astype(np.int32),
    )
    return pending, base


def test_host_delta_route_matches_device_route(monkeypatch):
    """``apply_pending_batched``: the host mirror (numpy) ≡ the
    ``KT_AGG_DEVICE_DELTAS=1`` route (the torch scatter on the manager's
    device) ≡ the JAX kernel, over the same encoded burst."""
    ks = tds._KindState("throttle", tschema.DimRegistry(), device=CPU)
    pending, base = _pending(7, ks)

    def run(device_route):
        monkeypatch.setattr(tds, "_AGG_DEVICE_DELTAS", device_route)
        ks.agg_cnt, ks.agg_req, ks.agg_contrib = (a.copy() for a in base)
        ks.apply_pending_batched(list(pending))
        return ks.agg_cnt.copy(), ks.agg_req.copy(), ks.agg_contrib.copy()

    host, device = run(False), run(True)
    ks.agg_cnt, ks.agg_req, ks.agg_contrib = base
    want = jagg.apply_pod_deltas_batched(*base, *ks._pending_batch_arrays(pending))
    for h, d, w in zip(host, device, want):
        assert h.dtype == d.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(h, d)
        np.testing.assert_array_equal(d, np.asarray(w))


def test_device_delta_route_end_to_end(monkeypatch):
    """Pod churn reconciled with ``KT_AGG_DEVICE_DELTAS=1`` writes the same
    ``status.used`` as the host route."""
    from tests.test_torch_tick import add_pod, port_stack, populate

    monkeypatch.setenv("KT_VERDICT_CACHE", "0")

    def run(device_route):
        monkeypatch.setattr(tds, "_AGG_DEVICE_DELTAS", device_route)
        store, plugin = port_stack()
        rng = random.Random(5)
        populate(store, rng, n_thr=12, n_pods=40)
        plugin.run_pending_once()
        for i in range(30):  # churn after the first full rebase
            add_pod(store, f"churn{i}", rng)
            if i % 3 == 0:
                store.delete_pod("default", f"p{i}")
        plugin.run_pending_once()
        used = {thr.key: thr.status.used for thr in store.list_throttles()}
        plugin.stop()
        return used

    host = run(False)
    assert run(True) == host
    assert any(u.resource_counts for u in host.values())
