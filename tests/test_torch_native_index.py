"""Parity tests: native C++ row-match tier vs the pure-Python SelectorIndex.

The native engine (kube_throttler_tpu_torch/native/ktnative.cpp) must reproduce the Python tier's
mask bit-for-bit over every selector shape the reference supports:
matchLabels-only terms (throttle_selector.go:30-54), ClusterThrottle
namespace selectors (clusterthrottle_selector.go:112-141), matchExpressions
falling back to the general tier, empty selectors (match nothing), empty
terms (match everything), unknown namespaces, and object churn.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    LabelSelector,
    LabelSelectorRequirement,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.engine.index import SelectorIndex
from kube_throttler_tpu_torch.native import NativeRowEngine, available

pytestmark = pytest.mark.skipif(not available(), reason="native library unavailable")


def _throttle(name, ns, terms):
    return Throttle(
        name=name,
        namespace=ns,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(pod=10),
            selector=ThrottleSelector(selector_terms=tuple(terms)),
        ),
    )


def _cluster(name, terms):
    return ClusterThrottle(
        name=name,
        spec=ClusterThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(pod=10),
            selector=ClusterThrottleSelector(selector_terms=tuple(terms)),
        ),
    )


def _pod(name, ns, labels):
    return make_pod(name, namespace=ns, labels=labels)


def test_native_engine_loads():
    assert NativeRowEngine("throttle") is not None


def test_engine_matchlabels_semantics():
    eng = NativeRowEngine("throttle")
    # col 0: ns 7, one term {1:2}; col 1: ns 7, empty selector (no terms)
    eng.set_col(0, 7, [([(1, NativeRowEngine.OP_EQ, (2,))], [])])
    eng.set_col(1, 7, [])
    # col 2: empty TERM — matches every pod in ns 7
    eng.set_col(2, 7, [([], [])])
    match, general = eng.match_row(7, True, {1: 2, 3: 4}, {})
    assert list(match) == [1, 0, 1] and not general.any()
    # wrong namespace gates everything off
    match, _ = eng.match_row(8, True, {1: 2}, {})
    assert list(match) == [0, 0, 0]
    # missing label key → no match
    match, _ = eng.match_row(7, True, {3: 4}, {})
    assert list(match) == [0, 0, 1]


def test_engine_cluster_ns_gate():
    eng = NativeRowEngine("clusterthrottle")
    eng.set_col(0, -1, [([(1, NativeRowEngine.OP_EQ, (1,))], [(5, NativeRowEngine.OP_EQ, (6,))])])
    eng.set_col_general(1, -1)
    # namespace labels must satisfy the ns requirement
    match, general = eng.match_row(0, True, {1: 1}, {5: 6})
    assert match[0] == 1 and general[1] == 1
    match, general = eng.match_row(0, True, {1: 1}, {5: 7})
    assert match[0] == 0
    # unknown namespace: nothing matches, general tier not consulted
    match, general = eng.match_row(0, False, {1: 1}, {5: 6})
    assert not match.any() and not general.any()


def test_engine_clear_and_or_terms():
    eng = NativeRowEngine("throttle")
    eng.set_col(0, 1, [([(1, NativeRowEngine.OP_EQ, (1,))], []), ([(2, NativeRowEngine.OP_EQ, (2,))], [])])  # OR of two terms
    match, _ = eng.match_row(1, True, {2: 2}, {})
    assert match[0] == 1
    eng.clear_col(0)
    match, _ = eng.match_row(1, True, {2: 2}, {})
    assert match[0] == 0


def _rand_expr(rng, keys, values):
    op = rng.choice(["In", "NotIn", "Exists", "DoesNotExist"])
    if op in ("In", "NotIn"):
        vals = tuple(
            rng.choice(values) for _ in range(rng.randint(1, len(values)))
        )
    else:
        vals = ()
    return LabelSelectorRequirement(key=rng.choice(keys), operator=op, values=vals)


def _rand_term(rng, keys, values, with_ns):
    pod_sel = LabelSelector(
        match_labels={rng.choice(keys): rng.choice(values) for _ in range(rng.randint(0, 2))},
        match_expressions=(
            tuple(_rand_expr(rng, keys, values) for _ in range(rng.randint(1, 2)))
            if rng.random() < 0.4
            else ()
        ),
    )
    if with_ns:
        ns_sel = LabelSelector(
            match_labels={"env": rng.choice(values)} if rng.random() < 0.5 else {}
        )
        return ClusterThrottleSelectorTerm(pod_selector=pod_sel, namespace_selector=ns_sel)
    return ThrottleSelectorTerm(pod_selector=pod_sel)


def test_match_expressions_compile_natively():
    """In/NotIn/Exists/DoesNotExist evaluate in the C++ tier (no general
    flag); only selectors failing validation stay general."""
    idx = SelectorIndex("throttle", use_native=True)
    assert idx._native is not None
    idx.upsert_namespace(Namespace("default"))
    exprs = {
        "in": LabelSelectorRequirement("tier", "In", ("web", "api")),
        "notin": LabelSelectorRequirement("tier", "NotIn", ("db",)),
        "exists": LabelSelectorRequirement("canary", "Exists"),
        "dne": LabelSelectorRequirement("legacy", "DoesNotExist"),
    }
    for name, expr in exprs.items():
        idx.upsert_throttle(
            _throttle(name, "default", [
                ThrottleSelectorTerm(LabelSelector(match_expressions=(expr,)))
            ])
        )
    # evaluate via the row path and compare against the Python oracle
    for labels in (
        {"tier": "web"},
        {"tier": "db"},
        {"canary": "yes"},
        {"legacy": "x", "tier": "api"},
        {},
    ):
        pod = _pod("probe", "default", labels)
        got = set(idx.affected_throttle_keys_for(pod))
        want = {
            t.key
            for t in [
                _throttle(n, "default", [
                    ThrottleSelectorTerm(LabelSelector(match_expressions=(e,)))
                ])
                for n, e in exprs.items()
            ]
            if t.spec.selector.matches_to_pod(pod)
        }
        assert got == want, (labels, got, want)


def test_invalid_selector_stays_general_and_matches_nothing():
    idx = SelectorIndex("throttle", use_native=True)
    idx.upsert_namespace(Namespace("default"))
    bad = _throttle("bad", "default", [
        ThrottleSelectorTerm(
            LabelSelector(
                match_expressions=(
                    LabelSelectorRequirement("k", "In", ()),  # In needs values
                )
            )
        )
    ])
    idx.upsert_throttle(bad)
    pod = _pod("p", "default", {"k": "v"})
    assert idx.affected_throttle_keys_for(pod) == []


@pytest.mark.parametrize("kind", ["throttle", "clusterthrottle"])
def test_randomized_parity_with_python_tier(kind):
    """Drive identical event sequences through a native-backed and a pure-
    Python index; the [P,T] masks must stay identical at every step."""
    rng = random.Random(12345)
    keys = ["app", "tier", "team"]
    values = ["a", "b", "c"]
    namespaces = ["ns0", "ns1", "ns2"]

    nat = SelectorIndex(kind, pod_capacity=4, throttle_capacity=2, use_native=True)
    pure = SelectorIndex(kind, pod_capacity=4, throttle_capacity=2, use_native=False)
    assert nat._native is not None and pure._native is None

    def check():
        p = min(nat.mask.shape[0], pure.mask.shape[0])
        t = min(nat.mask.shape[1], pure.mask.shape[1])
        np.testing.assert_array_equal(nat.mask[:p, :t], pure.mask[:p, :t])
        assert not nat.mask[p:].any() and not pure.mask[p:].any()

    # known namespaces land first for two of three (ns2 stays unknown a while)
    for ns in namespaces[:2]:
        n = Namespace(ns, labels={"env": rng.choice(values)})
        nat.upsert_namespace(n)
        pure.upsert_namespace(n)

    pods, thrs = [], []
    for step in range(120):
        op = rng.random()
        if op < 0.35 or not pods:
            name = f"p{rng.randint(0, 20)}"
            ns = rng.choice(namespaces)
            pod = _pod(name, ns, {rng.choice(keys): rng.choice(values) for _ in range(rng.randint(0, 3))})
            pods.append(pod.key)
            nat.upsert_pod(pod)
            pure.upsert_pod(pod)
        elif op < 0.6 or not thrs:
            name = f"t{rng.randint(0, 10)}"
            terms = [
                _rand_term(rng, keys, values, with_ns=kind == "clusterthrottle")
                for _ in range(rng.randint(0, 2))
            ]
            thr = (
                _throttle(name, rng.choice(namespaces), terms)
                if kind == "throttle"
                else _cluster(name, terms)
            )
            thrs.append(thr.key)
            nat.upsert_throttle(thr)
            pure.upsert_throttle(thr)
        elif op < 0.75:
            key = rng.choice(pods)
            nat.remove_pod(key)
            pure.remove_pod(key)
        elif op < 0.9:
            key = rng.choice(thrs)
            nat.remove_throttle(key)
            pure.remove_throttle(key)
        else:
            ns = Namespace(rng.choice(namespaces), labels={"env": rng.choice(values)})
            nat.upsert_namespace(ns)
            pure.upsert_namespace(ns)
        check()

    # queries agree too
    for key in pods[:5]:
        assert nat.affected_throttle_keys(key) == pure.affected_throttle_keys(key)
    for key in thrs[:5]:
        assert sorted(nat.matched_pod_keys(key)) == sorted(pure.matched_pod_keys(key))
