"""The selector index's pod-row table (``SelectorIndex.pod_row_table``).

One table per pod-set version: the pod keys in the index's row-map order,
each key's row, and each key's namespace (from its ``namespace/`` prefix)
as a code. The version moves only when a key enters or leaves the index,
a table is never written after it is handed out, and as a read-only
mapping it answers as the ``{pod_key: row}`` dict it replaces in the
batch check and the tick.
"""

from __future__ import annotations

import random
from dataclasses import replace

import numpy as np
import pytest

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.index import PodRowTable, SelectorIndex
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from torch_race_gate import race_gate  # noqa: F401  (autouse: the port's race gate)

KINDS = ("throttle", "clusterthrottle")


def _pod(i, ns=None, **labels):
    return make_pod(f"p{i}", namespace=ns or f"ns-{i % 5}", labels=labels or {"app": f"a{i % 3}"})


def _expected(index):
    """The dict the batch surfaces copied before the table, and each key's
    namespace from its prefix."""
    with index._lock:
        rows = dict(index._pod_rows)
    return rows, [k.partition("/")[0] for k in rows]


def _assert_matches_index(index):
    table = index.pod_row_table()
    rows, namespaces = _expected(index)
    assert table.pod_keys == tuple(rows)
    assert table.rows.tolist() == list(rows.values())
    assert table.rows.dtype == np.int64 and table.ns_codes.dtype == np.int32
    assert [table.ns_names[c] for c in table.ns_codes.tolist()] == namespaces
    # it names the namespaces that hold a pod now, each once, and no other
    assert sorted(table.ns_names) == sorted(set(namespaces))
    assert dict(table) == rows and list(table) == list(rows)
    return table


def _churn(index, rng, n_ops=120):
    """Inserts, removes (their rows go to the free list and are reused)
    and modifies that keep the key, in a seeded order."""
    live = {}
    nxt = 0
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.5 or not live:
            pod = _pod(nxt, ns=f"ns-{rng.randrange(7)}")
            index.upsert_pod(pod)
            live[pod.key] = pod
            nxt += 1
        elif op < 0.8:
            key = rng.choice(sorted(live))
            index.remove_pod(key)
            del live[key]
        else:
            key = rng.choice(sorted(live))
            pod = replace(live[key], labels={"app": f"a{rng.randrange(9)}"})
            index.upsert_pod(pod)
            live[key] = pod
    return nxt


@pytest.mark.parametrize("seed", range(4))
def test_table_is_the_row_map_after_churn(seed):
    index = SelectorIndex("throttle")
    inserted = _churn(index, random.Random(seed))
    with index._lock:
        rows_used = len(index._pod_rows) + len(index._free_rows)
    assert rows_used < inserted, "the churn reused no free row"
    _assert_matches_index(index)


def test_table_after_a_batch_upsert_and_free_row_reuse():
    index = SelectorIndex("clusterthrottle", pod_capacity=8)
    index.upsert_pods_batch([_pod(i) for i in range(20)])  # grows the capacity twice
    table = _assert_matches_index(index)
    for i in (3, 11, 17):
        index.remove_pod(f"ns-{i % 5}/p{i}")
    index.upsert_pods_batch([_pod(i, ns="ns-late") for i in range(100, 103)])
    fresh = _assert_matches_index(index)
    assert fresh is not table
    with index._lock:
        assert sorted(index._pod_rows[f"ns-late/p{i}"] for i in range(100, 103)) == [3, 11, 17]
    assert "ns-late" in fresh.ns_names


@pytest.mark.parametrize("n_transient", [1, 8, 40])
def test_table_names_only_the_namespaces_that_hold_a_pod(n_transient):
    """Short-lived namespaces (a CI job's, a preview's) leave no name
    behind: once their pods are gone the table's namespace list is back
    to the live ones, however many came and went."""
    index = SelectorIndex("throttle")
    index.upsert_pods_batch([_pod(i, ns=f"ns-{i % 3}") for i in range(9)])
    for n in range(n_transient):
        pods = [_pod(100 + 2 * n + j, ns=f"ci-{n}") for j in range(2)]
        index.upsert_pod(pods[0])
        index.upsert_pods_batch(pods[1:])
        table = _assert_matches_index(index)
        assert len(table.ns_names) == 4 and f"ci-{n}" in table.ns_names
        for pod in pods:
            index.remove_pod(pod.key)
        table = _assert_matches_index(index)
        assert sorted(table.ns_names) == ["ns-0", "ns-1", "ns-2"]
    # a namespace in the middle of the list loses its pods: the others'
    # codes close up over the two that are left
    for i in (1, 4, 7):
        index.remove_pod(f"ns-1/p{i}")
    table = _assert_matches_index(index)
    assert sorted(table.ns_names) == ["ns-0", "ns-2"]
    assert sorted(set(table.ns_codes.tolist())) == [0, 1]


def test_version_moves_on_insert_and_remove_only():
    index = SelectorIndex("throttle")
    pod = _pod(1)
    index.upsert_pod(pod)
    first = index.pod_row_table()
    assert index.pod_row_table() is first
    # a modify that keeps the key (new labels, new object) keeps the table
    index.upsert_pod(replace(pod, labels={"app": "other"}))
    index.upsert_pods_batch([replace(pod, labels={"app": "third"})])
    assert index.pod_row_table() is first
    index.upsert_pod(_pod(2))
    inserted = index.pod_row_table()
    assert inserted.version > first.version
    index.remove_pod(pod.key)
    removed = index.pod_row_table()
    assert removed.version > inserted.version
    index.remove_pod("nowhere/none")  # a key the index never held
    assert index.pod_row_table() is removed


def test_a_handed_out_table_is_never_written():
    index = SelectorIndex("throttle")
    for i in range(12):
        index.upsert_pod(_pod(i))
    table = index.pod_row_table()
    before = (table.pod_keys, table.rows.copy(), table.ns_codes.copy(), table.ns_names, dict(table))
    index.remove_pod("ns-0/p0")
    index.upsert_pod(_pod(50, ns="ns-new"))
    index.upsert_pod(replace(_pod(3), labels={"app": "moved"}))
    assert index.pod_row_table() is not table
    assert table.pod_keys == before[0]
    assert np.array_equal(table.rows, before[1]) and np.array_equal(table.ns_codes, before[2])
    assert table.ns_names == before[3] and dict(table) == before[4]
    for arr in (table.rows, table.ns_codes):
        assert not arr.flags.writeable
        with pytest.raises(ValueError):
            arr[0] = 7
    with pytest.raises(TypeError):
        table["ns-1/p1"] = 3  # noqa: the mapping is read-only


def test_it_answers_as_the_dict_it_replaces():
    index = SelectorIndex("throttle")
    for i in range(9):
        index.upsert_pod(_pod(i))
    index.remove_pod("ns-4/p4")
    table = index.pod_row_table()
    rows, _ = _expected(index)
    assert isinstance(table, PodRowTable)
    assert list(table.keys()) == list(rows.keys())
    assert list(table.values()) == list(rows.values())
    assert list(table.items()) == list(rows.items())
    assert table["ns-1/p1"] == rows["ns-1/p1"]
    with pytest.raises(KeyError):
        table["ns-4/p4"]
    assert table.get("ns-4/p4") is None and table.get("ns-4/p4", -1) == -1
    assert table.get("ns-2/p2") == rows["ns-2/p2"]
    assert len(table) == len(rows) == 8
    assert "ns-3/p3" in table and "ns-4/p4" not in table
    assert table == rows and rows == table and not (table != rows)
    assert table == index.pod_row_table()
    assert table != {**rows, "ns-4/p4": 4}
    assert table.keys() <= rows.keys() <= table.keys()


def test_filled_hands_out_a_fresh_dict_in_table_order():
    index = SelectorIndex("clusterthrottle")
    for i in range(7):
        index.upsert_pod(_pod(i))
    table = index.pod_row_table()
    for value in (True, False):
        first = table.filled(value)
        assert list(first) == list(table.pod_keys) and set(first.values()) == {value}
        first["ns-1/p1"] = not value
        del first["ns-2/p2"]
        second = table.filled(value)
        assert second is not first and second == dict.fromkeys(table.pod_keys, value)


def _device_plugin(n_pods=24):
    store = Store()
    for n in range(3):
        store.create_namespace(Namespace(f"ns-{n}"))
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store, use_device=True, device="cpu",
    )
    for i in range(n_pods):
        store.create_pod(
            make_pod(f"p{i}", namespace=f"ns-{i % 3}", requests={"cpu": "100m"},
                     node_name="node-0", phase="Running")
        )
    plugin.run_pending_once()
    return store, plugin


def _builds(plugin):
    counter = plugin.device_manager.row_table_build_counter
    return {key[0]: v for key, v in counter.collect().items()}


def test_one_build_per_kind_over_calls_on_a_static_store(monkeypatch):
    monkeypatch.setattr(KubeThrottler, "BATCH_DEDUPE_MAX_PODS", 0)
    store, plugin = _device_plugin()
    try:
        plugin.pre_filter_batch()
        first = _builds(plugin)
        assert set(first) == set(KINDS) and all(v >= 1 for v in first.values())
        outs = [plugin.pre_filter_batch() for _ in range(5)]
        plugin.full_tick_sharded(1)
        assert _builds(plugin) == first
        assert all(o == outs[0] for o in outs) and len(outs[0]["schedulable"]) == 24
        # every call built its own result
        assert len({id(o["schedulable"]) for o in outs}) == len(outs)
        store.create_pod(make_pod("late", namespace="ns-1", requests={"cpu": "1m"}))
        plugin.pre_filter_batch()
        plugin.pre_filter_batch()
        assert _builds(plugin) == {k: v + 1 for k, v in first.items()}
    finally:
        plugin.stop()
