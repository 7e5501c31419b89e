"""The pod informer's O(1) count (``Indexer.count``, ``PodLister.count``):
what the batch-triage dedupe probe reads to decide its size gate before
it lists any pod."""

import pytest

from kube_throttler_tpu_torch.api.pod import make_pod
from kube_throttler_tpu_torch.client import SharedInformerFactory
from kube_throttler_tpu_torch.client.informers import NAMESPACE_INDEX, Indexer
from kube_throttler_tpu_torch.client.listers import PodLister
from kube_throttler_tpu_torch.engine.store import Store
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def _indexer(mode):
    """An indexer in object mode, or in resolver mode over a dict that
    stands in for the columnar store."""
    funcs = {NAMESPACE_INDEX: lambda obj: [obj.namespace]}
    if mode == "objects":
        return Indexer(funcs), None
    backing = {}
    return Indexer(funcs, resolver=backing.get), backing


def _upsert(indexer, backing, pod, key=None):
    key = key or pod.key
    if backing is not None:
        backing[key] = pod
    indexer.upsert(key, pod)


@pytest.mark.parametrize("mode", ["objects", "resolver"])
class TestIndexerCount:
    def test_empty(self, mode):
        indexer, _ = _indexer(mode)
        assert indexer.count() == 0 == len(indexer.list())

    def test_upserts_reupserts_and_deletes(self, mode):
        indexer, backing = _indexer(mode)
        for i in range(5):
            _upsert(indexer, backing, make_pod(f"p{i}", namespace=f"ns{i % 2}"))
        assert indexer.count() == 5 == len(indexer.list())
        # the same key again, once with its index values unchanged and once
        # with another namespace index value: still one key each
        _upsert(indexer, backing, make_pod("p0", namespace="ns0"))
        _upsert(indexer, backing, make_pod("p1", namespace="ns9"), key="ns1/p1")
        assert indexer.count() == 5 == len(indexer.list())
        indexer.delete("ns0/p2")
        indexer.delete("ns0/absent")
        if backing is not None:
            del backing["ns0/p2"]
        assert indexer.count() == 4 == len(indexer.list())
        for key in indexer.keys():
            indexer.delete(key)
        assert indexer.count() == 0 == len(indexer.list())


def test_resolver_none_is_counted_but_not_listed():
    """A key whose resolver returns None (the object went between the
    indexer's event and the read) stays in the count and drops out of the
    listing: the count is an upper bound on the listing, so the probe
    keeps its check of the listing's length."""
    indexer, backing = _indexer("resolver")
    for i in range(3):
        _upsert(indexer, backing, make_pod(f"p{i}"))
    del backing["default/p1"]
    assert indexer.count() == 3
    assert sorted(p.name for p in indexer.list()) == ["p0", "p2"]


@pytest.mark.parametrize("columnar", [False, True])
def test_pod_lister_count_equals_the_informers(columnar):
    store = Store(columnar=columnar)
    factory = SharedInformerFactory(store, resync_period=0)
    indexer = factory.pods().indexer
    lister = PodLister(indexer)
    for i in range(7):
        store.create_pod(make_pod(f"p{i}", namespace=f"ns{i % 3}"))
    store.delete_pod("ns0", "p3")
    assert lister.count() == indexer.count() == 6
    assert lister.count() == len(lister.list()) == len(store.list_pods())
    factory.shutdown()
