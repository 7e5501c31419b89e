"""The plain reference against the program on the CPU, at tiny sizes of
both configurations: selector matches, the written thresholds and used,
every pair's four-step status, and each cell's whole run."""

from __future__ import annotations

from datetime import datetime, timezone

import numpy as np
import pytest

from gpubench import adapter, cluster as cluster_mod
from gpubench.reference import semantics as S
from gpubench.reference.quantity import milli
from gpubench.tests.tiny import SEED, run_tiny, tiny_cell

CONFIGS = ("throttles-100k", "selector-terms")
STATUS = {"not-throttled": S.NOT_THROTTLED, "active": S.ACTIVE,
          "insufficient": S.INSUFFICIENT, "pod-requests-exceeds-threshold": S.EXCEEDS}


def _loaded(config: str, seed: int):
    cell = tiny_cell(f"{config}.triage")
    cl = cluster_mod.generate(cell.config, seed)
    store, plugin = adapter.build_plugin(cl, "cpu")
    return cl, store, plugin


@pytest.mark.parametrize("seed", [SEED, 7, 2**31 + 3])
@pytest.mark.parametrize("config", CONFIGS)
def test_pairs_and_statuses_equal_the_programs_oracle(config, seed):
    from kube_throttler_tpu_torch.api.types import ResourceAmount

    cl, store, plugin = _loaded(config, seed)
    now = datetime.now(timezone.utc)
    pods = {p.key: p for p in store.list_pods()}
    namespaces = {n.name: n for n in store.list_namespaces()}
    for ts, objs in ((cl.throttles, store.list_throttles()),
                     (cl.cluster_throttles, store.list_cluster_throttles())):
        ks = S.kind_state(ts, cl.pods, cl.namespaces, now)
        by_key = {o.key: o for o in objs}
        want_pairs = set()
        for key, obj in by_key.items():
            for pk, pod in pods.items():
                ok = (obj.spec.selector.matches_to_pod(pod) and pod.namespace == obj.namespace
                      if ts.kind == "throttle"
                      else obj.spec.selector.matches_to_pod(pod, namespaces[pod.namespace]))
                if ok:
                    want_pairs.add((pk, key))
        p, t = ks.pairs
        got_pairs = {(cl.pods.key(i, cl.namespaces), ts.keys[j]) for i, j in zip(p.tolist(), t.tolist())}
        assert got_pairs == want_pairs
        statuses = S.classify(ks.pairs, cl.pods, ks.thr, ks.use, ks.st, False, S.step3_of(ts.kind))
        for i, j, st in zip(p.tolist(), t.tolist(), statuses.tolist()):
            obj, pod = by_key[ts.keys[j]], pods[cl.pods.key(i, cl.namespaces)]
            assert STATUS[obj.check_throttled_for(pod, ResourceAmount(), False)] == st
        # the written used pod counts equal the reference's
        for j, key in enumerate(ts.keys):
            assert (by_key[key].status.used.resource_counts or 0) == int(ks.use[0][j])
    plugin.stop()


@pytest.mark.parametrize("config", ["throttles-100k"])  # the benchmark's configurations
def test_every_status_occurs_at_full_size(config):
    """The configuration is no degenerate one: at its full size all four
    statuses occur, and both verdicts."""
    cl = cluster_mod.generate(cluster_mod.load_config(config), SEED)
    now = datetime.now(timezone.utc)
    states = [S.kind_state(ts, cl.pods, cl.namespaces, now)
              for ts in (cl.throttles, cl.cluster_throttles)]
    seen = set()
    for ks in states:
        seen |= set(S.classify(ks.pairs, cl.pods, ks.thr, ks.use, ks.st, False,
                               S.step3_of(ks.ts.kind)).tolist())
    assert seen == {S.NOT_THROTTLED, S.ACTIVE, S.INSUFFICIENT, S.EXCEEDS}
    share = np.mean(list(S.verdicts(states, cl.pods, cl.namespaces).values()))
    assert 0.2 < share < 0.95


def test_override_window_replaces_the_threshold():
    R = 1
    base = S.Threshold(cnt=10, cnt_p=True, req=np.array([5000]), req_p=np.array([True]))
    now = datetime(2030, 1, 1, 12, tzinfo=timezone.utc)
    hour = lambda h: datetime(2030, 1, 1, h, tzinfo=timezone.utc)  # noqa: E731
    active_cnt = S.Threshold(cnt=3, cnt_p=True, req=np.array([0]), req_p=np.array([False]))
    active_req = S.Threshold(cnt=99, cnt_p=True, req=np.array([7]), req_p=np.array([True]))
    expired = S.Threshold(cnt=1, cnt_p=True, req=np.array([1]), req_p=np.array([True]))
    ts = S.ThrottleSet("throttle", ["a/t0", "a/t1"], np.array([0, 0]), [[], []], [base, base], [
        [S.Override(hour(9), hour(10), expired), S.Override(hour(11), hour(12), active_cnt),
         S.Override(hour(12), None, active_req)],
        [S.Override(hour(13), None, expired)],
    ])
    cnt, cnt_p, req, req_p = S.resolve(ts, now, R)
    # t0: first active wins per dimension (count from the first, cpu from the second)
    assert (cnt[0], cnt_p[0], req[0, 0], req_p[0, 0]) == (3, True, 7, True)
    # t1: nothing active, the base threshold
    assert (cnt[1], req[1, 0]) == (10, 5000)
    cnt, _, req, _ = S.resolve(ts, now, R, control="ignore_overrides")
    assert (cnt[0], req[0, 0]) == (10, 5000)


def test_quantities_are_exact_milli_units():
    assert milli("250m") == 250
    assert milli("1500M") == 1_500_000_000_000
    assert milli("2Gi") == 2 * 2**30 * 1000
    assert milli(4) == 4000
    with pytest.raises(ValueError):
        milli("0.0001")


@pytest.mark.parametrize("cell", [
    "throttles-100k.triage", "selector-terms.triage",
])
def test_whole_run_is_correct_on_the_cpu(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("config", CONFIGS)
def test_triage_through_the_batch_kernels_route(config, monkeypatch):
    """Below the dedupe probe's pod limit the tiny cluster takes the
    grouped route; with the limit at 0 it takes the device dispatch, the
    route the full-size cells take."""
    from kube_throttler_tpu_torch.plugin import KubeThrottler

    monkeypatch.setattr(KubeThrottler, "BATCH_DEDUPE_MAX_PODS", 0)
    out = run_tiny(f"{config}.triage")
    assert out["correct"], out["checks"]
