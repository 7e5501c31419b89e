"""The port's verdict-coherence assassin
(kube_throttler_tpu_torch/utils/epochassert.py): the port copy of
tests/test_epochassert.py, every plugin on the CPU.

The epochs static checker proves every visible verdict-plane write is
dominated by a bump; these tests pin the runtime companion that keeps
that proof honest: a planted bump-free mutation MUST surface as a
StaleVerdict on the next sampled cache hit (must-fire, like the
lockorder/racedetect planted-bug suites), a clean stack must survive
shadow-recompute silently, and the report must carry the forensics an
operator needs — both epochs (equal: the smoking gun), both verdicts,
and the file:line of the mutation that skipped its bump.
"""

from __future__ import annotations

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
from kube_throttler_tpu_torch.plugin.framework import Status, StatusCode
from kube_throttler_tpu_torch.utils import epochassert


def _throttle(name="t1", cpu="200m", grp="a"):
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(requests={"cpu": cpu}),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(
                        pod_selector=LabelSelector(match_labels={"grp": grp})
                    ),
                )
            ),
        ),
    )


def _stack():
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
    plugin.run_pending_once()
    assert plugin.verdict_cache is not None
    assert plugin._epoch_assert, "conftest must arm KT_EPOCH_ASSERT before imports"
    return store, plugin


@pytest.fixture(autouse=True)
def _isolate():
    """Every-hit sampling inside these tests; restore the suite default
    (and drop first-observation state) on the way out so the rest of the
    armed suite is unaffected by what we plant here."""
    epochassert.reset()
    epochassert.set_sample(1)
    yield
    epochassert.reset()


def _plant_bump_free_flip(plugin):
    """The bug class itself: flip t1's throttled flags directly on the
    staging planes with correct dirty tracking (so the device sync sees
    it — a real buggy mutator would do this much) but WITHOUT the
    col_epoch bump the epoch contract demands."""
    ks = plugin.device_manager.throttle
    col = ks.index._thr_cols["default/t1"]
    before = (ks.tcap, ks.R)
    ks.st_cnt_throttled[col] = True
    ks.st_req_throttled[col, :] = True
    ks.st_req_flag_present[col, :] = True
    ks._note_thr_col(col, before)  # MISSING: ks.col_epoch[col] += 1
    return col


class TestAssassin:
    def test_clean_hits_survive_shadow_recompute(self):
        _, plugin = _stack()
        pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
        first = plugin.pre_filter(pod)
        assert first.code is StatusCode.SUCCESS
        # sample=1: every one of these hits is shadow-recomputed
        for _ in range(5):
            assert plugin.pre_filter(pod) is first
        assert epochassert.reports() == []

    def test_planted_missed_bump_fires_staleverdict(self):
        _, plugin = _stack()
        pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
        assert plugin.pre_filter(pod).code is StatusCode.SUCCESS  # interned
        _plant_bump_free_flip(plugin)
        with pytest.raises(epochassert.StaleVerdict) as ei:
            plugin.pre_filter(pod)
        msg = str(ei.value)
        # the smoking gun: the fingerprint did NOT move
        assert "(UNCHANGED)" in msg
        assert "cached verdict" in msg and "oracle verdict" in msg
        # mutation provenance: _note_thr_col recorded the planter's frame
        assert "test_torch_epochassert.py" in msg, msg
        assert len(epochassert.reports()) == 1

    def test_first_observation_only_per_key(self):
        _, plugin = _stack()
        pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
        plugin.pre_filter(pod)
        _plant_bump_free_flip(plugin)
        with pytest.raises(epochassert.StaleVerdict):
            plugin.pre_filter(pod)
        # same stale key again: already reported — the hit is served
        # without a second raise (one report per distinct missed bump,
        # not one per probe)
        st = plugin.pre_filter(pod)
        assert st.code is StatusCode.SUCCESS  # still the stale intern
        assert len(epochassert.reports()) == 1

    def test_error_recompute_is_not_coherence_evidence(self):
        _, plugin = _stack()
        pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
        first = plugin.pre_filter(pod)
        plugin._pre_filter_uncached = lambda p, emit_events=True: Status(
            StatusCode.ERROR, ("device transiently down",)
        )
        assert plugin.pre_filter(pod) is first  # hit survives, no report
        assert epochassert.reports() == []

    def test_sampling_counter_is_every_nth(self):
        epochassert.set_sample(3)
        got = [epochassert.should_check() for _ in range(7)]
        assert got == [False, False, True, False, False, True, False]

    def test_malformed_sample_env_falls_back(self, monkeypatch):
        monkeypatch.setenv("KT_EPOCH_ASSERT_SAMPLE", "every-other")
        epochassert.reset()  # re-reads the env; malformed → default 7
        got = [epochassert.should_check() for _ in range(7)]
        assert got == [False] * 6 + [True]

    def test_note_mutation_bounded_and_newest_last(self):
        for _ in range(20):
            epochassert.note_mutation(depth=1)
        _, plugin = _stack()
        pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
        plugin.pre_filter(pod)
        _plant_bump_free_flip(plugin)
        with pytest.raises(epochassert.StaleVerdict) as ei:
            plugin.pre_filter(pod)
        # the deque is bounded: the 20 synthetic sites did not crowd out
        # the planted mutation (newest entries win)
        assert "_plant_bump_free_flip" in str(ei.value)
