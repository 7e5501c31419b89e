"""Port faults that the armed race detector found, each held by a test
that fails without its fix.

Fault (k): ``PreemptCoordinator._tracking_enabled`` read
``PolicyEngine.generation`` without the engine's lock. It runs on the pod
event path, on whichever thread applies the event (under the store's
lock, not the engine's), while ``set_specs`` bumps the generation under
the engine's lock on another: a lockset race that the chip smoke's
``[armed]`` phase, rehearsed on the CPU, reported. The read now goes
through ``PolicyEngine.current_generation()``.

Fault (l): the verdict-coherence assassin (``utils/epochassert.py``)
raised ``StaleVerdict`` for a cache hit whose shadow recompute saw a
covered mutation that landed, with its epoch bump, after the lookup. Its
own criterion is a divergence at an unchanged epoch sum; under churn
(the chip smoke's ``[armed]`` probes of the churned groups) a served hit
could fail a correct stack. ``check_hit`` now re-reads the fingerprint
after the recompute and reports only when it has not moved.

Fault (m): the shard worker's reaper (``ShardCore.reap_stale_txns`` and
``reap_stale_handoffs``) rewrote ``reaped_txns`` and ``reaped_handoffs``
on every pass, ``+= 0`` when it reaped nothing. A bare read of a counter
between two passes (the sharding tests read ``core.reaped_txns``) then
met a later idle write: a race report whose appearance hung on whether
the reaper woke once more before the file's teardown. A pass now writes
a counter only when it reaped something."""

import threading
import time

import pytest

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.plugin.framework import StatusCode
from kube_throttler_tpu_torch.sharding.worker import ShardCore
from kube_throttler_tpu_torch.utils import epochassert, racedetect
from tests.test_torch_epochassert import _plant_bump_free_flip, _stack

POLICY = {"name": "p", "preemptionEnabled": True, "minPriorityGap": 1}


def test_policy_generation_is_read_under_its_lock_on_the_pod_event_path():
    assert racedetect.enabled(), "the suite arms KT_RACE_DETECT"
    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store, device="cpu",
    )
    store.create_namespace(Namespace("default"))
    racedetect.reset()  # a qual reports once a process: forget earlier modules'
    with racedetect.capture() as cap:
        plugin.set_policy_specs([dict(POLICY)])
        # a pod event on another thread: the coordinator's policy gate
        t = threading.Thread(target=lambda: store.create_pod(
            make_pod("p0", requests={"cpu": "100m"}, node_name="n", phase="Running")))
        t.start()
        t.join()
        plugin.set_policy_specs([dict(POLICY, name="q")])
    assert plugin.policy.current_generation() == 2
    assert [r.render() for r in cap.reports] == []


@pytest.fixture
def every_hit_checked():
    epochassert.reset()
    epochassert.set_sample(1)
    yield
    epochassert.reset()


def test_a_bumped_mutation_between_a_hit_and_its_recompute_is_no_stale_verdict(every_hit_checked):
    _, plugin = _stack()
    pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
    first = plugin.pre_filter(pod)
    assert first.code is StatusCode.SUCCESS  # interned
    uncached = plugin._pre_filter_uncached

    def racing(p, emit_events=True):
        """The recompute, with a covered mutation and its bump landing
        just before it, as another thread's would."""
        plugin._pre_filter_uncached = uncached
        col = _plant_bump_free_flip(plugin)
        plugin.device_manager.throttle.col_epoch[col] += 1
        return uncached(p, emit_events)

    plugin._pre_filter_uncached = racing
    assert plugin.pre_filter(pod) is first  # the hit, looked up before the mutation
    assert epochassert.reports() == []
    # the next lookup misses at the moved epoch and sees the flip
    assert plugin.pre_filter(pod).code is not StatusCode.SUCCESS
    assert epochassert.reports() == []


def test_a_missed_bump_is_still_a_stale_verdict(every_hit_checked):
    """The guard leaves the assassin's own case alone."""
    _, plugin = _stack()
    pod = make_pod("p", labels={"grp": "a"}, requests={"cpu": "100m"})
    assert plugin.pre_filter(pod).code is StatusCode.SUCCESS
    _plant_bump_free_flip(plugin)
    with pytest.raises(epochassert.StaleVerdict, match="UNCHANGED"):
        plugin.pre_filter(pod)
    assert len(epochassert.reports()) == 1


def _on_reaper_thread(fn):
    t = threading.Thread(target=fn, name="shard0-reaper")
    t.start()
    t.join()


@pytest.mark.parametrize("counter", ["reaped_txns", "reaped_handoffs"])
def test_reaper_counter_is_left_alone_by_a_pass_that_reaps_nothing(counter):
    assert racedetect.enabled(), "the suite arms KT_RACE_DETECT"
    core = ShardCore(0, 1, use_device=False, prepare_ttl=1000.0)
    try:
        core.store.create_namespace(Namespace("default"))
        pod = make_pod("orphan", requests={"cpu": "100m"})
        assert core.rpc("reserve_prepare", {"txn": "orphan", "pod": pod})[0]
    finally:
        core.stop()
    core._reaper.join()  # its own first pass would come a second later
    racedetect.reset()  # a qual reports once a process: forget earlier modules'
    later = time.monotonic() + 2 * core.prepare_ttl
    with racedetect.capture() as cap:
        # the front died between prepare and commit: the reaper aborts it
        _on_reaper_thread(lambda: core.reap_stale_txns(now=later))
        seen = getattr(core, counter)  # bare, as the sharding tests read it
        _on_reaper_thread(lambda: core.reap_stale_txns(now=later))  # idle
    assert seen == (1 if counter == "reaped_txns" else 0)
    assert [r.render() for r in cap.reports] == []
