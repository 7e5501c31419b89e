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
after the recompute and reports only when it has not moved."""

import threading

import pytest

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from kube_throttler_tpu_torch.plugin.framework import StatusCode
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
