"""Kill-a-shard robustness smoke: SIGKILL a worker process mid-churn.

Drives the REAL multiprocess stack (front + ShardSupervisor + worker
subprocesses over socketpair IPC, tools/harness.py fixtures/oracles):

- while a shard is dark, the front degrades FAIL-SAFE — pods matching
  that shard's keyspace report unschedulable, health reports degraded;
- the supervisor restarts the worker and resyncs its keyspace slice;
- after recovery, verdicts equal a single-process oracle over the same
  final state and every published throttled flag equals the recomputed
  one — no lost flips.

The second test arms the ``shard.worker.kill`` fault site instead of an
external SIGKILL: the worker dies BY THE SEEDED PLAN at its Nth routed
event batch (the registered chaos site), and the same recovery contract
holds.
"""

from __future__ import annotations

import os
import signal
import time

import pytest

import tools.harness_torch as H
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.plugin.framework import StatusCode
from kube_throttler_tpu_torch.sharding.front import AdmissionFront
from kube_throttler_tpu_torch.sharding.supervisor import ShardSupervisor
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

N_SHARDS = 2
N_GROUPS = 6
N_PODS = 24


def _seed(front):
    front.store.create_namespace(Namespace("default"))
    for i in range(N_GROUPS):
        front.store.create_throttle(H.make_throttle(i))
    for i in range(N_PODS):
        front.store.create_pod(_pod(i, 500))


def _pod(i, cpu_m):
    return make_pod(
        f"p{i}",
        labels={"grp": f"g{i % N_GROUPS}"},
        requests={"cpu": f"{cpu_m}m"},
        node_name="node-1",
        phase="Running",
    )


def _churn(front, rng, n=40):
    for _ in range(n):
        i = rng.randrange(N_PODS)
        front.store.update_pod(_pod(i, rng.randrange(1, 9) * 100))


def _oracle_state(front):
    """Single-process oracle over a copy of the front's final state."""
    store = Store()
    store.create_namespace(Namespace("default"))
    for thr in front.store.list_throttles():
        store.create_throttle(thr)
    for pod in front.store.list_pods():
        store.create_pod(pod)
    plugin = H.build_plugin(store)
    plugin.run_pending_once()
    return store, plugin


def _assert_converged(front):
    """Verdict + flip oracle: front verdicts ≡ single-process verdicts on
    the same state, and every published flag ≡ deterministic recompute."""
    store, oracle = _oracle_state(front)
    for pod in store.list_pods():
        got, want = front.pre_filter(pod), oracle.pre_filter(pod)
        assert got.code == want.code, (pod.key, got.reasons, want.reasons)
        assert H.normalized_reasons(got.reasons) == H.normalized_reasons(
            want.reasons
        ), pod.key
    for thr in front.store.list_throttles():
        want_thr = H.recompute_status(front.store, thr)
        assert thr.status.throttled.resource_counts_pod == (
            want_thr.status.throttled.resource_counts_pod
        ), thr.key
        assert thr.status.throttled.resource_requests.get("cpu") == (
            want_thr.status.throttled.resource_requests.get("cpu")
        ), thr.key
        assert thr.status.used == want_thr.status.used, thr.key


def _settle(front, timeout=60.0):
    assert front.drain(timeout=timeout)
    time.sleep(0.8)  # status pushes flush on their own cadence


def _wait_health(front, state, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got, _ = front._shards_health()
        if got == state:
            return True
        time.sleep(0.1)
    return False


@pytest.fixture
def sharded_stack(tmp_path):
    front = AdmissionFront(N_SHARDS)
    sup = ShardSupervisor(
        front, use_device=False, restart_backoff=0.3,
        env={**os.environ, "KT_SHARD_QUIET": "1", "KT_LOCK_ASSERT": "0"},
    )
    try:
        sup.start(ready_timeout=180.0)
        yield front, sup
    finally:
        sup.stop()
        front.stop()


def test_sigkill_worker_mid_churn_degrades_then_recovers(sharded_stack):
    import random

    front, sup = sharded_stack
    rng = random.Random(7)
    _seed(front)
    _settle(front)
    # pick a victim shard + a pod whose verdict depends on it
    victim = front.owner_of("Throttle", "default/t1")
    probe = make_pod("probe", labels={"grp": "g1"}, requests={"cpu": "100m"})
    assert victim in front._pod_target_shards(probe)
    _churn(front, rng, 30)
    os.kill(sup.shard_proc(victim).pid, signal.SIGKILL)
    _churn(front, rng, 20)  # churn continues against a dark shard
    # degraded window: fail-safe verdicts + degraded health (sampled
    # before the supervisor's restart completes)
    saw_failsafe = False
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        status = front.pre_filter(probe)
        state, _ = front._shards_health()
        if (
            status.code == StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE
            and any("shard[unavailable]" in r for r in status.reasons)
        ):
            saw_failsafe = True
            assert state in ("degraded", "down")
            break
        if state == "ok" and sup.restart_counts()[victim] > 0:
            break  # restarted before we could sample the window
        time.sleep(0.01)
    assert saw_failsafe or sup.restart_counts()[victim] > 0
    # recovery: restart + resync must bring health back and lose nothing
    assert _wait_health(front, "ok", timeout=120.0)
    assert sup.restart_counts()[victim] >= 1
    _churn(front, rng, 20)  # post-recovery churn lands on the rejoined shard
    _settle(front)
    _assert_converged(front)


@pytest.mark.slow
def test_sharded_bad_day_scenario_gates():
    """The composed bad-day trace through 4 shard workers with a
    kill-a-shard episode (scenarios/sharded.py — the make scenario-test
    rung): pace, recovery, flip-p99, and zero-wrong-verdict gates."""
    from kube_throttler_tpu_torch.scenarios.sharded import run_sharded_bad_day

    report = run_sharded_bad_day(n_shards=4, seed=0, device="cpu")
    assert report["pass"], report["gates"]


def test_fault_site_shard_worker_kill_recovers(tmp_path):
    """The registered ``shard.worker.kill`` site: the worker SIGKILLs
    ITSELF at its 6th routed event batch (seeded FaultPlan, the crash
    harness idiom) — same degrade/restart/resync/no-lost-flips contract."""
    import random

    front = AdmissionFront(N_SHARDS)
    sup = ShardSupervisor(
        front, use_device=False, restart_backoff=0.3,
        worker_args=["--fault-site", "shard.worker.kill:kill:5"],
        env={**os.environ, "KT_SHARD_QUIET": "1", "KT_LOCK_ASSERT": "0"},
    )
    rng = random.Random(11)
    try:
        sup.start(ready_timeout=180.0)
        _seed(front)
        # churn until the plan fires on some worker (hit 6 at one shard)
        deadline = time.monotonic() + 60.0
        while (
            sum(sup.restart_counts().values()) == 0
            and time.monotonic() < deadline
        ):
            _churn(front, rng, 10)
            time.sleep(0.1)
        assert sum(sup.restart_counts().values()) >= 1, "fault site never fired"
        assert _wait_health(front, "ok", timeout=120.0)
        _settle(front)
        _assert_converged(front)
    finally:
        sup.stop()
        front.stop()
