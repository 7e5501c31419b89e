"""Seeded chaos runs over the integration stack: the invariants that matter
under churn and partial failure (SURVEY §5 — admission control is
only trustworthy under failure):

- **no lost/duplicated watch events after reconnect** — the local reflector
  cache converges to exact equality with the remote store despite stream
  cuts, 410 storms, and connection resets;
- **status converges after conflict storms** — injected 409s on the status
  subresource delay but never lose publications;
- **admission never over-admits while degraded** — device-dispatch faults
  flip the breaker through open/half-open mid-burst and the host oracle
  keeps the reservation arithmetic exact;
- **journal replay recovers to the pre-crash store** — torn/dropped writes
  and a failed compaction fsync, then a crash, still replay to the live
  store's exact contents.

The fast smoke variants run one seeded deterministic pass each (tier-1);
the randomized multi-seed soak is behind ``-m slow``.
"""

from __future__ import annotations

import random
import time
from dataclasses import replace

import pytest

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.serialization import object_to_dict
from kube_throttler_tpu_torch.api.types import (
    LabelSelector,
    ResourceAmount,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.client.mockserver import MockApiServer
from kube_throttler_tpu_torch.client.transport import RemoteSession, RestConfig
from kube_throttler_tpu_torch.engine.journal import attach
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.faults import FaultPlan
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

SMOKE_SEED = 1337


def _throttle(name, labels, **threshold):
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(**threshold),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels=labels)),
                )
            ),
        ),
    )


def _bound(pod):
    bound = replace(pod, spec=replace(pod.spec, node_name="node-1"))
    bound.status.phase = "Running"
    return bound


def _wait(predicate, timeout=20.0, every=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(every)
    return predicate()


def _dump(store: Store) -> dict:
    """Canonical content snapshot of every kind (no resourceVersions — the
    two stores version independently — and no uids: make_pod's uid counter
    is process-global, so independent same-seed runs differ only there)."""

    def strip(obj) -> dict:
        doc = object_to_dict(obj)
        (doc.get("metadata") or {}).pop("uid", None)
        return doc

    return {
        "Namespace": {n.name: strip(n) for n in store.list_namespaces()},
        "Pod": {p.key: strip(p) for p in store.list_pods()},
        "Throttle": {t.key: strip(t) for t in store.list_throttles()},
        "ClusterThrottle": {
            t.name: strip(t) for t in store.list_cluster_throttles()
        },
    }


# --------------------------------------------------------------------------
# remote-mode convergence: watch cuts + 410s + resets + conflict storms


def _remote_chaos_round(seed: int, pods: int = 24, settle_timeout: float = 30.0):
    """One seeded chaos pass over the remote-mode stack. Returns the plans
    (for firing assertions) after asserting the convergence invariants."""
    server = MockApiServer(bookmark_interval=0.02, log_size=512)
    remote = server.store
    remote.create_namespace(Namespace("default"))
    remote.create_throttle(_throttle("t1", {"grp": "a"}, pod=1000, requests={"cpu": "100"}))

    server_plan = FaultPlan(seed)
    # sever live watch streams; storm the status subresource with 409s
    server_plan.rule("mock.watch.cut", probability=0.10, times=6)
    server_plan.rule("mock.status.conflict", probability=0.25, times=8)
    server.faults = server_plan

    client_plan = FaultPlan(seed + 1)
    # client-side: torn streams, a 410 mid-read, resets on the REST path
    # (after= lets the initial 4-kind sync land before the storm starts)
    client_plan.rule("transport.watch.read", mode="close", probability=0.02, times=6)
    client_plan.rule("transport.watch.read", mode="gone", schedule=[25], times=1)
    client_plan.rule("transport.request", probability=0.05, times=5, after=12)

    server.start()
    local = Store()
    session = RemoteSession(
        RestConfig(server=server.url), local, faults=client_plan
    )
    session.start(sync_timeout=20)
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        local,
        use_device=True,
        start_workers=True,
        status_writer=session.status_committer, device="cpu",
    )
    try:
        rng = random.Random(seed)
        # churn: bound pods appear/mutate/disappear on the REMOTE cluster
        # while reconciles publish status back through the conflict storm
        alive = []
        for i in range(pods):
            name = f"chaos-{i:03d}"
            remote.create_pod(
                _bound(
                    make_pod(
                        name,
                        labels={"grp": "a"},
                        requests={"cpu": f"{rng.choice([50, 100, 150])}m"},
                    )
                )
            )
            alive.append(name)
            if rng.random() < 0.3 and len(alive) > 2:
                victim = alive.pop(rng.randrange(len(alive)))
                remote.delete_pod("default", victim)
            time.sleep(0.005)

        # settle: remote and local must converge to IDENTICAL content —
        # every delete/add survived the stream cuts and relists (no lost,
        # no resurrected/duplicated objects)
        assert _wait(
            lambda: {p.key for p in local.list_pods()}
            == {p.key for p in remote.list_pods()},
            timeout=settle_timeout,
        ), "local pod set never converged to remote"

        # ... and the throttle status converged THROUGH the conflict storm:
        # used counts exactly the bound matching pods (status publications
        # were delayed by 409s, never lost)
        expected = len(alive)
        assert _wait(
            lambda: remote.get_throttle("default", "t1").status.used.resource_counts
            == expected,
            timeout=settle_timeout,
        ), (
            f"remote status.used={remote.get_throttle('default', 't1').status.used.resource_counts} "
            f"never converged to {expected}"
        )
        # the echo closes the loop: local mirrors the remote status
        assert _wait(
            lambda: local.get_throttle("default", "t1") is not None
            and local.get_throttle("default", "t1").status.used.resource_counts
            == expected,
            timeout=settle_timeout,
        )
        # full-content equality across every kind
        assert _wait(lambda: _dump(local) == _dump(remote), timeout=settle_timeout)
        return server_plan, client_plan
    finally:
        plugin.stop()
        session.stop()
        server.stop()


def test_chaos_smoke_remote_convergence():
    """Tier-1 smoke: one seeded deterministic chaos pass; the plans must
    actually fire (a chaos test whose faults never trigger is a no-op)."""
    server_plan, client_plan = _remote_chaos_round(SMOKE_SEED)
    assert server_plan.fired() > 0, "server-side faults never fired"
    assert client_plan.fired() > 0, "client-side faults never fired"


# --------------------------------------------------------------------------
# admission: never over-admit while the device layer is degraded


def _admission_chaos_round(seed: int):
    store = Store()
    store.create_namespace(Namespace("default"))
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True,
        start_workers=False, device="cpu",
    )
    dm = plugin.device_manager
    now = [5000.0]
    dm._monotonic = lambda: now[0]
    plan = FaultPlan(seed)
    plan.rule("device.dispatch", probability=0.4)
    dm.faults = plan
    store.create_throttle(_throttle("burst", {"grp": "a"}, requests={"cpu": "1"}))
    plugin.run_pending_once()

    admitted = 0
    states = set()
    for i in range(21):
        pod = make_pod(f"b{i:02d}", labels={"grp": "a"}, requests={"cpu": "50m"})
        store.create_pod(pod)
        if plugin.pre_filter(pod).is_success():
            assert plugin.reserve(pod).is_success()
            admitted += 1
        states.add(dm.breaker_state())
        if i % 4 == 3:
            # roll the cooldown forward so the breaker cycles through
            # half-open probes mid-burst (probe outcome is fault-driven)
            now[0] += dm.device_retry_cooldown + 1
            states.add(dm.breaker_state())
    plugin.stop()
    return admitted, states, plan


def test_chaos_smoke_admission_never_over_admits():
    """21 × 50m against cpu=1 admits EXACTLY 20 — the host oracle keeps
    reservation arithmetic exact while injected dispatch faults flip the
    breaker through open and half-open mid-burst."""
    admitted, states, plan = _admission_chaos_round(SMOKE_SEED)
    assert admitted == 20, f"over/under-admission under device chaos: {admitted}"
    assert plan.fired("device.dispatch") > 0, "device faults never fired"
    assert "open" in states, "the breaker never opened — chaos was a no-op"


# --------------------------------------------------------------------------
# journal: replay converges to the pre-crash store


def _journal_chaos_round(seed: int, tmp_path, ops: int = 150):
    """Deterministic single-threaded journal chaos: torn writes, dropped
    writes, one failed compaction fsync — then heal (compact), crash, and
    replay. Returns (plan history, live dump, replayed dump)."""
    path = str(tmp_path / f"chaos-{seed}.journal")
    plan = FaultPlan(seed)
    plan.rule("journal.append", mode="torn", probability=0.06)
    plan.rule("journal.append", mode="error", probability=0.04)
    plan.rule("journal.fsync", times=1)
    store = Store()
    journal = attach(store, path, compact_after=60, faults=plan)
    store.create_namespace(Namespace("default"))
    store.create_throttle(_throttle("t1", {"grp": "a"}, pod=100))
    rng = random.Random(seed)
    alive = []
    for i in range(ops):
        roll = rng.random()
        if roll < 0.5 or not alive:
            name = f"p-{i:03d}"
            store.create_pod(
                _bound(make_pod(name, labels={"grp": "a"},
                                requests={"cpu": f"{rng.choice([50, 100])}m"}))
            )
            alive.append(name)
        elif roll < 0.8:
            name = rng.choice(alive)
            store.update_pod(
                _bound(make_pod(name, labels={"grp": "a"},
                                requests={"cpu": f"{rng.choice([60, 120])}m"}))
            )
        else:
            store.delete_pod("default", alive.pop(rng.randrange(len(alive))))
    assert journal.torn_writes > 0, "torn faults never fired"
    assert journal.write_errors > 0, "write-error faults never fired"
    assert journal.compact_failures >= 1, "the fsync fault never hit a compaction"

    # heal the log (operational compact), then CRASH (no close())
    journal.compact()
    live = _dump(store)

    recovered = Store()
    j2 = attach(recovered, path)
    replayed = _dump(recovered)
    j2.close()
    assert j2.replay_skipped == 0, "post-compact replay must be clean"
    return plan.snapshot(), live, replayed


def test_chaos_smoke_journal_replay_converges(tmp_path):
    history, live, replayed = _journal_chaos_round(SMOKE_SEED, tmp_path)
    assert replayed == live, "journal replay diverged from the pre-crash store"


def test_chaos_journal_run_is_bit_for_bit_reproducible(tmp_path):
    """Acceptance: same seed → same injected fault sequence AND same final
    state, across two fully independent runs."""
    for sub in ("a", "b", "c"):
        (tmp_path / sub).mkdir()
    h1, live1, rep1 = _journal_chaos_round(SMOKE_SEED, tmp_path / "a")
    h2, live2, rep2 = _journal_chaos_round(SMOKE_SEED, tmp_path / "b")
    assert h1 == h2, "fault sequences diverged for the same seed"
    assert live1 == live2 and rep1 == rep2
    # and a different seed produces a different fault sequence
    h3, _, _ = _journal_chaos_round(SMOKE_SEED + 1, tmp_path / "c")
    assert h3 != h1


# --------------------------------------------------------------------------
# the long randomized soak (behind -m slow)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [3, 7, 11, 19, 31])
def test_chaos_soak_randomized(seed, tmp_path):
    """Multi-seed soak of all three chaos surfaces (tier-2; tier-1 runs the
    single-seed smoke variants above)."""
    server_plan, client_plan = _remote_chaos_round(seed, pods=60, settle_timeout=60)
    assert server_plan.fired() + client_plan.fired() > 0
    admitted, _, _ = _admission_chaos_round(seed)
    assert admitted == 20
    _, live, replayed = _journal_chaos_round(seed, tmp_path, ops=400)
    assert replayed == live
