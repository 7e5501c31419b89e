#!/usr/bin/env python
"""Kill-the-leader chaos harness for the active/standby HA subsystem
(engine/replication.py), over the PyTorch port
(``kube_throttler_tpu_torch``, device data plane on the CPU). A copy of
``tools/hatest.py`` with the port's imports.

Topology per cycle: a LEADER child (store + journal + snapshots + fencing
epoch + a replication HTTP endpoint) drives a crashtest-style workload
while a warm STANDBY child bootstraps from its newest snapshot and streams
the journal tail into its own data directory. A seeded fault plan SIGKILLs
the leader at an ``ha.*`` site (faults/plan.py) — mid-journal-batch,
mid-status-commit, mid-snapshot, mid-replication-send. The OS drops the
leader's flock lease on death; the standby's blocked ``acquire`` returns,
it fast-forwards the remaining tail, bumps the fencing epoch, re-publishes
every throttle status from replicated truth (the flip re-publication
step), answers a full admission sweep, and writes a report.

The parent then asserts the **failover oracle**:

1. *bounded window* — the standby serves (admission verdicts answered)
   within ``--window`` seconds of the leader's death;
2. *replay equivalence* — the standby's post-failover store is identical,
   object for object, to a pure from-genesis replay of the standby's own
   journal (the crashtest oracle, applied to the replicated log);
3. *zero lost flips* — every throttle's post-failover ``throttled`` flags
   equal a deterministic recompute from the replicated pods/specs: a flip
   the dead leader computed but never durably published is re-derived,
   never lost, and nothing phantom appears;
4. *admission equivalence* — ``pre_filter`` verdicts for every pod match
   between the promoted standby and a plugin built over the pure replay;
5. *epoch monotonicity* — the standby's term is strictly greater than the
   dead leader's, and its journal records it (a restart re-learns it);
6. *clean stream* — zero replication lines skipped (nothing torn leaked
   past the chunk protocol).

A separate **split-brain scenario** (in-process, per seed) proves the
fencing half: a paused-then-resumed old leader's status/lease writes are
rejected by the mockserver's epoch gate (reason ``FencedEpoch``), counted,
and leave state untouched, while the async committer demotes itself on the
first rejection.

Usage:
    python tools/hatest_torch.py matrix [--seeds 0,1,2] [--events 120]
    python tools/hatest_torch.py one --site ha.status.commit --seed 0
    python tools/hatest_torch.py splitbrain [--seed 0]
    python tools/hatest_torch.py leader|standby ...   (internal: the children)

``make ha-test`` runs the JAX package's matrix; tests/test_torch_ha.py runs one smoke
cycle in tier-1 and the matrix behind ``-m slow``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import sys
import tempfile
import time
from dataclasses import replace

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from tools import harness_torch as harness  # noqa: E402 — the shared child-process toolkit

HA_SITES = (
    "ha.journal.batch",
    "ha.status.commit",
    "ha.snapshot.write",
    "ha.replication.send",
)

DEFAULT_EVENTS = 120
DEFAULT_WINDOW_S = 10.0  # 2 x the pair's nominal 5s lease duration
SNAPSHOT_EVERY = 25
COMPACT_AFTER = 10**9  # never compact under the stream in the harness
LEASE_RETRY = 0.05
EVENT_PACE_S = 0.002  # keep the stream flowing while the workload runs


def default_hit(site: str, seed: int) -> int:
    """1-based hit of ``site`` to die at, spread so each seed kills a
    different occurrence (site hit frequencies differ wildly)."""
    if site == "ha.status.commit":
        return 4 + 7 * seed  # ~30% of events are status writes
    if site == "ha.journal.batch":
        return 2 + 2 * seed  # one hit per micro-batch
    if site == "ha.replication.send":
        return 3 + 2 * seed  # one hit per standby poll with data
    # ha.snapshot.write: hit 1 is the pre-replication bootstrap snapshot —
    # die at a later cut, while the standby is streaming
    return 2 + seed


# --------------------------------------------------------------------------
# leader child
# --------------------------------------------------------------------------


def run_leader(args) -> int:
    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
    from kube_throttler_tpu_torch.engine.replication import (
        FencingEpoch,
        HaCoordinator,
        ReplicationServer,
        ReplicationSource,
    )
    from kube_throttler_tpu_torch.engine.snapshot import SnapshotManager
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.faults.plan import FaultPlan
    from kube_throttler_tpu_torch.utils.leaderelect import FileLeaseElector

    plan = None
    if args.site:
        plan = FaultPlan(seed=args.seed).rule(
            args.site, mode="kill", schedule=[args.hit]
        )

    elector = FileLeaseElector(args.lock, retry_period=LEASE_RETRY)
    assert elector.try_acquire(), "leader child must win the fresh lease"

    store = Store()
    recovery = RecoveryManager(args.dir, faults=plan, compact_after=COMPACT_AFTER)
    journal = recovery.recover_store(store)
    epoch = FencingEpoch(args.dir)
    epoch.observe(recovery.report.epoch)
    journal.fencing = epoch
    snapshotter = SnapshotManager(args.dir, store, keep=2, faults=plan)
    snapshotter.fencing = epoch
    ha = HaCoordinator(epoch, role="leader", journal=journal, snapshotter=snapshotter)
    ha.become_leader()
    snapshotter.bind_journal(journal, every_lines=args.snapshot_every)

    rng = random.Random(args.seed)
    if store.get_namespace("default") is None:
        store.create_namespace(Namespace("default"))
    throttles = []
    for i in range(harness.N_THROTTLES):
        try:
            store.create_throttle(harness.make_throttle(i))
        except ValueError:
            pass
        throttles.append(f"t{i}")
    # one snapshot up front so the standby bootstraps from a snapshot, not
    # from a genesis stream — the "warm standby from newest snapshot" path
    snapshotter.write(reason="bootstrap")

    source = ReplicationSource(args.dir, journal, epoch, faults=plan)
    server = ReplicationServer(source)
    server.start()
    print(f"HATEST leader port={server.port} epoch={epoch.current()}", flush=True)

    # let the standby attach before churning, so the kill interrupts a LIVE
    # replication stream (deterministic coverage of the streaming path)
    deadline = time.time() + 30
    while source.chunks_served == 0 and time.time() < deadline:
        time.sleep(0.01)

    def _mk_pod():
        i = rng.randrange(harness.N_THROTTLES)
        pod = make_pod(
            f"p{rng.randrange(10**9)}",
            labels={"grp": f"g{i}"},
            requests={"cpu": f"{rng.randrange(100, 900)}m"},
        )
        if rng.random() < 0.5:
            pod = replace(pod, spec=replace(pod.spec, node_name="node-1"))
            pod.status.phase = "Running"
        return pod

    for _step in range(args.events):
        op = rng.random()
        if op < 0.35:  # create pod(s); some arrive as one micro-batch
            if rng.random() < 0.35:
                store.apply_events(
                    [("upsert", "Pod", _mk_pod()) for _ in range(rng.randrange(2, 6))]
                )
            else:
                try:
                    store.create_pod(_mk_pod())
                except ValueError:
                    pass
        elif op < 0.5:  # bind a pending pod
            pods = [
                p for p in store.list_pods("default") if p.status.phase == "Pending"
            ]
            if pods:
                p = rng.choice(pods)
                bound = replace(p, spec=replace(p.spec, node_name="node-1"))
                bound = replace(bound, status=replace(bound.status, phase="Running"))
                store.update_pod(bound)
        elif op < 0.6:  # delete a pod
            pods = store.list_pods("default")
            if pods:
                p = rng.choice(pods)
                store.delete_pod(p.namespace, p.name)
        elif op < 0.7:  # spec churn: bump a threshold
            from kube_throttler_tpu_torch.api.types import ResourceAmount

            name = rng.choice(throttles)
            thr = store.get_throttle("default", name)
            store.update_throttle_spec(
                replace(
                    thr,
                    spec=replace(
                        thr.spec,
                        threshold=ResourceAmount.of(
                            pod=rng.randrange(2, 9),
                            requests={"cpu": str(rng.randrange(1, 6))},
                        ),
                    ),
                )
            )
        else:  # reconcile stand-in: status write (possibly a FLIP)
            name = rng.choice(throttles)
            thr = store.get_throttle("default", name)
            store.update_throttle_status(harness.recompute_status(store, thr))
        time.sleep(EVENT_PACE_S)

    # the seeded site never fired: report and idle — the parent SIGKILLs
    # us so a failover still happens at a known instant
    print("HATEST leader done", flush=True)
    while True:
        time.sleep(0.5)


# --------------------------------------------------------------------------
# standby child
# --------------------------------------------------------------------------


def run_standby(args) -> int:
    import torch  # warm the import BEFORE promotion: the window measures HA,

    torch.zeros(1)  # not torch's cold start

    from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
    from kube_throttler_tpu_torch.engine.replication import (
        FencingEpoch,
        HaCoordinator,
        StandbyReplicator,
    )
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.utils.leaderelect import FileLeaseElector

    store = Store()
    recovery = RecoveryManager(args.dir, compact_after=COMPACT_AFTER)
    journal = recovery.recover_store(store)
    epoch = FencingEpoch(args.dir)
    epoch.observe(recovery.report.epoch)
    journal.fencing = epoch
    replicator = StandbyReplicator(
        store, journal, args.leader_url, epoch=epoch, poll_interval=0.02
    )
    ha = HaCoordinator(epoch, role="standby", replicator=replicator, journal=journal)
    if not replicator.bootstrap(deadline_s=30.0):
        print("HATEST standby bootstrap FAILED", flush=True)
        return 1
    replicator.start()
    print(f"HATEST standby synced offset={replicator.consumed_offset()}", flush=True)

    elector = FileLeaseElector(args.lock, retry_period=LEASE_RETRY)
    elector.acquire()  # blocks until the leader dies (flock freed by the OS)
    t_acquired = time.time()
    new_epoch = ha.promote()

    # flip re-publication: recompute EVERY throttle status from replicated
    # truth — anything the dead leader flipped but never journaled is
    # re-derived here (the daemon path drives the same sweep through the
    # controllers' two-lane pipeline via HaCoordinator.promote_reconcile)
    for thr in store.list_throttles():
        store.update_throttle_status(harness.recompute_status(store, thr))

    plugin = harness.build_plugin(store)
    try:
        verdicts = harness.verdicts(plugin, store)
    finally:
        plugin.stop()
    t_serving = time.time()

    report = {
        "t_acquired": t_acquired,
        "t_serving": t_serving,
        "epoch": new_epoch,
        "failover_s": ha.failover_duration_s,
        "dump": harness.dump_store(store),
        "verdicts": verdicts,
        "replication": {
            "events_applied": replicator.events_applied,
            "bytes_applied": replicator.bytes_applied,
            "lines_skipped": replicator.lines_skipped,
            "apply_errors": replicator.apply_errors,
            "polls": replicator.polls,
            "diverged": replicator.diverged,
        },
    }
    journal.close()
    path = os.path.join(args.dir, "hatest-report.json")
    with open(path, "w") as f:
        json.dump(report, f)
    elector.release()
    print(f"HATEST standby report={path}", flush=True)
    return 0


# --------------------------------------------------------------------------
# parent: one failover cycle + the oracle
# --------------------------------------------------------------------------


def _spawn(role: str, extra):
    return harness.spawn_child(__file__, [role] + extra)


# the shared line-waiter (tools/harness.py) under its historical name
_wait_line = harness.wait_line


def run_ha_cycle(
    site: str,
    seed: int,
    workdir: str,
    events: int = DEFAULT_EVENTS,
    hit: int = None,
    window_s: float = DEFAULT_WINDOW_S,
) -> dict:
    """One leader-kill/standby-promote/verify cycle; raises AssertionError
    with a diagnosis on any oracle violation, else returns a report."""
    from kube_throttler_tpu_torch.engine.journal import attach
    from kube_throttler_tpu_torch.engine.store import Store

    hit = default_hit(site, seed) if hit is None else hit
    lock = os.path.join(workdir, "lease.lock")
    leader_dir = os.path.join(workdir, "leader")
    standby_dir = os.path.join(workdir, "standby")
    os.makedirs(leader_dir, exist_ok=True)
    os.makedirs(standby_dir, exist_ok=True)

    leader = standby = None
    try:
        leader = _spawn(
            "leader",
            [
                "--dir", leader_dir, "--lock", lock,
                "--seed", str(seed), "--events", str(events),
                "--snapshot-every", str(SNAPSHOT_EVERY),
            ]
            + (["--site", site, "--hit", str(hit)] if site else []),
        )
        line = _wait_line(leader, "HATEST leader port=", 60)
        port = int(line.split("port=")[1].split()[0])

        standby = _spawn(
            "standby",
            [
                "--dir", standby_dir, "--lock", lock,
                "--leader-url", f"http://127.0.0.1:{port}",
            ],
        )
        _wait_line(standby, "HATEST standby synced", 120)

        # wait for the seeded SIGKILL (or the workload's end, then kill)
        killed_by_site = True
        deadline = time.time() + 120
        while leader.poll() is None and time.time() < deadline:
            try:
                if _wait_line(leader, "HATEST leader done", 0.2):
                    killed_by_site = False
                    break
            except AssertionError:
                continue
        if leader.poll() is None:
            leader.kill()
        leader.wait(timeout=30)
        t_kill = time.time()
        killed = killed_by_site and leader.returncode == -signal.SIGKILL

        # the standby must promote and report within the window
        line = _wait_line(standby, "HATEST standby report=", window_s + 60)
        report_path = line.split("report=")[1].strip()
        assert standby.wait(timeout=30) == 0, "standby child failed"
        with open(report_path) as f:
            report = json.load(f)
    finally:
        harness.kill_children((leader, standby))

    # oracle 1: bounded failover window (kill → admission answered). The
    # parent's death-detection can lag the actual SIGKILL by a poll tick;
    # the standby's lease acquisition is never earlier than the death
    # (flock is held until the process dies), so anchor on whichever of
    # the two timestamps is earlier — both are same-host wall clock.
    window = report["t_serving"] - min(t_kill, report["t_acquired"])
    assert window <= window_s, (
        f"{site} seed={seed}: standby served {window:.2f}s after the kill "
        f"(bound {window_s:.1f}s)"
    )

    # oracle 2: standby state ≡ pure from-genesis replay of ITS journal
    pure_dir = os.path.join(workdir, "pure")
    if os.path.exists(pure_dir):
        shutil.rmtree(pure_dir)
    shutil.copytree(standby_dir, pure_dir)
    pure = Store()
    pure_journal = attach(
        pure, os.path.join(pure_dir, "store.journal"), compact_after=10**9
    )
    pure_journal.close()
    dump_pure = json.loads(json.dumps(harness.dump_store(pure)))
    assert dump_pure == report["dump"], (
        f"{site} seed={seed} hit={hit}: promoted standby state diverges "
        "from a pure from-genesis replay of its own journal"
    )

    # oracle 3: zero lost flips — post-failover throttled flags equal a
    # deterministic recompute from the replicated pods/specs
    from kube_throttler_tpu_torch.api.serialization import object_to_dict

    for thr in pure.list_throttles():
        expected = harness.recompute_status(pure, thr)
        got = report["dump"]["Throttle"][thr.key]["status"]["throttled"]
        want = json.loads(
            json.dumps(object_to_dict(expected)["status"]["throttled"])
        )
        assert got == want, (
            f"{site} seed={seed} hit={hit}: flip lost on {thr.key}: "
            f"published {got} != recomputed {want}"
        )

    # oracle 4: admission equivalence against the pure replay
    plugin_pure = harness.build_plugin(pure)
    try:
        v_pure = json.loads(json.dumps(harness.verdicts(plugin_pure, pure)))
    finally:
        plugin_pure.stop()
    v_standby = json.loads(json.dumps(report["verdicts"]))
    assert v_pure == v_standby, (
        f"{site} seed={seed} hit={hit}: admission verdicts diverge: "
        f"{ {k: (v_standby.get(k), v_pure.get(k)) for k in set(v_standby) | set(v_pure) if v_standby.get(k) != v_pure.get(k)} }"
    )

    # oracle 5: epoch monotonicity, recorded in the standby's journal
    assert report["epoch"] >= 2, "promotion must bump past the leader's term"
    assert pure_journal.last_epoch == report["epoch"], (
        f"{site} seed={seed}: standby journal records epoch "
        f"{pure_journal.last_epoch}, report says {report['epoch']}"
    )

    # oracle 6: the stream never leaked torn bytes
    rep = report["replication"]
    assert rep["lines_skipped"] == 0, (
        f"{site} seed={seed}: {rep['lines_skipped']} replication line(s) "
        "skipped — the chunk protocol leaked a torn artifact"
    )
    assert not rep["diverged"], f"{site} seed={seed}: replication diverged"

    return {
        "site": site,
        "seed": seed,
        "hit": hit,
        "killed": killed,
        "window_s": round(window, 3),
        "failover_s": round(report["failover_s"], 4),
        "epoch": report["epoch"],
        "events_replicated": rep["events_applied"],
        "pods": len(pure.list_pods()),
    }


# --------------------------------------------------------------------------
# split-brain fencing scenario (in-process)
# --------------------------------------------------------------------------


def run_splitbrain(seed: int = 0) -> dict:
    """A paused-then-resumed old leader keeps writing with its stale
    epoch: every status/lease write must bounce off the mockserver's
    fencing gate, the async committer must demote itself on the first
    rejection, and the state the new leader wrote must stay untouched."""
    import threading

    from kube_throttler_tpu_torch.api.pod import Namespace
    from kube_throttler_tpu_torch.api.serialization import object_to_dict
    from kube_throttler_tpu_torch.client.mockserver import MockApiServer
    from kube_throttler_tpu_torch.client.transport import (
        ApiClient,
        AsyncStatusCommitter,
        FencedError,
        RemoteStatusWriter,
        RemoteVersions,
        RestConfig,
    )
    from kube_throttler_tpu_torch.engine.replication import FencingEpoch

    server = MockApiServer()
    server.store.create_namespace(Namespace("default"))
    thr = harness.make_throttle(seed % harness.N_THROTTLES)
    server.store.create_throttle(thr)
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        epoch_a, epoch_b = FencingEpoch(), FencingEpoch()
        epoch_a.bump()  # term 1: the original leader
        client_a = ApiClient(
            RestConfig(server=url), qps=None, epoch_provider=epoch_a.current
        )

        def status_put(client, obj):
            key = f"{obj.namespace}/{obj.name}"
            rv = server.store.resource_version("Throttle", key)
            body = object_to_dict(obj)
            body.setdefault("metadata", {})["resourceVersion"] = str(rv)
            return client.put(
                f"/apis/schedule.k8s.everpeace.github.com/v1alpha1/"
                f"namespaces/{obj.namespace}/throttles/{obj.name}/status",
                body,
            )

        status_put(client_a, harness.recompute_status(server.store, thr))
        assert server.fencing_epoch == 1 and server.stale_rejections() == 0

        # failover: the standby bumps past term 1 and writes
        epoch_b.observe(1)
        epoch_b.bump()  # term 2
        client_b = ApiClient(
            RestConfig(server=url), qps=None, epoch_provider=epoch_b.current
        )
        thr_live = server.store.get_throttle("default", thr.name)
        status_put(client_b, harness.recompute_status(server.store, thr_live))
        assert server.fencing_epoch == 2

        # the zombie resumes: direct PUT bounces with FencedError...
        state_before = object_to_dict(server.store.get_throttle("default", thr.name))
        rejected = False
        try:
            status_put(client_a, harness.recompute_status(server.store, thr_live))
        except FencedError:
            rejected = True
        assert rejected, "stale-epoch status PUT was accepted (split brain!)"
        assert server.stale_rejections() == 1
        assert (
            object_to_dict(server.store.get_throttle("default", thr.name))
            == state_before
        ), "a rejected write still mutated state"

        # ...its lease renewal bounces the same way...
        lease_rejected = False
        try:
            client_a.put(
                "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases/kt",
                {"metadata": {"name": "kt"}, "spec": {"holderIdentity": "zombie"}},
            )
        except FencedError:
            lease_rejected = True
        except Exception:
            pass
        assert lease_rejected, "stale-epoch lease write was accepted"

        # ...and the async committer demotes itself on the first rejection
        fenced = threading.Event()
        versions = RemoteVersions()
        key = f"{thr.namespace}/{thr.name}"
        versions.set(
            "Throttle", key, str(server.store.resource_version("Throttle", key))
        )
        committer = AsyncStatusCommitter(
            RemoteStatusWriter(client_a, versions),
            workers=1,
            on_fenced=fenced.set,
        )
        committer.start()
        committer.update_throttle_status(
            harness.recompute_status(server.store, thr_live)
        )
        assert fenced.wait(5.0), "committer never fired on_fenced"
        committer.stop()
        total_rejected = server.stale_rejections()
        assert total_rejected >= 2
        return {
            "seed": seed,
            "stale_rejected": total_rejected,
            "fencing_epoch": server.fencing_epoch,
        }
    finally:
        server.stop()


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="hatest")
    sub = parser.add_subparsers(dest="command", required=True)

    leader = sub.add_parser("leader", help="internal: the leader child")
    leader.add_argument("--dir", required=True)
    leader.add_argument("--lock", required=True)
    leader.add_argument("--seed", type=int, default=0)
    leader.add_argument("--site", default="")
    leader.add_argument("--hit", type=int, default=1)
    leader.add_argument("--events", type=int, default=DEFAULT_EVENTS)
    leader.add_argument("--snapshot-every", type=int, default=SNAPSHOT_EVERY)

    standby = sub.add_parser("standby", help="internal: the standby child")
    standby.add_argument("--dir", required=True)
    standby.add_argument("--lock", required=True)
    standby.add_argument("--leader-url", required=True)

    one = sub.add_parser("one", help="one failover cycle")
    one.add_argument("--site", required=True, choices=HA_SITES)
    one.add_argument("--seed", type=int, default=0)
    one.add_argument("--events", type=int, default=DEFAULT_EVENTS)
    one.add_argument("--hit", type=int, default=None)
    one.add_argument("--window", type=float, default=DEFAULT_WINDOW_S)

    split = sub.add_parser("splitbrain", help="stale-epoch fencing scenario")
    split.add_argument("--seed", type=int, default=0)

    matrix = sub.add_parser("matrix", help="full ha.* site × seed matrix")
    matrix.add_argument("--seeds", default="0,1,2")
    matrix.add_argument("--events", type=int, default=DEFAULT_EVENTS)
    matrix.add_argument("--window", type=float, default=DEFAULT_WINDOW_S)

    args = parser.parse_args(argv)

    if args.command == "leader":
        return run_leader(args)
    if args.command == "standby":
        return run_standby(args)

    if args.command == "one":
        with tempfile.TemporaryDirectory(prefix="hatest-") as tmp:
            report = run_ha_cycle(
                args.site, args.seed, tmp,
                events=args.events, hit=args.hit, window_s=args.window,
            )
        print(json.dumps(report, indent=2))
        return 0

    if args.command == "splitbrain":
        print(json.dumps(run_splitbrain(args.seed), indent=2))
        return 0

    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    failures = 0
    for site in HA_SITES:
        for seed in seeds:
            with tempfile.TemporaryDirectory(prefix="hatest-") as tmp:
                try:
                    report = run_ha_cycle(
                        site, seed, tmp, events=args.events, window_s=args.window
                    )
                except AssertionError as e:
                    failures += 1
                    print(f"FAIL {site} seed={seed}: {e}")
                    continue
            print(
                f"PASS {site:<22} seed={seed} hit={report['hit']:<4} "
                f"killed={str(report['killed']):<5} "
                f"window={report['window_s']:<6} epoch={report['epoch']} "
                f"replicated={report['events_replicated']:<4} pods={report['pods']}"
            )
    for seed in seeds:
        try:
            report = run_splitbrain(seed)
        except AssertionError as e:
            failures += 1
            print(f"FAIL splitbrain seed={seed}: {e}")
            continue
        print(
            f"PASS {'splitbrain':<22} seed={seed} "
            f"stale_rejected={report['stale_rejected']} "
            f"epoch={report['fencing_epoch']}"
        )
    total = len(HA_SITES) * len(seeds) + len(seeds)
    print(f"\n{total - failures}/{total} HA scenarios green")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
