#!/usr/bin/env python
"""SIGKILL crash-point harness for the snapshot/recovery subsystem, over
the PyTorch port (``kube_throttler_tpu_torch``, device data plane on the
CPU). A copy of ``tools/crashtest.py`` with the port's imports.

Drives the standalone ingest stack (store + journal + snapshots +
TTL'd reservations) in a CHILD process whose fault plan SIGKILLs it at a
seeded ``crash.*`` site (faults/plan.py) — the worst possible instants:
between a store mutation and its journal line, mid-snapshot-tmp-write,
between the snapshot rename and the prune, right after a compaction
rotates the log. The parent then restarts over the same data directory
and asserts the **invariant oracle**:

1. *replay equivalence* — the recovered store (newest valid snapshot +
   journal tail, engine/recovery.py) is byte-identical, object for
   object, to a pure from-genesis replay of the same journal;
2. *admission equivalence* — ``pre_filter`` verdicts (status code +
   reason strings) for every stored pod match between the two;
3. *plane integrity* — the recovery reconcile finds ZERO divergences
   between the rebuilt published ``st_*`` planes and the restored
   statuses (throttled flags included);
4. *reservation safety* — every restored reservation existed unexpired in
   the snapshot, nothing expired is resurrected, and non-TTL entries all
   survive.

Usage:
    python tools/crashtest_torch.py matrix [--seeds 0,1,2] [--events 150]
    python tools/crashtest_torch.py one --site crash.snapshot.pre_rename --seed 0
    python tools/crashtest_torch.py child ...   (internal: the workload driver)

``make crash-test`` runs the JAX package's matrix; tests/test_torch_crash_recovery.py
runs one fast smoke cycle in tier-1 and the matrix behind ``-m slow``.
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
from dataclasses import replace
from datetime import timedelta

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from tools import harness_torch as harness  # noqa: E402 — the shared child-process toolkit

# shared fixtures/oracles (tools/harness.py) under their historical names —
# hatest and the scenario engine import them from harness directly
N_THROTTLES = harness.N_THROTTLES
_throttle = harness.make_throttle
_recompute_status = harness.recompute_status
_dump_store = harness.dump_store
_normalized_reasons = harness.normalized_reasons
_verdicts = harness.verdicts
_build_plugin = harness.build_plugin

# every registered crash.* site (faults/plan.py KNOWN_SITES)
CRASH_SITES = (
    "crash.journal.append",
    "crash.journal.torn",
    "crash.journal.compact",
    "crash.journal.group_commit",
    "crash.gang.partial_reserve",
    "crash.preempt.partial_evict",
    "crash.snapshot.begin",
    "crash.snapshot.tmp_partial",
    "crash.snapshot.pre_rename",
    "crash.snapshot.post_rename",
    "crash.snapshot.prune",
)

# workload knobs the child and the oracle agree on
DEFAULT_EVENTS = 150
SNAPSHOT_EVERY = 25
COMPACT_AFTER = 70
SNAPSHOT_KEEP = 2


def default_hit(site: str, seed: int) -> int:
    """Which 1-based hit of ``site`` to die at: spread kills across the run
    for per-append sites; low-frequency sites (per-snapshot, per-compact)
    use small indices so each seed crashes a different occurrence."""
    if site in ("crash.journal.append", "crash.journal.torn"):
        return 10 + 37 * seed
    if site == "crash.journal.group_commit":
        # hit once per micro-batch group commit (~a third of events flow
        # through batches): die at different batches per seed
        return 2 + 3 * seed
    if site == "crash.gang.partial_reserve":
        # hit once per gang MEMBER-key add (~2-4 per gang reserve): odd
        # indices land mid-group — the exact partial-reserve instant
        return 3 + 8 * seed
    if site == "crash.preempt.partial_evict":
        # hit once per victim delete (~2-4 per preempt cycle): spread so
        # each seed dies mid-eviction of a different cycle — some victims
        # deleted, the commit line never lands
        return 2 + 7 * seed
    return 1 + seed


# --------------------------------------------------------------------------
# child: the workload driver (dies by SIGKILL mid-flight)
# --------------------------------------------------------------------------


def run_child(args) -> int:
    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.engine.gang import GangLedger
    from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
    from kube_throttler_tpu_torch.engine.reservations import ReservedResourceAmounts
    from kube_throttler_tpu_torch.engine.snapshot import SnapshotManager
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.faults.plan import FaultPlan

    plan = None
    if args.site:
        plan = FaultPlan(seed=args.seed).rule(
            args.site, mode="kill", schedule=[args.hit]
        )
    store = Store()
    recovery = RecoveryManager(
        args.dir, faults=plan, compact_after=args.compact_after
    )
    journal = recovery.recover_store(store)
    reservations = {
        "throttle": ReservedResourceAmounts(8),
        "clusterthrottle": ReservedResourceAmounts(8),
    }
    recovery.restore_reservations(reservations)
    gangs = GangLedger(caches=reservations, journal=journal, faults=plan)
    recovery.restore_gangs(gangs, journal)
    snapshotter = SnapshotManager(
        args.dir,
        store,
        reservations=reservations,
        keep=args.keep,
        faults=plan,
        gang_ledger=gangs,
    )
    snapshotter.bind_journal(journal, every_lines=args.snapshot_every)
    from kube_throttler_tpu_torch.policy.preempt import PreemptionCoordinator
    from kube_throttler_tpu_torch.policy.spec import PolicyEngine

    # journaled eviction driver (no controllers: the child exercises the
    # PREEMPT begin → deletes → commit bracket and its crash artifacts,
    # not victim selection — that has its own seeded equivalence tier)
    preempt = PreemptionCoordinator(
        PolicyEngine(), kind_controllers=(), store=store,
        gang_ledger=gangs, journal=journal, faults=plan,
    )

    rng = random.Random(args.seed)
    if store.get_namespace("default") is None:
        store.create_namespace(Namespace("default"))
    throttles = []
    for i in range(N_THROTTLES):
        try:
            store.create_throttle(_throttle(i))
        except ValueError:
            pass  # recovered from a previous run
        throttles.append(f"t{i}")

    def _mk_pod():
        i = rng.randrange(N_THROTTLES)
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
        if op < 0.35:  # create pod(s) — a third arrive as one MICRO-BATCH
            if rng.random() < 0.35:
                # the batched ingest path: one store.apply_events per burst
                # → the journal GROUP COMMITS it (one buffered write), and
                # site crash.journal.group_commit can die mid-commit
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
        elif op < 0.6:  # delete a pod (never a "pv" preempt victim: their
            # presence/absence is the preempt oracle's witness — a random
            # delete of a rolled-back victim would fake a violation)
            pods = [
                p for p in store.list_pods("default") if not p.name.startswith("pv")
            ]
            if pods:
                p = rng.choice(pods)
                store.delete_pod(p.namespace, p.name)
        elif op < 0.7:  # spec churn: bump a threshold
            name = rng.choice(throttles)
            thr = store.get_throttle("default", name)
            spec = thr.spec
            from kube_throttler_tpu_torch.api.types import ResourceAmount

            new_spec = replace(
                spec,
                threshold=ResourceAmount.of(
                    pod=rng.randrange(2, 9),
                    requests={"cpu": str(rng.randrange(1, 6))},
                ),
            )
            store.update_throttle_spec(replace(thr, spec=new_spec))
        elif op < 0.88:  # reconcile stand-in: status write (journaled)
            name = rng.choice(throttles)
            thr = store.get_throttle("default", name)
            store.update_throttle_status(_recompute_status(store, thr))
        elif op < 0.93:  # gang churn: all-or-nothing group reserve/rollback
            if rng.random() < 0.75 or not gangs.pending_groups():
                name = rng.choice(throttles)
                gid = rng.randrange(10**6)
                members = [
                    make_pod(
                        f"gang{gid}-r{i}",
                        labels={"grp": name},
                        requests={"cpu": "250m"},
                        group=f"g{gid}",
                        group_size=rng.randrange(2, 5),
                    )
                    for i in range(rng.randrange(2, 5))
                ]
                member_keys = {
                    p.key: {"throttle": [f"default/{name}"]} for p in members
                }
                ttl = rng.choice([None, 10.0, 60.0])
                # crash.gang.partial_reserve fires INSIDE this loop — the
                # oracle must then find either every member reserved in
                # the recovered state or none of them
                gangs.reserve_group(f"default/g{gid}", members, member_keys, ttl=ttl)
            else:
                # roll an existing group back through the journaled path
                rec = next(iter(gangs._groups.values()), None)  # noqa: SLF001
                if rec is not None:
                    gangs.rollback_group(rec.group_key, "workload churn")
        elif op < 0.96:  # preemption: journaled gang-atomic victim eviction
            # victims are created RUNNING then evicted through the real
            # PREEMPT begin → delete-per-victim → commit bracket;
            # crash.preempt.partial_evict fires inside the delete loop —
            # the oracle must then find either every victim restored
            # (uncommitted ⇒ zero evictions) or every victim gone
            # (committed), never a half-evicted set
            vid = rng.randrange(10**6)
            victims = []
            if rng.random() < 0.5:  # whole-gang victim unit
                size = rng.randrange(2, 5)
                for i in range(size):
                    victims.append(
                        make_pod(
                            f"pv{vid}-r{i}",
                            labels={"grp": rng.choice(throttles)},
                            requests={"cpu": "150m"},
                            group=f"pg{vid}",
                            group_size=size,
                            node_name="node-1",
                            phase="Running",
                        )
                    )
            else:
                for i in range(rng.randrange(1, 3)):
                    victims.append(
                        make_pod(
                            f"pv{vid}-s{i}",
                            labels={"grp": rng.choice(throttles)},
                            requests={"cpu": "150m"},
                            node_name="node-1",
                            phase="Running",
                        )
                    )
            for p in victims:
                try:
                    store.create_pod(p)
                except ValueError:
                    pass
            preempt.execute_eviction(f"default/pre-{vid}", victims)
        else:  # reservation churn with mixed TTLs
            name = rng.choice(throttles)
            cache = reservations["throttle"]
            pod = make_pod(
                f"r{rng.randrange(10**6)}",
                labels={"grp": name},
                requests={"cpu": "250m"},
            )
            if rng.random() < 0.7:
                ttl = rng.choice([None, 5.0, 30.0, timedelta(minutes=2)])
                cache.add_pod(f"default/{name}", pod, ttl=ttl)
            else:
                keys = list(cache.reserved_pod_keys(f"default/{name}"))
                if keys:
                    cache.remove_pod_key(f"default/{name}", rng.choice(keys))

    # survived every event (the seeded hit was never reached): exit through
    # the graceful path — final snapshot + fsynced journal
    snapshotter.write(reason="shutdown")
    journal.close()
    return 0


# --------------------------------------------------------------------------
# parent: restart + invariant oracle
# --------------------------------------------------------------------------


def spawn_child(
    data_dir: str,
    seed: int,
    site: str,
    hit: int,
    events: int,
    timeout: float = 180.0,
):
    argv = [
        "child",
        "--dir", data_dir,
        "--seed", str(seed),
        "--events", str(events),
        "--snapshot-every", str(SNAPSHOT_EVERY),
        "--compact-after", str(COMPACT_AFTER),
        "--keep", str(SNAPSHOT_KEEP),
    ]
    if site:
        argv += ["--site", site, "--hit", str(hit)]
    return harness.run_child(__file__, argv, timeout=timeout)


def run_crash_cycle(
    site: str,
    seed: int,
    workdir: str,
    events: int = DEFAULT_EVENTS,
    hit: int = None,
) -> dict:
    """One full crash/recover/verify cycle; raises AssertionError with a
    diagnosis on any oracle violation, else returns a report dict."""
    from kube_throttler_tpu_torch.engine.journal import attach
    from kube_throttler_tpu_torch.engine.recovery import RecoveryManager
    from kube_throttler_tpu_torch.engine.reservations import ReservedResourceAmounts
    from kube_throttler_tpu_torch.engine.snapshot import find_snapshots, load_snapshot
    from kube_throttler_tpu_torch.engine.store import Store

    hit = default_hit(site, seed) if hit is None else hit
    data_dir = os.path.join(workdir, "data")
    os.makedirs(data_dir, exist_ok=True)
    proc = spawn_child(data_dir, seed, site, hit, events)
    killed = proc.returncode == -signal.SIGKILL
    if not killed and proc.returncode != 0:
        raise AssertionError(
            f"child failed (rc={proc.returncode}) at {site} seed={seed}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )

    # two pristine copies of the crash artifact: recovery and the pure
    # replay both truncate/compact, so they must not share files
    recovered_dir = os.path.join(workdir, "recovered")
    pure_dir = os.path.join(workdir, "pure")
    for d in (recovered_dir, pure_dir):
        if os.path.exists(d):
            shutil.rmtree(d)
        shutil.copytree(data_dir, d)

    # --- recovered state: snapshot + journal tail ------------------------
    from kube_throttler_tpu_torch.engine.gang import GangLedger

    recovered = Store()
    rec = RecoveryManager(recovered_dir, compact_after=10**9)
    rec_journal = rec.recover_store(recovered)
    caches = {
        "throttle": ReservedResourceAmounts(8),
        "clusterthrottle": ReservedResourceAmounts(8),
    }
    rec.restore_reservations(caches)
    gangs = GangLedger(caches=caches)
    rec.restore_gangs(gangs, rec_journal)
    rec_journal.close()

    # --- pure state: from-genesis journal replay, snapshots ignored ------
    pure = Store()
    attach(pure, os.path.join(pure_dir, "store.journal"), compact_after=10**9).close()

    # oracle 1: replay equivalence (objects, statuses, throttled flags)
    dump_rec, dump_pure = _dump_store(recovered), _dump_store(pure)
    assert dump_rec == dump_pure, (
        f"{site} seed={seed} hit={hit}: recovered state (mode="
        f"{rec.report.journal_mode}) diverges from pure from-genesis replay"
    )

    # oracle 2+3: admission equivalence + zero plane divergence
    plugin_rec = _build_plugin(recovered)
    plugin_pure = _build_plugin(pure)
    try:
        v_rec, v_pure = _verdicts(plugin_rec, recovered), _verdicts(plugin_pure, pure)
        assert v_rec == v_pure, (
            f"{site} seed={seed} hit={hit}: admission verdicts diverge: "
            f"{ {k: (v_rec.get(k), v_pure.get(k)) for k in set(v_rec) | set(v_pure) if v_rec.get(k) != v_pure.get(k)} }"
        )
        divergences = rec.reconcile(
            plugin_rec.informers, device_manager=plugin_rec.device_manager
        )
        assert divergences == 0, (
            f"{site} seed={seed} hit={hit}: {divergences} published-plane "
            f"divergence(s) after recovery: {rec.report.repaired_keys}"
        )
    finally:
        plugin_rec.stop()
        plugin_pure.stop()

    # oracle 4: reservation safety — everything restored was unexpired in
    # the snapshot; nothing with a spent TTL came back; every non-TTL
    # entry survived
    snaps = find_snapshots(recovered_dir)
    if rec.snapshot is not None and snaps:
        snap_res = (rec.snapshot.get("reservations") or {}).get("throttle") or {}
        restored_keys = {
            (tk, pk)
            for tk in caches["throttle"].throttle_keys()
            for pk in caches["throttle"].reserved_pod_keys(tk)
        }
        snap_keys = {
            (tk, pk) for tk, pods in snap_res.items() for pk in pods
        }
        extra = restored_keys - snap_keys
        assert not extra, (
            f"{site} seed={seed}: reservations restored that the snapshot "
            f"never carried: {extra}"
        )
        eternal = {
            (tk, pk)
            for tk, pods in snap_res.items()
            for pk, entry in pods.items()
            if entry.get("ttlRemainingSeconds") is None
        }
        missing = eternal - restored_keys
        assert not missing, (
            f"{site} seed={seed}: non-TTL reservations lost in restore: {missing}"
        )

    # oracle 5: gang all-or-nothing — every restored group is FULLY
    # reserved (each pending member holds a reservation on every recorded
    # throttle key); any group whose journal tail ends in begin (crash
    # mid-reserve) or rollback has NO surviving member reservation; and no
    # gang-member reservation exists outside a restored group record
    reserved_pairs = {
        (tk, pk)
        for cache in caches.values()
        for tk in cache.throttle_keys()
        for pk in cache.reserved_pod_keys(tk)
    }
    with gangs.lock:
        records = {
            gk: (
                {pk: dict(kinds) for pk, kinds in r.members.items()},
                set(r.admitted),
            )
            for gk, r in gangs._groups.items()  # noqa: SLF001 — oracle read
        }
    recorded_members = set()
    for gk, (members, admitted) in records.items():
        for pk, kinds in members.items():
            recorded_members.add(pk)
            if pk in admitted:
                continue
            for _kind, keys in kinds.items():
                for key in keys:
                    assert (key, pk) in reserved_pairs, (
                        f"{site} seed={seed} hit={hit}: gang {gk} member {pk} "
                        f"lost its reservation on {key} — PARTIAL group survived"
                    )
    for gk, entry in rec_journal.gang_ops.items():
        if entry.get("op") == "commit":
            continue
        for pk in entry.get("members") or []:
            holders = {tk for tk, p in reserved_pairs if p == pk}
            assert not holders, (
                f"{site} seed={seed} hit={hit}: gang {gk} ended '{entry['op']}' "
                f"but member {pk} still holds reservations on {holders} — "
                "partial reserve leaked through recovery"
            )
    for tk, pk in reserved_pairs:
        name = pk.partition("/")[2]
        if name.startswith("gang"):
            assert pk in recorded_members, (
                f"{site} seed={seed} hit={hit}: orphan gang-member "
                f"reservation {pk} on {tk} outside any restored group"
            )

    # oracle 6: preemption all-or-nothing — recovery leaves NO open
    # (begin) preemption; a committed one's victims are all gone; an
    # uncommitted (now rollback-stamped) one's victims are ALL present —
    # zero half-evicted victim sets, gang units included (a victim gang's
    # members share one preempt's victim list)
    live_pods = {p.key for p in recovered.list_pods("default")}
    for pid, entry in rec_journal.preempt_ops.items():
        op = entry.get("op")
        assert op != "begin", (
            f"{site} seed={seed} hit={hit}: preemption {pid} still open "
            "(begin without commit) after recovery"
        )
        vkeys = set(entry.get("victims") or [])
        if op == "commit":
            present = vkeys & live_pods
            assert not present, (
                f"{site} seed={seed} hit={hit}: committed preemption {pid} "
                f"left victims alive: {sorted(present)}"
            )
        elif op == "rollback":
            missing = vkeys - live_pods
            assert not missing, (
                f"{site} seed={seed} hit={hit}: rolled-back preemption "
                f"{pid} did not restore victims {sorted(missing)} — "
                "a HALF-EVICTED victim set survived"
            )

    return {
        "site": site,
        "seed": seed,
        "hit": hit,
        "killed": killed,
        "mode": rec.report.journal_mode,
        "snapshot_seq": rec.report.snapshot_seq,
        "snapshots_rejected": rec.report.snapshots_rejected,
        "journal_lines_replayed": rec.report.journal_lines_replayed,
        "torn_tails": rec.report.journal_torn_tails,
        "interior_skipped": rec.report.journal_interior_skipped,
        "reservations_restored": rec.report.reservations_restored,
        "reservations_expired_dropped": rec.report.reservations_expired_dropped,
        "pods": len(pure.list_pods()),
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="crashtest")
    sub = parser.add_subparsers(dest="command", required=True)

    child = sub.add_parser("child", help="internal: the workload driver")
    child.add_argument("--dir", required=True)
    child.add_argument("--seed", type=int, default=0)
    child.add_argument("--site", default="")
    child.add_argument("--hit", type=int, default=1)
    child.add_argument("--events", type=int, default=DEFAULT_EVENTS)
    child.add_argument("--snapshot-every", type=int, default=SNAPSHOT_EVERY)
    child.add_argument("--compact-after", type=int, default=COMPACT_AFTER)
    child.add_argument("--keep", type=int, default=SNAPSHOT_KEEP)

    one = sub.add_parser("one", help="one crash/recover/verify cycle")
    one.add_argument("--site", required=True, choices=CRASH_SITES)
    one.add_argument("--seed", type=int, default=0)
    one.add_argument("--events", type=int, default=DEFAULT_EVENTS)
    one.add_argument("--hit", type=int, default=None)

    matrix = sub.add_parser("matrix", help="full site × seed matrix")
    matrix.add_argument("--seeds", default="0,1,2")
    matrix.add_argument("--events", type=int, default=DEFAULT_EVENTS)

    args = parser.parse_args(argv)

    if args.command == "child":
        return run_child(args)

    if args.command == "one":
        with tempfile.TemporaryDirectory(prefix="crashtest-") as tmp:
            report = run_crash_cycle(
                args.site, args.seed, tmp, events=args.events, hit=args.hit
            )
        print(json.dumps(report, indent=2))
        return 0

    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    failures = 0
    for site in CRASH_SITES:
        for seed in seeds:
            with tempfile.TemporaryDirectory(prefix="crashtest-") as tmp:
                try:
                    report = run_crash_cycle(site, seed, tmp, events=args.events)
                except AssertionError as e:
                    failures += 1
                    print(f"FAIL {site} seed={seed}: {e}")
                    continue
            print(
                f"PASS {site:<28} seed={seed} hit={report['hit']:<4} "
                f"killed={str(report['killed']):<5} mode={report['mode']:<13} "
                f"replayed={report['journal_lines_replayed']:<4} "
                f"torn={report['torn_tails']} pods={report['pods']}"
            )
    total = len(CRASH_SITES) * len(seeds)
    print(f"\n{total - failures}/{total} crash points recovered cleanly")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
