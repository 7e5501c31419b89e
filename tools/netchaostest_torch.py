#!/usr/bin/env python
"""Network-fault chaos matrix for the cross-host TCP shard transport, over
the PyTorch port (``kube_throttler_tpu_torch``; its workers run with
``--no-device``). A copy of ``tools/netchaostest.py`` with the port's
imports.

Every ``net.*`` framing-layer fault site (faults/plan.py), armed
client-side against one shard of a LIVE 2-worker ``transport="tcp"``
fleet (real processes dialed over loopback — the same stack
``--shard-transport tcp`` serves), x 3 seeds:

    net.connect.refused:error   dials refused during reconnect; backoff
                                must retry through to the heal
    net.send.torn_frame:torn    a frame tears mid-write; the worker sees
                                a short read and drops the lane cleanly
    net.recv.stall:delay        the client's reader stalls mid-frame;
                                RPCs ride the per-op deadline, not hang
    net.partition:error         sends blackhole (asymmetric partition);
                                degraded fail-safe verdicts, then heal ⇒
                                epoch-bumped resync + re-push
    net.reconnect.storm:error   every fresh connection dies at birth;
                                jittered backoff must converge anyway

While the fault is live the driver keeps churning pod events across
flip thresholds, scattering ``pre_filter`` RPCs, and running
reserve/unreserve two-phase transactions. After the heal the matrix
asserts the full recovery contract:

- the armed site actually FIRED (an unfired rule is a vacuous pass);
- every shard reconnected and reports ``ok`` (no supervisor restart —
  transient network loss must not look like process death);
- ZERO wrong verdicts vs a single-process oracle rebuilt from the final
  state (code + normalized reasons);
- ZERO lost flips: every published ``status.throttled`` equals the
  oracle's recompute;
- ZERO orphan reservations: every worker's ``reshard_audit`` is clean —
  a reserve whose prepare outran the deadline must have been aborted on
  every target, not stranded.

An **SHM column** (``--only shm``) runs the zero-copy event-plane fault
sites against a LIVE socketpair fleet with the per-shard shared-memory
ring active (the default spawn path), x the same seeds:

    shm.ring.full:delay         a saturated ring: the writer takes a
                                counted backpressure wait — never a
                                silent drop of a non-sheddable op
    shm.slot.torn_commit:torn   a commit word dies mid-write; the reader
                                detects the torn slot, the worker dies
                                as a unit, and the supervisor's restart
                                + resync brings a FRESH segment
    shm.doorbell.lost:error     lost wakeup bytes; the reader's bounded
                                poll slice turns them into latency only
    shm.reader.stall:delay      a slow consumer (worker-side rule); the
                                lane backpressures, nothing is lost
    shm.segment.unlink:error    the restart-path unlink is lost; the
                                supervisor's sweep backstop must leave
                                /dev/shm clean at stop

SHM cases assert the same zero-wrong-verdict / zero-lost-flip / zero-
orphan gates, plus: the event plane is ACTIVE pre-fault (no silent
pickle fallback masking the matrix), restarts happen exactly when the
case expects them (torn commit: yes; everything else: no), and no
``kt_evt_*`` segment survives the final stop.

Run: ``python tools/netchaostest_torch.py matrix``; the tier-1 smoke
(tests/test_torch_net_transport.py) runs one case small.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

SEEDS = (0, 1, 2)

# site → (mode, rule kwargs): windowless rules stay finite so the fleet
# always heals inside the case budget (an unbounded blackhole would gate
# the harness's patience, not the code)
CASES = (
    ("net.connect.refused", "error", {"times": 2}),
    ("net.send.torn_frame", "torn", {"times": 2}),
    ("net.recv.stall", "delay", {"times": 3, "delay": 0.5}),
    ("net.partition", "error", {"times": 6}),
    ("net.reconnect.storm", "error", {"times": 2}),
)

# these sites only fire while (re)connecting — pair them with one torn
# frame so the established lane actually drops and the dial path runs
_NEEDS_SEVER = ("net.connect.refused", "net.reconnect.storm")

# shm column: (site, mode, front-side rule kwargs | None, worker
# --fault-site arg | None, expect_restart). Front-side rules arm the
# plan BEFORE spawn (the ring writer captures it at construction);
# worker-side rules ride the worker CLI. shm.segment.unlink needs a
# writer close to fire, so it's paired with one torn commit (the
# restart path closes the old handle) and the sweep backstop carries
# the cleanup contract.
SHM_CASES = (
    ("shm.ring.full", "delay", {"times": 3, "delay": 0.3}, None, False),
    ("shm.slot.torn_commit", "torn", {"times": 1}, None, True),
    ("shm.doorbell.lost", "error", {"times": 5}, None, False),
    ("shm.reader.stall", "delay", None, "shm.reader.stall:delay:2:0.5", False),
    ("shm.segment.unlink", "error", {"times": 1}, None, True),
)


def build_fleet(n_shards=2, n_throttles=24, n_pods=160, n_reserved=8,
                rpc_deadline=10.0, transport="tcp", faults=None,
                worker_args=None):
    import tools.harness_torch as H
    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.sharding.front import AdmissionFront
    from kube_throttler_tpu_torch.sharding.supervisor import ShardSupervisor

    front = AdmissionFront(n_shards, rpc_deadline=rpc_deadline, faults=faults)
    supervisor = ShardSupervisor(
        front,
        transport=transport,
        use_device=False,
        restart_backoff=0.3,
        env={**os.environ, "KT_SHARD_QUIET": "1", "KT_LOCK_ASSERT": "0"},
        worker_args=list(worker_args or []),
        # the matrix runs the KEYED framing (HMAC per frame) so every
        # fault path is exercised through the cross-host trust boundary,
        # not the loopback-only keyless shortcut
        auth_key=b"netchaos-matrix-psk" if transport == "tcp" else None,
    )
    supervisor.start(ready_timeout=300.0)
    try:
        front.store.create_namespace(Namespace("default"))
        for i in range(n_throttles):
            front.store.create_throttle(H.make_throttle(i))
        pods = []
        for i in range(n_pods):
            pod = make_pod(
                f"p{i}", labels={"grp": f"g{i % n_throttles}"},
                requests={"cpu": "100m"},
            )
            front.store.create_pod(pod)
            pods.append(pod)
        assert front.drain(120.0)
        time.sleep(0.3)
        # live reservations make the orphan audit meaningful: a two-phase
        # txn stranded by a mid-prepare fault would show up against these
        for pod in pods[:n_reserved]:
            status = front.reserve(pod)
            assert status.is_success(), status.reasons
    except BaseException:
        supervisor.stop()
        front.stop()
        raise
    return front, supervisor, pods


def churn(front, pods, rounds=6, per_round=60):
    """Pod-update churn that swings group sums across flip thresholds
    while the fault is live; interleaves scatter RPCs and two-phase
    reserve/unreserve so every transport path sees the fault. Degraded
    verdicts DURING the storm are fine (fail-safe by design) — only the
    post-heal equality gates count."""
    from kube_throttler_tpu_torch.api.pod import make_pod

    for r in range(rounds):
        cpu = "450m" if r % 2 == 0 else "50m"
        for i in range(min(per_round, len(pods))):
            pod = pods[i]
            front.store.update_pod(
                make_pod(pod.name, labels=dict(pod.labels),
                         requests={"cpu": cpu})
            )
        probe = pods[(r * 7) % len(pods)]
        try:
            front.pre_filter(probe)
        except Exception:  # noqa: BLE001 — storm-time refusal is the point
            pass
        victim = pods[-1 - (r % 8)]
        try:
            st = front.reserve(victim)
            if st.is_success():
                front.unreserve(victim)
        except Exception:  # noqa: BLE001 — storm-time refusal is the point
            pass
        time.sleep(0.25)


def final_state(front):
    """Oracle rebuild: (wrong verdicts, lost flips) vs the final state."""
    import tools.harness_torch as H
    from kube_throttler_tpu_torch.api.pod import Namespace
    from kube_throttler_tpu_torch.engine.store import Store

    store = Store()
    store.create_namespace(Namespace("default"))
    for thr in front.store.list_throttles():
        store.create_throttle(thr)
    for pod in front.store.list_pods():
        store.create_pod(pod)
    oracle = H.build_plugin(store)
    oracle.run_pending_once()
    wrong = []
    for pod in store.list_pods():
        got = front.pre_filter(pod)
        want = oracle.pre_filter(pod)
        if got.code != want.code or H.normalized_reasons(
            got.reasons
        ) != H.normalized_reasons(want.reasons):
            wrong.append(pod.key)
    by_key = {t.key: t for t in store.list_throttles()}
    stale = [
        thr.key
        for thr in front.store.list_throttles()
        if (w := by_key.get(thr.key)) is not None
        and thr.status.throttled != w.status.throttled
    ]
    oracle.stop()
    return wrong, stale


def audit_all(front):
    bad = []
    for sid in range(front.n_shards):
        handle = front.shards.get(sid)
        if handle is None or not handle.alive:
            bad.append(f"shard-{sid}: down")
            continue
        a = handle.request("reshard_audit", None, timeout=30.0)
        if a["orphan_reservations"]:
            bad.append(f"shard-{sid}: orphans {a['orphan_reservations']}")
        if a["pending_handoffs"]:
            bad.append(f"shard-{sid}: pending handoffs")
        if a["fenced_handoffs"]:
            bad.append(f"shard-{sid}: fences {a['fenced_handoffs']}")
    return bad


def run_case(site, mode, seed, rule_kwargs=None, n_pods=160, rounds=6,
             recovery_s=30.0):
    from kube_throttler_tpu_torch.faults.plan import FaultPlan

    rule_kwargs = dict(rule_kwargs or {})
    front, supervisor, pods = build_fleet(n_pods=n_pods)
    result = {"case": f"{site}:{mode}", "seed": seed}
    try:
        target_sid = 1
        handle = front.shards[target_sid]
        plan = FaultPlan(seed=seed).rule(site, mode=mode, **rule_kwargs)
        if site in _NEEDS_SEVER:
            plan.rule("net.send.torn_frame", mode="torn", times=1)
        handle.faults = plan

        churn(front, pods, rounds=rounds)

        # heal: the plan runs dry (finite times), the client reconnects,
        # the supervisor resyncs — every shard must come back ok with NO
        # process restart (network loss is not process death)
        restarts_before = dict(supervisor.restart_counts())
        deadline = time.monotonic() + recovery_s
        recovered = False
        while time.monotonic() < deadline:
            state, _ = front._shards_health()
            if state == "ok":
                recovered = True
                break
            time.sleep(0.1)
        assert recovered, f"fleet never recovered: {front._shards_health()}"
        assert supervisor.restart_counts() == restarts_before, (
            "supervisor restarted a worker over a transient network fault"
        )
        assert front.drain(120.0)
        time.sleep(0.5)

        fired = plan.fired(site)
        assert fired >= 1, f"{site} never fired (vacuous pass)"
        result["fired"] = fired
        result["reconnects"] = getattr(handle, "reconnects", 0)
        result["conn_lost"] = supervisor.connection_losses().get(target_sid, 0)
        result["deadline_exceeded"] = getattr(handle, "deadline_exceeded", 0)

        wrong, stale = final_state(front)
        assert not wrong, f"wrong verdicts after heal: {wrong[:3]}"
        assert not stale, f"lost flips after heal: {stale[:3]}"
        bad = audit_all(front)
        assert not bad, f"orphan audit failed: {bad}"
        result["ok"] = True
        return result
    finally:
        supervisor.stop()
        front.stop()


def _shm_leftovers():
    try:
        return [f for f in os.listdir("/dev/shm") if f.startswith("kt_evt_")]
    except OSError:
        return []


def run_shm_case(site, mode, seed, rule_kwargs=None, worker_fault=None,
                 expect_restart=False, n_pods=160, rounds=6, recovery_s=60.0):
    from kube_throttler_tpu_torch.faults.plan import FaultPlan

    # Front-side plans are passed EMPTY at construction (the ring writer
    # captures front.faults by reference at spawn) and armed only after
    # seeding: a torn commit during build_fleet would kill the worker
    # before the matrix even starts measuring.
    plan = FaultPlan(seed=seed) if rule_kwargs is not None else None
    worker_args = ["--fault-site", worker_fault] if worker_fault else None
    front, supervisor, pods = build_fleet(
        n_pods=n_pods, transport="socketpair", faults=plan,
        worker_args=worker_args,
    )
    result = {"case": f"{site}:{mode}", "seed": seed}
    try:
        # the event plane must be LIVE before the fault window — a fleet
        # that silently fell back to pickle would pass every gate while
        # testing nothing
        for sid in range(front.n_shards):
            handle = front.shards[sid]
            lane = getattr(handle, "shm_lane", None)
            assert lane is not None and not lane.dead, (
                f"shard {sid}: no live shm lane — matrix would be vacuous"
            )
            assert getattr(handle, "_shm_active", False), (
                f"shard {sid}: shm lane never promoted past the barrier"
            )

        restarts_before = sum(supervisor.restart_counts().values())
        if plan is not None:
            plan.rule(site, mode=mode, **dict(rule_kwargs))
            if site == "shm.segment.unlink":
                # the unlink only runs when a writer closes: force one
                # restart so the monitor closes the old handle mid-run
                plan.rule("shm.slot.torn_commit", mode="torn", times=1)
        churn(front, pods, rounds=rounds)

        deadline = time.monotonic() + recovery_s
        recovered = False
        while time.monotonic() < deadline:
            state, _ = front._shards_health()
            if state == "ok":
                recovered = True
                break
            time.sleep(0.1)
        assert recovered, f"fleet never recovered: {front._shards_health()}"
        assert front.drain(120.0)
        time.sleep(0.5)

        restarts_after = sum(supervisor.restart_counts().values())
        if expect_restart:
            assert restarts_after > restarts_before, (
                f"{site}: expected a worker restart (torn ring ⇒ die as a "
                f"unit ⇒ fresh segment), saw none"
            )
        else:
            assert restarts_after == restarts_before, (
                f"{site}: a latency/backpressure fault must not restart "
                f"workers (restarts {restarts_before} -> {restarts_after})"
            )
        result["restarts"] = restarts_after - restarts_before

        if plan is not None:
            fired = plan.fired(site)
            assert fired >= 1, f"{site} never fired (vacuous pass)"
            result["fired"] = fired
        else:
            # worker-side rule: the plan lives in the worker process.
            # Prove the faulted path ran by the pump having decoded
            # frames through the very peek loop the site instruments
            total_frames = 0
            for sid in range(front.n_shards):
                shm = front.shards[sid].request("stats", None, timeout=30.0)["shm"]
                assert shm is not None, f"shard {sid}: pump gone after heal"
                total_frames += shm["frames"]
            assert total_frames > 0, "no frames crossed the ring"
            result["fired"] = None
            result["pump_frames"] = total_frames

        # post-heal the plane must still (or again) be the live path
        for sid in range(front.n_shards):
            handle = front.shards[sid]
            lane = getattr(handle, "shm_lane", None)
            assert lane is not None and not lane.dead, (
                f"shard {sid}: lane dead after heal — fallback is hiding"
            )

        wrong, stale = final_state(front)
        assert not wrong, f"wrong verdicts after heal: {wrong[:3]}"
        assert not stale, f"lost flips after heal: {stale[:3]}"
        bad = audit_all(front)
        assert not bad, f"orphan audit failed: {bad}"
        result["ok"] = True
    finally:
        supervisor.stop()
        front.stop()
    leftovers = _shm_leftovers()
    assert not leftovers, f"leaked shm segments after stop: {leftovers}"
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="netchaostest")
    sub = parser.add_subparsers(dest="command", required=True)
    m = sub.add_parser("matrix", help="every net.* + shm.* site x 3 seeds")
    m.add_argument("--seeds", default=",".join(str(s) for s in SEEDS))
    m.add_argument("--json", default="", help="write the matrix report here")
    m.add_argument("--only", choices=("all", "net", "shm"), default="all",
                   help="restrict the matrix to one transport column")
    one = sub.add_parser("one", help="a single case")
    one.add_argument("--site", required=True)
    one.add_argument("--mode", default="error")
    one.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)


    if args.command == "one":
        if args.site.startswith("shm."):
            case = next(
                (c for c in SHM_CASES
                 if c[0] == args.site and c[1] == args.mode),
                None,
            )
            if case is None:
                parser.error(f"unknown shm case {args.site}:{args.mode}")
            _, _, kwargs, worker_fault, expect_restart = case
            result = run_shm_case(
                args.site, args.mode, args.seed, rule_kwargs=kwargs,
                worker_fault=worker_fault, expect_restart=expect_restart,
            )
        else:
            kwargs = next(
                (kw for s, md, kw in CASES
                 if s == args.site and md == args.mode),
                None,
            )
            result = run_case(args.site, args.mode, args.seed,
                              rule_kwargs=kwargs)
        print(json.dumps(result, indent=2))
        return 0

    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    results, failures = [], 0
    if args.only in ("all", "net"):
        for site, mode, kwargs in CASES:
            for seed in seeds:
                label = f"{site}:{mode}"
                t0 = time.monotonic()
                try:
                    result = run_case(site, mode, seed, rule_kwargs=kwargs)
                    result["wall_s"] = round(time.monotonic() - t0, 1)
                    results.append(result)
                    print(f"PASS {label:<28} seed={seed} "
                          f"fired={result['fired']} "
                          f"reconnects={result['reconnects']} "
                          f"({result['wall_s']}s)")
                except Exception as e:  # noqa: BLE001 — matrix reports, then fails
                    failures += 1
                    results.append(
                        {"case": label, "seed": seed, "error": repr(e)}
                    )
                    print(f"FAIL {label:<28} seed={seed}: {e!r}")
    if args.only in ("all", "shm"):
        for site, mode, kwargs, worker_fault, expect_restart in SHM_CASES:
            for seed in seeds:
                label = f"{site}:{mode}"
                t0 = time.monotonic()
                try:
                    result = run_shm_case(
                        site, mode, seed, rule_kwargs=kwargs,
                        worker_fault=worker_fault,
                        expect_restart=expect_restart,
                    )
                    result["wall_s"] = round(time.monotonic() - t0, 1)
                    results.append(result)
                    print(f"PASS {label:<28} seed={seed} "
                          f"fired={result['fired']} "
                          f"restarts={result['restarts']} "
                          f"({result['wall_s']}s)")
                except Exception as e:  # noqa: BLE001 — matrix reports, then fails
                    failures += 1
                    results.append(
                        {"case": label, "seed": seed, "error": repr(e)}
                    )
                    print(f"FAIL {label:<28} seed={seed}: {e!r}")
    n_net = len(CASES) * len(seeds) if args.only in ("all", "net") else 0
    n_shm = len(SHM_CASES) * len(seeds) if args.only in ("all", "shm") else 0
    total = n_net + n_shm
    print(f"\n{total - failures}/{total} transport-fault paths clean "
          "(zero wrong verdicts, zero lost flips, zero orphan reservations)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
