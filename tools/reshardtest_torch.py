#!/usr/bin/env python
"""Kill-mid-handoff chaos matrix for live elastic resharding, over the
PyTorch port (``kube_throttler_tpu_torch``; host-only shard cores). A copy
of ``tools/reshardtest.py`` with the port's imports.

Every abort path of the fenced two-phase handoff (sharding/reshard.py),
driven deterministically over in-process shard cores (LocalShard — the
same transport the sharding equivalence tests use; the real-process
SIGKILL variant lives in scenarios/resharding.py), x 3 seeds:

    reshard.handoff.torn:torn   chunk corrupted → sink hash check refuses
    reshard.handoff.torn:error  stream torn outright
    reshard.dest.crash:error    destination fails mid-import
    reshard.fence.race:error    fence superseded after it was taken
    reshard.front.crash:error   coordinator dies between prepare and
                                cutover (TTL reapers clean both sides)
    src-down                    handoff source marked dead mid-stream
    dest-down                   handoff destination marked dead mid-stream

After every episode the matrix asserts the full abort contract:

- the retried (or re-run) rescale completes and adopts the target ring;
- ZERO wrong verdicts vs a single-process oracle rebuilt from the final
  state;
- ZERO orphan reservations: every shard's ``reshard_audit`` is clean —
  no reservation against a throttle the shard no longer holds, no
  pending handoff, no standing fence (TTL reapers forced where the
  abort path leaves orphans by design).

Run: ``python tools/reshardtest_torch.py matrix`` (wired into docs/robustness
as the resharding analog of crashtest/hatest).
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

CASES = (
    ("reshard.handoff.torn", "torn"),
    ("reshard.handoff.torn", "error"),
    ("reshard.dest.crash", "error"),
    ("reshard.fence.race", "error"),
    ("reshard.front.crash", "error"),
    ("src-down", ""),
    ("dest-down", ""),
)


def build_stack(n_shards, core_faults=None, n_throttles=24, n_pods=160,
                n_reserved=12):
    import tools.harness_torch as H
    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.sharding.front import AdmissionFront
    from kube_throttler_tpu_torch.sharding.ipc import LocalShard
    from kube_throttler_tpu_torch.sharding.worker import ShardCore

    front = AdmissionFront(n_shards)
    cores = []
    for i in range(n_shards):
        core = ShardCore(i, n_shards, use_device=False, faults=core_faults)
        cores.append(core)
        front.attach_shard(i, LocalShard(i, core, on_push=front.apply_status_push))
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
    assert front.drain(60.0)
    time.sleep(0.3)
    # live reservations make orphan accounting meaningful: a leaked
    # handoff would strand exactly these
    for pod in pods[:n_reserved]:
        status = front.reserve(pod)
        assert status.is_success(), status.reasons
    return front, cores


def attach_new_shard(front, cores, sid, faults=None):
    from kube_throttler_tpu_torch.sharding.ipc import LocalShard
    from kube_throttler_tpu_torch.sharding.worker import ShardCore

    core = ShardCore(sid, sid + 1, use_device=False, faults=faults)
    cores.append(core)
    front.attach_shard(sid, LocalShard(sid, core, on_push=front.apply_status_push))
    front.resync_shard(sid)
    return core


def audit_all(front, cores):
    """Every shard's orphan audit; returns the list of violations."""
    bad = []
    for sid in range(len(cores)):
        handle = front.shards.get(sid)
        if handle is None or not handle.alive:
            continue
        a = handle.request("reshard_audit", None)
        if a["orphan_reservations"]:
            bad.append(f"shard-{sid}: orphans {a['orphan_reservations']}")
        if a["pending_handoffs"]:
            bad.append(f"shard-{sid}: pending handoffs")
        if a["fenced_handoffs"]:
            bad.append(f"shard-{sid}: fences {a['fenced_handoffs']}")
    return bad


def oracle_wrong(front):
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
    oracle.stop()
    return wrong


def run_case(site, mode, seed):
    from kube_throttler_tpu_torch.faults.plan import FaultPlan
    from kube_throttler_tpu_torch.sharding.reshard import (
        CoordinatorCrash,
        ReshardCoordinator,
    )
    from kube_throttler_tpu_torch.sharding.ring import HashRing, plan_reshard

    worker_plan = coord_plan = dest_plan = None
    if site == "reshard.handoff.torn":
        # source-side site: arm the initial cores (only a source hits it)
        worker_plan = FaultPlan(seed=seed).rule(site, mode=mode, times=1)
    elif site == "reshard.dest.crash":
        # destination-side site: arm the NEW shard the rescale streams to
        dest_plan = FaultPlan(seed=seed).rule(site, mode=mode, times=1)
    elif site.startswith("reshard."):
        coord_plan = FaultPlan(seed=seed).rule(site, mode=mode, times=1)

    front, cores = build_stack(2, core_faults=worker_plan)
    result = {"case": f"{site}:{mode}" if mode else site, "seed": seed}
    try:
        attach_new_shard(front, cores, 2, faults=dest_plan)
        front.n_shards = 3
        target = HashRing(3)

        if site in ("src-down", "dest-down"):
            # kill one side mid-stream: fail the first chunk relay by
            # marking the handle dead right before the rescale begins,
            # revive after the first abort, and let the retry land
            plan = plan_reshard(front.ring, target)
            victim_sid = (
                plan.moves[0].src if site == "src-down" else plan.moves[0].dst
            )
            handle = front.shards[victim_sid]
            handle.alive = False

            import threading

            def revive():
                time.sleep(1.0)
                handle.alive = True
                handle.clear_dirty()

            threading.Thread(target=revive, daemon=True).start()
            report = ReshardCoordinator(front).rescale(target, deadline_s=60.0)
            result["aborts"] = report["aborts"]
            assert report["aborts"] >= 1, "down handle never aborted a handoff"
        else:
            coordinator = ReshardCoordinator(front, faults=coord_plan)
            try:
                report = coordinator.rescale(target, deadline_s=60.0)
                result["aborts"] = report["aborts"]
                if site != "reshard.front.crash":
                    armed = worker_plan or dest_plan or coord_plan
                    fired = armed.fired(site)
                    assert fired >= 1, f"{site} never fired"
                    assert report["aborts"] >= 1, f"{site} fired but no abort"
            except CoordinatorCrash:
                assert site == "reshard.front.crash"
                # the orphaned handoff is nobody's problem but the TTL
                # reapers': force them, then prove a fresh coordinator
                # (the restarted front) completes the retarget
                for core in cores:
                    core.prepare_ttl = 0.0
                    core.reap_stale_txns()
                report = ReshardCoordinator(front).rescale(
                    target, deadline_s=60.0
                )
                result["aborts"] = report["aborts"]
                result["reaped"] = sum(c.reaped_handoffs for c in cores)
                assert result["reaped"] >= 1, "reapers never cleaned the orphan"

        assert front.drain(60.0)
        time.sleep(0.4)
        wrong = oracle_wrong(front)
        assert not wrong, f"wrong verdicts after abort+retry: {wrong[:3]}"
        bad = audit_all(front, cores)
        assert not bad, f"orphan audit failed: {bad}"
        result["ok"] = True
        return result
    finally:
        for core in cores:
            core.stop()
        front.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="reshardtest")
    sub = parser.add_subparsers(dest="command", required=True)
    m = sub.add_parser("matrix", help="every abort path x 3 seeds")
    m.add_argument("--seeds", default=",".join(str(s) for s in SEEDS))
    m.add_argument("--json", default="", help="write the matrix report here")
    one = sub.add_parser("one", help="a single case")
    one.add_argument("--site", required=True)
    one.add_argument("--mode", default="error")
    one.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)


    if args.command == "one":
        result = run_case(args.site, args.mode, args.seed)
        print(json.dumps(result, indent=2))
        return 0

    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    results, failures = [], 0
    for site, mode in CASES:
        for seed in seeds:
            label = f"{site}:{mode}" if mode else site
            t0 = time.monotonic()
            try:
                result = run_case(site, mode, seed)
                result["wall_s"] = round(time.monotonic() - t0, 1)
                results.append(result)
                print(f"PASS {label:<28} seed={seed} "
                      f"aborts={result.get('aborts')} ({result['wall_s']}s)")
            except Exception as e:  # noqa: BLE001 — matrix reports, then fails
                failures += 1
                results.append({"case": label, "seed": seed, "error": repr(e)})
                print(f"FAIL {label:<28} seed={seed}: {e!r}")
    total = len(CASES) * len(seeds)
    print(f"\n{total - failures}/{total} abort paths clean "
          "(zero wrong verdicts, zero orphan reservations)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
