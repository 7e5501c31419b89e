"""Partition bad-day scenario: the composed bad-day trace replayed
through a TCP shard fleet with a seeded asymmetric partition + heal.

The sharded runner (scenarios/sharded.py) proves the multiprocess stack
over inherited socketpairs — same host, kernel-guaranteed delivery, no
reconnects. This runner drives the SAME trace bytes (``build_trace`` of
the corpus' ``bad_day`` entry; the report pins the sha) through the
cross-host transport instead: a ``transport="tcp"`` supervisor fleet
where every front→worker frame can refuse, tear, stall, or blackhole
(the ``net.*`` sites, faults/plan.py).

Mid-storm, ONE shard's client-side plan arms ``net.partition`` for a
wall-clock window: that client's sends blackhole (asymmetric — the
worker stays healthy and can still talk, the front just can't reach it),
the maintainer thread churns through reconnect backoff, and verdicts
for the dark shard degrade fail-safe. When the window closes the client
heals, the supervisor's ``on_up`` bumps the fencing epoch and resyncs,
and any frame the partitioned-then-healed path held onto arrives stale
and is fenced by the worker. A seeded ``net.send.torn_frame`` rule adds
one mid-stream tear after heal so the reconnect path runs twice.

Gates (all deterministic — no timing SLO; the partition window IS the
latency story):

- **verdicts**: zero wrong verdicts vs a single-process oracle rebuilt
  from the final state (code + normalized reasons);
- **flips**: zero lost flips — every published ``status.throttled``
  equals the oracle's (heal ⇒ resync + re-push, nothing dropped while
  the send queue was dark);
- **recovery**: heal→converged (every shard ``ok``) within the bound;
- **audits**: clean two-phase state on every worker — zero orphan
  reservations, zero pending/fenced handoffs;
- **fencing**: the partition was REAL (connection losses observed,
  reconnects counted) and the healed client runs at a bumped epoch with
  the worker's ``wire_epoch`` agreeing.

Run: ``python -m kube_throttler_tpu_torch.scenarios.partition --seed 0
[--device {cuda,cpu}]`` (wired into ``make scenario-test``). The workers
run on the caller's device as in ``sharded.py``: ``device=None`` means
CUDA and raises ``RuntimeError`` before any worker is spawned without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

__all__ = ["run_partition_bad_day"]


def _build_fleet(n_shards: int, rpc_deadline: float, device: str):
    from ..sharding.front import AdmissionFront
    from ..sharding.supervisor import ShardSupervisor

    front = AdmissionFront(n_shards, rpc_deadline=rpc_deadline)
    supervisor = ShardSupervisor(
        front,
        transport="tcp",
        # device ON like the sharded runner: the flip lane (the zero-lost-
        # flips gate's subject) lives on the device mirror
        use_device=True,
        restart_backoff=0.3,
        env={**os.environ, "KT_SHARD_QUIET": "1", "KT_LOCK_ASSERT": "0"},
        device=device,
    )
    supervisor.start(ready_timeout=300.0)
    return front, supervisor


def run_partition_bad_day(
    n_shards: int = 2,
    seed: int = 0,
    pace_hz: float = 500.0,
    partition_at_frac: float = 0.35,
    partition_s: float = 2.0,
    recovery_s: float = 20.0,
    rpc_deadline: float = 10.0,
    scenario_name: str = "bad_day",
    device=None,
) -> Dict:
    from ..faults.plan import FaultPlan
    from .corpus import get_scenario
    from .engine import _materialize_pod, _pod_fields, _seed_remote_store
    from .sharded import fleet_device
    from .trace import build_topology, build_trace, serialize_trace, trace_sha256

    device = fleet_device(device)
    host_cores = len(os.sched_getaffinity(0))
    # byte-identical bad-day trace: built from the CORPUS entry, not from
    # partition_bad_day — the net faults live client-side, outside the
    # trace, so the replayed bytes equal the composed bad day's exactly
    scn = get_scenario(scenario_name)
    topology = build_topology(scn, seed)
    header, ops = build_trace(scn, seed)
    trace_sha = trace_sha256(serialize_trace(header, ops))

    front, supervisor = _build_fleet(n_shards, rpc_deadline, device)
    target_sid = 1 if n_shards > 1 else 0
    replay_len = len(ops) / pace_hz
    t_part = replay_len * partition_at_frac
    window = (t_part, t_part + partition_s)

    report: Dict = {
        "scenario": "partition_bad_day",
        "trace_scenario": scenario_name,
        "shards": n_shards,
        "seed": seed,
        "trace_sha256": trace_sha,
        "pace_hz": pace_hz,
        "host_cores": host_cores,
        "partitioned_shard": target_sid,
        "partition_window_s": [round(window[0], 2), round(window[1], 2)],
        "gates": {},
    }
    try:
        _seed_remote_store(front.store, scn, topology)
        front.drain(timeout=300.0)
        time.sleep(0.5)

        # the asymmetric partition: a client-side plan on ONE shard's
        # handle (TcpShardClient reads .faults per frame, so installing
        # it post-start is race-free w.r.t. the initial sync). The wall
        # clock anchors at replay start; the torn-frame rule fires once
        # after the heal so reconnect+resync runs a second time.
        handle = front.shards[target_sid]
        plan = FaultPlan(seed=seed)
        plan.rule("net.partition", mode="error", window=window)
        plan.rule(
            "net.send.torn_frame", mode="torn", times=1,
            window=(window[1] + 1.0, replay_len + 60.0),
        )
        t0_box: List[float] = [float("inf")]
        plan.set_time_source(lambda: time.perf_counter() - t0_box[0])
        handle.faults = plan

        from ..engine.ingest import MicroBatchIngest

        pipeline = MicroBatchIngest(front.store, batch_policy="adaptive")
        losses_before = dict(supervisor.connection_losses())
        t0 = time.perf_counter()
        t0_box[0] = t0
        for i, op in enumerate(ops):
            next_at = t0 + i / pace_hz
            delay = next_at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            verb = op["verb"]
            if verb in ("update_pod", "create_pod"):
                pipeline.submit(
                    "upsert", "Pod",
                    _materialize_pod(
                        op["name"], op["grp"], op.get("node", "n0"),
                        op["cpu_m"], **_pod_fields(op),
                    ),
                )
            elif verb == "delete_pod":
                pipeline.submit("delete", "Pod", f"default/{op['name']}")
        pipeline.flush(timeout=120.0)
        t_heal = t0 + window[1]

        # recovery: heal→converged, measured from the window's CLOSE (the
        # partition window itself is scheduled downtime, not recovery)
        rec_deadline = max(time.monotonic(), time.monotonic() + (
            t_heal - time.perf_counter()
        )) + recovery_s
        recovered_at: Optional[float] = None
        while time.monotonic() < rec_deadline:
            state, _ = front._shards_health()
            if state == "ok" and time.perf_counter() >= t_heal:
                recovered_at = time.perf_counter()
                break
            time.sleep(0.1)
        front.drain(timeout=300.0)
        time.sleep(1.0)
        pipe_stats = pipeline.stats()
        pipeline.stop()

        heal_lag = (
            max(0.0, recovered_at - t_heal) if recovered_at is not None else None
        )
        report["events"] = pipe_stats["events_applied"]
        report["dropped"] = pipe_stats["dropped"]
        report["gates"]["recovery"] = {
            "pass": recovered_at is not None,
            "heal_to_converged_s": (
                round(heal_lag, 2) if heal_lag is not None else None
            ),
            "bound_s": recovery_s,
        }

        # fencing evidence: the partition must have been REAL (the client
        # observably lost and re-established its primary lane) and the
        # healed path must run at a BUMPED epoch the worker agrees on
        losses_after = supervisor.connection_losses()
        conn_lost = losses_after.get(target_sid, 0) - losses_before.get(
            target_sid, 0
        )
        worker_stats: Dict = {}
        try:
            worker_stats = handle.request("stats", None, timeout=30.0)
        except Exception as e:  # noqa: BLE001 — a dark shard fails the gate
            worker_stats = {"error": repr(e)}
        client_epoch = getattr(handle, "epoch", 0)
        wire_epoch = worker_stats.get("wire_epoch", -1)
        report["gates"]["fencing"] = {
            "pass": (
                conn_lost >= 1
                and handle.reconnects >= 1
                and client_epoch >= 2
                and wire_epoch == client_epoch
            ),
            "connection_losses": conn_lost,
            "reconnects": handle.reconnects,
            "client_epoch": client_epoch,
            "worker_wire_epoch": wire_epoch,
            "fenced_frames": worker_stats.get("fenced_frames"),
            "restarts": supervisor.restart_counts(),
        }

        # zero wrong verdicts + zero lost flips vs the rebuilt oracle
        import tools.harness_torch as H
        from ..api.pod import Namespace
        from ..engine.store import Store

        oracle_store = Store()
        oracle_store.create_namespace(Namespace("default"))
        for thr in front.store.list_throttles():
            oracle_store.create_throttle(thr)
        for pod in front.store.list_pods():
            oracle_store.create_pod(pod)
        oracle = H.build_plugin(oracle_store)
        oracle.run_pending_once()
        wrong = []
        for pod in oracle_store.list_pods():
            got = front.pre_filter(pod)
            want = oracle.pre_filter(pod)
            if got.code != want.code or H.normalized_reasons(
                got.reasons
            ) != H.normalized_reasons(want.reasons):
                wrong.append(pod.key)
        report["gates"]["verdicts"] = {
            "pass": not wrong,
            "wrong": len(wrong),
            "checked": len(oracle_store.list_pods()),
            "examples": wrong[:5],
        }
        oracle_by_key = {t.key: t for t in oracle_store.list_throttles()}
        stale = [
            thr.key
            for thr in front.store.list_throttles()
            if (w := oracle_by_key.get(thr.key)) is not None
            and thr.status.throttled != w.status.throttled
        ]
        report["gates"]["flips"] = {
            "pass": not stale, "stale": len(stale), "examples": stale[:5],
        }

        # clean two-phase audits on every worker
        audit_bad = []
        for sid in range(front.n_shards):
            h = front.shards.get(sid)
            if h is None or not h.alive:
                audit_bad.append(f"shard-{sid}: down")
                continue
            try:
                a = h.request("reshard_audit", None, timeout=30.0)
            except Exception as e:  # noqa: BLE001 — a dark shard fails the gate
                audit_bad.append(f"shard-{sid}: {e}")
                continue
            if a["orphan_reservations"] or a["pending_handoffs"] or a["fenced_handoffs"]:
                audit_bad.append(f"shard-{sid}: {a}")
        report["gates"]["audits"] = {"pass": not audit_bad, "bad": audit_bad}

        report["net"] = {
            "partition_fired": plan.hits("net.partition") > 0
            and bool(plan.history.get("net.partition")),
            "torn_fired": bool(plan.history.get("net.send.torn_frame")),
            "deadline_exceeded": getattr(handle, "deadline_exceeded", 0),
            "partition_seconds": round(
                getattr(handle, "outage_seconds", lambda: 0.0)(), 2
            ),
        }
        report["pass"] = all(g["pass"] for g in report["gates"].values())
        return report
    finally:
        supervisor.stop()
        front.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="scenarios.partition")
    parser.add_argument("--shards", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pace", type=float, default=500.0)
    parser.add_argument("--partition-s", type=float, default=2.0)
    parser.add_argument("--json", default="", help="write the report here too")
    from ..utils.platform import add_device_argument, device_or_report

    add_device_argument(parser, "every shard worker's device data plane")
    args = parser.parse_args(argv)
    # without a CUDA device '--device cuda' exits here, before any worker
    device = device_or_report(args.device)
    if device is None:
        return 1
    report = run_partition_bad_day(
        n_shards=args.shards, seed=args.seed, pace_hz=args.pace,
        partition_s=args.partition_s, device=device.type,
    )
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
