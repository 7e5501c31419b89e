"""Resharding chaos scenario: live scale 2→4→3 under storm load, with a
kill-mid-handoff episode.

The sharded bad-day scenario proved the scatter-gather plane
survives a shard death; this one proves the plane survives TOPOLOGY
CHANGE while serving. The composed ``bad_day`` trace replays through a
2-shard front at storm pace; mid-replay the supervisor live-splits to 4
shards — with a chaos flag arming ``reshard.dest.crash:kill`` on one NEW
worker's first incarnation, so the destination SIGKILLs mid-warm-up, the
coordinator aborts back to the source, the monitor respawns the worker
clean, and the retry cuts over — then live-merges 4→3. No restarts of
surviving workers, no replay pause.

Gates:

- **reshard**: both rescales complete inside the replay window, the
  armed kill demonstrably fired (≥1 abort observed + ≥1 worker restart),
  and the killed worker rejoined;
- **verdicts**: zero wrong verdicts — after convergence every pod's
  sharded ``pre_filter`` equals a single-process oracle rebuilt from the
  final state (code + normalized reasons);
- **flips** (zero LOST flips): every front-store throttle's published
  ``status.throttled`` flags equal the oracle's deterministic recompute
  — a flip dropped in a cutover (computed by the destination during
  warm-up, never re-published) would show here as a stale flag;
- **flip_p99**: crossing-anchored flip publication bounded OUTSIDE the
  handoff windows (a flip whose crossing lands inside a window may ride
  the cutover's re-publication path; the windows are reported);
- **orphans**: after the run every shard's ``reshard_audit`` is clean —
  zero reservations against throttles the shard no longer holds, zero
  pending handoffs, zero standing fences.

Run: ``python -m kube_throttler_tpu_torch.scenarios.resharding
[--device {cuda,cpu}]`` (wired into ``make scenario-test``). The workers
run on the caller's device as in ``sharded.py``: ``device=None`` means
CUDA and raises ``RuntimeError`` before any worker is spawned without it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["run_resharding_storm"]

logger = logging.getLogger(__name__)

_WINDOW_PAD_S = 0.25
UNDERSUBSCRIBED_PACE_HZ = 600.0
STORM_PACE_HZ = 1200.0


def _build_stack(n_shards: int, device: str):
    from ..sharding.front import AdmissionFront
    from ..sharding.supervisor import ShardSupervisor

    front = AdmissionFront(n_shards)
    supervisor = ShardSupervisor(
        front,
        use_device=True,
        restart_backoff=0.3,
        env={**os.environ, "KT_SHARD_QUIET": "1", "KT_LOCK_ASSERT": "0"},
        device=device,
    )
    supervisor.start(ready_timeout=300.0)
    return front, supervisor


def run_resharding_storm(
    seed: int = 0,
    pace_hz: Optional[float] = None,
    min_pace_frac: float = 0.6,
    flip_p99_ms: float = 300.0,
    rescale_deadline_s: float = 150.0,
    scenario_name: str = "bad_day",
    scale_path: Tuple[int, ...] = (2, 4, 3),
    kill_mid_handoff: bool = True,
    device=None,
) -> Dict:
    from .engine import _materialize_pod, _pod_fields, _seed_remote_store
    from .sharded import fleet_device
    from .corpus import get_scenario
    from .measure import count_watch_of, flip_watch_of, group_keys_of, lag_tracker
    from .trace import build_topology, build_trace, serialize_trace, trace_sha256

    device = fleet_device(device)
    host_cores = len(os.sched_getaffinity(0))
    undersubscribed = host_cores < max(scale_path) + 1
    if pace_hz is None or pace_hz <= 0:
        pace_hz = UNDERSUBSCRIBED_PACE_HZ if undersubscribed else STORM_PACE_HZ
    scn = get_scenario(scenario_name)
    topology = build_topology(scn, seed)
    header, ops = build_trace(scn, seed)
    trace_sha = trace_sha256(serialize_trace(header, ops))
    front, supervisor = _build_stack(scale_path[0], device)
    report: Dict = {
        "scenario": f"resharding_{scenario_name}",
        "scale_path": list(scale_path),
        "seed": seed,
        "trace_sha256": trace_sha,
        "pace_hz": pace_hz,
        "host_cores": host_cores,
        "undersubscribed": undersubscribed,
        "gates": {},
    }
    rescale_reports: List[Dict] = []
    rescale_windows: List[List[float]] = []  # [t0, t1] perf_counter
    rescale_errors: List[str] = []
    try:
        _seed_remote_store(front.store, scn, topology)
        front.drain(timeout=300.0)
        time.sleep(0.5)

        pending, flip_pending, pend_lock, _lags, flip_lags, flip_walls, on_write = (
            lag_tracker()
        )
        group_keys = group_keys_of(front.store)
        flip_watch, run_sums = flip_watch_of(front.store)
        count_watch, run_counts = count_watch_of(front.store)
        front.store.add_event_handler("Throttle", on_write, replay=False)

        from ..engine.ingest import MicroBatchIngest

        pipeline = MicroBatchIngest(front.store, batch_policy="adaptive")

        # rescale episodes fire at fixed fractions of the trace, in a
        # worker thread — the replay must keep pacing THROUGH the handoff
        # (that is the whole point of live resharding)
        def run_rescale(step: int, n_new: int) -> None:
            t0 = time.perf_counter()
            spawn_args = None
            if step == 0 and kill_mid_handoff:
                # arm the kill on the FIRST new worker's first incarnation
                # only: SIGKILL at its 2nd import chunk (mid-warm-up); the
                # monitor respawn comes up clean and the retry succeeds
                sid = supervisor.n_shards
                spawn_args = {
                    sid: ["--fault-site", "reshard.dest.crash:kill:1"]
                }
            try:
                rep = supervisor.rescale(
                    n_new,
                    handoff_deadline_s=rescale_deadline_s,
                    spawn_args=spawn_args,
                )
                rescale_reports.append(rep)
            except Exception as e:  # noqa: BLE001 — gate evidence, not a crash
                logger.exception("rescale to %d failed", n_new)
                rescale_errors.append(f"rescale->{n_new}: {e}")
            finally:
                rescale_windows.append([t0, time.perf_counter()])

        # ONE runner thread walks the whole scale path (rescale() is
        # one-at-a-time by contract), each step gated on replay progress
        op_counter = [0]
        replay_done = threading.Event()

        def rescale_runner() -> None:
            # top-level routing (threads checker): a dead runner means the
            # scale path silently never completes while the replay stays
            # green — route the death into the reshard gate's evidence
            try:
                for step, n_new in enumerate(scale_path[1:]):
                    target_idx = int(len(ops) * (0.25 + 0.35 * step))
                    while op_counter[0] < target_idx and not replay_done.is_set():
                        time.sleep(0.05)
                    run_rescale(step, n_new)
            except Exception as e:  # noqa: BLE001 — gate evidence, not a crash
                logger.exception("rescale runner died")
                rescale_errors.append(f"runner: {e!r}")

        runner = threading.Thread(
            target=rescale_runner, name="rescale-runner", daemon=True
        )
        n_applied_target = 0
        t0 = time.perf_counter()
        runner.start()
        for i, op in enumerate(ops):
            next_at = t0 + i / pace_hz
            delay = next_at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            op_counter[0] = i
            verb = op["verb"]
            now = time.perf_counter()
            grp = op.get("grp")
            with pend_lock:
                for key in group_keys.get(grp, ()):
                    pending.setdefault(key, now)
                if verb in ("update_pod", "create_pod", "delete_pod"):
                    watch = flip_watch.get(grp)
                    if watch:
                        s_old = run_sums.get(grp, 0)
                        s_new = s_old + op["cpu_m"] - op["prev_m"]
                        run_sums[grp] = s_new
                        for key, thr_mc in watch:
                            if (s_old >= thr_mc) != (s_new >= thr_mc):
                                flip_pending[key] = now
                    cwatch = count_watch.get(grp)
                    if cwatch and verb != "update_pod":
                        c_old = run_counts.get(grp, 0)
                        c_new = c_old + (1 if verb == "create_pod" else -1)
                        run_counts[grp] = c_new
                        for key, thr_n in cwatch:
                            if (c_old >= thr_n) != (c_new >= thr_n):
                                flip_pending[key] = now
            if verb in ("update_pod", "create_pod"):
                pod = _materialize_pod(
                    op["name"], op["grp"], op.get("node", "n0"), op["cpu_m"],
                    **_pod_fields(op),
                )
                pipeline.submit("upsert", "Pod", pod)
                n_applied_target += 1
            elif verb == "delete_pod":
                pipeline.submit("delete", "Pod", f"default/{op['name']}")
                n_applied_target += 1
            elif verb == "update_throttle":
                try:
                    thr = front.store.get_throttle("default", op["name"])
                except Exception:  # noqa: BLE001
                    continue
                from dataclasses import replace as _replace

                from ..api.types import ResourceAmount

                front.store.update_throttle_spec(
                    _replace(
                        thr,
                        spec=_replace(
                            thr.spec,
                            threshold=ResourceAmount.of(
                                pod=op.get("pod_threshold", 10)
                            ),
                        ),
                    )
                )
        t_fired = time.perf_counter() - t0
        replay_done.set()
        pipeline.flush(timeout=120.0)
        front.drain(timeout=300.0)
        # the sustain clock stops HERE: fire window + ingest drain. The
        # rescale runner may still be warming a destination — that wait
        # is the reshard gate's bookkeeping, not ingest.
        t_sustain = time.perf_counter() - t0
        runner.join(timeout=(rescale_deadline_s + 120.0) * len(scale_path))
        front.drain(timeout=300.0)
        time.sleep(1.5)
        pipe_stats = pipeline.stats()
        front.store.remove_event_handler("Throttle", on_write)
        pipeline.stop()

        sustained = pipe_stats["events_applied"] / t_sustain
        report["events"] = pipe_stats["events_applied"]
        report["fired_hz"] = round(len(ops) / t_fired, 1)
        report["sustained_hz"] = round(sustained, 1)
        from .slo import _latency_gates_enforced

        enforced = _latency_gates_enforced()
        pace_ok = sustained >= pace_hz * min_pace_frac
        # dropped events are a correctness failure on any host; only the
        # sustained-rate comparison is host-speed-dependent
        report["gates"]["pace"] = {
            "pass": (pace_ok or not enforced) and pipe_stats["dropped"] == 0,
            "sustained_hz": round(sustained, 1),
            "target_hz": pace_hz,
            "min_frac": min_pace_frac,
        }
        if not enforced and not pace_ok:
            report["gates"]["pace"]["note"] = (
                "ADVISORY (host below latency core floor) — would FAIL"
            )

        aborts = sum(r.get("aborts", 0) for r in rescale_reports)
        restarts = supervisor.restart_counts()
        final_state, _detail = front._shards_health()
        report["rescales"] = rescale_reports
        report["gates"]["reshard"] = {
            "pass": (
                not rescale_errors
                and len(rescale_reports) == len(scale_path) - 1
                and front.n_shards == scale_path[-1]
                and (not kill_mid_handoff or aborts >= 1)
                and (not kill_mid_handoff or sum(restarts.values()) >= 1)
                and final_state == "ok"
            ),
            "errors": rescale_errors,
            "aborts": aborts,
            "restarts": restarts,
            "final_shards": front.n_shards,
            "final_health": final_state,
            "windows_s": [
                [round(w[0] - t0, 2), round(w[1] - t0, 2)]
                for w in rescale_windows
            ],
        }

        # flip p99 outside the handoff windows (a crossing anchored inside
        # one may ride the cutover's re-publication path; the reshard gate
        # bounds the windows themselves)
        def in_window(anchor: float) -> bool:
            return any(
                w[0] - _WINDOW_PAD_S <= anchor <= w[1] + _WINDOW_PAD_S
                for w in rescale_windows
            )

        samples = [
            lag for lag, wall in zip(flip_lags, flip_walls)
            if not in_window(wall - lag)
        ]
        if samples:
            p50 = float(np.percentile(np.asarray(samples), 50)) * 1e3
            p99 = float(np.percentile(np.asarray(samples), 99)) * 1e3
        else:
            p50 = p99 = 0.0
        flip_ok = p99 <= flip_p99_ms
        # unmeasurable (zero samples) stays enforced on any host
        report["gates"]["flip_p99"] = {
            "pass": (flip_ok or not enforced) and len(samples) > 0,
            "p50_ms": round(p50, 1),
            "p99_ms": round(p99, 1),
            "bound_ms": flip_p99_ms,
            "samples": len(samples),
            "window_excluded": max(0, len(flip_lags) - len(samples)),
        }
        if not enforced and not flip_ok:
            report["gates"]["flip_p99"]["note"] = (
                "ADVISORY (host below latency core floor) — would FAIL"
            )

        # oracle: verdicts + zero lost flips (flags ≡ deterministic recompute)
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
        stale_flags = []
        oracle_by_key = {t.key: t for t in oracle_store.list_throttles()}
        for thr in front.store.list_throttles():
            want = oracle_by_key.get(thr.key)
            if want is not None and thr.status.throttled != want.status.throttled:
                stale_flags.append(thr.key)
        report["gates"]["flips"] = {
            "pass": not stale_flags,
            "stale": len(stale_flags),
            "checked": len(oracle_by_key),
            "examples": stale_flags[:5],
        }

        # zero orphans: every shard's reshard audit must come back clean
        audit_bad: List[str] = []
        audits = {}
        for sid in range(front.n_shards):
            handle = front.shards.get(sid)
            if handle is None or not handle.alive:
                audit_bad.append(f"shard-{sid}: down")
                continue
            try:
                a = handle.request("reshard_audit", None, timeout=30.0)
            except Exception as e:  # noqa: BLE001 — a dark shard fails the gate
                audit_bad.append(f"shard-{sid}: {e}")
                continue
            audits[sid] = a
            if a["orphan_reservations"]:
                audit_bad.append(
                    f"shard-{sid}: orphan reservations {a['orphan_reservations'][:3]}"
                )
            if a["pending_handoffs"]:
                audit_bad.append(f"shard-{sid}: pending handoffs")
            if a["fenced_handoffs"]:
                audit_bad.append(f"shard-{sid}: standing fences")
        report["gates"]["orphans"] = {
            "pass": not audit_bad,
            "bad": audit_bad,
            "audits": audits,
        }

        report["pass"] = all(g["pass"] for g in report["gates"].values())
        return report
    finally:
        supervisor.stop()
        front.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="scenarios.resharding")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--pace", type=float, default=0.0,
        help="replay pace in ev/s; 0 = auto (host-core aware)",
    )
    parser.add_argument("--scenario", default="bad_day")
    parser.add_argument(
        "--scale-path", default="2,4,3",
        help="comma-separated shard counts the run walks through",
    )
    parser.add_argument("--no-kill", action="store_true",
                        help="skip the kill-mid-handoff episode")
    parser.add_argument("--json", default="", help="write the report here too")
    from ..utils.platform import add_device_argument, device_or_report

    add_device_argument(parser, "every shard worker's device data plane")
    args = parser.parse_args(argv)
    # without a CUDA device '--device cuda' exits here, before any worker
    device = device_or_report(args.device)
    if device is None:
        return 1
    scale_path = tuple(int(s) for s in args.scale_path.split(",") if s)
    report = run_resharding_storm(
        seed=args.seed,
        pace_hz=args.pace,
        scenario_name=args.scenario,
        scale_path=scale_path,
        kill_mid_handoff=not args.no_kill,
        device=device.type,
    )
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
