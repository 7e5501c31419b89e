#!/usr/bin/env python
"""Live rolling-upgrade chaos matrix, over the PyTorch port
(``kube_throttler_tpu_torch``; its workers run with ``--no-device``). A
copy of ``tools/upgradetest.py`` (`make upgrade-test`) with the port's
imports.

A real fleet upgrade is a sequence of process bounces under load with
version skew in between: for a window, old and new builds share one
fleet and every wire/durable format crosses the boundary. This harness
drives that window against a LIVE 3-worker ``transport="tcp"`` shard
fleet (real processes over loopback, HMAC-keyed frames) while a
background churner swings group sums across flip thresholds, scatters
``pre_filter`` RPCs, and runs two-phase reserve/unreserve — the
composed bad-day storm the fleet is rolled under.

Cases (x seeds, ``matrix``):

- **worker_first** — the fleet starts ALL-OLD (capabilities masked via
  ``KT_PROTO_CAPS_MASK``, the zero-cap 1.0 baseline). Workers are
  rolled to the new build one at a time behind the resync barrier
  (``ShardSupervisor.rolling_restart``) while the front still speaks the
  old baseline (mixed skew: new workers negotiate DOWN to the pickle
  fallback), then the front upgrades and a second re-handshake roll
  brings every lane to the full capability set. One already-bounced
  shard is SIGKILLed MID-ROLL; the monitor must restore it without
  perturbing the roll's one-at-a-time discipline.
- **front_first** — the mirror order: the front advertises the full set
  first (new front + old workers negotiate the old baseline), then the
  workers roll to the new build.
- **incompatible_major** — a worker is rolled onto ``KT_PROTO_MAJOR=99``:
  the bounce must FAIL CLEANLY — typed ``VersionMismatch`` refusal,
  degraded health naming the mismatch, counted metric, paced retries
  (no crash loop) — and rolling back the override must heal the shard.

Oracle after every case (tools/netchaostest_torch.py helpers): ZERO wrong
verdicts vs a single-process rebuild, ZERO lost flips, ZERO orphan
reservations, and every bounce's wall-clock bounded.

Run: ``python tools/upgradetest_torch.py matrix`` (``make upgrade-test``);
``smoke`` is the reduced-scale CI gate (hack/ci.sh).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from tools.netchaostest_torch import audit_all, churn, final_state  # noqa: E402

SEEDS = (0, 1)

OLD_MASK = ""  # zero capabilities: the pre-capability 1.0 baseline


def _new_caps() -> str:
    from kube_throttler_tpu_torch.version import CAPABILITIES

    return ",".join(sorted(CAPABILITIES))


def _fleet_caps() -> frozenset:
    """The full capability set a lane of this TCP fleet can negotiate: a
    ``--listen`` worker has no shared-memory ring with its front, so it
    never advertises ``evt-shm`` (``sharding/worker.py`` ``main``)."""
    from kube_throttler_tpu_torch.version import CAPABILITIES

    return CAPABILITIES - {"evt-shm"}


def _set_env(var: str, value) -> None:
    if value is None:
        os.environ.pop(var, None)
    else:
        os.environ[var] = value


def build_fleet(n_shards=3, n_throttles=24, n_pods=160, n_reserved=8,
                rpc_deadline=10.0, worker_env=None):
    """netchaostest.build_fleet with per-side skew control: the front's
    hello reads ``os.environ`` at dial time (mask it BEFORE calling),
    while ``worker_env`` entries land in the supervisor's child env —
    explicit entries there win over the os.environ passthrough, so the
    two sides of the wire can run different advertised versions."""
    import tools.harness_torch as H
    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.sharding.front import AdmissionFront
    from kube_throttler_tpu_torch.sharding.supervisor import ShardSupervisor

    env = {**os.environ, "KT_SHARD_QUIET": "1", "KT_LOCK_ASSERT": "0"}
    env.update(worker_env or {})
    front = AdmissionFront(n_shards, rpc_deadline=rpc_deadline)
    supervisor = ShardSupervisor(
        front,
        transport="tcp",
        use_device=False,
        restart_backoff=0.3,
        env=env,
        auth_key=b"upgrade-matrix-psk",
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
        for pod in pods[:n_reserved]:
            status = front.reserve(pod)
            assert status.is_success(), status.reasons
    except BaseException:
        supervisor.stop()
        front.stop()
        raise
    return front, supervisor, pods


class Churner(threading.Thread):
    """Background bad-day storm: keeps the churn/scatter/two-phase load
    running THROUGH every bounce (storm-time refusals are fail-safe by
    design; only the post-roll equality gates count)."""

    def __init__(self, front, pods):
        super().__init__(name="upgrade-churner", daemon=True)
        self.front = front
        self.pods = pods
        self.halt = threading.Event()

    def run(self) -> None:
        while not self.halt.is_set():
            try:
                churn(self.front, self.pods, rounds=1, per_round=40)
            except Exception:  # noqa: BLE001 — the storm never kills itself
                time.sleep(0.2)

    def stop(self) -> None:
        self.halt.set()
        if self.ident is not None:  # join only once actually started
            self.join(timeout=30.0)


def _caps_of(front, sid) -> frozenset:
    handle = front.shards.get(sid)
    return frozenset(getattr(handle, "negotiated_caps", frozenset()) or frozenset())


def _wait_fleet_ok(front, recovery_s: float) -> None:
    deadline = time.monotonic() + recovery_s
    while time.monotonic() < deadline:
        state, _ = front._shards_health()
        if state == "ok":
            return
        time.sleep(0.1)
    raise AssertionError(f"fleet never recovered: {front._shards_health()}")


def _final_gates(front, result) -> None:
    assert front.drain(120.0)
    time.sleep(0.5)
    wrong, stale = final_state(front)
    assert not wrong, f"wrong verdicts after the roll: {wrong[:3]}"
    assert not stale, f"lost flips after the roll: {stale[:3]}"
    bad = audit_all(front)
    assert not bad, f"orphan audit failed: {bad}"
    result["ok"] = True


def case_worker_first(seed, n_pods=160, bounce_bound_s=90.0,
                      kill_mid_roll=True, recovery_s=60.0):
    """All-old fleet; workers roll to new under the old front (pickle
    fallback skew), one already-bounced shard is SIGKILLed mid-roll,
    then the front upgrades and a second roll re-handshakes every lane
    up to the full capability set."""
    result = {"case": "worker_first", "seed": seed}
    _set_env("KT_PROTO_CAPS_MASK", OLD_MASK)  # the front speaks the baseline
    try:
        front, supervisor, pods = build_fleet(
            n_pods=n_pods, worker_env={"KT_PROTO_CAPS_MASK": OLD_MASK},
        )
    except BaseException:
        _set_env("KT_PROTO_CAPS_MASK", None)
        raise
    churner = Churner(front, pods)
    try:
        for sid in range(front.n_shards):
            assert not _caps_of(front, sid), (
                f"shard {sid} negotiated caps on an all-old fleet"
            )
        churner.start()
        # stage the WORKER upgrade: children spawned from here advertise
        # the full set (explicit env entry wins over the front's mask)
        supervisor.env["KT_PROTO_CAPS_MASK"] = _new_caps()
        bounced, killed = [], {}

        def gate(sid):
            bounced.append(sid)
            if kill_mid_roll and len(bounced) == 2 and not killed:
                # mid-roll SIGKILL of a NON-bouncing shard: the monitor
                # (not the roll) must restore it, with the roll's
                # one-at-a-time discipline undisturbed
                victim = bounced[0]
                proc = supervisor.shard_proc(victim)
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    killed["shard"] = victim
            return None

        report = supervisor.rolling_restart(
            ready_timeout=60.0, settle_timeout=60.0, gate=gate,
        )
        assert report["aborted"] is None, report["aborted"]
        slow = [b for b in report["bounces"] if b["seconds"] > bounce_bound_s]
        assert not slow, f"bounce recovery exceeded {bounce_bound_s}s: {slow}"
        result["kill"] = killed.get("shard")
        _wait_fleet_ok(front, recovery_s)
        # mixed-skew window held: new workers, old front → every lane
        # negotiated DOWN to the zero-cap baseline
        for sid in range(front.n_shards):
            assert not _caps_of(front, sid), (
                f"shard {sid} negotiated caps past the front's mask"
            )
        # upgrade the FRONT: full advertisement + a re-handshake roll
        _set_env("KT_PROTO_CAPS_MASK", None)
        report2 = supervisor.rolling_restart(
            ready_timeout=60.0, settle_timeout=60.0,
        )
        assert report2["aborted"] is None, report2["aborted"]
        churner.stop()
        _wait_fleet_ok(front, recovery_s)
        for sid in range(front.n_shards):
            assert _caps_of(front, sid) == _fleet_caps(), (
                f"shard {sid} did not land on the full capability set: "
                f"{_caps_of(front, sid)}"
            )
        result["bounces"] = len(report["bounces"]) + len(report2["bounces"])
        _final_gates(front, result)
        return result
    finally:
        churner.stop()
        _set_env("KT_PROTO_CAPS_MASK", None)
        supervisor.stop()
        front.stop()


def case_front_first(seed, n_pods=160, bounce_bound_s=90.0, recovery_s=60.0):
    """All-old fleet; the FRONT upgrades first (new front + old workers
    negotiate the baseline), then the workers roll to the new build."""
    result = {"case": "front_first", "seed": seed}
    _set_env("KT_PROTO_CAPS_MASK", OLD_MASK)
    try:
        front, supervisor, pods = build_fleet(
            n_pods=n_pods, worker_env={"KT_PROTO_CAPS_MASK": OLD_MASK},
        )
    except BaseException:
        _set_env("KT_PROTO_CAPS_MASK", None)
        raise
    churner = Churner(front, pods)
    try:
        churner.start()
        # the front upgrades FIRST: full advertisement on every dial from
        # here on; workers stay masked (their env entry is explicit)
        _set_env("KT_PROTO_CAPS_MASK", None)
        report = supervisor.rolling_restart(
            ready_timeout=60.0, settle_timeout=60.0,
        )
        assert report["aborted"] is None, report["aborted"]
        _wait_fleet_ok(front, recovery_s)
        # mixed-skew window: new front, old workers → baseline everywhere
        for sid in range(front.n_shards):
            assert not _caps_of(front, sid), (
                f"old worker {sid} negotiated caps it never advertised"
            )
        # then the workers roll to the new build
        supervisor.env.pop("KT_PROTO_CAPS_MASK", None)
        report2 = supervisor.rolling_restart(
            ready_timeout=60.0, settle_timeout=60.0,
        )
        assert report2["aborted"] is None, report2["aborted"]
        churner.stop()
        _wait_fleet_ok(front, recovery_s)
        for sid in range(front.n_shards):
            assert _caps_of(front, sid) == _fleet_caps()
        slow = [
            b for b in report["bounces"] + report2["bounces"]
            if b["seconds"] > bounce_bound_s
        ]
        assert not slow, f"bounce recovery exceeded {bounce_bound_s}s: {slow}"
        result["bounces"] = len(report["bounces"]) + len(report2["bounces"])
        _final_gates(front, result)
        return result
    finally:
        churner.stop()
        _set_env("KT_PROTO_CAPS_MASK", None)
        supervisor.stop()
        front.stop()


def case_incompatible_major(seed, n_pods=80, recovery_s=60.0):
    """A worker rolled onto an incompatible protocol major must refuse
    CLEANLY: typed VersionMismatch on the handle, degraded fleet health
    naming the mismatch, the counter bumped, no restart hot loop — and
    rolling the override back must heal the shard."""
    result = {"case": "incompatible_major", "seed": seed}
    _set_env("KT_PROTO_MAJOR", None)
    front, supervisor, pods = build_fleet(n_shards=2, n_pods=n_pods)
    try:
        restarts_before = dict(supervisor.restart_counts())
        supervisor.env["KT_PROTO_MAJOR"] = "99"
        report = supervisor.rolling_restart(
            shard_ids=[1], ready_timeout=6.0, settle_timeout=6.0,
        )
        assert report["aborted"] is not None, (
            "an incompatible-major bounce must abort the roll"
        )
        handle = front.shards.get(1)
        refused = getattr(handle, "version_refused", None)
        assert refused and "VersionMismatch" in str(refused), (
            f"no typed refusal on the handle: {refused!r}"
        )
        assert getattr(handle, "version_mismatches", 0) >= 1
        state, detail = front._shards_health()
        assert state != "ok", "fleet health ignored a version refusal"
        assert "version-mismatch" in json.dumps(detail), detail
        # no crash loop: the refusing worker keeps LISTENING (only the
        # lane died); the monitor must not burn restart budget on it
        time.sleep(1.5)
        after = dict(supervisor.restart_counts())
        churn_restarts = after.get(1, 0) - restarts_before.get(1, 0)
        assert churn_restarts <= 1, (
            f"restart hot loop on a version refusal: {churn_restarts} restarts"
        )
        result["refusal"] = str(refused)
        # heal: drop the override, roll the shard back
        supervisor.env.pop("KT_PROTO_MAJOR", None)
        report2 = supervisor.rolling_restart(
            shard_ids=[1], ready_timeout=60.0, settle_timeout=60.0,
        )
        assert report2["aborted"] is None, report2["aborted"]
        _wait_fleet_ok(front, recovery_s)
        _final_gates(front, result)
        return result
    finally:
        _set_env("KT_PROTO_MAJOR", None)
        supervisor.stop()
        front.stop()


CASES = (
    ("worker_first", case_worker_first),
    ("front_first", case_front_first),
    ("incompatible_major", case_incompatible_major),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="upgradetest")
    sub = parser.add_subparsers(dest="command", required=True)
    m = sub.add_parser("matrix", help="every roll order x seeds")
    m.add_argument("--seeds", default=",".join(str(s) for s in SEEDS))
    m.add_argument("--json", default="", help="write the matrix report here")
    one = sub.add_parser("one", help="a single case")
    one.add_argument("--case", required=True,
                     choices=[name for name, _ in CASES])
    one.add_argument("--seed", type=int, default=0)
    sub.add_parser("smoke", help="reduced-scale CI gate (hack/ci.sh)")
    args = parser.parse_args(argv)


    if args.command == "one":
        fn = dict(CASES)[args.case]
        result = fn(args.seed)
        print(json.dumps(result, indent=2))
        return 0

    if args.command == "smoke":
        t0 = time.monotonic()
        result = case_worker_first(0, n_pods=60, kill_mid_roll=True)
        print(f"smoke worker_first ok ({time.monotonic() - t0:.1f}s, "
              f"{result['bounces']} bounces, killed shard {result['kill']})")
        t0 = time.monotonic()
        case_incompatible_major(0, n_pods=40)
        print(f"smoke incompatible_major ok ({time.monotonic() - t0:.1f}s)")
        print("upgrade smoke: clean roll, clean refusal")
        return 0

    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    results, failures = [], 0
    for name, fn in CASES:
        for seed in seeds:
            t0 = time.monotonic()
            try:
                result = fn(seed)
                result["wall_s"] = round(time.monotonic() - t0, 1)
                results.append(result)
                print(f"PASS {name:<20} seed={seed} ({result['wall_s']}s)")
            except Exception as e:  # noqa: BLE001 — matrix reports, then fails
                failures += 1
                results.append({"case": name, "seed": seed, "error": repr(e)})
                print(f"FAIL {name:<20} seed={seed}: {e!r}")
    total = len(CASES) * len(seeds)
    print(f"\n{total - failures}/{total} rolling-upgrade paths clean "
          "(zero wrong verdicts, zero lost flips, zero orphan reservations)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
