"""Replica-serving scenario: the stateless read-replica admission tier
under storm, with a leader flip burst.

An owner (leader role: store + journal + snapshot + admission HTTP +
replication source) and one read replica (StandbyReplicator bootstrap +
journal-tail streaming, its own plugin + verdict cache, the staleness-
gated HTTP surface) run in-process. A paced pod-churn storm drives the
owner while a serving thread hammers the replica's prefilter path; mid-
storm the owner takes a FLIP BURST — threshold edits that flip hot
throttles throttled↔not-throttled — and every flip's propagation is
timed from the owner's status publication to the replica serving the
new verdict.

Gates:

- **verdicts**: zero wrong verdicts vs the owner oracle at every flip
  cutover AND in the final full-population sweep (replica's cached
  serving path vs a fresh owner-side recompute, code + normalized
  reasons);
- **lag**: replica verdict lag ≤ one flip SLO (the 150 ms serving
  bound) at the burst's p99 — the staleness story, measured not
  assumed;
- **staleness_gate**: with the gate's clock frozen past the bound the
  replica REFUSES reads with 503 (and counts the refusal), then serves
  again once fresh — the bound is enforced, not advisory;
- **forwarding**: a reserve submitted to the REPLICA lands on the
  owner's ledger and the response carries the forwarded-by marker;
- **cache**: the replica's verdict cache actually served during the
  storm (hits observed) — the tier ran hot, not incidentally correct.

Run: ``python -m kube_throttler_tpu_torch.scenarios.replica --seed 0
[--device {cuda,cpu}]`` (wired into ``make scenario-test``). Both plugins
run their device data plane on the caller's device: ``device=None``
(``--device cuda``) means CUDA and raises ``RuntimeError`` without it.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import replace as _replace
from typing import Dict, List, Optional

__all__ = ["run_replica_serving"]


def _req(port: int, method: str, path: str, body=None, timeout=10.0):
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            payload = resp.read().decode()
            headers = dict(resp.headers)
            status = resp.status
    except urllib.error.HTTPError as e:
        payload = e.read().decode()
        headers = dict(e.headers)
        status = e.code
    try:
        return status, json.loads(payload), headers
    except json.JSONDecodeError:
        return status, payload, headers


def _cpu_throttled(thr) -> bool:
    """The flip bit the burst toggles: the cpu request flag of the
    published status (``IsResourceAmountThrottled`` is a dataclass, so a
    bare ``bool()`` of it would always be True)."""
    flags = thr.status.throttled.resource_requests or {}
    return bool(flags.get("cpu", False))


def _wait(predicate, timeout=30.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return bool(predicate())


def _quiesce(tier, owner_store) -> bool:
    """Settle both tiers to ONE consistent cut: owner workqueues drained
    (statuses published), the replicator caught up to the owner journal's
    write position (nothing left in flight on the wire), then the
    replica's own reconciles drained. Verdict equality is only defined at
    such a cut — mid-churn the replica legitimately trails by one poll."""
    ok = _wait(
        lambda: len(tier.owner_plugin.throttle_ctr.workqueue) == 0
        and len(tier.owner_plugin.cluster_throttle_ctr.workqueue) == 0,
        timeout=30.0,
    )
    ok = _wait(
        lambda: tier.replicator._offset >= tier._oj.position()[0], timeout=30.0
    ) and ok
    ok = _wait(
        lambda: len(tier.replica_plugin.throttle_ctr.workqueue) == 0
        and len(tier.replica_plugin.cluster_throttle_ctr.workqueue) == 0,
        timeout=30.0,
    ) and ok
    ok = _wait(
        lambda: {p.key for p in owner_store.list_pods("default")}
        == {p.key for p in tier.replica_store.list_pods("default")},
        timeout=30.0,
    ) and ok
    return ok


class _Tier:
    """Owner + replica pair, in-process: the cli.py wiring of both roles
    without the process boundary (the scenario times verdict propagation
    at millisecond resolution — a subprocess would only add exec noise).

    No GUARDED_BY table: every attribute is assigned once during
    construction on the scenario thread and treated as immutable wiring
    thereafter — cross-thread safety lives inside the engine objects
    (store locks, replicator state, the gate's own counters), not here."""

    def __init__(self, workdir: str, max_lag_s: float, device):
        from ..api.pod import Namespace
        from ..engine.recovery import RecoveryManager
        from ..engine.replication import (
            FencingEpoch,
            HaCoordinator,
            ReplicaGate,
            ReplicationServer,
            ReplicationSource,
            StandbyReplicator,
        )
        from ..engine.snapshot import SnapshotManager
        from ..engine.store import Store
        from ..plugin import KubeThrottler, decode_plugin_args
        from ..server import ThrottlerHTTPServer

        args = decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        )
        owner_dir = os.path.join(workdir, "owner")
        replica_dir = os.path.join(workdir, "replica")
        os.makedirs(owner_dir)
        os.makedirs(replica_dir)

        self.owner_store = Store()
        self._oj = RecoveryManager(owner_dir).recover_store(self.owner_store)
        oepoch = FencingEpoch(owner_dir)
        self._oj.fencing = oepoch
        snap = SnapshotManager(owner_dir, self.owner_store)
        snap.fencing = oepoch
        snap.bind_journal(self._oj, every_lines=0)
        ha = HaCoordinator(oepoch, role="leader", journal=self._oj, snapshotter=snap)
        ha.become_leader()
        self.owner_store.create_namespace(Namespace("default"))
        snap.write(reason="bootstrap")
        self.owner_plugin = KubeThrottler(
            args, self.owner_store, use_device=True, start_workers=True,
            device=device,
        )
        self.owner_http = ThrottlerHTTPServer(self.owner_plugin, port=0)
        self.owner_http.start()
        self._repl_server = ReplicationServer(
            ReplicationSource(owner_dir, self._oj, oepoch)
        )
        self._repl_server.start()

        self.replica_store = Store()
        self._rj = RecoveryManager(replica_dir).recover_store(self.replica_store)
        repoch = FencingEpoch(replica_dir)
        self._rj.fencing = repoch
        self.replicator = StandbyReplicator(
            self.replica_store,
            self._rj,
            f"http://127.0.0.1:{self._repl_server.port}",
            epoch=repoch,
            poll_interval=0.02,
        )
        if not self.replicator.bootstrap(30.0):
            raise RuntimeError("replica bootstrap failed")
        self.replicator.start()
        self.replica_plugin = KubeThrottler(
            args, self.replica_store, use_device=True, start_workers=True,
            device=device,
        )
        self.gate = ReplicaGate(self.replicator, max_lag_s=max_lag_s)
        self.replica_http = ThrottlerHTTPServer(
            self.replica_plugin,
            port=0,
            replica_gate=self.gate,
            owner_url=f"http://127.0.0.1:{self.owner_http.port}",
        )
        self.replica_http.start()

    def stop(self):
        for closer in (
            self.replica_http.stop,
            self.replicator.stop,
            self.owner_http.stop,
            self._repl_server.stop,
            self.replica_plugin.stop,
            self.owner_plugin.stop,
            self._rj.close,
            self._oj.close,
        ):
            try:
                closer()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass


def run_replica_serving(
    seed: int = 0,
    pods: int = 800,
    throttles: int = 48,
    groups: int = 24,
    pace_hz: float = 200.0,
    flips: int = 12,
    flip_slo_ms: float = 150.0,
    storm_s: float = 8.0,
    max_lag_s: float = 5.0,
    device=None,
) -> Dict:
    from .. import resolve_device
    from ..api.pod import make_pod
    from ..api.types import ResourceAmount
    from .measure import served_throttle

    device = resolve_device(device)
    host_cores = len(os.sched_getaffinity(0))
    report: Dict = {
        "scenario": "replica_serving",
        "seed": seed,
        "pods": pods,
        "throttles": throttles,
        "groups": groups,
        "pace_hz": pace_hz,
        "flip_burst": flips,
        "flip_slo_ms": flip_slo_ms,
        "host_cores": host_cores,
        "gates": {},
    }
    rng = random.Random(seed)
    workdir = tempfile.mkdtemp(prefix="kt-replica-scn-")
    tier = _Tier(workdir, max_lag_s=max_lag_s, device=device)
    try:
        owner_store = tier.owner_store

        def bound_pod(name: str, grp: str, cpu_m: int):
            p = make_pod(
                name, labels={"grp": grp}, requests={"cpu": f"{cpu_m}m"}
            )
            p = _replace(p, spec=_replace(p.spec, node_name="n0"))
            p.status.phase = "Running"
            return p

        # topology: served_throttle's threshold classes, plus a FLIP BAND —
        # one hot throttle per flip whose cpu threshold starts ABOVE its
        # group's usage (not throttled) so the burst's edit flips it hard
        for i in range(throttles):
            owner_store.create_throttle(served_throttle(i, groups))
        flip_keys: List[str] = []
        for k in range(flips):
            thr = served_throttle(1_000 + k, groups)
            thr = _replace(
                thr,
                name=f"flip{k}",
                spec=_replace(
                    thr.spec,
                    threshold=ResourceAmount.of(requests={"cpu": "100000m"}),
                ),
            )
            owner_store.create_throttle(thr)
            flip_keys.append(thr.key)
        for i in range(pods):
            owner_store.create_pod(
                bound_pod(f"p{i}", f"g{i % groups}", (i % 7 + 1) * 100)
            )

        # replica catches up: same object population, then both plugins'
        # controllers settle
        synced = _wait(
            lambda: len(tier.replica_store.list_pods("default")) == pods
            and len(tier.replica_store.list_throttles()) == throttles + flips,
            timeout=60.0,
        )
        report["bootstrap_synced"] = synced
        if not synced:
            report["gates"]["verdicts"] = {"pass": False, "error": "never synced"}
            report["pass"] = False
            return report
        for plg in (tier.owner_plugin, tier.replica_plugin):
            _wait(
                lambda p=plg: len(p.throttle_ctr.workqueue) == 0
                and len(p.cluster_throttle_ctr.workqueue) == 0,
                timeout=60.0,
            )

        # the probe population: one representative pod per group (NOT in
        # the store — pure admission probes, so churn can't delete them)
        probes = [
            make_pod(f"probe-g{g}", labels={"grp": f"g{g}"}, requests={"cpu": "100m"})
            for g in range(groups)
        ]

        # ---- the storm: paced pod churn on the OWNER + a replica-serving
        # hammer. Writes go through the owner store (the leader's ingest
        # surface); reads hammer the replica plugin (the tier under test).
        stop = threading.Event()
        pause = threading.Event()  # set ⇒ churner idles (quiesced oracle cut)
        # Concurrency contract for the shared tallies below (no locks, no
        # GUARDED_BY — closure state, not class attrs): each cell has ONE
        # writer (churn_done ← churner thread, served ← hammer thread;
        # serve_errors is append-only from either, and list.append is
        # GIL-atomic). The main thread only reads them after stop.set()
        # + join(), which is the happens-before edge — mid-run reads
        # don't exist, so torn counts can't either.
        churn_done = [0]
        served = [0]
        serve_errors: List[str] = []

        def churner():
            try:
                _churn_loop()
            except Exception as e:  # noqa: BLE001 — a dead storm is a finding
                serve_errors.append(f"churner: {e!r}")

        def _churn_loop():
            crng = random.Random(seed + 1)
            period = 1.0 / pace_hz
            i = [pods]
            alive: List[str] = [f"p{j}" for j in range(pods)]
            while not stop.is_set():
                if pause.is_set():
                    time.sleep(0.01)
                    continue
                if crng.random() < 0.5 or not alive:
                    name = f"p{i[0]}"
                    i[0] += 1
                    owner_store.create_pod(
                        bound_pod(
                            name,
                            f"g{crng.randrange(groups)}",
                            crng.randrange(1, 8) * 100,
                        )
                    )
                    alive.append(name)
                else:
                    victim = alive.pop(crng.randrange(len(alive)))
                    try:
                        owner_store.delete_pod("default", victim)
                    except Exception:  # noqa: BLE001 — already gone is fine
                        pass
                churn_done[0] += 1
                time.sleep(period)

        def server_hammer():
            # paced, not flat-out: an unthrottled cache-hit loop would
            # monopolize the GIL on a 1-core harness and starve the very
            # controller threads whose flip propagation the lag gate times
            srng = random.Random(seed + 2)
            while not stop.is_set():
                try:
                    tier.replica_plugin.pre_filter(
                        probes[srng.randrange(len(probes))]
                    )
                    served[0] += 1
                except Exception as e:  # noqa: BLE001 — a serving crash is a finding
                    serve_errors.append(repr(e))
                    return
                time.sleep(0.001)

        threads = [
            threading.Thread(target=churner),
            threading.Thread(target=server_hammer),
        ]
        cache_hits_before = tier.replica_plugin.verdict_cache.stats()[0]
        for t in threads:
            t.start()

        # ---- the leader flip burst, mid-storm: force each flip throttle
        # across its threshold and time owner-publication → replica-verdict.
        time.sleep(min(1.0, storm_s / 4))
        lags_ms: List[float] = []
        flip_wrong: List[str] = []
        flip_timeouts = 0
        for k, key in enumerate(flip_keys):
            ns, name = key.split("/")
            thr = owner_store.get_throttle(ns, name)
            was = _cpu_throttled(thr)
            # flip hard: 1m throttles any non-empty group; 100000m clears
            new_mc = 1 if not was else 100_000
            owner_store.update_throttle_spec(
                _replace(
                    thr,
                    spec=_replace(
                        thr.spec,
                        threshold=ResourceAmount.of(requests={"cpu": f"{new_mc}m"}),
                    ),
                )
            )
            grp = thr.spec.selector.selector_terms[0].pod_selector.match_labels["grp"]
            probe = probes[int(grp[1:])]

            # owner publication: the flipped status lands in the owner store
            t_pub: Optional[float] = None
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                cur = owner_store.get_throttle(ns, name)
                if _cpu_throttled(cur) != was:
                    t_pub = time.monotonic()
                    break
                time.sleep(0.002)
            if t_pub is None:
                flip_timeouts += 1
                continue
            want = tier.owner_plugin.pre_filter(probe)

            # replica serving catches up: its verdict for the group probe
            # agrees with the owner's post-flip verdict
            t_rep: Optional[float] = None
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                got = tier.replica_plugin.pre_filter(probe)
                if got.code == want.code:
                    t_rep = time.monotonic()
                    break
                time.sleep(0.002)
            if t_rep is None:
                flip_timeouts += 1
                flip_wrong.append(f"{key}: replica never converged")
                continue
            lags_ms.append(max(0.0, (t_rep - t_pub) * 1e3))

            # cutover oracle: a QUIESCED cut — the lag above was timed
            # under live churn, but verdict equality is only defined at a
            # consistent state, so the churner pauses, both tiers settle,
            # and every pod of the flipped group must agree (replica's
            # cached serving path vs a fresh owner recompute)
            import tools.harness_torch as H

            pause.set()
            _quiesce(tier, owner_store)
            for pod in owner_store.list_pods("default"):
                if pod.labels.get("grp") != grp:
                    continue
                got = tier.replica_plugin.pre_filter(pod)
                ref = tier.owner_plugin._pre_filter_uncached(
                    pod, emit_events=False
                )
                if got.code != ref.code or H.normalized_reasons(
                    got.reasons
                ) != H.normalized_reasons(ref.reasons):
                    flip_wrong.append(
                        f"{key}/{pod.name}: {got.code} vs {ref.code}"
                    )
            pause.clear()

        stop.set()
        for t in threads:
            t.join(timeout=30)
        cache_hits = (
            tier.replica_plugin.verdict_cache.stats()[0] - cache_hits_before
        )
        report["storm"] = {
            "churn_events": churn_done[0],
            "replica_decisions_served": served[0],
            "serve_errors": serve_errors[:3],
            "replica_cache_hits": cache_hits,
        }

        lags_sorted = sorted(lags_ms)
        lag_p99 = (
            lags_sorted[max(0, int(len(lags_sorted) * 0.99) - 1)]
            if lags_sorted
            else None
        )
        lag_max = lags_sorted[-1] if lags_sorted else None
        from .slo import _latency_gates_enforced

        enforced = _latency_gates_enforced()
        lag_ok = lag_p99 is not None and lag_p99 <= flip_slo_ms
        # unmeasurable flips and timeouts stay enforced on any host —
        # only the wall-clock p99 comparison degrades to advisory
        report["gates"]["lag"] = {
            "pass": bool(lags_sorted)
            and flip_timeouts == 0
            and (lag_ok or not enforced),
            "flips_measured": len(lags_sorted),
            "flip_timeouts": flip_timeouts,
            "lag_p99_ms": round(lag_p99, 1) if lag_p99 is not None else None,
            "lag_max_ms": round(lag_max, 1) if lag_max is not None else None,
            "bound_ms": flip_slo_ms,
        }
        if not enforced and not lag_ok and lags_sorted:
            report["gates"]["lag"]["note"] = (
                "ADVISORY (host below latency core floor) — would FAIL"
            )

        # ---- final convergence + full-population verdict sweep
        import tools.harness_torch as H

        conv = _quiesce(tier, owner_store)
        wrong: List[str] = []
        checked = 0
        for pod in owner_store.list_pods("default"):
            got = tier.replica_plugin.pre_filter(pod)
            ref = tier.owner_plugin._pre_filter_uncached(pod, emit_events=False)
            checked += 1
            if got.code != ref.code or H.normalized_reasons(
                got.reasons
            ) != H.normalized_reasons(ref.reasons):
                wrong.append(f"{pod.key}: {got.code} vs {ref.code}")
        report["gates"]["verdicts"] = {
            "pass": conv and not flip_wrong and not wrong and not serve_errors,
            "converged": conv,
            "cutover_wrong": len(flip_wrong),
            "final_wrong": len(wrong),
            "final_checked": checked,
            "examples": (flip_wrong + wrong)[:5],
        }

        # ---- the staleness bound is ENFORCED: freeze the gate's clock
        # past the bound — reads refuse with 503 + the refusal is counted —
        # then unfreeze — reads serve again
        refused_before = tier.gate.refused_total
        real_clock = tier.gate._monotonic
        tier.gate._monotonic = lambda: (
            (tier.replicator.last_contact_monotonic or 0.0) + max_lag_s + 60.0
        )
        code_stale, body_stale, _ = _req(
            tier.replica_http.port,
            "POST",
            "/v1/prefilter",
            {"podKey": f"default/p{pods - 1}"},
        )
        tier.gate._monotonic = real_clock
        code_fresh, _, _ = _req(
            tier.replica_http.port,
            "POST",
            "/v1/prefilter",
            {"podKey": f"default/p{pods - 1}"},
        )
        report["gates"]["staleness_gate"] = {
            "pass": code_stale == 503
            and isinstance(body_stale, dict)
            and "stale" in body_stale.get("error", "")
            and tier.gate.refused_total > refused_before
            and code_fresh in (200, 404),
            "stale_status": code_stale,
            "fresh_status": code_fresh,
            "refusals": tier.gate.refused_total - refused_before,
        }

        # ---- forward-on-write: reserve through the REPLICA lands on the
        # owner's ledger, response marked as forwarded
        rsv = bound_pod("rsv0", "g0", 100)
        owner_store.create_pod(rsv)
        _wait(
            lambda: any(
                p.name == "rsv0" for p in tier.replica_store.list_pods("default")
            ),
            timeout=30.0,
        )
        code_fwd, _, headers = _req(
            tier.replica_http.port, "POST", "/v1/reserve", {"podKey": "default/rsv0"}
        )
        landed = _wait(
            lambda: any(
                "default/rsv0"
                in tier.owner_plugin.throttle_ctr.cache.reserved_pod_keys(t.key)
                for t in owner_store.list_throttles()
            ),
            timeout=30.0,
        )
        _req(
            tier.replica_http.port,
            "POST",
            "/v1/unreserve",
            {"podKey": "default/rsv0"},
        )
        report["gates"]["forwarding"] = {
            "pass": code_fwd == 200
            and headers.get("X-KT-Forwarded-By") == "replica"
            and landed,
            "status": code_fwd,
            "forwarded_by": headers.get("X-KT-Forwarded-By"),
            "landed_on_owner": landed,
        }

        # ---- the cache actually served the storm
        report["gates"]["cache"] = {
            "pass": cache_hits > 0 and served[0] > 0,
            "hits": cache_hits,
            "decisions": served[0],
        }

        report["pass"] = all(g["pass"] for g in report["gates"].values())
        return report
    finally:
        tier.stop()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="scenarios.replica")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pace", type=float, default=200.0)
    parser.add_argument("--flips", type=int, default=12)
    parser.add_argument("--flip-slo-ms", type=float, default=150.0)
    parser.add_argument("--json", default="", help="write the report here too")
    from ..utils.platform import add_device_argument, device_or_report

    add_device_argument(parser, "both plugins' device data plane")
    args = parser.parse_args(argv)
    # without a CUDA device '--device cuda' exits here, before the stack
    device = device_or_report(args.device)
    if device is None:
        return 1
    report = run_replica_serving(
        seed=args.seed,
        pace_hz=args.pace,
        flips=args.flips,
        flip_slo_ms=args.flip_slo_ms,
        device=device,
    )
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
