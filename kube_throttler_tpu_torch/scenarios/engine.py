"""The scenario engine: replay a committed trace through the REAL stack
and judge the SLO gates.

Topology and trace derive deterministically from ``(scenario, seed)``
(scenarios/trace.py); the run then composes the full remote-mode daemon —
mock apiserver over real HTTP → reflectors → adaptive micro-batched
ingest → shared informers → both controllers → device planes → two-lane
async status committer — exactly the production wiring (cli.py remote
mode / bench.py's remote rung), with ONE seeded
:class:`~kube_throttler_tpu_torch.faults.plan.FaultPlan` shared by the server's
fault verbs, the client transport, and the engine's own ``scenario.*``
action sites (apiserver restart with RV-window reset, continue-token
expiry, churn stalls, the injected regression, the leader-kill episode).

Measurements reuse the bench anchors (scenarios/measure.py): flip lag is
crossing-anchored against each label group's running cpu sum, maintained
from the trace's own ``prev_m`` chain so drain waves and herd bursts keep
the sums exact. After the replay the engine QUIESCES (reflectors past the
apiserver's final resourceVersion, ingest drained, workqueues empty,
committer flushed, no new writes) and then runs the zero-wrong-verdicts
sweep: the serving plugin's batch triage against an oracle stack rebuilt
from apiserver truth, plus a seeded per-pod host-oracle spot check that
is independent of every device plane and batch kernel.

Reports (one JSON per run) carry the gate verdicts, the measurements, the
committed trace's sha256 and path, and the fault-plan firing history (the
reproducibility witness).

The device is the caller's explicit choice: ``run_scenario(...,
device=None)`` means CUDA and raises ``RuntimeError`` before it builds
anything when there is none; ``device="cpu"`` runs both plugins' device
data plane on the CPU. With the verdict cache off (``KT_VERDICT_CACHE=0``)
each plugin's batch takes the device route, which on CUDA launches
``check_gather`` for the Throttle kind; with it on, a batch whose pods
share few verdict fingerprints is answered on the host, one check per
fingerprint.
"""

from __future__ import annotations

import json
import logging
import os
import random
import time
from typing import Dict, List, Optional

from .dsl import Scenario, compile_fault_rules
from .measure import (
    count_watch_of,
    flip_band_mc,
    flip_watch_of,
    group_keys_of,
    lag_tracker,
    served_throttle,
)
from .slo import evaluate_gates, host_spot_check
from .trace import build_topology, build_trace, serialize_trace, trace_sha256

logger = logging.getLogger(__name__)

# gates the in-process stack must close a restart loop within; replay
# pacing sleeps in slices this long so scenario.* sites stay responsive
_TICK_S = 0.02
_SPOT_CHECK_SAMPLE = 200

__all__ = ["run_scenario"]


def _materialize_pod(name: str, grp: str, node: str, cpu_m: int,
                     acl=None, gang=None, gsz: int = 0, pri=None):
    from dataclasses import replace as _replace

    from ..api.pod import make_pod

    pod = make_pod(
        name, labels={"grp": grp}, requests={"cpu": f"{cpu_m}m"},
        accel_class=acl, group=gang, group_size=gsz or None,
        priority=pri,
    )
    pod = _replace(pod, spec=_replace(pod.spec, node_name=node))
    pod.status.phase = "Running"
    return pod


def _pod_fields(spec_or_op: Dict) -> Dict:
    """The gang/accel/priority annotation fields a topology spec or trace
    op may carry (absent on every axis-off trace — committed corpus
    unchanged)."""
    out = {}
    if "acl" in spec_or_op:
        out["acl"] = spec_or_op["acl"]
    if "gang" in spec_or_op:
        out["gang"] = spec_or_op["gang"]
        out["gsz"] = int(spec_or_op.get("gsz", 0))
    if "pri" in spec_or_op:
        out["pri"] = int(spec_or_op["pri"])
    return out


def _accel_entries(topo, base_mc: int):
    """Per-class ``accelClassThresholds`` for a flip-band throttle: class
    c's cpu threshold scaled down by up to ``class_threshold_frac`` — the
    class-resolved admission inequality then genuinely diverges from the
    base one (the heterogeneity path, searchable by the hunt)."""
    frac = getattr(topo, "class_threshold_frac", 0.0)
    n = getattr(topo, "accel_classes", 0)
    if frac <= 0.0 or n <= 0:
        return ()
    from ..api.types import AccelClassThreshold, ResourceAmount

    return tuple(
        AccelClassThreshold(
            accel_class=f"ac{c}",
            threshold=ResourceAmount.of(
                requests={
                    "cpu": f"{max(int(base_mc * (1.0 - frac * (c + 1) / n)), 100)}m"
                }
            ),
        )
        for c in range(n)
    )


def _band_throttle(name: str, grp: str, sum_mc: int):
    from ..api.types import (
        LabelSelector,
        ResourceAmount,
        Throttle,
        ThrottleSelector,
        ThrottleSelectorTerm,
        ThrottleSpec,
    )

    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(requests={"cpu": f"{sum_mc}m"}),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels={"grp": grp})),
                )
            ),
        ),
    )


def _seed_remote_store(store, scn: Scenario, topology: Dict) -> None:
    from ..api.pod import Namespace

    store.create_namespace(Namespace("default"))
    topo = scn.topology
    band = flip_band_mc(max(topo.pods - topology["n_hot"], 1), max(topo.groups, 1))
    # flip band anchored at each group's ACTUAL initial cpu sum plus a
    # ~one-step offset: crossings need real drift (no thrash — a threshold
    # at the exact sum flips on nearly every update, and the resulting
    # flip-PUT flood feeds back into ingest as echo load), but the walk
    # still crosses within a few ops of any window opening. Density
    # matches the bench's band (every 24th throttle) so scenario flip
    # traffic stays a measurable sample stream, not a traffic class.
    sums: Dict[str, int] = {}
    for spec in topology["pods"]:
        sums[spec["grp"]] = sums.get(spec["grp"], 0) + spec["cpu_m"]
    _BAND_OFFSET_MC = 300
    from dataclasses import replace as _dreplace

    for i in range(topo.throttles):
        grp = f"g{i % max(topo.groups, 1)}"
        if i % 24 == 1 and sums.get(grp):
            thr = _band_throttle(f"t{i}", grp, sums[grp] + _BAND_OFFSET_MC)
            accel = _accel_entries(topo, sums[grp] + _BAND_OFFSET_MC)
            if accel:
                thr = _dreplace(
                    thr, spec=_dreplace(thr.spec, accel_class_thresholds=accel)
                )
            store.create_throttle(thr)
        else:
            store.create_throttle(served_throttle(i, topo.groups, flip_band_mc=band))
    if topology["n_hot"] > 0:
        # the hot key: ONE throttle matching the whole hot group, its cpu
        # threshold one step off the group's live sum so the dominant
        # (N,K) column flips under churn
        store.create_throttle(
            _band_throttle(
                "thot",
                "hot",
                sums.get("hot", topology["n_hot"] * 400) + _BAND_OFFSET_MC,
            )
        )
    for spec in topology["pods"]:
        store.create_pod(
            _materialize_pod(
                spec["name"], spec["grp"], spec["node"], spec["cpu_m"],
                **_pod_fields(spec),
            )
        )


# fault-schedule compilation is shared with the trace header's canonical
# plan commit: dsl.compile_fault_rules (one implementation, no drift)


def _oracle_store(remote):
    """Fresh store rebuilt from apiserver truth (statuses included)."""
    from ..api.pod import Namespace
    from ..engine.store import Store

    oracle = Store()
    for ns in remote.list_namespaces():
        oracle.create_namespace(Namespace(ns.name))
    ops = [("upsert", "Throttle", t) for t in remote.list_throttles()]
    ops += [("upsert", "ClusterThrottle", t) for t in remote.list_cluster_throttles()]
    ops += [("upsert", "Pod", p) for p in remote.list_pods()]
    for i in range(0, len(ops), 512):
        oracle.apply_events(ops[i : i + 512])
    return oracle


class _Replayer:
    """Walks the committed ops at their virtual times against the remote
    (apiserver) store, maintaining the crossing-anchored flip bookkeeping
    and dispatching the scenario.* action sites."""

    def __init__(self, engine):
        self.e = engine

    def run(self) -> Dict:
        e = self.e
        from dataclasses import replace as _replace

        from ..api.types import ResourceAmount

        remote = e.remote
        plan = e.plan
        pending, pend_lock = e.pending, e.pend_lock
        flip_watch, run_sums, flip_pending = e.flip_watch, e.run_sums, e.flip_pending
        count_watch, run_counts = e.count_watch, e.run_counts
        group_keys = e.group_keys
        n_crossings = 0
        n_applied = 0
        t0 = time.perf_counter()
        e.virtual_now = lambda: time.perf_counter() - t0
        plan.set_time_source(e.virtual_now)
        for op in e.ops:
            target = op["t_us"] / 1e6
            while True:
                self._scenario_sites()
                now_v = e.virtual_now()
                if now_v >= target:
                    break
                time.sleep(min(target - now_v, _TICK_S))
            verb = op["verb"]
            now = time.perf_counter()
            if verb == "update_throttle":
                key = f"default/{op['name']}"
                try:
                    thr = remote.get_throttle("default", op["name"])
                except Exception:
                    continue
                new_thr = _replace(
                    thr,
                    spec=_replace(
                        thr.spec,
                        threshold=ResourceAmount.of(pod=op["pod_threshold"]),
                    ),
                )
                grp = e.thr_grp.get(key)
                with pend_lock:
                    pending.setdefault(key, now)
                    # a spec change IS the crossing event for whatever flip
                    # it causes (calculatedThreshold and/or flags): stamp
                    # it so the sample doesn't fall back to the oldest
                    # refresh anchor (overstating by the whole backlog)
                    flip_pending[key] = now
                    if grp is not None:
                        # the new finite count threshold joins the count
                        # watch so later create/delete crossings stamp
                        entries = count_watch.setdefault(grp, [])
                        entries[:] = [(k, c) for k, c in entries if k != key]
                        entries.append((key, int(op["pod_threshold"])))
                remote.update_throttle_spec(new_thr)
                n_applied += 1
                continue
            grp = op["grp"]
            delta = op["cpu_m"] - op["prev_m"]
            delta_n = {"create_pod": 1, "delete_pod": -1}.get(verb, 0)
            with pend_lock:
                for key in group_keys.get(grp, ()):
                    pending.setdefault(key, now)
                watch = flip_watch.get(grp)
                if watch and delta:
                    s_old = run_sums.get(grp, 0)
                    s_new = s_old + delta
                    run_sums[grp] = s_new
                    for key, thr_mc in watch:
                        if (s_old >= thr_mc) != (s_new >= thr_mc):
                            flip_pending[key] = now  # latest crossing wins
                            n_crossings += 1
                cwatch = count_watch.get(grp)
                if delta_n:
                    c_old = run_counts.get(grp, 0)
                    c_new = c_old + delta_n
                    run_counts[grp] = c_new
                    for key, thr_n in cwatch or ():
                        if (c_old >= thr_n) != (c_new >= thr_n):
                            flip_pending[key] = now
                            n_crossings += 1
            try:
                if verb == "update_pod":
                    remote.update_pod(
                        _materialize_pod(
                            op["name"], grp, op["node"], op["cpu_m"],
                            **_pod_fields(op),
                        )
                    )
                elif verb == "create_pod":
                    remote.create_pod(
                        _materialize_pod(
                            op["name"], grp, op["node"], op["cpu_m"],
                            **_pod_fields(op),
                        )
                    )
                elif verb == "delete_pod":
                    remote.delete_pod("default", op["name"])
                n_applied += 1
            except Exception:
                logger.debug("replay op failed: %r", op, exc_info=True)
        self._scenario_sites()
        t_fired = time.perf_counter() - t0
        return {
            "ops_fired": len(e.ops),
            "ops_applied": n_applied,
            "fire_window_s": t_fired,
            "crossings": n_crossings,
        }

    def _scenario_sites(self) -> None:
        e = self.e
        e.sample_health()
        fault = e.plan.check("scenario.apiserver.restart")
        if fault is not None:
            if fault.mode == "expire_continues":
                n = e.server.expire_continue_tokens()
                logger.info("scenario: expired %d continue tokens", n)
            else:
                logger.info("scenario: restarting mock apiserver (RV reset)")
                e.server.restart(reset_rv_window=True, downtime_s=fault.delay)
                e.note_restart()
        fault = e.plan.check("scenario.churn.stall")
        if fault is not None:
            fault.sleep()


class _Engine:
    # analyzer annotations: the crossing-anchored flip bookkeeping
    # is shared between the replayer thread and the remote store's status
    # handler — both sides take pend_lock (measure.lag_tracker hands the
    # dicts and their lock out together). The assignment itself happens in
    # build(), single-threaded construction before any replay thread
    # exists (waived in baseline.txt). restart/resync/caughtup lists are
    # single-writer-per-index: note_restart appends (replayer thread),
    # each poll thread writes only its own index, readers join first.
    GUARDED_BY = {
        "pending": "self.pend_lock",
        "flip_pending": "self.pend_lock",
    }

    def __init__(self, scn: Scenario, seed: int, workdir: str,
                 regression: Optional[str] = None, registry=None, device=None):
        from .. import resolve_device

        self.device = resolve_device(device)
        self.scn = scn
        self.seed = seed
        self.workdir = workdir
        self.regression = regression
        self.registry = registry
        self.restart_times: List[float] = []
        # per restart: wall time every reflector's resume point passed the
        # post-reset RV floor (the relist completed), or None while pending
        self.resync_times: List[Optional[float]] = []
        # per restart: wall time the post-relist wire backlog fully
        # drained (ingest queue empty) — the outage window's end for flip
        # classification: a crossing queued behind the relist bubble
        # cannot publish sooner, and the RECOVERY gate bounds that bubble
        self.caughtup_times: List[Optional[float]] = []
        self.virtual_now = lambda: 0.0

    def note_restart(self) -> None:
        """Record a restart and watch for the full resync: recovery is
        judged from restart to the first status publication AFTER every
        reflector relisted past the reset RV floor — a PUT that lands
        while the watch path is still down is liveness of the committer,
        not recovery of the loop."""
        import threading

        t_restart = time.perf_counter()
        floor_rv = self.remote.latest_resource_version
        idx = len(self.restart_times)
        self.restart_times.append(t_restart)
        self.resync_times.append(None)
        self.caughtup_times.append(None)

        def poll() -> None:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                try:
                    if all(
                        int(r.last_resource_version or 0) >= floor_rv
                        for r in self.session.reflectors.values()
                    ):
                        self.resync_times[idx] = time.perf_counter()
                        break
                except ValueError:
                    pass
                time.sleep(0.01)
            if self.resync_times[idx] is None:
                return
            # the relist bubble: events queued behind the storm drain
            # through ingest, and the relist's replace-diff fans EVERY
            # key into the workqueues — caught up means both ran empty
            # twice in a row (a flip queued behind storm-induced
            # reconciles is storm cost, owned by the recovery gate)
            empties = 0
            while time.monotonic() < deadline:
                q = self.session.ingest.qsize() if self.session.ingest else 0
                q += len(self.plugin.throttle_ctr.workqueue)
                q += len(self.plugin.cluster_throttle_ctr.workqueue)
                empties = empties + 1 if q == 0 else 0
                if empties >= 2:
                    self.caughtup_times[idx] = time.perf_counter()
                    return
                time.sleep(0.05)

        # a dead poller leaves resync_times[idx] None, which the recovery
        # gate reports as an unrecovered restart — the death is observable
        # by construction, so no extra routing is needed
        threading.Thread(  #: thread: fire-and-forget
            target=poll, daemon=True, name=f"resync-poll-{idx}"
        ).start()

    # -- stack construction -------------------------------------------------

    def build(self) -> None:
        import sys

        # the whole topology — apiserver, replayer, daemon — shares one
        # interpreter: GIL hand-off latency (default 5ms switch interval ×
        # several CPU-bound threads) stacks across the 4-thread wire-in
        # pipeline. 1ms measurably cuts delivery lag (87→63ms p50 at the
        # 950/s saturation probe) at negligible throughput cost.
        self._prev_switch_interval = sys.getswitchinterval()
        sys.setswitchinterval(0.001)
        from ..client.mockserver import MockApiServer
        from ..client.transport import RemoteSession, RestConfig
        from ..engine.store import Store
        from ..faults.plan import FaultPlan
        from ..metrics import Registry
        from ..plugin import KubeThrottler, decode_plugin_args

        self.header, self.ops = build_trace(self.scn, self.seed)
        self.topology = build_topology(self.scn, self.seed)
        blob = serialize_trace(self.header, self.ops)
        self.trace_sha = trace_sha256(blob)
        self.trace_path = os.path.join(
            self.workdir, f"trace-{self.scn.name}-s{self.seed}.jsonl"
        )
        os.makedirs(self.workdir, exist_ok=True)
        with open(self.trace_path, "wb") as f:
            f.write(blob)

        self.plan = FaultPlan(seed=self.seed)
        compile_fault_rules(self.plan, self.scn)
        if self.regression:
            # the deliberately-broken SLO: route the regression site into a
            # per-status-PUT stall — flip publication pays it wholesale
            self.plan.rule(
                "scenario.regression.flip_stall", mode="delay", delay=0.3, times=1
            )

        server = MockApiServer(bookmark_interval=0.25)
        self.server = server
        self.remote = server.store
        _seed_remote_store(self.remote, self.scn, self.topology)
        server.faults = self.plan
        server.start()

        self.local = Store()
        self.journal = self.snapshotter = None
        if self.scn.durable:
            # the long-horizon durability hook: journal + size-triggered
            # snapshots + compaction cycles run UNDER the replayed storm
            # (journal attach must precede every other store handler so
            # nothing double-dispatches). Trigger cadence scales with the
            # trace so a multi-virtual-day run cuts several snapshots and
            # at least one compaction.
            from ..engine.journal import attach as journal_attach
            from ..engine.snapshot import SnapshotManager

            data_dir = os.path.join(
                self.workdir, f"data-{self.scn.name}-s{self.seed}"
            )
            os.makedirs(data_dir, exist_ok=True)
            every = max(len(self.ops) // 4, 500)
            self.journal = journal_attach(
                self.local,
                os.path.join(data_dir, "journal.log"),
                compact_after=every * 3,
                faults=self.plan,
            )
            self.snapshotter = SnapshotManager(
                data_dir, self.local, faults=self.plan
            )
            self.snapshotter.bind_journal(self.journal, every_lines=every)
        self.metrics_registry = self.registry if self.registry is not None else Registry()
        self.session = RemoteSession(
            RestConfig(server=server.url),
            self.local,
            metrics_registry=self.metrics_registry,
            qps=None,
            faults=self.plan,
            ingest_batch="adaptive",
        )
        self.session.start(sync_timeout=60)
        self.plugin = KubeThrottler(
            decode_plugin_args(
                {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
            ),
            self.local,
            use_device=True,
            start_workers=True,
            status_writer=self.session.status_committer,
            metrics_registry=self.metrics_registry,
            device=self.device,
        )
        # initial statuses converge before measurement (every group has
        # pods, so every throttle ends with a materialized used count)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            thrs = self.remote.list_throttles()
            if thrs and all(
                t.status.used.resource_counts is not None for t in thrs
            ):
                break
            time.sleep(0.2)
        import gc

        from ..utils.gchygiene import freeze_startup_heap

        # same pre-serving posture as the daemon; teardown restores it so
        # an embedding process (the test suite) doesn't inherit a frozen
        # heap + deferred gen2 for its remaining lifetime
        self._prev_gc_threshold = gc.get_threshold()
        freeze_startup_heap()

        # measurement anchors: the lag tracker watches the REMOTE store's
        # Throttle MODIFIEDs (status PUTs arriving back at the apiserver)
        (
            self.pending, self.flip_pending, self.pend_lock,
            self.lags, self.flip_lags, self.flip_walls, self._on_remote_status,
        ) = lag_tracker()
        self.group_keys = group_keys_of(self.remote)
        self.flip_watch, self.run_sums = flip_watch_of(self.remote)
        self.count_watch, self.run_counts = count_watch_of(self.remote)
        # throttle key → its selector's group (spec churn rewrites the
        # count watch in place, keyed by this)
        self.thr_grp = {
            t.key: t.spec.selector.selector_terms[0].pod_selector.match_labels["grp"]
            for t in self.remote.list_throttles()
        }
        self._status_write_walls: List[float] = []

        def on_status(event):
            self._status_write_walls.append(time.perf_counter())
            self._on_remote_status(event)

        self._status_handler = on_status
        self.remote.add_event_handler("Throttle", on_status, replay=False)

        if self.regression:
            fault = self.plan.check("scenario.regression.flip_stall")
            if fault is not None:
                self.plan.rule("mock.status.delay", mode="delay", delay=fault.delay)

        # fingerprint anchors (the hunt's coverage signal): reflectors join
        # the plugin's /readyz component registry, the transition log and
        # the metric-family baseline reset AFTER convergence so everything
        # recorded from here on is run behavior, not startup noise
        self.session.register_health(self.plugin.health)
        if self.journal is not None:
            self.plugin.health.register("journal", self.journal.health_state)
        if self.snapshotter is not None:
            self.snapshotter.device_manager = self.plugin.device_manager
            self.plugin.health.register("snapshot", self.snapshotter.health_state)
        self._health_sample_every_s = 0.05
        self._last_health_sample = 0.0
        self.plugin.health.reset_transitions()
        self.sample_health(force=True)
        self._metric_baseline = self.metrics_registry.family_totals()

    def sample_health(self, force: bool = False) -> None:
        """Probe every /readyz component at most every 50 ms (replayer
        tick + quiesce loop) so Health's transition log approximates a
        continuous timeline of the run."""
        now = time.perf_counter()
        if not force and now - self._last_health_sample < self._health_sample_every_s:
            return
        self._last_health_sample = now
        try:
            self.plugin.health.snapshot()
        except Exception:
            logger.debug("health sample failed", exc_info=True)

    def fingerprint(self) -> Dict:
        """The structured, machine-readable run fingerprint: fired fault
        sites with hit counts, health-component state transitions, and
        metric-family deltas vs the post-convergence baseline. This is the
        hunt's coverage signal (scenarios/hunt/coverage.py) and the raw
        material for diff_reports — consumers read THIS, not report
        prose."""
        end = self.metrics_registry.family_totals()
        base = getattr(self, "_metric_baseline", {})
        families: Dict[str, Dict] = {}
        for name, (series, total) in sorted(end.items()):
            before = base.get(name)
            if before is None or before != (series, total):
                families[name] = {
                    "series": series,
                    "delta": round(total - (before[1] if before else 0.0), 6),
                }
        return {
            "fault_sites": {
                site: len(firings) for site, firings in self.plan.snapshot().items()
            },
            "health_transitions": [
                list(t) for t in self.plugin.health.transitions()
            ],
            "metric_families": families,
        }

    # -- quiesce + oracles --------------------------------------------------

    def quiesce(self, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.sample_health()
            if self.session.ingest is not None:
                self.session.ingest.flush(timeout=5.0)
            target_rv = self.remote.latest_resource_version
            refl_ok = all(
                int(r.last_resource_version or 0) >= target_rv
                for r in self.session.reflectors.values()
            )
            wq_empty = (
                len(self.plugin.throttle_ctr.workqueue) == 0
                and len(self.plugin.cluster_throttle_ctr.workqueue) == 0
            )
            if refl_ok and wq_empty:
                self.session.status_committer.flush(timeout=5.0)
                if (
                    self.remote.latest_resource_version == target_rv
                    and len(self.plugin.throttle_ctr.workqueue) == 0
                    and len(self.plugin.cluster_throttle_ctr.workqueue) == 0
                ):
                    return True
            time.sleep(0.05)
        return False

    def verdict_sweep(self) -> Dict:
        serving = self.plugin.pre_filter_batch()
        sv = serving["schedulable"]
        oracle = _oracle_store(self.remote)
        oracle_plugin = None
        try:
            from ..plugin import KubeThrottler, decode_plugin_args

            oracle_plugin = KubeThrottler(
                decode_plugin_args(
                    {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
                ),
                oracle,
                use_device=True,
                start_workers=False,
                device=self.device,
            )
            ov = oracle_plugin.pre_filter_batch()["schedulable"]
            wrong = [k for k in ov if bool(sv.get(k)) is not bool(ov[k])]
            wrong += [k for k in sv if k not in ov]
            # seeded per-pod host-oracle spot check: independent of device
            # planes AND of pre_filter_batch on either side
            rng = random.Random(f"{self.scn.name}/{self.seed}/spot")
            pods = sorted(oracle.list_pods(), key=lambda p: p.key)
            sample = (
                pods
                if len(pods) <= _SPOT_CHECK_SAMPLE
                else [pods[rng.randrange(len(pods))] for _ in range(_SPOT_CHECK_SAMPLE)]
            )
            spot_wrong = host_spot_check(sv, oracle, sample)
            wrong = sorted(set(wrong) | set(spot_wrong))
            return {
                "wrong_verdicts": len(wrong),
                "wrong_examples": wrong[:10],
                "verdicts_checked": len(ov),
                "spot_checked": len(sample),
            }
        finally:
            if oracle_plugin is not None:
                oracle_plugin.stop()

    def leader_kill_episode(self) -> Optional[Dict]:
        fault = self.plan.check("scenario.leader.kill")
        if fault is None:
            return None
        import importlib.util

        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        hatest_path = os.path.join(root, "tools", "hatest_torch.py")
        if not os.path.exists(hatest_path):  # installed without the tools/ tree
            return {"skipped": "tools/hatest_torch.py not present"}
        import sys

        if root not in sys.path:
            sys.path.insert(0, root)
        spec = importlib.util.spec_from_file_location("kt_scenario_hatest", hatest_path)
        hatest = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(hatest)
        ha_dir = os.path.join(self.workdir, f"ha-{self.scn.name}-s{self.seed}")
        os.makedirs(ha_dir, exist_ok=True)
        window = self.scn.slo.failover_window_s or 10.0
        try:
            report = hatest.run_ha_cycle(
                "ha.status.commit", self.seed, ha_dir, events=60, window_s=window
            )
            return {"window_s": report["window_s"], "epoch": report["epoch"]}
        except AssertionError as e:
            return {"failed": str(e)}

    def teardown(self) -> None:
        import gc
        import sys

        try:
            sys.setswitchinterval(self._prev_switch_interval)
        except Exception:
            pass
        try:
            if getattr(self, "_prev_gc_threshold", None) is not None:
                gc.set_threshold(*self._prev_gc_threshold)
                gc.unfreeze()
        except Exception:
            pass
        for step in (
            lambda: self.remote.remove_event_handler("Throttle", self._status_handler),
            lambda: self.plugin.stop(),
            lambda: self.session.stop(),
            lambda: self.server.stop(),
            lambda: self.journal.close() if self.journal is not None else None,
        ):
            try:
                step()
            except Exception:
                logger.debug("scenario teardown step failed", exc_info=True)


def _nominal_ops(scn: Scenario, n_ops: int) -> float:
    """Trace's nominal average rate: its own op count over its duration —
    the pace the replayer is judged against."""
    return n_ops / max(scn.duration_s, 1e-9)


def run_scenario(
    scn: Scenario,
    seed: int,
    workdir: str,
    regression: Optional[str] = None,
    registry=None,
    keep_stack: bool = False,
    device=None,
) -> Dict:
    """One full build → replay → quiesce → oracle → gates cycle. Returns
    the report dict (also written to ``<workdir>/report-<name>-s<seed>.json``).
    ``device=None`` means CUDA and raises ``RuntimeError`` without it."""
    import numpy as np

    eng = _Engine(scn, seed, workdir, regression=regression, registry=registry,
                  device=device)
    eng.build()
    try:
        replay = _Replayer(eng).run()
        converged = eng.quiesce()
        time.sleep(0.2)
        # let the resync pollers record the caught-up instants the quiesce
        # flush just made observable
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and any(
            s is not None and c is None
            for s, c in zip(eng.resync_times, eng.caughtup_times)
        ):
            time.sleep(0.05)

        lag_arr = np.asarray(eng.lags) if eng.lags else np.asarray([0.0])
        # partition flip samples: a sample whose [anchor, publication]
        # interval overlaps an apiserver outage window (restart → every
        # reflector resynced past the reset RV floor) could not have
        # published sooner no matter how healthy the pipeline — the
        # RECOVERY gate bounds that window; the flip gate judges steady
        # state. With no restarts every sample is steady.
        outages = []
        for t_r, t_s, t_c in zip(
            eng.restart_times, eng.resync_times, eng.caughtup_times
        ):
            end = t_c if t_c is not None else t_s
            outages.append((t_r, end if end is not None else float("inf")))

        def outage_affected(pub_wall: float, lag: float) -> bool:
            anchor = pub_wall - lag
            return any(anchor < end and pub_wall > start for start, end in outages)

        steady_flips: List[float] = []
        outage_flips: List[float] = []
        for lag, wall in zip(eng.flip_lags, eng.flip_walls):
            (outage_flips if outage_affected(wall, lag) else steady_flips).append(lag)
        flip_arr = np.asarray(steady_flips) if steady_flips else np.asarray([0.0])
        measurements: Dict = {
            "ops_fired": replay["ops_fired"],
            "ops_applied": replay["ops_applied"],
            "fire_window_s": round(replay["fire_window_s"], 3),
            "events_per_sec": replay["ops_applied"] / max(replay["fire_window_s"], 1e-9),
            "pace_frac": (
                (replay["ops_fired"] / max(replay["fire_window_s"], 1e-9))
                / max(_nominal_ops(scn, replay["ops_fired"]), 1e-9)
            ),
            "applied_frac": replay["ops_applied"] / max(replay["ops_fired"], 1),
            "converged": converged,
            "lag_p50_ms": float(np.percentile(lag_arr, 50)) * 1e3,
            "lag_p99_ms": float(np.percentile(lag_arr, 99)) * 1e3,
            "status_writes": len(eng.lags),
            "flip_lag_p50_ms": float(np.percentile(flip_arr, 50)) * 1e3,
            "flip_lag_p99_ms": float(np.percentile(flip_arr, 99)) * 1e3,
            "flip_samples": len(steady_flips),
            "flip_outage_samples": len(outage_flips),
            "flip_outage_max_ms": (
                max(outage_flips) * 1e3 if outage_flips else 0.0
            ),
            "flip_crossings": replay["crossings"],
            "restarts": len(eng.restart_times),
        }
        if eng.session.ingest is not None:
            st = eng.session.ingest.stats()
            measurements["ingest_dropped"] = st["dropped"]
            measurements["ingest_batches"] = st["batches"]
            measurements["ingest_max_batch"] = st["max_batch_seen"]
        commit_counter = eng.metrics_registry.counter_vec(
            "kube_throttler_remote_status_commit_total", "", ["kind", "result"]
        )
        measurements["commit_counts"] = {
            f"{k}:{r}": int(v) for (k, r), v in commit_counter.collect().items()
        }
        if eng.restart_times:
            # recovery covers the WHOLE bubble: reflectors resynced past
            # the reset RV floor, the wire backlog digested, and — when
            # anything was left to publish — the first post-resync status
            # write. A pipeline whose backlog fully published BEFORE the
            # resync finished is healthy-idle, not unrecovered.
            recoveries = []
            for t_r, t_sync, t_caught in zip(
                eng.restart_times, eng.resync_times, eng.caughtup_times
            ):
                if t_sync is None:
                    recoveries.append(None)  # reflectors never resynced
                    continue
                rec = (t_caught if t_caught is not None else t_sync) - t_r
                post = [w for w in eng._status_write_walls if w > t_sync]
                if post:
                    rec = max(rec, post[0] - t_r)
                recoveries.append(rec)
            worst = None
            if all(r is not None for r in recoveries):
                worst = max(recoveries)
            measurements["recovery_s"] = worst
        measurements.update(eng.verdict_sweep())
        ha = eng.leader_kill_episode()
        if ha is not None:
            measurements["leader_kill"] = ha
            measurements["failover_window_s"] = ha.get("window_s")

        gates = evaluate_gates(scn, measurements)
        eng.sample_health(force=True)  # final probe before the fingerprint
        report = {
            "scenario": scn.name,
            "seed": seed,
            "regression": regression,
            "trace_path": eng.trace_path,
            "trace_sha256": eng.trace_sha,
            "fault_plan_sha256": eng.header.get("fault_plan_sha256"),
            "all_pass": all(g["pass"] for g in gates.values()),
            "gates": gates,
            "measurements": measurements,
            "fault_history": eng.plan.snapshot(),
            "fingerprint": eng.fingerprint(),
        }
        _record_metrics(eng.metrics_registry, scn, report)
        path = os.path.join(workdir, f"report-{scn.name}-s{seed}.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=2, default=str)
        report["report_path"] = path
        return report
    finally:
        if not keep_stack:
            eng.teardown()


def _record_metrics(registry, scn: Scenario, report: Dict) -> None:
    """Export the run's outcome as kube_throttler_scenario_* families on
    the stack's registry (METRIC_NAMES — the same names a long-running
    scenario soak would alert on)."""
    from ..metrics import register_scenario_metrics

    fams = register_scenario_metrics(registry)
    m = report["measurements"]
    fams["ops"].inc({"scenario": scn.name}, float(m["ops_applied"]))
    for site, firings in report["fault_history"].items():
        fams["faults"].inc({"scenario": scn.name, "site": site}, float(len(firings)))
    for gate, g in report["gates"].items():
        fams["gate"].set({"scenario": scn.name, "gate": gate}, 1.0 if g["pass"] else 0.0)
    if m.get("flip_samples", 0) > 0:
        fams["flip_p99"].set(
            {"scenario": scn.name}, m["flip_lag_p99_ms"] / 1e3
        )
    if m.get("recovery_s") is not None:
        fams["recovery"].set({"scenario": scn.name}, float(m["recovery_s"]))
