"""KubeThrottler plugin: the admission front-end (reference plugin.go).

PreFilter gates pods on both controllers' check results with the reference's
exact result statuses, reason-string formats, and Warning-event emission
(plugin.go:148-215); Reserve/Unreserve book-keep scheduler-cycle
reservations (217-257); EventsToRegister mirrors the requeue hints (263-279).

The device is explicit: ``device=None`` means CUDA (raising without it);
pass ``device="cpu"`` to run the device data plane on the CPU. With
``use_device=False`` no device is resolved or touched: the host oracle
answers every call, as ``serve --no-device`` asks.
"""

from __future__ import annotations

import logging
import os
from itertools import compress
from typing import List, Optional, Sequence

import torch

from .. import resolve_device
from ..api.pod import Pod
from ..api.types import cluster_throttle_names, throttle_names
from ..client import Clientset, InformerBundle, Listers, SharedInformerFactory
from ..controllers import ClusterThrottleController, ThrottleController
from ..engine.devicestate import DeviceStateManager
from ..engine.store import Store
from ..health import Health
from ..ops.check_dense import KernelLaunchError
from ..metrics import (
    ClusterThrottleMetricsRecorder,
    Registry,
    StatusLagMetrics,
    ThrottleMetricsRecorder,
    register_breaker_metrics,
    register_gc_metrics,
    register_kernel_metrics,
    register_watch_metrics,
)
from ..parallel.mesh import make_mesh
from ..utils.tracing import PhaseTracer, vlog
from ..utils.clock import Clock, RealClock
from .args import KubeThrottlerPluginArgs
from .framework import ClusterEvent, EventRecorder, Status, StatusCode

logger = logging.getLogger(__name__)

PLUGIN_NAME = "kube-throttler"

from ..api.serialization import API_GROUP as SCHEME_GROUP  # noqa: E402
from ..api.serialization import VERSION as SCHEME_VERSION  # noqa: E402


class KubeThrottler:
    """Implements PreFilter / Reserve / Unreserve / EventsToRegister."""

    def __init__(
        self,
        args: KubeThrottlerPluginArgs,
        store: Store,
        clock: Optional[Clock] = None,
        event_recorder: Optional[EventRecorder] = None,
        use_device: bool = True,
        start_workers: bool = False,
        metrics_registry=None,
        status_writer=None,
        device=None,
    ):
        clock = clock or RealClock()
        self.args = args
        self.store = store
        self.event_recorder = event_recorder
        self.metrics_registry = metrics_registry or Registry()
        self.tracer = PhaseTracer(self.metrics_registry)
        register_gc_metrics(self.metrics_registry)
        self.dedupe_outcomes = self.metrics_registry.counter_vec(
            "kube_throttler_batch_dedupe_total",
            "pre_filter_batch dedupe probe calls by outcome (served, "
            "declined_size, declined_mix)",
            ["outcome"],
        )
        self.batch_blocked_pods = self.metrics_registry.counter_vec(
            "kube_throttler_batch_blocked_pods_total",
            "pods a throttle kind's batch verdicts block, summed over batch "
            "merges (pre_filter_batch, full_tick_sharded)",
            ["kind"],
        )
        # ORDER MATTERS: the device mirror registers its store handlers
        # FIRST so its rows/masks update before the informer fan-out reaches
        # the controllers' enqueues — a worker draining the key immediately
        # then reconciles against device state >= the event.
        self.device_manager = (
            DeviceStateManager(
                store,
                args.name,
                args.target_scheduler_name,
                device=resolve_device(device),
                metrics_registry=self.metrics_registry,
            )
            if use_device
            else None
        )
        # Generated-machinery analog, wired for real (plugin.go:71-130):
        # a typed clientset over the cache, the schedule-group informer
        # factory plus the separate core factory (whose pod informer carries
        # the namespace indexer, plugin.go:81-84), and indexer-backed listers
        # that every controller read goes through. Informer-level resync is
        # disabled: the controllers' resync_interval
        # (reconcileTemporaryThresholdInterval) is the periodic backstop.
        self.clientset = Clientset(store)
        self.informer_factory = SharedInformerFactory(store, resync_period=0.0)
        self.core_informer_factory = SharedInformerFactory(store, resync_period=0.0)
        self.informers = InformerBundle(self.informer_factory, self.core_informer_factory)
        self.listers = Listers.from_factories(
            self.informer_factory, self.core_informer_factory
        )
        self.informer_factory.start()
        self.core_informer_factory.start()
        if not (
            self.informer_factory.wait_for_cache_sync()
            and self.core_informer_factory.wait_for_cache_sync()
        ):  # pragma: no cover — the store mirror syncs synchronously
            raise RuntimeError("informer caches failed to sync")
        self.throttle_ctr = ThrottleController(
            throttler_name=args.name,
            target_scheduler_name=args.target_scheduler_name,
            store=store,
            clock=clock,
            threadiness=args.controller_threadiness,
            num_key_mutex=args.num_key_mutex,
            device_manager=self.device_manager,
            metrics_recorder=ThrottleMetricsRecorder(self.metrics_registry),
            resync_interval=args.reconcile_temporary_threshold_interval,
            listers=self.listers,
            informers=self.informers,
            status_writer=status_writer,
            reservation_ttl=args.reservation_ttl,
        )
        self.cluster_throttle_ctr = ClusterThrottleController(
            throttler_name=args.name,
            target_scheduler_name=args.target_scheduler_name,
            store=store,
            clock=clock,
            threadiness=args.controller_threadiness,
            num_key_mutex=args.num_key_mutex,
            device_manager=self.device_manager,
            metrics_recorder=ClusterThrottleMetricsRecorder(self.metrics_registry),
            resync_interval=args.reconcile_temporary_threshold_interval,
            listers=self.listers,
            informers=self.informers,
            status_writer=status_writer,
            reservation_ttl=args.reservation_ttl,
        )
        if self.device_manager is not None:
            self.device_manager.tracer = self.tracer
            register_breaker_metrics(self.metrics_registry, self.device_manager)
            register_kernel_metrics(self.metrics_registry)
            # reservation replay onto freshly allocated device columns
            # (throttle re-creation / throttlerName handover) reads these
            self.device_manager.reservation_sources = {
                "throttle": self.throttle_ctr.cache,
                "clusterthrottle": self.cluster_throttle_ctr.cache,
            }
            # micro-batched ingest: each batch's single flip-candidate pass
            # promotes stale-flag keys straight into the priority lanes
            # (one add_all_priority per kind per batch — devicestate
            # _promote_ingest_flips)
            # promotion order is policy-weighted (flip_priorities reads
            # the controller's flip_priority_fn, wired below once the
            # policy engine exists): valued accel classes' flips drain
            # ahead of their hi-lane peers
            self.device_manager.install_flip_promoters(
                {
                    "throttle": (
                        lambda keys, _c=self.throttle_ctr: _c.workqueue.add_all_priority(
                            keys, priorities=_c.flip_priorities(keys)
                        )
                    ),
                    "clusterthrottle": (
                        lambda keys, _c=self.cluster_throttle_ctr: _c.workqueue.add_all_priority(
                            keys, priorities=_c.flip_priorities(keys)
                        )
                    ),
                }
            )
        self.throttle_ctr.tracer = self.tracer
        self.cluster_throttle_ctr.tracer = self.tracer
        # gang (pod-group) admission ledger (engine/gang.py): all-or-
        # nothing reserve/rollback over BOTH kinds' reservation caches.
        # The device mirror learns of member reservations through the same
        # on_reservation_change hook the per-pod paths use; the journal is
        # late-bound by the CLI (standalone mode) for GANG audit stamps.
        from ..engine.gang import GangLedger

        dm = self.device_manager
        self.gang = GangLedger(
            caches={
                "throttle": self.throttle_ctr.cache,
                "clusterthrottle": self.cluster_throttle_ctr.cache,
            },
            clock=clock,
            on_change=(
                (
                    lambda kind, key: dm.on_reservation_change(
                        kind,
                        key,
                        self.throttle_ctr.cache
                        if kind == "throttle"
                        else self.cluster_throttle_ctr.cache,
                    )
                )
                if dm is not None
                else None
            ),
            default_ttl=(args.gang_reservation_ttl or args.reservation_ttl),
        )
        self.throttle_ctr.gang_ledger = self.gang
        self.cluster_throttle_ctr.gang_ledger = self.gang
        # member lifecycle: bound members admit, deleted pre-admission
        # members roll the whole group back (store → gang lock order)
        store.add_event_handler("Pod", self.gang.on_pod_event, replay=False)
        # policy engine + preemption coordinator (policy/, docs/policy.md):
        # policy-as-data value weights drive victim selection and the flip
        # promotion priorities below; the coordinator owns the journaled,
        # gang-atomic eviction cycle the scheduler triggers when a high-
        # priority group is capacity-rejected. The journal is late-bound
        # by the CLI like the gang ledger's.
        from ..policy.preempt import PreemptionCoordinator
        from ..policy.spec import PolicyEngine

        self.policy = PolicyEngine(specs=args.policy_specs, clock=clock)
        self.preempt = PreemptionCoordinator(
            policy=self.policy,
            kind_controllers=(
                ("throttle", self.throttle_ctr),
                ("clusterthrottle", self.cluster_throttle_ctr),
            ),
            store=store,
            gang_ledger=self.gang,
            device_manager=self.device_manager,
        )
        # admission ages + evicted-then-readmitted churn (both gated on
        # the active policy enabling preemption — zero per-pod state kept
        # otherwise, the columnar-store memory posture)
        store.add_event_handler("Pod", self.preempt.on_pod_event, replay=False)
        # the controllers' flip promotion order consumes the policy
        # weights: a throttle declaring accel classes the policy values
        # above default promotes ahead of its hi-lane peers (workqueue
        # (-priority, seq) ordering)
        self.throttle_ctr.flip_priority_fn = self._policy_flip_priority(
            self.throttle_ctr
        )
        self.cluster_throttle_ctr.flip_priority_fn = self._policy_flip_priority(
            self.cluster_throttle_ctr
        )
        from ..metrics import register_gang_metrics, register_preempt_metrics

        self._gang_check_hist = register_gang_metrics(self.metrics_registry, self.gang)
        self.preempt.select_hist = register_preempt_metrics(
            self.metrics_registry, self.preempt
        )
        # local-path flip/total status-lag histograms; a lane-aware remote
        # writer (AsyncStatusCommitter) observes the "remote" path itself
        lag_metrics = StatusLagMetrics(self.metrics_registry, "local")
        self.throttle_ctr.lag_metrics = lag_metrics
        self.cluster_throttle_ctr.lag_metrics = lag_metrics
        register_watch_metrics(self.metrics_registry)
        # /readyz component registry (health.py): the daemon surface serves
        # its snapshot; the CLI adds journal/reflector components when they
        # exist (standalone vs remote mode)
        self.health = Health()
        if self.device_manager is not None:
            self.health.register("device", self._device_health)
        self.health.register("workqueues", self._workqueue_health)
        self._coalescer = None
        # interned-verdict cache (engine/verdictcache.py): pre_filter /
        # pre_filter_batch probe it before any plane walk. Requires the
        # device manager — the fingerprint reads its epoch planes.
        # KT_VERDICT_CACHE=0 disables; KT_VERDICT_CACHE_SIZE bounds it.
        self.verdict_cache = None
        if (
            self.device_manager is not None
            and os.environ.get("KT_VERDICT_CACHE", "1") != "0"
        ):
            from ..engine.verdictcache import VerdictCache

            try:
                capacity = int(os.environ.get("KT_VERDICT_CACHE_SIZE", "65536"))
            except ValueError:
                capacity = 65536  # malformed override must not kill serving
            self.verdict_cache = VerdictCache(capacity=capacity)
        # verdict-coherence assassin (utils/epochassert.py): when armed,
        # sampled cache hits are shadow-recomputed through the uncached
        # oracle route — a divergence at an unchanged epoch sum proves a
        # missed bump and raises StaleVerdict at first observation
        from ..utils import epochassert as _epochassert

        self._epoch_assert = _epochassert.enabled()
        if start_workers:
            self.throttle_ctr.start()
            self.cluster_throttle_ctr.start()

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    # ------------------------------------------------------------- health

    def _device_health(self):
        # an open/half-open breaker is DEGRADED, not down: the host oracle
        # serves every admission surface, at worse latency
        state = self.device_manager.breaker_state()
        return ("ok" if state == "closed" else "degraded"), {"breaker": state}

    # a workqueue this deep means reconciles are falling behind events by
    # minutes — still serving (degraded), but an operator should look
    WORKQUEUE_DEGRADED_DEPTH = 10_000

    def _workqueue_health(self):
        depths = {
            "throttle": len(self.throttle_ctr.workqueue),
            "clusterthrottle": len(self.cluster_throttle_ctr.workqueue),
        }
        state = (
            "degraded"
            if max(depths.values()) >= self.WORKQUEUE_DEGRADED_DEPTH
            else "ok"
        )
        return state, depths

    def coalescer(self, window_s: float = 0.0, max_batch: int = 64):
        """The micro-batching pre_filter front-end for CONCURRENT callers:
        one fused device dispatch per window instead of one per caller
        (plugin/coalesce.py). First call constructs it; parameters are
        fixed thereafter."""
        if self._coalescer is None:
            from .coalesce import PreFilterCoalescer

            self._coalescer = PreFilterCoalescer(self, window_s, max_batch)
        return self._coalescer

    # -------------------------------------------------------------- prefilter

    def pre_filter(self, pod: Pod) -> Status:
        with self.tracer.trace("prefilter"):
            return self._pre_filter(pod)

    def _pre_filter(self, pod: Pod) -> Status:
        cache = self.verdict_cache
        if cache is None:
            return self._pre_filter_uncached(pod)
        fp = self.device_manager.verdict_fingerprint(pod)
        if fp is None:  # no arena / unknown namespace — uncacheable
            return self._pre_filter_uncached(pod)
        key, esum = fp
        hit = cache.get(key, esum)
        if hit is not None:
            if self._epoch_assert:
                from ..utils import epochassert

                if epochassert.should_check():
                    epochassert.check_hit(self, pod, key, esum, hit)
            return hit
        status = self._pre_filter_uncached(pod)
        if self._cacheable(status):
            # validate-after-compute: re-read the fingerprint and insert
            # only if no covered mutation landed while we computed — a
            # racing flip/reservation then suppresses the insert instead
            # of poisoning the cache (see engine/verdictcache.py)
            if self.device_manager.verdict_fingerprint(pod) == fp:
                cache.put(key, esum, status)
        return status

    def _pre_filter_uncached(self, pod: Pod, emit_events: bool = True) -> Status:
        try:
            thr4 = self.throttle_ctr.check_throttled(pod, False)
        except Exception as e:
            return Status(StatusCode.ERROR, (str(e),))

        try:
            clthr4 = self.cluster_throttle_ctr.check_throttled(pod, False)
        except Exception as e:
            return Status(StatusCode.ERROR, (str(e),))

        return self._compose_prefilter_status(pod, thr4, clthr4, emit_events)

    @staticmethod
    def _cacheable(status: Status) -> bool:
        """ERROR statuses carry transient causes; exceeds statuses emit a
        Warning event per PreFilter call (plugin.go:191-201) — a cache hit
        would swallow the emission. Neither may be interned."""
        return status.code is not StatusCode.ERROR and not any(
            "[pod-requests-exceeds-threshold]" in r for r in status.reasons
        )

    def _compose_prefilter_status(
        self, pod: Pod, thr4, clthr4, emit_events: bool = True
    ) -> Status:
        """Reason composition from both kinds' check_throttled 4-tuples —
        ordering mirrors plugin.go:182-214 exactly. Shared by the direct
        path and the micro-batching coalescer (which produces the tuples
        from one fused dispatch)."""
        thr_active, thr_insufficient, thr_exceeds, thr_affected = thr4
        clthr_active, clthr_insufficient, clthr_exceeds, clthr_affected = clthr4

        if (
            len(thr_active) + len(thr_insufficient) + len(thr_exceeds)
            + len(clthr_active) + len(clthr_insufficient) + len(clthr_exceeds)
            == 0
        ):
            vlog(5, "pod %s is not throttled by any throttle/clusterthrottle", pod.key)
            return Status(StatusCode.SUCCESS)

        # reason ordering mirrors plugin.go:182-214 exactly
        reasons: List[str] = []
        if clthr_exceeds:
            reasons.append(
                f"clusterthrottle[pod-requests-exceeds-threshold]={','.join(cluster_throttle_names(clthr_exceeds))}"
            )
        if thr_exceeds:
            reasons.append(
                f"throttle[pod-requests-exceeds-threshold]={','.join(throttle_names(thr_exceeds))}"
            )
        if (clthr_exceeds or thr_exceeds) and emit_events and self.event_recorder is not None:
            names = cluster_throttle_names(clthr_exceeds) + throttle_names(thr_exceeds)
            self.event_recorder.eventf(
                pod.key,
                "Warning",
                "ResourceRequestsExceedsThrottleThreshold",
                self.name,
                "It won't be scheduled unless decreasing resource requests or "
                "increasing ClusterThrottle/Throttle threshold because its "
                f"resource requests exceeds their thresholds: {','.join(names)}",
            )
        if clthr_active:
            reasons.append(f"clusterthrottle[active]={','.join(cluster_throttle_names(clthr_active))}")
        if thr_active:
            reasons.append(f"throttle[active]={','.join(throttle_names(thr_active))}")
        if clthr_insufficient:
            reasons.append(
                f"clusterthrottle[insufficient]={','.join(cluster_throttle_names(clthr_insufficient))}"
            )
        if thr_insufficient:
            reasons.append(f"throttle[insufficient]={','.join(throttle_names(thr_insufficient))}")
        # plugin.go:157-style V(2) visibility into every rejection
        vlog(2, "pod %s is unschedulable: %s", pod.key, "; ".join(reasons))
        return Status(StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE, tuple(reasons))

    def pre_filter_batch(self) -> dict:
        """Bulk admission triage: ONE device pass classifies every stored pod
        against both kinds' full throttle state (no per-pod loop — the
        100k×10k check matrix the reference evaluates pod-by-pod in Go runs
        as two batched kernels here). Without a device manager, falls back to
        the per-pod host oracle.

        Returns ``{"schedulable": {pod_key: bool}, "errors": [pod_key, ...]}``;
        schedulable mirrors PreFilter's gate (no active/insufficient/exceeds
        throttle of either kind, plugin.go:177-180). Pods whose Namespace
        object is missing land in ``errors`` — the per-pod path returns an
        ERROR status for them (clusterthrottle_controller.go:273-276), so the
        batch must not report them schedulable. Per-pod reasons stay on
        ``pre_filter``.
        """
        with self.tracer.trace("prefilter_batch"):
            known_ns = {ns.name for ns in self.listers.namespaces.list()}
            schedulable: dict = {}
            errors: list = []
            dm = self.device_manager
            if dm is not None and self.verdict_cache is not None:
                # intra-batch dedupe: the degenerate mix collapses to a few
                # hundred (shape, accel, cols) groups — one representative
                # eval per group replaces the O(P) classification AND warms
                # the verdict cache for the single-pod serving path in one
                # pass. Returns None when the mix is NOT degenerate enough
                # (or too large to fingerprint) — the fused device kernel
                # is the better batch engine there.
                with self.tracer.trace("batch_dedupe"):
                    deduped = self._pre_filter_batch_dedupe(known_ns)
                if deduped is not None:
                    return deduped
            if dm is not None:
                # one coherent device snapshot for BOTH kinds (a single
                # lock hold inside check_batch_all) — the composed verdict
                # matches one point in the event stream. On breaker-open/
                # failure, batch calls serve from the host oracle below.
                # Sub-phases traced for the bench's dispatch/merge
                # breakdown. CUDA launches are async, so batch_dispatch
                # synchronizes the device — otherwise the kernel time would
                # surface inside batch_merge's first read-back and the
                # split would point at the wrong phase.
                with self.tracer.trace("batch_dispatch"):
                    batches = dm.guarded("batch", dm.check_batch_all, False)
                    if batches is not None and dm.device.type == "cuda":
                        torch.cuda.synchronize(dm.device)
                if batches is not None:
                    with self.tracer.trace("batch_merge"):
                        per_kind = {
                            kind: (ok.cpu().numpy(), rows)
                            for kind, (_, ok, rows) in batches.items()
                        }
                        schedulable, errors = self._merge_verdicts(per_kind, known_ns)
                        self._apply_accel_class_overrides(schedulable, errors)
                    return {"schedulable": schedulable, "errors": errors}

            # host oracle, side-effect-free (no Warning events — triage
            # only, matching the device path)
            for pod in self._list_pods():
                ok = self._host_verdict(pod)
                if ok is None:
                    errors.append(pod.key)
                else:
                    schedulable[pod.key] = ok
            return {"schedulable": schedulable, "errors": errors}

    def _host_verdict(self, pod: Pod) -> Optional[bool]:
        """One pod's batch-triage verdict from the host oracle, side-effect
        free (no Warning events): True when no throttle of either kind is
        active, insufficient or exceeded for it, None when either
        controller raises (the pod belongs in ``errors``)."""
        try:
            ta, ti, te, _ = self.throttle_ctr.check_throttled(pod, False)
            ca, ci, ce, _ = self.cluster_throttle_ctr.check_throttled(pod, False)
        except Exception:
            return None
        return not any((ta, ti, te, ca, ci, ce))

    def _list_pods(self) -> list:
        """Every pod of the informer's cache, each materialised from the
        store, traced as ``list_pods``: the listing of the dedupe probe
        below its size gate, of the host oracle and of the accel-class
        patch."""
        with self.tracer.trace("list_pods"):
            return self.listers.pods.list()

    # dedupe is only attempted at or below this pod count: fingerprinting
    # is O(P) host work, and past this scale the fused device kernel wins
    # even against a perfectly degenerate mix. The gate reads the pod
    # informer's count before anything is listed, so a declined call
    # materialises no pod
    BATCH_DEDUPE_MAX_PODS = 50_000

    def _pre_filter_batch_dedupe(self, known_ns: set) -> Optional[dict]:
        """Grouped batch triage: pods sharing a verdict fingerprint —
        (request-shape id, accel class, matched-cols of both kinds) — get
        ONE side-effect-free representative evaluation (the verdict is a
        pure function of the fingerprint, the same argument the cache
        rests on), cache-probed first and inserted after under the
        validate-after-compute protocol. Returns None to decline (caller
        falls through to the fused device path): mix not degenerate
        enough, or too many pods to fingerprint host-side.

        Semantics mirror the host-oracle fallback exactly: side-effect-free
        (no Warning events), unknown-namespace pods land in ``errors``,
        ERROR evaluations route every group member to ``errors``."""
        dm, cache = self.device_manager, self.verdict_cache
        if self.listers.pods.count() > self.BATCH_DEDUPE_MAX_PODS:
            self.dedupe_outcomes.inc({"outcome": "declined_size"})
            return None
        pods = self._list_pods()
        if len(pods) > self.BATCH_DEDUPE_MAX_PODS:
            # pods added between the count and the listing
            self.dedupe_outcomes.inc({"outcome": "declined_size"})
            return None
        groups: dict = {}
        loners: list = []
        for pod in pods:
            fp = dm.verdict_fingerprint(pod)
            if fp is None:
                loners.append(pod)
                continue
            g = groups.get(fp[0])
            if g is None:
                groups[fp[0]] = g = (fp[1], [])
            g[1].append(pod)
        if len(pods) > 256 and len(groups) * 2 > len(pods):
            self.dedupe_outcomes.inc({"outcome": "declined_mix"})
            return None  # not degenerate — grouping bought nothing
        schedulable: dict = {}
        errors: list = []
        for key, (esum, members) in groups.items():
            status = cache.get(key, esum)
            if status is None:
                rep = members[0]
                status = self._pre_filter_uncached(rep, emit_events=False)
                if self._cacheable(status) and dm.verdict_fingerprint(rep) == (
                    key,
                    esum,
                ):
                    cache.put(key, esum, status)
            if status.code is StatusCode.ERROR:
                errors.extend(p.key for p in members)
            else:
                ok = status.code is StatusCode.SUCCESS
                for p in members:
                    schedulable[p.key] = ok
        for pod in loners:
            # no fingerprint ⇒ no arena (shouldn't happen here — the route
            # requires a device manager) or unknown namespace; mirror the
            # key-derived routing of _merge_verdicts
            ok = self._host_verdict(pod) if pod.namespace in known_ns else None
            if ok is None:
                errors.append(pod.key)
            else:
                schedulable[pod.key] = ok
        self.dedupe_outcomes.inc({"outcome": "served"})
        return {"schedulable": schedulable, "errors": errors}

    def _merge_verdicts(self, per_kind: dict, known_ns: set):
        """AND the per-kind schedulable verdicts per pod, then route pods of
        unknown namespaces to errors (the per-pod path returns ERROR for
        them, clusterthrottle_controller.go:273-276 — the batch surfaces
        must never report them schedulable). Shared by pre_filter_batch and
        full_tick_sharded so the two surfaces cannot drift. ``per_kind``
        maps kind → (schedulable bool[P] host array, the index's
        ``PodRowTable``).

        The namespace routing stays key-derived (a key's ``namespace/``
        prefix): deriving it from the pod informer's namespace index
        instead would make the never-schedulable invariant
        timing-dependent — a pod the device mirror has seen but the pod
        informer has not yet indexed would slip through.

        Every kind's table holds the same key tuple: the device mirror
        applies each pod event to both kinds' indexes in one order under
        one lock, and both surfaces take both tables under one hold. Each
        kind's ``ok`` is gathered through its own row array
        (``merge_{kind}``: the gather, the AND and the blocked count, added
        to ``kube_throttler_batch_blocked_pods_total{kind}``), then the
        table's namespace codes select the pods of known namespaces
        (``merge_ns_route``: a mask over the table's namespace names, and
        the result and error builds). With every namespace known, the
        result is the table's keys filled with the verdict most pods
        share, then the other verdict written for the rest: a copy and at
        most P/2 stores, against hashing every key into a new dict. Every
        call builds a fresh result dict and error list; the tables carry
        keys, rows and namespaces only, never a verdict."""
        import numpy as np

        tables = [rows for _, rows in per_kind.values()]
        if any(t.pod_keys != tables[0].pod_keys for t in tables[1:]):
            raise RuntimeError(
                "batch merge: the kinds' pod-row tables hold different pod keys"
            )
        combined = table = None
        for kind, (ok, rows) in per_kind.items():
            with self.tracer.trace(f"merge_{kind}"):
                vals = ok[rows.rows]
                self.batch_blocked_pods.inc(
                    {"kind": kind}, vals.size - int(np.count_nonzero(vals))
                )
                if combined is None:
                    combined, table = vals, rows
                else:
                    combined &= vals
        with self.tracer.trace("merge_ns_route"):
            names = table.ns_names
            known = np.fromiter((n in known_ns for n in names), dtype=bool, count=len(names))
            keep = known[table.ns_codes]
            if keep.all():
                most = 2 * int(np.count_nonzero(combined)) >= combined.size
                schedulable = table.filled(most)
                keys, rest = table.pod_keys, not most
                for i in np.flatnonzero(combined != most).tolist():
                    schedulable[keys[i]] = rest
                return schedulable, []
            keep_list = keep.tolist()
            schedulable = dict(
                zip(compress(table.pod_keys, keep_list), compress(combined.tolist(), keep_list))
            )
            errors = list(compress(table.pod_keys, (~keep).tolist()))
        return schedulable, errors

    def _apply_accel_class_overrides(self, schedulable: dict, errors: list) -> None:
        """Accel-class resolution on the batch-triage surfaces: the device
        planes carry only BASE thresholds, so a device-classified verdict
        for a pod whose accel class any mirrored throttle names is wrong
        whenever the per-class replacement differs. Route exactly those
        pods through the class-aware host oracle — the same route the
        single-pod ``check_throttled`` takes — and overwrite their
        rows in place. No accel thresholds mirrored ⇒ zero cost; otherwise
        it lists every stored pod (O(P) materialisations) and runs the host
        oracle for the accel-class ones among them."""
        dm = self.device_manager
        if dm is None or not (
            dm.has_accel_thresholds("throttle")
            or dm.has_accel_thresholds("clusterthrottle")
        ):
            return
        from ..api.pod import accel_class_of

        for pod in self._list_pods():
            if not accel_class_of(pod) or pod.key not in schedulable:
                continue
            ok = self._host_verdict(pod)
            if ok is None:
                del schedulable[pod.key]
                errors.append(pod.key)
            else:
                schedulable[pod.key] = ok

    def full_tick_sharded(self, n_devices: Optional[int] = None, shape=None) -> dict:
        """The fused reconcile+PreFilter sweep over a device mesh — the
        multi-chip serving surface. Builds a 2D ("pods","throttles") Mesh
        over the first ``n_devices`` (default: all visible devices; one
        chip degenerates to a 1×1 mesh) and runs both kinds' complete
        tick tiled across it (DeviceStateManager.full_tick_sharded):
        override-resolved thresholds, used re-aggregation, throttled
        flags, and the [P,T] classification, with two psum all-reduces of
        tile partials as the only cross-device traffic.

        Returns ``{"schedulable": {pod_key: bool}, "used": {kind:
        {throttle_key: pod_count}}, "mesh": [dp, tp], "errors": [...]}``.
        Unlike ``pre_filter_batch`` this classifies against the
        freshly-derived state, not the written statuses (ahead of them
        under churn).

        The grid's slots are the first ``n_devices`` cards when the
        plugin's device is CUDA, else ``n_devices`` slots on the CPU;
        ``n_devices`` defaults to the product of ``shape`` when given, else
        to every visible card on CUDA and to 1 on the CPU.
        """
        if self.device_manager is None:
            raise RuntimeError("full_tick_sharded requires the device data plane")
        with self.tracer.trace("full_tick"):
            mesh = make_mesh(
                n_devices, tuple(shape) if shape else None,
                device=self.device_manager.device,
            )
            known_ns = {ns.name for ns in self.listers.namespaces.list()}
            used: dict = {}
            out = self.device_manager.full_tick_sharded(mesh, on_equal=False)
            for kind, (_, _, _, used_cnt, _, col_map) in out.items():
                used[kind] = {
                    tkey: int(used_cnt[col]) for col, tkey in col_map.items()
                }
            schedulable, errors = self._merge_verdicts(
                {k: (v[1], v[2]) for k, v in out.items()}, known_ns
            )
            # accel-class pods resolve per-class thresholds host-side, the
            # documented accel route (their verdicts then read the written
            # statuses — the tick's ahead-of-status freshness applies to
            # base-threshold pods)
            self._apply_accel_class_overrides(schedulable, errors)
            return {
                "schedulable": schedulable,
                "used": used,
                "mesh": [mesh.shape["pods"], mesh.shape["throttles"]],
                "errors": errors,
            }

    # ---------------------------------------------------------------- reserve

    def reserve(self, pod: Pod, node: str = "") -> Status:
        with self.tracer.trace("reserve"):
            return self._reserve(pod, node)

    def _reserve(self, pod: Pod, node: str = "") -> Status:
        errs: List[str] = []
        try:
            self.throttle_ctr.reserve(pod)
        except Exception as e:
            errs.append(f"Failed to reserve pod={pod.key} in ThrottleController: {e}")
        try:
            self.cluster_throttle_ctr.reserve(pod)
        except Exception as e:
            errs.append(f"Failed to reserve pod={pod.key} in ClusterThrottleController: {e}")
        if errs:
            return Status(StatusCode.ERROR, tuple(errs))
        return Status(StatusCode.SUCCESS)

    def unreserve(self, pod: Pod, node: str = "") -> None:
        with self.tracer.trace("unreserve"):
            self._unreserve(pod, node)

    def _unreserve(self, pod: Pod, node: str = "") -> None:
        try:
            self.throttle_ctr.unreserve(pod)
        except Exception:
            logger.exception("Failed to unreserve pod %s in ThrottleController", pod.key)
        try:
            self.cluster_throttle_ctr.unreserve(pod)
        except Exception:
            logger.exception("Failed to unreserve pod %s in ClusterThrottleController", pod.key)

    # -------------------------------------------------------- gang admission

    def pre_filter_gang(self, group_key: str, pods: Sequence[Pod]) -> Status:
        """All-or-nothing group feasibility: does the WHOLE group fit under
        every matched throttle of both kinds simultaneously? The device
        path is ONE batched dispatch (DeviceStateManager.gang_check_groups
        → ops/gang_check.gang_check_both); the host fallback (no device /
        breaker open) is the sequential per-pod oracle the kernel is
        property-tested against. Per-member reasons come from the oracle;
        the device path reports blocking throttle keys per kind."""
        import time as _time

        t0 = _time.monotonic()
        try:
            with self.tracer.trace("prefilter_gang"):
                return self._pre_filter_gang(group_key, pods)
        finally:
            if self._gang_check_hist is not None:
                self._gang_check_hist.observe_key((), _time.monotonic() - t0)

    def _pre_filter_gang(self, group_key: str, pods: Sequence[Pod]) -> Status:
        from ..api.pod import accel_class_of
        from ..engine.gang import sequential_gang_check

        if not pods:
            return Status(StatusCode.SUCCESS)
        accel = next((c for c in map(accel_class_of, pods) if c), None)
        dm = self.device_manager
        if dm is not None:
            out = dm.guarded(
                "gang", dm.gang_check_groups, [(group_key, list(pods), accel)]
            )
            if out is not None:
                verdict = out[group_key]
                if verdict["ok"]:
                    return Status(StatusCode.SUCCESS)
                reasons: List[str] = []
                for kind in ("clusterthrottle", "throttle"):
                    detail = verdict["kinds"][kind]
                    if detail["exceeds"]:
                        reasons.append(f"gang:{kind}[pod-requests-exceeds-threshold]")
                    if detail["active"]:
                        reasons.append(f"gang:{kind}[active]")
                    if detail["blocked"]:
                        reasons.append(
                            f"gang:{kind}[group-insufficient]="
                            + ",".join(sorted(detail["blocked"]))
                        )
                vlog(2, "gang %s is unschedulable: %s", group_key, "; ".join(reasons))
                return Status(StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE, tuple(reasons))
        try:
            feasible, blocked = sequential_gang_check(
                pods,
                (
                    ("throttle", self.throttle_ctr, False),
                    ("clusterthrottle", self.cluster_throttle_ctr, False),
                ),
            )
        except Exception as e:
            return Status(StatusCode.ERROR, (str(e),))
        if feasible:
            return Status(StatusCode.SUCCESS)
        reasons = tuple(
            f"gang:{pod_key}: " + "; ".join(blocks)
            for pod_key, blocks in sorted(blocked.items())
        )
        vlog(2, "gang %s is unschedulable: %s", group_key, "; ".join(reasons))
        return Status(StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE, reasons)

    def reserve_gang(self, group_key: str, pods: Sequence[Pod]) -> Status:
        """Atomic multi-pod Reserve: every member on every matched throttle
        of both kinds, or nothing (engine/gang.py). The scheduler calls
        this once per admitted group instead of N per-pod reserves."""
        with self.tracer.trace("reserve_gang"):
            member_keys = {}
            try:
                for pod in pods:
                    member_keys[pod.key] = {
                        "throttle": self.throttle_ctr.affected_throttle_keys(pod),
                        "clusterthrottle": (
                            self.cluster_throttle_ctr.affected_cluster_throttle_keys(pod)
                        ),
                    }
            except Exception as e:
                return Status(
                    StatusCode.ERROR,
                    (f"Failed to resolve gang {group_key} member throttles: {e}",),
                )
            try:
                ok = self.gang.reserve_group(group_key, list(pods), member_keys)
            except Exception as e:
                return Status(
                    StatusCode.ERROR, (f"Failed to reserve gang {group_key}: {e}",)
                )
            if not ok:
                return Status(
                    StatusCode.ERROR,
                    (f"gang {group_key}: member reserve failed (rolled back)",),
                )
            return Status(StatusCode.SUCCESS)

    def unreserve_gang(self, group_key: str) -> None:
        """Release the whole group reserve (scheduler Unreserve analog)."""
        with self.tracer.trace("unreserve_gang"):
            try:
                self.gang.rollback_group(group_key, "unreserve")
            except Exception:
                logger.exception("Failed to unreserve gang %s", group_key)

    # ----------------------------------------------------- policy / preempt

    def _policy_flip_priority(self, ctr):
        """Per-key hi-lane promotion priority for ``ctr``'s flips: the
        policy weight margin of the throttle's declared accel classes
        (PolicySpec.promotion_priority). Zero — the original FIFO lane —
        for throttles with no classes, unknown keys, or a weightless
        policy, so the default path is byte-identical."""

        def fn(key: str) -> int:
            spec = self.policy.active()
            if not spec.class_weights:
                return 0  # weightless policy: skip the store lookup entirely
            try:
                thr = ctr.throttle_by_key(key)
            except Exception:
                return 0
            classes = [
                e.accel_class for e in thr.spec.accel_class_thresholds
            ]
            if not classes:
                return 0
            return spec.promotion_priority(classes)

        return fn

    def set_policy_specs(self, specs) -> int:
        """Hot-swap the whole policy (the temporaryThresholdOverrides
        discipline applied to policy-as-data): accepts PolicySpec objects
        or their dict wire form. Returns the new policy generation."""
        from ..policy.spec import PolicySpec, policy_spec_from_dict

        decoded = [
            s if isinstance(s, PolicySpec) else policy_spec_from_dict(s)
            for s in specs
        ]
        gen = self.policy.set_specs(decoded)
        # policy swaps reach verdicts through reconcile status writes
        # (epoch-covered), but drop everything eagerly anyway — a swap is
        # rare and the repopulation cost is one miss per live key
        if self.verdict_cache is not None:
            self.verdict_cache.invalidate_all()
        return gen

    def maybe_preempt_gang(self, group_key: str, pods: Sequence[Pod]) -> bool:
        """Gang-aware preemption entry (scheduler._schedule_gang calls
        this after a capacity rejection): one coordinator cycle — policy
        gate → deficits → ranked victim selection (batched kernel ≡
        sequential oracle) → journaled, gang-atomic delete-then-requeue
        eviction. True iff victims were evicted (the freed capacity's
        requeue hints will re-drive the group). A victim-selection kernel
        that fails to launch raises ``KernelLaunchError`` to the caller."""
        with self.tracer.trace("preempt"):
            try:
                report = self.preempt.preempt_for_gang(group_key, list(pods))
            except KernelLaunchError:
                raise
            except Exception:
                logger.exception("preemption cycle failed for gang %s", group_key)
                return False
            return report["evicted"] > 0

    # ----------------------------------------------------------------- events

    def events_to_register(self) -> Sequence[ClusterEvent]:
        return (
            ClusterEvent("Node"),
            ClusterEvent("Pod"),
            ClusterEvent(f"throttles.{SCHEME_VERSION}.{SCHEME_GROUP}"),
            ClusterEvent(f"clusterthrottles.{SCHEME_VERSION}.{SCHEME_GROUP}"),
        )

    def pre_filter_extensions(self) -> None:
        return None  # plugin.go:259-261

    # ---------------------------------------------------------------- control

    def start(self) -> None:
        self.throttle_ctr.start()
        self.cluster_throttle_ctr.start()

    def stop(self) -> None:
        self.throttle_ctr.stop()
        self.cluster_throttle_ctr.stop()
        self.informer_factory.shutdown()
        self.core_informer_factory.shutdown()

    def run_pending_once(self) -> int:
        """Deterministic single-threaded drain (tests / embedding)."""
        return self.throttle_ctr.run_pending_once() + self.cluster_throttle_ctr.run_pending_once()
