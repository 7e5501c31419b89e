"""Prometheus metrics — the reference's 16 gauge families, same names,
labels, and value semantics.

Mirrors pkg/controllers/{metrics_recorder,throttle_metrics,
clusterthrottle_metrics}.go:

- 8 families per kind: spec threshold / status throttled / status used /
  status calculatedThreshold, each × resourceCounts + resourceRequests;
- labels ``{namespace,name,uid,resource}`` for Throttle,
  ``{name,uid,resource}`` for ClusterThrottle;
- CPU quantities exported as **milli** (``Quantity.MilliValue()``), all
  other resources as whole values rounded up (``Quantity.Value()`` ceils) —
  metrics_recorder.go:38-46;
- nil resourceCounts records 0 (metrics_recorder.go:29-35); nil throttled
  request-flag maps record nothing (metrics_recorder.go:56-59).

Implemented with a minimal in-process registry + text exposition (the
reference registers into kube-scheduler's legacyregistry and serves on its
metrics endpoint; here ``Registry.exposition()`` backs the daemon's
``/metrics``).
"""

from __future__ import annotations

import math

from bisect import bisect_left as _bucket_index  # smallest i: buckets[i] >= v
from fractions import Fraction
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple, Union

from .utils.lockorder import guard_attrs, make_lock
from .api.types import ClusterThrottle, IsResourceAmountThrottled, ResourceAmount, Throttle

# Every metric family this process may expose, declared in one place.
# The static analyzer's `registry` checker enforces that any literal name
# passed to gauge_vec/counter_vec/histogram_vec anywhere in the package is
# a member — an inline name that drifts from this set is a family no
# dashboard or alert will ever find. The per-kind families built from
# f-strings in _KindRecorder are enumerated explicitly below. Keep this a
# plain literal (the analyzer reads it from the AST without importing).
METRIC_NAMES = frozenset(
    {
        # _KindRecorder: 8 families x 2 kinds (f"{kind}_{suffix}")
        "throttle_spec_threshold_resourceCounts",
        "throttle_spec_threshold_resourceRequests",
        "throttle_status_throttled_resourceCounts",
        "throttle_status_throttled_resourceRequests",
        "throttle_status_used_resourceCounts",
        "throttle_status_used_resourceRequests",
        "throttle_status_calculated_threshold_resourceCounts",
        "throttle_status_calculated_threshold_resourceRequests",
        "clusterthrottle_spec_threshold_resourceCounts",
        "clusterthrottle_spec_threshold_resourceRequests",
        "clusterthrottle_status_throttled_resourceCounts",
        "clusterthrottle_status_throttled_resourceRequests",
        "clusterthrottle_status_used_resourceCounts",
        "clusterthrottle_status_used_resourceRequests",
        "clusterthrottle_status_calculated_threshold_resourceCounts",
        "clusterthrottle_status_calculated_threshold_resourceRequests",
        # two-lane status pipeline lag histograms (StatusLagMetrics)
        "kube_throttler_status_lag_seconds",
        "kube_throttler_status_flip_lag_seconds",
        # device circuit breaker (register_breaker_metrics)
        "kube_throttler_device_breaker_state",
        # hand-written CUDA kernels' launch counts (register_kernel_metrics)
        "kube_throttler_kernel_launches",
        # watch fan-out health (register_watch_metrics)
        "kube_throttler_watch_streams_open",
        "kube_throttler_watch_queue_depth",
        "kube_throttler_watch_overflow_total",
        # micro-batched ingest (register_ingest_metrics / engine/ingest.py)
        "kube_throttler_ingest_batch_size",
        "kube_throttler_ingest_events_total",
        # reflector counters (client/transport.py ReflectorMetrics)
        "kube_throttler_reflector_lists_total",
        "kube_throttler_reflector_watches_total",
        "kube_throttler_reflector_events_total",
        "kube_throttler_reflector_gone_total",
        # async status committer (client/transport.py)
        "kube_throttler_remote_status_commit_total",
        # device-fallback counter (engine/devicestate.py)
        "kube_throttler_device_fallback_total",
        # phase-latency tracing histogram (utils/tracing.py)
        "kube_throttler_phase_duration_seconds",
        # the CPython collector, per generation (register_gc_metrics, read at
        # scrape time from utils/gchygiene.py's hook): seconds paused and
        # collections run since the hook was installed; a pause stops every
        # thread of the process
        "kube_throttler_gc_pause_seconds_total",
        "kube_throttler_gc_collections_total",
        # pre_filter_batch's dedupe probe by outcome (plugin/plugin.py):
        # served, declined_size (the pod informer counts more pods than
        # BATCH_DEDUPE_MAX_PODS, read before any pod is listed) or
        # declined_mix (too few pods share a verdict fingerprint); served
        # over all three is the probe's useful share
        "kube_throttler_batch_dedupe_total",
        # the batch check per throttle kind: the pods each kind's verdicts
        # block, summed over merges (plugin/plugin.py _merge_verdicts); the
        # route each kind took in check_batch_all (sparse or dense) and the
        # gather's match width K, 0 on the dense route (engine/devicestate.py)
        "kube_throttler_batch_blocked_pods_total",
        "kube_throttler_batch_route_total",
        "kube_throttler_batch_match_width",
        # each kind's pod-row table builds, one per pod-set version
        # (engine/index.py pod_row_table)
        "kube_throttler_pod_row_table_builds_total",
        # crash-safety layer (register_recovery_metrics): snapshot cadence
        # + the last recovery's shape (engine/snapshot.py, engine/recovery.py)
        "kube_throttler_snapshot_total",
        "kube_throttler_snapshot_failures_total",
        "kube_throttler_snapshot_age_seconds",
        "kube_throttler_recovery_duration_seconds",
        "kube_throttler_recovery_journal_lines_replayed",
        "kube_throttler_recovery_divergence_total",
        # gang admission (register_gang_metrics / engine/gang.py): group
        # ledger population + outcomes, and the batched group-feasibility
        # kernel's dispatch latency (plugin.pre_filter_gang observes it)
        "kube_throttler_gang_groups_pending",
        "kube_throttler_gang_groups_admitted_total",
        "kube_throttler_gang_groups_rolled_back_total",
        "kube_throttler_gang_check_duration_seconds",
        # active/standby HA (register_ha_metrics / engine/replication.py)
        "kube_throttler_leader_state",
        "kube_throttler_failover_duration_seconds",
        "kube_throttler_replication_lag_bytes",
        "kube_throttler_replication_lag_events",
        "kube_throttler_stale_epoch_rejections_total",
        # scenario engine + SLO gates (register_scenario_metrics /
        # scenarios/engine.py): per-scenario outcome families a scenario
        # soak or CI gate dashboard alerts on
        "kube_throttler_scenario_ops_total",
        "kube_throttler_scenario_faults_total",
        "kube_throttler_scenario_slo_gate",
        "kube_throttler_scenario_flip_p99_seconds",
        "kube_throttler_scenario_recovery_seconds",
        # multiprocess keyspace sharding (register_shard_metrics /
        # sharding/front.py): per-shard ingest + liveness, the
        # scatter-gather fan-out latency, and the failure counters the
        # degraded-mode runbook watches
        "kube_throttler_shard_ingest_events_total",
        "kube_throttler_shard_up",
        "kube_throttler_shard_scatter_duration_seconds",
        "kube_throttler_shard_route_misses_total",
        "kube_throttler_shard_two_phase_aborts_total",
        # live elastic resharding (register_reshard_metrics /
        # sharding/reshard.py): ranges in flight, handoff volume, the
        # cutover-latency histogram the flip-SLO runbook reads, and the
        # abort counter the kill-mid-handoff matrix drives
        "kube_throttler_reshard_ranges_moving",
        "kube_throttler_reshard_handoff_bytes_total",
        "kube_throttler_reshard_handoff_events_total",
        "kube_throttler_reshard_cutover_duration_seconds",
        "kube_throttler_reshard_aborted_total",
        # adversarial scenario hunt (register_hunt_metrics /
        # scenarios/hunt/loop.py): search-loop progress a nightly soak
        # dashboard watches — mutants evaluated, coverage-map size, corpus
        # population, gate-failing mutants found, and shrink work
        "kube_throttler_hunt_iterations_total",
        "kube_throttler_hunt_coverage_size",
        "kube_throttler_hunt_corpus_size",
        "kube_throttler_hunt_findings_total",
        "kube_throttler_hunt_shrink_steps_total",
        # preemption & policy engine (register_preempt_metrics /
        # policy/preempt.py): cycle/victim counters, the no-progress
        # outcomes (infeasible), the crash/live rollback counter, the
        # evicted-then-readmitted churn counter the preemption-storm
        # scenario gates on, and the victim-selection latency histogram
        "kube_throttler_preempt_cycles_total",
        "kube_throttler_preempt_victims_total",
        "kube_throttler_preempt_infeasible_total",
        "kube_throttler_preempt_rolled_back_total",
        "kube_throttler_preempt_readmitted_total",
        "kube_throttler_preempt_select_duration_seconds",
        # columnar arena store (register_store_metrics / engine/columnar.py):
        # slot population/recycling, intern-pool growth, and how often the
        # lazy edge materializes full API objects
        "kube_throttler_store_arena_slots_live",
        "kube_throttler_store_arena_slots_recycled_total",
        "kube_throttler_store_intern_pool_size",
        "kube_throttler_store_materializations_total",
        # cross-host shard fleet (register_net_metrics / sharding/ipc.py
        # TcpShardClient): reconnect churn, RPCs that outran their
        # deadline budget, send-queue depth while partitioned, and
        # cumulative partition downtime — the partition runbook's four
        # signals (docs/robustness.md "Cross-host fleet")
        "kube_throttler_net_reconnects_total",
        "kube_throttler_net_rpc_deadline_exceeded_total",
        "kube_throttler_net_send_queue_depth",
        "kube_throttler_net_partition_seconds",
        # zero-copy shm event plane (register_shm_metrics /
        # sharding/shmring.py): per-shard ring occupancy, wrap and
        # counted-backpressure totals, frames pushed, and how many
        # batches fell back to the pickle socketpair — plus the worker
        # side's ingest counters (docs/PERFORMANCE.md "Zero-copy event
        # plane")
        "kube_throttler_shm_ring_depth",
        "kube_throttler_shm_ring_wraps_total",
        "kube_throttler_shm_backpressure_waits_total",
        "kube_throttler_shm_frames_total",
        "kube_throttler_shm_fallback_batches_total",
        "kube_throttler_shm_ingest_frames_total",
        "kube_throttler_shm_ingest_events_total",
        # interned-verdict cache (register_verdict_cache_metrics /
        # engine/verdictcache.py): probe outcomes, live entry count, and
        # explicit invalidation sweeps — hit-rate is the serving tier's
        # primary health signal (docs/PERFORMANCE.md "Verdict cache")
        "kube_throttler_verdict_cache_hits_total",
        "kube_throttler_verdict_cache_misses_total",
        "kube_throttler_verdict_cache_entries",
        "kube_throttler_verdict_cache_invalidations_total",
        # read-replica admission tier (register_replica_metrics /
        # engine/replication.py ReplicaGate): verdicts served by role and
        # requests refused for breaching the staleness bound — the
        # replica-lag SLO's two signals
        "kube_throttler_replica_verdicts_total",
        "kube_throttler_replica_lag_events_total",
        "kube_throttler_replica_lag_seconds",
        # rolling-upgrade safety (register_build_metrics / version.py):
        # this build's identity + per-shard negotiated protocol rows,
        # the typed incompatible-major refusal counter, and the
        # crash-loop guard's current per-shard restart backoff
        "kube_throttler_build_info",
        "kube_throttler_shard_version_mismatch_total",
        "kube_throttler_shard_restart_backoff_seconds",
    }
)


@guard_attrs
class GaugeVec:
    GUARDED_BY = {"_values": "self._lock"}

    def __init__(self, name: str, help_text: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = make_lock(f"metrics.family.{name}")
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, labels: Dict[str, str], value: float) -> None:
        self.set_key(tuple(labels[n] for n in self.label_names), value)

    def set_key(self, key: Tuple[str, ...], value: float) -> None:
        """Hot-path setter for a precomputed label-value tuple (order must
        match ``label_names``); skips the per-call dict→tuple rebuild."""
        with self._lock:
            self._values[key] = float(value)

    def get(self, labels: Dict[str, str]) -> Optional[float]:
        key = tuple(labels[n] for n in self.label_names)
        with self._lock:
            return self._values.get(key)

    def collect(self) -> Dict[Tuple[str, ...], float]:
        """Raw values snapshot. Families fed by deferred recorders are
        stale until ``Registry.flush()`` (or ``exposition()``) runs."""
        with self._lock:
            return dict(self._values)


class CounterVec(GaugeVec):
    """Monotonic counter family (exposition TYPE counter; use the
    _total naming convention). ``inc`` is atomic under the family lock."""

    def inc(self, labels: Dict[str, str], delta: float = 1.0) -> None:
        key = tuple(labels[n] for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta


@guard_attrs
class HistogramVec:
    """Prometheus histogram family: cumulative buckets + _sum/_count per
    label set. Backs the per-phase latency tracing (SURVEY §5's TPU-native
    tracing equivalent — the reference has only klog levels)."""

    GUARDED_BY = {"_series": "self._lock"}

    # le boundaries tuned for scheduling-phase latencies: 10µs .. 10s
    DEFAULT_BUCKETS = (
        1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
        1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    )

    def __init__(
        self,
        name: str,
        help_text: str,
        label_names: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
    ):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets) if buckets is not None else self.DEFAULT_BUCKETS
        self._lock = make_lock(f"metrics.family.{name}")
        # key -> (bucket counts, sum, count)
        self._series: Dict[Tuple[str, ...], list] = {}

    def observe(self, labels: Dict[str, str], value: float) -> None:
        self.observe_key(tuple(labels[n] for n in self.label_names), value)

    def observe_key(self, key: Tuple[str, ...], value: float) -> None:
        """Hot-path observe for a precomputed label tuple. Buckets store
        RAW (non-cumulative) counts — one bisect instead of a walk over
        every boundary; collect() cumsums at scrape time (observes
        outnumber scrapes by ~1e6 on the serving path)."""
        i = _bucket_index(self.buckets, value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[key] = s
            s[0][i] += 1
            s[1] += value
            s[2] += 1

    def snapshot(self, labels: Dict[str, str]) -> Optional[Tuple[float, int]]:
        """(sum, count) for one label set, or None."""
        key = tuple(labels[n] for n in self.label_names)
        with self._lock:
            s = self._series.get(key)
            return (s[1], s[2]) if s else None

    def collect(self) -> Dict[Tuple[str, ...], tuple]:
        """Series snapshot with CUMULATIVE bucket counts (the prometheus
        exposition shape; storage is raw per-bucket — see observe_key)."""
        out = {}
        with self._lock:
            for k, s in self._series.items():
                cum, running = [], 0
                for c in s[0][: len(self.buckets)]:
                    running += c
                    cum.append(running)
                out[k] = (cum, s[1], s[2])
        return out


@guard_attrs
class Registry:
    GUARDED_BY = {
        "_gauges": "self._lock",
        "_counters": "self._lock",
        "_histograms": "self._lock",
        "_pre_expose": "self._lock",
    }

    def __init__(self) -> None:
        self._lock = make_lock("metrics.registry")
        self._gauges: Dict[str, GaugeVec] = {}
        self._counters: Dict[str, CounterVec] = {}
        self._histograms: Dict[str, HistogramVec] = {}
        # scrape-time collectors (deferred recorders flush here): gauges
        # only need to be correct when read, so hot paths may buffer
        self._pre_expose: list = []

    def register_pre_expose(self, fn) -> None:
        with self._lock:
            self._pre_expose.append(fn)

    def flush(self) -> None:
        """Run the deferred recorders' flush hooks without rendering.

        Gauge families fed by deferred recorders (ThrottleMetricsRecorder
        et al. buffer per-label snapshots and flush at scrape) are only
        current after a flush: a consumer reading ``GaugeVec.collect()``
        directly — tests, in-process introspection — must call this first
        (``exposition()`` does it implicitly)."""
        with self._lock:
            hooks = list(self._pre_expose)
        for fn in hooks:
            fn()

    def gauge_vec(self, name: str, help_text: str, label_names: Sequence[str]) -> GaugeVec:
        with self._lock:
            if name in self._gauges:
                return self._gauges[name]
            g = GaugeVec(name, help_text, label_names)
            self._gauges[name] = g
            return g

    def counter_vec(self, name: str, help_text: str, label_names: Sequence[str]) -> CounterVec:
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            c = CounterVec(name, help_text, label_names)
            self._counters[name] = c
            return c

    def histogram_vec(
        self,
        name: str,
        help_text: str,
        label_names: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
    ) -> HistogramVec:
        with self._lock:
            if name in self._histograms:
                return self._histograms[name]
            h = HistogramVec(name, help_text, label_names, buckets)
            self._histograms[name] = h
            return h

    def family_totals(self) -> Dict[str, Tuple[int, float]]:
        """``family name → (series count, value sum)`` across gauges,
        counters, and histograms (histograms contribute their observation
        counts). Flushes deferred recorders first so scrape-time families
        are current. This is the scenario hunt's metric-coverage signal:
        comparing two snapshots tells you which families a run *touched*
        without parsing exposition text."""
        self.flush()
        out: Dict[str, Tuple[int, float]] = {}
        with self._lock:
            gauges = list(self._gauges.values())
            counters = list(self._counters.values())
            histograms = list(self._histograms.values())
        for fam in gauges + counters:
            values = fam.collect()
            if values:
                out[fam.name] = (len(values), float(sum(values.values())))
        for h in histograms:
            series = h.collect()
            if series:
                out[h.name] = (
                    len(series),
                    float(sum(count for _, _, count in series.values())),
                )
        return out

    def exposition(self) -> str:
        """Prometheus text format (flushes deferred recorders first)."""
        self.flush()

        def esc(v: str) -> str:
            # label-value escaping per the exposition format: \ " and newline
            return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

        def fmt(value: float) -> str:
            return str(int(value)) if value == int(value) else str(value)

        lines = []
        with self._lock:
            gauges = list(self._gauges.values())
            counters = list(self._counters.values())
            histograms = list(self._histograms.values())
        for family, ptype in [(gauges, "gauge"), (counters, "counter")]:
            for g in family:
                lines.append(f"# HELP {g.name} {g.help}")
                lines.append(f"# TYPE {g.name} {ptype}")
                for key, value in sorted(g.collect().items()):
                    labels = ",".join(
                        f'{n}="{esc(v)}"' for n, v in zip(g.label_names, key)
                    )
                    brace = f"{{{labels}}}" if labels else ""
                    lines.append(f"{g.name}{brace} {fmt(value)}")
        for h in histograms:
            lines.append(f"# HELP {h.name} {h.help}")
            lines.append(f"# TYPE {h.name} histogram")
            for key, (counts, total, count) in sorted(h.collect().items()):
                base = [f'{n}="{esc(v)}"' for n, v in zip(h.label_names, key)]
                for le, c in zip(h.buckets, counts):
                    labels = ",".join(base + [f'le="{le}"'])
                    lines.append(f"{h.name}_bucket{{{labels}}} {c}")
                labels = ",".join(base + ['le="+Inf"'])
                lines.append(f"{h.name}_bucket{{{labels}}} {count}")
                sep = ",".join(base)
                brace = f"{{{sep}}}" if sep else ""
                lines.append(f"{h.name}_sum{brace} {total}")
                lines.append(f"{h.name}_count{brace} {count}")
        return "\n".join(lines) + "\n"


@lru_cache(maxsize=8192)
def _quantity_metric_value(resource: str, q: Fraction) -> float:
    if resource == "cpu":
        # MilliValue: ceil to integer milli (metrics_recorder.go:40-41)
        return float(math.ceil(q * 1000))
    # Value(): ceil to integer units
    return float(math.ceil(q))


@guard_attrs
class _KindRecorder:
    """One kind's 8 gauge families."""

    GUARDED_BY = {"_pending": "self._pending_lock"}

    def __init__(self, kind_prefix: str, label_names: Sequence[str], registry: Registry):
        mk = registry.gauge_vec
        k = kind_prefix
        assert tuple(label_names)[-1] == "resource"  # set_key relies on this order
        self._base_names = tuple(label_names)[:-1]
        # deferred-record buffer: latest object per label set, flushed by
        # the registry's pre-exposition hook (see record())
        self._pending: Dict[Tuple[str, ...], object] = {}
        self._pending_lock = make_lock(f"metrics.pending.{kind_prefix}")
        self._flush_lock = make_lock(f"metrics.flush.{kind_prefix}")
        registry.register_pre_expose(self._flush)
        self.spec_counts = mk(
            f"{k}_spec_threshold_resourceCounts",
            f"threshold on specific resourceCounts of the {k}",
            label_names,
        )
        self.spec_requests = mk(
            f"{k}_spec_threshold_resourceRequests",
            f"threshold on specific resourceRequests of the {k}",
            label_names,
        )
        self.throttled_counts = mk(
            f"{k}_status_throttled_resourceCounts",
            f"resourceCounts of the {k} is throttled or not on specific resource (1=throttled, 0=not throttled)",
            label_names,
        )
        self.throttled_requests = mk(
            f"{k}_status_throttled_resourceRequests",
            f"resourceRequests of the {k} is throttled or not on specific resource (1=throttled, 0=not throttled)",
            label_names,
        )
        self.used_counts = mk(
            f"{k}_status_used_resourceCounts",
            f"used resource counts of the {k}",
            label_names,
        )
        self.used_requests = mk(
            f"{k}_status_used_resourceRequests",
            f"used amount of resource requests of the {k}",
            label_names,
        )
        self.calculated_counts = mk(
            f"{k}_status_calculated_threshold_resourceCounts",
            f"calculated threshold on specific resourceCounts of the {k}",
            label_names,
        )
        self.calculated_requests = mk(
            f"{k}_status_calculated_threshold_resourceRequests",
            f"calculated threshold on specific resourceRequests of the {k}",
            label_names,
        )

    def _record_counts(self, gauge: GaugeVec, base: Tuple[str, ...], counts: Optional[int]) -> None:
        gauge.set_key(base + ("pod",), 0.0 if counts is None else float(counts))

    def _record_requests(self, gauge: GaugeVec, base: Tuple[str, ...], amount: ResourceAmount) -> None:
        for resource, q in (amount.resource_requests or {}).items():
            gauge.set_key(base + (resource,), _quantity_metric_value(resource, q))

    def _record_flags(self, base: Tuple[str, ...], flags: IsResourceAmountThrottled) -> None:
        self.throttled_counts.set_key(
            base + ("pod",), 1.0 if flags.resource_counts_pod else 0.0
        )
        for resource, throttled in (flags.resource_requests or {}).items():
            self.throttled_requests.set_key(
                base + (resource,), 1.0 if throttled else 0.0
            )

    def record(self, labels: Dict[str, str], thr: Union[Throttle, ClusterThrottle]) -> None:
        # DEFERRED: ~7-15 gauge writes per status update would land on the
        # reconcile hot path (~23µs/key — measured as ~25% of the per-key
        # drain cost under cfg5 max rate). Gauges only need to be correct
        # at scrape time, so record() just buffers the latest object per
        # label set and the Registry's pre-exposition hook flushes.
        base = tuple(labels[n] for n in self._base_names)
        with self._pending_lock:
            self._pending[base] = thr

    def _flush(self) -> None:
        # two locks: _pending_lock guards only the buffer swap so the hot
        # record() path never waits behind gauge writes (a post-sweep flush
        # can be T×~7 set_keys), while _flush_lock serializes whole flushes
        # so two concurrent scrapes cannot interleave writes and pin gauges
        # at an older snapshot
        with self._flush_lock:
            with self._pending_lock:
                items = list(self._pending.items())
                self._pending.clear()
            self._write_items(items)

    def _write_items(self, items) -> None:
        for base, thr in items:
            self._record_counts(self.spec_counts, base, thr.spec.threshold.resource_counts)
            self._record_requests(self.spec_requests, base, thr.spec.threshold)
            self._record_flags(base, thr.status.throttled)
            self._record_counts(self.used_counts, base, thr.status.used.resource_counts)
            self._record_requests(self.used_requests, base, thr.status.used)
            calc = thr.status.calculated_threshold.threshold
            self._record_counts(self.calculated_counts, base, calc.resource_counts)
            self._record_requests(self.calculated_requests, base, calc)


class StatusLagMetrics:
    """The two-lane status pipeline's latency histograms.

    - ``kube_throttler_status_lag_seconds`` — event → publication for EVERY
      status write (total lag: the time from the store/watch event that
      made a key dirty to its status being visible — written to the local
      store, or the PUT completing on the wire);
    - ``kube_throttler_status_flip_lag_seconds`` — the same lag restricted
      to FLIP publications: statuses whose ``throttled`` flags or
      ``calculatedThreshold`` changed. Flips are the only status bits that
      change admission verdicts, so their tail is the one that bounds how
      stale scheduling decisions can be (the reference publishes per-key
      inside reconcile, throttle_controller.go:157-173, so its flip lag IS
      its total lag; ours diverge because refreshes batch).

    ``path`` distinguishes the local batched store commit (``local``) from
    the remote async committer's PUT completion (``remote``)."""

    # status publication spans ~100µs (local batch write) to multi-second
    # backlog tails; anchor the buckets around the <150ms flip target
    BUCKETS = (
        1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
        0.1, 0.15, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    )

    def __init__(self, registry: Registry, path: str):
        self._path = path
        self.total = registry.histogram_vec(
            "kube_throttler_status_lag_seconds",
            "event to status-publication lag (all status writes)",
            ["kind", "path"],
            buckets=self.BUCKETS,
        )
        self.flip = registry.histogram_vec(
            "kube_throttler_status_flip_lag_seconds",
            "event to status-publication lag for throttled/calculatedThreshold flips",
            ["kind", "path"],
            buckets=self.BUCKETS,
        )

    def observe(self, kind: str, lag_s: float, flip: bool) -> None:
        key = (kind, self._path)
        self.total.observe_key(key, lag_s)
        if flip:
            self.flip.observe_key(key, lag_s)


_BREAKER_STATE_VALUES = {"closed": 0.0, "open": 1.0, "half-open": 2.0}


def register_breaker_metrics(registry: Registry, device_manager) -> GaugeVec:
    """Device circuit-breaker state gauge (0=closed, 1=open, 2=half-open),
    refreshed at scrape time from the manager's state machine — the
    operator-facing answer to "is admission serving device- or host-side
    right now, and is a probe pending?"."""
    gauge = registry.gauge_vec(
        "kube_throttler_device_breaker_state",
        "device circuit breaker state (0=closed, 1=open, 2=half-open)",
        [],
    )
    registry.register_pre_expose(
        lambda: gauge.set_key(
            (), _BREAKER_STATE_VALUES.get(device_manager.breaker_state(), 0.0)
        )
    )
    return gauge


def kernel_launch_counts() -> Dict[str, int]:
    """Launches of each hand-written CUDA kernel in this process since it
    started, from the wrappers' counters (which count kernel launches
    only, never the plain versions run on CPU tensors)."""
    from .ops import check_dense, check_gather, victim_select

    return {
        "check_dense": check_dense.launches,
        "check_gather": check_gather.launches,
        "pack_gather_rows": check_gather.pack_launches,
        "victim_select": victim_select.launches,
    }


def register_kernel_metrics(registry: Registry) -> GaugeVec:
    """:func:`kernel_launch_counts`, read at scrape time: an operator's
    proof that served calls went through the card's kernels."""
    gauge = registry.gauge_vec(
        "kube_throttler_kernel_launches",
        "launches of each hand-written CUDA kernel in this process",
        ["kernel"],
    )

    def refresh() -> None:
        for label, n in kernel_launch_counts().items():
            gauge.set_key((label,), float(n))

    registry.register_pre_expose(refresh)
    return gauge


def register_gc_metrics(registry: Registry) -> None:
    """The collector's pauses and collections per generation, read at
    scrape time from the accounting hook (``utils/gchygiene.py``), which
    this installs if it is not installed yet."""
    from .utils.gchygiene import gc_totals, install_gc_accounting

    install_gc_accounting()
    pause = registry.counter_vec(
        "kube_throttler_gc_pause_seconds_total",
        "seconds the CPython collector paused the process, per generation",
        ["generation"],
    )
    runs = registry.counter_vec(
        "kube_throttler_gc_collections_total",
        "CPython collections run in the process, per generation",
        ["generation"],
    )

    def refresh() -> None:
        for gen in range(3):
            totals = gc_totals(gen)
            if totals is not None:
                pause.set_key((str(gen),), totals[0])
                runs.set_key((str(gen),), float(totals[1]))

    registry.register_pre_expose(refresh)


def register_recovery_metrics(
    registry: Registry, snapshot_manager=None, recovery_manager=None
) -> None:
    """Crash-safety observability: snapshot cadence (age/written/failed)
    from the SnapshotManager and the last recovery's duration, replayed
    journal lines, and plane divergences from the RecoveryManager. All fed
    at scrape time from the managers' single-writer stats — the snapshot
    and recovery paths never touch a metric family on their own."""
    snap_total = registry.counter_vec(
        "kube_throttler_snapshot_total", "snapshots written by this process", []
    )
    snap_failed = registry.counter_vec(
        "kube_throttler_snapshot_failures_total",
        "snapshot writes that failed (journal remains the recovery source)",
        [],
    )
    snap_age = registry.gauge_vec(
        "kube_throttler_snapshot_age_seconds",
        "seconds since the last snapshot written by this process "
        "(-1 before the first one)",
        [],
    )
    rec_duration = registry.gauge_vec(
        "kube_throttler_recovery_duration_seconds",
        "wall time of the startup recovery (snapshot restore + journal replay)",
        [],
    )
    rec_lines = registry.gauge_vec(
        "kube_throttler_recovery_journal_lines_replayed",
        "journal events replayed by the startup recovery",
        [],
    )
    rec_divergence = registry.counter_vec(
        "kube_throttler_recovery_divergence_total",
        "published-plane vs restored-status mismatches found (and repaired) "
        "by the recovery reconcile",
        [],
    )

    def flush() -> None:
        if snapshot_manager is not None:
            snap_total.set_key((), float(snapshot_manager.snapshots_written))
            snap_failed.set_key((), float(snapshot_manager.snapshot_failures))
            age = snapshot_manager.snapshot_age_seconds()
            snap_age.set_key((), -1.0 if age is None else age)
        if recovery_manager is not None:
            r = recovery_manager.report
            rec_duration.set_key((), r.duration_s)
            rec_lines.set_key((), float(r.journal_lines_replayed))
            rec_divergence.set_key((), float(r.divergences))

    registry.register_pre_expose(flush)


def register_gang_metrics(registry: Registry, ledger) -> "HistogramVec":
    """Gang-admission observability (engine/gang.py): ledger population
    (groups reserved but not yet fully admitted) plus the all-or-nothing
    outcome counters, sampled from the ledger at scrape time. Returns the
    group-feasibility latency histogram the plugin observes per
    ``pre_filter_gang`` dispatch (inline — scrape-time sampling would miss
    the distribution)."""
    pending_g = registry.gauge_vec(
        "kube_throttler_gang_groups_pending",
        "groups holding an all-or-nothing reserve, not yet fully admitted",
        [],
    )
    admitted_c = registry.counter_vec(
        "kube_throttler_gang_groups_admitted_total",
        "groups whose every member was observed admitted",
        [],
    )
    rolled_c = registry.counter_vec(
        "kube_throttler_gang_groups_rolled_back_total",
        "groups rolled back (member failure, deletion, TTL expiry, or an "
        "explicit unreserve) — all member reservations released together",
        [],
    )
    check_h = registry.histogram_vec(
        "kube_throttler_gang_check_duration_seconds",
        "batched group-feasibility evaluation latency (one dispatch per "
        "scheduling tick, both kinds fused)",
        [],
        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
    )

    def flush() -> None:
        pending_g.set_key((), float(ledger.pending_groups()))
        admitted_c.set_key((), float(ledger.groups_admitted_total))
        rolled_c.set_key((), float(ledger.groups_rolled_back_total))

    registry.register_pre_expose(flush)
    return check_h


def register_preempt_metrics(registry: Registry, coordinator) -> "HistogramVec":
    """Preemption & policy observability (policy/preempt.py): cycle and
    victim counters sampled from the coordinator at scrape time, plus the
    victim-selection latency histogram the coordinator observes inline
    per cycle (returned, like the gang check histogram). The readmitted
    counter is the victim-churn signal the preemption-storm scenario's
    no-thrash SLO gate reads."""
    cycles_c = registry.counter_vec(
        "kube_throttler_preempt_cycles_total",
        "preemption cycles that evicted at least one victim",
        [],
    )
    victims_c = registry.counter_vec(
        "kube_throttler_preempt_victims_total",
        "victim pods evicted (whole gangs count every member)",
        [],
    )
    infeasible_c = registry.counter_vec(
        "kube_throttler_preempt_infeasible_total",
        "cycles that evicted NOTHING because no victim set could admit "
        "the group (member-exceeds, no eligible victims, or insufficient "
        "eligible capacity)",
        [],
    )
    rolled_c = registry.counter_vec(
        "kube_throttler_preempt_rolled_back_total",
        "evictions rolled back to zero victims (live mid-eviction failure; "
        "crash rollbacks surface via the recovery report instead)",
        [],
    )
    readmitted_c = registry.counter_vec(
        "kube_throttler_preempt_readmitted_total",
        "evicted pods readmitted within the churn window — the thrash "
        "signal the preemption-storm scenario bounds",
        [],
    )
    select_h = registry.histogram_vec(
        "kube_throttler_preempt_select_duration_seconds",
        "deficit derivation + candidate gathering + ranked victim "
        "selection latency per cycle (batched kernel or host oracle)",
        [],
        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
    )

    def flush() -> None:
        cycles_c.set_key((), float(coordinator.cycles_total))
        victims_c.set_key((), float(coordinator.victims_total))
        infeasible_c.set_key((), float(coordinator.infeasible_total))
        rolled_c.set_key((), float(coordinator.rolled_back_total))
        readmitted_c.set_key((), float(coordinator.readmitted_total))

    registry.register_pre_expose(flush)
    return select_h


def register_ha_metrics(registry: Registry, coordinator) -> None:
    """Active/standby HA observability (engine/replication.py), fed at
    scrape time from the coordinator: role (1=leader, 0=standby), the last
    failover's duration, replication lag (bytes behind the leader's
    journal position + events applied so far), and the stale-epoch write
    rejections the fencing gates have refused — the counter that must stay
    at ZERO on a healthy pair and moves exactly when a deposed leader
    tries to write."""
    leader_g = registry.gauge_vec(
        "kube_throttler_leader_state",
        "replica role (1=leader, 0=standby)",
        [],
    )
    failover_g = registry.gauge_vec(
        "kube_throttler_failover_duration_seconds",
        "tail fast-forward + epoch bump time of the last promotion "
        "(-1 before any failover)",
        [],
    )
    lag_bytes_g = registry.gauge_vec(
        "kube_throttler_replication_lag_bytes",
        "journal bytes the standby still has to stream (0 on the leader)",
        [],
    )
    lag_events_g = registry.gauge_vec(
        "kube_throttler_replication_lag_events",
        "events applied from the replication stream so far "
        "(0 on a never-standby leader)",
        [],
    )
    stale_c = registry.counter_vec(
        "kube_throttler_stale_epoch_rejections_total",
        "writes refused because this replica's fencing epoch went stale "
        "(journal appends + snapshot cuts)",
        [],
    )

    def flush() -> None:
        leader_g.set_key((), 1.0 if coordinator.role == "leader" else 0.0)
        failover_g.set_key(
            (),
            -1.0
            if coordinator.failover_duration_s is None
            else coordinator.failover_duration_s,
        )
        rep = coordinator.replicator
        lag_bytes_g.set_key((), float(rep.lag_bytes()) if rep is not None else 0.0)
        lag_events_g.set_key(
            (), float(rep.events_applied) if rep is not None else 0.0
        )
        stale_c.set_key((), float(coordinator.stale_epoch_rejections()))

    registry.register_pre_expose(flush)


def register_scenario_metrics(registry: Registry) -> Dict[str, object]:
    """Scenario-engine outcome families (scenarios/engine.py): ops
    replayed and faults fired per scenario, each SLO gate's last verdict
    (1 = pass), and the headline gate measurements (flip p99, post-restart
    recovery). Written inline per run — a scenario run IS the scrape."""
    return {
        "ops": registry.counter_vec(
            "kube_throttler_scenario_ops_total",
            "trace ops replayed against the apiserver per scenario",
            ["scenario"],
        ),
        "faults": registry.counter_vec(
            "kube_throttler_scenario_faults_total",
            "fault-plan firings per scenario and site (the schedule's witness)",
            ["scenario", "site"],
        ),
        "gate": registry.gauge_vec(
            "kube_throttler_scenario_slo_gate",
            "last SLO gate verdict per scenario (1=pass, 0=fail)",
            ["scenario", "gate"],
        ),
        "flip_p99": registry.gauge_vec(
            "kube_throttler_scenario_flip_p99_seconds",
            "crossing-anchored flip-publication p99 of the last run",
            ["scenario"],
        ),
        "recovery": registry.gauge_vec(
            "kube_throttler_scenario_recovery_seconds",
            "worst post-restart time to the next landed status publication",
            ["scenario"],
        ),
    }


def register_hunt_metrics(registry: Registry) -> Dict[str, object]:
    """Adversarial-hunt progress families (scenarios/hunt/loop.py): the
    nightly soak's dashboard surface. Iterations/findings/shrink-steps are
    counters (monotone across a soak process); coverage and corpus size
    are gauges sampled by the loop after every iteration."""
    return {
        "iterations": registry.counter_vec(
            "kube_throttler_hunt_iterations_total",
            "mutants generated and evaluated by the hunt loop",
            [],
        ),
        "coverage": registry.gauge_vec(
            "kube_throttler_hunt_coverage_size",
            "distinct coverage keys observed (fault sites × hit buckets, "
            "metric families touched, health transitions, gate outcomes)",
            [],
        ),
        "corpus": registry.gauge_vec(
            "kube_throttler_hunt_corpus_size",
            "programs retained in the novelty-weighted hunt corpus",
            [],
        ),
        "findings": registry.counter_vec(
            "kube_throttler_hunt_findings_total",
            "gate-failing mutants discovered (pre-shrink)",
            [],
        ),
        "shrink_steps": registry.counter_vec(
            "kube_throttler_hunt_shrink_steps_total",
            "accepted shrink transformations across all findings",
            [],
        ),
    }


def register_shard_metrics(registry: Registry, front) -> Dict[str, object]:
    """Multiprocess-sharding observability (sharding/front.py): per-shard
    ingest throughput and liveness sampled at scrape time from the shard
    handles, plus the inline-observed scatter-gather fan-out latency and
    the two failure counters (route misses to a down shard, two-phase
    reserve aborts) the degraded-mode runbook alerts on."""
    ingest_c = registry.counter_vec(
        "kube_throttler_shard_ingest_events_total",
        "events routed to and accepted by each shard's ingest pipeline",
        ["shard"],
    )
    up_g = registry.gauge_vec(
        "kube_throttler_shard_up",
        "shard worker liveness (1=alive, 0=down) as the front sees it",
        ["shard"],
    )
    scatter_h = registry.histogram_vec(
        "kube_throttler_shard_scatter_duration_seconds",
        "scatter-gather fan-out latency per RPC op (request fan-out to "
        "last shard answer, merge excluded)",
        ["op"],
    )
    misses_c = registry.counter_vec(
        "kube_throttler_shard_route_misses_total",
        "events that could not be delivered because the owning shard was "
        "down (repaired by the restart resync)",
        [],
    )
    aborts_c = registry.counter_vec(
        "kube_throttler_shard_two_phase_aborts_total",
        "two-phase reserves aborted by the front after a prepare failure",
        [],
    )

    def flush() -> None:
        for sid in range(front.n_shards):
            handle = front.shards.get(sid)
            alive = handle is not None and handle.alive
            up_g.set_key((str(sid),), 1.0 if alive else 0.0)
            if handle is not None:
                ingest_c.set_key((str(sid),), float(handle.events_sent))

    registry.register_pre_expose(flush)
    return {"scatter": scatter_h, "aborts": aborts_c, "misses": misses_c}


def register_net_metrics(registry: Registry, front) -> Dict[str, object]:
    """Cross-host fleet transport observability (sharding/ipc.py
    ``TcpShardClient``), sampled at scrape time from the shard handles.
    Socketpair/local handles report zeros for the TCP-only families, so
    one dashboard covers mixed fleets. The four signals the partition
    runbook watches: reconnect churn (a flapping link keeps the counter
    moving), deadline-exceeded RPCs (a slow link that has not yet died),
    send-queue depth (events parked behind a partition — shed pressure),
    and cumulative partition downtime per shard."""
    reconnects_c = registry.counter_vec(
        "kube_throttler_net_reconnects_total",
        "shard transport re-establishments after a connection loss",
        ["shard"],
    )
    deadline_c = registry.counter_vec(
        "kube_throttler_net_rpc_deadline_exceeded_total",
        "shard RPCs abandoned because their per-op deadline budget "
        "(--shard-rpc-deadline) elapsed",
        ["shard"],
    )
    depth_g = registry.gauge_vec(
        "kube_throttler_net_send_queue_depth",
        "events queued at the front awaiting transport to the shard "
        "(bounded; overflow sheds pod upserts and marks dirty)",
        ["shard"],
    )
    partition_g = registry.gauge_vec(
        "kube_throttler_net_partition_seconds",
        "cumulative seconds the shard's primary connection has been "
        "down, including the outage in progress",
        ["shard"],
    )

    def flush() -> None:
        for sid in range(front.n_shards):
            handle = front.shards.get(sid)
            if handle is None:
                continue
            key = (str(sid),)
            reconnects_c.set_key(key, float(getattr(handle, "reconnects", 0)))
            deadline_c.set_key(
                key, float(getattr(handle, "deadline_exceeded", 0))
            )
            depth_g.set_key(key, float(handle.pending_events()))
            outage = getattr(handle, "outage_seconds", None)
            partition_g.set_key(key, outage() if outage is not None else 0.0)

    registry.register_pre_expose(flush)
    return {
        "reconnects": reconnects_c,
        "deadline_exceeded": deadline_c,
        "queue_depth": depth_g,
        "partition_seconds": partition_g,
    }


def register_shm_metrics(registry: Registry, front) -> Dict[str, object]:
    """Zero-copy event-plane observability (sharding/shmring.py),
    sampled at scrape time from each shard handle's ``shm_lane``.
    Handles without a lane (TCP fleets, ``KT_SHM_RING=0``, masked
    ``evt-shm`` capability) report zeros, so one dashboard covers mixed
    fleets. The signals the ring runbook watches: occupancy (a reader
    that stopped draining), counted backpressure (the writer waited for
    slots — never a silent drop), wraps (normal steady-state churn),
    and fallback batches (events that rode the pickle socketpair
    instead — nonzero means the fast path is off for that shard)."""
    depth_g = registry.gauge_vec(
        "kube_throttler_shm_ring_depth",
        "event frames committed to the shard's shm ring, not yet "
        "consumed by the worker",
        ["shard"],
    )
    wraps_c = registry.counter_vec(
        "kube_throttler_shm_ring_wraps_total",
        "arena wraparounds on the shard's shm ring",
        ["shard"],
    )
    backpressure_c = registry.counter_vec(
        "kube_throttler_shm_backpressure_waits_total",
        "writer waits for ring capacity (counted backpressure; "
        "non-sheddable ops are never silently dropped)",
        ["shard"],
    )
    frames_c = registry.counter_vec(
        "kube_throttler_shm_frames_total",
        "columnar event frames pushed to the shard over shared memory",
        ["shard"],
    )
    fallback_c = registry.counter_vec(
        "kube_throttler_shm_fallback_batches_total",
        "event batches sent over the pickle socketpair while an shm "
        "lane existed (capability masked, barrier pending, or lane dead)",
        ["shard"],
    )

    def flush() -> None:
        for sid in range(front.n_shards):
            handle = front.shards.get(sid)
            if handle is None:
                continue
            key = (str(sid),)
            lane = getattr(handle, "shm_lane", None)
            stats = lane.stats() if lane is not None else {}
            depth_g.set_key(key, float(stats.get("depth", 0)))
            wraps_c.set_key(key, float(stats.get("wraps", 0)))
            backpressure_c.set_key(key, float(stats.get("backpressure", 0)))
            frames_c.set_key(key, float(stats.get("frames", 0)))
            fallback_c.set_key(
                key, float(getattr(handle, "shm_fallback_batches", 0))
            )

    registry.register_pre_expose(flush)
    return {
        "depth": depth_g,
        "wraps": wraps_c,
        "backpressure": backpressure_c,
        "frames": frames_c,
        "fallback": fallback_c,
    }


def register_shm_worker_metrics(registry: Registry, core, shard_id: int) -> None:
    """Worker-side half of the shm event plane: frames/events ingested
    off the ring by this worker's pump thread, plus the ring depth as
    the READER sees it (the two depth gauges disagreeing for long means
    a stalled pump). Sampled from ``core.shm_pump`` at scrape; a worker
    running plain pickle registers nothing."""
    frames_c = registry.counter_vec(
        "kube_throttler_shm_ingest_frames_total",
        "columnar event frames this worker decoded off its shm ring",
        ["shard"],
    )
    events_c = registry.counter_vec(
        "kube_throttler_shm_ingest_events_total",
        "events this worker applied from shm frames",
        ["shard"],
    )
    depth_g = registry.gauge_vec(
        "kube_throttler_shm_ring_depth",
        "event frames committed to the shm ring, not yet consumed "
        "(reader's view)",
        ["shard"],
    )

    def flush() -> None:
        pump = getattr(core, "shm_pump", None)
        if pump is None:
            return
        key = (str(shard_id),)
        frames_c.set_key(key, float(pump.frames))
        events_c.set_key(key, float(pump.events))
        depth_g.set_key(key, float(pump.depth()))

    registry.register_pre_expose(flush)


def register_build_metrics(
    registry: Registry, role: str = "front", front=None,
) -> Dict[str, object]:
    """Rolling-upgrade observability (kube_throttler_tpu/version.py).
    ``kube_throttler_build_info`` is a constant-1 gauge whose labels are
    the data — one row for this process (role, build id, protocol it
    speaks) and, when ``front`` is given, one row per shard with the
    hello-negotiated version + capability intersection, so a dashboard
    shows exactly which fleet members still ride the old minor mid-roll.
    The mismatch counter moves when a worker refuses an incompatible
    MAJOR (typed ``VersionMismatch`` — degraded, never a crash loop);
    the backoff gauge samples the supervisor's crash-loop guard (the
    per-shard restart delay, 0 when healthy) via the ``supervisor_ref``
    the supervisor pins on its front."""
    from .version import BUILD_ID, local_proto_version

    build_g = registry.gauge_vec(
        "kube_throttler_build_info",
        "build identity and negotiated wire protocol (value is always "
        "1; the labels carry the data)",
        ["role", "shard", "build", "proto", "caps"],
    )
    mismatch_c = registry.counter_vec(
        "kube_throttler_shard_version_mismatch_total",
        "handshakes the shard refused for an incompatible protocol "
        "MAJOR (typed VersionMismatch refusals)",
        ["shard"],
    )
    backoff_g = registry.gauge_vec(
        "kube_throttler_shard_restart_backoff_seconds",
        "the supervisor crash-loop guard's most recent restart delay "
        "per shard (jittered-exponential; 0 when healthy)",
        ["shard"],
    )
    own_proto = "%d.%d" % local_proto_version()

    def flush() -> None:
        build_g.set_key((role, "", BUILD_ID, own_proto, ""), 1.0)
        if front is None:
            return
        for sid in range(front.n_shards):
            handle = front.shards.get(sid)
            if handle is None:
                continue
            proto = getattr(handle, "negotiated_proto", None)
            caps = getattr(handle, "negotiated_caps", None) or ()
            build_g.set_key(
                (
                    role,
                    str(sid),
                    getattr(handle, "peer_build", None) or "",
                    "" if proto is None else "%d.%d" % tuple(proto),
                    ",".join(sorted(caps)),
                ),
                1.0,
            )
            mismatch_c.set_key(
                (str(sid),), float(getattr(handle, "version_mismatches", 0))
            )
        supervisor = getattr(front, "supervisor_ref", None)
        if supervisor is not None:
            for sid, delay in supervisor.backoff_seconds().items():
                backoff_g.set_key((str(sid),), float(delay))

    registry.register_pre_expose(flush)
    return {"build": build_g, "mismatches": mismatch_c, "backoff": backoff_g}


def register_reshard_metrics(registry: Registry, front) -> Dict[str, object]:
    """Live-resharding observability (sharding/reshard.py drives the
    counters/histogram; the gauge samples the front's transition state at
    scrape time). Ranges-moving > 0 for longer than a handoff SLO means a
    stuck transition — the dual-ring router keeps serving correctly, but
    the fleet is not at its target shape."""
    moving_g = registry.gauge_vec(
        "kube_throttler_reshard_ranges_moving",
        "keyspace ranges currently in flight (mirroring or pending) in a "
        "live reshard; 0 when no transition is active",
        [],
    )
    bytes_c = registry.counter_vec(
        "kube_throttler_reshard_handoff_bytes_total",
        "verified slice bytes streamed source→destination across all "
        "handoffs (the StandbyReplicator chunk contract over IPC)",
        [],
    )
    events_c = registry.counter_vec(
        "kube_throttler_reshard_handoff_events_total",
        "objects (throttles + pods) and ledger entries transferred in "
        "handoff slices",
        [],
    )
    cutover_h = registry.histogram_vec(
        "kube_throttler_reshard_cutover_duration_seconds",
        "per-range fence→activate cutover window (the interval a moving "
        "range's flips ride the re-publication path instead of the live "
        "stream)",
        [],
    )
    aborts_c = registry.counter_vec(
        "kube_throttler_reshard_aborted_total",
        "handoffs aborted back to the source (torn stream, destination "
        "crash, fence race, or TTL reap)",
        [],
    )

    def flush() -> None:
        state = front.reshard_state()
        if state is None:
            moving_g.set({}, 0.0)
        else:
            moving_g.set(
                {}, float(state["pending"]) + float(state["mirroring"])
            )

    registry.register_pre_expose(flush)
    return {
        "moving": moving_g,
        "bytes": bytes_c,
        "events": events_c,
        "cutover": cutover_h,
        "aborts": aborts_c,
    }


def register_ingest_metrics(registry: Registry, pipeline) -> None:
    """Micro-batched ingest observability (engine/ingest.py), exported on
    whatever registry the daemon serves — local standalone and remote mode
    both build their pipeline with the process registry, so the families
    appear on both paths. The batch-size histogram is observed inline by
    the dispatcher (one observe per drain — scrape-time sampling would
    miss the distribution); the events counter moves with it."""
    pipeline._batch_hist = registry.histogram_vec(
        "kube_throttler_ingest_batch_size",
        "events applied per micro-batch drain (1 = the unloaded "
        "single-event path; growth means the adaptive batcher is absorbing "
        "backlog)",
        [],
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
    )
    pipeline._events_ctr = registry.counter_vec(
        "kube_throttler_ingest_events_total",
        "events ingested through the micro-batch pipeline",
        [],
    )


def register_store_metrics(registry: Registry, store) -> None:
    """Columnar arena observability (engine/columnar.py), sampled from the
    arena's counters at scrape time. Slots-live tracks the pod population;
    recycled_total moving means delete churn is reusing slots (no arena
    growth); intern-pool size growing without population growth means
    label/value cardinality is climbing; materializations_total is the
    lazy-edge hydration rate (the whole point of the arena is that this
    stays proportional to API/serialization traffic, not event churn).
    No-op for a frozen-dict reference store (no arena)."""
    arena = getattr(store, "pod_arena", None)
    if arena is None:
        return
    live_g = registry.gauge_vec(
        "kube_throttler_store_arena_slots_live",
        "pods resident in the columnar arena (slots occupied)",
        [],
    )
    recycled_c = registry.counter_vec(
        "kube_throttler_store_arena_slots_recycled_total",
        "arena slots freed by pod deletion and returned to the free list",
        [],
    )
    intern_g = registry.gauge_vec(
        "kube_throttler_store_intern_pool_size",
        "distinct strings in the shared intern pool (names, namespaces, "
        "uids, label keys+values)",
        [],
    )
    mat_c = registry.counter_vec(
        "kube_throttler_store_materializations_total",
        "full API objects built at the lazy serialization/API edge",
        [],
    )

    def flush() -> None:
        live_g.set_key((), float(len(arena)))
        recycled_c.set_key((), float(arena.recycled_total))
        intern_g.set_key((), float(len(arena.pool)))
        mat_c.set_key((), float(arena.materializations_total))

    registry.register_pre_expose(flush)


def register_verdict_cache_metrics(registry: Registry, cache) -> None:
    """Interned-verdict cache observability (engine/verdictcache.py),
    sampled from the cache's racy counters at scrape time. Hit-rate
    (hits / (hits+misses)) is the serving tier's primary health signal:
    a collapse under steady traffic means epoch churn is outrunning the
    degenerate-shape assumption. Entries is bounded by the configured
    capacity; invalidations counts explicit full drops (policy swaps),
    not epoch-superseded entries (those die silently by construction)."""
    if cache is None:
        return
    hits_c = registry.counter_vec(
        "kube_throttler_verdict_cache_hits_total",
        "pre_filter verdicts served straight from the interned-verdict cache",
        [],
    )
    miss_c = registry.counter_vec(
        "kube_throttler_verdict_cache_misses_total",
        "cache probes that fell through to a full plane walk "
        "(cold key, epoch-superseded entry, or uncacheable verdict)",
        [],
    )
    entries_g = registry.gauge_vec(
        "kube_throttler_verdict_cache_entries",
        "live entries across both cache generations (bounded by capacity)",
        [],
    )
    inval_c = registry.counter_vec(
        "kube_throttler_verdict_cache_invalidations_total",
        "explicit whole-cache invalidation sweeps (policy hot-swaps, "
        "replica re-bootstraps) — epoch-superseded entries are not counted",
        [],
    )

    def flush() -> None:
        hits, misses, entries, invalidations, _ = cache.stats()
        hits_c.set_key((), float(hits))
        miss_c.set_key((), float(misses))
        entries_g.set_key((), float(entries))
        inval_c.set_key((), float(invalidations))

    registry.register_pre_expose(flush)


def register_replica_metrics(registry: Registry, gate) -> None:
    """Read-replica serving observability (engine/replication.py
    ReplicaGate), sampled at scrape time. Verdicts are labeled by outcome
    ("served" vs "refused") so the SLO dashboard reads refusal-rate
    directly; lag_events counts requests refused for breaching the
    staleness bound; lag_seconds is the replica's current journal-tail
    age (the quantity the bound is enforced against)."""
    verdicts_c = registry.counter_vec(
        "kube_throttler_replica_verdicts_total",
        "pre_filter verdicts handled by this read replica",
        ["outcome"],
    )
    lag_events_c = registry.counter_vec(
        "kube_throttler_replica_lag_events_total",
        "serving refusals because replication lag exceeded the staleness bound",
        [],
    )
    lag_g = registry.gauge_vec(
        "kube_throttler_replica_lag_seconds",
        "seconds since the replica last confirmed it was caught up with "
        "the leader's journal tail",
        [],
    )

    def flush() -> None:
        verdicts_c.set_key(("served",), float(gate.served_total))
        verdicts_c.set_key(("refused",), float(gate.refused_total))
        lag_events_c.set_key((), float(gate.lag_events_total))
        lag_g.set_key((), float(gate.current_lag()))

    registry.register_pre_expose(flush)


def register_watch_metrics(registry: Registry) -> None:
    """Watch-queue depth/overflow families, fed at scrape time from the
    Watch class aggregates (client/watch.py): queue depth climbing means a
    consumer is falling behind; the overflow counter moving means events
    were shed and that consumer must relist."""
    from .client.watch import Watch

    open_g = registry.gauge_vec(
        "kube_throttler_watch_streams_open", "live Watch streams", []
    )
    depth_g = registry.gauge_vec(
        "kube_throttler_watch_queue_depth",
        "events queued across live Watch streams (slow-consumer lag)",
        [],
    )
    dropped_c = registry.counter_vec(
        "kube_throttler_watch_overflow_total",
        "events shed by bounded Watch queues (drop-oldest policy); a "
        "consumer that overflowed has a gap and must relist",
        [],
    )

    def flush() -> None:
        stats = Watch.stats()
        open_g.set_key((), float(stats["open"]))
        depth_g.set_key((), float(stats["depth"]))
        # the class-level total is already monotonic: expose it directly
        dropped_c.set_key((), float(stats["dropped_total"]))

    registry.register_pre_expose(flush)


class ThrottleMetricsRecorder:
    """throttle_metrics.go:94-197. The registry is explicit — there is no
    module-global default, so recorded series are always reachable from
    whatever serves that registry's /metrics."""

    def __init__(self, registry: Registry):
        self._rec = _KindRecorder(
            "throttle", ("namespace", "name", "uid", "resource"), registry
        )

    def record(self, thr: Throttle) -> None:
        self._rec.record(
            {"namespace": thr.namespace, "name": thr.name, "uid": thr.uid}, thr
        )


class ClusterThrottleMetricsRecorder:
    """clusterthrottle_metrics.go:224-326."""

    def __init__(self, registry: Registry):
        self._rec = _KindRecorder(
            "clusterthrottle", ("name", "uid", "resource"), registry
        )

    def record(self, thr: ClusterThrottle) -> None:
        self._rec.record({"name": thr.name, "uid": thr.uid}, thr)
