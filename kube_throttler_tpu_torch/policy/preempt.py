"""PreemptionCoordinator: journaled, gang-atomic victim eviction.

The scheduler calls :meth:`preempt_for_gang` when ``pre_filter_gang``
rejected a group for capacity (scheduler.py ``_schedule_gang``). One cycle:

1. **Policy gate** — the active :class:`~..policy.spec.PolicySpec` must
   enable preemption, the preemptor's priority must be positive, and the
   group must be outside its cooldown window (the anti-thrash floor the
   preemption-storm scenario gates on).
2. **Deficits** — ``compute_gang_deficits``: the exact per-(kind,
   throttle, dim) capacity shortfalls, accel-class-resolved. None ⇒ the
   group can never fit (a member alone exceeds a threshold) — no victim
   set helps, nothing is evicted.
3. **Candidates** — running (count-in, non-finished) pods matched to a
   deficit throttle whose priority sits at least ``min_priority_gap``
   below the preemptor's, grouped into eviction units (a gang member
   drags its whole gang — no half-evicted gangs by construction), ranked
   (weight asc, priority asc, age desc).
4. **Selection** — the batched kernel (ops/victim_select.py) when a
   device manager is wired (``KT_PREEMPT_DEVICE=0`` forces the host
   path), else the sequential oracle; both walk the identical ranked
   arrays, so the choice is a performance knob, never a semantic one.
   If even the full eligible set cannot cover the deficits, NOTHING is
   evicted (counted ``infeasible``): partial eviction would churn victims
   without admitting the group.
5. **Eviction** — journal ``PREEMPT begin`` (victim keys + serialized
   objects: the crash-rollback payload), roll back victim gangs' ledger
   records, then delete each victim pod through the store
   (delete-then-requeue: the DELETED events free node occupancy, drop
   used sums, and the flip-candidate promotion publishes the freed-
   capacity flips through the priority lane first), then ``PREEMPT
   commit``. A crash between begin and commit rolls back to ZERO
   evictions at recovery (engine/journal.py ``rollback_uncommitted_
   preempts`` re-creates the victims from the begin line), mirroring the
   GANG contract; a live mid-eviction exception restores the already-
   deleted victims and stamps ``rollback``. The SIGKILL instant is
   ``crash.preempt.partial_evict`` (tools/crashtest.py).

The coordinator also tracks admission ages (the rank's age axis) and the
evicted-then-readmitted churn counter — both gated on preemption being
enabled so a policy-less daemon pays one cached-flag check per pod event
and retains ZERO per-pod state (the columnar-store memory posture).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.pod import Pod, accel_class_of, pod_group_of, priority_of
from ..engine.store import EventType
from ..faults.plan import maybe_crash
from ..utils.lockorder import guard_attrs, make_lock
from ..utils.tracing import vlog
from .spec import PolicyEngine
from .victims import (
    EvictionUnit,
    build_selection_problem,
    compute_gang_deficits,
    rank_eviction_units,
    sequential_victim_select,
)

logger = logging.getLogger(__name__)

# re-check the cached preemption-enabled flag at most every N pod events
# (plus on every policy generation bump) — time-window activation flips
# are observed within one stride without paying an active() per event
_ENABLED_PROBE_STRIDE = 1024


def _next_pow2(n: int, lo: int = 8) -> int:
    v = lo
    while v < n:
        v <<= 1
    return v


@guard_attrs
class PreemptionCoordinator:
    """One per plugin. Thread-safety: the maps below move under the
    coordinator lock, taken only for short map operations — NEVER across
    store calls (store dispatch re-enters :meth:`on_pod_event`, which
    takes the same lock). Counters are single-writer ints read by
    metrics/tests (the ledger stance)."""

    GUARDED_BY = {
        "_admitted_at": "self._lock",
        "_recent_evictions": "self._lock",
        "_last_attempt": "self._lock",
    }

    READMIT_WINDOW_S = 60.0

    def __init__(
        self,
        policy: PolicyEngine,
        kind_controllers: Sequence[Tuple[str, object]],
        store=None,
        gang_ledger=None,
        journal=None,
        faults=None,
        evict_fn: Optional[Callable[[Pod], None]] = None,
        device_manager=None,
    ):
        self.policy = policy
        self.kind_controllers = tuple(kind_controllers)
        self.store = store
        self.gang_ledger = gang_ledger
        # late-bound by the CLI in standalone mode, like the gang ledger's
        self.journal = journal
        self.faults = faults
        self.device_manager = device_manager
        self._evict_fn = evict_fn
        self._lock = make_lock("policy.preempt")
        self._admitted_at: Dict[str, float] = {}  # pod key → monotonic bind time
        self._recent_evictions: Dict[str, float] = {}  # pod key → eviction time
        self._last_attempt: Dict[str, float] = {}  # group key → last cycle time
        self._seq = 0  # preempt-id counter (single-writer: scheduler thread)
        # cached policy gate for the hot pod-event path
        self._enabled_cache = (None, 0, False)  # (generation, countdown, enabled)
        # single-writer counters (metrics/tests read these)
        self.cycles_total = 0
        self.victims_total = 0
        self.infeasible_total = 0
        self.disabled_total = 0
        self.cooldown_skipped_total = 0
        self.rolled_back_total = 0
        self.readmitted_total = 0
        # select-latency histogram (metrics.register_preempt_metrics)
        self.select_hist = None

    # -- pod-event tracking (ages + readmit churn) -------------------------

    def _tracking_enabled(self) -> bool:
        gen = self.policy.generation
        cached_gen, countdown, enabled = self._enabled_cache
        if cached_gen == gen and countdown > 0:
            self._enabled_cache = (cached_gen, countdown - 1, enabled)
            return enabled
        enabled = self.policy.active().preemption_enabled
        self._enabled_cache = (gen, _ENABLED_PROBE_STRIDE, enabled)
        if not enabled:
            # a policy swap back to disabled must not strand per-pod state
            with self._lock:
                if self._admitted_at:
                    self._admitted_at.clear()
        return enabled

    def on_pod_event(self, event) -> None:
        """Store Pod-event hook (runs under the store lock — keep tiny).
        Records admission (bind) times for the rank's age axis and counts
        evicted-then-readmitted churn; both only while the active policy
        enables preemption, so a policy-less daemon retains zero per-pod
        state here."""
        if not self._tracking_enabled():
            return
        pod = event.obj
        now = time.monotonic()
        with self._lock:
            if event.type == EventType.DELETED:
                self._admitted_at.pop(pod.key, None)
                return
            if pod.is_scheduled() and pod.is_not_finished():
                self._admitted_at.setdefault(pod.key, now)
            ts = self._recent_evictions.get(pod.key)
            if ts is not None and event.type == EventType.ADDED:
                self._recent_evictions.pop(pod.key, None)
                if now - ts <= self.READMIT_WINDOW_S:
                    self.readmitted_total += 1

    # -- candidate gathering -----------------------------------------------

    def _gather_units(
        self,
        deficits,
        member_keys: set,
        preemptor_priority: int,
        spec,
    ) -> List[EvictionUnit]:
        units: Dict[str, EvictionUnit] = {}
        seen: set = set()  # (pod_key, kind, throttle_key) contrib dedupe
        now = time.monotonic()
        with self._lock:
            admitted_at = dict(self._admitted_at)
        ctr_by_kind = dict(self.kind_controllers)
        for kind, tkey in sorted({(k, t) for (k, t, _dim) in deficits}):
            ctr = ctr_by_kind[kind]
            try:
                thr = ctr.throttle_by_key(tkey)
            except Exception:
                continue  # deleted under us: its deficit keys stay unmet
            running, _ = ctr.affected_pods(thr)
            for pod in running:
                if pod.key in member_keys:
                    continue
                prio = priority_of(pod)
                if prio + spec.min_priority_gap > preemptor_priority:
                    continue
                group = pod_group_of(pod)
                unit_key = f"gang:{group.key}" if group is not None else pod.key
                unit = units.get(unit_key)
                if unit is None:
                    unit = EvictionUnit(
                        unit_key=unit_key,
                        pods=(),
                        priority=prio,
                        weight=spec.weight_for(accel_class_of(pod)),
                        age_s=-1.0,
                        gang_key=group.key if group is not None else None,
                    )
                    units[unit_key] = unit
                if pod.key not in {p.key for p in unit.pods}:
                    unit.pods = unit.pods + (pod,)
                    unit.priority = max(unit.priority, prio)
                    unit.weight = max(
                        unit.weight, spec.weight_for(accel_class_of(pod))
                    )
                    bound = admitted_at.get(pod.key)
                    age = float("inf") if bound is None else now - bound
                    # a unit ranks as its OLDEST member (age desc)
                    unit.age_s = age if unit.age_s < 0 else max(unit.age_s, age)
                if (pod.key, kind, tkey) not in seen:
                    seen.add((pod.key, kind, tkey))
                    unit.add_pod_contrib(kind, tkey, pod)
        for unit in units.values():
            if unit.age_s < 0:
                unit.age_s = float("inf")
        return rank_eviction_units(units.values())

    # -- selection ----------------------------------------------------------

    def _select(self, deficit: np.ndarray, contrib: np.ndarray, max_victims: int):
        """Kernel when a device manager is wired (padded shapes, on the
        manager's device), host oracle otherwise — identical ranked arrays,
        pinned-equal semantics. A kernel that fails to launch raises
        (``KernelLaunchError``): the host oracle never stands in for it."""
        use_device = (
            self.device_manager is not None
            and os.environ.get("KT_PREEMPT_DEVICE", "1") != "0"
        )
        if use_device and deficit.size:
            from ..ops.victim_select import victim_select

            n, m = contrib.shape
            np_pad = _next_pow2(max(n, 1))
            mp_pad = _next_pow2(max(m, 1), lo=4)
            contrib_p = np.zeros((np_pad, mp_pad), dtype=np.int64)
            contrib_p[:n, :m] = contrib
            deficit_p = np.zeros(mp_pad, dtype=np.int64)
            deficit_p[:m] = deficit
            dev = self.device_manager.device
            selected, ok, _remaining = victim_select(
                torch.from_numpy(contrib_p).to(dev), torch.from_numpy(deficit_p).to(dev),
                max_victims=max_victims,
            )
            sel = selected.cpu().numpy()[:n]
            return bool(ok.cpu()), list(np.nonzero(sel)[0])
        ok, selected, _remaining = sequential_victim_select(
            deficit, contrib, max_victims=max_victims
        )
        return ok, selected

    # -- the cycle -----------------------------------------------------------

    def preempt_for_gang(
        self, group_key: str, members: Sequence[Pod], mono: Optional[float] = None
    ) -> Dict:
        """One preemption cycle for a capacity-rejected group. Returns a
        report dict; ``report["evicted"]`` > 0 means victims were removed
        and the scheduler should simply park — the deletes fire requeue
        hints and the next cycle admits the group."""
        report = {"evicted": 0, "victims": [], "reason": ""}
        spec = self.policy.active()
        preemptor_priority = max((priority_of(m) for m in members), default=0)
        if not spec.preemption_enabled or preemptor_priority <= 0:
            self.disabled_total += 1
            report["reason"] = "disabled"
            return report
        now = time.monotonic() if mono is None else mono
        with self._lock:
            last = self._last_attempt.get(group_key)
            if (
                last is not None
                and spec.preempt_cooldown_s > 0
                and now - last < spec.preempt_cooldown_s
            ):
                in_cooldown = True
            else:
                in_cooldown = False
                self._last_attempt[group_key] = now
        if in_cooldown:
            self.cooldown_skipped_total += 1
            report["reason"] = "cooldown"
            return report

        t0 = time.monotonic()
        try:
            deficits = compute_gang_deficits(members, self.kind_controllers)
            if deficits is None:
                self.infeasible_total += 1
                report["reason"] = "member-exceeds-threshold"
                return report
            if not deficits:
                report["reason"] = "no-capacity-deficit"
                return report
            member_keys = {m.key for m in members}
            units = self._gather_units(
                deficits, member_keys, preemptor_priority, spec
            )
            if not units:
                self.infeasible_total += 1
                report["reason"] = "no-eligible-victims"
                return report
            _dims, deficit, contrib = build_selection_problem(deficits, units)
            ok, selected = self._select(
                deficit, contrib, spec.max_victims_per_cycle
            )
            if not ok:
                # evicting everything eligible still would not admit the
                # group: evict NOTHING (churn without admission is the
                # thrash the storm scenario gates against)
                self.infeasible_total += 1
                report["reason"] = "insufficient-victims"
                return report
            victims = [units[i] for i in selected]
        finally:
            if self.select_hist is not None:
                self.select_hist.observe_key((), time.monotonic() - t0)

        evicted = self._execute_eviction(group_key, victims, now)
        report["evicted"] = len(evicted)
        report["victims"] = evicted
        report["reason"] = "evicted" if evicted else "eviction-failed"
        return report

    # -- eviction ------------------------------------------------------------

    def _expand_gang_pods(self, unit: EvictionUnit) -> List[Pod]:
        """Whole-gang expansion at eviction time: every running member of
        the victim's gang, not just the ones matched to deficit throttles
        — half-evicted gangs are the exact stranded-capacity shape gang
        admission exists to prevent."""
        if unit.gang_key is None or self.store is None:
            return list(unit.pods)
        namespace = unit.gang_key.partition("/")[0]
        out: Dict[str, Pod] = {p.key: p for p in unit.pods}
        for pod in self.store.list_pods(namespace):
            g = pod_group_of(pod)
            if (
                g is not None
                and g.key == unit.gang_key
                and pod.is_scheduled()
                and pod.is_not_finished()
            ):
                out.setdefault(pod.key, pod)
        return list(out.values())

    def _evict(self, pod: Pod) -> None:
        if self._evict_fn is not None:
            self._evict_fn(pod)
        elif self.store is not None:
            self.store.delete_pod(pod.namespace, pod.name)
        else:
            raise RuntimeError("preemption coordinator has no eviction path")

    def execute_eviction(
        self, preempt_id: str, victim_pods: Sequence[Pod], gang_keys: Sequence[str] = ()
    ) -> List[str]:
        """The journaled eviction sequence, exposed for the crash harness:
        PREEMPT begin (victims + serialized objects) → gang-ledger
        rollbacks → per-victim delete (``crash.preempt.partial_evict``
        fires per delete) → PREEMPT commit. A live exception mid-sequence
        restores the already-deleted victims and stamps rollback — zero
        evictions either way, the GANG contract's mirror."""
        from ..api.serialization import object_to_dict

        victim_pods = list(victim_pods)
        keys = [p.key for p in victim_pods]
        if self.journal is not None:
            self.journal.append_preempt(
                "begin",
                preempt_id,
                victims=keys,
                objects=[object_to_dict(p) for p in victim_pods],
            )
        if self.gang_ledger is not None:
            for gk in gang_keys:
                try:
                    self.gang_ledger.rollback_group(gk, "preempted")
                except Exception:  # pragma: no cover — ledger rollback is total
                    logger.exception("gang %s: preemption rollback failed", gk)
        deleted: List[Pod] = []
        try:
            for pod in victim_pods:
                # the mid-eviction SIGKILL instant the crash matrix drives:
                # some victims deleted, the commit line never lands
                maybe_crash(self.faults, "crash.preempt.partial_evict")
                self._evict(pod)
                deleted.append(pod)
        except Exception:
            logger.exception(
                "preempt %s: eviction failed after %d/%d victim(s); restoring",
                preempt_id, len(deleted), len(victim_pods),
            )
            for pod in deleted:
                try:
                    if self.store is not None:
                        self.store.create_pod(pod)
                except Exception:  # pragma: no cover — restore is best effort
                    logger.exception("preempt %s: restore of %s failed", preempt_id, pod.key)
            if self.journal is not None:
                self.journal.append_preempt("rollback", preempt_id)
            self.rolled_back_total += 1
            return []
        if self.journal is not None:
            self.journal.append_preempt("commit", preempt_id)
        return keys

    def _execute_eviction(self, group_key: str, victims, now: float) -> List[str]:
        self._seq += 1
        preempt_id = f"{group_key}#{self._seq}"
        victim_pods: List[Pod] = []
        gang_keys: List[str] = []
        for unit in victims:
            if unit.gang_key is not None:
                gang_keys.append(unit.gang_key)
                victim_pods.extend(self._expand_gang_pods(unit))
            else:
                victim_pods.extend(unit.pods)
        with self._lock:
            for pod in victim_pods:
                self._recent_evictions[pod.key] = now
            # bound the churn map: entries outside the window carry no signal
            if len(self._recent_evictions) > 4096:
                floor = now - self.READMIT_WINDOW_S
                self._recent_evictions = {
                    k: t for k, t in self._recent_evictions.items() if t >= floor
                }
        evicted = self.execute_eviction(preempt_id, victim_pods, gang_keys)
        if evicted:
            self.cycles_total += 1
            self.victims_total += len(evicted)
            vlog(
                2,
                "preempt %s: evicted %d victim(s) (%d gang(s)) for group %s",
                preempt_id, len(evicted), len(gang_keys), group_key,
            )
        return evicted
