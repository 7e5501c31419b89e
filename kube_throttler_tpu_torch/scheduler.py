"""Embedded scheduler loop — the analog of the reference's in-binary
kube-scheduler (cmd/kube_scheduler.go:90-106 registers the plugin into the
upstream scheduler app; integration tests then run `scheduler.Setup +
go scheduler.Run` in-process, integration_suite_test.go:87-138).

The framework is standalone, so this module supplies the scheduling loop
the plugin plugs into:

- a pending queue (active / backoff / unschedulable, mirroring the
  scheduler's three-queue structure);
- ``schedule_one``: pop → PreFilter → pick node → Reserve → bind
  (write ``spec.nodeName`` back through the store) → Unreserve on failure;
- event-driven requeue per the plugin's ``EventsToRegister`` hints
  (plugin.go:263-279): Throttle/ClusterThrottle/Pod/Node changes move
  unschedulable pods back to the active queue, subject to per-pod
  exponential backoff (the reference integration suite pokes a Node to
  force exactly this wakeup, util_pod_test.go:206-225);
- ``FailedScheduling`` Warning events with the plugin's reason string, the
  same observable the reference's tests assert on (util_pod_test.go:156-180).

Binding sets only ``spec.nodeName`` (phase stays Pending) — that is the
reference's ``shouldCountIn`` trigger (scheduled ∧ not finished,
pod_util.go:300-306), so a bound pod immediately counts into
``status.used`` at the next reconcile and its reservation is released by
the unreserve-on-observe handshake.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from .api.pod import Pod, PodGroup, pod_group_of, priority_of
from .quantity import parse_quantity
from .resourcelist import add as rl_add, pod_request_resource_list, sub as rl_sub
from .utils.lockorder import assert_held, guard_attrs, make_condition, make_lock
from .utils.tracing import vlog
from .engine.store import Event, EventType, Store
from .plugin.plugin import KubeThrottler

logger = logging.getLogger(__name__)


@dataclass
class Node:
    """Node model: pod-count capacity (the integration fixture is one node
    with max-pods 300 — hack/integration/kind.conf) plus optional
    allocatable resources. With ``allocatable`` set, binding also requires
    the pod's effective requests to fit the remaining capacity per declared
    dimension (the NodeResourcesFit analog of the embedded kube-scheduler
    the reference relies on); a NONZERO request for an undeclared resource
    never fits (zero requests are skipped, as NodeResourcesFit does).
    ``allocatable=None`` keeps the resource-blind behavior."""

    name: str
    max_pods: int = 300
    allocatable: Optional[Dict[str, str]] = None


@dataclass
class _QueuedPod:
    key: str
    attempts: int = 0
    not_before: float = 0.0  # monotonic gate for backoff
    # preemption-ordered admission (docs/gang_admission.md): when capacity
    # opens, eligible candidates are drained highest priority first, ties
    # oldest first — not in arbitrary queue order
    priority: int = 0
    enqueued_at: float = 0.0  # monotonic first-enqueue time (the age tiebreak)


@guard_attrs
class Scheduler:
    """Single-threaded scheduling loop over the store's pending pods.

    Synchronous driving (tests/examples): ``run_until_idle()``.
    Daemon mode: ``start()`` spawns the loop thread; ``stop()`` joins it.
    """

    FAILED_SCHEDULING = "FailedScheduling"

    # queue state and node-occupancy ledgers move only under the single
    # scheduler lock (always taken through the `_cv` condition over it)
    GUARDED_BY = {
        "_active": "self._cv",
        "_unschedulable": "self._cv",
        "_queued_keys": "self._cv",
        "_wake_gen": "self._cv",
        "_bound_per_node": "self._cv",
        "_alloc_used": "self._cv",
    }

    def __init__(
        self,
        plugin: KubeThrottler,
        store: Store,
        nodes: Optional[List[Node]] = None,
        backoff_base: float = 0.05,
        backoff_max: float = 5.0,
    ) -> None:
        self.plugin = plugin
        self.store = store
        self.nodes = list(nodes) if nodes else [Node("node-1")]
        self._bound_per_node: Dict[str, int] = {n.name: 0 for n in self.nodes}
        # resource accounting (only maintained/consulted for nodes that
        # declare allocatable — the default path stays Fraction-free)
        self._alloc_cap = {
            n.name: (
                {r: parse_quantity(v) for r, v in n.allocatable.items()}
                if n.allocatable is not None
                else None
            )
            for n in self.nodes
        }
        self._alloc_used: Dict[str, Dict] = {n.name: {} for n in self.nodes}
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max

        self._lock = make_lock("scheduler")
        self._cv = make_condition(self._lock)
        self._active: List[_QueuedPod] = []
        self._unschedulable: Dict[str, _QueuedPod] = {}
        self._queued_keys: set = set()
        # bumped on every requeue hint; a cycle that started before the bump
        # re-queues to active instead of parking (closes the window where a
        # wake lands while its pod is popped but not yet parked)
        self._wake_gen = 0
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

        target = plugin.args.target_scheduler_name
        self._target = target

        # node occupancy is driven ENTIRELY by pod events (replay covers
        # pre-existing pods): a pod occupies a node slot while bound and not
        # finished; deletes and terminal phases free the slot. schedule_one
        # does NOT increment directly — its bind write's MODIFIED event does,
        # synchronously on the same thread, so there is no double count.
        store.add_event_handler("Pod", self._on_pod_event, replay=True)
        # EventsToRegister: throttle/clusterthrottle/namespace changes retry
        # unschedulable pods (plugin.go:263-279; Node changes would too, but
        # nodes live outside the store — poke_nodes() covers that hint)
        for kind in ("Throttle", "ClusterThrottle", "Namespace"):
            store.add_event_handler(kind, self._on_cluster_event, replay=False)

    # -- queue management --------------------------------------------------

    def _track_usage_locked(self, node_name: Optional[str], pod: Optional[Pod], sign: int) -> None:
        """Adjust a node's used-resources ledger — no-op for resource-blind
        nodes, keeping the hot event path free of Fraction work."""
        assert_held(self._lock, "Scheduler._track_usage_locked")
        if pod is None or node_name is None or self._alloc_cap.get(node_name) is None:
            return
        (rl_add if sign > 0 else rl_sub)(
            self._alloc_used[node_name], pod_request_resource_list(pod)
        )

    def _is_schedulable_target(self, pod: Pod) -> bool:
        # reads only immutable-after-init config (self._target) + the pod —
        # deliberately callable with or without the scheduler lock
        return (
            pod.spec.scheduler_name == self._target
            and not pod.is_scheduled()
            and pod.is_not_finished()
        )

    def _occupies_node_locked(self, pod: Optional[Pod]) -> Optional[str]:
        """Node name this pod holds a slot on, or None."""
        assert_held(self._lock, "Scheduler._occupies_node_locked")
        if pod is None or not pod.is_scheduled() or not pod.is_not_finished():
            return None
        return pod.spec.node_name if pod.spec.node_name in self._bound_per_node else None

    def _on_pod_event(self, event: Event) -> None:
        pod = event.obj
        if event.type == EventType.DELETED:
            with self._cv:
                freed = self._occupies_node_locked(pod)
                if freed is not None:
                    self._bound_per_node[freed] -= 1
                    self._track_usage_locked(freed, pod, -1)
                self._queued_keys.discard(pod.key)
                self._unschedulable.pop(pod.key, None)
                self._active = [q for q in self._active if q.key != pod.key]
            # a delete frees node capacity and throttle usage — it is a
            # requeue hint like any other Pod event (EventsToRegister)
            self._wake_unschedulable()
            return
        if event.type == EventType.ADDED:
            with self._cv:
                held = self._occupies_node_locked(pod)
                if held is not None:
                    self._bound_per_node[held] += 1
                    self._track_usage_locked(held, pod, +1)
                elif self._is_schedulable_target(pod) and pod.key not in self._queued_keys:
                    self._queued_keys.add(pod.key)
                    self._active.append(
                        _QueuedPod(
                            pod.key,
                            priority=priority_of(pod),
                            enqueued_at=time.monotonic(),
                        )
                    )
                    self._cv.notify_all()
            # a new pod is a requeue hint too (EventsToRegister lists Pod
            # events): a parked gang member may only need this arrival to
            # complete its group
            self._wake_unschedulable()
            return
        # MODIFIED: adjust occupancy for bind/unbind/termination transitions
        # AND in-place request edits (same node, different requests), then
        # treat the change as a requeue hint for unschedulable pods
        new_priority = priority_of(pod)
        priority_changed = (
            event.old_obj is None or priority_of(event.old_obj) != new_priority
        )
        with self._cv:
            before = self._occupies_node_locked(event.old_obj)
            after = self._occupies_node_locked(pod)
            if before != after:
                if before is not None:
                    self._bound_per_node[before] -= 1
                if after is not None:
                    self._bound_per_node[after] += 1
            self._track_usage_locked(before, event.old_obj, -1)
            self._track_usage_locked(after, pod, +1)
            if priority_changed and pod.key in self._queued_keys:
                # stale-priority requeue fix: a priority-annotation update
                # re-orders already-queued work — candidate selection reads
                # the queued entry's priority, so rewrite it in place (the
                # workqueue hi lane re-orders the same way)
                for q in self._active:
                    if q.key == pod.key:
                        q.priority = new_priority
                        break
                parked = self._unschedulable.get(pod.key)
                if parked is not None:
                    parked.priority = new_priority
        self._wake_unschedulable()

    def _on_cluster_event(self, event: Event) -> None:
        self._wake_unschedulable()

    def _wake_unschedulable(self) -> None:
        with self._cv:
            # bump even when nothing is parked: a mid-cycle pod checks this
            # generation before parking itself
            self._wake_gen += 1
            if not self._unschedulable:
                return
            for q in self._unschedulable.values():
                self._active.append(q)
            self._unschedulable.clear()
            self._cv.notify_all()

    def poke_nodes(self) -> None:
        """The Node-change requeue hint (the reference tests' WakeupBackoffPod
        node-poke, util_pod_test.go:206-225)."""
        self._wake_unschedulable()

    def _backoff_for(self, attempts: int) -> float:
        return min(self._backoff_base * (2 ** max(attempts - 1, 0)), self._backoff_max)

    # -- the scheduling cycle ---------------------------------------------

    def _fits_resources_locked(self, node: Node, req) -> bool:
        """NodeResourcesFit: every requested dimension must be declared in
        the node's allocatable and leave headroom. Resource-blind when the
        node declares no allocatable."""
        assert_held(self._lock, "Scheduler._fits_resources_locked")
        cap = self._alloc_cap[node.name]
        if cap is None:
            return True
        used = self._alloc_used[node.name]
        for resource, q in req.items():
            if q == 0:
                continue  # NodeResourcesFit skips zero requests
            limit = cap.get(resource)
            if limit is None or used.get(resource, 0) + q > limit:
                return False
        return True

    def _pick_node(self, pod: Pod) -> Optional[Node]:
        req = pod_request_resource_list(pod)
        with self._cv:
            for node in self.nodes:
                if self._bound_per_node[node.name] < node.max_pods and self._fits_resources_locked(
                    node, req
                ):
                    return node
        return None

    def schedule_one(self, now: Optional[float] = None) -> Optional[str]:
        """Run one scheduling cycle. Returns the bound pod's key (a gang
        cycle returns the triggering member's key after binding the whole
        group), or None if nothing was schedulable (queue empty or all
        gated by backoff).

        Candidate selection is preemption-ordered: among backoff-eligible
        queued pods, highest priority first, ties oldest-first — so when
        capacity opens the drain order is (priority, age), not whatever
        order the queue happened to accumulate."""
        now = time.monotonic() if now is None else now
        with self._cv:
            idx = None
            best = None
            for i, q in enumerate(self._active):
                if q.not_before > now:
                    continue
                rank = (-q.priority, q.enqueued_at)
                if best is None or rank < best:
                    best = rank
                    idx = i
            if idx is None:
                return None
            queued = self._active.pop(idx)
            gen = self._wake_gen
        try:
            pod = self.store.get_pod(*queued.key.split("/", 1))
        except KeyError:
            with self._cv:
                self._queued_keys.discard(queued.key)
            return None
        if not self._is_schedulable_target(pod):
            with self._cv:
                self._queued_keys.discard(queued.key)
            return None

        queued.attempts += 1
        group = pod_group_of(pod)
        if group is not None:
            return self._schedule_gang(queued, pod, group, now, gen)
        status = self.plugin.pre_filter(pod)
        if not status.is_success():
            self._record_failed_scheduling(pod, status.message())
            self._park(queued, now, gen)
            return None

        node = self._pick_node(pod)
        if node is None:
            self._record_failed_scheduling(pod, "0/%d nodes are available" % len(self.nodes))
            self._park(queued, now, gen)
            return None

        reserve_status = self.plugin.reserve(pod, node.name)
        if not reserve_status.is_success():
            self.plugin.unreserve(pod, node.name)
            self._park(queued, now, gen)
            return None

        try:
            # atomic bind: set ONLY spec.nodeName on the store's current
            # object (the bind-subresource analog) — a whole-object write of
            # the pod read at cycle start would revert any patch that landed
            # mid-cycle. Occupancy increments via the write's MODIFIED event.
            self.store.mutate(
                "Pod",
                pod.key,
                lambda cur: replace(cur, spec=replace(cur.spec, node_name=node.name)),
            )
        except Exception:
            logger.exception("bind failed for %s", pod.key)
            self.plugin.unreserve(pod, node.name)
            self._park(queued, now, gen)
            return None

        with self._cv:
            self._queued_keys.discard(queued.key)
        vlog(3, "scheduled %s -> %s", pod.key, node.name)
        return pod.key

    # -- gang scheduling ---------------------------------------------------

    def _gang_members(self, group: PodGroup, namespace: str) -> List[Pod]:
        """Pending schedulable members of ``group`` in ``namespace``,
        name-sorted for a deterministic admission set."""
        members = [
            p
            for p in self.store.list_pods(namespace)
            if self._is_schedulable_target(p)
            and (g := pod_group_of(p)) is not None
            and g.key == group.key
        ]
        members.sort(key=lambda p: p.name)
        return members

    def _pick_nodes_for(self, pods: List[Pod]) -> Optional[List[Node]]:
        """Greedy all-members placement with TENTATIVE occupancy: either
        every member gets a node (respecting max-pods and declared
        allocatable against the members placed before it) or the whole
        placement fails — the node-capacity half of all-or-nothing.

        Rank-aware contiguity (policy.rankAwarePlacement, on by default —
        the MPI-locality hint of docs/policy.md): the node list IS the
        topology order (racks/hosts enumerate adjacently), so each rank
        prefers its predecessor's node, then the nearest index, among the
        FEASIBLE nodes only. Feasibility is unchanged — a gang that fit
        under first-fit still fits here; what changes is that a multi-host
        gang stops fragmenting across distant nodes when a near one has
        room. Rank 0 (and the scoring-off path) keeps the original
        lowest-index first-fit."""
        rank_aware = self._placement_rank_aware()
        node_idx = {n.name: i for i, n in enumerate(self.nodes)}
        with self._cv:
            counts = dict(self._bound_per_node)
            used = {
                name: dict(self._alloc_used[name])
                for name, cap in self._alloc_cap.items()
                if cap is not None
            }
            out: List[Node] = []
            prev_idx: Optional[int] = None
            for pod in pods:
                req = pod_request_resource_list(pod)
                chosen = None
                best_score = None
                for node in self.nodes:
                    if counts[node.name] >= node.max_pods:
                        continue
                    cap = self._alloc_cap[node.name]
                    if cap is not None:
                        u = used[node.name]
                        if any(
                            q != 0
                            and (cap.get(r) is None or u.get(r, 0) + q > cap[r])
                            for r, q in req.items()
                        ):
                            continue
                    if not rank_aware or prev_idx is None:
                        chosen = node
                        break  # original first-fit
                    idx = node_idx[node.name]
                    score = (0 if idx == prev_idx else 1, abs(idx - prev_idx), idx)
                    if best_score is None or score < best_score:
                        best_score = score
                        chosen = node
                if chosen is None:
                    return None
                counts[chosen.name] += 1
                if self._alloc_cap[chosen.name] is not None:
                    rl_add(used[chosen.name], req)
                out.append(chosen)
                prev_idx = node_idx[chosen.name]
            return out

    def _placement_rank_aware(self) -> bool:
        """The active policy's rankAwarePlacement knob (docs/policy.md) —
        True when the plugin carries no policy engine (the default spec's
        value)."""
        policy = getattr(self.plugin, "policy", None)
        if policy is None:
            return True
        try:
            return bool(policy.active().rank_aware_placement)
        except Exception:  # pragma: no cover — a policy bug must not stop binds
            return True

    def _schedule_gang(
        self, queued: _QueuedPod, pod: Pod, group: PodGroup, now: float, gen: int
    ) -> Optional[str]:
        """One gang admission cycle, triggered by ANY member's pop:
        gather the pending members → group PreFilter (one batched
        feasibility dispatch) → place every rank → atomic group Reserve →
        bind all ranks. Any failure before the binds parks the triggering
        member with the whole group unreserved (all-or-nothing)."""
        members = self._gang_members(group, pod.namespace)
        if len(members) < group.size:
            self._record_failed_scheduling(
                pod,
                f"gang {group.key}: waiting for members "
                f"({len(members)}/{group.size} present)",
            )
            self._park(queued, now, gen)
            return None
        members = members[: group.size]

        status = self.plugin.pre_filter_gang(group.key, members)
        if not status.is_success():
            self._record_failed_scheduling(pod, status.message())
            if status.is_unschedulable():
                # gang-aware preemption (docs/policy.md): a capacity
                # rejection may be resolvable by evicting lower-priority
                # running work. Eviction is delete-then-requeue — the
                # DELETED events free node slots and used sums, the freed-
                # capacity flips publish through the priority lane, and
                # the deletes themselves are requeue hints — so this cycle
                # just parks; the wake generation check below keeps the
                # group active when victims were actually evicted.
                self.plugin.maybe_preempt_gang(group.key, members)
            self._park(queued, now, gen)
            return None

        nodes = self._pick_nodes_for(members)
        if nodes is None:
            self._record_failed_scheduling(
                pod,
                "0/%d nodes can place all %d ranks of gang %s"
                % (len(self.nodes), group.size, group.key),
            )
            self._park(queued, now, gen)
            return None

        reserve_status = self.plugin.reserve_gang(group.key, members)
        if not reserve_status.is_success():
            self.plugin.unreserve_gang(group.key)
            self._park(queued, now, gen)
            return None

        for member, node in zip(members, nodes):
            try:
                self.store.mutate(
                    "Pod",
                    member.key,
                    lambda cur, n=node.name: replace(
                        cur, spec=replace(cur.spec, node_name=n)
                    ),
                )
            except Exception:
                logger.exception(
                    "gang %s: bind failed for %s; releasing the group reserve",
                    group.key, member.key,
                )
                # already-bound ranks are admitted (their reservations ride
                # the normal unreserve-on-observe handshake); the rest of
                # the group's reserve is released together
                self.plugin.unreserve_gang(group.key)
                self._park(queued, now, gen)
                return None

        with self._cv:
            for member in members:
                self._queued_keys.discard(member.key)
                self._unschedulable.pop(member.key, None)
            member_keys = {m.key for m in members}
            self._active = [q for q in self._active if q.key not in member_keys]
        vlog(3, "gang %s scheduled: %d rank(s)", group.key, len(members))
        return pod.key

    def _park(self, queued: _QueuedPod, now: float, gen: Optional[int] = None) -> None:
        # a sync drain passes now=inf to bypass backoff gates; anchor the
        # backoff to the real clock so the pod isn't gated forever once a
        # real-time loop takes over
        base = now if math.isfinite(now) else time.monotonic()
        queued.not_before = base + self._backoff_for(queued.attempts)
        with self._cv:
            if gen is not None and gen != self._wake_gen:
                # a requeue hint fired while this pod was mid-cycle; parking
                # now would miss it — keep the pod active (backoff-gated)
                self._active.append(queued)
                self._cv.notify_all()
                return
            self._unschedulable[queued.key] = queued

    def _record_failed_scheduling(self, pod: Pod, message: str) -> None:
        if self.plugin.event_recorder is not None:
            self.plugin.event_recorder.eventf(
                pod.key, "Warning", self.FAILED_SCHEDULING, "Scheduling", message
            )

    # -- driving -----------------------------------------------------------

    def run_until_idle(self, max_cycles: int = 10_000, settle: bool = True) -> int:
        """Synchronously drain the queue: reconcile controllers and schedule
        until neither makes progress. Backoff gates are ignored (tests drive
        wall-clock-free). Returns the number of pods bound."""
        bound = 0
        for _ in range(max_cycles):
            progressed = False
            if self.plugin.run_pending_once():
                progressed = True
            # far-future "now" neutralizes backoff gating for sync draining
            key = self.schedule_one(now=float("inf")) if settle else self.schedule_one()
            if key is not None:
                bound += 1
                progressed = True
            if not progressed:
                with self._cv:
                    if not self._active:
                        break
                    # only backoff-parked actives remain and settle is off
                    if not settle:
                        break
        return bound

    def pending_count(self) -> int:
        with self._cv:
            return len(self._active) + len(self._unschedulable)

    def start(self, poll_interval: float = 0.01, flush_interval: float = 5.0) -> None:
        """``flush_interval``: unschedulable pods are periodically re-queued
        even without a triggering event (kube-scheduler's
        flushUnschedulablePodsLeftover analog) — the safety net under the
        event-driven wakeups; backoff gates still apply after a flush.

        The loop sleeps on the condition variable until the next backoff
        gate or the flush deadline — an idle scheduler makes no wakeups
        (new work notifies the condition). ``poll_interval`` is retained
        for signature compatibility; it no longer drives a poll."""
        del poll_interval  # superseded by event-driven waits
        if self._thread is not None:
            return
        self._stop_event.clear()

        def loop() -> None:
            last_flush = time.monotonic()
            while not self._stop_event.is_set():
                # loop-level routing (threads checker): a scheduling bug
                # must not silently stop the scheduler loop for good
                try:
                    key = self.schedule_one()
                    now = time.monotonic()
                    if now - last_flush >= flush_interval:
                        last_flush = now
                        self._wake_unschedulable()
                        continue
                    if key is None:
                        with self._cv:
                            if self._stop_event.is_set():
                                return
                            gates = [q.not_before for q in self._active]
                            if any(g <= now for g in gates):
                                continue  # work arrived between cycle and here
                            next_gate = min((g for g in gates if g > now), default=None)
                            deadline = last_flush + flush_interval
                            wake_at = deadline if next_gate is None else min(next_gate, deadline)
                            self._cv.wait(timeout=max(wake_at - now, 0.0))
                except Exception:  # noqa: BLE001 — keep scheduling
                    logger.exception("scheduler loop error")
                    self._stop_event.wait(0.1)

        self._thread = threading.Thread(target=loop, name="scheduler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_event.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
