"""Committed, replayable scenario traces.

``build_trace(scenario, seed)`` is a PURE function: topology and op
stream derive from seeded ``random.Random`` instances keyed by
``(scenario.name, seed)`` and nothing else — no wall clock, no host
state. The serialized form (one JSON line per record, sorted keys, fixed
separators, integer-microsecond timestamps) is therefore byte-identical
across runs and hosts: the tier-1 determinism smoke hashes it, and a
committed trace file IS the reproduction recipe for whatever its replay
exposed.

Record shapes:

- header — scenario parameters, seed, trace format version, the fault
  schedule, and the topology's sha256 (topology is derivable, so only its
  hash ships);
- ops — ``update_pod`` / ``create_pod`` / ``delete_pod`` /
  ``update_throttle``, each carrying the virtual time ``t_us``, the pod's
  label group, and the cpu delta bookkeeping (``cpu_m``/``prev_m``) the
  replayer needs for crossing-anchored flip stamping
  (scenarios/measure.py) without re-deriving generator state.

Patterns beyond plain churn are generated INLINE with the background
stream (a single time-ordered pass), so the per-pod ``prev_m`` chain
stays exact across drain waves and herd bursts — the flip-stamp
bookkeeping would silently drift if patterns were generated separately
and merged.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import random
from dataclasses import asdict
from typing import Dict, List, Tuple

from .dsl import Scenario, arrival_rate, compile_fault_rules

# v2: the header additionally commits the CANONICAL compiled fault plan
# (faults/plan.py FaultRule.canonical, priority order preserved) and its
# sha256 — the hunt's dedupe key for mutants whose schedules differ only
# in surface form, and a reader's answer to "what does this trace
# actually arm?" without re-deriving the compile step.
TRACE_VERSION = 2

__all__ = [
    "TRACE_VERSION",
    "build_topology",
    "build_trace",
    "canonical_fault_plan",
    "serialize_trace",
    "trace_sha256",
]


def canonical_fault_plan(scn: Scenario) -> Tuple[List[Dict], str]:
    """→ (canonical rule list, sha256 of its stable JSON form): the
    scenario's fault schedule compiled exactly as the engine compiles it
    (dsl.compile_fault_rules), then canonicalized. Equal shas ⇒ the two
    scenarios arm byte-for-byte the same effective plan."""
    from ..faults.plan import FaultPlan

    plan = FaultPlan(seed=0)
    compile_fault_rules(plan, scn)
    rules = plan.canonical_rules()
    blob = json.dumps(rules, sort_keys=True, separators=(",", ":")).encode()
    return rules, hashlib.sha256(blob).hexdigest()


def build_topology(scn: Scenario, seed: int) -> Dict:
    """The pre-trace object population, derived from the seed alone:
    pod specs (name, label group, initial cpu milli, node) plus the hot
    group's size. Throttles are fully determined by the scenario (counts,
    groups, flip band) and need no randomness."""
    rng = random.Random(f"{scn.name}/{seed}/topo")
    topo = scn.topology
    n_hot = int(topo.pods * topo.hot_frac)
    n_classes = getattr(topo, "accel_classes", 0)
    gang_size = getattr(topo, "gang_size", 0)
    n_priorities = getattr(topo, "priority_levels", 0)
    gang_counters: Dict[str, int] = {}
    pods: List[Dict] = []
    for i in range(topo.pods):
        grp = "hot" if i < n_hot else f"g{rng.randrange(topo.groups)}"
        spec = {
            "name": f"p{i}",
            "grp": grp,
            "cpu_m": rng.randrange(1, 8) * 100,
            "node": f"n{i % max(topo.nodes, 1)}",
        }
        # gang/heterogeneity/priority axes (the admission, gang and
        # policy paths): keys appear ONLY when the axis is on, so axis-off
        # topologies — every committed trace — keep their exact bytes/shas
        if n_classes > 0:
            spec["acl"] = f"ac{i % n_classes}"
        if gang_size > 0:
            c = gang_counters.get(grp, 0)
            gang_counters[grp] = c + 1
            spec["gang"] = f"gg-{grp}-{c // gang_size}"
        if n_priorities > 0:
            spec["pri"] = rng.randrange(n_priorities)
        pods.append(spec)
    return {"pods": pods, "n_hot": n_hot}


def _topology_sha(topology: Dict) -> str:
    blob = json.dumps(topology, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def build_trace(scn: Scenario, seed: int) -> Tuple[Dict, List[Dict]]:
    """→ (header, ops). Ops are time-ordered; ties keep emission order via
    the monotone ``seq`` field."""
    topology = build_topology(scn, seed)
    rng = random.Random(f"{scn.name}/{seed}/ops")
    topo = scn.topology

    cur_cpu = {p["name"]: p["cpu_m"] for p in topology["pods"]}
    grp_of = {p["name"]: p["grp"] for p in topology["pods"]}
    node_of = {p["name"]: p["node"] for p in topology["pods"]}
    acl_of = {p["name"]: p["acl"] for p in topology["pods"] if "acl" in p}
    gang_of = {p["name"]: p["gang"] for p in topology["pods"] if "gang" in p}
    pri_of = {p["name"]: p["pri"] for p in topology["pods"] if "pri" in p}
    n_classes = getattr(topo, "accel_classes", 0)
    gang_size = getattr(topo, "gang_size", 0)
    n_priorities = getattr(topo, "priority_levels", 0)

    def annot_fields(name: str) -> Dict:
        out: Dict = {}
        if name in acl_of:
            out["acl"] = acl_of[name]
        if name in gang_of:
            out["gang"] = gang_of[name]
            out["gsz"] = gang_size
        if name in pri_of:
            out["pri"] = pri_of[name]
        return out
    alive = [p["name"] for p in topology["pods"]]
    alive_set = set(alive)
    weights = scn.mix_weights()
    w_update = weights.get("update", 1.0)
    w_create = w_update + weights.get("create", 0.0)
    w_delete = w_create + weights.get("delete", 0.0)
    w_total = w_delete + weights.get("spec", 0.0)

    ops: List[Dict] = []
    seq = 0

    def emit(t: float, verb: str, **fields) -> None:
        nonlocal seq
        seq += 1
        ops.append({"t_us": int(round(t * 1e6)), "seq": seq, "verb": verb, **fields})

    def pick_alive() -> str:
        # uniform over the CURRENT population; dead names are lazily
        # skipped (deletions compact on pick, keeping the draw O(1) amortized)
        while alive:
            name = alive[rng.randrange(len(alive))]
            if name in alive_set:
                return name
            alive.remove(name)
        raise RuntimeError("trace generator ran out of pods")

    def emit_update(t: float, name: str) -> None:
        prev = cur_cpu[name]
        new_cpu = rng.randrange(1, 8) * 100
        if new_cpu == prev:
            new_cpu = new_cpu % 700 + 100
        cur_cpu[name] = new_cpu
        emit(
            t, "update_pod",
            name=name, grp=grp_of[name], node=node_of[name],
            cpu_m=new_cpu, prev_m=prev, **annot_fields(name),
        )

    def emit_create(t: float, name: str, grp: str, node: str) -> None:
        cpu = rng.randrange(1, 8) * 100
        cur_cpu[name] = cpu
        grp_of[name] = grp
        node_of[name] = node
        if n_classes > 0 and name not in acl_of:
            acl_of[name] = f"ac{rng.randrange(n_classes)}"
        if n_priorities > 0 and name not in pri_of:
            pri_of[name] = rng.randrange(n_priorities)
        alive.append(name)
        alive_set.add(name)
        emit(
            t, "create_pod", name=name, grp=grp, node=node, cpu_m=cpu,
            prev_m=0, **annot_fields(name),
        )

    def emit_delete(t: float, name: str) -> None:
        alive_set.discard(name)
        emit(
            t, "delete_pod",
            name=name, grp=grp_of[name], node=node_of[name],
            cpu_m=0, prev_m=cur_cpu.get(name, 0),
        )
        cur_cpu[name] = 0

    # scheduled pattern extras: (t, tiebreak, kind, payload) heap, generated
    # lazily when virtual time reaches each wave/burst trigger so the
    # population snapshot they act on reflects all prior churn
    extras: List[Tuple[float, int, str, Tuple]] = []
    extra_seq = 0

    def push_extra(t: float, kind: str, payload: Tuple) -> None:
        nonlocal extra_seq
        extra_seq += 1
        heapq.heappush(extras, (t, extra_seq, kind, payload))

    triggers: List[Tuple[float, str, Tuple]] = []
    if scn.pattern == "drain":
        # waves roll node by node, spaced wider than one wave's eviction
        # window so at most ~2 waves overlap (a cluster drains serially)
        for k in range(max(topo.nodes, 1)):
            t_wave = 0.8 + 1.3 * k
            if t_wave + 2.2 > scn.duration_s:
                break
            triggers.append((t_wave, "drain", (k,)))
    elif scn.pattern == "herd":
        triggers.append((scn.duration_s * 0.25, "herd_up", ()))
        triggers.append((scn.duration_s * 0.65, "herd_down", ()))
    triggers.sort(key=lambda x: x[0])
    trigger_i = 0
    herd_names: List[str] = []

    def fire_triggers(now: float) -> None:
        nonlocal trigger_i
        while trigger_i < len(triggers) and triggers[trigger_i][0] <= now:
            t_trig, kind, payload = triggers[trigger_i]
            trigger_i += 1
            if kind == "drain":
                # a real drain is PACED (eviction API / PDB throttling, the
                # kubelet's serial pod kills): each wave evicts over ~1.2s
                # and the replacements land ~0.8s behind — violent, but not
                # an apiserver-impossible instantaneous burst
                (k,) = payload
                node = f"n{k}"
                victims = [n for n in alive if n in alive_set and node_of[n] == node]
                for j, name in enumerate(victims):
                    dt = 1.2 * j / max(len(victims), 1)
                    push_extra(t_trig + dt, "delete", (name,))
                    push_extra(
                        t_trig + 0.8 + dt, "recreate",
                        (name, grp_of[name], f"n{k}r"),
                    )
            elif kind == "herd_up":
                # a deployment-sized rollout: the controller manager + the
                # apiserver's write path cap create rates at hundreds/s —
                # the herd lands over ~3s, not in one instant
                for j in range(scn.herd_size):
                    name = f"h{j}"
                    grp = f"g{rng.randrange(topo.groups)}"
                    herd_names.append(name)
                    push_extra(
                        t_trig + 3.0 * j / max(scn.herd_size, 1),
                        "create", (name, grp, f"n{j % max(topo.nodes, 1)}"),
                    )
            elif kind == "herd_down":
                for j, name in enumerate(herd_names):
                    push_extra(
                        t_trig + 3.0 * j / max(len(herd_names), 1),
                        "delete_if_alive", (name,),
                    )

    def drain_extras(upto: float) -> None:
        while extras and extras[0][0] <= upto:
            t_x, _, kind, payload = heapq.heappop(extras)
            fire_triggers(t_x)
            if kind == "delete":
                (name,) = payload
                if name in alive_set:
                    emit_delete(t_x, name)
            elif kind == "delete_if_alive":
                (name,) = payload
                if name in alive_set:
                    emit_delete(t_x, name)
            elif kind == "recreate":
                name, grp, node = payload
                if name not in alive_set:
                    emit_create(t_x, name, grp, node)
            elif kind == "create":
                name, grp, node = payload
                if name not in alive_set:
                    emit_create(t_x, name, grp, node)

    t = 0.0
    n_created = 0
    while True:
        rate = max(arrival_rate(scn.arrival, t, scn.duration_s), 1e-6)
        t_next = t + 1.0 / rate
        fire_triggers(t_next)
        drain_extras(t_next)
        t = t_next
        if t >= scn.duration_s:
            break
        r = rng.random() * w_total
        if r < w_update or not alive_set:
            emit_update(t, pick_alive())
        elif r < w_create:
            n_created += 1
            emit_create(
                t, f"x{n_created}",
                f"g{rng.randrange(topo.groups)}",
                f"n{rng.randrange(max(topo.nodes, 1))}",
            )
        elif r < w_delete:
            if len(alive_set) > topo.pods // 2:
                emit_delete(t, pick_alive())
            else:
                emit_update(t, pick_alive())
        else:
            # spec churn on the open (pod-count) threshold class only:
            # cpu thresholds are the crossing-anchored flip watch's fixed
            # reference, so the generator leaves them alone
            idx = rng.randrange(max(scn.topology.throttles // 3, 1)) * 3
            if idx < scn.topology.throttles:
                emit(
                    t, "update_throttle",
                    name=f"t{idx}", pod_threshold=rng.randrange(5, 80),
                )
            else:
                emit_update(t, pick_alive())
    fire_triggers(scn.duration_s)
    drain_extras(scn.duration_s)

    ops.sort(key=lambda o: (o["t_us"], o["seq"]))
    plan_rules, plan_sha = canonical_fault_plan(scn)
    header = {
        "version": TRACE_VERSION,
        "scenario": scn.name,
        "description": scn.description,
        "seed": seed,
        "duration_s": scn.duration_s,
        "pattern": scn.pattern,
        "herd_size": scn.herd_size,
        "leader_kill": scn.leader_kill,
        "durable": scn.durable,
        "arrival": asdict(scn.arrival),
        "topology": asdict(scn.topology),
        "topology_sha256": _topology_sha(topology),
        "mix": list(list(m) for m in scn.mix),
        "faults": [asdict(f) for f in scn.faults],
        "fault_plan": plan_rules,
        "fault_plan_sha256": plan_sha,
        "slo": asdict(scn.slo),
        "ops": len(ops),
    }
    return header, ops


def serialize_trace(header: Dict, ops: List[Dict]) -> bytes:
    """Canonical byte form: header line then one line per op, sorted keys,
    no whitespace — the determinism smoke compares these bytes."""
    lines = [json.dumps(header, sort_keys=True, separators=(",", ":"))]
    lines.extend(
        json.dumps(op, sort_keys=True, separators=(",", ":")) for op in ops
    )
    return ("\n".join(lines) + "\n").encode()


def trace_sha256(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()
