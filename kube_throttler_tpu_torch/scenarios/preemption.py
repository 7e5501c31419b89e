"""Preemption-storm scenario: gang waves vs low-priority residents, with
a no-thrash victim-churn SLO gate.

The generic replay engine (scenarios/engine.py) drives reflectors and
controllers but no scheduler, so this scenario — like the sharded and
resharding chaos scenarios — owns a dedicated runner over the REAL
admission stack: store + plugin (policy with preemption enabled) +
embedded scheduler. The ``preempt_storm`` corpus entry
(scenarios/corpus.py) is the declarative program; this module interprets
its topology axes (gang_size, priority_levels) into the storm:

1. **Residents** — every label group's throttle is filled to its cpu
   threshold by priority-0/1 RUNNING pods; a fraction are gang-shaped
   (whole-gang eviction must fire, not just single-pod eviction).
2. **Waves** — per wave, high-priority gangs land Pending on saturated
   groups. Admission rejects them for capacity; the scheduler's
   preemption hook selects ranked victims (batched kernel ≡ sequential
   oracle), evicts whole units through delete-then-requeue, and the
   freed capacity admits the gang on the requeue. The wave's gangs then
   finish (delete) and their EVICTED victims are recreated Pending — the
   deployment-controller shape that makes churn measurable. Recreated
   victims readmit between waves; the rank order's age axis (oldest
   first) then steers the NEXT wave's selection away from them.

Gates (report JSON on stdout; nonzero exit on any failure):

- ``admitted``      — every high-priority gang of every wave admitted;
- ``no_half_gangs`` — no resident gang is ever left partially present
  (whole-gang eviction, checked after every wave AND at the end);
- ``victim_order``  — every evicted pod's priority sat below every
  preemptor's (the min_priority_gap contract);
- ``churn``         — the no-thrash SLO: evicted-then-readmitted-then-
  re-evicted rate ≤ ``MAX_REEVICT_FRAC`` of victims, and total victims
  ≤ ``MAX_VICTIM_FACTOR``× the storm's aggregate minimal need (the
  selector must stay near-minimal, not clear-cut whole groups);
- ``oracle``        — a final seeded kernel ≡ sequential-oracle sweep
  over synthetic selection problems (the in-situ twin of the tier-1
  equivalence tests).

Run: ``python -m kube_throttler_tpu_torch.scenarios.preemption --seed 0
[--device {cuda,cpu}]`` (wired into ``make scenario-test``). The device is
the caller's explicit choice: ``device=None`` (``--device cuda``) means
CUDA and raises ``RuntimeError`` before the stack is built when there is
none. On CUDA the storm's preemption cycles and the ``oracle`` sweep
launch the ``victim_select`` kernel.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import sys
from typing import Dict, List, Set

__all__ = ["run_preemption_storm"]

logger = logging.getLogger(__name__)

N_WAVES = 3
GANGS_PER_WAVE = 2
# churn gates: re-evicting more than this fraction of evicted-and-
# readmitted victims is thrashing; selecting more than this multiple of
# the storm's aggregate minimal need is over-eviction
MAX_REEVICT_FRAC = 0.5
MAX_VICTIM_FACTOR = 2.0


def _build_stack(seed: int, device):
    from ..api.pod import Namespace
    from ..engine.store import Store
    from ..plugin import KubeThrottler, decode_plugin_args
    from ..scheduler import Node, Scheduler

    store = Store()
    store.create_namespace(Namespace("default"))
    plugin = KubeThrottler(
        decode_plugin_args(
            {
                "name": "kube-throttler",
                "targetSchedulerName": "my-scheduler",
                "policies": [
                    {
                        "name": "storm",
                        "preemptionEnabled": True,
                        "minPriorityGap": 1,
                        "maxVictimsPerCycle": 64,
                        "classWeights": [
                            {"accelClass": "gold", "weight": 2.0}
                        ],
                    }
                ],
            }
        ),
        store,
        use_device=True,
        device=device,
    )
    from ..scenarios.corpus import get_scenario

    scn = get_scenario("preempt_storm")
    nodes = [Node(f"n{i}") for i in range(max(scn.topology.nodes, 1))]
    sched = Scheduler(plugin, store, nodes=nodes)
    return store, plugin, sched, scn


def _make_throttle(name: str, grp: str, cpu_m: int):
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
            threshold=ResourceAmount.of(requests={"cpu": f"{cpu_m}m"}),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels={"grp": grp})),
                )
            ),
        ),
    )


def _gang_presence(store, members_of: Dict[str, Set[str]]) -> List[str]:
    """Resident gangs partially present: the half-evicted-gang violation
    list (empty = the whole-gang contract held)."""
    live = {p.key for p in store.list_pods("default")}
    violations = []
    for gang, members in members_of.items():
        present = members & live
        if present and present != members:
            violations.append(
                f"{gang}: {len(present)}/{len(members)} members present"
            )
    return violations


def _oracle_sweep(seed: int, cases: int = 25, device=None) -> bool:
    """Seeded kernel ≡ sequential-oracle equivalence over synthetic
    selection problems — the in-situ twin of the tier-1 sweep. The operands
    live on ``device`` (``None`` means CUDA and raises ``RuntimeError``
    without it), so on CUDA every case launches the kernel."""
    import numpy as np
    import torch

    from .. import resolve_device

    device = resolve_device(device)
    from ..ops.victim_select import victim_select
    from ..policy.victims import sequential_victim_select

    rng = random.Random(seed * 7919 + 11)
    for _ in range(cases):
        n = rng.randint(1, 24)
        m = rng.randint(1, 6)
        cap = rng.choice([0, 0, rng.randint(1, n)])
        contrib = np.array(
            [[rng.choice([0, 0, 1, 2, 100, 250]) for _ in range(m)] for _ in range(n)],
            dtype=np.int64,
        )
        deficit = np.array(
            [rng.choice([0, 1, 3, 200, 500]) for _ in range(m)], dtype=np.int64
        )
        ok_s, sel_s, _ = sequential_victim_select(deficit, contrib, max_victims=cap)
        sel_k, ok_k, _ = victim_select(
            torch.from_numpy(contrib).to(device),
            torch.from_numpy(deficit).to(device),
            max_victims=cap,
        )
        if bool(ok_k.cpu()) != ok_s or list(
            np.nonzero(sel_k.cpu().numpy())[0]
        ) != sel_s:
            return False
    return True


def run_preemption_storm(seed: int = 0, device=None) -> Dict:
    """The storm on ``device`` (``None`` → CUDA, raising without it)."""
    from .. import resolve_device
    from ..api.pod import make_pod

    device = resolve_device(device)
    store, plugin, sched, scn = _build_stack(seed, device)
    rng = random.Random(f"preempt_storm/{seed}")
    topo = scn.topology
    gang_size = max(topo.gang_size, 2)
    n_groups = max(topo.groups, 4)
    residents_per_group = max(topo.pods // n_groups, gang_size * 2)
    cpu_m = 100  # every pod requests 100m: deficits are exact multiples

    report: Dict = {
        "scenario": scn.name,
        "seed": seed,
        "device": str(plugin.device_manager.device),
        "groups": n_groups,
        "residents_per_group": residents_per_group,
        "waves": N_WAVES,
        "gates": {},
        "violations": [],
    }
    try:
        # one throttle per group, threshold == the resident sum: saturated
        for g in range(n_groups):
            store.create_throttle(
                _make_throttle(f"t{g}", f"g{g}", residents_per_group * cpu_m)
            )
        # residents: RUNNING low-priority pods; half the groups' pods are
        # gang-shaped so whole-gang eviction must fire
        resident_gangs: Dict[str, Set[str]] = {}
        resident_priority: Dict[str, int] = {}
        for g in range(n_groups):
            gangy = g % 2 == 0
            for i in range(residents_per_group):
                prio = rng.randrange(2)  # priority 0/1 — all below the waves'
                kwargs = {}
                if gangy:
                    gang_name = f"res-{g}-{i // gang_size}"
                    kwargs = {"group": gang_name, "group_size": gang_size}
                pod = make_pod(
                    f"res-{g}-{i}",
                    labels={"grp": f"g{g}"},
                    requests={"cpu": f"{cpu_m}m"},
                    node_name=f"n{(g + i) % max(topo.nodes, 1)}",
                    phase="Running",
                    priority=prio,
                    **kwargs,
                )
                store.create_pod(pod)
                resident_priority[pod.key] = prio
                if gangy:
                    resident_gangs.setdefault(
                        f"default/res-{g}-{i // gang_size}", set()
                    ).add(pod.key)
        sched.run_until_idle()  # statuses converge: every group saturated

        evicted_ever: Set[str] = set()
        reevicted: Set[str] = set()
        admitted_gangs = 0
        expected_gangs = 0
        min_need_total = 0
        preemptor_floor = 10**9
        coord = plugin.preempt

        # waves 0..N-2 hit FRESH groups; the final wave REVISITS wave 0's —
        # its residents now include readmitted ex-victims, so the rank
        # order's age axis (oldest first) is what keeps them from being
        # re-evicted: the churn gate measures exactly that
        fresh = rng.sample(range(n_groups), GANGS_PER_WAVE * (N_WAVES - 1))
        wave_plan = [
            fresh[w * GANGS_PER_WAVE : (w + 1) * GANGS_PER_WAVE]
            for w in range(N_WAVES - 1)
        ]
        wave_plan.append(wave_plan[0])
        for wave in range(N_WAVES):
            wave_groups = wave_plan[wave]
            wave_keys = []
            for j, g in enumerate(wave_groups):
                expected_gangs += 1
                min_need_total += gang_size  # gang_size * cpu_m over a full throttle
                prio = 5 + wave  # far above every resident
                preemptor_floor = min(preemptor_floor, prio)
                gang_name = f"hi-{wave}-{j}"
                for r in range(gang_size):
                    store.create_pod(
                        make_pod(
                            f"{gang_name}-r{r}",
                            labels={"grp": f"g{g}"},
                            requests={"cpu": f"{cpu_m}m"},
                            group=gang_name,
                            group_size=gang_size,
                            priority=prio,
                            accel_class="gold",
                        )
                    )
                wave_keys.append((gang_name, g))
            before = {p.key for p in store.list_pods("default")}
            sched.run_until_idle()
            after_pods = {p.key: p for p in store.list_pods("default")}
            newly_evicted = {
                k for k in before - set(after_pods)
                if k in resident_priority and k not in evicted_ever
            }
            re_evicted_now = {
                k for k in before - set(after_pods)
                if k in resident_priority and k in evicted_ever
            }
            reevicted |= re_evicted_now
            evicted_ever |= newly_evicted | re_evicted_now
            # gate data: admitted gangs = every rank bound
            for gang_name, _g in wave_keys:
                ranks = [
                    after_pods.get(f"default/{gang_name}-r{r}")
                    for r in range(gang_size)
                ]
                if all(p is not None and p.is_scheduled() for p in ranks):
                    admitted_gangs += 1
            half = _gang_presence(store, resident_gangs)
            if half:
                report["violations"].extend([f"wave {wave}: {v}" for v in half])
            # the wave's gangs finish; their evicted victims come back as
            # Pending recreations (the churn signal's raw material)
            for gang_name, _g in wave_keys:
                for r in range(gang_size):
                    try:
                        store.delete_pod("default", f"{gang_name}-r{r}")
                    except KeyError:
                        pass
            for key in sorted(newly_evicted | re_evicted_now):
                name = key.partition("/")[2]
                gang_of = next(
                    (gk for gk, mem in resident_gangs.items() if key in mem), None
                )
                kwargs = {}
                if gang_of is not None:
                    kwargs = {
                        "group": gang_of.partition("/")[2],
                        "group_size": gang_size,
                    }
                grp = name.split("-")[1]
                store.create_pod(
                    make_pod(
                        name,
                        labels={"grp": f"g{grp}"},
                        requests={"cpu": f"{cpu_m}m"},
                        priority=resident_priority[key],
                        **kwargs,
                    )
                )
            sched.run_until_idle()  # readmissions between waves

        # ---- gates -----------------------------------------------------
        victims_total = coord.victims_total
        churn_frac = len(reevicted) / max(len(evicted_ever), 1)
        report.update(
            {
                "admitted_gangs": admitted_gangs,
                "expected_gangs": expected_gangs,
                "victims_total": victims_total,
                "evicted_unique": len(evicted_ever),
                "reevicted": len(reevicted),
                "readmitted_total": coord.readmitted_total,
                "infeasible_total": coord.infeasible_total,
                "min_need_total": min_need_total,
                "churn_frac": round(churn_frac, 3),
            }
        )
        victim_order_ok = all(
            resident_priority[k] + 1 <= preemptor_floor for k in evicted_ever
        )
        final_half = _gang_presence(store, resident_gangs)
        if final_half:
            report["violations"].extend([f"final: {v}" for v in final_half])
        gates = {
            "admitted": admitted_gangs == expected_gangs,
            "no_half_gangs": not report["violations"],
            "victim_order": victim_order_ok,
            "churn": (
                churn_frac <= MAX_REEVICT_FRAC
                and victims_total <= int(min_need_total * MAX_VICTIM_FACTOR)
                + gang_size * N_WAVES  # whole-gang rounding slack
            ),
            "oracle": _oracle_sweep(seed, device=device),
        }
        report["gates"] = gates
        report["ok"] = all(gates.values())
        return report
    finally:
        sched.stop()
        plugin.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="scenarios.preemption")
    parser.add_argument("--seed", type=int, default=0)
    from ..utils.platform import add_device_argument, device_or_report

    add_device_argument(parser, "the plugin's device data plane")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    # without a CUDA device '--device cuda' exits here, before the stack
    device = device_or_report(args.device)
    if device is None:
        return 1
    report = run_preemption_storm(seed=args.seed, device=device)
    print(json.dumps(report, indent=2, sort_keys=True))
    if not report.get("ok"):
        failed = [g for g, ok in report.get("gates", {}).items() if not ok]
        print(f"FAIL preempt_storm seed={args.seed}: gates {failed}", file=sys.stderr)
        return 1
    print(
        f"PASS preempt_storm seed={args.seed}: "
        f"{report['admitted_gangs']}/{report['expected_gangs']} gangs admitted, "
        f"{report['victims_total']} victim(s), churn {report['churn_frac']}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
