#!/usr/bin/env python3
"""Times the port's ``check_gather`` at its callers' shapes, and the
coalescer's ``check_pods_multi`` calls repeated, for the port of this
checkout or of another one, on one CUDA card.

    python3 gather_timing.py [TREE]

TREE (default: this checkout) is the root of a checkout whose
``kube_throttler_tpu_torch`` is imported, built and timed. The cluster and
the timers come from this checkout's ``chip_smoke.py`` (``build_cluster``,
``tick_inputs``, ``cuda_ms``, ``device_only_ms``), which call only the
port's entry points and its mirror, so two checkouts, say a parent and a
change unpacked with ``git archive``, are timed on the same inputs in the
same way.

It builds the smoke's cluster (100,000 pods, 10,000 Throttles in 500
label groups, 8 ClusterThrottles, seed 0), reconciles it and prewarms the
mirror, then:

- ``[coalesce-timing]``: the smoke's ``[coalesce]`` calls, ``check_pods_multi``
  over the same 256 stored pods per kind, on the host route and then the
  device route, REPEATS times each, before any other phase (host clock).
  Each device call is held against its host call.
- ``[gather-timing]``: ``check_gather`` at the tick's state, as
  ``full_tick_sharded`` derives it, in three cells: ``coalesce``, the
  first 256 pod rows (the coalescer's P); ``tick``, all 131,072 pod rows,
  each pod requesting one dim, cpu, as the smoke's pods do; ``tick-2dim``,
  the same rows with a second requested dim, as a pod that asks for cpu
  and memory does: every pod requests the next unused dim too (2**20
  times its cpu request) and every Throttle row with a cpu threshold gets
  a roomy one on that dim (2**40) with the rows' used cpu times 2**20 as
  its used. Per cell and form (counts, as ``check_pods_gather``; statuses)
  the wrapper's ms with the L2 flushed (``cuda_ms``), the same calls with
  the host's enqueue hidden (``device_only_ms``) and, where the tree has
  the pack, the pack alone and the check alone over records packed once.
  Each form's output is held against ``check_gather_reference`` first.

The card's ``nvidia-smi`` name and power limit come first, and the last
line is one JSON object of every reading.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CALLS = 50  # calls per timing
REPEATS = 5  # coalescer calls per route and kind
COALESCE_ROWS = 256


def coalesce_timing(smoke, plugin, cg):
    """REPEATS host and device ``check_pods_multi`` calls per kind over the
    smoke's sampled pods, each device call held against its host call."""
    dm = plugin.device_manager
    pods = random.Random(smoke.SEED + 7).sample(plugin.listers.pods.list(), COALESCE_ROWS)
    forced = dm._single_check_device  # noqa: SLF001 — the route's switch
    rows, ok = [], True
    try:
        for kind in ("throttle", "clusterthrottle"):
            for rep in range(REPEATS):
                dm._single_check_device = False
                t0 = time.perf_counter()
                host = dm.check_pods_multi(pods, kind)
                t_host = time.perf_counter() - t0
                dm._single_check_device = True
                l0 = cg.launches
                t0 = time.perf_counter()
                device = dm.check_pods_multi(pods, kind)
                t_dev = time.perf_counter() - t0
                same = device == host
                ok = ok and same
                rows.append({"kind": kind, "rep": rep, "host_ms": t_host * 1e3,
                             "device_ms": t_dev * 1e3, "equal": same,
                             "check_gather_launches": cg.launches - l0})
                smoke.say("coalesce-timing", kind=kind, rep=rep, equal_to_host=same,
                          host_ms=f"{t_host * 1e3:.3f}", device_ms=f"{t_dev * 1e3:.3f}",
                          check_gather_launches=cg.launches - l0)
    finally:
        dm._single_check_device = forced
    return rows, ok


def two_dim_inputs(state, pods):
    """(state, pods) with a second requested dim beside the pods' one (see
    the module docstring); the second dim is the first that no pod
    requests."""
    import torch

    asked = pods.req_present.any(0).nonzero().flatten().tolist()
    if len(asked) != 1:
        raise RuntimeError(f"expected the pods to request one dim, not {asked}")
    d1 = asked[0]
    d2 = next(r for r in range(pods.req.shape[1]) if r != d1)
    req, req_present = pods.req.clone(), pods.req_present.clone()
    req[:, d2] = req[:, d1] << 20
    req_present[:, d2] = req_present[:, d1]
    planes = {name: getattr(state, name).clone()
              for name in ("thr_req", "thr_req_present", "used_req", "used_req_present")}
    planes["thr_req"][:, d2] = torch.where(state.thr_req_present[:, d1], 1 << 40, 0)
    planes["thr_req_present"][:, d2] = state.thr_req_present[:, d1]
    planes["used_req"][:, d2] = state.used_req[:, d1] << 20
    planes["used_req_present"][:, d2] = state.used_req_present[:, d1]
    return (dataclasses.replace(state, **planes),
            dataclasses.replace(pods, req=req, req_present=req_present))


def time_cell(smoke, cg, check_pods_gather, label, state, pods, cols):
    """One ``[gather-timing]`` line: outputs held against the plain
    version, then the wrapper's and (where the tree has them) each
    kernel's times."""
    flush = 64 << 20
    got_s = cg.check_gather(state, pods, cols, False, True, statuses=True)
    got_c, got_b = check_pods_gather(state, pods, cols, on_equal=False, step3_on_equal=True)
    want_s = cg.check_gather_reference(state, pods, cols, False, True, statuses=True)
    want_c, want_b = cg.check_gather_reference(state, pods, cols, False, True)
    bad = (int((got_s != want_s).sum()) + int((got_c != want_c).sum())
           + int((got_b != want_b).sum()))
    row = {"cell": label, "shape": [*cols.shape, *state.thr_req.shape], "mismatches": bad,
           **smoke.gather_live(state, pods, cols),
           "ms": smoke.cuda_ms(lambda: check_pods_gather(
               state, pods, cols, on_equal=False, step3_on_equal=True), CALLS, flush),
           "statuses_ms": smoke.cuda_ms(lambda: cg.check_gather(
               state, pods, cols, False, True, statuses=True), CALLS, flush),
           "device_ms": smoke.device_only_ms(lambda: check_pods_gather(
               state, pods, cols, on_equal=False, step3_on_equal=True), CALLS, flush),
           "statuses_device_ms": smoke.device_only_ms(lambda: cg.check_gather(
               state, pods, cols, False, True, statuses=True), CALLS, flush),
           "pack_ms": None, "kernel_only_ms": None, "statuses_kernel_only_ms": None}
    if hasattr(cg, "pack_gather_rows"):
        pack, check_counts, _ = smoke.gather_bare(state, pods, cols, statuses=False)
        _, check_statuses, _ = smoke.gather_bare(state, pods, cols, statuses=True)
        row["pack_ms"] = smoke.device_only_ms(pack, CALLS, flush)
        row["kernel_only_ms"] = smoke.device_only_ms(check_counts, CALLS, flush)
        row["statuses_kernel_only_ms"] = smoke.device_only_ms(check_statuses, CALLS, flush)
    smoke.say("gather-timing", **{k: f"{v:.5f}" if isinstance(v, float) else v
                                  for k, v in row.items()}, l2="flushed")
    return row


def main() -> int:
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    if not (tree / "kube_throttler_tpu_torch" / "__init__.py").is_file():
        print(f"gather_timing: no kube_throttler_tpu_torch/ in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("gather_timing: CUDA is not available", file=sys.stderr)
        return 2
    from kube_throttler_tpu_torch.ops import check_gather as cg
    from kube_throttler_tpu_torch.ops.check import check_pods_gather
    from kube_throttler_tpu_torch.utils.gchygiene import freeze_startup_heap

    print(smoke.card_line(), flush=True)
    smoke.say("gather-timing-tree", tree=str(tree), module=cg.__file__)
    t0 = time.perf_counter()
    plugin = smoke.build_cluster("cuda", smoke.N_PODS, smoke.N_THROTTLES, smoke.GROUPS,
                                 smoke.N_CLUSTER, smoke.SEED)
    try:
        plugin.run_pending_once()
        plugin.device_manager.prewarm()
        freeze_startup_heap()
        smoke.say("setup", seconds=f"{time.perf_counter() - t0:.1f}")
        coalesce, ok = coalesce_timing(smoke, plugin, cg)
        inputs = smoke.tick_inputs(plugin.device_manager)
        state, pods, cols = inputs[12], inputs[2], inputs[3]
        head = dataclasses.replace(pods, **{f.name: getattr(pods, f.name)[:COALESCE_ROWS]
                                            .contiguous() for f in dataclasses.fields(pods)})
        state2, pods2 = two_dim_inputs(state, pods)
        cells = [time_cell(smoke, cg, check_pods_gather, label, *args) for label, args in (
            ("coalesce", (state, head, cols[:COALESCE_ROWS].contiguous())),
            ("tick", (state, pods, cols)),
            ("tick-2dim", (state2, pods2, cols)))]
    finally:
        plugin.stop()
    ok = ok and all(c["mismatches"] == 0 for c in cells)
    print(json.dumps({"tree": str(tree), "ok": ok, "coalesce": coalesce, "cells": cells}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
