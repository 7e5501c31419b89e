"""The real daemon stack at scale on the PyTorch/CUDA port, without JAX.

``build_served_stack`` is ``bench.py``'s (store events → device mirror →
controllers → statuses) over ``kube_throttler_tpu_torch``: the same seeded
pods, the same Throttles (``scenarios.measure.served_throttle`` with its
flip band) and the same per-phase log lines on stderr. ``measured_call``
runs one call of it with the card synchronised around it and reads the
plugin tracer's phases and each kernel's launches across it; the
profiling tools (``tools/profile_batch_torch.py``,
``tools/profile_reconcile_torch.py``) print what it returns.

The device is explicit: ``device=None`` means ``cuda`` and raises without
a CUDA device; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import os
import random
import sys
import time
from dataclasses import replace
from typing import Callable, Sequence, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_served_stack(P, T, groups=500, label="served", device=None):
    """The daemon's stack at ``P`` bound pods × ``T`` Throttles in
    ``groups`` label groups, on ``device``. Returns (store, plugin). Setup
    cost is logged per phase (it is the honest cost of cold-starting this
    state)."""
    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
    from kube_throttler_tpu_torch.scenarios.measure import flip_band_mc, served_throttle
    from kube_throttler_tpu_torch.utils.gchygiene import freeze_startup_heap

    rng = random.Random(0)
    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True,
        device=device,
    )
    store.create_namespace(Namespace("default"))

    t0 = time.perf_counter()
    flip_mc = flip_band_mc(P, groups)
    for i in range(T):
        store.create_throttle(served_throttle(i, groups, flip_band_mc=flip_mc))
    t_thr = time.perf_counter() - t0
    log(f"[{label}] created {T} throttles in {t_thr:.1f}s "
        f"(flip band: every 24th cpu threshold at {flip_mc}m)")

    t0 = time.perf_counter()
    for i in range(P):
        pod = make_pod(
            f"p{i}",
            labels={"grp": f"g{rng.randrange(groups)}"},
            requests={"cpu": f"{rng.randrange(1, 8) * 100}m"},
        )
        pod = replace(pod, spec=replace(pod.spec, node_name="node-1"))
        pod.status.phase = "Running"
        store.create_pod(pod)
    t_pods = time.perf_counter() - t0
    log(f"[{label}] created {P} bound pods in {t_pods:.1f}s "
        f"({t_pods/P*1e6:.0f}us/event through the live index)")

    t0 = time.perf_counter()
    n = plugin.run_pending_once()
    t_rec = time.perf_counter() - t0
    log(f"[{label}] initial reconcile of {n} keys in {t_rec:.1f}s "
        f"(batched device aggregates)")

    if plugin.device_manager is not None:
        t0 = time.perf_counter()
        nk = plugin.device_manager.prewarm()
        log(f"[{label}] prewarmed {nk} kernel shapes in {time.perf_counter()-t0:.1f}s")
    # same pre-serving step the daemon takes (cli.py): freeze the startup
    # heap so automatic full GCs never rescan the pod graph inside a call
    frozen = freeze_startup_heap()
    if frozen > 0:
        log(f"[{label}] gc hygiene: froze {frozen} startup objects; gen2 deferred")
    return store, plugin


def measured_call(plugin, fn: Callable, phases: Sequence[str]) -> Tuple[object, dict]:
    """``fn()``'s result and its measurement: wall ms, the ms and count
    the plugin's tracer summed for each of ``phases`` during the call, and
    each kernel's launches during it. On a CUDA device the card is
    synchronised before each clock is read, so queued kernels land inside
    the call that queued them."""
    from kube_throttler_tpu_torch.metrics import kernel_launch_counts

    dm = plugin.device_manager
    device = dm.device if dm is not None else None
    if device is not None and device.type == "cuda":
        import torch

        def sync() -> None:
            torch.cuda.synchronize(device)
    else:
        def sync() -> None:
            pass

    def sums():
        out = {}
        for phase in phases:
            snap = plugin.tracer.snapshot(phase)
            out[phase] = (snap["sum"], snap["count"]) if snap else (0.0, 0)
        return out

    sync()
    s0, l0 = sums(), kernel_launch_counts()
    t0 = time.perf_counter()
    result = fn()
    sync()
    wall = time.perf_counter() - t0
    s1, l1 = sums(), kernel_launch_counts()
    split = {p: {"ms": round((s1[p][0] - s0[p][0]) * 1e3, 3), "n": s1[p][1] - s0[p][1]}
             for p in phases}
    launches = {k: l1[k] - l0[k] for k in l1}
    return result, {"ms": round(wall * 1e3, 3), "phases": split, "launches": launches}
