"""Memory-regression smoke for the columnar arena store on the
PyTorch/CUDA port: the copy of ``tools/memsmoke.py`` over
``kube_throttler_tpu_torch``. Run:

    python tools/memsmoke_torch.py [--device {cuda,cpu}]

It builds the real serving stack (store → device mirror → informers →
controllers, workers parked) on the device (``cuda`` by default; exits 1
without a CUDA device) at 50k pods × 1k throttles and gates the same two
per-pod marginals against the same committed bounds as the reference:

- **heap objects per pod** (bound 0.5): a stored pod must cost ~zero
  retained Python objects;
- **RSS per pod** (bound 6,144 B): arrays + interned strings + key maps;
  a blown bound means a dense per-pod structure crept back in.

The device mirror is prewarmed before the baseline is read: on ``cuda``
the CUDA context and the loaded kernel libraries add hundreds of MB of
RSS once, which is no cost of a stored pod. RSS is a high-water mark on
both devices, so a dense structure that the pod loop allocates and frees
again still counts: on the CPU the reference's ``ru_maxrss``; on
``cuda``, whose context's start-up peak lies above the whole pod loop so
that ``ru_maxrss`` does not move, the loop's own high-water mark over
the resident set at the baseline (``_ResidentPeak``). On ``cuda`` it
also prints the device bytes per pod once the mirror holds every pod
(``torch.cuda.memory_allocated`` after a second prewarm uploads it): a
figure, not a gate.

Exit 0 on pass, 1 with a diff-style report on breach.
"""

from __future__ import annotations

import argparse
import gc
import os
import resource
import sys
import threading
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

PODS = 50_000
THROTTLES = 1_000
GROUPS = 250

# committed bounds (the reference's, tools/memsmoke.py)
MAX_HEAP_OBJECTS_PER_POD = 0.5
MAX_RSS_BYTES_PER_POD = 6_144


def _hwm_kb() -> int:
    """The process's resident-set high-water mark, in KiB, as the
    reference reads it."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def _rss_kb() -> int:
    """The process's resident set now, in KiB."""
    with open("/proc/self/statm") as f:
        resident_pages = int(f.read().split()[1])
    return resident_pages * os.sysconf("SC_PAGE_SIZE") // 1024


class _ResidentPeak:
    """The resident set's high-water mark from its start to ``stop()``, in
    KiB, where the process's own mark lies above that stretch. A thread
    samples the resident set every millisecond; if the stretch lifts the
    process's mark past where it stood at the start, that mark is the
    stretch's peak exactly."""

    def __init__(self) -> None:
        self.start_kb = _rss_kb()
        self._hwm0 = _hwm_kb()
        self._peak = self.start_kb
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._sample, name="memsmoke-rss", daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        while not self._done.wait(0.001):
            self._peak = max(self._peak, _rss_kb())

    def stop(self) -> int:
        self._done.set()
        self._thread.join()
        peak = max(self._peak, _rss_kb())
        hwm = _hwm_kb()
        return max(peak, hwm) if hwm > self._hwm0 else peak


def main(argv=None) -> int:
    from kube_throttler_tpu_torch.utils.platform import add_device_argument, device_or_report

    parser = argparse.ArgumentParser(prog="memsmoke_torch.py")
    add_device_argument(parser, "the store's device mirror")
    args = parser.parse_args(argv)
    device = device_or_report(args.device)
    if device is None:
        return 1
    os.environ.setdefault("KT_LOCK_ASSERT", "0")
    import random
    from dataclasses import replace as _replace

    import torch

    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
    from tools.harness_torch import make_throttle

    on_card = device.type == "cuda"
    rng = random.Random(0)
    store = Store()
    if store.pod_arena is None:
        print("memsmoke: store is in frozen-dict reference mode; skipping")
        return 0
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store, use_device=True, start_workers=False, device=device,
    )
    store.create_namespace(Namespace("default"))
    for i in range(THROTTLES):
        store.create_throttle(_replace(make_throttle(i % 500), name=f"t{i}"))
    plugin.device_manager.prewarm()

    gc.collect()
    loop_peak = _ResidentPeak() if on_card else None
    objs0 = len(gc.get_objects())
    rss0 = loop_peak.start_kb if on_card else _hwm_kb()
    dev0 = torch.cuda.memory_allocated(device) if on_card else 0
    t0 = time.perf_counter()
    for i in range(PODS):
        pod = make_pod(
            f"p{i}",
            labels={"grp": f"g{rng.randrange(GROUPS)}"},
            requests={"cpu": f"{rng.randrange(1, 8) * 100}m"},
        )
        pod = _replace(pod, spec=_replace(pod.spec, node_name="node-1"))
        pod.status.phase = "Running"
        store.create_pod(pod)
    build_s = time.perf_counter() - t0
    gc.collect()
    objs_per_pod = (len(gc.get_objects()) - objs0) / PODS
    rss_per_pod = ((loop_peak.stop() if on_card else _hwm_kb()) - rss0) * 1024 / PODS

    stats = store.pod_arena.stats()
    print(
        f"memsmoke: {PODS} pods x {THROTTLES} throttles in {build_s:.1f}s — "
        f"{objs_per_pod:.3f} heap objects/pod (bound {MAX_HEAP_OBJECTS_PER_POD}), "
        f"{rss_per_pod:.0f} B RSS/pod (bound {MAX_RSS_BYTES_PER_POD}); "
        f"arena: {stats['slots_live']} slots, {stats['intern_pool_size']} interned, "
        f"{stats['request_shapes']} request shapes; device {device}"
    )
    if on_card:
        plugin.device_manager.prewarm()  # uploads the mirror with every pod
        torch.cuda.synchronize(device)
        dev_per_pod = (torch.cuda.memory_allocated(device) - dev0) / PODS
        print(f"memsmoke: device {torch.cuda.get_device_name(device)}: "
              f"{dev_per_pod:.0f} B allocated/pod once the mirror holds every pod "
              f"({torch.cuda.memory_allocated(device)} B allocated in all; not gated)")
    ok = True
    if objs_per_pod > MAX_HEAP_OBJECTS_PER_POD:
        print(
            f"memsmoke: FAIL heap objects/pod {objs_per_pod:.3f} > "
            f"{MAX_HEAP_OBJECTS_PER_POD} — a layer is retaining per-pod "
            "objects again (index/informer/devicestate retention?)"
        )
        ok = False
    if rss_per_pod > MAX_RSS_BYTES_PER_POD:
        print(
            f"memsmoke: FAIL RSS/pod {rss_per_pod:.0f} B > {MAX_RSS_BYTES_PER_POD} B "
            "— a dense per-pod structure crept back in"
        )
        ok = False
    plugin.stop()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
