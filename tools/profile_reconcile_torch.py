"""Profile the reconcile drain (cfg5's event → status path) on the
PyTorch/CUDA port: the copy of ``tools/profile_reconcile.py`` over
``kube_throttler_tpu_torch``. Run:

    python tools/profile_reconcile_torch.py [P] [T] [EVENTS] [--device {cuda,cpu}]

It builds the served stack (``tools/served_stack_torch.py``) at P pods ×
T Throttles (2,000 × 200 by default) on the device (``cuda`` by default;
exits 1 without a CUDA device), fires EVENTS (2,000) pod-churn events,
then profiles the synchronous drain under ``cProfile``: the per-batch cost
that sets status-commit lag. Beside the reference's output it prints one
``split`` line (JSON) for the drain: wall ms, the plugin tracer's
``agg_*`` phases (lock waits, snapshot, apply, flips, gather, decode) and
each kernel's launches, read with the card synchronised.
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import random
import sys
import time
from dataclasses import replace as dc_replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("agg_lock_wait", "agg_main_lock_wait", "agg_snapshot", "agg_apply",
          "agg_flips", "agg_gather", "agg_decode")


def main(argv=None) -> int:
    from kube_throttler_tpu_torch.api.pod import make_pod
    from kube_throttler_tpu_torch.utils.platform import add_device_argument, device_or_report
    from tools.served_stack_torch import build_served_stack, measured_call

    parser = argparse.ArgumentParser(prog="profile_reconcile_torch.py")
    parser.add_argument("P", type=int, nargs="?", default=2_000)
    parser.add_argument("T", type=int, nargs="?", default=200)
    parser.add_argument("EVENTS", type=int, nargs="?", default=2_000)
    add_device_argument(parser, "the served stack's device data plane")
    args = parser.parse_args(argv)
    device = device_or_report(args.device)
    if device is None:
        return 1

    store, plugin = build_served_stack(args.P, args.T, label="prof", device=device)
    try:
        rng = random.Random(1)
        pods = store.list_pods()

        def fire(n):
            for i in range(n):
                pod = pods[rng.randrange(len(pods))]
                updated = make_pod(
                    pod.name, labels=pod.labels,
                    requests={"cpu": f"{rng.randrange(1, 8) * 100}m"},
                )
                updated = dc_replace(updated, spec=dc_replace(updated.spec, node_name="node-1"))
                updated.status.phase = "Running"
                store.update_pod(updated)

        # warm the drain path
        fire(200)
        plugin.run_pending_once()

        t0 = time.perf_counter()
        fire(args.EVENTS)
        t_fire = time.perf_counter() - t0
        print(f"fired {args.EVENTS} events in {t_fire:.2f}s ({args.EVENTS/t_fire:,.0f}/s ingest)")

        pr = cProfile.Profile()
        pr.enable()
        n, drain = measured_call(plugin, plugin.run_pending_once, PHASES)
        pr.disable()
        t_drain = drain["ms"] / 1e3
        print(f"drained {n} keys in {t_drain:.2f}s ({n/t_drain:,.0f} keys/s)")
        print("split " + json.dumps({"call": "drain", "device": str(device), "keys": n, **drain}))
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(35)
        print(s.getvalue())
    finally:
        plugin.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
