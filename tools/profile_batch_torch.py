"""Profile ``pre_filter_batch`` phases on the PyTorch/CUDA port: the copy
of ``tools/profile_batch.py`` over ``kube_throttler_tpu_torch``. Run:

    python tools/profile_batch_torch.py [P] [T] [--device {cuda,cpu}]

It builds the served stack (``tools/served_stack_torch.py``) at P pods ×
T Throttles (10,000 × 1,000 by default) on the device (``cuda`` by
default; exits 1 without a CUDA device), runs one batch to warm it, times
one and profiles one under ``cProfile``. For the timed and the profiled
call it also prints one ``split`` line (JSON): the wall ms, the plugin
tracer's dedupe / dispatch / merge ms and each kernel's launches during
the call, read with the card synchronised. A batch under 50,000 pods
dedupes on the host and reaches no kernel unless the verdict cache is
off (``KT_VERDICT_CACHE=0``).
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("batch_dedupe", "batch_dispatch", "batch_merge")


def main(argv=None) -> int:
    from kube_throttler_tpu_torch.utils.platform import add_device_argument, device_or_report
    from tools.served_stack_torch import build_served_stack, measured_call

    parser = argparse.ArgumentParser(prog="profile_batch_torch.py")
    parser.add_argument("P", type=int, nargs="?", default=10_000)
    parser.add_argument("T", type=int, nargs="?", default=1_000)
    add_device_argument(parser, "the served stack's device data plane")
    args = parser.parse_args(argv)
    device = device_or_report(args.device)
    if device is None:
        return 1

    store, plugin = build_served_stack(args.P, args.T, label="prof", device=device)
    try:
        plugin.pre_filter_batch()  # warm: first uploads and launches

        t0 = time.perf_counter()
        out, warm = measured_call(plugin, plugin.pre_filter_batch, PHASES)
        print(f"warm pre_filter_batch: {(time.perf_counter()-t0)*1e3:.1f}ms "
              f"for {len(out['schedulable'])} pods")
        print("split " + json.dumps({"call": "warm", "device": str(device), **warm}))

        pr = cProfile.Profile()
        pr.enable()
        _, profiled = measured_call(plugin, plugin.pre_filter_batch, PHASES)
        pr.disable()
        print("split " + json.dumps({"call": "profiled", "device": str(device), **profiled}))
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(30)
        print(s.getvalue())
    finally:
        plugin.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
