#!/usr/bin/env python3
"""Times the port's ``victim_select`` kernel alone, beside its wrapper call,
for the port of this checkout or of another one, on one CUDA card.

    python3 victim_timing.py [TREE]

TREE (default: this checkout) is the root of a checkout whose
``kube_throttler_tpu_torch`` is imported, built and timed. The problems and
the timing come from this checkout's ``chip_smoke.py`` (``victim_problem``,
``compare_victim``), which call only the public wrapper and its plain
version, so two checkouts, say a parent and a change unpacked with
``git archive``, are timed on the same inputs in the same way.

The cells are the walks that stop within a few rows, where the launch and
the kernel's set-up are the whole time: the smoke's ``[victim]`` cells at
cap 1 and every cell with N <= 40 (the smoke's seeded data), and a problem
of the preemption cycle's padded shape, 256 × 4 (one deficit dim of 500
milli-cpu, 205 candidates of 1 cpu, the policy's cap of 32). Per cell one
``[victim-timing]`` line: the wrapper's ms over back-to-back calls (CUDA
events; host time included where the host is the slower) and the kernel's
alone (the same calls captured in one CUDA graph, so no host time falls
between the kernels), each cell's outputs held against the plain version.
The card's ``nvidia-smi`` name and power limit come first, and the last
line is one JSON object of every cell.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CALLS = 50  # calls per timing


def main() -> int:
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    if not (tree / "kube_throttler_tpu_torch" / "__init__.py").is_file():
        print(f"victim_timing: no kube_throttler_tpu_torch/ in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("victim_timing: CUDA is not available", file=sys.stderr)
        return 2
    from kube_throttler_tpu_torch.ops import victim_select as vsel

    print(smoke.card_line(), flush=True)
    smoke.say("victim-timing-tree", tree=str(tree), module=vsel.__file__)

    # the smoke's [victim] data, drawn in the smoke's order from its seed
    rng = np.random.default_rng(smoke.SEED + 5)
    cells = []
    for N, M, extremes in ([(N, M, False) for N, M in smoke.VICTIM_CELLS]
                           + [(*smoke.VICTIM_EXTREMES_CELL, True)]):
        contrib, deficit = smoke.victim_problem(rng, N, M, extremes)
        caps = sorted({0, 1, N // 2}) if N <= 40 else [1]
        cells += [(f"{N}x{M}", contrib, deficit, cap) for cap in caps]
    contrib = np.zeros((256, 4), dtype=np.int64)
    contrib[:205, 0] = 1000
    deficit = np.array([500, 0, 0, 0], dtype=np.int64)
    cells.append(("256x4-preempt", contrib, deficit, 32))

    rows, ok = [], True
    for name, contrib, deficit, cap in cells:
        same, _err, k_ms, only_ms, _p_ms, bound, _ = smoke.compare_victim(contrib, deficit, cap,
                                                                          CALLS)
        ok = ok and same
        rows.append({"cell": name, "cap": cap, "equal": same, "ms": k_ms,
                     "kernel_only_ms": only_ms, "rows_walked": bound["rows_walked"]})
        smoke.say("victim-timing", cell=name, cap=cap, equal=same, wrapper_ms=f"{k_ms:.5f}",
                  kernel_only_ms=f"{only_ms:.5f}", rows_walked=bound["rows_walked"])
    print(json.dumps({"tree": str(tree), "ok": ok, "cells": rows}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
