"""The program's readings and the control's, over many seeds, in one
process (set-up is long; the check is not).

    python3 -m gpubench.control --workload <cell> --seconds <s> --seeds <n> ...

For each seed, one run of the cell as the benchmark makes it, whose
window outputs are judged twice: against the plain reference (the
program's reading) and against the reference with the configuration's
stated guarantee broken (its ``control``, the control's reading). The
lower reading of a limit is the largest the program gives; the upper,
the smallest the control gives. One JSON line per seed; the benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from gpubench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = run.resolve_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = run.run_cell(cell, seed, args.seconds, False, "cuda", control=cell.config["control"])
        print(json.dumps({"seed": seed, "correct": out["correct"], "checks": out["checks"],
                          "control": cell.config["control"],
                          "control_checks": out["control_checks"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
