"""Adversarial hunt CLI.

Usage:
    python -m kube_throttler_tpu_torch.scenarios.hunt run   [--budget-s 600] [--iterations 40]
    python -m kube_throttler_tpu_torch.scenarios.hunt smoke [--workdir WD] [--report R.json]
    python -m kube_throttler_tpu_torch.scenarios.hunt long  [--budget-s 3600] [--mega-pods N]

``run`` is the nightly budgeted soak (`make scenario-hunt`): random
coverage-guided search from the base programs, findings shrunk and
promoted into ``scenarios/corpus/regressions/``.

``smoke`` is the CI acceptance check (`make scenario-hunt-smoke`,
hack/ci.sh): the planted-bug program (a mock.status.delay stall inside
the searched space) is seeded into the corpus; the run must FIND it
(flip gate fails through the real stack), CONFIRM it, SHRINK it to a
minimal program, and PROMOTE it — exit 1 otherwise. The coverage report
is the archived artifact.

``long`` evaluates the long-horizon tier programs (multi-virtual-day
diurnal soaks, durability-cycle churn, the 1M-pod arena rung) and then
mutates from them for the remaining budget.

Every subcommand takes ``--device {cuda,cpu}`` (``cuda`` by default): the
stack each evaluation runs in its fresh interpreter, and without a CUDA
device ``cuda`` exits non-zero before the search starts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from ...utils.platform import add_device_argument, device_or_report
from .longhorizon import MEGA_PODS_DEFAULT, long_horizon_programs
from .loop import HuntConfig, base_programs, hunt, planted_bug_program


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--workdir", default="")
    p.add_argument("--report", default="", help="coverage report path")
    p.add_argument("--budget-s", type=float, default=600.0)
    p.add_argument("--iterations", type=int, default=40)
    p.add_argument("--hunt-seed", type=int, default=0)
    p.add_argument("--trace-seed", type=int, default=0)
    p.add_argument(
        "--promote-dir", default="",
        help="where shrunk repros land (default: the committed corpus)",
    )
    p.add_argument(
        "--no-promote", action="store_true",
        help="report findings without writing regression-corpus entries",
    )
    add_device_argument(p, "every evaluation's device data plane")


def _config(args, **overrides) -> HuntConfig:
    workdir = args.workdir or tempfile.mkdtemp(prefix="kt-hunt-")
    os.makedirs(workdir, exist_ok=True)
    kwargs = dict(
        workdir=workdir,
        budget_s=args.budget_s,
        max_iterations=args.iterations,
        hunt_seed=args.hunt_seed,
        trace_seed=args.trace_seed,
        do_promote=not args.no_promote,
        report_path=args.report or None,
        device=args.device,
    )
    if args.promote_dir:
        kwargs["promote_dir"] = args.promote_dir
    kwargs.update(overrides)
    return HuntConfig(**kwargs)


def _summarize(report: dict) -> None:
    cov = report["coverage"]
    print(
        f"hunt: {report['iterations']} iterations in {report['wall_s']:.0f}s | "
        f"coverage {cov['coverage_keys']} keys "
        f"({cov['by_class']}) | corpus {report['corpus_size']} | "
        f"findings {len(report['findings'])} | promoted {len(report['promoted'])}"
    )
    for f in report["findings"]:
        print(
            f"  FINDING {f['found_program']} failed {f['failed_gates']} → "
            f"shrunk to {f['minimal_program']} "
            f"(size {f['minimal_size']}, {f['shrink_steps']} steps)"
            + (f" → promoted {f['promoted_path']}" if "promoted_path" in f else "")
        )
    print(f"coverage report: {report['report_path']}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kube_throttler_tpu_torch.scenarios.hunt")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("run", "smoke", "long"):
        p = sub.add_parser(name)
        _common(p)
        if name == "long":
            p.add_argument("--mega-pods", type=int, default=MEGA_PODS_DEFAULT)
            p.add_argument("--skip-mega", action="store_true")
            p.add_argument("--days", type=int, default=3)
    args = parser.parse_args(argv)

    # without a CUDA device '--device cuda' exits here, before any search
    if device_or_report(args.device) is None:
        return 1

    if args.command == "run":
        report = hunt(_config(args))
        _summarize(report)
        return 0

    if args.command == "smoke":
        # small budget, planted bug seeded into the search corpus; ops-only
        # shrink stages keep the fresh-interpreter evaluation count small
        cfg = _config(
            args,
            budget_s=min(args.budget_s, 480.0),
            max_iterations=min(args.iterations, 6),
            bases=[base_programs()[0]],  # one clean baseline, then the plant
            extra_programs=[planted_bug_program()],
            shrink_stages=("faults", "flags", "arrival"),
            shrink_max_attempts=6,
            max_findings=1,
            stop_on_finding=True,
        )
        report = hunt(cfg)
        _summarize(report)
        found = [f for f in report["findings"] if "flip_p99" in f["failed_gates"]]
        promoted_ok = bool(report["promoted"]) or (
            not cfg.do_promote and bool(report["findings"])
        )
        if not (found and promoted_ok):
            print(
                "HUNT SMOKE FAILED: the planted mock.status.delay regression "
                "was not found+shrunk+promoted", file=sys.stderr,
            )
            return 1
        minimal_sizes = [f["minimal_size"] for f in found]
        if min(minimal_sizes) > 2:
            print(
                f"HUNT SMOKE FAILED: minimal repro size {min(minimal_sizes)} > 2 "
                "DSL ops (shrinker regressed)", file=sys.stderr,
            )
            return 1
        print("hunt smoke: planted bug found, shrunk, promoted — OK")
        return 0

    # long
    programs = long_horizon_programs(
        days=args.days, mega_pods=args.mega_pods, include_mega=not args.skip_mega
    )
    cfg = _config(args, bases=programs)
    report = hunt(cfg)
    _summarize(report)
    # the long tier doubles as a gate: its committed programs must pass
    failing = [
        line for line in report["log"]
        if line.get("origin") == "base" and line.get("failed_gates")
    ]
    if failing:
        print(json.dumps(failing, indent=2))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
