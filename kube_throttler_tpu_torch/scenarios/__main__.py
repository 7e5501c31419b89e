"""Scenario engine CLI.

Usage:
    python -m kube_throttler_tpu_torch.scenarios list
    python -m kube_throttler_tpu_torch.scenarios run --name hotkey_throttle [--seed 0]
    python -m kube_throttler_tpu_torch.scenarios run --file program.json [--seed 0]
    python -m kube_throttler_tpu_torch.scenarios matrix [--seeds 0,1,2] [--names a,b]
    python -m kube_throttler_tpu_torch.scenarios regression --name smoke [--seed 0]
    python -m kube_throttler_tpu_torch.scenarios regressions [--workdir WD]
    python -m kube_throttler_tpu_torch.scenarios trace --name smoke --seed 0

``make scenario-test`` runs ``matrix`` over the full corpus × 3 seeds and
exits non-zero if any SLO gate fails. ``regression`` runs one scenario
clean AND with the injected flip-stall regression, prints the per-gate
diff report, and exits non-zero unless the regression demonstrably fails
a gate the clean run passed (the gate-actually-gates acceptance check).
``run --file`` replays an arbitrary DSL program from JSON
(dsl.scenario_from_dict) — the hunt's fresh-interpreter evaluation hook.
``regressions`` replays every hunt-promoted repro committed under
``scenarios/corpus/regressions/`` and enforces each entry's pinned
verdict (``expect: fail:<gate>`` must still fail exactly that gate;
``expect: pass`` must go green) — the permanent tier gate.

Every subcommand that runs a stack (``run``, ``matrix``, ``regression``,
``regressions``) takes ``--device {cuda,cpu}``: ``cuda`` (the default)
exits non-zero before it builds anything when there is no CUDA device,
and the isolated child interpreters get the same ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def _run_isolated(name: str, seed: int, workdir: str, regression=None,
                  device: str = "cuda"):
    """One scenario in a FRESH interpreter. Sequential in-process runs
    contaminate each other (each build freezes the previous runs' heaps
    and inherits their compile caches/RSS — measured 79ms → 440ms flip
    p99 by run five of a shared process), so the matrix and the
    clean-vs-regressed comparison isolate every run. Returns (report or
    None, CompletedProcess)."""
    os.makedirs(workdir, exist_ok=True)
    cmd = [
        sys.executable, "-m", "kube_throttler_tpu_torch.scenarios", "run",
        "--name", name, "--seed", str(seed), "--workdir", workdir,
        "--device", device,
    ]
    if regression:
        cmd += ["--regression", regression]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
    report_path = os.path.join(workdir, f"report-{name}-s{seed}.json")
    report = None
    if os.path.exists(report_path):
        with open(report_path) as f:
            report = json.load(f)
    return report, proc


def _gate_line(report: dict) -> str:
    bits = []
    for name, g in sorted(report["gates"].items()):
        bits.append(f"{name}={'PASS' if g['pass'] else 'FAIL'}")
    m = report["measurements"]
    extra = (
        f"flip_p99={m['flip_lag_p99_ms']:.1f}ms/{m['flip_samples']}smp "
        f"eps={m['events_per_sec']:,.0f} restarts={m['restarts']}"
    )
    if m.get("recovery_s") is not None:
        extra += f" recovery={m['recovery_s']:.2f}s"
    return f"{' '.join(bits)} | {extra}"


def _add_device(p) -> None:
    from ..utils.platform import add_device_argument

    add_device_argument(p, "both plugins' device data plane")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kube_throttler_tpu_torch.scenarios")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("list", help="list the corpus")

    run = sub.add_parser("run", help="one scenario run")
    run.add_argument("--name", default="")
    run.add_argument("--file", default="", help="DSL program JSON (hunt mutants)")
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--workdir", default="")
    run.add_argument("--regression", default=None, choices=[None, "flip_stall"])
    _add_device(run)

    regs = sub.add_parser(
        "regressions",
        help="replay the committed hunt-promoted repros, enforce pinned verdicts",
    )
    regs.add_argument("--workdir", default="")
    _add_device(regs)

    tr = sub.add_parser("trace", help="emit a committed trace (stdout)")
    tr.add_argument("--name", required=True)
    tr.add_argument("--seed", type=int, default=0)

    matrix = sub.add_parser("matrix", help="corpus × seeds, exit 1 on any gate failure")
    matrix.add_argument("--seeds", default="0,1,2")
    matrix.add_argument("--names", default="")
    matrix.add_argument("--workdir", default="")
    _add_device(matrix)

    reg = sub.add_parser(
        "regression", help="clean vs injected-regression diff for one scenario"
    )
    reg.add_argument("--name", default="smoke")
    reg.add_argument("--seed", type=int, default=0)
    reg.add_argument("--workdir", default="")
    _add_device(reg)

    args = parser.parse_args(argv)

    from .corpus import corpus, get_scenario

    if args.command == "list":
        for scn in corpus(include_smoke=True):
            print(f"{scn.name:<18} {scn.description}")
        return 0

    if args.command == "trace":
        from .trace import build_trace, serialize_trace

        scn = get_scenario(args.name)
        header, ops = build_trace(scn, args.seed)
        sys.stdout.buffer.write(serialize_trace(header, ops))
        return 0

    from ..utils.platform import device_or_report

    # the device, resolved before any stack or child interpreter: without
    # a CUDA device '--device cuda' exits here rather than running the CPU
    resolved = device_or_report(args.device)
    if resolved is None:
        return 1
    device = resolved.type

    from .engine import run_scenario

    def workdir_of(ns) -> str:
        if ns.workdir:
            os.makedirs(ns.workdir, exist_ok=True)
            return ns.workdir
        return tempfile.mkdtemp(prefix="kt-scenarios-")

    if args.command == "run":
        wd = workdir_of(args)
        if args.file:
            from .dsl import scenario_from_dict

            with open(args.file) as f:
                scn = scenario_from_dict(json.load(f))
        elif args.name:
            scn = get_scenario(args.name)
        else:
            print("run: one of --name / --file is required", file=sys.stderr)
            return 2
        from .hunt.mutate import needs_shard_tier

        if needs_shard_tier(scn):
            # shard.*/reshard.* sites only exist in the multiprocess
            # stack: route the program through the sharded replayer (one
            # live rescale included when reshard.* is armed) so hunt
            # mutants arming those sites actually fire them end to end
            from .sharded import run_sharded_program

            report = run_sharded_program(scn, args.seed, wd, device=device)
        else:
            report = run_scenario(
                scn, args.seed, wd, regression=args.regression, device=device
            )
        print(json.dumps(report, indent=2, default=str))
        return 0 if report["all_pass"] else 1

    if args.command == "regressions":
        from .corpus import load_regressions
        from .dsl import scenario_to_dict

        entries = load_regressions()
        if not entries:
            print("regression corpus is empty — nothing to gate")
            return 0
        wd_root = workdir_of(args)
        bad = 0
        for entry in entries:
            wd = os.path.join(wd_root, entry["name"])
            os.makedirs(wd, exist_ok=True)
            program_path = os.path.join(wd, "program.json")
            with open(program_path, "w") as f:
                json.dump(scenario_to_dict(entry["scenario"]), f)
            cmd = [
                sys.executable, "-m", "kube_throttler_tpu_torch.scenarios", "run",
                "--file", program_path, "--seed", str(entry["seed"]),
                "--workdir", wd, "--device", device,
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
            report_path = os.path.join(
                wd, f"report-{entry['scenario'].name}-s{entry['seed']}.json"
            )
            if not os.path.exists(report_path):
                bad += 1
                print(
                    f"FAIL {entry['name']}: no report (rc={proc.returncode})\n"
                    f"{proc.stdout[-1500:]}"
                )
                continue
            with open(report_path) as f:
                report = json.load(f)
            failed = sorted(
                g for g, v in report["gates"].items() if not v["pass"]
            )
            if entry["expect"] == "pass":
                ok = report["all_pass"]
                want = "all gates green"
            else:
                gate = entry["expect"].split(":", 1)[1]
                ok = gate in failed
                want = f"gate {gate} still failing"
            bad += 0 if ok else 1
            print(
                f"{'PASS' if ok else 'FAIL'} {entry['name']:<28} "
                f"expect={entry['expect']} got failed={failed or 'none'} "
                f"({want})"
            )
        print(f"\n{len(entries) - bad}/{len(entries)} regression repros verdict-stable")
        return 1 if bad else 0

    if args.command == "regression":
        from .slo import diff_reports

        wd = workdir_of(args)
        clean, p1 = _run_isolated(
            args.name, args.seed, os.path.join(wd, "clean"), device=device
        )
        regressed, p2 = _run_isolated(
            args.name, args.seed, os.path.join(wd, "regressed"),
            regression="flip_stall", device=device,
        )
        if clean is None or regressed is None:
            print(f"run crashed:\n{p1.stdout[-2000:]}\n{p2.stdout[-2000:]}")
            return 1
        print(diff_reports(clean, regressed))
        demonstrated = clean["all_pass"] and not regressed["all_pass"]
        print(
            "\nregression demonstrably failed its gate"
            if demonstrated
            else "\nREGRESSION NOT DEMONSTRATED (clean run failed, or the "
            "injected stall passed every gate)"
        )
        return 0 if demonstrated else 1

    # matrix
    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    names = [n for n in args.names.split(",") if n]
    scns = [get_scenario(n) for n in names] if names else corpus()
    wd_root = workdir_of(args)
    failures = 0
    for scn in scns:
        for seed in seeds:
            wd = os.path.join(wd_root, f"{scn.name}-s{seed}")
            try:
                report, proc = _run_isolated(scn.name, seed, wd, device=device)
            except Exception as e:  # noqa: BLE001 — a run must not kill the matrix
                failures += 1
                print(f"FAIL {scn.name:<18} seed={seed} crashed: {e!r}")
                continue
            if report is None:
                failures += 1
                print(
                    f"FAIL {scn.name:<18} seed={seed} no report "
                    f"(rc={proc.returncode}):\n{proc.stdout[-1500:]}"
                )
                continue
            ok = report["all_pass"]
            failures += 0 if ok else 1
            print(
                f"{'PASS' if ok else 'FAIL'} {scn.name:<18} seed={seed} "
                f"{_gate_line(report)}"
            )
    total = len(scns) * len(seeds)
    print(f"\n{total - failures}/{total} scenario runs green (workdir {wd_root})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
