"""CLI for the repo-native static analyzer.

Exit status: 0 when every finding is either absent or waived in the
baseline AND every waiver is still live; 1 when new findings exist (they
are printed ``path:line: [checker] message``) OR any baseline/allowlist
entry is stale (a waiver whose finding no longer exists is waiver rot —
it hides nothing today and will silently hide a regression tomorrow).
``--prune-stale`` rewrites the baseline and allow files dropping the
dead entries instead of failing on them.
"""

from __future__ import annotations

import argparse
import sys

from . import (
    CHECKERS,
    DEFAULT_ALLOWLIST,
    DEFAULT_BASELINE,
    DEFAULT_BLOCKING_ALLOWLIST,
    DEFAULT_DEADLINE_ALLOWLIST,
    DEFAULT_EPOCH_ALLOWLIST,
    PACKAGE_ROOT,
    run_checks,
)
from .core import apply_baseline, load_baseline, load_package, prune_file_lines
from .lockgraph import build_edges


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kube_throttler_tpu_torch.analysis",
        description=(
            "lock discipline / registry / blocking / thread / "
            "exception-safety / protocol / dtype / envguard / epochs / "
            "deadlines / taint static analyzer over the port"
        ),
    )
    ap.add_argument("--root", default=PACKAGE_ROOT, help="package root to analyze")
    ap.add_argument(
        "--checks",
        default=",".join(CHECKERS),
        help=f"comma-separated subset of: {', '.join(CHECKERS)}",
    )
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--allowlist", default=None)
    ap.add_argument("--blocking-allowlist", default=None)
    ap.add_argument("--epoch-allowlist", default=None)
    ap.add_argument("--deadline-allowlist", default=None)
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding (ignore the baseline)",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="append new findings to the baseline with TODO justifications",
    )
    ap.add_argument(
        "--prune-stale",
        action="store_true",
        help="delete stale baseline/allowlist entries instead of failing on them",
    )
    ap.add_argument(
        "--dump-lock-graph",
        action="store_true",
        help="print the raw acquired-while-holding edges and exit",
    )
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    checks = tuple(c.strip() for c in args.checks.split(",") if c.strip())
    bad = [c for c in checks if c not in CHECKERS]
    if bad:
        ap.error(f"unknown checker(s): {', '.join(bad)}")

    modules = load_package(args.root)
    if args.dump_lock_graph:
        for (a, b), (path, line, ctx) in sorted(build_edges(modules).items()):
            print(f"{a} -> {b}    # {path}:{line} ({ctx})")
        return 0

    # stale-allowlist enforcement only makes sense when the allow file
    # and the analyzed tree belong together: the default allow files
    # against the default root (the repo gate), or an explicitly given
    # file (fixture tests). A custom --root against the repo's defaults
    # is mismatched by construction — findings are still filtered, but
    # unmatched entries are not waiver rot.
    import os as _os

    root_is_default = _os.path.abspath(args.root) == _os.path.abspath(PACKAGE_ROOT)
    enforce_stale = {
        "lockorder": root_is_default or args.allowlist is not None,
        "blocking": root_is_default or args.blocking_allowlist is not None,
        "epochs": root_is_default or args.epoch_allowlist is not None,
        "deadlines": root_is_default or args.deadline_allowlist is not None,
    }
    allowlist = args.allowlist if args.allowlist is not None else DEFAULT_ALLOWLIST
    blocking_allowlist = (
        args.blocking_allowlist
        if args.blocking_allowlist is not None
        else DEFAULT_BLOCKING_ALLOWLIST
    )
    epoch_allowlist = (
        args.epoch_allowlist
        if args.epoch_allowlist is not None
        else DEFAULT_EPOCH_ALLOWLIST
    )
    deadline_allowlist = (
        args.deadline_allowlist
        if args.deadline_allowlist is not None
        else DEFAULT_DEADLINE_ALLOWLIST
    )

    stale_allow: dict = {}
    findings = run_checks(
        modules,
        checks,
        allowlist_path=allowlist,
        blocking_allowlist_path=blocking_allowlist,
        epoch_allowlist_path=epoch_allowlist,
        deadline_allowlist_path=deadline_allowlist,
        stale_allow_out=stale_allow,
    )
    stale_allow = {
        checker: pairs
        for checker, pairs in stale_allow.items()
        if enforce_stale.get(checker)
    }
    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    # a waiver of a checker that did not run is neither live nor stale:
    # --checks blocking,dtype neither fails on nor prunes the others'
    baseline = {k: v for k, v in baseline.items() if k.split("|", 1)[0] in checks}
    new, waived, stale = apply_baseline(findings, baseline)

    for f in new:
        print(f.render())
    if args.write_baseline and new:
        with open(args.baseline, "a", encoding="utf-8") as fh:
            for f in new:
                fh.write(f"{f.key()}  # TODO: justify or fix\n")
        print(f"wrote {len(new)} new waiver(s) to {args.baseline}", file=sys.stderr)
        return 0

    allow_paths = {
        "lockorder": allowlist,
        "blocking": blocking_allowlist,
        "epochs": epoch_allowlist,
        "deadlines": deadline_allowlist,
    }
    n_stale_allow = sum(len(v) for v in stale_allow.values())
    if args.prune_stale:
        pruned = 0
        if stale:
            stale_set = set(stale)
            pruned += prune_file_lines(
                args.baseline, lambda body: body in stale_set
            )
        for checker, pairs in stale_allow.items():
            if not pairs:
                continue
            dead = {f"{a} -> {b}" for a, b in pairs}

            def _is_stale(body: str, dead=dead) -> bool:
                a, _, b = body.partition("->")
                return f"{a.strip()} -> {b.strip()}" in dead

            pruned += prune_file_lines(allow_paths[checker], _is_stale)
        if pruned and not args.quiet:
            print(f"pruned {pruned} stale waiver(s)", file=sys.stderr)
        stale, stale_allow, n_stale_allow = [], {}, 0

    for k in stale:
        print(f"error: stale baseline entry (fix: --prune-stale): {k}")
    for checker, pairs in stale_allow.items():
        for a, b in pairs:
            print(
                f"error: stale {checker} allowlist entry (fix: --prune-stale): "
                f"{a} -> {b}"
            )
    if not args.quiet:
        print(
            f"analysis: {len(new)} new finding(s), {len(waived)} waived, "
            f"{len(stale) + n_stale_allow} stale waiver(s) over "
            f"{len(modules)} file(s)",
            file=sys.stderr,
        )
    return 1 if (new or stale or n_stale_allow) else 0


if __name__ == "__main__":
    sys.exit(main())
