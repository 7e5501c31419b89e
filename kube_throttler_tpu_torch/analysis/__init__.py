"""Repo-native static analyzer over the port: lock discipline, string-
keyed registry consistency, blocking-under-lock (device syncs and kernel
launches included), thread-lifecycle, exception-safety, cross-process
protocol checking, int64 milli-plane dtype discipline, verdict-epoch
coherence, transport deadline discipline, and trust-boundary taint
checking.

Run as ``python -m kube_throttler_tpu_torch.analysis`` from the
repository root: with no arguments it analyzes this package against the
waivers in ``kube_throttler_tpu_torch/analysis_waivers/``. Checkers:

- ``guarded``   — guarded-by attribute discipline (guarded.py)
- ``lockorder`` — static lock-acquisition order graph (lockgraph.py)
- ``registry``  — fault-site and metric-name registries (registry.py)
- ``blocking``  — blocking calls reached under a named lock, among them
  the port's kernel wrappers and the routes that call them
  (``kernel:<name>()``), ``.cpu()``, ``.item()`` and
  ``torch.cuda.synchronize()`` (blocking.py)
- ``threads``   — silent thread death / daemon-under-lock / unbounded
  shutdown joins (threads.py)
- ``excsafety`` — fd/lock/reservation leaks on exception paths (excsafety.py)
- ``protocol``  — journal control lines, IPC frame types, fencing-epoch
  domination (protocol.py)
- ``dtype``     — int64 milli-plane dtype discipline: narrowing casts
  (numpy ``astype`` and torch ``.to``/``.type``/``.int()``/``.float()``
  ...), narrow accumulators (``index_add_``/``scatter_add_`` into a
  narrow destination too), default-dtype allocations (device.py)
- ``envguard``  — numeric ``KT_*`` env parses need try/except guards
  (envguard.py)
- ``epochs``    — verdict-epoch coherence: every write to a declared
  verdict-affecting plane is dominated by an epoch bump (epochs.py)
- ``deadlines`` — blocking socket/RPC ops reached from the
  sharding/replication transports carry a timeout (deadlines.py)
- ``taint``     — trust-boundary taint: network bytes pass the
  ``hmac.compare_digest`` gate before ``pickle.loads``/``json.loads``
  (taint.py)

The JAX package's analyzer has three more checkers, and this one has
not copied them: ``purity`` (trace purity of ``jax.jit``, ``pallas_call``
and ``shard_map`` bodies), ``donation`` (reads after a ``donate_argnums``
dispatch) and ``retrace`` (jit entries see only padded or static shapes).
The port has no ``jax.jit``, no ``donate_argnums``, no ``pallas_call``
and no ``shard_map``, so each would look at nothing.

The runtime counterparts — the instrumented-lock assassin and hold-time
budgets (``KT_LOCK_ASSERT=1``, ``utils/lockorder.py``), the Eraser-style
lockset race detector (``KT_RACE_DETECT=1``, ``utils/racedetect.py``,
waivers in ``analysis_waivers/race_allow.txt``) and the verdict-coherence
assassin (``KT_EPOCH_ASSERT=1``, ``utils/epochassert.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from . import (
    blocking,
    deadlines,
    device,
    envguard,
    epochs,
    excsafety,
    guarded,
    lockgraph,
    protocol,
    registry,
    taint,
    threads,
)
from .core import Finding, Module, apply_baseline, load_baseline, load_package

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIVERS_DIR = os.path.join(PACKAGE_ROOT, "analysis_waivers")
DEFAULT_BASELINE = os.path.join(WAIVERS_DIR, "baseline.txt")
DEFAULT_ALLOWLIST = os.path.join(WAIVERS_DIR, "lockorder_allow.txt")
DEFAULT_BLOCKING_ALLOWLIST = os.path.join(WAIVERS_DIR, "blocking_allow.txt")
DEFAULT_EPOCH_ALLOWLIST = os.path.join(WAIVERS_DIR, "epoch_allow.txt")
DEFAULT_DEADLINE_ALLOWLIST = os.path.join(WAIVERS_DIR, "deadline_allow.txt")

CHECKERS = (
    "guarded",
    "lockorder",
    "registry",
    "blocking",
    "threads",
    "excsafety",
    "protocol",
    "dtype",
    "envguard",
    "epochs",
    "deadlines",
    "taint",
)


def run_checks(
    modules: Sequence[Module],
    checks: Sequence[str] = CHECKERS,
    allowlist_path: Optional[str] = DEFAULT_ALLOWLIST,
    blocking_allowlist_path: Optional[str] = DEFAULT_BLOCKING_ALLOWLIST,
    epoch_allowlist_path: Optional[str] = DEFAULT_EPOCH_ALLOWLIST,
    deadline_allowlist_path: Optional[str] = DEFAULT_DEADLINE_ALLOWLIST,
    stale_allow_out: Optional[Dict[str, List[Tuple[str, str]]]] = None,
) -> List[Finding]:
    """Run the selected checkers over ``modules``. ``stale_allow_out``
    (when given) maps checker name -> dead allowlist pairs so the CLI can
    error on (and ``--prune-stale``) waiver rot."""
    findings: List[Finding] = []
    if "guarded" in checks:
        findings.extend(guarded.check(modules))
    if "lockorder" in checks:
        stale: Optional[List[Tuple[str, str]]] = (
            stale_allow_out.setdefault("lockorder", [])
            if stale_allow_out is not None
            else None
        )
        findings.extend(
            lockgraph.check(modules, allowlist_path=allowlist_path, stale_out=stale)
        )
    if "registry" in checks:
        findings.extend(registry.check(modules))
    if "blocking" in checks:
        stale = (
            stale_allow_out.setdefault("blocking", [])
            if stale_allow_out is not None
            else None
        )
        findings.extend(
            blocking.check(
                modules,
                allowlist_path=blocking_allowlist_path,
                stale_out=stale,
            )
        )
    if "threads" in checks:
        findings.extend(threads.check(modules))
    if "excsafety" in checks:
        findings.extend(excsafety.check(modules))
    if "protocol" in checks:
        findings.extend(protocol.check(modules))
    if "dtype" in checks:
        findings.extend(device.check(modules))
    if "envguard" in checks:
        findings.extend(envguard.check(modules))
    if "epochs" in checks:
        stale = (
            stale_allow_out.setdefault("epochs", [])
            if stale_allow_out is not None
            else None
        )
        findings.extend(
            epochs.check(modules, allowlist_path=epoch_allowlist_path, stale_out=stale)
        )
    if "deadlines" in checks:
        stale = (
            stale_allow_out.setdefault("deadlines", [])
            if stale_allow_out is not None
            else None
        )
        findings.extend(
            deadlines.check(
                modules, allowlist_path=deadline_allowlist_path, stale_out=stale
            )
        )
    if "taint" in checks:
        findings.extend(taint.check(modules))
    findings.sort(key=lambda f: (f.relpath or f.path, f.line, f.checker, f.message))
    return findings


def run_repo(
    root: str = PACKAGE_ROOT,
    checks: Sequence[str] = CHECKERS,
    baseline_path: Optional[str] = DEFAULT_BASELINE,
    allowlist_path: Optional[str] = DEFAULT_ALLOWLIST,
    blocking_allowlist_path: Optional[str] = DEFAULT_BLOCKING_ALLOWLIST,
    epoch_allowlist_path: Optional[str] = DEFAULT_EPOCH_ALLOWLIST,
    deadline_allowlist_path: Optional[str] = DEFAULT_DEADLINE_ALLOWLIST,
    stale_allow_out: Optional[Dict[str, List[Tuple[str, str]]]] = None,
):
    """(new, waived, stale) findings for the package at ``root``."""
    modules = load_package(root)
    findings = run_checks(
        modules,
        checks,
        allowlist_path,
        blocking_allowlist_path=blocking_allowlist_path,
        epoch_allowlist_path=epoch_allowlist_path,
        deadline_allowlist_path=deadline_allowlist_path,
        stale_allow_out=stale_allow_out,
    )
    baseline = load_baseline(baseline_path) if baseline_path else {}
    return apply_baseline(findings, baseline)
