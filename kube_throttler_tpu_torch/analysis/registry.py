"""Checker 4: string-keyed registry consistency.

Two registries in this codebase are keyed by inline strings, and both
have drifted in past PRs (a fault site that no rule ever matches fires
nothing silently; a metric family created under an undeclared name never
shows up where dashboards look):

- **fault sites**: every literal site passed to ``*.check(site)`` /
  ``*.maybe_raise(site)`` on a ``faults`` object must be a member of
  ``faults.plan.KNOWN_SITES``; every literal ``FaultRule(site=...)``
  pattern must ``fnmatch`` at least one known site;
- **metric names**: every literal name passed to ``gauge_vec`` /
  ``counter_vec`` / ``histogram_vec`` must be a member of
  ``metrics.METRIC_NAMES`` (the single declaration point — families
  built from f-strings in ``metrics.py`` are enumerated there
  explicitly).

Both registries are read straight from the AST of their defining module
(a ``frozenset({...})`` / set/tuple literal assignment), so the checker
needs no imports of the package under analysis.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import List, Optional, Sequence, Set

from .core import Finding, Module, literal_str, unparse

_VEC_FACTORIES = {"gauge_vec", "counter_vec", "histogram_vec"}
_FAULT_METHODS = {"check", "maybe_raise"}


def _literal_str_set(module: Module, varname: str) -> Optional[Set[str]]:
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == varname:
                    try:
                        val = ast.literal_eval(node.value)
                    except ValueError:
                        # frozenset({...}) is a Call — eval its single arg
                        if (
                            isinstance(node.value, ast.Call)
                            and unparse(node.value.func).endswith("frozenset")
                            and node.value.args
                        ):
                            try:
                                val = ast.literal_eval(node.value.args[0])
                            except ValueError:
                                return None
                        else:
                            return None
                    if isinstance(val, (set, frozenset, tuple, list)):
                        return {str(v) for v in val}
    return None


def _find_module(modules: Sequence[Module], suffix: str) -> Optional[Module]:
    for m in modules:
        if m.relpath.replace("\\", "/").endswith(suffix):
            return m
    return None


def check(modules: Sequence[Module]) -> List[Finding]:
    findings: List[Finding] = []

    plan_mod = _find_module(modules, "faults/plan.py")
    known_sites = (
        _literal_str_set(plan_mod, "KNOWN_SITES") if plan_mod is not None else None
    )
    metrics_mod = _find_module(modules, "metrics.py")
    metric_names = (
        _literal_str_set(metrics_mod, "METRIC_NAMES")
        if metrics_mod is not None
        else None
    )

    if plan_mod is not None and known_sites is None:
        findings.append(
            Finding(
                checker="registry",
                path=plan_mod.path,
                relpath=plan_mod.relpath,
                line=1,
                message="faults/plan.py must declare KNOWN_SITES as a literal set of site names",
            )
        )
    if metrics_mod is not None and metric_names is None:
        findings.append(
            Finding(
                checker="registry",
                path=metrics_mod.path,
                relpath=metrics_mod.relpath,
                line=1,
                message="metrics.py must declare METRIC_NAMES as a literal set of family names",
            )
        )

    for m in modules:
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            # fault sites
            if (
                known_sites is not None
                and f.attr in _FAULT_METHODS
                and "faults" in unparse(f.value)
                and node.args
            ):
                site = literal_str(node.args[0])
                if site is not None and site not in known_sites:
                    findings.append(
                        Finding(
                            checker="registry",
                            path=m.path,
                            relpath=m.relpath,
                            line=node.lineno,
                            message=(
                                f"fault site '{site}' is not registered in "
                                "faults.plan.KNOWN_SITES"
                            ),
                        )
                    )
            # FaultRule site patterns
            if (
                known_sites is not None
                and (
                    (isinstance(f.value, ast.Name) and f.attr == "FaultRule")
                    or unparse(f).endswith("FaultRule")
                )
            ):
                pattern = None
                if node.args:
                    pattern = literal_str(node.args[0])
                for kw in node.keywords:
                    if kw.arg == "site":
                        pattern = literal_str(kw.value)
                if pattern is not None and not any(
                    fnmatch.fnmatch(s, pattern) for s in known_sites
                ):
                    findings.append(
                        Finding(
                            checker="registry",
                            path=m.path,
                            relpath=m.relpath,
                            line=node.lineno,
                            message=(
                                f"FaultRule pattern '{pattern}' matches no "
                                "site in faults.plan.KNOWN_SITES"
                            ),
                        )
                    )
            # metric family names
            if metric_names is not None and f.attr in _VEC_FACTORIES and node.args:
                name = literal_str(node.args[0])
                if name is not None and name not in metric_names:
                    findings.append(
                        Finding(
                            checker="registry",
                            path=m.path,
                            relpath=m.relpath,
                            line=node.lineno,
                            message=(
                                f"metric family '{name}' is not declared in "
                                "metrics.METRIC_NAMES"
                            ),
                        )
                    )
    # plain FaultRule(...) constructor calls by bare name
    if known_sites is not None:
        for m in modules:
            for node in ast.walk(m.tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "FaultRule"
                ):
                    pattern = None
                    if node.args:
                        pattern = literal_str(node.args[0])
                    for kw in node.keywords:
                        if kw.arg == "site":
                            pattern = literal_str(kw.value)
                    if pattern is not None and not any(
                        fnmatch.fnmatch(s, pattern) for s in known_sites
                    ):
                        findings.append(
                            Finding(
                                checker="registry",
                                path=m.path,
                                relpath=m.relpath,
                                line=node.lineno,
                                message=(
                                    f"FaultRule pattern '{pattern}' matches no "
                                    "site in faults.plan.KNOWN_SITES"
                                ),
                            )
                        )
    return findings
