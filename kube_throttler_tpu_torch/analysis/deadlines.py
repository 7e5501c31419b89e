"""Checker 14 (gen-4): deadline discipline on the sharding/replication
transports.

The partition-tolerance contract: every blocking operation on the
cross-host transport carries a deadline — a scatter RPC that outruns
its budget degrades fail-safe instead of blocking admission, a dial
that hangs is cut by ``connect_timeout``, shutdown joins are bounded.
A single unbounded ``recv``/``connect``/``wait`` reached from the
transport re-introduces the head-of-line hang the whole discipline
exists to prevent, and nothing crashes until a partition day.

The checker scans every function defined in the transport scope
(``sharding/`` and ``engine/replication.py``) plus every function
reachable from one — interprocedurally to fixpoint over the same call
shapes the blocking checker resolves (``self.m()``, ``self.attr.m()``
with one level of attribute-type inference, unique bare-name module
functions) — and flags the deadline-less shapes:

- ``X.wait()`` with no timeout (Event/Condition/future slots — the RPC
  waiter side) or an explicit ``timeout=None``;
- ``X.join()`` with no timeout on a thread-ish base (``",".join(xs)``
  always has an argument and a string base — not a thread join);
- ``X.result()`` with no timeout — a future wait on a scatter RPC must
  either pass one or be provably bounded by the task's own deadline
  (the vetted ``_scatter`` shape — allow-filed, not invisible);
- ``socket.create_connection(...)`` without a ``timeout=``;
- ``X.connect(...)`` with no prior ``X.settimeout(...)`` in the same
  function;
- ``X.recv(...)``/``X.recv_into(...)`` with no prior
  ``X.settimeout(...)`` in the same function (connection-lifetime
  reader threads in-tree read via the framed layer whose lifecycle is
  socket close — a raw deadline-less ``recv`` is a new ingestion
  point, not an idiom).

Vetted exceptions go in ``deadline_allow.txt``, one per line::

    sharding.front.Front._scatter -> .result()  # bounded by the per-op RPC deadline inside the task

keyed ``(context, descriptor)`` with a mandatory justification; stale
entries FAIL the run (``--prune-stale`` deletes them).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, iter_classes, iter_methods, load_pair_allowlist

_SCOPE_PREFIXES = ("sharding/",)
_SCOPE_FILES = ("engine/replication.py",)


def in_scope(module: Module) -> bool:
    rel = module.relpath.replace("\\", "/")
    return rel.startswith(_SCOPE_PREFIXES) or rel in _SCOPE_FILES


def _no_timeout(call: ast.Call) -> bool:
    """True when the call passes no bound: no args/kwargs, or an
    explicit ``timeout=None`` / first-positional ``None``."""
    if not call.args and not call.keywords:
        return True
    if call.args and isinstance(call.args[0], ast.Constant) and call.args[0].value is None:
        return True
    for k in call.keywords:
        if k.arg == "timeout" and isinstance(k.value, ast.Constant) and k.value.value is None:
            return True
    return False


class _FnScan:
    """One function's deadline-less ops and call refs."""

    def __init__(self) -> None:
        self.ops: List[Tuple[str, int]] = []  # (descriptor, line)
        self.calls: List[Tuple[str, ...]] = []  # resolution refs


def _scan_function(fn: ast.AST, out: _FnScan) -> None:
    from .core import unparse

    # bases settimeout() was called on, in lexical order of appearance
    timed_bases: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute):
            base_txt = unparse(f.value)
            if f.attr == "settimeout":
                if not (
                    node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value is None
                ):
                    timed_bases.add(base_txt)
                continue
            if f.attr == "wait" and _no_timeout(node):
                out.ops.append((".wait()", node.lineno))
            elif f.attr == "result" and _no_timeout(node):
                out.ops.append((".result()", node.lineno))
            elif (
                f.attr == "join"
                and not node.args
                and not node.keywords
                and not (isinstance(f.value, ast.Constant) and isinstance(f.value.value, str))
            ):
                out.ops.append((".join()", node.lineno))
            elif f.attr == "create_connection":
                if not any(k.arg == "timeout" for k in node.keywords) and len(node.args) < 2:
                    out.ops.append(("create_connection()", node.lineno))
            elif f.attr == "connect":
                if base_txt not in timed_bases:
                    out.ops.append((".connect()", node.lineno))
            elif f.attr in ("recv", "recv_into"):
                if base_txt not in timed_bases:
                    out.ops.append((f".{f.attr}()", node.lineno))
            # call refs for reachability
            base = f.value
            if isinstance(base, ast.Name) and base.id == "self":
                out.calls.append(("self", f.attr))
            elif (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                out.calls.append(("attr", base.attr, f.attr))
        elif isinstance(f, ast.Name):
            if f.id == "create_connection":
                if not any(k.arg == "timeout" for k in node.keywords) and len(node.args) < 2:
                    out.ops.append(("create_connection()", node.lineno))
            out.calls.append(("name", f.id))


def check(
    modules: Sequence[Module],
    allowlist_path: Optional[str] = None,
    stale_out: Optional[List[Tuple[str, str]]] = None,
) -> List[Finding]:
    from .lockgraph import _ClassInfo, _collect_class_info

    classes: Dict[str, _ClassInfo] = {}
    by_bare_name: Dict[str, List[_ClassInfo]] = {}
    for m in modules:
        for cls in iter_classes(m):
            info = _collect_class_info(m, cls)
            classes[info.qual] = info
            by_bare_name.setdefault(cls.name, []).append(info)

    scans: Dict[Tuple[str, str], _FnScan] = {}
    scan_meta: Dict[Tuple[str, str], str] = {}
    module_fns: Dict[str, List[Tuple[str, str]]] = {}
    entries: Set[Tuple[str, str]] = set()  # transport-scope roots
    for m in modules:
        method_ids = set()
        for cls in iter_classes(m):
            qual = f"{m.modname}.{cls.name}"
            for method in iter_methods(cls):
                method_ids.add(id(method))
                s = _FnScan()
                _scan_function(method, s)
                scans[(qual, method.name)] = s
                scan_meta[(qual, method.name)] = m.relpath
                if in_scope(m):
                    entries.add((qual, method.name))
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if id(node) in method_ids:
                    continue
                s = _FnScan()
                _scan_function(node, s)
                key = (m.modname, node.name)
                scans[key] = s
                scan_meta[key] = m.relpath
                module_fns.setdefault(node.name, []).append(key)
                if in_scope(m):
                    entries.add(key)

    def resolve(key: Tuple[str, str], ref: Tuple[str, ...]) -> Optional[Tuple[str, str]]:
        owner, _ = key
        if ref[0] == "self":
            callee = (owner, ref[1])
            return callee if callee in scans else None
        if ref[0] == "attr":
            info = classes.get(owner)
            if info is None:
                return None
            tname = info.attr_types.get(ref[1])
            if tname is None:
                return None
            cands = by_bare_name.get(tname, [])
            if len(cands) == 1:
                callee = (cands[0].qual, ref[2])
                return callee if callee in scans else None
            return None
        if ref[0] == "name":
            cands = module_fns.get(ref[1], [])
            if len(cands) == 1:
                return cands[0]
        return None

    # reachability closure from the transport-scope roots
    reachable: Set[Tuple[str, str]] = set(entries)
    frontier = list(entries)
    while frontier:
        key = frontier.pop()
        for ref in scans[key].calls:
            callee = resolve(key, ref)
            if callee is not None and callee not in reachable:
                reachable.add(callee)
                frontier.append(callee)

    allow = load_pair_allowlist(allowlist_path)
    seen_pairs: Set[Tuple[str, str]] = set()
    findings: List[Finding] = []
    emitted: Set[Tuple[str, str]] = set()

    for key in sorted(reachable):
        s = scans[key]
        if not s.ops:
            continue
        ctx = f"{key[0]}.{key[1]}"
        relpath = scan_meta[key]
        for desc, line in s.ops:
            seen_pairs.add((ctx, desc))
            if (ctx, desc) in allow:
                continue
            if (ctx, desc) in emitted:
                continue
            emitted.add((ctx, desc))
            short = ".".join(ctx.rsplit(".", 2)[-2:])
            findings.append(
                Finding(
                    checker="deadlines",
                    path=relpath,
                    relpath=relpath,
                    line=line,
                    message=f"deadline-less {desc} on the transport path (in {short})",
                )
            )

    if stale_out is not None:
        stale_out.extend(sorted(p for p in allow if p not in seen_pairs))
    findings.sort(key=lambda f: (f.relpath, f.line, f.message))
    return findings
