"""Checker 6: thread lifecycle — silent death, daemon-under-lock, and
unbounded shutdown joins.

A standby replicator thread was once found dead of an uncaught
exception while ``/readyz`` reported ok — the bug class this checker
makes structural. Three rules:

1. **Exception routing.** Every ``threading.Thread(target=...)`` whose
   target resolves statically (a ``self._method``, a local/module
   ``def``, or a ``threading.Thread`` subclass's ``run``) must have
   *top-level exception routing*: a ``try`` that is a direct child of
   the target's body (or of a top-level loop's body) carrying a broad
   handler (``except Exception``/``BaseException``/bare, body not just
   ``pass``) or a ``finally`` (teardown-as-routing: the ``finally`` can
   flip a health flag on the way out). Anything narrower means an
   unexpected exception kills the thread while every probe stays green.
   Targets that are deliberate fire-and-forget carry a waiver comment —
   ``#: thread: fire-and-forget`` — on the ``Thread(...)`` line, the
   line above it, or the target's ``def`` line. Foreign targets
   (``self._httpd.serve_forever``) are skipped: not ours to instrument.

2. **Daemon spawn under a lock.** Constructing a ``Thread`` while
   lexically holding a named lock is flagged: the child can start and
   immediately contend (or deadlock) on the very lock its parent still
   holds, and the spawn itself (interpreter bookkeeping) is slow work
   under a lock either way.

3. **Unbounded shutdown joins.** ``.join()`` with neither a positional
   timeout nor a ``timeout=`` keyword inside a method named ``stop`` /
   ``close`` / ``shutdown`` / ``teardown`` / ``__exit__`` wedges
   shutdown forever if the thread is stuck — exactly when it is most
   likely to be stuck.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, iter_classes, iter_methods, unparse
from .lockgraph import _ModuleLocks, _collect_class_info, resolve_lock_node

_WAIVER_RE = re.compile(r"#:\s*thread:\s*fire-and-forget")
_SHUTDOWN_METHODS = {"stop", "close", "shutdown", "teardown", "__exit__"}
_BROAD = {"Exception", "BaseException"}


def _is_thread_call(call: ast.Call) -> bool:
    f = call.func
    name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
    return name == "Thread"


def _target_expr(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "target":
            return kw.value
    return None


def _line_waived(module: Module, *linenos: int) -> bool:
    for ln in linenos:
        for cand in (ln, ln - 1):
            if 1 <= cand <= len(module.lines) and _WAIVER_RE.search(
                module.lines[cand - 1]
            ):
                return True
    return False


def _handler_is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        broad = True
    else:
        names = []
        t = handler.type
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        for e in elts:
            names.append(e.id if isinstance(e, ast.Name) else getattr(e, "attr", ""))
        broad = any(n in _BROAD for n in names)
    if not broad:
        return False
    # a handler that only ``pass``es swallows the death without routing
    # it anywhere — that is silent death with extra steps
    return not all(isinstance(s, ast.Pass) for s in handler.body)


def _has_toplevel_routing(fn: ast.AST) -> bool:
    """A Try with a broad handler or a finally, sitting either directly
    in the function body or directly in the body of a top-level loop."""

    def try_ok(node: ast.stmt) -> bool:
        return isinstance(node, ast.Try) and (
            bool(node.finalbody) or any(_handler_is_broad(h) for h in node.handlers)
        )

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        if try_ok(stmt):
            return True
        if isinstance(stmt, (ast.While, ast.For)):
            if any(try_ok(s) for s in stmt.body):
                return True
        if isinstance(stmt, ast.With):
            # `with ...:` wrapping the whole loop/try is common shape
            if any(
                try_ok(s)
                or (isinstance(s, (ast.While, ast.For)) and any(try_ok(x) for x in s.body))
                for s in stmt.body
            ):
                return True
    return False


class _FnIndex:
    """Resolution of thread targets: methods by (class, name), local defs
    by enclosing function, module defs by name."""

    def __init__(self, module: Module):
        self.module = module
        self.module_defs: Dict[str, ast.AST] = {}
        for node in module.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module_defs[node.name] = node


def _local_defs(fn: ast.AST) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            out.setdefault(node.name, node)
    return out


def _check_spawns(
    module: Module,
    owner: str,
    fn: ast.AST,
    methods: Dict[str, ast.AST],
    idx: _FnIndex,
    info,
    mod_locks: _ModuleLocks,
    by_bare_name,
    findings: List[Finding],
) -> None:
    locals_ = _local_defs(fn)

    def visit(node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in node.items:
                n = resolve_lock_node(item.context_expr, info, mod_locks, by_bare_name)
                if n is not None:
                    inner.add(n)
            for stmt in node.body:
                visit(stmt, frozenset(inner))
            return
        if isinstance(node, ast.Call) and _is_thread_call(node):
            if held:
                findings.append(
                    Finding(
                        checker="threads",
                        path=module.relpath,
                        relpath=module.relpath,
                        line=node.lineno,
                        message=(
                            f"thread spawned while holding {', '.join(sorted(held))} "
                            f"(in {owner}) — spawn outside the lock"
                        ),
                    )
                )
            _check_target(node)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    def _check_target(call: ast.Call) -> None:
        target = _target_expr(call)
        if target is None:
            return
        resolved: Optional[ast.AST] = None
        tname = ""
        if isinstance(target, ast.Attribute):
            base = target.value
            if isinstance(base, ast.Name) and base.id == "self":
                resolved = methods.get(target.attr)
                tname = target.attr
            else:
                return  # foreign target (library object) — not ours
        elif isinstance(target, ast.Name):
            resolved = locals_.get(target.id) or idx.module_defs.get(target.id)
            tname = target.id
        elif isinstance(target, ast.Lambda):
            findings.append(
                Finding(
                    checker="threads",
                    path=module.relpath,
                    relpath=module.relpath,
                    line=call.lineno,
                    message=(
                        f"lambda thread target in {owner}: exceptions are "
                        "unroutable — use a def with try/except or waive"
                    ),
                )
            )
            return
        if resolved is None:
            return
        if _line_waived(module, call.lineno, resolved.lineno):
            return
        if not _has_toplevel_routing(resolved):
            findings.append(
                Finding(
                    checker="threads",
                    path=module.relpath,
                    relpath=module.relpath,
                    line=resolved.lineno,
                    message=(
                        f"thread target '{tname}' (spawned in {owner}) has no "
                        "top-level exception routing — an uncaught exception "
                        "kills it silently; route to health/restart or waive "
                        "with '#: thread: fire-and-forget'"
                    ),
                )
            )

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        visit(stmt, frozenset())


def _check_shutdown_joins(
    module: Module, owner: str, fn: ast.FunctionDef, findings: List[Finding]
) -> None:
    if fn.name not in _SHUTDOWN_METHODS:
        return
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr == "join"):
            continue
        if node.args or any(kw.arg == "timeout" for kw in node.keywords):
            continue
        base = unparse(f.value)
        if "." in base and not base.startswith("self"):
            continue  # os.path.join etc.
        findings.append(
            Finding(
                checker="threads",
                path=module.relpath,
                relpath=module.relpath,
                line=node.lineno,
                message=(
                    f"{base}.join() without timeout in shutdown path "
                    f"{owner} — a stuck thread wedges shutdown forever"
                ),
            )
        )


def check(modules: Sequence[Module]) -> List[Finding]:
    findings: List[Finding] = []
    # class infos for lock resolution (daemon-under-lock rule)
    by_bare_name: Dict[str, List] = {}
    infos: Dict[Tuple[str, str], object] = {}
    for m in modules:
        for cls in iter_classes(m):
            info = _collect_class_info(m, cls)
            infos[(m.modname, cls.name)] = info
            by_bare_name.setdefault(cls.name, []).append(info)
    for m in modules:
        idx = _FnIndex(m)
        ml = _ModuleLocks(m)
        for cls in iter_classes(m):
            info = infos[(m.modname, cls.name)]
            methods = {meth.name: meth for meth in iter_methods(cls)}
            # Thread subclasses: run() is an implicit target of start()
            bases = {unparse(b).rsplit(".", 1)[-1] for b in cls.bases}
            if "Thread" in bases and "run" in methods:
                run = methods["run"]
                if not _line_waived(m, cls.lineno, run.lineno) and not _has_toplevel_routing(run):
                    findings.append(
                        Finding(
                            checker="threads",
                            path=m.relpath,
                            relpath=m.relpath,
                            line=run.lineno,
                            message=(
                                f"Thread subclass {cls.name}.run has no "
                                "top-level exception routing — an uncaught "
                                "exception kills it silently; route to "
                                "health/restart or waive with "
                                "'#: thread: fire-and-forget'"
                            ),
                        )
                    )
            for method in iter_methods(cls):
                owner = f"{cls.name}.{method.name}"
                _check_spawns(m, owner, method, methods, idx, info, ml,
                              by_bare_name, findings)
                _check_shutdown_joins(m, owner, method, findings)
        claimed = set()
        for cls in iter_classes(m):
            for method in iter_methods(cls):
                claimed.add(id(method))
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if id(node) in claimed:
                    continue
                _check_spawns(m, node.name, node, {}, idx, None, ml, by_bare_name,
                              findings)
    findings.sort(key=lambda f: (f.relpath, f.line, f.message))
    return findings
