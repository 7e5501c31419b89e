"""Checker 7: exception safety — resources that leak on the error path.

The lease-elector bug: ``os.open`` the lease file, then
``flock`` it — and when ``flock`` raised anything unexpected, the fd
leaked, silently holding the flock for the process lifetime and wedging
every future acquire on the host. The class is "resource acquired, then
fallible work, then ownership transfer — with no protection in between".
Three rules:

1. **Explicit ``.acquire()``.** A lock acquired outside ``with`` must be
   released in a ``finally`` — a function containing ``X.acquire()``
   without any ``finally`` that calls ``.release()`` keeps the lock on
   every exception path. (Lock-wrapper internals — functions named
   ``acquire``/``release``/``__enter__``/``__exit__``/``_acquire_restore``
   /``_release_save`` and the ``utils/lockorder`` module itself — are
   the implementation, not users, and are exempt.)

2. **Fd/socket/tempfile lifetime.** A call to ``open`` / ``os.open`` /
   ``socket.socket`` / ``socket.socketpair`` / ``tempfile.mkstemp`` /
   ``tempfile.NamedTemporaryFile`` / ``.makefile()`` assigned to a local
   name must be *secured* — stored on ``self``/a container, returned, or
   consumed by ``os.fdopen`` — before any other fallible call runs, OR
   every fallible call in between must sit in a ``try`` whose handlers or
   ``finally`` close the resource. Release-only-on-success shapes are
   flagged at the first unprotected fallible call between creation and
   the close; a resource never closed and never escaping is flagged as
   leaking on every path. (``with`` forms are safe by construction and
   skipped.)

3. **Prepare without abort.** In functions whose name contains
   ``prepare`` or starts with ``reserve``, a loop performing per-member
   ``.reserve(...)`` calls must sit in a ``try`` whose handler calls a
   compensating ``unreserve``/``rollback``/``release``/``abort`` — a
   partial reserve abandoned by an exception is a permanent capacity
   leak (the ledger holds what no pod uses).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, iter_classes, iter_methods, unparse

_EXEMPT_FNS = {
    "acquire", "release", "__enter__", "__exit__",
    "_acquire_restore", "_release_save", "try_acquire",
}
_COMPENSATORS = ("unreserve", "rollback", "release", "abort", "_gang_release")


def _resource_desc(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        if f.id == "open":
            return "open()"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    base = unparse(f.value)
    if base == "os" and f.attr == "open":
        return "os.open()"
    if base == "socket" and f.attr in ("socket", "socketpair", "create_connection"):
        return f"socket.{f.attr}()"
    if base == "tempfile" and f.attr in ("mkstemp", "NamedTemporaryFile", "TemporaryFile"):
        return f"tempfile.{f.attr}()"
    if f.attr == "makefile":
        return ".makefile()"
    return None


def _call_closes(node: ast.AST, names: Set[str]) -> bool:
    """Does this subtree close any of ``names``? (``n.close()``,
    ``os.close(n)``, ``os.unlink`` is NOT a close — fds survive unlink.)"""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if isinstance(f, ast.Attribute):
            if f.attr == "close" and isinstance(f.value, ast.Name) and f.value.id in names:
                return True
            if (
                f.attr == "close"
                and unparse(f.value) == "os"
                and sub.args
                and isinstance(sub.args[0], ast.Name)
                and sub.args[0].id in names
            ):
                return True
    return False


def _check_acquire(module: Module, owner: str, fn: ast.AST, findings: List[Finding]) -> None:
    name = getattr(fn, "name", "")
    if name in _EXEMPT_FNS:
        return
    acquires = [
        node
        for node in ast.walk(fn)
        if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "acquire"
        # lock-shaped receivers only: lease electors and other acquire()
        # protocols have their own lifecycles (released on shutdown, not
        # per-call) and are not this rule's business
        and ("lock" in unparse(node.func.value).lower()
             or "cond" in unparse(node.func.value).lower()
             or "mutex" in unparse(node.func.value).lower())
    ]
    if not acquires:
        return
    has_finally_release = any(
        isinstance(node, ast.Try)
        and node.finalbody
        and any(
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "release"
            for stmt in node.finalbody
            for sub in ast.walk(stmt)
        )
        for node in ast.walk(fn)
    )
    if has_finally_release:
        return
    for node in acquires:
        findings.append(
            Finding(
                checker="excsafety",
                path=module.relpath,
                relpath=module.relpath,
                line=node.lineno,
                message=(
                    f"{unparse(node.func.value)}.acquire() in {owner} with no "
                    "finally-release — the lock is kept on every exception "
                    "path; use `with` or try/finally"
                ),
            )
        )


_SAFE_CALLS = {
    "str", "int", "float", "len", "repr", "print", "list", "dict", "set",
    "tuple", "sorted", "min", "max", "bool", "format",
}
_SAFE_CALL_PREFIXES = ("hashlib.", "logging.", "logger.", "time.", "os.path.")


class _ResourceState:
    __slots__ = ("names", "desc", "line", "secured", "closed_protected",
                 "leak_reported", "suspended")

    def __init__(self, names: Set[str], desc: str, line: int):
        self.names = names
        self.desc = desc
        self.line = line
        self.secured = False
        self.closed_protected = False
        self.leak_reported = False
        # True while walking except-handlers of the try the resource was
        # created in: on those paths the creation itself failed, so the
        # "leaks before secured" rule does not apply
        self.suspended = False


def _check_resources(module: Module, owner: str, fn: ast.AST, findings: List[Finding]) -> None:
    states: List[_ResourceState] = []

    def secure_targets(value: ast.AST, names: Set[str]) -> bool:
        """Does this expression consume/secure one of ``names``?
        Securing = stored to self/attribute/subscript, returned, yielded,
        or handed to os.fdopen (fd ownership transfer)."""
        for sub in ast.walk(value):
            if isinstance(sub, ast.Call):
                f = sub.func
                callee = unparse(f)
                if callee in ("os.fdopen", "fdopen"):
                    if any(isinstance(a, ast.Name) and a.id in names for a in sub.args):
                        return True
        return False

    def _executed_nodes(stmt: ast.AST):
        """ast.walk minus nested function/lambda bodies — a ``def`` is
        not executed at its definition point."""
        stack = [stmt]
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                stack.append(child)

    def has_risky_call(stmt: ast.AST, state: _ResourceState) -> Optional[str]:
        """First fallible call in ``stmt`` that is neither a close of the
        resource nor its own creation, else None."""
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return None  # a def/class statement executes no body code
        for sub in _executed_nodes(stmt):
            if isinstance(sub, ast.Call):
                f = sub.func
                text = unparse(f)
                if isinstance(f, ast.Attribute) and f.attr == "close":
                    continue
                if _resource_desc(sub) is not None:
                    continue
                # constructors/formatters that cannot meaningfully raise
                if text in _SAFE_CALLS or text.startswith(_SAFE_CALL_PREFIXES):
                    continue
                return text
        return None

    def protected_by(try_node: ast.Try, state: _ResourceState) -> bool:
        """The try's handlers or finally close the resource."""
        for h in try_node.handlers:
            if any(_call_closes(s, state.names) for s in h.body):
                return True
        if try_node.finalbody and any(
            _call_closes(s, state.names) for s in try_node.finalbody
        ):
            return True
        return False

    def walk_block(body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            # new resource assignments start tracking
            if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
                desc = _resource_desc(stmt.value)
                if desc is not None:
                    names: Set[str] = set()
                    attr_target = False
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            names.add(t.id)
                        elif isinstance(t, ast.Tuple):
                            elts = t.elts
                            if desc == "tempfile.mkstemp()":
                                # (fd, path): the fd is the resource, the
                                # path is a string
                                elts = elts[:1]
                            for e in elts:
                                if isinstance(e, ast.Name):
                                    names.add(e.id)
                        else:
                            attr_target = True  # self.x = open() — owned
                    if names and not attr_target:
                        states.append(_ResourceState(names, desc, stmt.lineno))
                    process_stmt(stmt, creating=True)
                    continue
            process_stmt(stmt, creating=False)
            # recurse into compound statements
            if isinstance(stmt, ast.Try):
                for st in states:
                    if not st.secured and protected_by(stmt, st):
                        st.closed_protected = True
                n_before = len(states)
                walk_block(stmt.body)
                born = states[n_before:]
                # on a handler path, the creation inside this try FAILED —
                # suspend its states so `raise WrappedError(...)` in the
                # handler is not misread as a leak-before-secure
                for st in born:
                    st.suspended = True
                for h in stmt.handlers:
                    walk_block(h.body)
                for st in born:
                    st.suspended = False
                walk_block(stmt.orelse)
                walk_block(stmt.finalbody)
            elif not isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                # nested defs/classes are not executed here — their bodies
                # are separate control flow (checked as their own functions)
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if sub:
                        walk_block(sub)

    def process_stmt(stmt: ast.stmt, creating: bool) -> None:
        for st in states:
            if st.secured or st.suspended:
                continue
            # securing forms
            if isinstance(stmt, (ast.Return, ast.Expr)) and isinstance(
                getattr(stmt, "value", None), (ast.Name, ast.Tuple)
            ):
                v = stmt.value
                elts = v.elts if isinstance(v, ast.Tuple) else [v]
                if isinstance(stmt, ast.Return) and any(
                    isinstance(e, ast.Name) and e.id in st.names for e in elts
                ):
                    st.secured = True
                    continue
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)) and isinstance(
                        stmt.value, ast.Name
                    ) and stmt.value.id in st.names:
                        st.secured = True
                if secure_targets(stmt.value, st.names):
                    st.secured = True
            if isinstance(stmt, ast.Expr) and secure_targets(stmt.value, st.names):
                st.secured = True
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    if secure_targets(item.context_expr, st.names):
                        st.secured = True
            if st.secured:
                continue
            if _call_closes(stmt, st.names):
                # an unconditional close before any risky call: the
                # resource's lifetime ended cleanly (risky-before-close is
                # caught below, at the risky call, not here)
                st.secured = True
                continue
            if creating:
                continue
            if st.closed_protected or st.leak_reported:
                continue
            if isinstance(stmt, ast.Try):
                if protected_by(stmt, st):
                    st.closed_protected = True
                continue
            risky = has_risky_call(stmt, st)
            if risky is not None:
                st.leak_reported = True
                findings.append(
                    Finding(
                        checker="excsafety",
                        path=module.relpath,
                        relpath=module.relpath,
                        line=st.line,
                        message=(
                            f"{st.desc} in {owner} may leak: '{risky}' can "
                            "raise before the resource is stored or closed — "
                            "use with/try-finally or close in the except path"
                        ),
                    )
                )

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    walk_block(body)
    for st in states:
        if st.secured or st.closed_protected or st.leak_reported:
            continue
        findings.append(
            Finding(
                checker="excsafety",
                path=module.relpath,
                relpath=module.relpath,
                line=st.line,
                message=f"{st.desc} in {owner} is never closed on any path",
            )
        )


def _check_prepare_abort(
    module: Module, owner: str, fn: ast.FunctionDef, findings: List[Finding]
) -> None:
    name = fn.name.lower()
    if "prepare" not in name and not name.startswith("reserve"):
        return

    def loop_reserves(loop: ast.AST) -> Optional[int]:
        for sub in ast.walk(loop):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "reserve"
            ):
                return sub.lineno
        return None

    def handler_compensates(try_node: ast.Try) -> bool:
        for h in try_node.handlers:
            for s in h.body:
                for sub in ast.walk(s):
                    if isinstance(sub, ast.Call):
                        callee = (
                            sub.func.attr
                            if isinstance(sub.func, ast.Attribute)
                            else getattr(sub.func, "id", "")
                        )
                        if any(c in callee for c in _COMPENSATORS):
                            return True
        return False

    protected_loops: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Try) and handler_compensates(node):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.For, ast.While)):
                    protected_loops.add(id(sub))
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.While)) and id(node) not in protected_loops:
            line = loop_reserves(node)
            if line is not None:
                findings.append(
                    Finding(
                        checker="excsafety",
                        path=module.relpath,
                        relpath=module.relpath,
                        line=line,
                        message=(
                            f"per-member reserve loop in {owner} has no "
                            "compensating unreserve/rollback handler — a "
                            "partial reserve abandoned mid-loop leaks capacity"
                        ),
                    )
                )


def check(modules: Sequence[Module]) -> List[Finding]:
    findings: List[Finding] = []
    for m in modules:
        if m.relpath.replace("\\", "/").endswith("utils/lockorder.py"):
            continue  # the lock instrumentation itself
        claimed = set()
        for cls in iter_classes(m):
            for method in iter_methods(cls):
                claimed.add(id(method))
                owner = f"{cls.name}.{method.name}"
                _check_acquire(m, owner, method, findings)
                _check_resources(m, owner, method, findings)
                _check_prepare_abort(m, owner, method, findings)
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if id(node) in claimed:
                    continue
                _check_acquire(m, node.name, node, findings)
                _check_resources(m, node.name, node, findings)
                _check_prepare_abort(m, node.name, node, findings)
    findings.sort(key=lambda f: (f.relpath, f.line, f.message))
    return findings
