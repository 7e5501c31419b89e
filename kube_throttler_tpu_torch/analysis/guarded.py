"""Checker 1: guarded-by discipline.

Shared mutable attributes are declared guarded either way:

- a class-level table for existing code::

      GUARDED_BY = {"_values": "self._lock", "_queue": ("self._lock",)}

  (values are the lock expression as written at the ``with`` site; a
  tuple means holding ANY of the listed locks satisfies the guard);

- or an inline annotation on the attribute declaration::

      self._values = {}  #: guarded-by: self._lock

  (also recognized on the line directly above the assignment).

Every ``self.<attr>`` read/write of a guarded attribute must then sit
lexically inside a ``with <lock>:`` block for one of its guards.
Method-boundary rules:

- ``__init__``/``__new__``/``__del__`` are exempt (construction and
  teardown happen-before/after sharing);
- methods whose name ends in ``_locked`` are callee-side helpers whose
  contract is "caller holds the lock" — they are treated as holding every
  guard of their class (and should call ``lockorder.assert_held`` when
  the runtime assassin is on);
- nested functions inherit the locks held at their definition site (the
  dominant in-tree shape is a closure invoked synchronously under the
  lock; a closure stashed and called later must be waived explicitly).

``threading.Condition(self._lock)`` aliases: holding the condition IS
holding the lock, so either expression satisfies a guard naming the
other.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, iter_classes, iter_methods, unparse

_INLINE_RE = re.compile(r"#:\s*guarded-by:\s*(?P<expr>[^#]+?)\s*$")
_ATTR_ASSIGN_RE = re.compile(r"^\s*self\.(?P<attr>\w+)\s*(?::[^=]+)?=[^=]")

EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__post_init__"}


def _norm_expr(node: ast.AST) -> str:
    """Canonical text of a lock expression: calls lose their arguments
    (``self._key_lock(key)`` -> ``self._key_lock()``) and subscripts lose
    their index (``self._conds[i]`` -> ``self._conds``), so guards over
    accessor methods and lock collections can be written generically."""
    if isinstance(node, ast.Call):
        return unparse(node.func) + "()"
    while isinstance(node, ast.Subscript):
        node = node.value
    return unparse(node)


def _norm_str(s: str) -> str:
    s = s.strip()
    m = re.match(r"^(?P<base>[\w\.\[\]'\"]+)\(.*\)$", s)
    if m and "(" in s:
        return m.group("base") + "()"
    return re.sub(r"(\[[^\]]*\])+$", "", s)


class _GuardSpec:
    """Per-class guard table + condition/lock aliases."""

    def __init__(self) -> None:
        self.attrs: Dict[str, Tuple[str, ...]] = {}
        self.aliases: Dict[str, Set[str]] = {}

    def add(self, attr: str, guards) -> None:
        if isinstance(guards, str):
            guards = (guards,)
        self.attrs[attr] = tuple(_norm_str(g) for g in guards)

    def add_alias(self, a: str, b: str) -> None:
        self.aliases.setdefault(a, set()).add(b)
        self.aliases.setdefault(b, set()).add(a)

    def satisfied(self, attr: str, held: FrozenSet[str]) -> bool:
        for g in self.attrs[attr]:
            if g in held:
                return True
            if any(alias in held for alias in self.aliases.get(g, ())):
                return True
        return False


def _collect_table(cls: ast.ClassDef) -> Optional[Dict[str, object]]:
    for node in cls.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "GUARDED_BY":
                try:
                    table = ast.literal_eval(value)
                except ValueError:
                    return None
                return table if isinstance(table, dict) else None
    return None


def _collect_inline(module: Module, cls: ast.ClassDef, spec: _GuardSpec) -> None:
    start = cls.lineno - 1
    end = max(
        (getattr(n, "end_lineno", n.lineno) for n in ast.walk(cls) if hasattr(n, "lineno")),
        default=cls.lineno,
    )
    lines = module.lines
    for i in range(start, min(end, len(lines))):
        m = _INLINE_RE.search(lines[i])
        if not m:
            continue
        guard = _norm_str(m.group("expr"))
        am = _ATTR_ASSIGN_RE.match(lines[i])
        if am is None and i + 1 < len(lines) and lines[i].strip().startswith("#:"):
            # standalone comment line: annotates the assignment below
            am = _ATTR_ASSIGN_RE.match(lines[i + 1])
        if am is not None:
            spec.add(am.group("attr"), guard)


def _collect_aliases(cls: ast.ClassDef, spec: _GuardSpec) -> None:
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        fn = node.value
        callee = unparse(fn.func)
        if not callee.endswith("Condition"):
            continue
        if not fn.args:
            continue
        lock_expr = _norm_expr(fn.args[0])
        for t in node.targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                spec.add_alias(f"self.{t.attr}", lock_expr)


class _MethodVisitor:
    """Walks one method body tracking lexically-held locks."""

    def __init__(
        self,
        module: Module,
        cls_name: str,
        method: str,
        spec: _GuardSpec,
        findings: List[Finding],
        aliases: Optional[Dict[str, str]] = None,
    ):
        self.module = module
        self.cls_name = cls_name
        self.method = method
        self.spec = spec
        self.findings = findings
        # local-name -> normalized self-expr (``cond = self._conds[i]``
        # makes ``with cond:`` count as holding self._conds); collected
        # flow-insensitively over the whole method
        self.aliases = aliases or {}

    def run(self, body: Sequence[ast.stmt], held: FrozenSet[str]) -> None:
        for stmt in body:
            self._visit(stmt, held)

    def _visit(self, node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in node.items:
                self._scan_expr(item.context_expr, held)
                norm = _norm_expr(item.context_expr)
                inner.add(self.aliases.get(norm, norm))
            self.run(node.body, frozenset(inner))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: inherits the definition site's held set (see
            # module docstring); decorators/defaults evaluate here
            for dec in node.decorator_list:
                self._scan_expr(dec, held)
            for d in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]:
                self._scan_expr(d, held)
            self.run(node.body, held)
            return
        if isinstance(node, ast.Lambda):
            self._visit(node.body, held)
            return
        if isinstance(node, ast.expr):
            self._scan_expr(node, held)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    def _scan_expr(self, node: ast.AST, held: FrozenSet[str]) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Lambda,)):
                continue  # walked anyway; held set identical
            if (
                isinstance(sub, ast.Attribute)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "self"
                and sub.attr in self.spec.attrs
            ):
                if not self.spec.satisfied(sub.attr, held):
                    kind = "write" if isinstance(sub.ctx, (ast.Store, ast.Del)) else "read"
                    guards = " | ".join(self.spec.attrs[sub.attr])
                    self.findings.append(
                        Finding(
                            checker="guarded",
                            path=self.module.path,
                            relpath=self.module.relpath,
                            line=sub.lineno,
                            message=(
                                f"{kind} of '{sub.attr}' (guarded by {guards}) "
                                f"outside its lock in {self.cls_name}.{self.method}"
                            ),
                        )
                    )


def _local_lock_aliases(method: ast.AST) -> Dict[str, str]:
    """``name = self.<something>`` assignments anywhere in the method:
    name -> normalized self-expression. Flow-insensitive (good enough for
    the in-tree ``cond = self._conds[i]`` shape; a name rebound to two
    different locks would resolve to the last one seen)."""
    out: Dict[str, str] = {}
    for node in ast.walk(method):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                norm = _norm_expr(node.value)
                if norm.startswith("self."):
                    out[t.id] = norm
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            # `for cond in self._conds:` / `for i, cond in
            # enumerate(self._conds):` — the loop variable iterates the
            # lock collection
            it = node.iter
            target = node.target
            if (
                isinstance(it, ast.Call)
                and isinstance(it.func, ast.Name)
                and it.func.id == "enumerate"
                and it.args
            ):
                it = it.args[0]
                if isinstance(target, ast.Tuple) and len(target.elts) == 2:
                    target = target.elts[1]
            norm = _norm_expr(it)
            if norm.startswith("self.") and isinstance(target, ast.Name):
                out[target.id] = norm
    return out


def check_module(module: Module) -> List[Finding]:
    findings: List[Finding] = []
    for cls in iter_classes(module):
        spec = _GuardSpec()
        table = _collect_table(cls)
        if table:
            for attr, guards in table.items():
                spec.add(str(attr), guards)
        _collect_inline(module, cls, spec)
        if not spec.attrs:
            continue
        _collect_aliases(cls, spec)
        for method in iter_methods(cls):
            if method.name in EXEMPT_METHODS:
                continue
            if method.name.endswith("_locked"):
                # contract: caller holds the lock — treat as holding all
                held = frozenset(
                    g for guards in spec.attrs.values() for g in guards
                )
            else:
                held = frozenset()
            aliases = _local_lock_aliases(method)
            _MethodVisitor(
                module, cls.name, method.name, spec, findings, aliases
            ).run(method.body, held)
    return findings


def check(modules: Sequence[Module]) -> List[Finding]:
    out: List[Finding] = []
    for m in modules:
        out.extend(check_module(m))
    return out
