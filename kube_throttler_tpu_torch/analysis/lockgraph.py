"""Checker 2: static lock-acquisition order graph.

Builds the "acquired-while-holding" graph across the package:

- pass 1 discovers lock objects: ``self.X = threading.Lock()/RLock()``
  (also ``lockorder.make_lock``/``make_rlock`` factories, dict/list
  collections of locks, dataclass ``field(default_factory=threading.Lock)``,
  class- and module-level locks) and ``threading.Condition(self.Y)``
  aliases (acquiring the condition IS acquiring Y);
- pass 2 walks every function tracking the lexically-held set through
  ``with`` blocks; a nested acquisition adds edge ``outer -> inner``;
- call propagation: the lock set a method acquires transitively (through
  ``self.`` calls and one level of attribute-type inference from
  ``self.attr = ClassName(...)``) is charged against the held set at each
  call site, to fixpoint.

A cycle in the resulting graph is a potential lock inversion; vetted
orders are excluded via the allowlist file (``lockorder_allow.txt``,
lines ``nodeA -> nodeB  # reason``) which removes that edge before cycle
detection. Reentrant self-edges are reported only for non-reentrant
``threading.Lock`` nodes (an RLock may nest on itself).

Lock nodes are named ``<module>.<Class>.<attr>`` (or ``<module>.<attr>``
for module-level locks). Accessor methods that return a lock from a
collection (``def _key_lock(self): return self._key_locks[...]``) count
as acquiring the collection's node.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, iter_classes, iter_methods, unparse

_LOCK_FACTORIES = ("Lock", "RLock", "make_lock", "make_rlock")
_REENTRANT_FACTORIES = ("RLock", "make_rlock")


def _factory_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _is_lock_ctor(node: ast.AST) -> Optional[str]:
    """'lock' / 'rlock' if node constructs a lock, else None. Descends one
    level into list/dict/comprehension collections and dataclass field()."""
    if isinstance(node, ast.Call):
        name = _factory_name(node)
        if name in _LOCK_FACTORIES:
            return "rlock" if name in _REENTRANT_FACTORIES else "lock"
        if name == "field":
            for kw in node.keywords:
                if kw.arg == "default_factory":
                    v = kw.value
                    vname = (
                        v.attr if isinstance(v, ast.Attribute)
                        else v.id if isinstance(v, ast.Name) else None
                    )
                    if vname in _LOCK_FACTORIES:
                        return "rlock" if vname in _REENTRANT_FACTORIES else "lock"
        return None
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        for elt in node.elts:
            k = _is_lock_ctor(elt)
            if k:
                return k
    if isinstance(node, ast.Dict):
        for v in node.values:
            k = _is_lock_ctor(v)
            if k:
                return k
    if isinstance(node, (ast.ListComp, ast.SetComp)):
        return _is_lock_ctor(node.elt)
    if isinstance(node, ast.DictComp):
        return _is_lock_ctor(node.value)
    return None


class _ClassInfo:
    def __init__(self, module: Module, cls: ast.ClassDef):
        self.module = module
        self.cls = cls
        self.qual = f"{module.modname}.{cls.name}"
        self.lock_attrs: Dict[str, str] = {}  # attr -> 'lock'|'rlock'
        self.cond_alias: Dict[str, Optional[str]] = {}  # cond attr -> lock attr
        self.accessor_alias: Dict[str, str] = {}  # method name -> lock attr
        self.attr_types: Dict[str, str] = {}  # attr -> bare class name

    def node_for_attr(self, attr: str) -> Optional[str]:
        if attr in self.lock_attrs:
            return f"{self.qual}.{attr}"
        if attr in self.cond_alias:
            target = self.cond_alias[attr]
            if target is not None and target in self.lock_attrs:
                return f"{self.qual}.{target}"
            return f"{self.qual}.{attr}"
        return None

    def reentrant(self, node: str) -> bool:
        attr = node.rsplit(".", 1)[-1]
        kind = self.lock_attrs.get(attr)
        if kind is None and attr in self.cond_alias:
            kind = "rlock"  # bare Condition owns an RLock
        return kind == "rlock"


def _ann_class_name(ann: ast.AST) -> Optional[str]:
    """Bare class name of an annotation: ``Store`` / ``Optional[Store]`` /
    ``"Store"`` (string annotation) -> 'Store'."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.Subscript):
        head = ann.value
        head_name = (
            head.id if isinstance(head, ast.Name)
            else head.attr if isinstance(head, ast.Attribute) else None
        )
        if head_name in ("Optional", "Union"):
            inner = ann.slice
            if isinstance(inner, ast.Tuple):
                for elt in inner.elts:
                    n = _ann_class_name(elt)
                    if n:
                        return n
                return None
            return _ann_class_name(inner)
        return None
    if isinstance(ann, ast.Name):
        return ann.id if ann.id[:1].isupper() else None
    if isinstance(ann, ast.Attribute):
        return ann.attr if ann.attr[:1].isupper() else None
    return None


def _attr_base_chain(expr: ast.AST) -> Optional[str]:
    """``self._agg_locks[k]`` / ``self._lock`` / ``cls._stats_lock`` /
    ``self._key_lock(key)`` -> the attribute name, else None."""
    node = expr
    if isinstance(node, ast.Call):
        node = node.func
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


# (id(module), id(cls)) -> _ClassInfo. Module objects are themselves
# memoized across checker runs (core._PARSE_CACHE), so identity is a
# stable key within one process: five checkers (lockorder, blocking,
# guarded, epochs, deadlines) walk the same class bodies — collecting
# once keeps a full-package run inside its 15s budget.
_CLASS_INFO_CACHE: dict = {}


def _collect_class_info(module: Module, cls: ast.ClassDef) -> _ClassInfo:
    key = (id(module), id(cls))
    cached = _CLASS_INFO_CACHE.get(key)
    if cached is not None and cached.module is module and cached.cls is cls:
        return cached
    info = _collect_class_info_uncached(module, cls)
    _CLASS_INFO_CACHE[key] = info
    return info


def _collect_class_info_uncached(module: Module, cls: ast.ClassDef) -> _ClassInfo:
    info = _ClassInfo(module, cls)
    # class-level lock attributes
    for node in cls.body:
        if isinstance(node, ast.Assign):
            kind = _is_lock_ctor(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if kind:
                        info.lock_attrs[t.id] = kind
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            kind = _is_lock_ctor(node.value)
            if kind and isinstance(node.target, ast.Name):
                info.lock_attrs[node.target.id] = kind
    # __init__ parameter annotations: ``self.store = store`` with
    # ``store: Store`` (or ``Optional[Store]``) types the attribute, so
    # ``with self.store._lock`` resolves to the Store's node instead of
    # being misread as this class's own ``_lock``
    param_types: Dict[str, str] = {}
    for method in iter_methods(cls):
        if method.name != "__init__":
            continue
        for a in list(method.args.args) + list(method.args.kwonlyargs):
            if a.annotation is not None:
                t = _ann_class_name(a.annotation)
                if t:
                    param_types[a.arg] = t
    # instance attributes, condition aliases, attr types
    for method in iter_methods(cls):
        for node in ast.walk(method):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                kind = _is_lock_ctor(node.value)
                if kind:
                    info.lock_attrs[t.attr] = kind
                    continue
                value = node.value
                if isinstance(value, ast.Name) and value.id in param_types:
                    info.attr_types[t.attr] = param_types[value.id]
                    continue
                if isinstance(value, ast.BoolOp):
                    # ``self.store = store or Store()``: either operand types it
                    for v in value.values:
                        if isinstance(v, ast.Name) and v.id in param_types:
                            info.attr_types[t.attr] = param_types[v.id]
                            break
                        if isinstance(v, ast.Call):
                            fname = _factory_name(v)
                            if fname and fname[0].isupper():
                                info.attr_types[t.attr] = fname
                                break
                    continue
                if isinstance(value, ast.Call):
                    fname = _factory_name(value)
                    if fname == "Condition":
                        target = None
                        if value.args:
                            target = _attr_base_chain(value.args[0])
                        info.cond_alias[t.attr] = target
                    elif fname and fname[0].isupper():
                        info.attr_types[t.attr] = fname
    # accessor methods returning a lock from a collection
    for method in iter_methods(cls):
        for node in ast.walk(method):
            if isinstance(node, ast.Return) and node.value is not None:
                attr = _attr_base_chain(node.value)
                if attr in info.lock_attrs:
                    info.accessor_alias[method.name] = attr
    return info


class _ModuleLocks:
    def __init__(self, module: Module):
        self.module = module
        self.names: Dict[str, str] = {}  # name -> 'lock'|'rlock'
        for node in module.tree.body:
            if isinstance(node, ast.Assign):
                kind = _is_lock_ctor(node.value)
                if kind:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.names[t.id] = kind


class _Graph:
    def __init__(self) -> None:
        # edge -> (path, line, context) of first sighting
        self.edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        self.reentrant: Set[str] = set()

    def add(self, outer: str, inner: str, where: Tuple[str, int, str]) -> None:
        self.edges.setdefault((outer, inner), where)


class _FnScan:
    """One function's direct acquisitions and call sites, each with the
    lexically-held set at that point."""

    def __init__(self) -> None:
        self.acquires: List[Tuple[str, FrozenSet[str], int]] = []
        self.calls: List[Tuple[Tuple[str, ...], FrozenSet[str], int]] = []


def resolve_lock_node(
    expr: ast.AST,
    info: Optional[_ClassInfo],
    mod_locks: _ModuleLocks,
    by_bare_name: Optional[Dict[str, List[_ClassInfo]]] = None,
) -> Optional[str]:
    """Canonical lock-node name for a ``with``-site expression, or None
    when the expression does not resolve to a discovered lock. Shared by
    the lockorder, blocking, and threads checkers so they all agree on
    what counts as "holding a named lock"."""
    if isinstance(expr, ast.Name) and expr.id in mod_locks.names:
        return f"{mod_locks.module.modname}.{expr.id}"
    if isinstance(expr, ast.Call):
        attr = _attr_base_chain(expr)
        if info is not None and attr in info.accessor_alias:
            return f"{info.qual}.{info.accessor_alias[attr]}"
        return None
    node = expr
    while isinstance(node, ast.Subscript):
        node = node.value
    if not isinstance(node, ast.Attribute):
        return None
    base = node.value
    while isinstance(base, ast.Subscript):
        base = base.value
    if isinstance(base, ast.Name):
        # self._lock / cls._lock / ClassName._lock (class-level lock)
        if base.id in ("self", "cls") or (
            info is not None and base.id == info.cls.name
        ):
            return info.node_for_attr(node.attr) if info is not None else None
        return None
    # self.<obj>.<lockattr>: one level of attribute-type inference —
    # NOT this class's lock (misattributing it would fabricate
    # self-edges and hide real cross-object orderings)
    if (
        info is not None
        and by_bare_name is not None
        and isinstance(base, ast.Attribute)
        and isinstance(base.value, ast.Name)
        and base.value.id == "self"
    ):
        tname = info.attr_types.get(base.attr)
        if tname is not None:
            cands = by_bare_name.get(tname, [])
            if len(cands) == 1:
                return cands[0].node_for_attr(node.attr)
    return None


def _scan_function(
    fn: ast.AST,
    info: Optional[_ClassInfo],
    mod_locks: _ModuleLocks,
    out: _FnScan,
    by_bare_name: Optional[Dict[str, List[_ClassInfo]]] = None,
) -> None:
    def lock_node(expr: ast.AST) -> Optional[str]:
        return resolve_lock_node(expr, info, mod_locks, by_bare_name)

    def visit(node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in node.items:
                scan_calls(item.context_expr, held)
                n = lock_node(item.context_expr)
                if n is not None:
                    out.acquires.append((n, frozenset(inner), item.context_expr.lineno))
                    inner.add(n)
            for stmt in node.body:
                visit(stmt, frozenset(inner))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                visit(stmt, held)
            return
        if isinstance(node, ast.expr):
            scan_calls(node, held)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    def scan_calls(expr: ast.AST, held: FrozenSet[str]) -> None:
        for sub in ast.walk(expr):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if isinstance(f, ast.Attribute):
                base = f.value
                if isinstance(base, ast.Name) and base.id == "self":
                    out.calls.append((("self", f.attr), held, sub.lineno))
                elif (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                ):
                    out.calls.append((("attr", base.attr, f.attr), held, sub.lineno))

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        visit(stmt, frozenset())


def _load_allowlist(path: Optional[str]) -> Set[Tuple[str, str]]:
    import os

    out: Set[Tuple[str, str]] = set()
    if not path or not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line or "->" not in line:
                continue
            a, _, b = line.partition("->")
            out.add((a.strip(), b.strip()))
    return out


def check(
    modules: Sequence[Module],
    allowlist_path: Optional[str] = None,
    stale_out: Optional[List[Tuple[str, str]]] = None,
) -> List[Finding]:
    """``stale_out`` (when given) receives allowlist edges that no longer
    match any acquired-while-holding edge — dead waivers the CLI turns
    into errors (prunable with ``--prune-stale``)."""
    classes: Dict[str, _ClassInfo] = {}
    by_bare_name: Dict[str, List[_ClassInfo]] = {}
    mod_locks: Dict[str, _ModuleLocks] = {}
    for m in modules:
        mod_locks[m.modname] = _ModuleLocks(m)
        for cls in iter_classes(m):
            info = _collect_class_info(m, cls)
            classes[info.qual] = info
            by_bare_name.setdefault(cls.name, []).append(info)

    graph = _Graph()
    scans: Dict[Tuple[str, str], _FnScan] = {}  # (class qual, method) -> scan
    scan_meta: Dict[Tuple[str, str], Tuple[str, _ClassInfo]] = {}
    for m in modules:
        for cls in iter_classes(m):
            info = classes[f"{m.modname}.{cls.name}"]
            for node in info.lock_attrs:
                if info.reentrant(f"{info.qual}.{node}"):
                    graph.reentrant.add(f"{info.qual}.{node}")
            for method in iter_methods(cls):
                s = _FnScan()
                _scan_function(method, info, mod_locks[m.modname], s, by_bare_name)
                scans[(info.qual, method.name)] = s
                scan_meta[(info.qual, method.name)] = (m.relpath, info)

    # transitive lock sets, to fixpoint
    locks_of: Dict[Tuple[str, str], Set[str]] = {
        k: {n for n, _, _ in s.acquires} for k, s in scans.items()
    }

    def resolve(key: Tuple[str, str], ref: Tuple[str, ...]) -> Optional[Tuple[str, str]]:
        qual, _ = key
        info = classes[qual]
        if ref[0] == "self":
            callee = (qual, ref[1])
            return callee if callee in scans else None
        if ref[0] == "attr":
            tname = info.attr_types.get(ref[1])
            if tname is None:
                return None
            cands = by_bare_name.get(tname, [])
            if len(cands) == 1:
                callee = (cands[0].qual, ref[2])
                return callee if callee in scans else None
        return None

    changed = True
    iters = 0
    while changed and iters < 50:
        changed = False
        iters += 1
        for key, s in scans.items():
            cur = locks_of[key]
            for ref, _, _ in s.calls:
                callee = resolve(key, ref)
                if callee is not None:
                    extra = locks_of[callee] - cur
                    if extra:
                        cur |= extra
                        changed = True

    # edges: direct nesting + held-at-call x callee's transitive locks.
    # Re-acquiring a lock ALREADY in the held set cannot block, so it
    # orders nothing new against the other held locks — it only matters
    # as a self-deadlock on a non-reentrant Lock.
    for key, s in scans.items():
        relpath, info = scan_meta[key]
        ctx = f"{key[0].rsplit('.', 1)[-1]}.{key[1]}"
        for node, held, line in s.acquires:
            if node in held:
                if node not in graph.reentrant:
                    graph.add(node, node, (relpath, line, ctx))  # self-edge on Lock
                continue
            for h in held:
                graph.add(h, node, (relpath, line, ctx))
        for ref, held, line in s.calls:
            if not held:
                continue
            callee = resolve(key, ref)
            if callee is None:
                continue
            for inner in locks_of[callee]:
                if inner in held:
                    if inner not in graph.reentrant:
                        # callee re-acquires a plain Lock the caller holds
                        graph.add(
                            inner, inner, (relpath, line, ctx + " -> " + callee[1])
                        )
                    continue
                for h in held:
                    graph.add(h, inner, (relpath, line, ctx + " -> " + callee[1]))

    allow = _load_allowlist(allowlist_path)
    if stale_out is not None:
        stale_out.extend(sorted(a for a in allow if a not in graph.edges))
    edges = {e: w for e, w in graph.edges.items() if e not in allow}

    findings: List[Finding] = []
    # self-edges on non-reentrant locks
    for (a, b), (relpath, line, ctx) in sorted(edges.items()):
        if a == b:
            findings.append(
                Finding(
                    checker="lockorder",
                    path=relpath,
                    relpath=relpath,
                    line=line,
                    message=(
                        f"non-reentrant lock {a} re-acquired while held (in {ctx})"
                    ),
                )
            )

    # cycle detection (iterative Tarjan SCC over the directed edge set)
    adj: Dict[str, List[str]] = {}
    for (a, b) in edges:
        if a != b:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    onstack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v0: str) -> None:
        work = [(v0, iter(adj.get(v0, ())))]
        index[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        onstack.add(v0)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    onstack.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                elif w in onstack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    for comp in sccs:
        comp_set = set(comp)
        detail = "; ".join(
            f"{a}->{b} at {w[0]}:{w[1]} ({w[2]})"
            for (a, b), w in sorted(edges.items())
            if a in comp_set and b in comp_set and a != b
        )
        first = min(
            (w for (a, b), w in edges.items() if a in comp_set and b in comp_set),
            key=lambda w: (w[0], w[1]),
        )
        findings.append(
            Finding(
                checker="lockorder",
                path=first[0],
                relpath=first[0],
                line=first[1],
                message=(
                    "lock-order cycle (potential inversion): "
                    + " <-> ".join(comp)
                    + f" [{detail}]"
                ),
            )
        )
    return findings


def build_edges(modules: Sequence[Module]) -> Dict[Tuple[str, str], Tuple[str, int, str]]:
    """The raw acquired-while-holding edge set (debug/doc aid; the CLI's
    ``--dump-lock-graph`` prints it)."""
    classes: Dict[str, _ClassInfo] = {}
    by_bare_name: Dict[str, List[_ClassInfo]] = {}
    for m in modules:
        for cls in iter_classes(m):
            info = _collect_class_info(m, cls)
            classes[info.qual] = info
            by_bare_name.setdefault(cls.name, []).append(info)
    graph: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for m in modules:
        ml = _ModuleLocks(m)
        for cls in iter_classes(m):
            info = classes[f"{m.modname}.{cls.name}"]
            for method in iter_methods(cls):
                s = _FnScan()
                _scan_function(method, info, ml, s, by_bare_name)
                ctx = f"{cls.name}.{method.name}"
                for node, held, line in s.acquires:
                    for h in held:
                        if h != node:
                            graph.setdefault((h, node), (m.relpath, line, ctx))
    return graph
