"""Checker 13 (gen-4): epoch-coherence domination over the verdict planes.

The interned-verdict cache proves freshness by epoch sums: a
PreFilter verdict is a pure function of (request-shape id, accel class,
matched cols, per-col state), and every mutation that can change a
verdict must bump ``col_epoch[col]`` / ``global_epoch`` under the
owner's main lock. A write that skips the bump does not crash anything
— it silently serves a stale admission verdict at cache-hit speed
(134k decisions/s of quiet wrongness), which is exactly the bug shape
static analysis exists for.

``ops/schema.py`` declares the covered state as a literal set
(``VERDICT_EPOCH_PLANES`` — read from the AST here, the same registry
idiom as ``INT64_MILLI_PLANES``): the st_* flip planes, the
threshold/spec columns, the usage and reservation ledgers, and the
per-accel-class override table. The checker scans ``engine/``,
``sharding/``, and ``plugin/`` for **covered writes**:

- direct stores — ``X.<plane>[...] = ``, ``X.<plane> = ``, augmented
  assigns, and mutating container calls (``.pop``/``.clear``/
  ``.update``/``.fill``) on a covered attribute;
- indirect stores — a call passing a covered plane name as a string
  literal (the ``_amount_into_row(amount, "res_cnt", ...)`` shape:
  devicestate routes row encodes through ``getattr``-named planes, so
  the plane name at the call site IS the write).

Every covered write must be **dominated by an epoch bump**: the writing
function itself bumps (writes ``col_epoch``/``global_epoch``/
``_epochs``/``_global_epoch``, calls a ``bump_epoch*`` /
``_bump_pod_epochs`` / ``_bump_global_epoch`` / ``invalidate_all``
provider, or carries an inline ``#: epoch-bumps:`` annotation at its
``def``), or EVERY caller — resolved interprocedurally to fixpoint over
the same call shapes the lockorder/blocking checkers resolve
(``self.m()``, ``self.attr.m()`` with one level of attribute-type
inference, unique bare-name module functions) — is recursively
dominated. ``__init__`` is exempt (construction precedes sharing; the
epoch plane itself is allocated there).

Vetted exceptions go in ``epoch_allow.txt``, one per line::

    engine.devicestate.KindState.ensure_capacity -> thr_cnt  # growth zero-fills invalid cols only

keyed ``(context, plane)`` with a mandatory justification. Entries
matching no write site are stale and FAIL the run (``--prune-stale``
deletes them). The runtime companion (``utils/epochassert.py``,
``KT_EPOCH_ASSERT=1``) keeps the allow file honest: a waived-but-wrong
entry surfaces as a StaleVerdict report in the armed suite.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, iter_classes, iter_methods, load_pair_allowlist

_SCOPE_PREFIXES = ("engine/", "sharding/", "plugin/")

# minimal fallback when the declaring schema module is outside the
# analyzed root (fixture trees declare their own registry)
_FALLBACK_PLANES = frozenset(
    {"thr_cnt", "used_cnt", "res_cnt", "st_cnt_throttled"}
)

# writes to these attributes ARE the bump
_EPOCH_ATTRS = {"col_epoch", "global_epoch", "_epochs", "_global_epoch"}
# calling one of these (or any bump_epoch*-named function) provides the bump
_BUMP_CALLS = {"bump_epochs_for", "_bump_pod_epochs", "_bump_global_epoch", "invalidate_all"}
_MUTATING_METHODS = {"pop", "clear", "update", "fill", "setdefault"}

_INLINE_RE = re.compile(r"#:\s*epoch-bumps:")

EXEMPT_METHODS = {"__init__"}


def in_scope(module: Module) -> bool:
    rel = module.relpath.replace("\\", "/")
    return rel.startswith(_SCOPE_PREFIXES)


def load_planes(modules: Sequence[Module]) -> Set[str]:
    """``VERDICT_EPOCH_PLANES`` literal from ops/schema.py's AST; the
    checked-in fallback only applies when the declaring module is outside
    the analyzed root."""
    for m in modules:
        if not m.relpath.replace("\\", "/").endswith("schema.py"):
            continue
        for node in m.tree.body:
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
                if isinstance(t, ast.Name) and t.id == "VERDICT_EPOCH_PLANES":
                    # the registry idiom wraps the literal in frozenset(...)
                    # (or set(...)); literal_eval can't evaluate a Call, so
                    # unwrap to the underlying set/list/tuple display first
                    if (
                        isinstance(value, ast.Call)
                        and isinstance(value.func, ast.Name)
                        and value.func.id in ("frozenset", "set")
                        and len(value.args) == 1
                        and not value.keywords
                    ):
                        value = value.args[0]
                    try:
                        got = ast.literal_eval(value)
                    except ValueError:
                        continue
                    return {str(v) for v in got}
    return set(_FALLBACK_PLANES)


def _annotated_bump(m: Module, fn: ast.AST) -> bool:
    """True when the ``def`` line (or the line above it) carries an
    inline ``#: epoch-bumps:`` annotation."""
    for lineno in (fn.lineno, fn.lineno - 1):
        i = lineno - 1
        if 0 <= i < len(m.lines) and _INLINE_RE.search(m.lines[i]):
            return True
    return False


def _target_attr(node: ast.AST) -> Optional[str]:
    """The attribute name written by an assignment target: ``X.attr``,
    ``X.attr[...]``, or a plane-named bare name ONLY when subscripted
    (``plane[...] = `` may store through a local alias of the plane; a
    bare ``plane = ...`` rebinds a local and writes nothing shared)."""
    subscripted = isinstance(node, ast.Subscript)
    if subscripted:
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name) and subscripted:
        return node.id
    return None


class _FnScan:
    """One function's covered writes, bump evidence, and call refs."""

    def __init__(self) -> None:
        self.writes: List[Tuple[str, int]] = []  # (plane, line)
        self.bumps = False
        # ref is ("self", m) | ("attr", a, m) | ("name", f)
        self.calls: List[Tuple[Tuple[str, ...], int]] = []


def _scan_function(m: Module, fn: ast.AST, planes: Set[str], out: _FnScan) -> None:
    if _annotated_bump(m, fn):
        out.bumps = True
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                attr = _target_attr(t)
                if attr in _EPOCH_ATTRS:
                    out.bumps = True
                elif attr in planes:
                    out.writes.append((attr, node.lineno))
        elif isinstance(node, ast.Call):
            f = node.func
            # mutating container calls on a covered plane / bump providers
            if isinstance(f, ast.Attribute):
                if isinstance(f.value, ast.Attribute):
                    owner = f.value.attr
                    if f.attr in _MUTATING_METHODS and owner in planes:
                        out.writes.append((owner, node.lineno))
                    if f.attr in _MUTATING_METHODS and owner in _EPOCH_ATTRS:
                        out.bumps = True
                name = f.attr
            elif isinstance(f, ast.Name):
                name = f.id
            else:
                name = ""
            if name.startswith("bump_epoch") or name in _BUMP_CALLS:
                out.bumps = True
                continue
            # indirect store: a covered plane name passed as a string
            # literal (the getattr-named row-encode shape)
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if (
                    isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value in planes
                ):
                    out.writes.append((arg.value, node.lineno))
            # call refs for the caller graph
            if isinstance(f, ast.Attribute):
                base = f.value
                if isinstance(base, ast.Name) and base.id == "self":
                    out.calls.append((("self", f.attr), node.lineno))
                elif (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                ):
                    out.calls.append((("attr", base.attr, f.attr), node.lineno))
            elif isinstance(f, ast.Name):
                out.calls.append((("name", f.id), node.lineno))


def check(
    modules: Sequence[Module],
    allowlist_path: Optional[str] = None,
    stale_out: Optional[List[Tuple[str, str]]] = None,
) -> List[Finding]:
    from .lockgraph import _ClassInfo, _collect_class_info

    planes = load_planes(modules)

    classes: Dict[str, _ClassInfo] = {}
    by_bare_name: Dict[str, List[_ClassInfo]] = {}
    for m in modules:
        for cls in iter_classes(m):
            info = _collect_class_info(m, cls)
            classes[info.qual] = info
            by_bare_name.setdefault(cls.name, []).append(info)

    scans: Dict[Tuple[str, str], _FnScan] = {}
    scan_meta: Dict[Tuple[str, str], str] = {}  # key -> relpath
    module_fns: Dict[str, List[Tuple[str, str]]] = {}
    for m in modules:
        if not in_scope(m):
            continue
        method_ids = set()
        for cls in iter_classes(m):
            qual = f"{m.modname}.{cls.name}"
            for method in iter_methods(cls):
                method_ids.add(id(method))
                s = _FnScan()
                _scan_function(m, method, planes, s)
                scans[(qual, method.name)] = s
                scan_meta[(qual, method.name)] = m.relpath
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if id(node) in method_ids:
                    continue
                s = _FnScan()
                _scan_function(m, node, planes, s)
                key = (m.modname, node.name)
                scans[key] = s
                scan_meta[key] = m.relpath
                module_fns.setdefault(node.name, []).append(key)

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

    # caller graph (interprocedural, over the resolved call shapes)
    callers: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {k: set() for k in scans}
    for key, s in scans.items():
        for ref, _ in s.calls:
            callee = resolve(key, ref)
            if callee is not None and callee != key:
                callers[callee].add(key)

    def dominated(key: Tuple[str, str], seen: Set[Tuple[str, str]]) -> bool:
        """A function is dominated when it bumps itself, or when every
        caller is (recursively). No callers = a public entry that must
        bump itself. ``__init__`` callers count as dominated
        (construction precedes sharing)."""
        if key in seen:
            return False
        seen.add(key)
        s = scans.get(key)
        if s is not None and s.bumps:
            return True
        if key[1] in EXEMPT_METHODS:
            return True
        cs = callers.get(key, set())
        if not cs:
            return False
        return all(dominated(c, seen) for c in cs)

    allow = load_pair_allowlist(allowlist_path)
    seen_pairs: Set[Tuple[str, str]] = set()
    findings: List[Finding] = []
    emitted: Set[Tuple[str, str]] = set()  # (context, plane) dedup

    for key, s in scans.items():
        if not s.writes:
            continue
        if key[1] in EXEMPT_METHODS:
            continue
        if dominated(key, set()):
            continue
        relpath = scan_meta[key]
        ctx = f"{key[0]}.{key[1]}" if "." in key[0] else f"{key[0]}.{key[1]}"
        for plane, line in s.writes:
            seen_pairs.add((ctx, plane))
            if (ctx, plane) in allow:
                continue
            if (ctx, plane) in emitted:
                continue
            emitted.add((ctx, plane))
            short = ctx.rsplit(".", 2)
            findings.append(
                Finding(
                    checker="epochs",
                    path=relpath,
                    relpath=relpath,
                    line=line,
                    message=(
                        f"write to verdict-epoch plane '{plane}' not dominated "
                        f"by an epoch bump (in {'.'.join(short[-2:])})"
                    ),
                )
            )

    if stale_out is not None:
        stale_out.extend(sorted(p for p in allow if p not in seen_pairs))
    findings.sort(key=lambda f: (f.relpath, f.line, f.message))
    return findings
