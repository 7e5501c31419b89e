"""Checker 9: dtype/overflow discipline over the int64 milli-unit planes.

``ops/schema.py`` declares the int64 planes as a literal set
(``INT64_MILLI_PLANES`` — read from the AST here, the same registry
idiom as fault sites and metric families). Those tensors carry exact
milli-unit quantities and pod counts summed over up to 1M pods; an
int32 accumulator overflows at ~2.1 cores across 1k pods and a float
cast silently rounds. The checker scans ``ops/``, ``parallel/``, and
the engine staging planes (``engine/devicestate.py``,
``engine/columnar.py``) for three shapes:

- **narrowing cast** — ``<plane>.astype(np.int32)`` (or int16/8,
  uint*, float16/32/64, via ``astype``/``asarray``/``array`` with a
  narrow dtype), and torch's ``.to(torch.int32)``/``.to(dtype=...)``/
  ``.type(...)``, ``torch.as_tensor``/``torch.tensor(..., dtype=...)``
  and the cast methods ``.int()``/``.short()``/``.char()``/``.byte()``/
  ``.half()``/``.bfloat16()``/``.float()``/``.double()``, applied to an
  expression mentioning a declared plane. float64 counts as narrowing:
  milli values exceed 2^53. The vetted exact-float64 path
  (``ops/aggregate.py``) splits into 32-bit limbs under *different
  names* first, so it does not trip this rule;
- **narrow accumulator** — a reduction (``sum``/``nansum``/``cumsum``/
  ``prod``/``cumprod``/``dot``/``matmul``/``einsum``/``segment_sum``/
  ``tensordot``) whose ``dtype=`` is narrow while an operand mentions a
  declared plane (reductions over masks/statuses with int32 accumulators
  stay legal), and torch's ``index_add_``/``scatter_add_``/
  ``scatter_reduce_`` (and their out-of-place forms) of a plane into a
  destination that is narrow in the same function: a narrow allocation
  or cast, or a name bound from one;
- **default-dtype allocation** — ``np.zeros``/``np.empty``/``np.ones``/
  ``np.full``/``torch.zeros``/... assigned to a declared plane name
  without an explicit ``dtype=``: numpy defaults to float64 (and
  platform-C-long for ``full`` of ints), torch to float32 (``full`` of
  an int gives int64, of a float float32) — either silently floats the
  milli math. The host tiers still stage planes in numpy, so both
  families are checked.

The rules are name-syntactic on purpose: the planes are *declared*, so
a rename without updating the declaration is caught by the default-
dtype/narrowing rules going silent on the new name while the stale
declaration keeps the honest writer honest (update the set in the same
commit). Interprocedural value flow is the runtime differential soaks'
job; this checker pins the declared boundary.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from .core import Finding, Module, unparse

# dtypes that cannot hold an exact int64 milli value
NARROW_DTYPES = {
    "int8",
    "int16",
    "int32",
    "uint8",
    "uint16",
    "uint32",
    "float16",
    "bfloat16",
    "float32",
    "float64",
}

_CAST_CALLS = {
    "asarray", "array", "as_tensor", "tensor", "full", "full_like", "zeros_like",
    "ones_like",
}
# the calls whose second positional argument is the dtype
_POSITIONAL_DTYPE = {"asarray", "array", "as_tensor"}
_REDUCTIONS = {
    "sum",
    "nansum",
    "cumsum",
    "prod",
    "cumprod",
    "dot",
    "matmul",
    "einsum",
    "tensordot",
    "segment_sum",
}
# torch's argument-free cast methods and the dtype each gives
_CAST_METHODS = {
    "int": "int32",
    "short": "int16",
    "char": "int8",
    "byte": "uint8",
    "half": "float16",
    "bfloat16": "bfloat16",
    "float": "float32",
    "double": "float64",
}
# torch's scatter-accumulate methods: (destination).<op>(dim, index, source)
_ACCUMULATE_INTO = {
    "index_add_", "index_add", "scatter_add_", "scatter_add", "scatter_reduce_",
    "scatter_reduce",
}
_ALLOCATORS = {"zeros", "empty", "ones", "full", "zeros_like", "empty_like"}

_DEVICE_SCOPE_PREFIXES = ("ops/", "parallel/")
_DEVICE_SCOPE_FILES = ("engine/devicestate.py", "engine/columnar.py")

_FALLBACK_PLANES = frozenset(
    {"thr_cnt", "thr_req", "used_cnt", "used_req", "res_cnt", "res_req", "req", "pod_req"}
)


def in_scope(module: Module) -> bool:
    rel = module.relpath.replace("\\", "/")
    return rel.startswith(_DEVICE_SCOPE_PREFIXES) or rel in _DEVICE_SCOPE_FILES


def load_planes(modules: Sequence[Module]) -> Set[str]:
    """``INT64_MILLI_PLANES`` literal from ops/schema.py's AST; the
    checked-in fallback only applies when the declaring module is outside
    the analyzed root (fixture trees declare their own)."""
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
                if isinstance(t, ast.Name) and t.id == "INT64_MILLI_PLANES":
                    try:
                        got = ast.literal_eval(value)
                    except ValueError:
                        continue
                    return {str(v) for v in got}
    return set(_FALLBACK_PLANES)


def _dtype_name(node: ast.AST) -> Optional[str]:
    """'int32' for jnp.int32 / np.int32 / "int32" / int32."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _mentioned_planes(expr: ast.AST, planes: Set[str]) -> Set[str]:
    """Declared plane names appearing as identifiers/attributes in expr
    as *values*. ``*_present`` masks and ``st_*`` flags are distinct
    names, so they never collide; a plane inside a comparison
    (``req != 0``, ``pod_req > thr_req``) yields a bool mask, not milli
    values — casting THAT is legal, so Compare subtrees are skipped."""
    hits: Set[str] = set()

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.Compare):
            return
        if isinstance(node, ast.Name) and node.id in planes:
            hits.add(node.id)
            return
        if isinstance(node, ast.Attribute):
            if node.attr in planes:
                hits.add(node.attr)
            return
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(expr)
    return hits


def _call_attr(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _dtype_kwarg(call: ast.Call) -> Optional[str]:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return _dtype_name(kw.value)
    return None


def _narrow_dtype_of(expr: ast.AST, narrow: Dict[str, str]) -> Optional[str]:
    """The narrow dtype ``expr`` is known to have in its function: an
    allocation or ``as_tensor`` with a narrow ``dtype=``, a narrowing
    ``.to``/``.type``/``.astype`` or cast method, or a name in ``narrow``
    (bound from one of those). None when it is not known to be narrow."""
    if isinstance(expr, ast.Name):
        return narrow.get(expr.id)
    if not isinstance(expr, ast.Call):
        return None
    name = _call_attr(expr)
    if isinstance(expr.func, ast.Attribute):
        if name in _CAST_METHODS and not expr.args and not expr.keywords:
            return _CAST_METHODS[name]
        if name in ("to", "type", "astype"):
            dt = _cast_target(expr)
            return dt if dt in NARROW_DTYPES else None
    dt = _dtype_kwarg(expr)
    return dt if dt in NARROW_DTYPES else None


def _cast_target(call: ast.Call) -> Optional[str]:
    """The dtype of a ``.to``/``.type``/``.astype`` call: its ``dtype=``,
    else the first positional argument that names a dtype (``.to(device,
    torch.int32)`` and ``.to(torch.int32)`` alike)."""
    dt = _dtype_kwarg(call)
    if dt is not None:
        return dt
    for a in call.args:
        name = _dtype_name(a)
        if name in NARROW_DTYPES or name in ("int64", "long", "bool"):
            return name
    return None


def _narrow_names(fn: ast.AST) -> Dict[str, str]:
    """Local names of ``fn`` bound from a narrow expression, with the dtype."""
    narrow: Dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            dt = _narrow_dtype_of(node.value, narrow)
            if dt is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        narrow[t.id] = dt
    return narrow


def _target_names(node: ast.AST) -> List[str]:
    """Assignment-target plane candidates: bare names, self-attrs, and
    subscripted bases (``self.pod_req[row] = ...`` targets pod_req)."""
    out: List[str] = []
    t = node
    while isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Name):
        out.append(t.id)
    elif isinstance(t, ast.Attribute):
        out.append(t.attr)
    elif isinstance(t, ast.Tuple):
        for elt in t.elts:
            out.extend(_target_names(elt))
    return out


def check_module(module: Module, planes: Set[str]) -> List[Finding]:
    findings: List[Finding] = []

    def emit(line: int, message: str) -> None:
        findings.append(
            Finding(
                checker="dtype",
                path=module.path,
                relpath=module.relpath,
                line=line,
                message=message,
            )
        )

    for node in module.walk():
        if isinstance(node, ast.Call):
            name = _call_attr(node)
            # narrowing cast: <expr over plane>.astype(narrow) or
            # asarray/array(<plane expr>, dtype=narrow)
            if name in ("astype", "to", "type") and isinstance(node.func, ast.Attribute):
                dt = _cast_target(node)
                if dt in NARROW_DTYPES:
                    hit = _mentioned_planes(node.func.value, planes)
                    if hit:
                        emit(
                            node.lineno,
                            f"narrowing cast .{name}({dt}) of int64 plane "
                            f"{'/'.join(sorted(hit))} (declared in "
                            "ops/schema.py INT64_MILLI_PLANES)",
                        )
                continue
            if (name in _CAST_METHODS and isinstance(node.func, ast.Attribute)
                    and not node.args and not node.keywords):
                hit = _mentioned_planes(node.func.value, planes)
                if hit:
                    emit(
                        node.lineno,
                        f"narrowing cast .{name}() ({_CAST_METHODS[name]}) of int64 "
                        f"plane {'/'.join(sorted(hit))} (declared in "
                        "ops/schema.py INT64_MILLI_PLANES)",
                    )
                continue
            if name in _CAST_CALLS:
                dt = _dtype_kwarg(node)
                if dt is None and len(node.args) >= 2 and name in _POSITIONAL_DTYPE:
                    dt = _dtype_name(node.args[1])
                if dt in NARROW_DTYPES:
                    hit: Set[str] = set()
                    for a in node.args[:1]:
                        hit |= _mentioned_planes(a, planes)
                    if hit:
                        emit(
                            node.lineno,
                            f"narrowing {name}(..., dtype={dt}) of int64 plane "
                            f"{'/'.join(sorted(hit))}",
                        )
                # fall through: full/zeros_like are also allocators below
            if name in _REDUCTIONS:
                dt = _dtype_kwarg(node)
                if dt in NARROW_DTYPES:
                    hit = set()
                    for a in node.args:
                        hit |= _mentioned_planes(a, planes)
                    if isinstance(node.func, ast.Attribute):
                        hit |= _mentioned_planes(node.func.value, planes)
                    if hit:
                        emit(
                            node.lineno,
                            f"reduction {name}(dtype={dt}) over int64 plane "
                            f"{'/'.join(sorted(hit))} — accumulator must stay "
                            "int64",
                        )
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = getattr(node, "value", None)
            if not isinstance(value, ast.Call):
                continue
            name = _call_attr(value)
            if name not in _ALLOCATORS:
                continue
            if _dtype_kwarg(value) is not None:
                continue
            if name in ("zeros_like", "empty_like"):
                continue  # inherits the source dtype
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            torch_call = unparse(value.func).startswith("torch.")
            for t in targets:
                for tn in _target_names(t):
                    if tn in planes:
                        emit(
                            value.lineno,
                            f"default-dtype {name}() assigned to int64 plane "
                            f"'{tn}' — "
                            + ("torch defaults to float32; pass dtype=torch.int64"
                               if torch_call else
                               "numpy defaults to float64; pass dtype=np.int64"),
                        )
    findings.extend(_accumulate_findings(module, planes))
    return findings


def _accumulate_findings(module: Module, planes: Set[str]) -> List[Finding]:
    """``dest.index_add_(dim, index, <plane>)`` and its kind, where the
    destination is narrow in the enclosing function."""
    out: Dict[int, Finding] = {}  # keyed by call node: nested defs are walked twice
    for fn in module.walk():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        narrow = _narrow_names(fn)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _ACCUMULATE_INTO):
                continue
            dt = _narrow_dtype_of(node.func.value, narrow)
            if dt is None:
                continue
            hit: Set[str] = set()
            for a in list(node.args) + [k.value for k in node.keywords]:
                hit |= _mentioned_planes(a, planes)
            if hit and id(node) not in out:
                out[id(node)] = Finding(
                    checker="dtype",
                    path=module.path,
                    relpath=module.relpath,
                    line=node.lineno,
                    message=(
                        f"{node.func.attr} of int64 plane {'/'.join(sorted(hit))} "
                        f"into a {dt} destination — accumulator must stay int64"
                    ),
                )
    return sorted(out.values(), key=lambda f: f.line)


def check(modules: Sequence[Module]) -> List[Finding]:
    planes = load_planes(modules)
    out: List[Finding] = []
    for m in modules:
        if in_scope(m):
            out.extend(check_module(m, planes))
    return out
