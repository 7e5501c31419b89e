"""The int64 planes stay int64 in the port: a port-local AST check over
``kube_throttler_tpu_torch/ops/``, ``parallel/`` and
``engine/devicestate.py``.

The JAX package's ``dtype`` checker (``kube_throttler_tpu/analysis/
device.py``) knows numpy and jnp spellings only, so it cannot see a torch
narrowing. This check flags, on any name of ``INT64_MILLI_PLANES``
(``ops/schema.py``):

- a narrowing cast of an expression that mentions the name:
  ``.to(torch.int32)`` (any dtype other than int64, as ``.to``/``.type``
  argument or ``dtype=``), ``.int()``, ``.float()``, ``.double()``,
  ``.half()``, ``.short()``, ``.char()``, ``.byte()``, ``.bfloat16()``;
- an allocation assigned to the name (or passed as its keyword) by
  ``torch.zeros``/``empty``/``full``/``ones`` without ``dtype=``: torch
  defaults to float32, and ``full`` infers it from the fill value.
"""

import ast
from pathlib import Path

import pytest

from kube_throttler_tpu_torch.ops.schema import INT64_MILLI_PLANES

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kube_throttler_tpu_torch"
NARROW_METHODS = {"int", "float", "double", "half", "short", "char", "byte", "bfloat16"}
WIDE = {"int64", "long"}
ALLOCATORS = {"zeros", "empty", "full", "ones"}


def _scanned():
    files = sorted((PORT / "ops").glob("*.py")) + sorted((PORT / "parallel").glob("*.py"))
    files.append(PORT / "engine" / "devicestate.py")
    return files


def _planes_in(node):
    return {
        n.id if isinstance(n, ast.Name) else n.attr
        for n in ast.walk(node)
        if (isinstance(n, ast.Name) and n.id in INT64_MILLI_PLANES)
        or (isinstance(n, ast.Attribute) and n.attr in INT64_MILLI_PLANES)
    }


def _torch_dtype(node):
    """'int32' for ``torch.int32``, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "torch"):
        return node.attr
    return None


def _narrow_cast(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr in NARROW_METHODS and not call.args and not call.keywords:
        return True
    if call.func.attr in ("to", "type"):
        dtypes = [_torch_dtype(a) for a in call.args]
        dtypes += [_torch_dtype(k.value) for k in call.keywords if k.arg == "dtype"]
        return any(d is not None and d not in WIDE for d in dtypes)
    return False


def _untyped_alloc(node) -> bool:
    """Whether ``node`` holds a torch allocator call without ``dtype=``."""
    for n in ast.walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ALLOCATORS and isinstance(n.func.value, ast.Name)
                and n.func.value.id == "torch"
                and not any(k.arg == "dtype" for k in n.keywords)):
            return True
    return False


def _target_names(target):
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _target_names(elt)
    elif isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, ast.Attribute):
        yield target.attr
    elif isinstance(target, ast.Subscript):
        yield from _target_names(target.value)


def findings(source: str, filename: str = "<snippet>"):
    out = []
    for node in ast.walk(ast.parse(source, filename=filename)):
        if isinstance(node, ast.Call):
            if _narrow_cast(node):
                hit = _planes_in(node.func.value)
                if hit:
                    out.append((node.lineno, f"narrowing cast of {sorted(hit)}"))
            for k in node.keywords:
                if k.arg in INT64_MILLI_PLANES and _untyped_alloc(k.value):
                    out.append((node.lineno, f"{k.arg}= allocated without dtype"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names = {n for t in targets for n in _target_names(t)} & INT64_MILLI_PLANES
            if names and node.value is not None and _untyped_alloc(node.value):
                out.append((node.lineno, f"{sorted(names)} allocated without dtype"))
    return out


@pytest.mark.parametrize("path", _scanned(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_keeps_int64_planes_int64(path):
    found = findings(path.read_text(encoding="utf-8"), str(path))
    assert not found, f"{path.relative_to(REPO)}: {found}"


def test_scan_covers_the_tick_modules():
    names = {p.relative_to(PORT).as_posix() for p in _scanned()}
    assert {"ops/aggregate.py", "ops/overrides.py", "parallel/sharded.py",
            "engine/devicestate.py"} <= names


@pytest.mark.parametrize("snippet", [
    "x = used_req.to(torch.int32)",
    "x = state.used_cnt.to(dtype=torch.float64)",
    "x = pods.req[:, 0].float()",
    "x = (thr_req - used_req).double()",
    "x = agg.used_req.type(torch.int16)",
    "x = res_cnt.int()",
    "used_req = torch.zeros((T, R), device=dev)",
    "self.used_cnt = torch.empty(T)",
    "thr_cnt, mask = torch.full((T,), 0), None",
    "s = ThrottleState(used_req=torch.zeros(T, R))",
    "used_cnt = torch.zeros(n).index_add_(0, tgt, src)[:T]",
])
def test_check_flags(snippet):
    assert findings(snippet), snippet


@pytest.mark.parametrize("snippet", [
    "x = used_req.to(torch.int64)",
    "x = used_req.to(dev)",
    "x = used_req.to(torch.device('cpu'))",
    "x = pods.req_present.to(torch.int32)",
    "x = counts.float()",
    "used_req = torch.zeros((T, R), dtype=torch.int64, device=dev)",
    "mask = torch.zeros(T)",
    "used_cnt = torch.zeros_like(thr_cnt)",
    "s = ThrottleState(used_req=torch.zeros(T, R, dtype=torch.int64))",
])
def test_check_passes(snippet):
    assert not findings(snippet), snippet
