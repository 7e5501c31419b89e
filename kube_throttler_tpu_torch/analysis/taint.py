"""Checker 15 (gen-4): trust-boundary taint over the shard transports.

The security contract: the shard protocol is pickled Python —
``pickle.loads`` on attacker bytes is remote code execution, full stop
— so every frame crossing a non-loopback boundary is HMAC-authenticated
and ``read_frame`` verifies the tag with ``hmac.compare_digest``
BEFORE the payload ever reaches the deserializer. The contract only
holds if ``read_frame`` stays the ONLY ingestion point: one new
``pickle.loads(sock.recv(...))`` anywhere in the transport quietly
reopens the RCE class.

The checker makes the boundary structural over ``sharding/`` and
``engine/replication.py``:

- **sources** — network bytes: the result of ``X.recv(...)`` /
  ``X.recv_into(...)`` / ``X.accept()`` / ``X.makefile(...)`` (and
  reads off such a reader), plus parameters named ``rfile``/``sock``
  (the framing layer's reader-handle convention). Taint propagates
  through assignment, slicing, and concatenation, flow-insensitively
  to a local fixpoint;
- **sinks** — ``pickle.loads`` (exec-shaped: always) and ``json.loads``
  (flagged only when fed tainted bytes — the parser itself is safe,
  but an unauthenticated parse is still a boundary crossing worth a
  justified waiver);
- **the gate** — ``hmac.compare_digest``: a function that verifies a
  digest before deserializing (the ``read_frame`` shape, including its
  keyless trusted-local socketpair path — the gate is present, keying
  is the caller's deployment contract) satisfies the rule.

Two finding shapes:

1. a sink fed tainted bytes in a function with no ``compare_digest``
   gate — unauthenticated deserialization of network bytes;
2. any ``pickle.loads`` in the transport scope outside a gated
   function — a frame-ingestion point bypassing the authenticated
   framing layer, even when this checker cannot see the bytes' origin
   (pickle of locally-produced bytes belongs outside the transport or
   in ``baseline.txt`` with a justification).

One structural exemption, shape 2 only: ``sharding/shmring.py``. The
shared-memory event ring never carries network bytes — the segment is
created by the supervisor, mode 0600 on the local host, attached only
by the worker it spawned, and the TCP transport cannot reach it — so
its rare ``ROW_BLOB`` ``pickle.loads`` deserializes bytes this process
tree wrote into its own memory. That is the same trust statement as the
keyless socketpair pickle stream (whose gate is present but unkeyed).
Shape 1 still applies there in full: the moment network-sourced bytes
flow into the module, the exemption does NOT cover them.

Waivers go in ``baseline.txt`` (checker-agnostic keys) with mandatory
justifications; stale entries FAIL the run as usual.
"""

from __future__ import annotations

import ast
from typing import List, Sequence, Set

from .core import Finding, Module, iter_classes, iter_methods

_SCOPE_PREFIXES = ("sharding/",)
_SCOPE_FILES = ("engine/replication.py",)

_SOURCE_ATTRS = {"recv", "recv_into", "accept", "makefile"}
_TAINTED_PARAMS = {"rfile", "sock"}

# Shape-2 ("bypass") exemption: modules whose pickle.loads calls
# deserialize same-host bytes this process tree wrote itself (see the
# module docstring's trust-domain note). Shape 1 still applies.
_SHM_EXEMPT_FILES = ("sharding/shmring.py",)


def in_scope(module: Module) -> bool:
    rel = module.relpath.replace("\\", "/")
    return rel.startswith(_SCOPE_PREFIXES) or rel in _SCOPE_FILES


def _names_in(expr: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


def _has_source_call(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _SOURCE_ATTRS
        ):
            return True
    return False


def _is_gated(fn: ast.AST) -> bool:
    """True when the function calls ``hmac.compare_digest`` (the
    read_frame auth gate) anywhere in its body."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "compare_digest":
                return True
            if isinstance(f, ast.Name) and f.id == "compare_digest":
                return True
    return False


def _tainted_names(fn: ast.AST) -> Set[str]:
    """Flow-insensitive local taint set: params named like network
    readers, plus anything assigned from a source call or an
    already-tainted name, to fixpoint."""
    tainted: Set[str] = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for a in list(fn.args.args) + list(fn.args.kwonlyargs):
            if a.arg in _TAINTED_PARAMS:
                tainted.add(a.arg)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AugAssign):
                value, targets = node.value, [node.target]
            else:
                continue
            if _has_source_call(value) or (_names_in(value) & tainted):
                for t in targets:
                    if isinstance(t, ast.Name) and t.id not in tainted:
                        tainted.add(t.id)
                        changed = True
                    elif isinstance(t, ast.Tuple):
                        for el in t.elts:
                            if isinstance(el, ast.Name) and el.id not in tainted:
                                tainted.add(el.id)
                                changed = True
    return tainted


def _sink_kind(call: ast.Call) -> str:
    """'pickle' / 'json' / '' for a deserializer call."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "loads":
        if isinstance(f.value, ast.Name):
            if f.value.id == "pickle":
                return "pickle"
            if f.value.id == "json":
                return "json"
        return "pickle"  # aliased pickle-ish loads: treat as exec-shaped
    if isinstance(f, ast.Name) and f.id == "loads":
        return "pickle"
    return ""


def check(modules: Sequence[Module]) -> List[Finding]:
    findings: List[Finding] = []
    emitted: Set[tuple] = set()

    def scan(m: Module, fn: ast.AST, ctx: str) -> None:
        gated = _is_gated(fn)
        tainted = _tainted_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            kind = _sink_kind(node)
            if not kind:
                continue
            arg = node.args[0] if node.args else None
            fed_taint = arg is not None and (
                _has_source_call(arg) or bool(_names_in(arg) & tainted)
            )
            if fed_taint and not gated:
                key = (m.relpath, ctx, kind, "taint")
                if key not in emitted:
                    emitted.add(key)
                    findings.append(
                        Finding(
                            checker="taint",
                            path=m.relpath,
                            relpath=m.relpath,
                            line=node.lineno,
                            message=(
                                f"unauthenticated {kind}.loads of network bytes "
                                f"(no hmac.compare_digest gate in {ctx})"
                            ),
                        )
                    )
            elif kind == "pickle" and not gated:
                if m.relpath.replace("\\", "/").endswith(_SHM_EXEMPT_FILES):
                    continue  # same-host shm blobs — docstring exemption
                key = (m.relpath, ctx, "pickle", "bypass")
                if key not in emitted:
                    emitted.add(key)
                    findings.append(
                        Finding(
                            checker="taint",
                            path=m.relpath,
                            relpath=m.relpath,
                            line=node.lineno,
                            message=(
                                f"frame-ingestion point bypasses the "
                                f"authenticated framing layer: pickle.loads "
                                f"outside the read_frame gate (in {ctx})"
                            ),
                        )
                    )

    for m in modules:
        if not in_scope(m):
            continue
        claimed = set()
        for cls in iter_classes(m):
            for method in iter_methods(cls):
                claimed.add(id(method))
                scan(m, method, f"{cls.name}.{method.name}")
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if id(node) in claimed:
                    continue
                scan(m, node, node.name)

    findings.sort(key=lambda f: (f.relpath, f.line, f.message))
    return findings
