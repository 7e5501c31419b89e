"""Checker 12: every numeric parse of a ``KT_*`` env knob needs a guard.

The ``_GATHER_CHUNK_ELEMS`` bug class: a bare
``int(os.environ.get("KT_GATHER_CHUNK_ELEMS", ...))`` at import time
means one malformed override kills module import — or, on a serving
path, kills the daemon at the first tick that reads the knob. The
repo convention (``tpu_watch.py``'s ``KT_TUNNEL_PROBE_PORT`` guard,
``gchygiene.py``) is ``try: int(...) except ValueError: <default>``.

The rule: any ``int(...)``/``float(...)`` whose argument reads an
environment variable named ``KT_*`` (``os.environ.get``, ``os.getenv``,
``os.environ[...]``, or a bare ``environ``/``getenv`` import alias)
must sit inside a ``try`` whose handlers catch ``ValueError`` /
``TypeError`` / ``Exception``. ``environ[...]`` additionally wants
``KeyError`` coverage, but any of the accepted handlers at least keeps
a typo'd value from becoming a crash loop.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from .core import Finding, Module

_GUARD_EXCEPTIONS = {"ValueError", "TypeError", "Exception", "BaseException"}


def _env_key(call_or_sub: ast.AST) -> Optional[str]:
    """The literal env-var name if node reads an environment variable."""
    if isinstance(call_or_sub, ast.Call):
        f = call_or_sub.func
        fname = None
        if isinstance(f, ast.Attribute):
            # os.environ.get / os.getenv
            if f.attr in ("get", "getenv"):
                base = f.value
                base_txt = (
                    base.attr if isinstance(base, ast.Attribute)
                    else base.id if isinstance(base, ast.Name) else ""
                )
                if base_txt in ("environ", "os"):
                    fname = f.attr
        elif isinstance(f, ast.Name) and f.id == "getenv":
            fname = "getenv"
        if fname and call_or_sub.args:
            a = call_or_sub.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
        return None
    if isinstance(call_or_sub, ast.Subscript):
        base = call_or_sub.value
        base_txt = (
            base.attr if isinstance(base, ast.Attribute)
            else base.id if isinstance(base, ast.Name) else ""
        )
        if base_txt == "environ":
            s = call_or_sub.slice
            if isinstance(s, ast.Constant) and isinstance(s.value, str):
                return s.value
    return None


def _handler_catches(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    names = []
    if isinstance(t, ast.Tuple):
        names = [e for e in t.elts]
    else:
        names = [t]
    for n in names:
        txt = n.attr if isinstance(n, ast.Attribute) else getattr(n, "id", "")
        if txt in _GUARD_EXCEPTIONS:
            return True
    return False


def check_module(module: Module) -> List[Finding]:
    findings: List[Finding] = []
    # guarded line ranges: bodies of try statements with an accepted handler
    guarded: List[tuple] = []
    for node in module.walk():
        if isinstance(node, ast.Try) and any(
            _handler_catches(h) for h in node.handlers
        ):
            start = node.lineno
            end = max(
                (getattr(s, "end_lineno", s.lineno) for s in node.body),
                default=node.lineno,
            )
            guarded.append((start, end))

    def is_guarded(line: int) -> bool:
        return any(a <= line <= b for a, b in guarded)

    for node in module.walk():
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Name) and f.id in ("int", "float")):
            continue
        key = None
        for sub in ast.walk(node):
            if sub is node:
                continue
            key = _env_key(sub)
            if key is not None:
                break
        if key is None or not key.startswith("KT_"):
            continue
        if is_guarded(node.lineno):
            continue
        findings.append(
            Finding(
                checker="envguard",
                path=module.path,
                relpath=module.relpath,
                line=node.lineno,
                message=(
                    f"unguarded {f.id}() parse of env knob '{key}' — a "
                    "malformed override becomes a crash; wrap in try/except "
                    "ValueError with the default as fallback"
                ),
            )
        )
    return findings


def check(modules: Sequence[Module]) -> List[Finding]:
    out: List[Finding] = []
    for m in modules:
        out.extend(check_module(m))
    return out
