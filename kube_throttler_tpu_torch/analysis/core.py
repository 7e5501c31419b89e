"""Shared plumbing for the repo-native static analyzer.

The analyzer is AST-based and runs over the ``kube_throttler_tpu_torch``
package only (tests drive it on fixture trees too). Every checker emits
:class:`Finding`s; the CLI (``__main__``) diffs them against a checked-in
baseline so vetted findings stay waived with a one-line justification
while anything new fails ``python -m kube_throttler_tpu_torch.analysis``
and the tier-1 suite.

Baseline keys deliberately exclude line numbers: a finding is identified
by ``checker|relpath|message`` so unrelated edits shifting lines do not
churn the baseline, while any change to the violating construct itself
(attr name, lock name, call) produces a new key and fails.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Finding:
    checker: str  # "guarded" | "lockorder" | "purity" | "registry"
    path: str  # path as given to the checker (absolute or repo-relative)
    line: int  # 1-based; 0 when the finding is not line-anchored
    message: str
    relpath: str = ""  # stable path used in the baseline key

    def key(self) -> str:
        return f"{self.checker}|{self.relpath or self.path}|{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


@dataclass
class Module:
    """One parsed source file."""

    path: str
    relpath: str
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.lines:
            self.lines = self.source.splitlines()
        self._nodes: Optional[List[ast.AST]] = None

    @property
    def modname(self) -> str:
        # "engine/devicestate.py" -> "engine.devicestate"
        rel = self.relpath[:-3] if self.relpath.endswith(".py") else self.relpath
        return rel.replace(os.sep, ".").replace("/", ".")

    def walk(self) -> List[ast.AST]:
        """Every node of the tree, computed once. Eight checkers walk the
        same 90-odd files; materializing the node list once per file keeps
        a full-package run comfortably inside its latency budget."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes


# (path, mtime_ns, size) -> Module — parses survive across run_checks
# calls in one process (the test tier drives the pipeline dozens of
# times; the CLI benefits when checkers re-load scoped subsets)
_PARSE_CACHE: Dict[Tuple[str, int, int], Module] = {}


def load_module(path: str, relpath: Optional[str] = None) -> Optional[Module]:
    try:
        st = os.stat(path)
        cache_key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
        cached = _PARSE_CACHE.get(cache_key)
        if cached is not None and cached.relpath == (relpath or path):
            return cached
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError):
        return None
    mod = Module(path=path, relpath=relpath or path, source=source, tree=tree)
    if len(_PARSE_CACHE) > 4096:  # a bound, not an eviction policy
        _PARSE_CACHE.clear()
    _PARSE_CACHE[cache_key] = mod
    return mod


def load_package(root: str, subdirs: Optional[Sequence[str]] = None) -> List[Module]:
    """Parse every ``.py`` under ``root`` (optionally restricted to the
    given first-level subdirs), relpaths relative to ``root``."""
    mods: List[Module] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        rel_dir = os.path.relpath(dirpath, root)
        if subdirs is not None:
            top = "" if rel_dir == "." else rel_dir.split(os.sep)[0]
            if rel_dir != "." and top not in subdirs:
                continue
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            m = load_module(path, rel)
            if m is not None:
                mods.append(m)
    return mods


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on parsed trees
        return "<expr>"


def literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def class_qualname(module: Module, cls: ast.ClassDef) -> str:
    return f"{module.modname}.{cls.name}"


def iter_classes(module: Module) -> Iterable[ast.ClassDef]:
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef):
            yield node


def iter_methods(cls: ast.ClassDef) -> Iterable[ast.FunctionDef]:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ---------------------------------------------------------------- baseline


def load_baseline(path: str) -> Dict[str, str]:
    """``key  # justification`` lines -> {key: justification}. Blank lines
    and full-line comments are skipped."""
    out: Dict[str, str] = {}
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            if "  #" in line:
                key, _, just = line.partition("  #")
                out[key.strip()] = just.strip()
            else:
                out[line.strip()] = ""
    return out


def apply_baseline(
    findings: Sequence[Finding], baseline: Dict[str, str]
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """(new, waived, stale-keys). A baseline entry matches at most the
    findings sharing its key; stale keys are entries matching nothing —
    reported so fixed violations get their waivers deleted."""
    new: List[Finding] = []
    waived: List[Finding] = []
    seen_keys = set()
    for f in findings:
        k = f.key()
        seen_keys.add(k)
        (waived if k in baseline else new).append(f)
    stale = [k for k in baseline if k not in seen_keys]
    return new, waived, stale


# ------------------------------------------------------------- allow files


def load_pair_allowlist(path: Optional[str]) -> Dict[Tuple[str, str], str]:
    """``nodeA -> nodeB  # why`` lines -> {(a, b): justification}. The
    shared format of lockorder_allow.txt and blocking_allow.txt."""
    out: Dict[Tuple[str, str], str] = {}
    if not path or not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            body, _, comment = raw.partition("#")
            body = body.strip()
            if not body or "->" not in body:
                continue
            a, _, b = body.partition("->")
            out[(a.strip(), b.strip())] = comment.strip()
    return out


def prune_file_lines(path: str, is_stale) -> int:
    """Rewrite ``path`` dropping every non-comment line for which
    ``is_stale(stripped_body)`` is true (comment/blank lines survive).
    Returns the number of lines removed — the ``--prune-stale`` autofix."""
    if not os.path.exists(path):
        return 0
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    kept: List[str] = []
    dropped = 0
    for raw in lines:
        body = raw.split("#", 1)[0].strip() if not raw.lstrip().startswith("#") else ""
        if body and is_stale(body):
            dropped += 1
            continue
        kept.append(raw)
    if dropped:
        with open(path, "w", encoding="utf-8") as f:
            f.writelines(kept)
    return dropped
