"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program either.

Top-level module names are compared whole (the part before the first
dot): the program's package name begins with the JAX package's, so a
prefix test would be wrong both ways."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench.tests.tiny import ROOT

PKG = ROOT / "gpubench"
JAX_SIDE = {"jax", "jaxlib", "flax", "kube_throttler_tpu"}
PROGRAM = "kube_throttler_tpu_torch"


def harness_files():
    return sorted(p for p in PKG.rglob("*.py") if "tests" not in p.relative_to(PKG).parts)


def imports_of(path: Path) -> set:
    """Absolute module names ``path`` imports, relative ones resolved."""
    pkg_parts = list(path.relative_to(ROOT).with_suffix("").parts[:-1])
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            names.add(mod)
            names |= {f"{mod}.{a.name}" for a in node.names}
    return names


def top(name: str) -> str:
    return name.partition(".")[0]


def test_top_level_names_compare_whole():
    assert top("kube_throttler_tpu_torch.plugin") != "kube_throttler_tpu"
    assert top("kube_throttler_tpu.plugin") == "kube_throttler_tpu"


@pytest.mark.parametrize("path", harness_files(), ids=lambda p: str(p.relative_to(PKG)))
def test_harness_imports_no_jax_side(path):
    bad = {n for n in imports_of(path) if top(n) in JAX_SIDE}
    assert not bad, f"{path} imports {bad}"


def _closure(start: Path) -> set:
    """Files of gpubench that ``start`` reaches through its imports."""
    seen, todo = set(), [start]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for name in imports_of(p):
            if top(name) != "gpubench":
                continue
            parts = name.split(".")
            for k in range(len(parts), 0, -1):
                cand = ROOT.joinpath(*parts[:k])
                for f in (cand.with_suffix(".py"), cand / "__init__.py"):
                    if f.exists():
                        todo.append(f)
    return seen


def test_reference_imports_nothing_of_the_program():
    files = set()
    for p in (PKG / "reference").glob("*.py"):
        files |= _closure(p)
    assert all((PKG / "reference") in f.parents for f in files), files
    for f in files:
        bad = {n for n in imports_of(f) if top(n) in JAX_SIDE | {PROGRAM}}
        assert not bad, f"{f} imports {bad}"


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import gpubench.reference.semantics, gpubench.reference.quantity")
    assert not mods & (JAX_SIDE | {PROGRAM})


def test_a_whole_run_loads_no_jax_side():
    mods = _modules_after(
        "from gpubench.tests.tiny import run_tiny\n"
        "for c in ('throttles-100k.triage', 'selector-terms.triage'):\n"
        "    assert run_tiny(c)['correct']"
    )
    assert PROGRAM in mods
    assert not mods & JAX_SIDE, mods & JAX_SIDE


def test_test_files_do_not_shadow_the_repos_tests():
    ours = {p.name for p in (PKG / "tests").glob("test_*.py")}
    theirs = {p.name for p in (ROOT / "tests").rglob("*.py")}
    assert ours and not ours & theirs
