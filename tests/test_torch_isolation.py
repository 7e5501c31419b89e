"""The port stands alone: no module of ``kube_throttler_tpu_torch``, not
``chip_smoke.py`` and not the ``tools/*_torch.py`` harnesses imports
``jax``, ``jaxlib`` or ``kube_throttler_tpu`` — at module level or inside
a function — or names a ``kube_throttler_tpu.`` module in a string of its
code (an argv such as ``-m kube_throttler_tpu.sharding.worker`` would run
the JAX package in a child process); and the port's entry points refuse
to run without CUDA unless the caller asks for the CPU."""

import ast
import re
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kube_throttler_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "kube_throttler_tpu")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "victim_timing.py",
                                          REPO / "gather_timing.py"]
    # the chaos harnesses' copies that drive the port
    files += sorted((REPO / "tools").glob("*_torch.py"))
    assert len(files) > 40 and all(f.exists() for f in files)
    return files


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, (ast.Name, ast.Attribute))
            and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__",
            )
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.args[0].value.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    bad = [(root, line) for root, line in _imported_roots(tree) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                yield body[0].value


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_module_named_in_a_code_string(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    docs = {id(node) for node in _docstrings(tree)}
    bad = [
        (node.lineno, node.value) for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and id(node) not in docs and re.search(r"\bkube_throttler_tpu\.", node.value)
    ]
    assert not bad, f"{path.relative_to(REPO)} names the JAX package in {bad}"


def test_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from kube_throttler_tpu_torch import resolve_device
    from kube_throttler_tpu_torch.engine.devicestate import DeviceStateManager
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args
    from kube_throttler_tpu_torch.sharding.worker import ShardCore
    from kube_throttler_tpu_torch.sharding.worker import main as worker_main

    args = decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "s"})
    with pytest.raises(RuntimeError, match="CUDA"):
        KubeThrottler(args, Store())
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceStateManager(Store(), "kube-throttler", "s")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardCore(0, 1)
    # the worker process's entry point exits before it reads its socket
    assert worker_main(["--shard-id", "0", "--shards", "1", "--ipc-fd", "-1"]) == 1
    assert KubeThrottler(args, Store(), device="cpu").device_manager.device == torch.device("cpu")
