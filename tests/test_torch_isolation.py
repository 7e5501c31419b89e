"""The port stands alone: no module of ``kube_throttler_tpu_torch``, not
``chip_smoke.py``, not the ``tools/*_torch.py`` harnesses and not the
``tests/torch_*.py`` helpers imports
``jax``, ``jaxlib`` or ``kube_throttler_tpu`` — at module level or inside
a function — or names a ``kube_throttler_tpu.`` module in a string of its
code (an argv such as ``-m kube_throttler_tpu.sharding.worker`` would run
the JAX package in a child process), or loads one of the JAX package's
chaos harnesses in place of its ``tools/*_torch.py`` twin; and the port's
entry points refuse to run without CUDA unless the caller asks for the
CPU."""

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
    # the test helpers the smoke imports on the card, and the tests' others
    files += sorted((REPO / "tests").glob("torch_*.py"))
    # the port's examples
    files += sorted((REPO / "examples").glob("*_torch.py"))
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


# the JAX package's chaos harnesses that have a port twin (tools/<name>.py
# beside tools/<name>_torch.py): the twin is the one a port module may load
REFERENCE_TOOLS = sorted(
    p.stem for p in (REPO / "tools").glob("*.py")
    if (REPO / "tools" / f"{p.stem}_torch.py").exists()
)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_harness_loaded(path):
    """``tools/harness.py`` and its kind import the JAX package inside their
    functions, so a port module that imports one (or loads it by file
    name) would run JAX on a path that the import check above cannot see."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    docs = {id(node) for node in _docstrings(tree)}
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names
                    if a.name.split(".")[:2] in (["tools", t] for t in REFERENCE_TOOLS)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module == "tools":
            bad += [(node.lineno, a.name) for a in node.names if a.name in REFERENCE_TOOLS]
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs
              and node.value.removesuffix(".py") in REFERENCE_TOOLS
              and node.value.endswith(".py")):
            bad.append((node.lineno, node.value))
    assert REFERENCE_TOOLS and not bad, f"{path.relative_to(REPO)} loads {bad}"


def _deploy_texts():
    """The port's deployment files, and the Makefile's GPU targets."""
    texts = [(str(p.relative_to(REPO)), p.read_text(encoding="utf-8"))
             for p in sorted((REPO / "deploy" / "gpu").glob("*.yaml"))]
    texts.append(("Dockerfile.gpu", (REPO / "Dockerfile.gpu").read_text(encoding="utf-8")))
    make = (REPO / "Makefile").read_text(encoding="utf-8")
    for target in ("image-gpu", "serve-gpu", "walkthrough-gpu"):
        m = re.search(rf"^{target}:.*\n((?:\t.*\n)+)", make, re.M)
        assert m, target
        texts.append((f"Makefile:{target}", m.group(0)))
    assert len(texts) >= 6
    return texts


@pytest.mark.parametrize("where, text", _deploy_texts(), ids=[w for w, _ in _deploy_texts()])
def test_deploy_files_name_no_module_of_the_jax_package(where, text):
    """An image, a manifest's command or a make target that named the JAX
    package would run it in place of the port."""
    bad = re.findall(r"\bkube_throttler_tpu\b[\w.]*", text)
    assert not bad, f"{where} names {bad}"


def test_entry_points_refuse_cpu_unless_asked(tmp_path):
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

    # the scenario runners and their CLIs refuse before they build a stack:
    # no trace, report or worker appears
    from kube_throttler_tpu_torch.scenarios import get_scenario
    from kube_throttler_tpu_torch.scenarios.__main__ import main as scenarios_main
    from kube_throttler_tpu_torch.scenarios.engine import run_scenario
    from kube_throttler_tpu_torch.scenarios.hunt.__main__ import main as hunt_main
    from kube_throttler_tpu_torch.scenarios.preemption import main as preemption_main
    from kube_throttler_tpu_torch.scenarios.preemption import _oracle_sweep, run_preemption_storm
    from kube_throttler_tpu_torch.scenarios.sharded import run_sharded_bad_day

    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(get_scenario("smoke"), 0, str(tmp_path / "engine"), device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_preemption_storm(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        _oracle_sweep(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sharded_bad_day(n_shards=2, seed=0)
    cli_wd = tmp_path / "cli"
    assert scenarios_main(["run", "--name", "smoke", "--workdir", str(cli_wd)]) == 1
    assert preemption_main([]) == 1
    assert hunt_main(["smoke", "--workdir", str(tmp_path / "hunt"), "--no-promote"]) == 1
    assert not (tmp_path / "engine").exists() and not cli_wd.exists()
    assert not (tmp_path / "hunt").exists()
