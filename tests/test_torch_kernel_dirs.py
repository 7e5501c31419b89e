"""Where the port's kernel libraries live (``kernels.py``), on the CPU.

An installed copy of the package (``site/kube_throttler_tpu_torch`` with no
``pyproject.toml`` beside it) builds into the per-user cache
``$XDG_CACHE_HOME/kube-throttler-gpu/kernels`` (``~/.cache`` without the
variable) and writes nothing inside its own tree; a source checkout builds
into its ``build/kernels/``; a library prebuilt into the package's
``_kernels/`` under the current digest is used without a build, one under
another digest never. ``serve`` reports a kernel folder it cannot make and
exits 1. Each installed copy runs in a child interpreter with only its
``site`` on ``PYTHONPATH``; ``nvcc`` is a script that writes its ``-o`` file.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from kube_throttler_tpu_torch import kernels

REPO = Path(__file__).resolve().parent.parent
PKG = "kube_throttler_tpu_torch"
NAMES = ["check_dense", "check_gather", "victim_select"]


def _install(tmp_path: Path) -> Path:
    """The package copied into ``tmp_path/site`` as a wheel installs it."""
    site = tmp_path / "site"
    shutil.copytree(REPO / PKG, site / PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so", "_kernels"))
    return site


def _fake_cuda(tmp_path: Path, fail: bool = False) -> Path:
    """A ``CUDA_HOME`` whose ``bin/nvcc`` appends its argv to ``calls.log``
    and writes its ``-o`` file (or fails)."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        with open({str(home / "calls.log")!r}, "a") as f:
            f.write(" ".join(sys.argv[1:]) + "\\n")
        if {fail!r}:
            sys.exit(3)
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "wb").write(b"fake library")
        """))
    nvcc.chmod(0o755)
    return home


def _child(tmp_path: Path, site: Path, code: str, XDG_CACHE_HOME, **env_over):
    """``python -c code`` with ``site`` alone on the path; an
    ``XDG_CACHE_HOME`` of None unsets it."""
    env = {**os.environ, "PYTHONPATH": str(site), "HOME": str(tmp_path / "home"),
           "XDG_CACHE_HOME": XDG_CACHE_HOME, **env_over}
    env = {k: v for k, v in env.items() if v is not None}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)


def _listing(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*")
            if "__pycache__" not in p.parts}


RESOLVE = f"""
    import json, {PKG} as p, {PKG}.kernels as k
    print(json.dumps({{"package": p.__file__, "build_dir": str(k.build_dir()),
                       "paths": {{n: str(k.library_path(n)) for n in k.names()}}}}))
"""


def test_an_installed_copy_resolves_to_the_user_cache(tmp_path):
    site = _install(tmp_path)
    proc = _child(tmp_path, site, RESOLVE, XDG_CACHE_HOME=str(tmp_path / "xdg"))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert Path(got["package"]).is_relative_to(site)
    cache = tmp_path / "xdg" / "kube-throttler-gpu" / "kernels"
    assert Path(got["build_dir"]) == cache
    assert {n: Path(p).parent for n, p in got["paths"].items()} == dict.fromkeys(NAMES, cache)


def test_without_xdg_cache_home_it_falls_back_to_dot_cache(tmp_path):
    site = _install(tmp_path)
    proc = _child(tmp_path, site, RESOLVE, XDG_CACHE_HOME=None)
    assert proc.returncode == 0, proc.stderr
    assert Path(json.loads(proc.stdout)["build_dir"]) == (
        tmp_path / "home" / ".cache" / "kube-throttler-gpu" / "kernels")


def test_a_checkout_still_builds_into_build_kernels():
    assert (REPO / "pyproject.toml").is_file()
    assert kernels.build_dir() == REPO / "build" / "kernels"
    for name in NAMES:
        path = kernels.library_path(name)
        assert path.name == kernels.library_name(name)
        if not (kernels.PREBUILT_DIR / path.name).is_file():
            assert path.parent == REPO / "build" / "kernels"


def test_build_all_from_an_install_writes_only_into_the_cache(tmp_path):
    site = _install(tmp_path)
    before = _listing(site)
    cuda = _fake_cuda(tmp_path)
    proc = _child(tmp_path, site, f"""
        import json, {PKG}.kernels as k
        print(json.dumps([str(p) for p in k.build_all()]))
    """, XDG_CACHE_HOME=str(tmp_path / "xdg"), CUDA_HOME=str(cuda))
    assert proc.returncode == 0, proc.stderr
    cache = tmp_path / "xdg" / "kube-throttler-gpu" / "kernels"
    built = [Path(p) for p in json.loads(proc.stdout)]
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        kernels.library_name(n) for n in NAMES)
    assert sorted(built) == sorted(cache.iterdir())
    assert cache.stat().st_mode & 0o777 == 0o700
    assert len((cuda / "calls.log").read_text().splitlines()) == 3
    assert _listing(site) == before
    assert not (tmp_path / "build").exists()


def test_a_prebuilt_library_is_loaded_without_a_build(tmp_path):
    site = _install(tmp_path)
    prebuilt = site / PKG / "_kernels"
    prebuilt.mkdir()
    (prebuilt / kernels.library_name("check_dense")).write_bytes(b"prebuilt")
    cuda = _fake_cuda(tmp_path, fail=True)
    proc = _child(tmp_path, site, f"""
        import ctypes, json, {PKG}.kernels as k
        opened = []
        ctypes.CDLL = lambda path: opened.append(path) or ("lib", path)
        k.load("check_dense")
        print(json.dumps({{"opened": opened, "path": str(k.library_path("check_dense"))}}))
    """, XDG_CACHE_HOME=str(tmp_path / "xdg"), CUDA_HOME=str(cuda))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    want = str(prebuilt / kernels.library_name("check_dense"))
    assert got == {"opened": [want], "path": want}
    assert not (cuda / "calls.log").exists(), "nvcc ran beside a prebuilt library"
    assert not (tmp_path / "xdg").exists()


def test_a_prebuilt_library_of_another_digest_is_ignored(tmp_path):
    site = _install(tmp_path)
    prebuilt = site / PKG / "_kernels"
    prebuilt.mkdir()
    stale = prebuilt / "check_dense-0123456789abcdef.so"
    stale.write_bytes(b"stale")
    cuda = _fake_cuda(tmp_path)
    proc = _child(tmp_path, site, f"""
        import ctypes, json, {PKG}.kernels as k
        opened = []
        ctypes.CDLL = lambda path: opened.append(path) or ("lib", path)
        k.load("check_dense")
        print(json.dumps(opened))
    """, XDG_CACHE_HOME=str(tmp_path / "xdg"), CUDA_HOME=str(cuda))
    assert proc.returncode == 0, proc.stderr
    cache = tmp_path / "xdg" / "kube-throttler-gpu" / "kernels"
    assert json.loads(proc.stdout) == [str(cache / kernels.library_name("check_dense"))]
    assert len((cuda / "calls.log").read_text().splitlines()) == 1
    assert stale.read_bytes() == b"stale"


def test_prebuild_fills_the_package_folder(tmp_path):
    site = _install(tmp_path)
    cuda = _fake_cuda(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "XDG_CACHE_HOME"}
    env.update(PYTHONPATH=str(site), HOME=str(tmp_path / "home"), CUDA_HOME=str(cuda))
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.kernels", "--prebuild"],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    prebuilt = site / PKG / "_kernels"
    want = sorted(kernels.library_name(n) for n in NAMES)
    assert sorted(Path(p).name for p in proc.stdout.split()) == want
    assert sorted(p.name for p in prebuilt.iterdir()) == want
    assert prebuilt.stat().st_mode & 0o777 == 0o755
    assert all(p.stat().st_mode & 0o777 == 0o644 for p in prebuilt.iterdir())
    assert not (tmp_path / "home" / ".cache").exists()


@pytest.mark.parametrize("shards", [[], ["--shards", "2"]], ids=["single", "sharded"])
def test_serve_reports_a_kernel_folder_it_cannot_make(tmp_path, shards):
    """The folder's path is taken by a file (a ``chmod`` would stop no write
    when the tests run as root): ``serve`` on a (stubbed) card says so on
    stderr and exits 1, with no traceback and no worker spawned."""
    site = _install(tmp_path)
    xdg = tmp_path / "xdg"
    (xdg / "kube-throttler-gpu").mkdir(parents=True)
    (xdg / "kube-throttler-gpu" / "kernels").write_text("not a folder")
    cuda = _fake_cuda(tmp_path)
    argv = ["serve", "--name", "kube-throttler", "--target-scheduler-name", "s",
            "--port", "0", *shards]
    proc = _child(tmp_path, site, f"""
        import sys, torch
        torch.cuda.is_available = lambda: True  # a card, as far as serve can tell
        from {PKG} import cli
        sys.exit(cli.main({argv!r}))
    """, XDG_CACHE_HOME=str(xdg), CUDA_HOME=str(cuda))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "kernel build failed" in proc.stderr
    assert str(xdg / "kube-throttler-gpu" / "kernels") in proc.stderr
    assert "Traceback" not in proc.stderr
    assert "spawning" not in proc.stdout
    assert not (cuda / "calls.log").exists()


@pytest.mark.parametrize("failure", ["folder", "nvcc"])
def test_a_listen_worker_reports_a_kernel_build_it_cannot_make(tmp_path, failure):
    """A TCP shard worker (``sharding.worker --listen``) on a (stubbed)
    card builds its kernels before its engine: a kernel folder it cannot
    make (an ``OSError``) or a failed ``nvcc`` (a ``RuntimeError``) is
    reported as ``serve`` reports it, exit 1 and no traceback."""
    site = _install(tmp_path)
    xdg = tmp_path / "xdg"
    if failure == "folder":
        (xdg / "kube-throttler-gpu").mkdir(parents=True)
        (xdg / "kube-throttler-gpu" / "kernels").write_text("not a folder")
    cuda = _fake_cuda(tmp_path, fail=failure == "nvcc")
    argv = ["--shard-id", "0", "--shards", "1", "--listen", "127.0.0.1:0"]
    proc = _child(tmp_path, site, f"""
        import sys, torch
        torch.cuda.is_available = lambda: True  # a card, as far as the worker can tell
        from {PKG}.sharding import worker
        sys.exit(worker.main({argv!r}))
    """, XDG_CACHE_HOME=str(xdg), CUDA_HOME=str(cuda))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "shard 0: kernel build failed: " in proc.stderr
    assert "Traceback" not in proc.stderr
    assert (cuda / "calls.log").exists() == (failure == "nvcc")
