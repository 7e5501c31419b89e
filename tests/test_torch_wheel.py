"""The port's wheel, built from a copy of the tree on the CPU, holds every
file that the chip smoke's ``[deployed]`` phase copies into its install
tree (``chip_smoke.package_files``): the install it rehearses is the
wheel's. No top-level ``build/`` goes into the wheel, and no kernel
library: those are built where the package runs, or prebuilt into an
image."""

import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = "kube_throttler_tpu_torch"


def test_the_wheel_holds_what_the_deployed_phase_installs(tmp_path, monkeypatch):
    pytest.importorskip("setuptools")
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(REPO / name, src / name)
    files = chip_smoke.package_files(REPO / PKG)
    for rel in files:
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(REPO / rel, src / rel)
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "--disable-pip-version-check", "-w", str(tmp_path / "dist"), str(src)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    assert set(files) <= names
    assert {n for n in names if n.startswith(f"{PKG}/")} == set(files)
    assert not any(n.startswith("build/") for n in names)
    assert not any(n.endswith(".so") for n in names)
    assert f"{PKG}/csrc/check_dense.cu" in files and f"{PKG}/kernels.py" in files
