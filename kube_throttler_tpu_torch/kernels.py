"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under the
repository's ``build/kernels/``, named by a hash of the source so an edit
rebuilds and a stale binary is never loaded. The library is opened with
``ctypes``. Nothing is built at import: the first call to :func:`load`
builds (a few seconds per file), later calls return the loaded library.

A missing ``nvcc`` or a failed build raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# ``_lock`` guards the two dicts only; a build runs under its own name's
# lock, so one kernel's ``nvcc`` never stalls the load of another
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_name_locks: Dict[str, threading.Lock] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the one
    on ``PATH``; raises when there is none."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists. The
    output is written to a temporary name and renamed into place, so a
    concurrent loader never opens a half-written file. Returns the path."""
    target = library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, target)
        tmp = None
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
    return target


def build_all() -> None:
    """Compile every ``csrc/*.cu`` at once, one ``nvcc`` each, without
    loading any (so no CUDA context is created): a process that spawns
    workers builds here first, and the workers' loads find the libraries
    built. Raises when any build fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        for fut in [pool.submit(build, name) for name in names]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed. Idempotent and thread-safe: concurrent loads of one name build
    once, and loads of different names build concurrently."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        with _lock:
            lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            with _lock:
                _libs[name] = lib
        return lib
