"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library named by a digest
of the source and the flags, so an edit rebuilds and a stale binary is
never loaded. The library is opened with ``ctypes``. Nothing is built at
import: the first call to :func:`load` builds (a few seconds per file),
later calls return the loaded library.

Where the libraries live (:func:`library_path`), in this order:

1. the prebuilt folder inside the package, ``_kernels/``, read-only at run
   time; it is filled by ``python -m kube_throttler_tpu_torch.kernels
   --prebuild`` (a container image runs it at build time, so its runtime
   needs no CUDA toolkit). A library there is used only under the digest
   computed now;
2. otherwise :func:`build_dir`: ``build/kernels/`` of a source checkout
   (the package's parent holds ``pyproject.toml``), else the per-user
   cache ``$XDG_CACHE_HOME/kube-throttler-gpu/kernels`` (default
   ``~/.cache``, mode 0700). Nothing is written inside an installed tree
   but by ``--prebuild``.

A missing ``nvcc``, a failed build or a folder that cannot be written
raises — there is no fallback.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
PREBUILT_DIR = PKG_DIR / "_kernels"

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


def names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_name(name: str) -> str:
    """``<name>-<digest>.so``: the digest covers the source and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return f"{name}-{digest}.so"


def build_dir() -> Path:
    """Where a library missing from ``_kernels/`` is built: ``build/kernels/``
    of a source checkout, else the per-user cache."""
    if (PKG_DIR.parent / "pyproject.toml").is_file():
        return PKG_DIR.parent / "build" / "kernels"
    base = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(base) / "kube-throttler-gpu" / "kernels"


def library_path(name: str) -> Path:
    """The prebuilt library of the current digest when there is one, else
    its place under :func:`build_dir`."""
    prebuilt = PREBUILT_DIR / library_name(name)
    if prebuilt.is_file():
        return prebuilt
    return build_dir() / library_name(name)


def build(name: str, out_dir: Optional[Path] = None) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists (at
    :func:`library_path`, or in ``out_dir`` when given). The output is
    written to a temporary name and renamed into place, so a concurrent
    loader never opens a half-written file. Returns the path."""
    target = library_path(name) if out_dir is None else Path(out_dir) / library_name(name)
    if target.exists():
        return target
    # the prebuilt folder is read by every user of a shared install; a
    # per-user cache by its owner alone
    prebuilt = target.parent == PREBUILT_DIR
    target.parent.mkdir(mode=0o755 if prebuilt else 0o700, parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(target.parent))
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        if prebuilt:
            os.chmod(tmp, 0o644)
        os.replace(tmp, target)
        tmp = None
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
    return target


def build_all(out_dir: Optional[Path] = None) -> List[Path]:
    """Compile every ``csrc/*.cu`` at once, one ``nvcc`` each, without
    loading any (so no CUDA context is created): a process that spawns
    workers builds here first, and the workers' loads find the libraries
    built. Raises when any build fails."""
    todo = names()
    with ThreadPoolExecutor(len(todo)) as pool:
        return [f.result() for f in [pool.submit(build, n, out_dir) for n in todo]]


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


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m kube_throttler_tpu_torch.kernels")
    parser.add_argument(
        "--prebuild", action="store_true",
        help="compile every csrc/*.cu into the package's _kernels/ (for an "
        "image whose runtime has no CUDA toolkit)",
    )
    args = parser.parse_args(argv)
    if not args.prebuild:
        parser.error("nothing to do: pass --prebuild")
    try:
        paths = build_all(PREBUILT_DIR)
    except (RuntimeError, OSError) as e:
        print(f"kernel build failed: {e}", file=sys.stderr, flush=True)
        return 1
    for path in paths:
        print(path, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
