"""ctypes bindings for the native selector row-match engine.

The shared library is built from ``ktnative.cpp`` in this package
(``make native``), which ships with the wheel so installed copies
auto-build too.
If it is absent, the loader builds it on first import with ``g++`` — a
single-file, sub-second compile — and falls back to pure Python when no
toolchain is available, so the package never hard-depends on the binary.

Build destination: the package directory when writable (dev checkouts);
otherwise a per-user cache dir (``$XDG_CACHE_HOME/kube-throttler-tpu``,
mode 0700) keyed by the source hash — a read-only site-packages install
builds ONCE per user instead of failing the in-package write and
re-attempting g++ in every process.

Set ``KT_TPU_NO_NATIVE=1`` to force the Python tier (used by parity tests).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent
_SRC = _PKG_DIR / "ktnative.cpp"
_SO = _PKG_DIR / "_ktnative.so"

_lib: Optional[ctypes.CDLL] = None
from ..utils.lockorder import make_lock as _make_lock

_load_lock = _make_lock("native.load")
_load_attempted = False

_i32p = ctypes.POINTER(ctypes.c_int32)


logger = logging.getLogger(__name__)

CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def _user_cache_so() -> Optional[Path]:
    """Per-user build destination for read-only installs, keyed by source
    hash so a package upgrade invalidates stale binaries automatically."""
    import hashlib

    try:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        base = Path(
            os.environ.get("XDG_CACHE_HOME") or (Path.home() / ".cache")
        )
        cache_dir = base / "kube-throttler-tpu"
        cache_dir.mkdir(mode=0o700, parents=True, exist_ok=True)
        return cache_dir / f"_ktnative-{digest}.so"
    except OSError:
        return None


def _build(target: Path) -> bool:
    """Compile to a temp file and atomically rename, so concurrent importers
    never dlopen a partially written library."""
    if not _SRC.exists():
        return False
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(target.parent))
        os.close(fd)
        subprocess.run(
            ["g++", *CXX_FLAGS, str(_SRC), "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        # in-package builds stay world-readable (shared installs); the
        # per-user cache keeps mkstemp's 0600
        if target.parent == _PKG_DIR:
            os.chmod(tmp, 0o644)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        logger.warning(
            "native selector engine build failed (%s); falling back to the "
            "pure-Python row-match tier",
            exc,
        )
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return False


def _declare(lib: ctypes.CDLL) -> None:
    lib.ktn_create.argtypes = [ctypes.c_int32]
    lib.ktn_create.restype = ctypes.c_void_p
    lib.ktn_destroy.argtypes = [ctypes.c_void_p]
    lib.ktn_destroy.restype = None
    lib.ktn_reserve.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ktn_reserve.restype = None
    lib.ktn_set_col.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _i32p, _i32p, _i32p,  # pod side (nested CSR)
        _i32p, _i32p, _i32p, _i32p, _i32p,  # ns side
    ]
    lib.ktn_set_col.restype = None
    lib.ktn_set_col_general.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.ktn_set_col_general.restype = None
    lib.ktn_clear_col.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ktn_clear_col.restype = None
    lib.ktn_num_cols.argtypes = [ctypes.c_void_p]
    lib.ktn_num_cols.restype = ctypes.c_int32
    # raw-pointer-int args (c_void_p) on the hot row-match: each data_as
    # POINTER conversion costs ~2µs and the call makes six — at 2 kinds ×
    # 100k pod events that marshaling alone was seconds of cold start
    lib.ktn_match_row.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ktn_match_row.restype = None
    # single-pod classifier: planes registered once per staging allocation
    # (ktn_cls_create), per-call args are raw pointer ints (c_void_p) so the
    # hot call marshals 8 scalars instead of 22 numpy data_as conversions
    lib.ktn_cls_create.argtypes = [ctypes.c_int32] + [ctypes.c_void_p] * 16
    lib.ktn_cls_create.restype = ctypes.c_void_p
    lib.ktn_cls_destroy.argtypes = [ctypes.c_void_p]
    lib.ktn_cls_destroy.restype = None
    lib.ktn_cls_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.ktn_cls_run.restype = None


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _load_attempted
    if os.environ.get("KT_TPU_NO_NATIVE") == "1":
        return None
    with _load_lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        so = _SO
        fresh = so.exists() and not (
            _SRC.exists() and so.stat().st_mtime < _SRC.stat().st_mtime
        )
        if not fresh:
            if os.access(_PKG_DIR, os.W_OK):
                if not _build(_SO):
                    return None
            else:
                # read-only install: build (once) into the per-user cache
                cached = _user_cache_so()
                if cached is None:
                    return None
                if not cached.exists() and not _build(cached):
                    return None
                so = cached
        try:
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _lib = lib
        except (OSError, AttributeError) as exc:
            # AttributeError: a prebuilt .so predating a symbol added to
            # _declare (archive extraction can set mtimes that defeat the
            # source-mtime freshness check) — degrade to the Python tier
            # like any other load failure instead of crashing the caller
            logger.warning(
                "native selector engine load failed (%s); falling back to the "
                "pure-Python row-match tier",
                exc,
            )
            _lib = None
        return _lib


def available() -> bool:
    return load() is not None


def _as_i32(seq: Sequence[int]) -> np.ndarray:
    return np.asarray(seq, dtype=np.int32)


def _ptr(arr: np.ndarray) -> _i32p:
    return arr.ctypes.data_as(_i32p)


class NativeRowEngine:
    """One engine per SelectorIndex — wraps the C row-match kernel.

    All interning happens in the caller; this class only marshals int32
    arrays across the ctypes boundary.  Thread safety is the caller's
    (SelectorIndex holds its RLock around every call).
    """

    def __init__(self, kind: str):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.ktn_create(1 if kind == "clusterthrottle" else 0))
        # ktn_num_cols cached per column-set mutation (set_col can extend):
        # the hot match_row otherwise pays an extra ctypes call per row
        self._n_cols: Optional[int] = None
        # (out, general) uint8 scratch for match_row — see its docstring
        self._match_scratch: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        h = getattr(self, "_h", None)
        if h:
            try:
                self._lib.ktn_destroy(h)
            except Exception:
                pass
            self._h = None

    def reserve(self, tcap: int) -> None:
        self._lib.ktn_reserve(self._h, tcap)
        self._n_cols = None

    # operator codes — shared contract with the Op enum in ktnative.cpp
    OP_EQ = 0
    OP_IN = 1
    OP_NOT_IN = 2
    OP_EXISTS = 3
    OP_DOES_NOT_EXIST = 4

    @staticmethod
    def _flatten_side(terms_side) -> Tuple[np.ndarray, ...]:
        """Nested CSR for one selector side: terms_side is a list (per
        term) of requirement lists [(key_id, op, (value_ids...))]."""
        term_off = [0]
        keys: List[int] = []
        ops: List[int] = []
        voff = [0]
        vals: List[int] = []
        for reqs in terms_side:
            for key, op, values in reqs:
                keys.append(key)
                ops.append(op)
                vals.extend(values)
                voff.append(len(vals))
            term_off.append(len(keys))
        return (
            _as_i32(term_off), _as_i32(keys), _as_i32(ops),
            _as_i32(voff), _as_i32(vals),
        )

    def set_col(
        self,
        col: int,
        thr_ns: int,
        terms: Sequence[Tuple[Sequence[Tuple[int, int, Sequence[int]]],
                              Sequence[Tuple[int, int, Sequence[int]]]]],
    ) -> None:
        """terms: [(pod_reqs, ns_reqs)] with reqs as
        (key_id, op, value_ids) — op per the OP_* codes (matchLabels
        entries are OP_EQ with one value)."""
        pod_arrays = self._flatten_side([t[0] for t in terms])
        ns_arrays = self._flatten_side([t[1] for t in terms])
        self._lib.ktn_set_col(
            self._h, col, thr_ns, len(terms),
            *(_ptr(a) for a in pod_arrays),
            *(_ptr(a) for a in ns_arrays),
        )
        self._n_cols = None

    def set_col_general(self, col: int, thr_ns: int) -> None:
        self._lib.ktn_set_col_general(self._h, col, thr_ns)
        self._n_cols = None

    def clear_col(self, col: int) -> None:
        self._lib.ktn_clear_col(self._h, col)
        self._n_cols = None

    def match_row(
        self,
        pod_ns: int,
        ns_exists: bool,
        pod_labels: Dict[int, int],
        ns_labels: Dict[int, int],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (match, needs_general) as uint8 arrays of length num_cols.

        The returned arrays are per-engine SCRATCH, valid only until the
        next match_row call — the caller contract (SelectorIndex holds its
        RLock around every call AND copies what it keeps —
        engine/index.py _match_row_arbitrary) makes reuse safe and saves
        two allocations on the hot pod-event path. Pointer args pass as
        raw ints (see _declare)."""
        n_cols = self._n_cols
        if n_cols is None:
            n_cols = self._n_cols = self._lib.ktn_num_cols(self._h)
        sc = self._match_scratch
        if sc is None or sc[0].shape[0] < n_cols:
            # np.empty: ktn_match_row memsets both buffers itself
            sc = (np.empty(n_cols, dtype=np.uint8), np.empty(n_cols, dtype=np.uint8))
            self._match_scratch = sc
        out, general = sc[0][:n_cols], sc[1][:n_cols]
        pk = np.fromiter(pod_labels.keys(), dtype=np.int32, count=len(pod_labels))
        pv = np.fromiter(pod_labels.values(), dtype=np.int32, count=len(pod_labels))
        nk = np.fromiter(ns_labels.keys(), dtype=np.int32, count=len(ns_labels))
        nv = np.fromiter(ns_labels.values(), dtype=np.int32, count=len(ns_labels))
        self._lib.ktn_match_row(
            self._h, pod_ns, 1 if ns_exists else 0,
            pk.ctypes.data, pv.ctypes.data, len(pk),
            nk.ctypes.data, nv.ctypes.data, len(nk),
            out.ctypes.data, general.ctypes.data,
        )
        return out, general
