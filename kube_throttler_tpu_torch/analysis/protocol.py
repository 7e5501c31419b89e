"""Checker 8: cross-process protocol registries.

Three protocols cross a process (or crash) boundary in this codebase,
and each is keyed by short literal strings that no type system sees.
Drift is silent by construction — an unhandled control line is "skipped
corruption", an unhandled IPC frame is dropped on the floor, an unfenced
durable write is split-brain waiting for a pause. The checker pins each
registry's emit and dispatch sides against each other:

1. **Journal control lines.** Any dict literal ``{"type": "X", ...}``
   with an UPPERCASE type that is not a store watch-event type
   (ADDED/MODIFIED/DELETED/BOOKMARK/ERROR) is a journal control line
   (EPOCH, GANG, ...). Every emitted control type must be dispatched in
   ``StoreJournal._apply`` (local replay), dispatched in
   ``StandbyReplicator._apply_lines`` (the replication stream applies
   the same wire format — a control line the standby does not recognize
   is counted as corruption and its meaning is LOST on the standby), and
   re-emitted or explicitly handled in ``StoreJournal._compact_locked``
   (compaction rewrites the log from the store; control state not
   re-emitted is erased by every compaction).

2. **IPC frame message types.** ``send_frame(sock, lock, "mtype", ...)``
   literals partition by side — front (``sharding/ipc.py``,
   ``sharding/front.py``, ``sharding/supervisor.py``) vs worker
   (``sharding/worker.py``). Every mtype the front sends must be
   compared against a literal in the worker's dispatch (and vice versa),
   and every mtype a dispatch handles must have a sender somewhere —
   a handler nothing sends is dead protocol surface.

3. **Fencing-epoch domination.** In ``engine/journal.py`` and
   ``engine/snapshot.py``, any method of a fencing-aware class (one that
   assigns ``self.fencing``) that performs a durable write — a
   ``self._file.write``, an ``os.replace``, an ``os.fsync`` — must be
   *dominated* by an ``is_stale()`` check: either in its own body, or
   every in-class caller of the helper is itself dominated (a private
   writer funneled exclusively through checked entries is safe by
   construction; a method nobody in-class calls is a public entry and
   must check for itself). ``__init__``/``close`` are exempt
   (construction pre-dates leadership; shutdown flush must work fenced
   or not).

4. **Format registry coverage.** ``version.FORMAT_REGISTRY`` is the
   single source of truth mapping every durable/wire format to the
   minimum reader version that understands it — the rolling-upgrade
   contract. The registry must be a PURE dict literal (a computed
   registry cannot be audited at review time), and it must cover the
   code: every IPC frame mtype sent or dispatched needs a
   ``frame:<mtype>`` row, every emitted journal control type needs a
   ``journal:<TYPE>`` row, every entry of
   ``snapshot.SUPPORTED_SNAPSHOT_VERSIONS`` needs a ``snapshot:<v>``
   row, and every entry of ``shmring.SHM_FORMATS`` (the shared-memory
   event-ring layouts) needs an ``shm:<name>`` row. Stale rows (a
   registry entry whose referent no longer exists in
   the code) are findings too — a dead row misstates the compatibility
   surface to operators planning a roll.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, iter_classes, iter_methods, literal_str, unparse

_EVENT_TYPES = {"ADDED", "MODIFIED", "DELETED", "BOOKMARK", "ERROR"}
_FRONT_FILES = ("sharding/ipc.py", "sharding/front.py", "sharding/supervisor.py")
_WORKER_FILES = ("sharding/worker.py",)
_FENCED_EXEMPT = {"__init__", "close", "__del__"}


def _norm(relpath: str) -> str:
    return relpath.replace("\\", "/")


def _find_function(
    modules: Sequence[Module], cls_name: str, fn_name: str
) -> Optional[Tuple[Module, ast.FunctionDef]]:
    for m in modules:
        for cls in iter_classes(m):
            if cls.name != cls_name:
                continue
            for meth in iter_methods(cls):
                if meth.name == fn_name:
                    return m, meth
    return None


def _string_constants(fn: ast.AST) -> Set[str]:
    return {
        node.value
        for node in ast.walk(fn)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
    }


def _check_control_lines(modules: Sequence[Module], findings: List[Finding]) -> None:
    # emitted control types: {"type": "X"} dict literals, X uppercase,
    # not a watch-event type, no "object" key (event lines carry objects)
    emitted: Dict[str, Tuple[str, int]] = {}
    for m in modules:
        for node in m.walk():
            if not isinstance(node, ast.Dict):
                continue
            ctype = None
            has_object = False
            for k, v in zip(node.keys, node.values):
                ks = literal_str(k) if k is not None else None
                if ks == "type":
                    vs = literal_str(v)
                    if vs and vs.isupper() and vs not in _EVENT_TYPES:
                        ctype = vs
                if ks == "object":
                    has_object = True
            if ctype and not has_object:
                emitted.setdefault(ctype, (m.relpath, node.lineno))

    venues = (
        ("StoreJournal", "_apply", "journal replay dispatch"),
        ("StandbyReplicator", "_apply_lines", "replication stream dispatch"),
        ("StoreJournal", "_compact_locked", "compaction re-emit"),
    )
    for cls_name, fn_name, what in venues:
        found = _find_function(modules, cls_name, fn_name)
        if found is None:
            continue  # fixture trees without the engine are fine
        vm, vfn = found
        known = _string_constants(vfn)
        for ctype, (relpath, line) in sorted(emitted.items()):
            if ctype not in known:
                findings.append(
                    Finding(
                        checker="protocol",
                        path=relpath,
                        relpath=relpath,
                        line=line,
                        message=(
                            f"journal control type '{ctype}' is emitted but "
                            f"absent from {cls_name}.{fn_name} ({what}) — "
                            "its meaning is silently lost there"
                        ),
                    )
                )


def _check_ipc_frames(modules: Sequence[Module], findings: List[Finding]) -> None:
    sends: Dict[str, List[Tuple[str, str, int]]] = {"front": [], "worker": []}
    handler_consts: Dict[str, Set[str]] = {"front": set(), "worker": set()}
    have_sharding = False
    for m in modules:
        rel = _norm(m.relpath)
        side = (
            "front" if rel.endswith(_FRONT_FILES)
            else "worker" if rel.endswith(_WORKER_FILES)
            else None
        )
        if side is None:
            continue
        have_sharding = True
        for node in m.walk():
            if isinstance(node, ast.Call):
                fname = (
                    node.func.id
                    if isinstance(node.func, ast.Name)
                    else getattr(node.func, "attr", None)
                )
                if fname == "send_frame" and len(node.args) >= 3:
                    mtype = literal_str(node.args[2])
                    if mtype is not None:
                        sends[side].append((mtype, m.relpath, node.lineno))
            elif isinstance(node, ast.Compare):
                # `mtype == "evt"` / `elif mtype == "req"` dispatch arms —
                # only comparisons against the frame-type variable count
                # (``fault.mode == "kill"`` and friends are not protocol)
                if not (
                    isinstance(node.left, ast.Name) and node.left.id == "mtype"
                ):
                    continue
                for comp in node.comparators:
                    s = literal_str(comp)
                    if s is not None:
                        handler_consts[side].add(s)
    if not have_sharding:
        return
    opposite = {"front": "worker", "worker": "front"}
    for side, entries in sends.items():
        for mtype, relpath, line in entries:
            if mtype not in handler_consts[opposite[side]]:
                findings.append(
                    Finding(
                        checker="protocol",
                        path=relpath,
                        relpath=relpath,
                        line=line,
                        message=(
                            f"IPC frame type '{mtype}' sent from the {side} "
                            f"side has no {opposite[side]}-side dispatch arm — "
                            "the frame is dropped on the floor"
                        ),
                    )
                )
    sent_types = {
        side: {mtype for mtype, _, _ in entries} for side, entries in sends.items()
    }
    for side, consts in handler_consts.items():
        for mtype in sorted(consts):
            if mtype not in sent_types[opposite[side]]:
                findings.append(
                    Finding(
                        checker="protocol",
                        path=_FRONT_FILES[0] if side == "front" else _WORKER_FILES[0],
                        relpath=_FRONT_FILES[0] if side == "front" else _WORKER_FILES[0],
                        line=1,
                        message=(
                            f"IPC dispatch arm for '{mtype}' on the {side} "
                            f"side has no {opposite[side]}-side sender — dead "
                            "protocol surface"
                        ),
                    )
                )


def _durable_write_lines(fn: ast.AST) -> List[int]:
    out: List[int] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        text = unparse(f)
        if f.attr == "write" and text.startswith("self._file"):
            out.append(node.lineno)
        elif text in ("os.replace", "os.fsync"):
            out.append(node.lineno)
    return out


def _check_fencing(modules: Sequence[Module], findings: List[Finding]) -> None:
    for m in modules:
        rel = _norm(m.relpath)
        if not rel.endswith(("engine/journal.py", "engine/snapshot.py")):
            continue
        for cls in iter_classes(m):
            fencing_aware = any(
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Attribute)
                    and t.attr == "fencing"
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                    for t in node.targets
                )
                for node in ast.walk(cls)
            )
            if not fencing_aware:
                continue
            methods = {meth.name: meth for meth in iter_methods(cls)}
            callers: Dict[str, Set[str]] = {name: set() for name in methods}
            for meth in iter_methods(cls):
                for node in ast.walk(meth):
                    if (
                        isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"
                        and node.func.attr in methods
                    ):
                        callers[node.func.attr].add(meth.name)

            def checks_inline(fn: ast.AST) -> bool:
                return any(
                    isinstance(node, ast.Attribute) and node.attr == "is_stale"
                    for node in ast.walk(fn)
                )

            def dominated(name: str, seen: frozenset) -> bool:
                """The check itself, or EVERY in-class caller dominated —
                a private helper funneled through checked entries is
                dominated by construction; a method nobody in-class calls
                is a public entry and must check for itself."""
                if name in seen:
                    return True  # recursion: judged by the other paths
                if checks_inline(methods[name]):
                    return True
                calling = callers.get(name, set())
                if not calling:
                    return False
                return all(dominated(c, seen | {name}) for c in calling)

            for meth in iter_methods(cls):
                if meth.name in _FENCED_EXEMPT:
                    continue
                lines = _durable_write_lines(meth)
                if not lines:
                    continue
                if not dominated(meth.name, frozenset()):
                    findings.append(
                        Finding(
                            checker="protocol",
                            path=m.relpath,
                            relpath=m.relpath,
                            line=lines[0],
                            message=(
                                f"durable write in {cls.name}.{meth.name} is "
                                "not dominated by a fencing-epoch check — a "
                                "fenced (stale) leader can still mutate "
                                "durable state here"
                            ),
                        )
                    )


def _emitted_control_types(
    modules: Sequence[Module],
) -> Dict[str, Tuple[str, int]]:
    """Journal control types emitted anywhere: ``{"type": "X"}`` dict
    literals with an uppercase non-watch-event type and no ``object``
    key (the scan _check_control_lines pins dispatch against)."""
    emitted: Dict[str, Tuple[str, int]] = {}
    for m in modules:
        for node in m.walk():
            if not isinstance(node, ast.Dict):
                continue
            ctype = None
            has_object = False
            for k, v in zip(node.keys, node.values):
                ks = literal_str(k) if k is not None else None
                if ks == "type":
                    vs = literal_str(v)
                    if vs and vs.isupper() and vs not in _EVENT_TYPES:
                        ctype = vs
                if ks == "object":
                    has_object = True
            if ctype and not has_object:
                emitted.setdefault(ctype, (m.relpath, node.lineno))
    return emitted


def _check_format_registry(modules: Sequence[Module], findings: List[Finding]) -> None:
    reg: Optional[Tuple[Module, ast.Assign]] = None
    for m in modules:
        if not _norm(m.relpath).endswith("version.py"):
            continue
        for node in m.walk():
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "FORMAT_REGISTRY"
                for t in node.targets
            ):
                reg = (m, node)
                break
    if reg is None:
        return  # fixture trees without version.py have no contract to pin
    vm, vnode = reg
    if not isinstance(vnode.value, ast.Dict):
        findings.append(
            Finding(
                checker="protocol",
                path=vm.relpath,
                relpath=vm.relpath,
                line=vnode.lineno,
                message=(
                    "FORMAT_REGISTRY must be a pure dict literal — a "
                    "computed registry cannot be audited at review time"
                ),
            )
        )
        return
    rows: Set[str] = set()
    for k in vnode.value.keys:
        ks = literal_str(k) if k is not None else None
        if ks is None:
            findings.append(
                Finding(
                    checker="protocol",
                    path=vm.relpath,
                    relpath=vm.relpath,
                    line=vnode.lineno,
                    message=(
                        "FORMAT_REGISTRY key is not a string literal — "
                        "the registry must be pure so the min-reader "
                        "contract is readable without executing code"
                    ),
                )
            )
            continue
        rows.add(ks)

    # frames: every mtype sent (send_frame literal) or dispatched
    # (`mtype == "..."`) on either side needs a frame:<mtype> row
    frame_uses: Dict[str, Tuple[str, int]] = {}
    have_sharding = False
    for m in modules:
        rel = _norm(m.relpath)
        if not rel.endswith(_FRONT_FILES + _WORKER_FILES):
            continue
        have_sharding = True
        for node in m.walk():
            if isinstance(node, ast.Call):
                fname = (
                    node.func.id
                    if isinstance(node.func, ast.Name)
                    else getattr(node.func, "attr", None)
                )
                if fname == "send_frame" and len(node.args) >= 3:
                    mtype = literal_str(node.args[2])
                    if mtype is not None:
                        frame_uses.setdefault(mtype, (m.relpath, node.lineno))
            elif isinstance(node, ast.Compare):
                if isinstance(node.left, ast.Name) and node.left.id == "mtype":
                    for comp in node.comparators:
                        s = literal_str(comp)
                        if s is not None:
                            frame_uses.setdefault(s, (m.relpath, node.lineno))
    for mtype, (relpath, line) in sorted(frame_uses.items()):
        if f"frame:{mtype}" not in rows:
            findings.append(
                Finding(
                    checker="protocol",
                    path=relpath,
                    relpath=relpath,
                    line=line,
                    message=(
                        f"IPC frame type '{mtype}' has no 'frame:{mtype}' "
                        "row in version.FORMAT_REGISTRY — its min-reader "
                        "contract is undeclared for rolling upgrades"
                    ),
                )
            )

    # journal control lines: every emitted type needs a journal:<TYPE> row
    emitted = _emitted_control_types(modules)
    have_journal = any(
        _norm(m.relpath).endswith("engine/journal.py") for m in modules
    )
    for ctype, (relpath, line) in sorted(emitted.items()):
        if f"journal:{ctype}" not in rows:
            findings.append(
                Finding(
                    checker="protocol",
                    path=relpath,
                    relpath=relpath,
                    line=line,
                    message=(
                        f"journal control type '{ctype}' has no "
                        f"'journal:{ctype}' row in version.FORMAT_REGISTRY "
                        "— replay cannot name the reader it requires"
                    ),
                )
            )

    # snapshot versions: every supported version needs a snapshot:<v> row
    snap_versions: Dict[str, Tuple[str, int]] = {}
    have_snapshot = False
    for m in modules:
        if not _norm(m.relpath).endswith("engine/snapshot.py"):
            continue
        have_snapshot = True
        for node in m.walk():
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SUPPORTED_SNAPSHOT_VERSIONS"
                for t in node.targets
            ):
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant) and isinstance(
                            elt.value, int
                        ):
                            snap_versions.setdefault(
                                str(elt.value), (m.relpath, node.lineno)
                            )
    for ver, (relpath, line) in sorted(snap_versions.items()):
        if f"snapshot:{ver}" not in rows:
            findings.append(
                Finding(
                    checker="protocol",
                    path=relpath,
                    relpath=relpath,
                    line=line,
                    message=(
                        f"supported snapshot version {ver} has no "
                        f"'snapshot:{ver}' row in version.FORMAT_REGISTRY "
                        "— its min-reader contract is undeclared"
                    ),
                )
            )

    # shm ring layouts: every entry of shmring.SHM_FORMATS needs an
    # shm:<name> row (same contract shape as snapshot versions — the
    # reader must be able to name the layout it requires)
    shm_formats: Dict[str, Tuple[str, int]] = {}
    have_shmring = False
    for m in modules:
        if not _norm(m.relpath).endswith("sharding/shmring.py"):
            continue
        have_shmring = True
        for node in m.walk():
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SHM_FORMATS"
                for t in node.targets
            ):
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant) and isinstance(
                            elt.value, str
                        ):
                            shm_formats.setdefault(
                                elt.value, (m.relpath, node.lineno)
                            )
    for name, (relpath, line) in sorted(shm_formats.items()):
        if f"shm:{name}" not in rows:
            findings.append(
                Finding(
                    checker="protocol",
                    path=relpath,
                    relpath=relpath,
                    line=line,
                    message=(
                        f"shm ring format '{name}' has no "
                        f"'shm:{name}' row in version.FORMAT_REGISTRY "
                        "— its min-reader contract is undeclared"
                    ),
                )
            )

    # stale rows: a registry entry whose referent no longer exists
    # misstates the compatibility surface (only judged for domains whose
    # source of truth is present in the tree)
    for row in sorted(rows):
        domain, _, name = row.partition(":")
        stale = (
            (domain == "frame" and have_sharding and name not in frame_uses)
            or (domain == "journal" and have_journal and name not in emitted)
            or (domain == "snapshot" and have_snapshot and name not in snap_versions)
            or (domain == "shm" and have_shmring and name not in shm_formats)
        )
        unknown = domain not in ("frame", "journal", "snapshot", "shm")
        if stale or unknown:
            findings.append(
                Finding(
                    checker="protocol",
                    path=vm.relpath,
                    relpath=vm.relpath,
                    line=vnode.lineno,
                    message=(
                        f"FORMAT_REGISTRY row '{row}' is "
                        + (
                            "in an unknown domain "
                        "(expected frame:/journal:/snapshot:/shm:)"
                            if unknown
                            else "stale — nothing in the code emits or supports it"
                        )
                    ),
                )
            )


def check(modules: Sequence[Module]) -> List[Finding]:
    findings: List[Finding] = []
    _check_control_lines(modules, findings)
    _check_ipc_frames(modules, findings)
    _check_fencing(modules, findings)
    _check_format_registry(modules, findings)
    findings.sort(key=lambda f: (f.relpath, f.line, f.message))
    return findings
