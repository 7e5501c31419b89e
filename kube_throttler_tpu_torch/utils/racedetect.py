"""Eraser-style lockset race detector — the dynamic half of gen-3.

The GUARDED_BY machinery catches an unguarded write at runtime only
when it *rebinds* the attribute (``guard_attrs``' ``__setattr__``
check), and the static ``guarded`` checker reasons lexically. What
neither sees: actual *reads* racing actual writes under the locks each
thread really held. This module closes that gap with the classic
Eraser algorithm (Savage et al., SOSP '97) over exactly the attributes
the GUARDED_BY tables already declare shared:

- per (object, attribute) a **candidate lockset** ``C(v)`` is refined
  by intersection with the acquiring thread's instrumented-lock set at
  every access once a second thread touches the attribute;
- the read-share/write-exclusive state machine suppresses the benign
  patterns: ``Virgin → Exclusive`` (single-owner init, no lockset
  ops), ``Exclusive → Shared`` on a second-thread *read* (reads refine
  C(v) but an empty C(v) does not report), ``→ Shared-Modified`` on
  any second-thread write or a write in Shared (empty C(v) reports);
- a race is reported at **first observation** — the access whose
  intersection empties the candidate set — with both access sites,
  both locksets, and both threads. Two threads never need to collide
  in time; the interleaving only has to be *observed* once, which is
  what makes the planted-race gate deterministic.

Arming: ``KT_RACE_DETECT=1`` (tests/conftest.py arms it suite-wide,
like ``KT_LOCK_ASSERT``). ``utils/lockorder.guard_attrs`` then installs
a data descriptor per guarded attribute (reads AND writes funnel
through it at native cost for every *other* attribute — no
``__getattribute__`` tax), storing values under the attribute's own
``__dict__`` key so pickling/vars() are unchanged. Lock identity comes
from the instrumented ``make_lock``/``make_rlock`` primitives — race
mode implies lock instrumentation even when ``KT_LOCK_ASSERT`` is
unset.

Reports collect in a process-global list; the conftest sessionfinish
gate fails the suite on any unwaived report. Vetted benign races go in
``kube_throttler_tpu_torch/analysis_waivers/race_allow.txt`` keyed
``module.Class.attr`` (the module path below the package, as the JAX
package's detector keys its own) with a **mandatory justification** (the
convention: an entry with no justification, or naming an attribute
that no longer exists in any GUARDED_BY table, is itself an error —
tests/test_racedetect.py enforces both statically, so waiver rot fails
the suite without depending on which tests ran).
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

__all__ = [
    "enabled",
    "note_read",
    "note_write",
    "reports",
    "reset",
    "capture",
    "fired_waivers",
    "load_allow",
    "default_allow_path",
    "install_descriptors",
    "RaceReport",
]


def enabled() -> bool:
    return os.environ.get("KT_RACE_DETECT", "") == "1"


# ------------------------------------------------------------------- states

_VIRGIN = 0
_EXCLUSIVE = 1
_SHARED = 2
_SHARED_MOD = 3

_STATE_NAMES = {
    _VIRGIN: "virgin",
    _EXCLUSIVE: "exclusive",
    _SHARED: "read-shared",
    _SHARED_MOD: "shared-modified",
}


class _VarState:
    __slots__ = (
        "state",
        "owner",
        "lockset",
        "last_site",
        "last_ident",
        "last_name",
        "last_held",
        "last_write",
        "reported",
    )

    def __init__(self) -> None:
        self.state = _VIRGIN
        self.owner: Optional[int] = None
        self.lockset: Optional[FrozenSet[str]] = None
        self.last_site: Tuple[Tuple[str, int], ...] = ()
        self.last_ident = 0
        self.last_name = ""
        self.last_held: FrozenSet[str] = frozenset()
        self.last_write = False
        self.reported = False


@dataclass
class RaceReport:
    """First observation of an empty candidate lockset."""

    qual: str  # module.Class.attr — the waiver key
    attr: str
    kind: str  # "write/write" | "read/write" | "write/read"
    state: str  # state-machine state at detection
    thread: str
    held: Tuple[str, ...]
    site: str  # full stack of the detecting access
    prior_thread: str
    prior_held: Tuple[str, ...]
    prior_site: str  # compact file:line chain of the prior access
    line: str = ""  # file:line of the detecting access (first frame)

    def render(self) -> str:
        return (
            f"race on {self.qual} [{self.kind}, {self.state}]: candidate "
            f"lockset emptied at {self.line}\n"
            f"--- this access (thread {self.thread}, holding "
            f"{list(self.held) or '{}'}) ---\n{self.site}"
            f"--- prior access (thread {self.prior_thread}, holding "
            f"{list(self.prior_held) or '{}'}) ---\n  {self.prior_site}\n"
        )


# ------------------------------------------------------------------ globals

_mu = threading.Lock()  # plain on purpose: never enters the order graph
# the prefix a guarded class's module loses in its waiver key
_PACKAGE = __name__.split(".", 1)[0] + "."
_reports: List[RaceReport] = []
_reported_quals: set = set()
_fired_waivers: set = set()
_allow_cache: Optional[Dict[str, str]] = None
_tls = threading.local()


def default_allow_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "analysis_waivers",
        "race_allow.txt",
    )


def load_allow(path: Optional[str] = None) -> Dict[str, str]:
    """``module.Class.attr  # justification`` lines -> {qual: why}."""
    out: Dict[str, str] = {}
    path = path or default_allow_path()
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


def _allowed(qual: str) -> bool:
    global _allow_cache
    if _allow_cache is None:
        _allow_cache = load_allow()
    return qual in _allow_cache


def reports() -> List[RaceReport]:
    with _mu:
        return list(_reports)


def fired_waivers() -> set:
    with _mu:
        return set(_fired_waivers)


def reset() -> None:
    """Clear reports, fired waivers, and the waiver cache (test isolation).
    Per-object var states live on the objects and die with them."""
    global _allow_cache
    with _mu:
        _reports.clear()
        _reported_quals.clear()
        _fired_waivers.clear()
        _allow_cache = None


class capture:
    """Context manager: redirect reports to a local list so planted-race
    fixtures never leak into the suite-wide sessionfinish gate."""

    def __init__(self) -> None:
        self.reports: List[RaceReport] = []

    def __enter__(self) -> "capture":
        self._saved: List[RaceReport] = []
        with _mu:
            self._saved = list(_reports)
            _reports.clear()
            self._saved_quals = set(_reported_quals)
        return self

    def __exit__(self, *exc) -> None:
        with _mu:
            self.reports = list(_reports)
            _reports[:] = self._saved
            _reported_quals.clear()
            _reported_quals.update(self._saved_quals)


# ------------------------------------------------------------- access notes


# this module and lockorder, by exact path: an endswith() filter would
# also swallow tests/test_racedetect.py frames. Raw and abspath forms so
# per-frame comparison stays a set lookup on co_filename as-is.
_SELF_FILES = {
    __file__,
    os.path.abspath(__file__),
    os.path.join(os.path.dirname(__file__), "lockorder.py"),
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "lockorder.py"),
}


def _compact_frames(depth: int = 4, skip: int = 2) -> Tuple[Tuple[str, int], ...]:
    """(filename, lineno) chain of the caller — recorded on every access,
    so no string formatting here (format only at report time)."""
    out: List[Tuple[str, int]] = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    while f is not None and len(out) < depth:
        fn = f.f_code.co_filename
        if fn not in _SELF_FILES:
            out.append((fn, f.f_lineno))
        f = f.f_back
    return tuple(out)


def _fmt_frames(frames: Tuple[Tuple[str, int], ...]) -> str:
    return " <- ".join(f"{fn}:{ln}" for fn, ln in frames) or "<unknown>"


def _full_site(limit: int = 10) -> str:
    return "".join(traceback.format_stack(limit=limit)[:-3])


_held_frozenset = None  # resolved lazily (lockorder import would cycle)
_get_ident = threading.get_ident


def _held_fs() -> FrozenSet[str]:
    global _held_frozenset
    f = _held_frozenset
    if f is None:
        from . import lockorder

        f = _held_frozenset = lockorder.held_frozenset
    return f()


def _note(obj, attr: str, qual: str, is_write: bool) -> None:
    d = obj.__dict__
    vars_map = d.get("_kt_race_vars")
    if vars_map is None:
        vars_map = d["_kt_race_vars"] = {}
    vs0 = vars_map.get(attr)
    me = _get_ident()
    if vs0 is not None:
        if vs0.reported:
            return  # first observation already recorded for this var
        if vs0.state == _EXCLUSIVE and vs0.owner == me:
            # single-owner hot path (the overwhelmingly common case):
            # no lockset ops, no mutex — just enough context for the
            # eventual transition report (prior lockset/site of a FIRED
            # report always comes from a cross-thread access, which
            # takes the slow path). A concurrent transition by a second
            # thread only races these bookkeeping fields, never the
            # state machine itself (that runs under _mu below).
            vs0.last_ident = me
            vs0.last_write = is_write
            return
        held = _held_fs()
        if (
            vs0.lockset is not None
            and (vs0.state == _SHARED_MOD or not is_write)
            and vs0.lockset.issubset(held)
        ):
            # steady shared hot path: C ⊆ H means the intersection
            # leaves C unchanged — no state transition (write-in-Shared
            # excluded above), and a fire is impossible (an empty C in
            # Shared-Modified would already have reported) — mutex
            # skipped. This includes the post-handoff read-only pattern
            # (C emptied in read-share, every later read is free).
            vs0.last_ident = me
            vs0.last_write = is_write
            vs0.last_held = held
            return
    if getattr(_tls, "busy", False):
        return
    _tls.busy = True
    try:
        held = _held_fs()
        with _mu:
            vs = vars_map.get(attr)
            if vs is None:
                vs = vars_map[attr] = _VarState()
            race_kind: Optional[str] = None
            if vs.state == _VIRGIN:
                vs.state = _EXCLUSIVE
                vs.owner = me
            elif vs.state == _EXCLUSIVE:
                if vs.owner == me:
                    pass  # still single-owner: no lockset ops
                else:
                    # second thread: leave Exclusive, C(v) := held
                    vs.lockset = held
                    if is_write:
                        vs.state = _SHARED_MOD
                        if not vs.lockset:
                            race_kind = (
                                "write/write" if vs.last_write else "read/write"
                            )
                    else:
                        vs.state = _SHARED
            elif vs.state == _SHARED:
                if vs.lockset is None:
                    vs.lockset = held
                elif held is not vs.last_held:  # identity: same fs ⇒ C∩H==C
                    vs.lockset = vs.lockset & held
                if is_write:
                    vs.state = _SHARED_MOD
                    if not vs.lockset:
                        race_kind = "read/write"
            else:  # _SHARED_MOD
                if vs.lockset is None:
                    vs.lockset = held
                elif held is not vs.last_held:
                    vs.lockset = vs.lockset & held
                if not vs.lockset and not vs.reported:
                    race_kind = (
                        "write/write"
                        if (is_write and vs.last_write)
                        else ("read/write" if vs.last_write or is_write else None)
                    )
                    # two reads can empty C(v) only after a write put the
                    # var in Shared-Modified; attribute it to that write
                    race_kind = race_kind or "write/read"
            fire = race_kind is not None and not vs.reported
            if fire:
                vs.reported = True
                fire = qual not in _reported_quals
                if fire:
                    _reported_quals.add(qual)
            prior = (vs.last_name, vs.last_held, vs.last_site)
            # the frame walk and thread-name lookup are the per-access
            # cost centers; record them only when the accessing thread
            # CHANGED (prior-access context in a report always describes
            # the most recent cross-thread access — the conflict partner)
            if me != vs.last_ident or fire:
                vs.last_site = _compact_frames()
                vs.last_name = threading.current_thread().name
            vs.last_ident = me
            vs.last_held = held
            vs.last_write = is_write
        if fire:
            if _allowed(qual):
                with _mu:
                    _fired_waivers.add(qual)
                return
            site = _full_site()
            line = _fmt_frames(_compact_frames(depth=1))
            rep = RaceReport(
                qual=qual,
                attr=attr,
                kind=race_kind,
                state=_STATE_NAMES[_SHARED_MOD],
                thread=threading.current_thread().name,
                held=tuple(sorted(held)),
                site=site,
                prior_thread=prior[0] or "<none>",
                prior_held=tuple(sorted(prior[1])),
                prior_site=_fmt_frames(prior[2]) if prior[2] else "<first access>",
                line=line,
            )
            with _mu:
                _reports.append(rep)
            if os.environ.get("KT_RACE_RAISE", "") == "1":
                raise RaceDetected(rep.render())
    finally:
        _tls.busy = False


class RaceDetected(RuntimeError):
    """Raised at the detection site under ``KT_RACE_RAISE=1`` (debug aid;
    the default is collect-and-gate so one report never cascades)."""


def note_read(obj, attr: str, qual: str) -> None:
    _note(obj, attr, qual, is_write=False)


def note_write(obj, attr: str, qual: str) -> None:
    _note(obj, attr, qual, is_write=True)


# ---------------------------------------------- mutation-aware access kinds

# At the attribute level, an in-place mutation (``self._items.append(x)``,
# ``self._map[k] = v``) reaches the descriptor as a *load* — classifying
# it as a read would blind the write-exclusive half of the state machine
# to exactly the accesses ``guard_attrs``' rebind check already cannot
# see. So each load site is classified ONCE from the caller's bytecode
# (then cached by (code, lasti)): a load feeding a known mutator method
# or a subscript store/delete within the next few instructions is a
# WRITE access.

_MUTATORS = {
    "append",
    "extend",
    "insert",
    "remove",
    "pop",
    "popitem",
    "popleft",
    "appendleft",
    "clear",
    "update",
    "add",
    "discard",
    "setdefault",
    "sort",
    "reverse",
    "fill",
    "put",
    "put_nowait",
    "itemset",
    "resize",
}
_STORE_OPS = {"STORE_SUBSCR", "DELETE_SUBSCR"}
_LOAD_OPS = {"LOAD_ATTR", "LOAD_METHOD"}

_site_kind: Dict[Tuple[object, int], bool] = {}


def _classify_site(frame) -> bool:
    """True when the attribute load at frame.f_lasti feeds a mutation."""
    import dis

    key = (frame.f_code, frame.f_lasti)
    hit = _site_kind.get(key)
    if hit is not None:
        return hit
    is_write = False
    try:
        instrs = list(dis.get_instructions(frame.f_code))
        idx = next(
            (i for i, ins in enumerate(instrs) if ins.offset == frame.f_lasti),
            None,
        )
        if idx is not None:
            for ins in instrs[idx + 1 : idx + 7]:
                if ins.opname in _STORE_OPS:
                    is_write = True
                    break
                if ins.opname in _LOAD_OPS and ins.argval in _MUTATORS:
                    is_write = True
                    break
                # any consumer that ends this expression's use of the
                # loaded value: calls, stores, jumps/branch tests, loop
                # setup, returns — stop before misreading a LATER
                # statement's store as ours
                if ins.opname.startswith(
                    ("STORE_", "CALL", "RETURN", "POP_JUMP", "JUMP", "COMPARE_OP")
                ) or ins.opname in ("POP_TOP", "GET_ITER", "FOR_ITER", "UNPACK_SEQUENCE"):
                    break
    except Exception:  # pragma: no cover - dis is total on live code
        pass
    if len(_site_kind) > 65536:
        _site_kind.clear()
    _site_kind[key] = is_write
    return is_write


# -------------------------------------------------------------- descriptors

_MISSING = object()


class _TrackedAttr:
    """Data descriptor over one guarded attribute. Storage stays under
    the attribute's own ``__dict__`` key (data descriptors shadow the
    instance dict on lookup, so reads/writes funnel here while
    ``vars()``/pickling see exactly the usual shape). Tracking arms with
    ``_kt_guard_armed`` — construction writes stay free, like
    ``guard_attrs``."""

    __slots__ = ("name", "qual", "default")

    def __init__(self, name: str, qual: str, default=_MISSING):
        self.name = name
        self.qual = qual
        self.default = default

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        d = obj.__dict__
        val = d.get(self.name, _MISSING)
        if val is _MISSING:
            if self.default is _MISSING:
                raise AttributeError(self.name)
            return self.default
        if d.get("_kt_guard_armed", False):
            # inline single-owner fast path: the descriptor is on every
            # hot read, so the steady case must cost dict gets only
            vm = d.get("_kt_race_vars")
            vs = vm.get(self.name) if vm is not None else None
            if vs is not None and vs.state == _EXCLUSIVE and vs.owner == _get_ident():
                # single-owner reads don't even classify: last_write
                # keeps the value from the last slow-path access (the
                # first access classified this site family already;
                # kind labels on an eventual report tolerate that)
                vs.last_ident = vs.owner
                return val
            if vs is not None and vs.reported:
                return val
            # a load feeding an in-place mutation IS a write — classified
            # from the caller's bytecode (cached per site)
            _note(obj, self.name, self.qual, _classify_site(sys._getframe(1)))
        return val

    def __set__(self, obj, value) -> None:
        d = obj.__dict__
        d[self.name] = value
        if d.get("_kt_guard_armed", False):
            vm = d.get("_kt_race_vars")
            vs = vm.get(self.name) if vm is not None else None
            if vs is not None and vs.state == _EXCLUSIVE and vs.owner == _get_ident():
                vs.last_ident = vs.owner
                vs.last_write = True
                return
            if vs is not None and vs.reported:
                return
            _note(obj, self.name, self.qual, True)

    def __delete__(self, obj) -> None:
        try:
            del obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None


def install_descriptors(cls, attrs) -> None:
    """Install a tracking descriptor per guarded attribute. Called from
    ``lockorder.guard_attrs`` when race detection is armed. Classes
    relying on ``__slots__`` for a guarded attr are skipped (no guarded
    class does today; slotted helpers stay untouched)."""
    slots = getattr(cls, "__slots__", None)
    if slots is not None and "__dict__" not in slots:
        return
    qual_base = f"{cls.__module__.removeprefix(_PACKAGE)}.{cls.__qualname__}"
    for attr in attrs:
        existing = getattr(cls, attr, _MISSING)
        if isinstance(existing, _TrackedAttr):
            continue
        default = existing if existing is not _MISSING else _MISSING
        if callable(default) or isinstance(default, property):
            # a method/property sharing the name would be shadowed;
            # guarded attrs are data, never callables — skip defensively
            continue
        setattr(cls, attr, _TrackedAttr(attr, f"{qual_base}.{attr}", default))
