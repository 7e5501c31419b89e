"""Runtime lock-order assassin: instrumented locks for tests and soaks.

Opt-in via ``KT_LOCK_ASSERT=1`` (tests/conftest.py turns it on for the
whole suite). When off, the factories return plain ``threading``
primitives — zero overhead on the serving path. When on, every lock
created through :func:`make_lock`/:func:`make_rlock` is wrapped so that:

- each thread's acquisition stack is tracked; acquiring B while holding A
  records the order edge ``A -> B`` in a process-global graph, and an
  acquisition that would close a cycle (some thread previously acquired
  in the opposite order) raises :class:`LockOrderViolation` immediately —
  with the current stack and the first-seen stack of the conflicting
  edge — instead of deadlocking two chaos threads sometime later;
- re-acquiring a non-reentrant lock from its own holder raises instead of
  silently deadlocking;
- :func:`assert_held` lets ``*_locked`` helpers enforce their "caller
  holds the lock" contract;
- per-lock HOLD-TIME budgets (:func:`set_hold_budget`, fnmatch patterns
  over lock names, or a global default via ``KT_LOCK_HOLD_BUDGET``
  seconds): a release after holding longer than the budget raises
  :class:`LockHoldBudgetExceeded` — the runtime twin of the static
  ``blocking`` checker, keeping ``blocking_allow.txt`` honest: a waived
  "intended hold" that silently grows past its budget fails the suite
  instead of surfacing as a flip-p99 regression two PRs later;
- :func:`guard_attrs` (a class decorator) turns a class's ``GUARDED_BY``
  table — the same one the static analyzer reads — into a ``__setattr__``
  check: rebinding a guarded attribute after ``__init__`` without holding
  its lock raises :class:`LockAssertionError`. (Only rebinding is
  checked; in-place mutation of a guarded container is invisible to
  ``__setattr__`` and remains the static checker's job.)

The edge graph is cumulative across the process: two threads never need
to collide in time for an inversion to be caught — each order only has
to be *observed* once.

Every violation raised is also kept, in order, in :func:`reports`, as
``utils/racedetect.py`` and ``utils/epochassert.py`` keep theirs: a
worker loop that catches and logs one still leaves it there for a
harness to read.
"""

from __future__ import annotations

import fnmatch
import functools
import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderViolation",
    "LockAssertionError",
    "LockHoldBudgetExceeded",
    "enabled",
    "lock_assert_enabled",
    "race_detect_enabled",
    "make_lock",
    "make_rlock",
    "make_condition",
    "assert_held",
    "held_by_me",
    "held_names",
    "guard_attrs",
    "reset_graph",
    "set_hold_budget",
    "clear_hold_budgets",
    "reports",
]


class LockOrderViolation(RuntimeError):
    """Two locks were acquired in both orders (potential deadlock)."""


class LockAssertionError(RuntimeError):
    """A lock-holding contract was violated (lock not held / wrong owner)."""


class LockHoldBudgetExceeded(LockAssertionError):
    """A lock was held longer than its configured hold-time budget."""


# every violation raised, as "<class>: <message>"
_reports_lock = threading.Lock()
_reports: List[str] = []


def _reported(exc: RuntimeError) -> RuntimeError:
    with _reports_lock:
        _reports.append(f"{type(exc).__name__}: {exc}")
    return exc


def reports() -> List[str]:
    """Every lock-order, lock-assertion and hold-budget violation raised
    in this process so far, caught or not."""
    with _reports_lock:
        return list(_reports)


def lock_assert_enabled() -> bool:
    return os.environ.get("KT_LOCK_ASSERT", "") == "1"


def race_detect_enabled() -> bool:
    # mirror of racedetect.enabled() read here directly: the lockset
    # detector needs instrumented locks for thread-held identity, and
    # importing racedetect from this module would cycle
    return os.environ.get("KT_RACE_DETECT", "") == "1"


def enabled() -> bool:
    """Instrumentation master switch: the lock assassin
    (``KT_LOCK_ASSERT=1``) or the Eraser lockset detector
    (``KT_RACE_DETECT=1``) — race detection implies instrumented locks."""
    return lock_assert_enabled() or race_detect_enabled()


_tls = threading.local()

# order graph: name -> set of names acquired while holding it; guarded by
# _graph_lock for writes (reads are GIL-consistent snapshots — a stale
# read only delays edge insertion to the locked path below)
_graph_lock = threading.Lock()
_edges: Dict[str, Set[str]] = {}
# (outer, inner) -> trimmed stack at first sighting, for diagnostics
_edge_sites: Dict[Tuple[str, str], str] = {}


def reset_graph() -> None:
    """Clear the cumulative order graph (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _edge_sites.clear()


# ------------------------------------------------------- hold-time budgets

# (fnmatch pattern over lock names, seconds); first match wins. Seeded
# from KT_LOCK_HOLD_BUDGET (a global default budget in seconds) when set.
_hold_budgets: List[Tuple[str, float]] = []
_budget_epoch = 0  # bumped on every change so per-lock caches invalidate


_env_budget_cache: List[Optional[float]] = []  # [] = unread; [x] = cached


def _env_default_budget() -> Optional[float]:
    # read once per process: this sits on EVERY instrumented release, and
    # os.environ.get per release measurably taxed the armed soak tiers
    if not _env_budget_cache:
        raw = os.environ.get("KT_LOCK_HOLD_BUDGET", "")
        val: Optional[float] = None
        if raw:
            try:
                val = float(raw)
            except ValueError:
                val = None
        _env_budget_cache.append(val)
    return _env_budget_cache[0]


def set_hold_budget(pattern: str, seconds: float) -> None:
    """Arm a hold-time budget for every lock whose name fnmatches
    ``pattern`` (``"journal"``, ``"shard.*"``, ``"*"``). Releasing a lock
    after holding it longer than its budget raises
    :class:`LockHoldBudgetExceeded` — AFTER the release, so the failure
    cannot wedge other threads. First matching pattern wins; re-arming a
    pattern replaces its budget. Test-tier only (inert when
    instrumentation is off)."""
    global _budget_epoch
    with _graph_lock:
        _hold_budgets[:] = [(p, s) for p, s in _hold_budgets if p != pattern]
        _hold_budgets.append((str(pattern), float(seconds)))
        _budget_epoch += 1


def clear_hold_budgets() -> None:
    global _budget_epoch
    with _graph_lock:
        _hold_budgets.clear()
        _budget_epoch += 1


def _budget_for(name: str) -> Optional[float]:
    for pattern, seconds in _hold_budgets:
        if fnmatch.fnmatch(name, pattern):
            return seconds
    return _env_default_budget()


def _held() -> List["_InstrumentedLock"]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def held_names() -> Tuple[str, ...]:
    """Names of the instrumented locks the calling thread holds right
    now — the lockset the race detector intersects per access."""
    return tuple(lock.name for lock in _held())


def held_frozenset():
    """Frozenset form of :func:`held_names`, cached per thread and
    invalidated on every acquire/release — the race detector's per-access
    read. Identity is meaningful: two calls returning the SAME object
    mean the lockset did not change in between (the detector skips the
    intersection entirely then)."""
    fs = getattr(_tls, "held_fs", None)
    if fs is None:
        fs = _tls.held_fs = frozenset(lock.name for lock in _held())
    return fs


def _invalidate_held_fs() -> None:
    _tls.held_fs = None


def _site(limit: int = 8) -> str:
    return "".join(traceback.format_stack(limit=limit)[:-2])


def _reachable(src: str, dst: str) -> bool:
    """dst reachable from src in the edge graph (iterative DFS)."""
    seen = {src}
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        for m in _edges.get(n, ()):
            if m not in seen:
                seen.add(m)
                stack.append(m)
    return False


def _note_acquisition(lock: "_InstrumentedLock") -> None:
    held = _held()
    if not held:
        return
    for outer in held:
        a, b = outer.name, lock.name
        if a == b:
            continue
        s = _edges.get(a)
        if s is not None and b in s:
            continue  # known-good order, fast path
        with _graph_lock:
            s = _edges.setdefault(a, set())
            if b in s:
                continue
            # inserting a->b: would b ->* a close a cycle?
            if _reachable(b, a):
                prior = _edge_sites.get((b, a)) or next(
                    (
                        _edge_sites[e]
                        for e in _edge_sites
                        if e[0] == b and _reachable(e[1], a)
                    ),
                    "<site not recorded>",
                )
                raise _reported(LockOrderViolation(
                    f"lock-order inversion: acquiring '{b}' while holding "
                    f"'{a}', but the opposite order '{b}' -> ... -> '{a}' "
                    f"was previously observed.\n--- current acquisition "
                    f"(thread {threading.current_thread().name}) ---\n"
                    f"{_site()}--- first sighting of the opposite order ---\n"
                    f"{prior}"
                ))
            s.add(b)
            _edge_sites[(a, b)] = _site()


class _InstrumentedLock:
    """Lock/RLock replacement with owner tracking + order recording.

    Built on a plain ``threading.Lock`` with reentrancy managed here, so
    one implementation serves both kinds and Condition's
    ``_release_save``/``_acquire_restore`` protocol can keep the held
    bookkeeping exact across ``wait()``."""

    __slots__ = ("name", "reentrant", "_inner", "_owner", "_count", "_t0")

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.Lock()
        self._owner: Optional[int] = None
        self._count = 0
        self._t0 = 0.0  # monotonic instant the current hold began

    # -- core protocol ----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:
            if not self.reentrant:
                raise _reported(LockOrderViolation(
                    f"non-reentrant lock '{self.name}' re-acquired by its "
                    f"holder (guaranteed deadlock)\n{_site()}"
                ))
            self._count += 1
            return True
        _note_acquisition(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = me
            self._count = 1
            self._t0 = time.monotonic()
            _held().append(self)
            _invalidate_held_fs()
        return ok

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner != me:
            raise _reported(LockAssertionError(
                f"lock '{self.name}' released by a thread that does not "
                f"hold it\n{_site()}"
            ))
        self._count -= 1
        if self._count == 0:
            held_for = time.monotonic() - self._t0
            self._owner = None
            h = _held()
            if self in h:
                h.remove(self)
            _invalidate_held_fs()
            self._inner.release()
            # budget check AFTER the release: the raise must report the
            # over-hold, never extend it (or wedge the other threads)
            budget = _budget_for(self.name)
            if budget is not None and held_for > budget:
                raise _reported(LockHoldBudgetExceeded(
                    f"lock '{self.name}' held {held_for * 1e3:.1f}ms, over "
                    f"its {budget * 1e3:.1f}ms hold budget\n{_site()}"
                ))

    def __enter__(self) -> "_InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration -------------------------------------------

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        me = threading.get_ident()
        if self._owner != me:
            raise _reported(LockAssertionError(
                f"cond.wait() on '{self.name}' without holding it"
            ))
        saved = self._count
        self._count = 0
        self._owner = None
        h = _held()
        if self in h:
            h.remove(self)
        _invalidate_held_fs()
        self._inner.release()
        return saved

    def _acquire_restore(self, saved) -> None:
        _note_acquisition(self)
        self._inner.acquire()
        self._owner = threading.get_ident()
        self._count = saved
        # the wait()ed stretch does not count against the hold budget —
        # a fresh hold starts when the condition hands the lock back
        self._t0 = time.monotonic()
        _held().append(self)
        _invalidate_held_fs()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = f"held by {self._owner} x{self._count}" if self._owner else "unlocked"
        return f"<InstrumentedLock {self.name!r} {state}>"


def make_lock(name: str):
    """A ``threading.Lock`` — instrumented under ``KT_LOCK_ASSERT=1``.
    ``name`` should be globally descriptive (``"devicestate.main"``)."""
    if enabled():
        return _InstrumentedLock(name, reentrant=False)
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` — instrumented under ``KT_LOCK_ASSERT=1``."""
    if enabled():
        return _InstrumentedLock(name, reentrant=True)
    return threading.RLock()


def make_condition(lock=None):
    """``threading.Condition`` over a (possibly instrumented) lock.
    Instrumented locks implement the full owner/save/restore protocol, so
    ``wait()`` keeps the held-stack bookkeeping exact."""
    return threading.Condition(lock)


def held_by_me(lock) -> Optional[bool]:
    """True/False when determinable, None for plain primitives that do not
    expose ownership (an un-instrumented ``threading.Lock``)."""
    if isinstance(lock, _InstrumentedLock):
        return lock._is_owned()
    is_owned = getattr(lock, "_is_owned", None)
    if callable(is_owned):  # plain RLock / Condition
        try:
            return bool(is_owned())
        except Exception:  # pragma: no cover - exotic lock types
            return None
    return None


def assert_held(lock, what: str = "") -> None:
    """Enforce a ``*_locked`` helper's contract. No-op when the primitive
    cannot answer (plain Lock) or instrumentation is off — the call is
    then documentation; under ``KT_LOCK_ASSERT=1`` it bites."""
    if not isinstance(lock, _InstrumentedLock):
        # instrumentation off (production): every make_lock/make_rlock hands
        # out plain primitives — asking a plain RLock ``_is_owned()`` here
        # measured ~10µs/event across the ingest hot path's *_locked
        # helpers, pure overhead for a check that only bites when
        # instrumented. The suite runs KT_LOCK_ASSERT=1 (instrumented
        # locks), so the contract is still enforced where it matters.
        return
    owned = held_by_me(lock)
    if owned is False:
        name = getattr(lock, "name", repr(lock))
        raise _reported(LockAssertionError(
            f"{what or 'a _locked helper'} requires lock '{name}' held by "
            f"the calling thread\n{_site()}"
        ))


def _guard_lock_names(spec) -> Tuple[str, ...]:
    if isinstance(spec, str):
        spec = (spec,)
    out = []
    for s in spec:
        s = s.strip()
        if s.startswith("self."):
            s = s[5:]
        out.append(s.split("(")[0].split("[")[0])
    return tuple(out)


def guard_attrs(cls):
    """Class decorator: enforce the class's ``GUARDED_BY`` table at
    runtime. Inert unless instrumentation is on at class decoration
    time. Arms after ``__init__`` returns, so construction writes stay
    free. Two independent layers share the table:

    - ``KT_LOCK_ASSERT=1`` — rebind-time ``__setattr__`` check (original
      behavior: rebinding a guarded attribute without its lock raises);
    - ``KT_RACE_DETECT=1`` — a data descriptor per guarded attribute
      funnels reads AND writes into the Eraser lockset detector
      (``utils/racedetect.py``), catching the in-place-mutation and
      read-side races the rebind check cannot see."""
    if not enabled():
        return cls
    table = getattr(cls, "GUARDED_BY", None)
    if not table:
        return cls
    guards = {attr: _guard_lock_names(spec) for attr, spec in table.items()}
    orig_setattr = cls.__setattr__
    orig_init = cls.__init__
    check_rebind = lock_assert_enabled()

    def __setattr__(self, name, value):
        if check_rebind and name in guards and self.__dict__.get("_kt_guard_armed", False):
            ok = False
            for lock_name in guards[name]:
                lock = self.__dict__.get(lock_name)
                owned = held_by_me(lock) if lock is not None else None
                if owned is not False:  # held, or can't tell -> allow
                    ok = True
                    break
            if not ok:
                raise _reported(LockAssertionError(
                    f"guarded attribute '{name}' of {type(self).__name__} "
                    f"rebound without holding "
                    f"{' or '.join(guards[name])}\n{_site()}"
                ))
        orig_setattr(self, name, value)

    @functools.wraps(orig_init)
    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        self.__dict__["_kt_guard_armed"] = True

    cls.__setattr__ = __setattr__
    cls.__init__ = __init__
    if race_detect_enabled():
        from . import racedetect

        racedetect.install_descriptors(cls, guards.keys())
    return cls
