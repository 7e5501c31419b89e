"""The port's runtime lock-order assassin
(kube_throttler_tpu_torch/utils/lockorder.py) under KT_LOCK_ASSERT=1: the
port copy of tests/test_lockorder.py.

conftest turns the env flag on for the whole suite, so make_lock here
returns instrumented primitives. Each test resets the process-global
order graph — the graph is deliberately cumulative (two threads never
need to collide in time), which also means tests must not leak edges
into each other.
"""

from __future__ import annotations

import threading

import pytest

from kube_throttler_tpu_torch.utils import lockorder
from kube_throttler_tpu_torch.utils.lockorder import (
    LockAssertionError,
    LockOrderViolation,
    assert_held,
    guard_attrs,
    make_condition,
    make_lock,
    make_rlock,
    reset_graph,
)


@pytest.fixture(autouse=True)
def _fresh_graph():
    reset_graph()
    yield
    reset_graph()


def test_enabled_in_suite():
    assert lockorder.enabled(), "conftest must arm KT_LOCK_ASSERT for the suite"


def test_inversion_detected_without_a_timed_collision():
    a, b = make_lock("t.a"), make_lock("t.b")
    with a:
        with b:
            pass
    # same thread, opposite order, long after the first pair released:
    # the cumulative edge graph still catches it
    with pytest.raises(LockOrderViolation) as ei:
        with b:
            with a:
                pass
    msg = str(ei.value)
    assert "t.a" in msg and "t.b" in msg
    assert "first sighting" in msg  # diagnostic carries the prior stack


def test_inversion_detected_across_threads():
    a, b = make_lock("x.a"), make_lock("x.b")

    def t1():
        with a:
            with b:
                pass

    th = threading.Thread(target=t1)
    th.start()
    th.join()

    with pytest.raises(LockOrderViolation):
        with b:
            with a:
                pass


def test_transitive_cycle_detected():
    a, b, c = make_lock("tr.a"), make_lock("tr.b"), make_lock("tr.c")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(LockOrderViolation):
        with c:
            with a:
                pass


def test_consistent_order_never_raises():
    a, b = make_lock("ok.a"), make_lock("ok.b")
    for _ in range(3):
        with a:
            with b:
                pass


def test_nonreentrant_self_reacquire_raises():
    a = make_lock("self.a")
    with pytest.raises(LockOrderViolation, match="re-acquired"):
        with a:
            with a:
                pass


def test_rlock_reenters_fine():
    r = make_rlock("self.r")
    with r:
        with r:
            assert r._is_owned()


def test_release_by_non_owner_raises():
    a = make_lock("rel.a")
    a.acquire()
    err = []

    def t():
        try:
            a.release()
        except LockAssertionError as e:
            err.append(e)

    th = threading.Thread(target=t)
    th.start()
    th.join()
    a.release()
    assert err, "foreign-thread release must raise"


def test_assert_held():
    a = make_lock("ah.a")
    with pytest.raises(LockAssertionError, match="requires lock"):
        assert_held(a, "helper")
    with a:
        assert_held(a, "helper")  # no raise


def test_condition_wait_rebalances_held_stack():
    lock = make_lock("cv.lock")
    cv = make_condition(lock)
    other = make_lock("cv.other")
    done = threading.Event()

    def waiter():
        with cv:
            cv.wait(timeout=5)
            done.set()

    th = threading.Thread(target=waiter)
    th.start()
    # while the waiter sleeps inside wait() it must NOT count as holding
    # cv.lock — acquiring other->lock here would otherwise record a bogus
    # inversion against the waiter's lock->(wait)->... stack
    with other:
        with cv:
            cv.notify_all()
    th.join()
    assert done.is_set()


def test_guard_attrs_rebind_without_lock_raises():
    @guard_attrs
    class Box:
        GUARDED_BY = {"items": "self._lock"}

        def __init__(self):
            self._lock = make_lock("ga.box")
            self.items = []  # construction writes are exempt

        def good(self):
            with self._lock:
                self.items = [1]

        def bad(self):
            self.items = [2]

    box = Box()
    box.good()
    with pytest.raises(LockAssertionError, match="rebound without holding"):
        box.bad()
    # unguarded attributes stay writable
    box.note = "ok"


def test_guard_attrs_inert_without_table():
    @guard_attrs
    class Plain:
        def __init__(self):
            self.x = 1

    p = Plain()
    p.x = 2
    assert p.x == 2


def test_hold_budget_raises_on_over_hold_and_lock_survives():
    """The runtime half of the blocking checker: a lock held past its
    budget raises AFTER release (the raise reports the over-hold, never
    extends it), and the lock stays usable afterwards."""
    import time

    lockorder.clear_hold_budgets()
    a = make_lock("budget.test.a")
    other = make_lock("other.unbudgeted")
    lockorder.set_hold_budget("budget.test.*", 0.02)
    try:
        with a:
            pass  # fast hold: under budget, no raise
        with pytest.raises(lockorder.LockHoldBudgetExceeded, match="hold budget"):
            with a:
                time.sleep(0.05)
        # unmatched locks fall through to the (unset) env default: no raise
        with other:
            time.sleep(0.05)
    finally:
        lockorder.clear_hold_budgets()
    # the over-hold released the lock before raising: still acquirable
    with a:
        assert a._is_owned()


def test_hold_budget_rearm_and_clear():
    import time

    lockorder.clear_hold_budgets()
    a = make_lock("budget.rearm")
    lockorder.set_hold_budget("budget.rearm", 0.01)
    lockorder.set_hold_budget("budget.rearm", 5.0)  # re-arm replaces
    try:
        with a:
            time.sleep(0.02)  # over the old budget, under the new: fine
    finally:
        lockorder.clear_hold_budgets()
    with a:
        time.sleep(0.02)  # budgets cleared: no raise
