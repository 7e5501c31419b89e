"""The port's static analyzer (``kube_throttler_tpu_torch.analysis``):
each checker must fire on a seeded fixture violation (with the right
file:line) and stay silent on the port.

The port copy of ``tests/test_analysis.py``. Fixtures are tiny source
trees written to tmp_path and analyzed through the same
``load_package``/``run_checks`` pipeline the CLI uses, so the tests
exercise path scoping and baseline handling too — not just the AST
visitors. The gate shells out to ``python -m
kube_throttler_tpu_torch.analysis`` from the repository root. The
reference's purity, donation and retrace tests are left out with their
checkers, which the port does not have; the torch rules of the
``blocking`` and ``dtype`` checkers are tested in
``tests/test_torch_analysis_torch_rules.py``.

Every checker here is shared with the JAX package's analyzer, and no
fixture of this file holds torch code, so each fixture run is also a
parity check: the JAX package's ``run_checks`` over the same tree, with
the same waiver files, must report the same findings (``same_findings``).
``tests/test_torch_analysis_parity.py`` holds the two analyzers equal
over the port itself.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import textwrap

import pytest

from kube_throttler_tpu.analysis import run_checks as reference_run_checks
from kube_throttler_tpu.analysis.core import load_package as reference_load_package
from kube_throttler_tpu_torch.analysis import (
    DEFAULT_ALLOWLIST,
    DEFAULT_BLOCKING_ALLOWLIST,
    DEFAULT_DEADLINE_ALLOWLIST,
    DEFAULT_EPOCH_ALLOWLIST,
    run_checks,
    run_repo,
)
from kube_throttler_tpu_torch.analysis.__main__ import main as analysis_main
from kube_throttler_tpu_torch.analysis.core import (
    apply_baseline,
    load_baseline,
    load_package,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_tree(root, files):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


# the one message the port words apart on purpose: its default-dtype
# advice for a numpy allocation drops the jnp clause
_PORT_WORDING = (
    ("numpy defaults to float64; pass dtype=np.int64",
     "numpy defaults to float64, jnp to float32; pass dtype=np.int64"),
)


def as_reference(message):
    for port, reference in _PORT_WORDING:
        message = message.replace(port, reference)
    return message


def rows(findings, wording=lambda m: m):
    return sorted((f.checker, f.relpath, f.line, wording(f.message)) for f in findings)


def checked_run(root, checks, **paths):
    """``run_checks`` of the port over ``root``, held equal to the JAX
    package's ``run_checks`` over the same tree with the same waiver
    files (the port's defaults where none is given): the same findings,
    and the same dead waivers in ``stale_allow_out``."""
    paths = {
        "allowlist_path": DEFAULT_ALLOWLIST,
        "blocking_allowlist_path": DEFAULT_BLOCKING_ALLOWLIST,
        "epoch_allowlist_path": DEFAULT_EPOCH_ALLOWLIST,
        "deadline_allowlist_path": DEFAULT_DEADLINE_ALLOWLIST,
        **paths,
    }
    stale_out = paths.pop("stale_allow_out", None)
    port_stale, ref_stale = {}, {}
    found = run_checks(load_package(str(root)), checks, stale_allow_out=port_stale, **paths)
    ref = reference_run_checks(
        reference_load_package(str(root)), checks, stale_allow_out=ref_stale, **paths
    )
    assert rows(found, as_reference) == rows(ref), "the port's analyzer and the JAX package's differ"
    assert port_stale == ref_stale
    if stale_out is not None:
        stale_out.update(port_stale)
    return found


def findings_for(root, checks, allowlist_path=None):
    return checked_run(root, checks, allowlist_path=allowlist_path)


# ------------------------------------------------------------------ guarded


class TestGuardedBy:
    def test_unguarded_write_fires_with_line(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading


                class Box:
                    GUARDED_BY = {"_items": "self._lock"}

                    def __init__(self):
                        self._lock = threading.Lock()
                        self._items = []

                    def ok(self):
                        with self._lock:
                            self._items.append(1)

                    def bad(self):
                        self._items.append(2)
                '''
            },
        )
        found = findings_for(root, ("guarded",))
        assert len(found) == 1
        f = found[0]
        assert f.checker == "guarded"
        assert f.relpath == "mod.py"
        assert f.line == 16  # the self._items read in bad()
        assert "_items" in f.message and "Box.bad" in f.message

    def test_inline_annotation_and_locked_suffix(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading


                class Box:
                    def __init__(self):
                        self._lock = threading.Lock()
                        self._n = 0  #: guarded-by: self._lock

                    def _bump_locked(self):
                        self._n += 1  # caller-holds-lock contract: no finding

                    def bad(self):
                        return self._n
                '''
            },
        )
        found = findings_for(root, ("guarded",))
        assert [f.line for f in found] == [13]
        assert "Box.bad" in found[0].message

    def test_condition_alias_satisfies_lock_guard(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading


                class Q:
                    GUARDED_BY = {"_q": "self._lock"}

                    def __init__(self):
                        self._lock = threading.Lock()
                        self._cv = threading.Condition(self._lock)
                        self._q = []

                    def put(self, x):
                        with self._cv:  # holding the condition IS holding the lock
                            self._q.append(x)
                '''
            },
        )
        assert findings_for(root, ("guarded",)) == []


# ---------------------------------------------------------------- lockorder


_CYCLE_SRC = {
    "mod.py": '''\
    import threading


    class AB:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def ab(self):
            with self._a:
                with self._b:
                    pass

        def ba(self):
            with self._b:
                with self._a:
                    pass
    '''
}


class TestLockOrder:
    def test_cycle_fires(self, tmp_path):
        found = findings_for(write_tree(tmp_path, _CYCLE_SRC), ("lockorder",))
        cycles = [f for f in found if "cycle" in f.message]
        assert len(cycles) == 1
        assert "mod.AB._a" in cycles[0].message and "mod.AB._b" in cycles[0].message
        assert cycles[0].relpath == "mod.py"

    def test_allowlist_silences_vetted_edge(self, tmp_path):
        root = write_tree(tmp_path, _CYCLE_SRC)
        allow = tmp_path / "allow.txt"
        # removing either direction breaks the 2-cycle
        allow.write_text("mod.AB._b -> mod.AB._a  # vetted: ba() only runs in tests\n")
        found = findings_for(root, ("lockorder",), allowlist_path=str(allow))
        assert [f for f in found if "cycle" in f.message] == []

    def test_nonreentrant_self_reacquire_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading


                class S:
                    def __init__(self):
                        self._lock = threading.Lock()

                    def outer(self):
                        with self._lock:
                            self.inner()

                    def inner(self):
                        with self._lock:
                            pass
                '''
            },
        )
        found = findings_for(root, ("lockorder",))
        assert any("re-acquired while held" in f.message for f in found)

    def test_rlock_self_nesting_is_fine(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading


                class R:
                    def __init__(self):
                        self._lock = threading.RLock()

                    def outer(self):
                        with self._lock:
                            self.inner()

                    def inner(self):
                        with self._lock:
                            pass
                '''
            },
        )
        assert findings_for(root, ("lockorder",)) == []


# ----------------------------------------------------------------- registry


_REGISTRY_BASE = {
    "faults/plan.py": '''\
    KNOWN_SITES = frozenset({"transport.request", "journal.append"})
    ''',
    "metrics.py": '''\
    METRIC_NAMES = frozenset({"kube_throttler_good_total"})
    ''',
}


class TestRegistry:
    def test_unregistered_fault_site(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                **_REGISTRY_BASE,
                "mod.py": '''\
                def f(self):
                    self.faults.check("transport.request")
                    self.faults.check("transport.typo")
                ''',
            },
        )
        found = findings_for(root, ("registry",))
        assert len(found) == 1
        assert found[0].line == 3
        assert "transport.typo" in found[0].message

    def test_faultrule_pattern_must_match_some_site(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                **_REGISTRY_BASE,
                "mod.py": '''\
                from faults import FaultRule

                ok = FaultRule(site="transport.*")
                bad = FaultRule(site="watch.*")
                ''',
            },
        )
        found = findings_for(root, ("registry",))
        assert len(found) == 1
        assert found[0].line == 4
        assert "watch.*" in found[0].message

    def test_undeclared_metric_name(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                **_REGISTRY_BASE,
                "mod.py": '''\
                def setup(registry):
                    registry.gauge_vec("kube_throttler_good_total", "h", ["a"])
                    registry.counter_vec("kube_throttler_drifted_total", "h", ["a"])
                ''',
            },
        )
        found = findings_for(root, ("registry",))
        assert len(found) == 1
        assert found[0].line == 3
        assert "kube_throttler_drifted_total" in found[0].message

    def test_missing_registry_declarations_flagged(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "faults/plan.py": "SITES = None\n",
                "metrics.py": "x = 1\n",
            },
        )
        messages = "\n".join(f.message for f in findings_for(root, ("registry",)))
        assert "KNOWN_SITES" in messages
        assert "METRIC_NAMES" in messages


# ------------------------------------------------------- baseline mechanics


class TestBaseline:
    def test_waived_findings_do_not_fail(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading


                class Box:
                    GUARDED_BY = {"_items": "self._lock"}

                    def __init__(self):
                        self._lock = threading.Lock()
                        self._items = []

                    def bad(self):
                        return self._items
                '''
            },
        )
        found = findings_for(root, ("guarded",))
        assert len(found) == 1
        baseline_path = tmp_path / "baseline.txt"
        baseline_path.write_text(f"{found[0].key()}  # vetted lock-free read\n")
        baseline = load_baseline(str(baseline_path))
        new, waived, stale = apply_baseline(found, baseline)
        assert new == [] and len(waived) == 1 and stale == []

    def test_stale_waivers_reported(self, tmp_path):
        baseline = {"guarded|gone.py|read of '_x' outside its lock in G.f": "old"}
        new, waived, stale = apply_baseline([], baseline)
        assert new == [] and waived == [] and len(stale) == 1

    def test_key_is_line_stable(self, tmp_path):
        """Shifting a violation by a line must not change its baseline key."""

        body = textwrap.dedent(
            '''\
            import threading


            class Box:
                GUARDED_BY = {"_items": "self._lock"}

                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = []

                def bad(self):
                    return self._items
            '''
        )

        def tree(prefix_lines):
            return {"mod.py": "# pad\n" * prefix_lines + body}

        a = findings_for(write_tree(tmp_path / "a", tree(0)), ("guarded",))
        b = findings_for(write_tree(tmp_path / "b", tree(3)), ("guarded",))
        assert a[0].line != b[0].line
        assert a[0].key() == b[0].key()


# ----------------------------------------------------------- CLI / repo gate


class TestCli:
    def test_cli_nonzero_on_seeded_violation(self, tmp_path):
        root = write_tree(tmp_path, _CYCLE_SRC)
        empty_baseline = tmp_path / "baseline.txt"
        empty_baseline.write_text("")
        rc = analysis_main(
            ["--root", root, "--baseline", str(empty_baseline), "-q"]
        )
        assert rc == 1

    def test_cli_zero_on_clean_tree(self, tmp_path):
        root = write_tree(tmp_path, {"mod.py": "x = 1\n"})
        rc = analysis_main(["--root", root, "--no-baseline", "-q"])
        assert rc == 0

    def test_repo_is_clean_inprocess(self):
        """The real package must analyze clean against the checked-in
        baseline, and every baseline waiver must still be live."""
        new, waived, stale = run_repo()
        assert new == [], "\n".join(f.render() for f in new)
        assert stale == [], f"stale baseline waivers: {stale}"

    def test_repo_gate_subprocess(self):
        """Tier-1 regression gate: the module run with no arguments from
        the repository root, as a user runs it."""
        proc = subprocess.run(
            [sys.executable, "-m", "kube_throttler_tpu_torch.analysis"],
            cwd=REPO_ROOT,
            capture_output=True,
            text=True,
            timeout=300,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr


# ----------------------------------------------------------------- blocking


class TestBlocking:
    def test_direct_blocking_under_lock_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading
                import time


                class Box:
                    def __init__(self):
                        self._lock = threading.Lock()

                    def bad(self):
                        with self._lock:
                            time.sleep(0.5)
                ''',
            },
        )
        found = findings_for(root, ("blocking",))
        assert len(found) == 1
        assert found[0].line == 11
        assert "sleep()" in found[0].message
        assert "mod.Box._lock" in found[0].message

    def test_interprocedural_fsync_under_lock(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import os
                import threading


                class J:
                    def __init__(self):
                        self._lock = threading.Lock()
                        self._file = None

                    def _sync(self):
                        os.fsync(self._file.fileno())

                    def append(self, line):
                        with self._lock:
                            self._sync()
                ''',
            },
        )
        found = findings_for(root, ("blocking",))
        assert len(found) == 1
        assert "os.fsync()" in found[0].message and "append -> _sync" in found[0].message

    def test_dispatch_bridge_catches_blocking_io_under_store_lock(self, tmp_path):
        """The historical class: a store's handler fan-out runs under
        the store lock, and a registered journal handler does file I/O —
        the blocking reaches the store lock through the observer seam."""
        root = write_tree(
            tmp_path,
            {
                "store.py": '''\
                import threading


                class Store:
                    def __init__(self):
                        self._lock = threading.Lock()
                        self._handlers = []

                    def add_event_handler(self, kind, fn):
                        self._handlers.append(fn)

                    def _dispatch_locked(self, event):
                        for h in self._handlers:
                            h(event)

                    def update_status(self, event):
                        with self._lock:
                            self._dispatch_locked(event)
                ''',
                "journal.py": '''\
                import os


                class Journal:
                    def __init__(self, store):
                        self._file = None
                        store.add_event_handler("Throttle", self._on_event)

                    def _on_event(self, event):
                        os.fsync(self._file.fileno())
                ''',
            },
        )
        found = findings_for(root, ("blocking",))
        assert any(
            "os.fsync()" in f.message and "store.Store._lock" in f.message
            for f in found
        ), [f.render() for f in found]

    def test_allowlist_and_stale_detection(self, tmp_path):
        from kube_throttler_tpu_torch.analysis import blocking
        from kube_throttler_tpu_torch.analysis.core import load_package

        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading
                import time


                class Box:
                    def __init__(self):
                        self._lock = threading.Lock()

                    def bad(self):
                        with self._lock:
                            time.sleep(0.5)
                ''',
            },
        )
        allow = tmp_path / "allow.txt"
        allow.write_text(
            "mod.Box._lock -> sleep()  # vetted\n"
            "mod.Box._lock -> os.fsync()  # DEAD waiver\n"
        )
        stale = []
        found = blocking.check(
            load_package(str(root)), allowlist_path=str(allow), stale_out=stale
        )
        assert found == []
        assert stale == [("mod.Box._lock", "os.fsync()")]
        from kube_throttler_tpu.analysis import blocking as reference_blocking

        ref_stale = []
        assert reference_blocking.check(
            reference_load_package(str(root)), allowlist_path=str(allow), stale_out=ref_stale
        ) == []
        assert ref_stale == stale


    # the port's own rules: a hold by explicit acquire/release and a call
    # through a local receiver. The JAX package's checker has neither, so
    # these fixtures run the port's analyzer alone (the carve-out of
    # tests/test_torch_analysis_parity.py) and check that the JAX
    # package's sees nothing where the port's fires.

    _ACQUIRE_SRC = '''\
        import contextlib
        import threading
        import time


        class Box:
            def __init__(self):
                self._lock = threading.Lock()

            def held(self):
                with contextlib.nullcontext():
                    self._lock.acquire()
                try:
                    time.sleep(0.5)
                finally:
                    self._lock.release()

            def released(self):
                self._lock.acquire()
                try:
                    pass
                finally:
                    self._lock.release()
                time.sleep(0.5)
        '''

    @staticmethod
    def _port_only(root):
        found = run_checks(load_package(str(root)), ("blocking",),
                           blocking_allowlist_path=DEFAULT_BLOCKING_ALLOWLIST)
        ref = reference_run_checks(reference_load_package(str(root)), ("blocking",),
                                   blocking_allowlist_path=DEFAULT_BLOCKING_ALLOWLIST)
        return found, ref

    @pytest.mark.parametrize("method, fires", [("held", True), ("released", False)])
    def test_acquire_release_region(self, tmp_path, method, fires):
        """A lock taken by ``.acquire()`` (inside a ``with`` block of
        its own) is held through the ``try`` until the ``finally``'s
        ``.release()``: a sleep there fires; one after the release does
        not."""
        src = self._ACQUIRE_SRC.replace(f"def {method}(", "def target(")
        found, ref = self._port_only(write_tree(tmp_path, {"mod.py": src}))
        hits = [f for f in found if "(in Box.target)" in f.message]
        if fires:
            assert [(f.line, f.message) for f in hits] == [
                (14, "blocking sleep() while holding mod.Box._lock (in Box.target)")]
        else:
            assert hits == [], [f.render() for f in hits]
        assert ref == []

    def test_local_receiver_is_resolved_one_level(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading
                import time


                class Part:
                    def settle(self):
                        time.sleep(0.5)


                class Box:
                    def __init__(self):
                        self._lock = threading.Lock()
                        self._parts = {}

                    def _part(self, k) -> "Part":
                        return self._parts[k]

                    def by_annotation(self, k):
                        part = self._part(k)
                        with self._lock:
                            part.settle()

                    def unresolved(self, part):
                        with self._lock:
                            part.settle()
                ''',
            },
        )
        found, ref = self._port_only(root)
        assert [(f.line, f.message) for f in found] == [
            (21, "blocking sleep() while holding mod.Box._lock (in Box.by_annotation -> settle)")]
        assert ref == []

    def test_aggregate_used_for_holds_the_agg_lock_across_the_apply(self):
        """The site the checker's docstring names: ``aggregate_used_for``
        takes ``_agg_locks[kind]`` and ``_lock`` by ``.acquire()``; the
        steal runs under both, the apply (``ks.apply_agg_work``, through a
        local receiver) under the aggregate lock alone, and the apply
        reaches ``.cpu()`` and ``.numpy()`` (``KT_AGG_DEVICE_DELTAS=1``).
        Without its waiver the pair is a finding."""
        from kube_throttler_tpu_torch.analysis import PACKAGE_ROOT, blocking
        from kube_throttler_tpu_torch.analysis.core import iter_classes, iter_methods
        from kube_throttler_tpu_torch.analysis.lockgraph import (
            _collect_class_info,
            _ModuleLocks,
        )

        modules = load_package(PACKAGE_ROOT)
        (mod,) = [m for m in modules if m.modname == "engine.devicestate"]
        infos = {c.name: _collect_class_info(mod, c) for c in iter_classes(mod)}
        by_bare = {n: [i] for n, i in infos.items()}
        (fn,) = [f for f in iter_methods(infos["DeviceStateManager"].cls)
                 if f.name == "aggregate_used_for"]
        scan = blocking._Scan()
        blocking._scan_function(fn, infos["DeviceStateManager"], _ModuleLocks(mod),
                                by_bare, set(), scan)
        agg = "engine.devicestate.DeviceStateManager._agg_locks"
        main = "engine.devicestate.DeviceStateManager._lock"
        held = {ref[-1]: h for ref, h, _ in scan.calls}
        assert held["steal_agg_work"] == {agg, main}
        assert held["apply_agg_work"] == {agg}
        assert ("local", "engine.devicestate._KindState", "apply_agg_work") in {
            ref for ref, _, _ in scan.calls}
        assert held["flip_candidate_cols"] == {agg}
        messages = [f.message for f in blocking.check(modules)]
        for desc in ("torch:.cpu()", "torch:.numpy()"):
            assert any(f"blocking {desc} while holding {agg} " in m for m in messages)

    def test_the_store_lock_reaches_a_device_wait_only_through_ingest_flip_promotion(
            self, monkeypatch):
        """``Store._lock -> torch:.cpu()`` and ``-> torch:.numpy()`` are
        waived for one route: dispatch's handlers reach
        ``DeviceStateManager._promote_ingest_flips``, whose aggregate apply
        waits for the card under ``KT_AGG_DEVICE_DELTAS=1``. A waiver keys
        on the pair alone, so it would hide any other chain to a device
        wait under the store lock: with that one method left out of the
        analysis, the store lock must reach no device wait at all."""
        from kube_throttler_tpu_torch.analysis import PACKAGE_ROOT, blocking

        modules = load_package(PACKAGE_ROOT)
        scan = blocking._scan_function

        def store_lock_device_waits():
            pairs = set()
            for f in blocking.check(modules):
                m = re.match(r"blocking (\S+) while holding engine\.store\.Store\._lock ",
                             f.message)
                if m and m.group(1).startswith(("torch:", "kernel:", "torch.cuda.")):
                    pairs.add(m.group(1))
            return pairs

        def without_promotion(fn, info, *rest):
            if (info is not None and info.qual == "engine.devicestate.DeviceStateManager"
                    and fn.name == "_promote_ingest_flips"):
                return
            scan(fn, info, *rest)

        assert store_lock_device_waits() == {"torch:.cpu()", "torch:.numpy()"}
        monkeypatch.setattr(blocking, "_scan_function", without_promotion)
        assert store_lock_device_waits() == set()


# ------------------------------------------------------------------ threads


_SILENT_THREAD_SRC = {
    "mod.py": '''\
    import threading


    class Pump:
        def __init__(self):
            self._t = threading.Thread(target=self._loop, daemon=True)
            self._t.start()

        def _loop(self):
            while True:
                self.step()

        def step(self):
            pass
    '''
}


class TestThreads:
    def test_silent_death_fires_at_target(self, tmp_path):
        found = findings_for(write_tree(tmp_path, _SILENT_THREAD_SRC), ("threads",))
        assert len(found) == 1
        f = found[0]
        assert f.relpath == "mod.py"
        assert f.line == 9  # the _loop def
        assert "no top-level exception routing" in f.message

    def test_broad_handler_passes(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading


                class Pump:
                    def __init__(self):
                        threading.Thread(target=self._loop, daemon=True).start()

                    def _loop(self):
                        while True:
                            try:
                                self.step()
                            except Exception:
                                self.note_death()

                    def step(self):
                        pass

                    def note_death(self):
                        pass
                ''',
            },
        )
        assert findings_for(root, ("threads",)) == []

    def test_waiver_comment_silences(self, tmp_path):
        src = dict(_SILENT_THREAD_SRC)
        src["mod.py"] = src["mod.py"].replace(
            "self._t = threading.Thread(target=self._loop, daemon=True)",
            "#: thread: fire-and-forget\n"
            "        self._t = threading.Thread(target=self._loop, daemon=True)",
        )
        assert findings_for(write_tree(tmp_path, src), ("threads",)) == []

    def test_spawn_under_lock_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import threading


                class Box:
                    def __init__(self):
                        self._lock = threading.Lock()

                    def go(self):
                        with self._lock:
                            t = threading.Thread(target=run, daemon=True)
                            t.start()


                def run():
                    try:
                        pass
                    finally:
                        pass
                ''',
            },
        )
        found = findings_for(root, ("threads",))
        assert len(found) == 1
        assert "spawned while holding mod.Box._lock" in found[0].message

    def test_unbounded_shutdown_join_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                class Box:
                    def stop(self):
                        self._t.join()

                    def other(self):
                        self._t.join()  # not a shutdown path: not flagged

                    def fmt(self, xs):
                        return ",".join(xs)  # str.join: not flagged
                ''',
            },
        )
        found = findings_for(root, ("threads",))
        assert len(found) == 1
        assert found[0].line == 3
        assert "without timeout in shutdown path Box.stop" in found[0].message


# ---------------------------------------------------------------- excsafety


class TestExcSafety:
    def test_fd_leak_on_exception_path_fires(self, tmp_path):
        """The historical FileLeaseElector class: os.open, then a fallible
        call, then ownership transfer — the fd leaks if the call raises."""
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import fcntl
                import os


                class Elector:
                    def try_take(self):
                        fd = os.open("/tmp/x", os.O_RDWR)
                        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        self._fd = fd
                        return True
                ''',
            },
        )
        found = findings_for(root, ("excsafety",))
        assert len(found) == 1
        assert found[0].line == 7
        assert "os.open()" in found[0].message and "fcntl.flock" in found[0].message

    def test_except_path_close_passes(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import fcntl
                import os


                class Elector:
                    def try_take(self):
                        fd = os.open("/tmp/x", os.O_RDWR)
                        try:
                            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        except BaseException:
                            os.close(fd)
                            raise
                        self._fd = fd
                        return True
                ''',
            },
        )
        assert findings_for(root, ("excsafety",)) == []

    def test_with_form_and_never_closed(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                def good(path):
                    with open(path) as f:
                        return f.read()


                def bad(path):
                    f = open(path)
                    return None
                ''',
            },
        )
        found = findings_for(root, ("excsafety",))
        assert len(found) == 1
        assert found[0].line == 7
        assert "never closed" in found[0].message

    def test_acquire_without_finally_release(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                class Box:
                    def bad(self):
                        self._lock.acquire()
                        self.work()
                        self._lock.release()

                    def good(self):
                        self._lock.acquire()
                        try:
                            self.work()
                        finally:
                            self._lock.release()
                ''',
            },
        )
        found = findings_for(root, ("excsafety",))
        assert len(found) == 1
        assert found[0].line == 3
        assert "no finally-release" in found[0].message

    def test_prepare_loop_without_compensator(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                class Gang:
                    def gang_prepare_bad(self, pods):
                        for pod in pods:
                            self.plugin.reserve(pod)

                    def gang_prepare_good(self, pods):
                        done = []
                        try:
                            for pod in pods:
                                self.plugin.reserve(pod)
                                done.append(pod)
                        except Exception:
                            for pod in done:
                                self.plugin.unreserve(pod)
                            raise
                ''',
            },
        )
        found = findings_for(root, ("excsafety",))
        assert len(found) == 1
        assert found[0].line == 4
        assert "no compensating unreserve/rollback" in found[0].message


# ----------------------------------------------------------------- protocol


class TestProtocol:
    def test_unhandled_control_type_fires_per_venue(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "engine/journal.py": '''\
                import json


                class StoreJournal:
                    def _apply(self, event):
                        etype = event["type"]
                        if etype == "EPOCH":
                            return

                    def _compact_locked(self):
                        self._file.write(json.dumps({"type": "EPOCH", "epoch": 1}))

                    def emit(self):
                        self._file.write(json.dumps({"type": "GANG", "op": "begin"}))
                ''',
                "engine/replication.py": '''\
                class StandbyReplicator:
                    def _apply_lines(self, data):
                        for event in data:
                            if event.get("type") == "EPOCH":
                                continue
                ''',
            },
        )
        found = findings_for(root, ("protocol",))
        msgs = [f.message for f in found]
        assert any("'GANG'" in m and "_apply" in m for m in msgs)
        assert any("'GANG'" in m and "_apply_lines" in m for m in msgs)
        assert any("'GANG'" in m and "_compact_locked" in m for m in msgs)
        # EPOCH is dispatched everywhere: no finding for it
        assert not any("'EPOCH'" in m for m in msgs)

    def test_ipc_mtype_without_worker_handler_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "sharding/front.py": '''\
                from .ipc import send_frame


                class Front:
                    def send(self, sock, lock):
                        send_frame(sock, lock, "evt", 0, [])
                        send_frame(sock, lock, "zap", 0, [])
                ''',
                "sharding/worker.py": '''\
                def serve(rfile, sock, lock):
                    while True:
                        mtype, rid, body = read_frame(rfile)
                        if mtype == "evt":
                            pass
                ''',
                "sharding/ipc.py": '''\
                def send_frame(sock, lock, mtype, rid, body):
                    pass


                def read_frame(rfile):
                    return None
                ''',
            },
        )
        found = findings_for(root, ("protocol",))
        assert any(
            "'zap'" in f.message and "no worker-side dispatch arm" in f.message
            for f in found
        ), [f.render() for f in found]

    def test_unfenced_durable_write_fires_and_domination_passes(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "engine/journal.py": '''\
                class StoreJournal:
                    def __init__(self):
                        self.fencing = None
                        self._file = None

                    def bad_append(self, line):
                        self._file.write(line)

                    def good_append(self, line):
                        if self.fencing is not None and self.fencing.is_stale():
                            return
                        self._writer()

                    def _writer(self):
                        self._file.write("x")
                ''',
            },
        )
        found = findings_for(root, ("protocol",))
        assert len(found) == 1
        assert found[0].line == 7
        assert "bad_append" in found[0].message
        assert "not dominated by a fencing-epoch check" in found[0].message

    def test_format_registry_coverage_and_stale_rows(self, tmp_path):
        """Planted rolling-upgrade bugs: a sent frame type, an emitted
        journal control type, and a supported snapshot version each
        missing their FORMAT_REGISTRY row, plus one stale row and one
        unknown-domain row — all five must fire."""
        root = write_tree(
            tmp_path,
            {
                "version.py": '''\
                FORMAT_REGISTRY = {
                    "frame:evt": 1,
                    "journal:EPOCH": 1,
                    "snapshot:1": 1,
                    "frame:ghost": 1,
                    "weird:row": 1,
                }
                ''',
                "sharding/ipc.py": '''\
                def send_frame(sock, lock, mtype, rid, body):
                    pass
                ''',
                "sharding/front.py": '''\
                from .ipc import send_frame


                class Front:
                    def send(self, sock, lock):
                        send_frame(sock, lock, "evt", 0, [])
                        send_frame(sock, lock, "zap", 0, [])
                ''',
                "sharding/worker.py": '''\
                def serve(rfile):
                    while True:
                        mtype = read(rfile)
                        if mtype == "evt":
                            pass
                        elif mtype == "zap":
                            pass
                ''',
                "engine/journal.py": '''\
                import json


                class StoreJournal:
                    def _apply(self, event):
                        if event["type"] == "EPOCH":
                            return
                        if event["type"] == "GANG":
                            return

                    def _compact_locked(self):
                        self._file.write(json.dumps({"type": "EPOCH", "epoch": 1}))
                        self._file.write(json.dumps({"type": "GANG", "op": "x"}))
                ''',
                "engine/snapshot.py": '''\
                SUPPORTED_SNAPSHOT_VERSIONS = (1, 2)
                ''',
            },
        )
        found = findings_for(root, ("protocol",))
        msgs = [f.message for f in found]
        assert any("no 'frame:zap' row" in m for m in msgs), msgs
        assert any("no 'journal:GANG' row" in m for m in msgs), msgs
        assert any("no 'snapshot:2' row" in m for m in msgs), msgs
        assert any("'frame:ghost'" in m and "stale" in m for m in msgs), msgs
        assert any("'weird:row'" in m and "unknown domain" in m for m in msgs), msgs
        # declared rows referenced by the code are NOT findings
        assert not any("'frame:evt'" in m for m in msgs), msgs
        assert not any("'journal:EPOCH'" in m for m in msgs), msgs
        assert not any("'snapshot:1'" in m for m in msgs), msgs

    def test_computed_format_registry_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "version.py": '''\
                _ROWS = [("frame:evt", 1)]
                FORMAT_REGISTRY = dict(_ROWS)
                ''',
            },
        )
        found = findings_for(root, ("protocol",))
        assert any(
            "pure dict literal" in f.message and f.line == 2 for f in found
        ), [f.render() for f in found]


# ------------------------------------------------------------- stale waivers


class TestStaleWaivers:
    def test_dead_baseline_waiver_fails_and_prunes(self, tmp_path):
        root = write_tree(tmp_path, {"mod.py": "x = 1\n"})
        baseline = tmp_path / "baseline.txt"
        baseline.write_text(
            "# comment survives\n"
            "guarded|gone.py|read of '_x' outside its lock in G.f  # dead\n"
        )
        rc = analysis_main(
            ["--root", str(root), "--baseline", str(baseline), "-q"]
        )
        assert rc == 1  # stale waiver is an ERROR, not a warning
        rc = analysis_main(
            ["--root", str(root), "--baseline", str(baseline), "--prune-stale", "-q"]
        )
        assert rc == 0
        text = baseline.read_text()
        assert "gone.py" not in text and "# comment survives" in text
        # pruned file is clean on the next run
        assert analysis_main(
            ["--root", str(root), "--baseline", str(baseline), "-q"]
        ) == 0

    def test_dead_blocking_allow_entry_fails_and_prunes(self, tmp_path):
        root = write_tree(tmp_path, {"mod.py": "x = 1\n"})
        baseline = tmp_path / "baseline.txt"
        baseline.write_text("")
        allow = tmp_path / "blocking_allow.txt"
        allow.write_text("mod.Box._lock -> os.fsync()  # dead waiver\n")
        args = [
            "--root", str(root), "--baseline", str(baseline),
            "--blocking-allowlist", str(allow), "-q",
        ]
        assert analysis_main(args) == 1
        assert analysis_main(args + ["--prune-stale"]) == 0
        assert "os.fsync" not in allow.read_text()
        assert analysis_main(args) == 0


# ------------------------------------------------ registry coverage (families)


class TestRegistryCoverage:
    def test_real_known_sites_cover_new_families(self):
        from kube_throttler_tpu_torch.analysis import PACKAGE_ROOT
        from kube_throttler_tpu_torch.analysis.core import load_package
        from kube_throttler_tpu_torch.analysis.registry import _find_module, _literal_str_set

        modules = load_package(PACKAGE_ROOT)
        sites = _literal_str_set(_find_module(modules, "faults/plan.py"), "KNOWN_SITES")
        for expected in (
            "scenario.leader.kill", "shard.ipc.send", "shard.worker.kill",
            "ha.journal.batch", "gang.reserve.partial", "mock.lease",
        ):
            assert expected in sites
        names = _literal_str_set(_find_module(modules, "metrics.py"), "METRIC_NAMES")
        for expected in (
            "kube_throttler_shard_scatter_duration_seconds",
            "kube_throttler_scenario_slo_gate",
        ):
            assert expected in names

    @pytest.mark.parametrize(
        "bad_site",
        [
            "scenario.leader.typo",
            "shard.ipc.typo",
            "ha.journal.typo",
            "gang.reserve.typo",
            "mock.lease2",
        ],
    )
    def test_one_miss_per_family_fires(self, tmp_path, bad_site):
        root = write_tree(
            tmp_path,
            {
                "faults/plan.py": '''\
                KNOWN_SITES = frozenset({
                    "scenario.leader.kill", "shard.ipc.send", "ha.journal.batch",
                    "gang.reserve.partial", "mock.lease",
                })
                ''',
                "metrics.py": "METRIC_NAMES = frozenset({'kube_throttler_shard_up'})\n",
                "mod.py": f'''\
                def f(self):
                    self.faults.check("{bad_site}")
                ''',
            },
        )
        found = findings_for(root, ("registry",))
        assert len(found) == 1
        assert bad_site in found[0].message

    def test_shard_metric_family_miss_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "faults/plan.py": "KNOWN_SITES = frozenset({'mock.lease'})\n",
                "metrics.py": (
                    "METRIC_NAMES = frozenset({"
                    "'kube_throttler_shard_up', 'kube_throttler_scenario_slo_gate'})\n"
                ),
                "mod.py": '''\
                def setup(registry):
                    registry.gauge_vec("kube_throttler_shard_up", "h", ["a"])
                    registry.gauge_vec("kube_throttler_shard_upp", "h", ["a"])
                ''',
            },
        )
        found = findings_for(root, ("registry",))
        assert len(found) == 1
        assert "kube_throttler_shard_upp" in found[0].message


# --------------------------------------------------- gen-3: dtype (device.py)


class TestDtype:
    def _tree(self, body):
        return {
            "ops/schema.py": '''\
            INT64_MILLI_PLANES = frozenset({"thr_req", "used_req", "req", "pod_req"})
            ''',
            "ops/mod.py": body,
        }

    def test_narrowing_astype_fires_with_line(self, tmp_path):
        root = write_tree(
            tmp_path,
            self._tree(
                '''\
                import jax.numpy as jnp


                def f(state):
                    ok = state.thr_req + 1
                    return state.used_req.astype(jnp.int32)
                '''
            ),
        )
        found = findings_for(root, ("dtype",))
        assert len(found) == 1
        f = found[0]
        assert f.relpath == "ops/mod.py" and f.line == 6
        assert "used_req" in f.message and "int32" in f.message

    def test_comparison_mask_cast_is_legal(self, tmp_path):
        # (req != 0).astype(int32) is a bool mask — the Compare subtree
        # must not taint the cast (the pallas limb-split idiom)
        root = write_tree(
            tmp_path,
            self._tree(
                '''\
                import jax.numpy as jnp


                def f(pods):
                    return (pods.req != 0).astype(jnp.int32)
                '''
            ),
        )
        assert findings_for(root, ("dtype",)) == []

    def test_narrow_reduction_accumulator_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            self._tree(
                '''\
                import jax.numpy as jnp


                def f(state, m):
                    good = jnp.sum(m == 1, axis=1, dtype=jnp.int32)
                    return jnp.sum(state.thr_req, axis=1, dtype=jnp.int32)
                '''
            ),
        )
        found = findings_for(root, ("dtype",))
        assert [f.line for f in found] == [6]
        assert "thr_req" in found[0].message and "accumulator" in found[0].message

    def test_default_dtype_allocation_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            self._tree(
                '''\
                import numpy as np


                class KS:
                    def grow(self, t, r):
                        self.pod_req = np.zeros((t, r))
                        self.pod_present = np.zeros((t, r))
                        self.other = np.zeros((t, r))
                '''
            ),
        )
        found = findings_for(root, ("dtype",))
        assert [f.line for f in found] == [6]
        assert "pod_req" in found[0].message

    def test_out_of_scope_modules_ignored(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "ops/schema.py": 'INT64_MILLI_PLANES = frozenset({"req"})\n',
                "client/mod.py": '''\
                import jax.numpy as jnp


                def f(x):
                    return x.req.astype(jnp.int32)
                ''',
            },
        )
        assert findings_for(root, ("dtype",)) == []


# ------------------------------------------------ gen-3: envguard (envguard.py)


class TestEnvGuard:
    def test_unguarded_parse_fires_with_line(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import os

                CHUNK = int(os.environ.get("KT_CHUNK", "64"))
                ''',
            },
        )
        found = findings_for(root, ("envguard",))
        assert len(found) == 1
        f = found[0]
        assert f.line == 3 and "KT_CHUNK" in f.message

    def test_guarded_parse_is_clean(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import os

                try:
                    CHUNK = int(os.environ.get("KT_CHUNK", "64"))
                except ValueError:
                    CHUNK = 64
                ''',
            },
        )
        assert findings_for(root, ("envguard",)) == []

    def test_non_kt_knobs_ignored(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import os

                PORT = int(os.environ.get("HTTP_PORT", "80"))
                ''',
            },
        )
        assert findings_for(root, ("envguard",)) == []

    def test_subscript_and_getenv_forms(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "mod.py": '''\
                import os

                A = float(os.getenv("KT_A", "1.5"))
                B = int(os.environ["KT_B"])
                ''',
            },
        )
        found = findings_for(root, ("envguard",))
        assert [f.line for f in found] == [3, 4]

    def test_real_bug_class_is_guarded_in_tree(self):
        # the _GATHER_CHUNK_ELEMS class: the repo-wide gate
        # (0 envguard findings) plus these two spot checks on the knobs
        # the class was named after
        import kube_throttler_tpu_torch.ops.check_gather as check

        assert check._GATHER_CHUNK_ELEMS == 64 * 1024 * 1024
        new, _, _ = run_repo(checks=("envguard",))
        assert new == []


# ---------------------------------------------------------------- epochs


class TestEpochs:
    def _run(self, root, allow=None, stale_out=None):
        return checked_run(root, ("epochs",), epoch_allowlist_path=allow, stale_allow_out=stale_out)

    def test_undominated_write_fires_with_line(self, tmp_path):
        """The registry is read from the fixture's own schema.py AST
        (the frozenset(...) wrapper unwraps) — ``custom_plane`` is not in
        the checker's fallback set, so a finding naming it proves the
        declared registry (not the fallback) is enforced."""
        root = write_tree(
            tmp_path,
            {
                "ops/schema.py": '''\
                VERDICT_EPOCH_PLANES = frozenset(
                    {
                        "thr_cnt",
                        "custom_plane",
                    }
                )
                ''',
                "engine/state.py": '''\
                class Arena:
                    def __init__(self):
                        self.thr_cnt = {}
                        self.custom_plane = {}
                        self.col_epoch = {}

                    def bumped(self, col):
                        self.thr_cnt[col] = 1
                        self.col_epoch[col] = 1

                    def missing(self, col):
                        self.thr_cnt[col] = 2
                        self.custom_plane[col] = 3
                ''',
            },
        )
        found = self._run(root)
        assert [(f.relpath, f.line) for f in found] == [
            ("engine/state.py", 12),
            ("engine/state.py", 13),
        ]
        assert "'thr_cnt'" in found[0].message
        assert "Arena.missing" in found[0].message
        assert "'custom_plane'" in found[1].message

    def test_interprocedural_domination_to_fixpoint(self, tmp_path):
        """A bump in EVERY caller dominates the writing helper; one
        rogue caller breaks the proof and the finding lands on the
        write site."""
        root = write_tree(
            tmp_path / "clean",
            {
                "engine/state.py": '''\
                class Arena:
                    def __init__(self):
                        self.thr_cnt = {}
                        self.col_epoch = {}

                    def _store(self, col):
                        self.thr_cnt[col] = 1

                    def commit(self, col):
                        self._store(col)
                        self.col_epoch[col] += 1
                ''',
            },
        )
        assert self._run(root) == []

        root = write_tree(
            tmp_path / "rogue",
            {
                "engine/state.py": '''\
                class Arena:
                    def __init__(self):
                        self.thr_cnt = {}
                        self.col_epoch = {}

                    def _store(self, col):
                        self.thr_cnt[col] = 1

                    def commit(self, col):
                        self._store(col)
                        self.col_epoch[col] += 1

                    def rogue(self, col):
                        self._store(col)
                ''',
            },
        )
        found = self._run(root)
        assert [(f.relpath, f.line) for f in found] == [("engine/state.py", 7)]
        assert "Arena._store" in found[0].message

    def test_inline_annotation_dominates(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "engine/state.py": '''\
                class Arena:
                    def __init__(self):
                        self.thr_cnt = {}

                    def flip(self, col):  #: epoch-bumps: batch commit bumps after the sweep
                        self.thr_cnt[col] = 1
                ''',
            },
        )
        assert self._run(root) == []

    def test_string_literal_plane_and_mutating_call(self, tmp_path):
        """The getattr-named row-encode shape: a covered plane name as a
        string literal at a call site IS the write; so is a mutating
        container call on the plane attribute."""
        root = write_tree(
            tmp_path,
            {
                "engine/state.py": '''\
                class Arena:
                    def __init__(self):
                        self.thr_cnt = {}

                    def route(self, col):
                        self._amount_into_row("thr_cnt", col)

                    def wipe(self):
                        self.thr_cnt.clear()
                ''',
            },
        )
        found = self._run(root)
        assert [(f.line, "Arena.route" in f.message) for f in found[:1]] == [(6, True)]
        assert [(f.line, "Arena.wipe" in f.message) for f in found[1:]] == [(9, True)]

    def test_local_rebind_is_not_a_plane_write(self, tmp_path):
        """A bare ``thr_cnt = {}`` binds a local (the snapshot-export
        shape); only subscript stores through the name count."""
        root = write_tree(
            tmp_path,
            {
                "engine/state.py": '''\
                class Arena:
                    def export(self):
                        thr_cnt = {}
                        thr_cnt[0] = 1
                        return thr_cnt
                ''',
            },
        )
        found = self._run(root)
        assert [f.line for f in found] == [4]  # the subscript store only

    def test_out_of_scope_ignored(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "scenarios/state.py": '''\
                class Arena:
                    def missing(self, col):
                        self.thr_cnt[col] = 2
                ''',
            },
        )
        assert self._run(root) == []

    def test_allow_roundtrip_and_stale_report(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "engine/state.py": '''\
                class Arena:
                    def missing(self, col):
                        self.thr_cnt[col] = 2
                ''',
            },
        )
        allow = tmp_path / "epoch_allow.txt"
        allow.write_text(
            "engine.state.Arena.missing -> thr_cnt  # growth zero-fill only\n"
            "engine.state.Gone.f -> thr_cnt  # dead entry\n"
        )
        stale_out = {}
        assert self._run(root, allow=str(allow), stale_out=stale_out) == []
        assert stale_out["epochs"] == [("engine.state.Gone.f", "thr_cnt")]

    def test_cli_stale_epoch_waiver_fails_and_prunes(self, tmp_path):
        root = write_tree(tmp_path, {"mod.py": "x = 1\n"})
        baseline = tmp_path / "baseline.txt"
        baseline.write_text("")
        allow = tmp_path / "epoch_allow.txt"
        allow.write_text(
            "# vetted epoch-bump exceptions\n"
            "engine.gone.Arena.f -> thr_cnt  # dead waiver\n"
        )
        args = [
            "--root", str(root), "--baseline", str(baseline),
            "--epoch-allowlist", str(allow), "-q",
        ]
        assert analysis_main(args) == 1
        assert analysis_main(args + ["--prune-stale"]) == 0
        text = allow.read_text()
        assert "Arena.f" not in text and "# vetted" in text
        assert analysis_main(args) == 0

    def test_repo_registry_and_domination_proof(self):
        """The real registry parses out of ops/schema.py (no silent
        fallback) and every covered write in the tree is dominated —
        zero findings with a zero-entry allow file is the PR's
        machine-checked coherence proof for the verdict cache."""
        from kube_throttler_tpu_torch.analysis import PACKAGE_ROOT
        from kube_throttler_tpu_torch.analysis.epochs import (
            _FALLBACK_PLANES,
            load_planes,
        )
        from kube_throttler_tpu_torch.ops import schema

        planes = load_planes(load_package(PACKAGE_ROOT))
        assert planes == set(schema.VERDICT_EPOCH_PLANES)
        assert planes > set(_FALLBACK_PLANES)  # registry, not fallback
        stale_out = {}
        new, _, _ = run_repo(checks=("epochs",), stale_allow_out=stale_out)
        assert new == [], "\n".join(f.render() for f in new)
        assert stale_out["epochs"] == []


# ------------------------------------------------------------- deadlines


class TestDeadlines:
    def _run(self, root, allow=None, stale_out=None):
        return checked_run(root, ("deadlines",), deadline_allowlist_path=allow, stale_allow_out=stale_out)

    def test_deadline_less_ops_fire_with_lines(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "sharding/net.py": '''\
                import socket


                class Client:
                    def dial(self, host):
                        return socket.create_connection((host, 9))

                    def pump(self, sock):
                        return sock.recv(4096)

                    def rpc(self, fut):
                        return fut.result()

                    def halt(self, thr):
                        thr.join()

                    def wait_up(self, ev):
                        ev.wait()
                ''',
            },
        )
        found = self._run(root)
        got = [(f.line, f.message.split(" on the")[0]) for f in found]
        assert got == [
            (6, "deadline-less create_connection()"),
            (9, "deadline-less .recv()"),
            (12, "deadline-less .result()"),
            (15, "deadline-less .join()"),
            (18, "deadline-less .wait()"),
        ]
        assert all("Client." in f.message for f in found)

    def test_bounded_ops_are_clean(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "sharding/net.py": '''\
                import socket


                class Client:
                    def dial(self, host):
                        return socket.create_connection((host, 9), timeout=3.0)

                    def pump(self, sock):
                        sock.settimeout(2.0)
                        return sock.recv(4096)

                    def rpc(self, fut):
                        return fut.result(timeout=1.0)

                    def halt(self, thr):
                        thr.join(2.0)

                    def wait_up(self, ev):
                        return ev.wait(0.5)

                    def render(self, xs):
                        return ",".join(xs)
                ''',
            },
        )
        assert self._run(root) == []

    def test_explicit_timeout_none_still_fires(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "sharding/net.py": '''\
                class Client:
                    def rpc(self, fut):
                        return fut.result(timeout=None)

                    def wait_up(self, ev):
                        ev.wait(None)
                ''',
            },
        )
        assert [f.line for f in self._run(root)] == [3, 6]

    def test_reachability_pulls_in_out_of_scope_helper(self, tmp_path):
        """An unbounded recv in a helper OUTSIDE the transport scope is
        flagged when a transport function reaches it — and silent when
        nothing in scope calls it."""
        helper = {
            "util/io.py": '''\
            def drain(sock):
                return sock.recv(1)
            ''',
        }
        root = write_tree(tmp_path / "unreached", dict(helper))
        assert self._run(root) == []

        reached = dict(helper)
        reached["sharding/net.py"] = '''\
        from util.io import drain


        def pump(sock):
            return drain(sock)
        '''
        root = write_tree(tmp_path / "reached", reached)
        found = self._run(root)
        assert [(f.relpath, f.line) for f in found] == [("util/io.py", 2)]
        assert "io.drain" in found[0].message

    def test_allow_roundtrip_and_stale_report(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "sharding/net.py": '''\
                class Client:
                    def rpc(self, fut):
                        return fut.result()
                ''',
            },
        )
        allow = tmp_path / "deadline_allow.txt"
        allow.write_text(
            "sharding.net.Client.rpc -> .result()  # bounded by the task deadline\n"
            "sharding.net.Gone.f -> .wait()  # dead entry\n"
        )
        stale_out = {}
        assert self._run(root, allow=str(allow), stale_out=stale_out) == []
        assert stale_out["deadlines"] == [("sharding.net.Gone.f", ".wait()")]

    def test_cli_stale_deadline_waiver_fails_and_prunes(self, tmp_path):
        root = write_tree(tmp_path, {"mod.py": "x = 1\n"})
        baseline = tmp_path / "baseline.txt"
        baseline.write_text("")
        allow = tmp_path / "deadline_allow.txt"
        allow.write_text("sharding.gone.C.f -> .recv()  # dead waiver\n")
        args = [
            "--root", str(root), "--baseline", str(baseline),
            "--deadline-allowlist", str(allow), "-q",
        ]
        assert analysis_main(args) == 1
        assert analysis_main(args + ["--prune-stale"]) == 0
        assert ".recv()" not in allow.read_text()
        assert analysis_main(args) == 0

    def test_repo_transport_is_deadline_disciplined(self):
        """Every blocking op reachable from the sharding transport
        surface carries a bound; the one vetted exception
        (AdmissionFront._scatter's .result(), bounded by the per-op RPC
        deadline inside the task) is allow-filed and still live."""
        stale_out = {}
        new, _, _ = run_repo(checks=("deadlines",), stale_allow_out=stale_out)
        assert new == [], "\n".join(f.render() for f in new)
        assert stale_out["deadlines"] == []
        from kube_throttler_tpu_torch.analysis import DEFAULT_DEADLINE_ALLOWLIST
        from kube_throttler_tpu_torch.analysis.core import load_pair_allowlist

        allow = load_pair_allowlist(DEFAULT_DEADLINE_ALLOWLIST)
        assert ("sharding.front.AdmissionFront._scatter", ".result()") in allow


# ----------------------------------------------------------------- taint


class TestTaint:
    def test_unauthenticated_pickle_of_recv_bytes(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "sharding/wire.py": '''\
                import pickle


                def ingest(sock):
                    data = sock.recv(65536)
                    return pickle.loads(data)
                ''',
            },
        )
        found = findings_for(root, ("taint",))
        assert [(f.relpath, f.line) for f in found] == [("sharding/wire.py", 6)]
        assert found[0].message == (
            "unauthenticated pickle.loads of network bytes "
            "(no hmac.compare_digest gate in ingest)"
        )

    def test_compare_digest_gate_satisfies(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "sharding/wire.py": '''\
                import hmac
                import pickle


                def read_frame(rfile):
                    payload = rfile.read(100)
                    tag = rfile.read(32)
                    if not hmac.compare_digest(tag, b"x" * 32):
                        raise ValueError("bad tag")
                    return pickle.loads(payload)
                ''',
            },
        )
        assert findings_for(root, ("taint",)) == []

    def test_ungated_pickle_is_a_bypass_even_untainted(self, tmp_path):
        """pickle.loads of bytes the checker can't trace to the network
        is still a new ingestion point inside the transport scope."""
        root = write_tree(
            tmp_path,
            {
                "sharding/wire.py": '''\
                import pickle


                def restore(blob):
                    return pickle.loads(blob)
                ''',
            },
        )
        found = findings_for(root, ("taint",))
        assert [f.line for f in found] == [5]
        assert "bypasses the authenticated framing layer" in found[0].message
        assert "(in restore)" in found[0].message

    def test_json_flagged_only_when_tainted(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "sharding/wire.py": '''\
                import json


                def parse(sock):
                    raw = sock.recv(4096)
                    return json.loads(raw)


                def config(text):
                    return json.loads(text)
                ''',
            },
        )
        found = findings_for(root, ("taint",))
        assert [f.line for f in found] == [6]
        assert "unauthenticated json.loads" in found[0].message

    def test_taint_flows_through_params_and_tuples(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "engine/replication.py": '''\
                import pickle


                class Applier:
                    def handle(self, rfile):
                        head, body = rfile.read(4), rfile.read(10)
                        return pickle.loads(body)
                ''',
            },
        )
        found = findings_for(root, ("taint",))
        assert [(f.relpath, f.line) for f in found] == [("engine/replication.py", 7)]
        assert "gate in Applier.handle" in found[0].message

    def test_out_of_scope_ignored(self, tmp_path):
        root = write_tree(
            tmp_path,
            {
                "plugin/wire.py": '''\
                import pickle


                def ingest(sock):
                    return pickle.loads(sock.recv(65536))
                ''',
            },
        )
        assert findings_for(root, ("taint",)) == []

    def test_repo_boundary_holds(self):
        """read_frame stays the only ingestion point: the repo's taint
        run is clean modulo the one baseline-waived local-bytes pickle
        (the reshard import path), which must still be live."""
        new, waived, _ = run_repo(checks=("taint",))
        assert new == [], "\n".join(f.render() for f in new)
        assert any(f.checker == "taint" for f in waived)
