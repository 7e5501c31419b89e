"""Leader-election lease: exclusion, handoff, crash release — flock backend
(single host) and the coordination.k8s.io Lease backend over the apiserver
(multi-host, client-go leaderelection semantics).

The reference gets leader election from the embedded kube-scheduler's
``leaderElection`` config (a Lease on the apiserver); the standalone
analogs live in utils/leaderelect.py."""

import os
import subprocess
import sys
import threading
import time

import pytest

from kube_throttler_tpu_torch.utils.leaderelect import (
    FileLeaseElector,
    HttpLeaseElector,
    default_lease_path,
)
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


def test_exclusion_and_handoff(tmp_path):
    lock = str(tmp_path / "lease.lock")
    a = FileLeaseElector(lock, retry_period=0.05)
    b = FileLeaseElector(lock, retry_period=0.05)

    assert a.try_acquire() and a.is_leader
    assert not b.try_acquire() and not b.is_leader

    # b blocks until a releases
    acquired = threading.Event()
    t = threading.Thread(target=lambda: (b.acquire(), acquired.set()), daemon=True)
    t.start()
    time.sleep(0.15)
    assert not acquired.is_set()
    a.release()
    assert acquired.wait(2.0) and b.is_leader
    b.release()


def test_acquire_interruptible(tmp_path):
    lock = str(tmp_path / "lease.lock")
    holder = FileLeaseElector(lock)
    assert holder.try_acquire()
    stop = threading.Event()
    standby = FileLeaseElector(lock, retry_period=0.05)
    result = {}
    t = threading.Thread(target=lambda: result.setdefault("r", standby.acquire(stop)), daemon=True)
    t.start()
    stop.set()
    t.join(2.0)
    assert result["r"] is False and not standby.is_leader
    holder.release()


def test_crashed_leader_frees_lease(tmp_path):
    """flock is released by the OS when the holder dies — the standby takes
    over without manual cleanup (crash-only stance)."""
    lock = str(tmp_path / "lease.lock")
    holder = subprocess.Popen(
        [
            sys.executable,
            "-c",
            "import fcntl, os, sys, time\n"
            f"fd = os.open({lock!r}, os.O_CREAT | os.O_RDWR)\n"
            "fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)\n"
            "print('locked', flush=True)\n"
            "time.sleep(30)\n",
        ],
        stdout=subprocess.PIPE,
    )
    assert holder.stdout.readline().strip() == b"locked"
    standby = FileLeaseElector(lock, retry_period=0.05)
    assert not standby.try_acquire()
    holder.kill()
    holder.wait()
    deadline = time.time() + 5
    while time.time() < deadline and not standby.try_acquire():
        time.sleep(0.05)
    assert standby.is_leader
    standby.release()


def test_default_lease_path_is_private(tmp_path, monkeypatch):
    """No world-writable /tmp: the default lease lives in a 0700 per-user
    runtime dir (ADVICE r2 item 1), and the open refuses symlinks."""
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))
    path = default_lease_path("kt")
    assert path.startswith(str(tmp_path))
    d = os.path.dirname(path)
    assert (os.stat(d).st_mode & 0o777) == 0o700

    # symlink squatting is refused (O_NOFOLLOW)
    target = tmp_path / "evil-target"
    target.write_text("")
    os.symlink(target, path)
    with pytest.raises(RuntimeError):
        FileLeaseElector(path).try_acquire()


class TestHttpLeaseElector:
    @pytest.fixture()
    def apiserver(self):
        from kube_throttler_tpu_torch.client.mockserver import MockApiServer

        server = MockApiServer()
        server.start()
        yield server
        server.stop()

    def _elector(self, apiserver, identity, **kw):
        from kube_throttler_tpu_torch.client.transport import ApiClient, RestConfig

        # generous margins: the renewer must never miss a whole
        # lease_duration under CI load, or tests flake
        kw.setdefault("lease_duration", 1.5)
        kw.setdefault("renew_period", 0.2)
        kw.setdefault("retry_period", 0.05)
        return HttpLeaseElector(
            ApiClient(RestConfig(server=apiserver.url)),
            name="kt",
            identity=identity,
            **kw,
        )

    def test_exclusion_and_clean_handoff(self, apiserver):
        a = self._elector(apiserver, "replica-a")
        b = self._elector(apiserver, "replica-b")
        assert a.try_acquire() and a.is_leader
        assert not b.try_acquire() and not b.is_leader

        acquired = threading.Event()
        t = threading.Thread(
            target=lambda: (b.acquire(), acquired.set()), daemon=True
        )
        t.start()
        time.sleep(0.15)
        assert not acquired.is_set()
        a.release()  # clean handoff: holder zeroed, standby takes over fast
        assert acquired.wait(5.0) and b.is_leader
        b.release()

    def test_failover_on_expired_lease(self, apiserver):
        """A crashed leader (renewer stopped, no release) is taken over once
        renewTime goes stale — two 'daemons', shared control plane, no
        shared filesystem: the multi-host scenario."""
        a = self._elector(apiserver, "replica-a")
        assert a.acquire()
        a._stop.set()  # simulate crash: stop renewing WITHOUT releasing
        a._renewer.join(timeout=2)

        b = self._elector(apiserver, "replica-b")
        assert not b.try_acquire()  # lease still fresh
        deadline = time.time() + 5
        while time.time() < deadline and not b.try_acquire():
            time.sleep(0.05)
        assert b.is_leader
        b.release()

    def test_renew_failure_demotes_before_standby_takeover(self, apiserver):
        """A leader that cannot reach the apiserver must demote (on_lost)
        within renew_deadline — strictly BEFORE a standby's lease_duration
        takeover clock expires, so two replicas never both lead."""
        lost = threading.Event()
        a = self._elector(apiserver, "replica-a")
        a.on_lost = lost.set
        assert a.acquire()
        # sever connectivity: point the client at a dead port
        from kube_throttler_tpu_torch.client.transport import ApiClient, RestConfig

        a.client = ApiClient(RestConfig(server="http://127.0.0.1:1"), timeout=0.2)
        assert lost.wait(5.0)
        assert not a.is_leader
        # the standby takes over after lease_duration
        b = self._elector(apiserver, "replica-b")
        deadline = time.time() + 5
        while time.time() < deadline and not b.try_acquire():
            time.sleep(0.05)
        assert b.is_leader
        b.release()

    def test_renewal_keeps_standby_out(self, apiserver):
        a = self._elector(apiserver, "replica-a")
        assert a.acquire()
        b = self._elector(apiserver, "replica-b")
        # well past lease_duration: the renewer must have kept it fresh
        time.sleep(2.0)
        assert not b.try_acquire()
        assert a.is_leader
        a.release()


class TestTwoDaemonFailover:
    def test_two_daemons_fail_over_through_the_shared_apiserver(self, tmp_path):
        """End to end: two REAL daemon
        processes (separate workdirs, no shared filesystem state) compete
        for the Lease on a shared apiserver; the standby only starts
        serving after the leader dies."""
        import re
        import subprocess
        import sys as _sys

        from kube_throttler_tpu_torch.client.mockserver import MockApiServer
        from kube_throttler_tpu_torch.api.pod import Namespace

        apiserver = MockApiServer()
        apiserver.store.create_namespace(Namespace("default"))
        apiserver.start()
        kubeconfig = tmp_path / "kubeconfig"
        kubeconfig.write_text(
            f"clusters:\n- name: m\n  cluster: {{server: \"{apiserver.url}\"}}\n"
            "contexts:\n- name: m\n  context: {cluster: m}\ncurrent-context: m\n"
        )

        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

        def launch(workdir):
            workdir.mkdir()
            env = dict(os.environ)
            env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
            return subprocess.Popen(
                [
                    _sys.executable, "-m", "kube_throttler_tpu_torch.cli", "serve", "--device", "cpu",
                    "--name", "kube-throttler",
                    "--target-scheduler-name", "my-scheduler",
                    "--kubeconfig", str(kubeconfig), "--leader-elect",
                    "--port", "0", "--no-device",
                ],
                cwd=workdir,  # separate workdirs: nothing shared but the apiserver
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )

        from tests.conftest import ProcReader

        a = b = None
        try:
            a = launch(tmp_path / "daemon-a")
            ra = ProcReader(a)
            ra.wait_for(r"serving on")  # A acquired and serves

            b = launch(tmp_path / "daemon-b")
            rb = ProcReader(b)
            rb.wait_for(r"waiting")
            # mutual exclusion: B must NOT start serving while A holds the
            # lease (keep draining — a vacuous check on already-seen lines
            # would pass even if both replicas acquired)
            rb.assert_absent(r"serving on", during_s=3.0)

            a.kill()  # crash, no release — failover must come from expiry
            a.wait(timeout=10)
            # default leaseDuration is 15s; B takes over after expiry
            rb.wait_for(r"serving on", timeout_s=60)
        finally:
            for p in (a, b):
                if p is not None:
                    p.kill()
                    p.wait(timeout=10)
            apiserver.stop()


def test_cli_wires_leader_election(tmp_path, monkeypatch):
    """`serve --leader-elect` blocks behind a held lease and starts once it
    frees (driven via SIGINT→stop to keep the test fast)."""
    lock = str(tmp_path / "cli.lock")
    holder = FileLeaseElector(lock)
    assert holder.try_acquire()

    from kube_throttler_tpu_torch import cli

    rc = {}

    def run():
        rc["v"] = cli.main(
            [
                "serve", "--device", "cpu",
                "--name", "kt", "--target-scheduler-name", "s",
                "--leader-elect", "--lock-file", lock,
                "--no-device", "--nodes", "0", "--port", "0",
            ]
        )

    # signal.signal only works on the main thread — stub it and capture the
    # stop event the CLI creates
    events = []
    real_event = threading.Event

    class CapturingEvent(real_event):
        def __init__(self):
            super().__init__()
            events.append(self)

    monkeypatch.setattr(cli.signal, "signal", lambda *a, **k: None)
    monkeypatch.setattr(cli.threading, "Event", CapturingEvent)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.3)
    assert t.is_alive() and rc == {}  # standing by behind the held lease
    # the monkeypatch covers the global threading module, so other
    # components' Events are captured too — fire them all ("SIGINT")
    for ev in list(events):
        ev.set()
    t.join(5.0)
    assert rc["v"] == 0  # clean exit without ever serving
    holder.release()
