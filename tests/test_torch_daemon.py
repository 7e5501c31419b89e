"""The daemon as a whole: the port's ``serve --device cpu`` answers the HTTP
surface exactly as the JAX package's daemon does.

Both daemons run ``cli.main`` in threads of this process, as
``test_leaderelect.py`` runs the reference's (``signal.signal`` works only
on the main thread, so it is replaced by a recorder and the recorded
SIGTERM handler stops each daemon). They get the same seeded cluster
(``tests/torch_daemon_cases.py``) and the same HTTP sequence: objects,
``/v1/prefilter`` for every pod, ``/v1/prefilter-batch``,
``/v1/tick {"devices": 1}``, reserve, unreserve and bind. Every response
must be equal. Both then restart from their ``--data-dir`` and must again
answer alike, with equal recovery reports; and each recovers the data dir
that the other package wrote to the same answers.

Also here: ``serve --shards 2 --device cpu`` (a front and two worker
processes) against the reference's ``serve --shards 2``; the CLI's guards
(``--device cuda`` without a card, with and without ``--shards``, and
``--shards`` with ``--nodes``) and ``version``.
"""

import json
import shutil
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import kube_throttler_tpu.cli as jcli
import kube_throttler_tpu_torch.cli as tcli

from tests.torch_daemon_cases import SCHEDULER, THROTTLER, manifests, pod_keys
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)

SERVE = ["serve", "--name", THROTTLER, "--target-scheduler-name", SCHEDULER,
         "--port", "0"]
PORT_SERVE = SERVE + ["--device", "cpu"]
# fields of the recovery report that measure time, not state
TIMED = ("durationSeconds", "snapshotAgeSeconds")


class _Daemons:
    """Runs either package's ``cli.main`` in threads. Records each thread's
    SIGTERM handler and HTTP server, so a test can find a daemon's port
    and stop it as SIGTERM would."""

    def __init__(self, monkeypatch):
        self.handlers = {}
        self.servers = {}

        def record_signal(signum, handler):
            if signum == signal.SIGTERM:
                self.handlers[threading.current_thread()] = handler

        monkeypatch.setattr(signal, "signal", record_signal)
        # a frozen heap would outlive the daemon in this test process
        monkeypatch.setenv("KT_GC_FREEZE", "0")
        servers = self.servers
        for mod in (jcli, tcli):

            class Recording(mod.ThrottlerHTTPServer):
                def __init__(self, *args, **kwargs):
                    super().__init__(*args, **kwargs)
                    servers[threading.current_thread()] = self

            monkeypatch.setattr(mod, "ThrottlerHTTPServer", Recording)

    def start(self, mod, argv, timeout_s=180.0):
        rc = {}
        thread = threading.Thread(
            target=lambda: rc.setdefault("rc", mod.main(argv)), daemon=True
        )
        thread.start()
        deadline = time.monotonic() + timeout_s
        while thread not in self.servers:
            assert thread.is_alive(), f"daemon exited before serving: {rc}"
            assert time.monotonic() < deadline, "daemon did not start serving"
            time.sleep(0.05)
        port = self.servers[thread].port
        while _call(port, "GET", "/readyz")[0] != 200:
            assert time.monotonic() < deadline, "daemon never became ready"
            time.sleep(0.05)
        return thread, port, rc

    def stop(self, daemon):
        thread, _, rc = daemon
        self.handlers[thread](signal.SIGTERM, None)
        thread.join(60.0)
        assert not thread.is_alive()
        assert rc == {"rc": 0}


def _call(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _statuses(port):
    out = []
    for path in ("/v1/throttles", "/v1/clusterthrottles"):
        _, items = _call(port, "GET", path)
        for item in items:
            item["status"]["calculatedThreshold"].pop("calculatedAt")
        out.append(sorted(items, key=lambda t: (
            t["metadata"].get("namespace", ""), t["metadata"]["name"])))
    return out


def _settle(port, timeout_s=60.0):
    """The written statuses once the controllers are idle: empty
    workqueues and the same statuses on three reads in a row."""
    deadline = time.monotonic() + timeout_s
    last, stable = None, 0
    while stable < 3:
        assert time.monotonic() < deadline, "controllers did not settle"
        _, ready = _call(port, "GET", "/readyz")
        cur = _statuses(port)
        idle = not any(ready["workqueues"].values())
        stable = stable + 1 if (idle and cur == last) else 0
        last = cur
        time.sleep(0.05)
    return last


def _reads(port, docs):
    """Every read of the admission surface: each pod's PreFilter, the
    batch triage and the tick on one device."""
    out = [("prefilter", key, _call(port, "POST", "/v1/prefilter", {"podKey": key}))
           for key in pod_keys(docs)]
    out.append(("batch", _call(port, "POST", "/v1/prefilter-batch", {})))
    out.append(("tick", _call(port, "POST", "/v1/tick", {"devices": 1})))
    return out


def _sequence(port, docs):
    out = [("apply", _call(port, "POST", "/v1/objects", d)) for d in docs]
    out.append(("statuses", _settle(port)))
    out += _reads(port, docs)
    pending = pod_keys(docs, pending_only=True)
    for key in pending[:10]:
        out.append(("reserve", key, _call(port, "POST", "/v1/reserve", {"podKey": key})))
    out += [("prefilter", key, _call(port, "POST", "/v1/prefilter", {"podKey": key}))
            for key in pending]
    out.append(("unreserve", _call(port, "POST", "/v1/unreserve", {"podKey": pending[0]})))
    out.append(("bind", _call(port, "POST", "/v1/bind",
                              {"podKey": pending[1], "nodeName": "node-2"})))
    out.append(("statuses", _settle(port)))
    out += _reads(port, docs)
    return out


def _recovery(port):
    _, ready = _call(port, "GET", "/readyz")
    report = dict(ready["components"]["recovery"])
    for key in TIMED:
        report.pop(key)
    return report


def test_port_daemon_answers_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    daemons = _Daemons(monkeypatch)
    docs = manifests(seed=0)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"

    ref = daemons.start(jcli, SERVE + ["--data-dir", str(jdir)])
    port = daemons.start(tcli, PORT_SERVE + ["--data-dir", str(tdir)])
    want = _sequence(ref[1], docs)
    got = _sequence(port[1], docs)
    assert got == want
    # the cluster is neither all schedulable nor all blocked
    batch = dict((r[0], r[-1]) for r in got)["batch"][1]["schedulable"]
    assert set(batch.values()) == {True, False}
    final_reads = _reads(ref[1], docs)
    daemons.stop(ref)
    daemons.stop(port)

    # each package's data dir, as its daemon left it, for the other
    shutil.copytree(jdir, tmp_path / "jax-for-torch")
    shutil.copytree(tdir, tmp_path / "torch-for-jax")

    ref = daemons.start(jcli, SERVE + ["--data-dir", str(jdir)])
    port = daemons.start(tcli, PORT_SERVE + ["--data-dir", str(tdir)])
    assert _recovery(port[1]) == _recovery(ref[1])
    assert _recovery(port[1])["reservationsRestored"] > 0
    assert _reads(port[1], docs) == _reads(ref[1], docs) == final_reads
    daemons.stop(ref)
    daemons.stop(port)

    port = daemons.start(tcli, PORT_SERVE + ["--data-dir", str(tmp_path / "jax-for-torch")])
    ref = daemons.start(jcli, SERVE + ["--data-dir", str(tmp_path / "torch-for-jax")])
    assert _recovery(port[1]) == _recovery(ref[1])
    assert _reads(port[1], docs) == _reads(ref[1], docs) == final_reads
    daemons.stop(port)
    daemons.stop(ref)


def test_serve_without_a_card_exits_before_serving(monkeypatch, capsys):
    """``--device`` defaults to ``cuda``: without a card the daemon exits
    non-zero with the CUDA message, and neither the plugin nor the server
    is built."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def never(*args, **kwargs):
        raise AssertionError("nothing may be built without a device")

    monkeypatch.setattr(signal, "signal", lambda *a, **k: None)
    monkeypatch.setattr(tcli, "KubeThrottler", never)
    monkeypatch.setattr(tcli, "ThrottlerHTTPServer", never)
    assert tcli.main(SERVE) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert tcli.main(SERVE + ["--device", "cuda"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_shards_is_a_usage_error(capsys):
    """``--shards`` runs the standalone sharded store; what it cannot be
    combined with is a usage error, as in the reference."""
    with pytest.raises(SystemExit) as e:
        tcli.main(PORT_SERVE + ["--shards", "2", "--nodes", "1"])
    assert e.value.code == 2
    assert "--nodes (embedded scheduler) is not supported with --shards" in (
        capsys.readouterr().err)


def _front(daemons, daemon):
    return daemons.servers[daemon[0]].plugin


def _sharded_answers(daemons, daemon, docs):
    """POST the cluster to a sharded daemon, wait until its shards are
    idle and the pushed statuses stand still, then read every pod's
    PreFilter and the batch."""
    port = daemon[1]
    for doc in docs:
        assert _call(port, "POST", "/v1/objects", doc)[0] == 200
    assert _front(daemons, daemon).drain(timeout=60.0)
    _settle(port)
    out = [("prefilter", key, _call(port, "POST", "/v1/prefilter", {"podKey": key}))
           for key in pod_keys(docs)]
    out.append(("batch", _call(port, "POST", "/v1/prefilter-batch", {})))
    return out


def test_sharded_port_daemon_answers_as_the_reference(monkeypatch):
    """``serve --shards 2 --device cpu``: an admission front in this process
    and two worker processes, each running its device data plane on the
    CPU, answer every PreFilter and the batch as the JAX package's
    ``serve --shards 2`` does; SIGTERM stops the front and its workers."""
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    daemons = _Daemons(monkeypatch)
    docs = manifests(seed=0)
    ref = daemons.start(jcli, SERVE + ["--shards", "2"])
    port = daemons.start(tcli, PORT_SERVE + ["--shards", "2"])
    procs = []
    try:
        _, ready = _call(port[1], "GET", "/readyz")
        assert ready["state"] == "ok"
        assert ready["components"]["shards"] == {
            "state": "ok", "shard-0": "ok", "shard-1": "ok"}
        want = _sharded_answers(daemons, ref, docs)
        got = _sharded_answers(daemons, port, docs)
        assert got == want
        batch = got[-1][1][1]["schedulable"]
        assert len(batch) == len(pod_keys(docs))
        assert set(batch.values()) == {True, False}
        front = _front(daemons, port)
        for sid, stats in front.stats()["shards"].items():
            assert stats["device"] == "cpu", sid
            assert stats["objects"]["throttles"] > 0, sid
        procs = [front.supervisor_ref.shard_proc(sid) for sid in range(2)]
        assert all(p is not None and p.poll() is None for p in procs)
    finally:
        daemons.stop(port)
        daemons.stop(ref)
    assert all(p.poll() is not None for p in procs), "a worker outlived SIGTERM"


def test_sharded_serve_without_a_card_spawns_no_worker(monkeypatch, capsys):
    """``serve --shards 2`` on ``--device cuda`` without a card exits
    non-zero before any worker is spawned or any kernel is built."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from kube_throttler_tpu_torch import kernels
    from kube_throttler_tpu_torch.sharding.supervisor import ShardSupervisor

    def never(*args, **kwargs):
        raise AssertionError("nothing may be spawned or built without a device")

    monkeypatch.setattr(signal, "signal", lambda *a, **k: None)
    monkeypatch.setattr(ShardSupervisor, "__init__", never)
    monkeypatch.setattr(kernels, "build", never)
    monkeypatch.setattr(tcli, "ThrottlerHTTPServer", never)
    assert tcli.main(SERVE + ["--shards", "2", "--device", "cuda"]) == 1
    err = capsys.readouterr().err
    assert "device unavailable" in err and "CUDA is not available" in err


def test_version(capsys):
    from kube_throttler_tpu_torch import __version__

    assert tcli.main(["version"]) == 0
    assert capsys.readouterr().out == f"kube-throttler-gpu version {__version__}\n"


def test_a_kernel_fault_at_prewarm_stops_startup(monkeypatch):
    """A kernel that fails to build or launch while the daemon prewarms
    raises out of ``serve``: no server starts, and the breaker never opens
    into host answers."""
    from kube_throttler_tpu_torch.engine.devicestate import DeviceStateManager
    from kube_throttler_tpu_torch.ops.check_dense import KernelLaunchError

    def fail(self):
        raise KernelLaunchError("check_dense kernel launch failed: cudaError 209")

    def never(*args, **kwargs):
        raise AssertionError("no server may start after a kernel fault")

    monkeypatch.setattr(signal, "signal", lambda *a, **k: None)
    monkeypatch.setattr(DeviceStateManager, "prewarm", fail)
    monkeypatch.setattr(tcli, "ThrottlerHTTPServer", never)
    with pytest.raises(KernelLaunchError, match="cudaError 209"):
        tcli.main(PORT_SERVE)
