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

Also here: the CLI's guards (``--device cuda`` without a card,
``--shards``) and ``version``.
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
    with pytest.raises(SystemExit) as e:
        tcli.main(PORT_SERVE + ["--shards", "2"])
    assert e.value.code == 2
    assert "ROADMAP queue 1 item 11c" in capsys.readouterr().err


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
