#!/usr/bin/env python
"""Two-replica active/standby failover demo (docs/robustness.md "High
availability & fencing").

Launches a LEADER daemon (``--ha-role leader``) and a warm STANDBY
(``--ha-role standby --replicate-from <leader>``) sharing a flock lease,
creates a throttle and pods on the leader, shows the standby replicating
(503 ``standby`` on /readyz while it streams the journal tail), then
SIGKILLs the leader and watches the standby promote itself — epoch
bumped, replicated objects served, admission answering — within a couple
of seconds.

The daemons are the PyTorch/CUDA port's (``kube_throttler_tpu_torch.cli``).
Failover is the subject, so, as in ``examples/ha_pair.py``, both answer
from the host oracle (``--no-device``) and need no card.

Run:  python examples/ha_pair_torch.py
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(role: str, workdir: str, lock: str, port: int, extra):
    datadir = os.path.join(workdir, role)
    os.makedirs(datadir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [
            sys.executable, "-m", "kube_throttler_tpu_torch.cli", "serve",
            "--name", "kube-throttler", "--target-scheduler-name", "my-scheduler",
            "--no-device", "--data-dir", datadir, "--port", str(port),
            "--lock-file", lock, "--ha-role", role,
        ] + extra,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def wait_for(proc, needle: str, timeout_s: float = 60.0) -> None:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(f"daemon exited rc={proc.returncode}")
            time.sleep(0.05)
            continue
        print(f"    | {line.rstrip()}")
        if needle in line:
            return
    raise RuntimeError(f"timed out waiting for {needle!r}")


def post(port: int, path: str, doc: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"},
    )
    return json.loads(urllib.request.urlopen(req).read())


def get(port: int, path: str):
    return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}{path}").read())


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="ha-pair-") as workdir:
        lock = os.path.join(workdir, "lease.lock")
        leader = standby = None
        try:
            print("[1] starting the LEADER (epoch 1, replication endpoints on)")
            leader = launch("leader", workdir, lock, 10259, [])
            wait_for(leader, "serving on")

            print("[2] creating a throttle + pods through the leader")
            post(10259, "/v1/objects", {
                "kind": "Throttle",
                "metadata": {"name": "demo", "namespace": "default"},
                "spec": {
                    "throttlerName": "kube-throttler",
                    "threshold": {"resourceCounts": {"pod": 2}},
                    "selector": {"selectorTerms": [
                        {"podSelector": {"matchLabels": {"app": "demo"}}}
                    ]},
                },
            })
            for i in range(3):
                post(10259, "/v1/objects", {
                    "kind": "Pod",
                    "metadata": {"name": f"demo-{i}", "namespace": "default",
                                 "labels": {"app": "demo"}},
                    "spec": {"schedulerName": "my-scheduler",
                             "containers": [{"name": "c", "resources": {
                                 "requests": {"cpu": "100m"}}}]},
                })

            print("[3] starting the WARM STANDBY (bootstraps + streams the tail)")
            standby = launch(
                "standby", workdir, lock, 10260,
                ["--replicate-from", "http://127.0.0.1:10259"],
            )
            wait_for(standby, "standing by")
            try:
                get(10260, "/readyz")
            except urllib.error.HTTPError as e:
                body = json.loads(e.read())
                print(f"    standby /readyz: {e.code} state={body['state']} "
                      f"(lag {body['components']['ha'].get('lagBytes')} bytes)")

            print("[4] SIGKILL the leader — no goodbye, no snapshot, no release")
            t0 = time.time()
            leader.send_signal(signal.SIGKILL)
            leader.wait()

            print("[5] the standby takes the lease, fast-forwards, and serves")
            wait_for(standby, "serving on")
            ready = get(10260, "/readyz")
            throttles = get(10260, "/v1/throttles")
            verdict = post(10260, "/v1/prefilter", {"podKey": "default/demo-0"})
            print(f"\n    failover: {time.time() - t0:.2f}s after the kill")
            print(f"    role={ready['role']} epoch={ready['epoch']} "
                  f"(the dead leader's term was 1)")
            print(f"    replicated throttles: "
                  f"{[t['metadata']['name'] for t in throttles]}")
            print(f"    admission verdict for default/demo-0: {verdict}")
            return 0
        finally:
            for p in (leader, standby):
                if p is not None and p.poll() is None:
                    p.terminate()
                    try:
                        p.wait(timeout=15)
                    except subprocess.TimeoutExpired:
                        p.kill()


if __name__ == "__main__":
    sys.exit(main())
