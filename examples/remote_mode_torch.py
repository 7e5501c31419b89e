"""Remote-mode demo: the daemon throttling a (simulated) external cluster.

Spins up the in-process wire-protocol apiserver (client/mockserver.py),
launches the REAL daemon binary against a generated kubeconfig, drives pod
churn on the "cluster", and shows:

- reflectors syncing the daemon's cache over real HTTP list+watch,
- the reconcile loop writing ``status.used`` back to the status
  subresource,
- admission decisions served over the daemon's /v1/prefilter,
- Warning events landing on the cluster as v1 Events.

The daemon is the PyTorch/CUDA port's (``kube_throttler_tpu_torch.cli``),
serving from the card by default.

Run: python examples/remote_mode_torch.py [--device {cuda,cpu}]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod  # noqa: E402
from kube_throttler_tpu_torch.api.serialization import object_from_dict  # noqa: E402
from kube_throttler_tpu_torch.client.mockserver import MockApiServer  # noqa: E402
from kube_throttler_tpu_torch.utils.platform import add_device_argument  # noqa: E402

THROTTLE = {
    "kind": "Throttle",
    "metadata": {"name": "t1", "namespace": "default"},
    "spec": {
        "throttlerName": "kube-throttler",
        "threshold": {"resourceRequests": {"cpu": "1"}},
        "selector": {"selectorTerms": [{"podSelector": {"matchLabels": {"grp": "a"}}}]},
    },
}


def main() -> int:
    parser = argparse.ArgumentParser()
    add_device_argument(parser, "the daemon's device data plane")
    args = parser.parse_args()
    server = MockApiServer()
    server.store.create_namespace(Namespace("default"))
    server.store.create_throttle(object_from_dict(THROTTLE))
    server.start()
    print(f"cluster (wire-protocol apiserver) on {server.url}")

    workdir = tempfile.TemporaryDirectory(prefix="kt-remote-demo-")
    kubeconfig = Path(workdir.name) / "kubeconfig.yaml"
    kubeconfig.write_text(
        f"clusters:\n- name: demo\n  cluster: {{server: \"{server.url}\"}}\n"
        "contexts:\n- name: demo\n  context: {cluster: demo}\ncurrent-context: demo\n"
    )

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    daemon = subprocess.Popen(
        [
            sys.executable, "-m", "kube_throttler_tpu_torch.cli", "serve",
            "--name", "kube-throttler", "--target-scheduler-name", "my-scheduler",
            "--kubeconfig", str(kubeconfig), "--port", "0", "--device", args.device,
        ],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    port = None
    try:
        for line in daemon.stdout:
            print(f"daemon: {line.rstrip()}")
            if "serving on" in line:
                port = int(line.split("serving on ")[1].split()[0].split(":")[1])
                break
        assert port, "daemon did not start"

        # keep draining the (merged) pipe in the background, or the daemon
        # blocks on a log write once the OS pipe buffer fills
        import threading

        threading.Thread(
            target=lambda: [None for _ in daemon.stdout], daemon=True
        ).start()

        # a Running 800m pod lands on the cluster → reconcile → status.used
        pod = make_pod(
            "p1",
            labels={"grp": "a"},
            requests={"cpu": "800m"},
            node_name="node-1",
            phase="Running",
        )
        server.store.create_pod(pod)
        deadline = time.time() + 20
        while time.time() < deadline:
            t1 = server.store.get_throttle("default", "t1")
            if t1.status.used.resource_counts == 1:
                break
            time.sleep(0.05)
        print(f"cluster sees status.used = {t1.status.used.to_dict()}")

        def prefilter(name, cpu):
            body = {
                "kind": "Pod",
                "metadata": {"name": name, "namespace": "default", "labels": {"grp": "a"}},
                "spec": {
                    "schedulerName": "my-scheduler",
                    "containers": [{"resources": {"requests": {"cpu": cpu}}}],
                },
            }
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/prefilter",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
            )
            out = json.load(urllib.request.urlopen(req, timeout=10))
            print(f"prefilter {name} ({cpu}): {out['code']} {out['reasons']}")

        prefilter("small", "100m")   # fits under 1 CPU
        prefilter("big", "300m")     # 800m used + 300m > 1 → insufficient
        prefilter("huge", "5")       # alone exceeds → Warning event emitted
        time.sleep(1)
        events = server.events_in("default")
        for ev in events:
            print(f"cluster event: {ev['type']} {ev['reason']} on {ev['involvedObject']['name']}")
        return 0
    finally:
        daemon.terminate()
        try:
            daemon.wait(timeout=10)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait(timeout=10)
        server.stop()
        workdir.cleanup()


if __name__ == "__main__":
    sys.exit(main())
