"""Shared child-process harness for the destructive test tools, over the
PyTorch port (``kube_throttler_tpu_torch``, device data plane on the CPU):
a copy of ``tools/harness.py`` with the port's imports, shared by
``tools/crashtest_torch.py`` and ``tools/hatest_torch.py``.

Three harnesses drive workloads in CHILD processes and assert invariant
oracles over what the parent finds afterwards: the SIGKILL crash matrix
(tools/crashtest.py), the kill-the-leader HA matrix (tools/hatest.py), and
the scenario engine's process-level scenarios (apiserver restart, leader
kill — kube_throttler_tpu/scenarios/). This module is the single copy of
what they share:

- **process management**: the child environment (PYTHONPATH to the repo
  checkout), run-to-completion and streaming spawns,
  the line-waiter that reads a child's stdout until a marker appears (the
  transcript rides any assertion), and best-effort cleanup;
- **workload fixtures**: the deterministic throttle factory and the
  reconcile stand-in that derives status.used/throttled through the real
  status-subresource write path (which the journal records);
- **oracle helpers**: full store dumps, plugin construction, and
  normalized ``pre_filter`` verdict sweeps — the vocabulary every
  "recovered state ≡ replayed state" assertion is written in.

Keeping these here means a new process-level scenario is a workload loop
plus an oracle, not a third copy of spawn/wait/kill plumbing.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from queue import Empty, Queue
from typing import List, Optional, Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

# workload knobs the drivers and the oracles agree on
N_THROTTLES = 4


# --------------------------------------------------------------------------
# process management
# --------------------------------------------------------------------------


def child_env() -> dict:
    """Environment for a harness child: the repo importable (the port's
    plugin runs its device data plane on the CPU, ``build_plugin``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_child(script: str, argv: Sequence[str], timeout: float = 180.0):
    """Run ``python <script> <argv...>`` to completion (the crash-matrix
    shape: the child either finishes its workload or dies by SIGKILL at
    the seeded site). Returns the CompletedProcess."""
    cmd = [sys.executable, os.path.abspath(script), *argv]
    return subprocess.run(
        cmd,
        capture_output=True,
        text=True,
        timeout=timeout,
        env=child_env(),
        cwd=REPO_ROOT,
    )


def spawn_child(script: str, argv: Sequence[str]) -> subprocess.Popen:
    """Start ``python <script> <argv...>`` streaming (the HA/scenario
    shape: the parent watches stdout markers while the child runs)."""
    cmd = [sys.executable, os.path.abspath(script), *argv]
    return subprocess.Popen(
        cmd,
        cwd=REPO_ROOT,
        env=child_env(),
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


def wait_line(proc: subprocess.Popen, prefix: str, timeout_s: float) -> str:
    """Read ``proc``'s stdout lines until one starts with ``prefix``; the
    transcript so far rides any assertion. A single drain thread per
    process survives repeated calls (lines already seen are re-scanned
    first, so two waits for the same marker both succeed)."""
    lines: "Queue[str]" = getattr(proc, "_kt_lines", None)
    if lines is None:

        def drain():
            for line in proc.stdout:
                proc._kt_lines.put(line)

        proc._kt_lines = lines = Queue()
        proc._kt_seen = []
        t = threading.Thread(target=drain, daemon=True)
        proc._kt_drain = t
        t.start()
    deadline = time.time() + timeout_s
    for line in proc._kt_seen:
        if line.startswith(prefix):
            return line
    while time.time() < deadline:
        try:
            line = lines.get(timeout=0.2)
        except Empty:
            if proc.poll() is not None and lines.empty():
                break
            continue
        proc._kt_seen.append(line)
        if line.startswith(prefix):
            return line
    raise AssertionError(
        f"never saw {prefix!r} from {proc.args[2] if len(proc.args) > 2 else proc.args}"
        f" (rc={proc.poll()}):\n{''.join(proc._kt_seen)}"
    )


def was_sigkilled(proc) -> bool:
    """True when the (finished) process died by SIGKILL — the seeded
    crash-site death, as opposed to a workload error."""
    rc = proc.returncode if not isinstance(proc, int) else proc
    return rc == -signal.SIGKILL


def kill_children(procs: Sequence[Optional[subprocess.Popen]]) -> None:
    """Best-effort cleanup: SIGKILL whatever is still alive and reap it
    (every harness' ``finally`` block)."""
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            try:
                p.wait(timeout=10)
            except Exception:
                pass


# --------------------------------------------------------------------------
# workload fixtures (deterministic; shared by every child driver)
# --------------------------------------------------------------------------


def make_throttle(i: int):
    """Throttle ``t<i>`` selecting pod group ``g<i>`` with a small
    pod-count + cpu threshold — the crash/HA workloads' fixed topology."""
    from kube_throttler_tpu_torch.api.types import (
        LabelSelector,
        ResourceAmount,
        Throttle,
        ThrottleSelector,
        ThrottleSelectorTerm,
        ThrottleSpec,
    )

    return Throttle(
        name=f"t{i}",
        namespace="default",
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ResourceAmount.of(
                pod=3 + i, requests={"cpu": str(1 + i)}
            ),
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(
                        LabelSelector(match_labels={"grp": f"g{i}"})
                    ),
                )
            ),
        ),
    )


def recompute_status(store, thr):
    """A deterministic reconcile stand-in: count/sum the Running pods the
    throttle's matchLabels selector matches and derive throttled flags —
    enough to populate status.used/throttled/calculatedThreshold through
    the real status-subresource write path (which the journal records)."""
    from kube_throttler_tpu_torch.api.types import (
        CalculatedThreshold,
        IsResourceAmountThrottled,
        ResourceAmount,
        ThrottleStatus,
    )
    from kube_throttler_tpu_torch.resourcelist import pod_request_resource_list

    grp = thr.spec.selector.selector_terms[0].pod_selector.match_labels.get("grp")
    running = [
        p
        for p in store.list_pods("default")
        if p.labels.get("grp") == grp and p.status.phase == "Running"
    ]
    cpu = sum(
        (pod_request_resource_list(p).get("cpu", 0) for p in running), 0
    )
    # exact-Fraction quantities go straight into the dataclass (of() parses
    # strings; these are already canonical)
    used = ResourceAmount(
        resource_counts=len(running), resource_requests={"cpu": cpu}
    )
    threshold = thr.spec.threshold
    flags = IsResourceAmountThrottled(
        resource_counts_pod=(
            threshold.resource_counts is not None
            and len(running) >= threshold.resource_counts
        ),
        resource_requests={
            "cpu": cpu >= (threshold.resource_requests or {}).get("cpu", 0)
        },
    )
    return thr.with_status(
        ThrottleStatus(
            calculated_threshold=CalculatedThreshold(threshold=threshold),
            throttled=flags,
            used=used,
        )
    )


# --------------------------------------------------------------------------
# oracle helpers
# --------------------------------------------------------------------------


def dump_store(store) -> dict:
    """Object-for-object dump of every kind — the replay-equivalence
    oracle's comparison form."""
    from kube_throttler_tpu_torch.api.serialization import object_to_dict

    return {
        "Namespace": {n.name: object_to_dict(n) for n in store.list_namespaces()},
        "Throttle": {t.key: object_to_dict(t) for t in store.list_throttles()},
        "ClusterThrottle": {
            t.name: object_to_dict(t) for t in store.list_cluster_throttles()
        },
        "Pod": {p.key: object_to_dict(p) for p in store.list_pods()},
    }


def normalized_reasons(reasons) -> list:
    """Reason strings with their name lists sorted — verdict comparisons
    must not depend on iteration order."""
    out = []
    for r in reasons:
        head, _, names = r.partition("=")
        out.append(f"{head}={','.join(sorted(names.split(',')))}")
    return sorted(out)


def verdicts(plugin, store) -> dict:
    """``pre_filter`` status (code + normalized reasons) for every stored
    pod — the admission-equivalence oracle's comparison form."""
    out = {}
    for pod in sorted(store.list_pods(), key=lambda p: p.key):
        status = plugin.pre_filter(pod)
        out[pod.key] = (status.code.value, normalized_reasons(status.reasons))
    return out


def build_plugin(store):
    """A KubeThrottler over ``store`` with workers parked — the oracle's
    admission surface."""
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

    return KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True,
        start_workers=False,
        device="cpu",
    )
