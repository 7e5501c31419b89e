"""The port's developer and CI surface, on the CPU: the served stack
(``tools/served_stack_torch.py``) against the JAX package's
``bench.build_served_stack``, the profiling tools and the memory smoke as
child processes on ``--device cpu``, their refusal without a card, and
the port's CI gate (``hack/ci_torch.sh``, ``make ci-torch``), which names
only the port."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TOOL_TIMEOUT_S = 180


def _tool(script, *args):
    return subprocess.run([sys.executable, str(REPO / "tools" / script), *args],
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=TOOL_TIMEOUT_S)


def _splits(stdout):
    return {s["call"]: s for s in (json.loads(line[len("split "):])
                                   for line in stdout.splitlines() if line.startswith("split "))}


def _served(objs, serialize):
    """A served stack's stored objects as manifests, without the fields
    a store assigns (uid, resourceVersion)."""
    out = []
    for o in objs:
        d = serialize(o)
        meta = {k: v for k, v in d["metadata"].items() if k in ("name", "namespace", "labels")}
        out.append((meta, d.get("spec"), d.get("status", {}).get("phase")))
    return sorted(out, key=lambda x: x[0]["name"])


def test_build_served_stack_matches_the_benchs(monkeypatch):
    """The same Throttle specs, pod labels and requests as the JAX
    package's ``bench.build_served_stack`` at 200 × 20, and a reconciled
    plugin on the device asked for."""
    monkeypatch.setenv("KT_GC_FREEZE", "0")  # the stack freezes no test heap
    import bench
    from kube_throttler_tpu.api.serialization import object_to_dict as jax_dict
    from kube_throttler_tpu_torch.api.serialization import object_to_dict
    from tools.served_stack_torch import build_served_stack

    store, plugin = build_served_stack(200, 20, label="t", device="cpu")
    ref_store, ref_plugin = bench.build_served_stack(200, 20, label="t")
    try:
        assert plugin.device_manager.device == torch.device("cpu")
        for listing in ("list_throttles", "list_pods"):
            got = _served(getattr(store, listing)(), object_to_dict)
            want = _served(getattr(ref_store, listing)(), jax_dict)
            assert len(got) == {"list_throttles": 20, "list_pods": 200}[listing]
            assert got == want, listing
        # the initial reconcile wrote the same statuses (but their clock)
        def statuses(st, serialize):
            out = []
            for t in sorted(st.list_throttles(), key=lambda t: t.name):
                status = serialize(t)["status"]
                status["calculatedThreshold"].pop("calculatedAt")
                out.append(status)
            return out

        assert statuses(store, object_to_dict) == statuses(ref_store, jax_dict)
    finally:
        plugin.stop()
        ref_plugin.stop()


def test_build_served_stack_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tools.served_stack_torch import build_served_stack

    with pytest.raises(RuntimeError, match="CUDA"):
        build_served_stack(10, 2)


def test_profile_batch_on_the_cpu():
    proc = _tool("profile_batch_torch.py", "500", "50", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"^warm pre_filter_batch: [\d.]+ms for 500 pods$", proc.stdout, re.M)
    assert "[prof] created 500 bound pods" in proc.stderr
    splits = _splits(proc.stdout)
    assert set(splits) == {"warm", "profiled"}
    for s in splits.values():
        assert s["device"] == "cpu" and s["ms"] > 0
        assert set(s["phases"]) == {"batch_dedupe", "batch_dispatch", "batch_merge"}
        # the wrappers count kernel launches only: none on the CPU
        assert s["launches"] == {"check_dense": 0, "check_gather": 0,
                                 "pack_gather_rows": 0, "victim_select": 0}
    assert "Ordered by: cumulative time" in proc.stdout


def test_profile_reconcile_on_the_cpu():
    proc = _tool("profile_reconcile_torch.py", "300", "30", "200", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"^fired 200 events in [\d.]+s", proc.stdout, re.M)
    m = re.search(r"^drained (\d+) keys in [\d.]+s \(([\d,]+) keys/s\)$", proc.stdout, re.M)
    assert m and int(m.group(1)) > 0
    (drain,) = _splits(proc.stdout).values()
    assert drain["call"] == "drain" and drain["keys"] == int(m.group(1))
    assert set(drain["phases"]) == {"agg_lock_wait", "agg_main_lock_wait", "agg_snapshot",
                                    "agg_apply", "agg_flips", "agg_gather", "agg_decode"}
    assert drain["phases"]["agg_apply"]["n"] >= 1
    assert "Ordered by: cumulative time" in proc.stdout


def test_memsmoke_passes_the_reference_bounds_on_the_cpu():
    """At its own 50k pods × 1k Throttles, under the reference's bounds."""
    proc = _tool("memsmoke_torch.py", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    m = re.search(r"memsmoke: 50000 pods x 1000 throttles in [\d.]+s — ([\d.]+) heap "
                  r"objects/pod \(bound 0.5\), (\d+) B RSS/pod \(bound 6144\);.* device cpu",
                  proc.stdout)
    assert m, proc.stdout
    assert float(m.group(1)) <= 0.5 and int(m.group(2)) <= 6144
    assert "FAIL" not in proc.stdout


def test_memsmoke_counts_a_buffer_freed_inside_the_stretch(monkeypatch):
    """On ``cuda`` the RSS gate reads the pod loop's own high-water mark:
    a 64 MiB buffer written and freed inside the stretch has left the
    resident set and still counts, as it does in the CPU's ``ru_maxrss``."""
    monkeypatch.syspath_prepend(str(REPO))
    from tools import memsmoke_torch

    peak = memsmoke_torch._ResidentPeak()
    buf = b"\x01" * (64 << 20)
    time.sleep(0.05)
    del buf
    assert memsmoke_torch._rss_kb() - peak.start_kb < 32 << 10
    assert peak.stop() - peak.start_kb >= 60 << 10


@pytest.mark.parametrize("script, args", [
    ("profile_batch_torch.py", ["10", "2"]),
    ("profile_reconcile_torch.py", ["10", "2", "5"]),
    ("memsmoke_torch.py", []),
], ids=["profile_batch", "profile_reconcile", "memsmoke"])
def test_tools_exit_1_without_a_card(script, args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _tool(script, *args)
    assert proc.returncode == 1
    assert "device unavailable" in proc.stderr and "Traceback" not in proc.stderr
    assert "[prof]" not in proc.stderr and "memsmoke:" not in proc.stdout


def test_ci_gate_lists_only_the_port():
    """``hack/ci_torch.sh --list`` prints every step's command and runs
    none; each names the port's modules, test files and tools only."""
    proc = subprocess.run([str(REPO / "hack" / "ci_torch.sh"), "--list"], cwd=str(REPO),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    steps = [line[2:] for line in proc.stdout.splitlines() if line.startswith("+ ")]
    assert len(steps) == 6
    assert "ci-torch gate: OK" not in proc.stdout
    listed = " ".join(steps)
    assert "make lint-torch" in listed and "make race-test-torch" in listed
    assert "-m kube_throttler_tpu_torch.scenarios.hunt smoke --device cpu" in listed
    assert "tools/memsmoke_torch.py --device cpu" in listed
    assert "tools/upgradetest_torch.py smoke" in listed
    for test_file in re.findall(r"tests/\S+\.py", listed):
        assert test_file.startswith("tests/test_torch_"), test_file
    for tool in re.findall(r"tools/\S+\.py", listed):
        assert tool.endswith("_torch.py"), tool
    assert not re.search(r"\bkube_throttler_tpu\b(?!_torch)", listed)
    assert "JAX_PLATFORMS" not in listed
    help_ = subprocess.run([str(REPO / "hack" / "ci_torch.sh"), "--help"], cwd=str(REPO),
                           capture_output=True, text=True, timeout=60)
    assert help_.returncode == 0 and "make ci-torch" in help_.stdout


def test_make_targets_of_the_port():
    """``lint-torch``, ``race-test-torch`` and ``ci-torch`` run the port's
    gate; ``lint``, ``race-test`` and ``ci`` still run the JAX package's."""
    make = (REPO / "Makefile").read_text(encoding="utf-8")

    def recipe(target):
        m = re.search(rf"^{target}:.*\n((?:\t.*\n)+)", make, re.M)
        assert m, target
        return m.group(0)

    assert "-m kube_throttler_tpu_torch.analysis" in recipe("lint-torch")
    for f in ("racedetect", "epochassert", "lockorder", "concurrent_check"):
        assert f"tests/test_torch_{f}.py" in recipe("race-test-torch")
    assert "hack/ci_torch.sh" in recipe("ci-torch")
    for target in ("lint-torch", "race-test-torch", "ci-torch"):
        assert "the PyTorch/CUDA port's twin" in recipe(target)
    assert "-m kube_throttler_tpu.analysis" in recipe("lint")
    assert recipe("ci").rstrip().endswith("hack/ci.sh")


def test_upgrade_smoke_expects_what_a_tcp_worker_negotiates(tmp_path):
    """Fault (q): the rolling-upgrade smoke (the gate's last step) held its
    TCP fleet to every capability, ``evt-shm`` included, which a
    ``--listen`` worker never advertises (it has no shared-memory ring with
    its front), so the smoke failed after every clean roll. Its expected
    set is what such a worker negotiates with a front that offers all."""
    import os
    import time

    from kube_throttler_tpu_torch.sharding.ipc import TcpShardClient
    from kube_throttler_tpu_torch.version import CAPABILITIES
    from tools.upgradetest_torch import _fleet_caps

    port_file = tmp_path / "port"
    env = {k: v for k, v in os.environ.items() if k != "KT_PROTO_CAPS_MASK"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kube_throttler_tpu_torch.sharding.worker", "--shard-id", "0",
         "--shards", "1", "--listen", "127.0.0.1:0", "--port-file", str(port_file),
         "--no-device"], cwd=str(REPO), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while not port_file.exists():
            assert proc.poll() is None and time.monotonic() < deadline, "the worker never listened"
            time.sleep(0.05)
        host, _, port = port_file.read_text().strip().rpartition(":")
        client = TcpShardClient(0, host, int(port), connect_timeout=2.0)
        try:
            while client.negotiated_caps is None:
                assert time.monotonic() < deadline, "no handshake"
                time.sleep(0.05)
            assert "evt-shm" in CAPABILITIES
            assert client.negotiated_caps == _fleet_caps() == CAPABILITIES - {"evt-shm"}
        finally:
            client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
