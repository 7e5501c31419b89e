"""The chip smoke's ``[deployed]`` phase rehearsed on the CPU at a small
size: ``chip_smoke.drive_deployed(device="cpu")`` copies the package into
an install tree and runs its parts (a) and (c) from there — the
remote-mode daemon of deploy/deployment.yaml against a ``MockApiServer``,
and the TCP fleet of deploy/sharded-fleet.yaml with a worker SIGKILLed and
restarted — each answer held against an in-process plugin, the install
tree's listing before and after. Part (b), the prebuilt kernels with no
``nvcc``, needs the card. On the CPU the wrappers run their plain
versions, so no kernel launch is counted.

A front that dials every shard runs no worker of its own, so it starts
without a card and without ``--device``: the workers' own flag decides
where they run."""

import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CLUSTER = (800, 80, 16, 8)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    return chip_smoke


def test_deployed_phase_on_the_cpu(chip_smoke, capsys, tmp_path):
    out = chip_smoke.drive_deployed("cpu", device="cpu", cluster=CLUSTER,
                                    root=tmp_path / "deployed")
    lines = capsys.readouterr().out.splitlines()
    parts = {re.search(r"part=(\S+)", x).group(1): x for x in lines if x.startswith("[deployed]")}
    assert list(parts) == ["install", "cluster", "remote-daemon", "install-tree", "fleet",
                           "fleet-sigkill"]
    install = parts["install"]
    assert f"package={tmp_path / 'deployed' / 'site'}" in install
    assert "kube-throttler-gpu/kernels" in install and "build_beside=False" in install
    assert 'routes={"clusterthrottle": "dense", "throttle": "sparse"}' in parts["cluster"]
    for part in ("remote-daemon", "fleet"):
        assert f"verdicts={CLUSTER[0]} batch_differ=0" in parts[part]
        assert "single_pods=200 single_differ=0" in parts[part]
    assert "tick_same=True" in parts["remote-daemon"]
    assert "device=cpu" in parts["remote-daemon"]
    tree = parts["install-tree"]
    assert "new_files=[] " in tree and "kernel_cache=[]" in tree
    assert "device=remote" in parts["fleet"]
    assert 'devices={"0": "cpu", "1": "cpu"}' in parts["fleet"]
    sigkill = parts["fleet-sigkill"]
    assert "single_differ=0" in sigkill and "device=cpu" in sigkill
    assert out["kill_to_back_s"] > 0
    assert set(out["launches"]) == {"remote-daemon", "fleet"}
    assert not (tmp_path / "deployed").exists()


def _worker(sid: int, port_file: Path, env: dict) -> subprocess.Popen:
    """A shard worker on the CPU, listening on an ephemeral loopback port;
    returns once it has written its address to ``port_file``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kube_throttler_tpu_torch.sharding.worker",
         "--shard-id", str(sid), "--shards", "2", "--listen", "127.0.0.1:0",
         "--port-file", str(port_file), "--device", "cpu"],
        cwd=str(REPO), env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 120
    while not port_file.exists():
        assert proc.poll() is None and time.monotonic() < deadline, "the worker never listened"
        time.sleep(0.1)
    return proc


def test_a_front_that_dials_every_shard_needs_no_card(chip_smoke, tmp_path):
    """``serve --shards 2`` with a ``--shard-connect`` for each shard and no
    ``--device`` (so ``cuda``) starts on a host without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {"PYTHONPATH": str(REPO), "KT_VERDICT_CACHE": "0"}
    workers = []
    try:
        for sid in range(2):
            workers.append(_worker(sid, tmp_path / f"shard-{sid}.port", {**os.environ, **env}))
        connect = [f"--shard-connect={sid}={(tmp_path / f'shard-{sid}.port').read_text().strip()}"
                   for sid in range(2)]
        front = chip_smoke.Daemon(["--shards", "2", "--shard-transport", "tcp", *connect],
                                  tmp_path / "front.log", 120.0, env=env)
        try:
            assert "shards=2, device=remote" in front.line(r"serving on")
            code, body = front.post("/v1/prefilter-batch")
            assert code == 200 and body["errors"] == []
            front.stop()
        finally:
            front.kill()
    finally:
        for w in workers:
            w.send_signal(signal.SIGKILL)
            w.wait()
