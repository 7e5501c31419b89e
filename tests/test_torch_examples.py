"""The port's examples (``examples/*_torch.py``) beside the JAX package's,
each run as a script on the CPU. The walkthrough prints decisions only,
and its twin's stdout must equal the reference's byte for byte. The
remote-mode and HA-pair demos must print the same lines once what varies
from run to run is taken out: the lines echoing the daemons' own logs
(``daemon: ...`` and ``    | ...``: log records, whose module names and
timestamps are each package's own), listening ports, the failover's
seconds and the standby's replication lag in bytes."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}


def _run(script: str, *args: str) -> str:
    proc = subprocess.run([sys.executable, f"examples/{script}", *args], cwd=str(REPO),
                          env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


def _untimed(out: str) -> list:
    lines = [x for x in out.splitlines() if not x.startswith(("daemon: ", "    | "))]
    lines = [re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:PORT", x) for x in lines]
    lines = [re.sub(r"failover: [\d.]+s", "failover: Ts", x) for x in lines]
    return [re.sub(r"\(lag \d+ bytes\)", "(lag N bytes)", x) for x in lines]


def test_walkthrough_twin_prints_the_same_bytes():
    want = _run("walkthrough.py")
    assert "pod3: Pending — throttle[insufficient]=default/t1" in want
    assert _run("walkthrough_torch.py", "--device", "cpu") == want


@pytest.mark.parametrize("script, args", [
    ("remote_mode", ["--device", "cpu"]),
    ("ha_pair", []),
], ids=["remote_mode", "ha_pair"])
def test_twin_prints_the_same_lines(script, args):
    want = _untimed(_run(f"{script}.py"))
    got = _untimed(_run(f"{script}_torch.py", *args))
    assert len(want) > 5
    assert got == want
