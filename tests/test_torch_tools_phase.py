"""The chip smoke's ``[daemon]`` cluster and ``[tools]`` phase rehearsed
on the CPU: ``chip_smoke.daemon_cluster`` builds the daemon phase's own
cluster (``DAEMON_CLUSTER``, the main path's seed rule at a fifth of its
depth) in process on the CPU, the reference the daemon on the card is
held against, and writes it as the daemon's data dir; and
``chip_smoke.drive_tools`` runs the port's tools (``TOOLS``) as child
processes and refuses a child that exits non-zero. The tests monkeypatch
the phases' module constants to a smaller size. On the CPU the wrappers
run their plain versions, so no kernel launch is counted."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    return chip_smoke


def test_the_daemon_cluster_is_a_fifth_of_the_main_paths(chip_smoke):
    """The stated size: 20,000 pods, 2,000 Throttles and 8
    ClusterThrottles, each label group holding the main path's 200 pods
    and 20 Throttles."""
    pods, throttles, groups, n_cluster = chip_smoke.DAEMON_CLUSTER
    assert (pods, throttles, n_cluster) == (20_000, 2_000, chip_smoke.N_CLUSTER)
    assert pods * 5 == chip_smoke.N_PODS and throttles * 5 == chip_smoke.N_THROTTLES
    assert pods // groups == chip_smoke.N_PODS // chip_smoke.GROUPS
    assert throttles // groups == chip_smoke.N_THROTTLES // chip_smoke.GROUPS
    assert chip_smoke.FILL_GROUP < groups
    ns, thr, cl, pod_objs = chip_smoke.cluster_objects(*chip_smoke.DAEMON_CLUSTER, chip_smoke.SEED)
    assert (len(pod_objs), len(thr), len(cl)) == (pods, throttles, n_cluster)
    assert len({p.labels["grp"] for p in pod_objs}) == groups
    # the armed child runs at the same fifth; the fleet at the main path's
    assert chip_smoke.ARMED_CLUSTER == chip_smoke.DAEMON_CLUSTER


def test_daemon_cluster_on_the_cpu(chip_smoke, monkeypatch, capsys, tmp_path):
    cluster = (400, 40, 20, 8)
    monkeypatch.setattr(chip_smoke, "DAEMON_CLUSTER", cluster)
    out = chip_smoke.daemon_cluster(tmp_path / "daemon")
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[daemon]")]
    assert len(line) == 1 and "step=cluster" in line[0] and "device=cpu" in line[0]
    assert f"cluster={json.dumps(list(cluster))}" in line[0]
    assert len(out["verdicts"]) == 400
    assert out["written"]["objects"] == 400 + 40 + 8 + 1
    assert (tmp_path / "daemon" / "data").is_dir()
    single = out["single"]
    assert len(single["keys"]) == chip_smoke.DAEMON_SINGLE_PODS
    assert single["before"]["code"] == "Success" and single["after"]["code"] != "Success"
    assert len(single["tick"]["schedulable"]) == 400


SMALL_TOOLS = (
    ("profile_batch", ("tools/profile_batch_torch.py", "300", "30")),
    ("profile_reconcile", ("tools/profile_reconcile_torch.py", "300", "30", "200")),
)


def test_tools_phase_on_the_cpu(chip_smoke, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(chip_smoke, "TOOLS", SMALL_TOOLS)
    monkeypatch.setattr(chip_smoke, "TOOLS_ROOT", tmp_path / "tools")
    monkeypatch.setattr(chip_smoke, "TOOLS_DEADLINE_S", 170)
    out = chip_smoke.drive_tools("cpu", device="cpu")
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[tools]")]
    assert [re.search(r"tool=(\S+)", x).group(1) for x in lines] == [
        "profile_batch", "profile_reconcile"]
    assert all("exit_code=0 " in x and "device=cpu" in x for x in lines)
    batch = out["tools"]["profile_batch"]
    # without the verdict cache the batch takes the device route
    assert batch["warm"]["phases"]["batch_dispatch"]["n"] == 1
    assert out["tools"]["profile_reconcile"]["keys"] > 0
    assert out["launches"] == {name: 0 for name in chip_smoke.KERNEL_COUNTERS}
    assert (tmp_path / "tools" / "profile_batch.log").read_text().count("split ") == 2


def test_tools_phase_refuses_a_child_that_fails(chip_smoke, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(chip_smoke, "TOOLS",
                        (("profile_batch", ("tools/profile_batch_torch.py", "not-a-count")),))
    monkeypatch.setattr(chip_smoke, "TOOLS_ROOT", tmp_path / "tools")
    monkeypatch.setattr(chip_smoke, "TOOLS_DEADLINE_S", 60)
    with pytest.raises(chip_smoke.SmokeFailure, match="profile_batch exited 2"):
        chip_smoke.drive_tools("cpu", device="cpu")
    assert "[tools] profile_batch log tail:" in capsys.readouterr().out
