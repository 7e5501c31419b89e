"""The port's own static analyzer over the port: 0 new findings against
the port's baseline and allow files
(``kube_throttler_tpu_torch/analysis_waivers/``, its defaults), and none
of them stale."""

from pathlib import Path

from kube_throttler_tpu_torch.analysis import (
    DEFAULT_ALLOWLIST,
    DEFAULT_BASELINE,
    DEFAULT_BLOCKING_ALLOWLIST,
    DEFAULT_DEADLINE_ALLOWLIST,
    DEFAULT_EPOCH_ALLOWLIST,
    PACKAGE_ROOT,
)
from kube_throttler_tpu_torch.analysis.__main__ import main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kube_throttler_tpu_torch"
WAIVERS = PORT / "analysis_waivers"


def test_analyzer_reports_no_new_finding_over_the_port(capsys):
    assert Path(PACKAGE_ROOT) == PORT
    assert {Path(p) for p in (DEFAULT_BASELINE, DEFAULT_ALLOWLIST, DEFAULT_BLOCKING_ALLOWLIST,
                              DEFAULT_EPOCH_ALLOWLIST, DEFAULT_DEADLINE_ALLOWLIST)} == {
        WAIVERS / "baseline.txt", WAIVERS / "lockorder_allow.txt",
        WAIVERS / "blocking_allow.txt", WAIVERS / "epoch_allow.txt",
        WAIVERS / "deadline_allow.txt",
    }
    rc = main([])
    out = capsys.readouterr()
    assert rc == 0, out.out
    assert "analysis: 0 new finding(s)" in out.err
    assert "0 stale waiver(s)" in out.err


def test_a_subset_of_checkers_neither_fails_on_nor_prunes_the_others_waivers(tmp_path, capsys):
    """``--checks blocking,dtype`` over the port: the baseline's guarded and
    taint waivers belong to checkers that did not run, so they are neither
    stale nor pruned, and every allow file is live. The run reads copies
    of the waiver files, so ``--prune-stale`` cannot rewrite the checkout's."""
    names = ("baseline.txt", "lockorder_allow.txt", "blocking_allow.txt",
             "epoch_allow.txt", "deadline_allow.txt")
    for name in names:
        (tmp_path / name).write_text((WAIVERS / name).read_text())
    before = {name: (tmp_path / name).read_text() for name in names}
    assert "guarded|" in before["baseline.txt"] and "taint|" in before["baseline.txt"]
    args = ["--checks", "blocking,dtype",
            "--baseline", str(tmp_path / "baseline.txt"),
            "--allowlist", str(tmp_path / "lockorder_allow.txt"),
            "--blocking-allowlist", str(tmp_path / "blocking_allow.txt"),
            "--epoch-allowlist", str(tmp_path / "epoch_allow.txt"),
            "--deadline-allowlist", str(tmp_path / "deadline_allow.txt")]
    assert main(args + ["--prune-stale"]) == 0
    assert {name: (tmp_path / name).read_text() for name in names} == before
    capsys.readouterr()
    rc = main(args)
    out = capsys.readouterr()
    assert rc == 0, out.out
    assert "analysis: 0 new finding(s), 0 waived, 0 stale waiver(s)" in out.err
