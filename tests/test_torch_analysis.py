"""The repository's static analyzer over the port: 0 new findings against
the port's own baseline and allow files
(``kube_throttler_tpu_torch/analysis_waivers/``), and none of them stale."""

from pathlib import Path

from kube_throttler_tpu.analysis.__main__ import main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kube_throttler_tpu_torch"
WAIVERS = PORT / "analysis_waivers"


def test_analyzer_reports_no_new_finding_over_the_port(capsys):
    rc = main([
        "--root", str(PORT),
        "--baseline", str(WAIVERS / "baseline.txt"),
        "--allowlist", str(WAIVERS / "lockorder_allow.txt"),
        "--blocking-allowlist", str(WAIVERS / "blocking_allow.txt"),
        "--epoch-allowlist", str(WAIVERS / "epoch_allow.txt"),
        "--deadline-allowlist", str(WAIVERS / "deadline_allow.txt"),
    ])
    out = capsys.readouterr()
    assert rc == 0, out.out
    assert "analysis: 0 new finding(s)" in out.err
    assert "0 stale waiver(s)" in out.err
