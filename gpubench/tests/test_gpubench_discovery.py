"""A configuration, a traffic mix and a per-layer metric are added with
new files and new BENCHMARK.json entries alone: in a copy of the
benchmark, the new cell resolves, runs (on the CPU, at a tiny size) and
reports the new metric, and no file that was there changed."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from gpubench.tests.tiny import ROOT


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_add_a_cell_and_a_metric(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "gpubench")

    pkg = tmp_path / "gpubench"
    cfg = json.loads((pkg / "configs" / "throttles-100k.json").read_text())
    cfg.update(name="tiny-new")
    cfg["namespaces"]["count"] = 5
    cfg["pods"].update(per_namespace=10, running=7)
    cfg["throttles"]["per_namespace"] = 2
    cfg["throttles"]["overrides"]["count"] = 3
    (pkg / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "triage-light.json").write_text(json.dumps({"driver": "triage"}))
    (pkg / "metrics" / "calls_done.triage-light.py").write_text(
        '"""Calls completed in the traced window."""\n\nSPANS = ()\n\n\n'
        "def read(rec):\n    return float(rec.calls) if rec.calls else None\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = "tiny-new.triage-light"
    bench["configs"].append({"name": "tiny-new", "source": "https://example.org/tiny",
                             "file": "gpubench/configs/tiny-new.json", "reduced": [],
                             "why": "a discovery test"})
    bench["workloads"].append({"name": cell, "config": "tiny-new", "traffic": "triage-light",
                               "chips": 1, "why": "a discovery test"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["triage_pods_per_s"]["workloads"].append(cell)
    bench["per_layer"].append({"name": "calls_done.triage-light", "unit": "calls",
                               "better": "higher", "source": "host_clock", "layer": "plugin",
                               "moves": "triage_pods_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json\nfrom gpubench import run\n"
        f"out = run.run_cell(run.resolve_cell({cell!r}), 2**40 + 1, 0.3, True, 'cpu')\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["calls_done.triage-light"]["value"] >= 1
    assert set(out["metrics"]) == {"calls_done.triage-light"}  # no reader of another cell's

    after = _digests(tmp_path / "gpubench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/tiny-new.json", "traffic/triage-light.json",
                                        "metrics/calls_done.triage-light.py"}
