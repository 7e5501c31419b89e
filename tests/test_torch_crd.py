"""CRD generation + structural validation (deploy/crd.yaml pipeline).

The reference ships a controller-gen'd deploy/crd.yaml; here the schema is
derived from the typed model (api/crd.py) and deploy/crd.yaml is emitted by
tools/gen_crd_torch.py. These tests pin: the generated file is in sync with the
code, example manifests validate, typos are rejected, and manifests
round-trip through the typed objects.
"""

import subprocess
import sys
from pathlib import Path

import yaml

from kube_throttler_tpu_torch.api import crd, serialization

REPO = Path(__file__).resolve().parent.parent


def _load_all(path):
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def test_generated_crd_file_in_sync():
    docs = _load_all(REPO / "deploy" / "crd.yaml")
    assert docs == [crd.cluster_throttle_crd(), crd.throttle_crd()]


def test_gen_tool_runs(tmp_path):
    # write to a temp path: regenerating deploy/crd.yaml in place would
    # silently repair the drift test_generated_crd_file_in_sync exists to catch
    dest = tmp_path / "crd.yaml"
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "gen_crd_torch.py"), "--out", str(dest)],
        capture_output=True,
        text=True,
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert "2 documents" in out.stdout
    assert dest.read_text() == (REPO / "deploy" / "crd.yaml").read_text()


def test_crd_names_and_scope():
    t = crd.throttle_crd()
    ct = crd.cluster_throttle_crd()
    assert t["metadata"]["name"] == "throttles.schedule.k8s.everpeace.github.com"
    assert t["spec"]["scope"] == "Namespaced"
    assert ct["spec"]["scope"] == "Cluster"
    assert ct["spec"]["names"]["shortNames"] == ["clthr", "clthrs"]
    v = t["spec"]["versions"][0]
    assert v["name"] == "v1alpha1" and v["subresources"] == {"status": {}}


def test_example_manifests_validate_and_roundtrip():
    for name in ["throttle.yaml", "clusterthrottle.yaml", "throttle-with-overrides.yaml"]:
        for raw in _load_all(REPO / "examples" / name):
            # kubectl-style YAML→JSON normalization (RFC3339 strings, typo keys)
            doc = serialization.normalize_manifest(raw)
            assert crd.validate(doc) == [], (name, crd.validate(doc))
            obj = serialization.object_from_dict(doc)
            back = serialization.object_to_dict(obj)
            assert crd.validate(back) == [], (name, crd.validate(back))
            # spec survives the round trip
            assert serialization.object_from_dict(back).spec == obj.spec


def test_example_pods_parse():
    pods = [serialization.pod_from_dict(d) for d in _load_all(REPO / "examples" / "pods.yaml")]
    assert [p.name for p in pods] == ["pod1", "pod2", "pod1m", "pod3"]
    assert all(p.spec.scheduler_name == "my-scheduler" for p in pods)


def test_validation_rejects_typos_and_wrong_types():
    bad_field = {
        "apiVersion": crd.API_VERSION,
        "kind": "Throttle",
        "metadata": {"name": "x"},
        "spec": {"throttlerName": "t", "thresold": {}},  # typo
    }
    errs = crd.validate(bad_field)
    assert any("thresold" in str(e) for e in errs)

    bad_type = {
        "kind": "ClusterThrottle",
        "spec": {"threshold": {"resourceCounts": {"pod": "five"}}},
    }
    errs = crd.validate(bad_type)
    assert any("resourceCounts.pod" in str(e) for e in errs)

    bad_expr = {
        "kind": "Throttle",
        "spec": {
            "selector": {
                "selectorTerms": [
                    {"podSelector": {"matchExpressions": [{"key": "k"}]}}  # missing operator
                ]
            }
        },
    }
    errs = crd.validate(bad_expr)
    assert any("operator" in str(e) for e in errs)


def test_quantity_schema_accepts_int_or_string():
    ok = {
        "kind": "Throttle",
        "spec": {"threshold": {"resourceRequests": {"cpu": 1, "memory": "1Gi"}}},
    }
    assert crd.validate(ok) == []
    bad = {
        "kind": "Throttle",
        "spec": {"threshold": {"resourceRequests": {"cpu": 0.5}}},
    }
    assert crd.validate(bad) != []


def test_deploy_manifests_are_well_formed_yaml():
    deploy = REPO / "deploy"
    names = {p.name for p in deploy.glob("*.yaml")}
    assert {
        "crd.yaml",
        "config.yaml",
        "deployment.yaml",
        "rbac.yaml",
        "namespace.yaml",
        "kustomization.yaml",
    } <= names
    for p in sorted(deploy.glob("*.yaml")) + [REPO / "prometheus" / "servicemonitor.yaml"]:
        docs = _load_all(p)
        assert docs, p
        for d in docs:
            assert "kind" in d, p
    # the daemon config embedded in the ConfigMap decodes as plugin args
    cfg = yaml.safe_load((deploy / "config.yaml").read_text())
    sched = yaml.safe_load(cfg["data"]["config.yaml"])
    args = sched["profiles"][0]["pluginConfig"][0]["args"]
    from kube_throttler_tpu_torch.plugin import decode_plugin_args

    decoded = decode_plugin_args(args)
    assert decoded.name == "kube-throttler"
    assert decoded.target_scheduler_name == "my-scheduler"


def test_quantity_pattern_rejects_garbage_strings():
    bad = {
        "kind": "Throttle",
        "spec": {"threshold": {"resourceRequests": {"cpu": "lots"}}},
    }
    errs = crd.validate(bad)
    assert any("pattern" in str(e) for e in errs)
    # suffixed forms still pass
    ok = {
        "kind": "Throttle",
        "spec": {"threshold": {"resourceRequests": {"cpu": "1500m", "memory": "2Gi", "x": "1e3"}}},
    }
    assert crd.validate(ok) == []


def test_date_only_override_boundary_normalizes():
    import datetime as dt

    raw = {
        "kind": "Throttle",
        "metadata": {"name": "d"},
        "spec": {
            "throttlerName": "t",
            "temporaryThresholdOverrides": [
                {"begin": dt.date(2024, 1, 1), "end": dt.date(2024, 1, 7), "threshold": {}}
            ],
        },
    }
    norm = serialization.normalize_manifest(raw)
    assert norm["spec"]["temporaryThresholdOverrides"][0]["begin"] == "2024-01-01"
    assert crd.validate(norm) == []
    obj = serialization.object_from_dict(norm)
    assert obj.spec.temporary_threshold_overrides[0].begin == "2024-01-01"
