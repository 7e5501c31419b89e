"""The port's runtime race detector names what it tracks as the JAX
package's does: the module path below the package
(``sharding.ipc.ShardClient.dropped``), not the port's full module name,
so the port's race waivers are keyed as the reference's. The port reads
its waivers from ``kube_throttler_tpu_torch/analysis_waivers/race_allow.txt``,
which holds exactly the reference's, each naming a guarded attribute the
port has."""

import ast
from pathlib import Path

import pytest

from kube_throttler_tpu.utils import racedetect as j_racedetect
from kube_throttler_tpu_torch.utils import racedetect

PORT = Path(__file__).resolve().parent.parent / "kube_throttler_tpu_torch"


@pytest.mark.parametrize("module, cls, attr", [
    ("sharding.ipc", "ShardClient", "dropped"),
    ("engine.verdictcache", "VerdictCache", "insertions"),
])
def test_descriptor_names_equal_the_reference(module, cls, attr):
    quals = []
    for mod, package in ((j_racedetect, "kube_throttler_tpu"),
                         (racedetect, "kube_throttler_tpu_torch")):
        fake = type(cls, (), {"__module__": f"{package}.{module}"})
        mod.install_descriptors(fake, [attr])
        quals.append(fake.__dict__[attr].qual)
    assert quals[1] == quals[0] == f"{module}.{cls}.{attr}"


def _guarded_attrs():
    out = set()
    for path in PORT.rglob("*.py"):
        rel = ".".join(path.relative_to(PORT).with_suffix("").parts)
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if not isinstance(node, ast.ClassDef):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "GUARDED_BY" for t in stmt.targets):
                    for attr in ast.literal_eval(stmt.value):
                        out.add(f"{rel}.{node.name}.{attr}")
    return out


def test_the_port_waives_what_the_reference_waives():
    allow = racedetect.load_allow()
    assert racedetect.default_allow_path() == str(PORT / "analysis_waivers" / "race_allow.txt")
    assert allow == j_racedetect.load_allow()
    assert all(why.strip() for why in allow.values())
    assert not set(allow) - _guarded_attrs(), "waivers naming no guarded attribute of the port"
