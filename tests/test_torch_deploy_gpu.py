"""The port's deployment files, read statically on the CPU:
``deploy/gpu/`` (the daemon Deployment and the TCP shard fleet),
``Dockerfile.gpu`` and the Makefile's GPU targets.

- Every YAML document loads, and every container command parses with the
  port's own argument parser (``cli.build_parser``,
  ``sharding.worker.build_parser``).
- Every pod that runs the daemon or a worker on a device limits
  ``nvidia.com/gpu``; a front that dials every shard runs no worker and
  holds no card; nothing asks for ``google.com/tpu``.
- Each kustomization lists only files that exist.
- Every ``COPY`` source of ``Dockerfile.gpu`` exists in the tree, and it
  prebuilds the kernels with the entry point the chip smoke's
  ``[deployed]`` phase runs, into the folder ``kernels.py`` reads first.
"""

import re
import shlex
from pathlib import Path

import pytest
import yaml

from kube_throttler_tpu_torch import cli, kernels
from kube_throttler_tpu_torch.sharding import worker

REPO = Path(__file__).resolve().parent.parent
GPU = REPO / "deploy" / "gpu"
MANIFESTS = sorted(p for p in GPU.glob("*.yaml") if p.name != "kustomization.yaml")
PARSERS = {"kube_throttler_tpu_torch.cli": cli.build_parser,
           "kube_throttler_tpu_torch.sharding.worker": worker.build_parser}


def _docs(path):
    return [d for d in yaml.safe_load_all(path.read_text()) if d]


def _containers():
    """(manifest, workload, container) for every pod template."""
    for path in MANIFESTS:
        for doc in _docs(path):
            spec = (doc.get("spec") or {}).get("template", {}).get("spec")
            if spec:
                for c in spec["containers"]:
                    yield path.name, doc["metadata"]["name"], c


def _argv(container):
    """(module, argv) of a ``python -m module ...`` command, directly or
    through ``/bin/sh -c 'exec python -m ...'`` (the pod's ordinal as the
    shard id)."""
    cmd = container["command"]
    if cmd[:2] == ["/bin/sh", "-c"]:
        cmd = shlex.split(cmd[2].replace('"${HOSTNAME##*-}"', "0").replace("\\\n", " "))
        assert cmd[0] == "exec"
        cmd = cmd[1:]
    assert cmd[:2] == ["python", "-m"], cmd
    return cmd[2], cmd[3:]


def test_the_manifests_load_and_name_the_gpu_image():
    assert [p.name for p in MANIFESTS] == ["deployment.yaml", "sharded-fleet.yaml"]
    found = list(_containers())
    assert len(found) == 3
    for _, _, c in found:
        assert c["image"] == "kube-throttler-gpu:latest"


@pytest.mark.parametrize("where, name, container",
                         list(_containers()), ids=lambda x: x if isinstance(x, str) else "")
def test_each_command_parses_and_a_device_pod_holds_a_card(where, name, container):
    module, argv = _argv(container)
    args = PARSERS[module]().parse_args(argv)
    limits = container.get("resources", {}).get("limits", {})
    assert "google.com/tpu" not in limits
    if module.endswith(".cli"):
        assert args.command == "serve" and args.device == "cuda"
        remote = [s.partition("=")[0] for s in args.shard_connect or []]
        front = args.shards > 0 and sorted(map(int, remote)) == list(range(args.shards))
        uses_card = not args.no_device and not front
        if front:
            assert args.shard_transport == "tcp"
            assert "KT_SHARD_AUTH_KEY" in {e["name"] for e in container.get("env", [])}
    else:
        assert args.listen.endswith(":17071") and args.device == "cuda"
        assert "KT_SHARD_AUTH_KEY" in {e["name"] for e in container.get("env", [])}
        uses_card = not args.no_device
    assert (limits.get("nvidia.com/gpu") == "1") is uses_card, (where, name, limits)


def test_the_fleet_front_dials_each_worker_of_the_statefulset():
    docs = {d["kind"]: d for d in _docs(GPU / "sharded-fleet.yaml")
            if d["kind"] in ("StatefulSet", "Deployment")}
    shards = docs["StatefulSet"]["spec"]["replicas"]
    (front,) = docs["Deployment"]["spec"]["template"]["spec"]["containers"]
    args = cli.build_parser().parse_args(_argv(front)[1])
    service = docs["StatefulSet"]["spec"]["serviceName"]
    sts = docs["StatefulSet"]["metadata"]["name"]
    assert args.shards == shards
    assert sorted(args.shard_connect) == [
        f"{i}={sts}-{i}.{service}:17071" for i in range(shards)]


@pytest.mark.parametrize("kustomization", sorted(REPO.glob("deploy/**/kustomization.yaml")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_each_kustomization_lists_only_files_that_exist(kustomization):
    doc = yaml.safe_load(kustomization.read_text())
    assert doc["resources"]
    for res in doc["resources"]:
        assert (kustomization.parent / res).is_file(), res
        assert not res.startswith(".."), "the default load restrictor refuses it"


def _dockerfile():
    """``Dockerfile.gpu`` without its comments, continuation lines joined."""
    lines = [x for x in (REPO / "Dockerfile.gpu").read_text().splitlines()
             if not x.lstrip().startswith("#")]
    return re.sub(r"\\\n\s*", " ", "\n".join(lines) + "\n")


def test_the_dockerfile_copies_only_what_the_tree_holds():
    copies = [line.split()[1:] for line in _dockerfile().splitlines()
              if line.startswith("COPY ")]
    assert copies
    for args in copies:
        if args[0].startswith("--from="):
            continue
        *sources, _dest = args
        for src in sources:
            assert (REPO / src).exists(), src


def test_the_dockerfile_prebuilds_the_kernels_for_its_runtime():
    text = _dockerfile()
    stages = re.split(r"^FROM ", text, flags=re.M)[1:]
    assert len(stages) == 2
    build_stage, runtime = stages
    assert "-devel-" in build_stage.splitlines()[0] and "-runtime-" in runtime.splitlines()[0]
    assert "python -m kube_throttler_tpu_torch.kernels --prebuild" in build_stage
    assert f"/{kernels.PREBUILT_DIR.name}/" in build_stage and f'/{kernels.PREBUILT_DIR.name}"' in runtime
    assert "nvcc" not in runtime and "--prebuild" not in runtime
    assert "USER 65532" in runtime and "ENV XDG_CACHE_HOME=/tmp/.cache" in runtime
    assert 'ENTRYPOINT ["python", "-m", "kube_throttler_tpu_torch.cli"]' in runtime


def test_the_makefile_builds_and_runs_the_port():
    make = (REPO / "Makefile").read_text()
    for target, body in (("image-gpu", "docker build -f Dockerfile.gpu -t kube-throttler-gpu:"),
                         ("serve-gpu", "-m kube_throttler_tpu_torch.cli serve"),
                         ("walkthrough-gpu", "examples/walkthrough_torch.py")):
        m = re.search(rf"^{target}:.*\n((?:\t.*\n)+)", make, re.M)
        assert m and body in m.group(1), target
