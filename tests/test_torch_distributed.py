"""The grid step across processes: two ranks on gloo on the CPU
(``tests/torch_dist_child.py``), each holding half the pods of a seeded
tick on a (2, 2) grid of its own, the pods axis spanning both, the
used partials summed by ``all_reduce``. Gathered (per-pod outputs laid end
to end, per-throttle outputs equal on both ranks) they ≡ the JAX
package's 8-device (4, 2) ``shard_map`` step and the port's 1×1 step, also
where the int64 used sums wrap, as XLA's do.

The ranks meet through a ``file://`` rendezvous under the test's
``tmp_path``, so parallel test workers never race for a port; each run
has its own deadline and its children are killed on failure."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kube_throttler_tpu.ops.schema as jschema
import kube_throttler_tpu.parallel as jpar
import kube_throttler_tpu.parallel.sharded as jsharded
import kube_throttler_tpu_torch.ops.schema as tschema
import kube_throttler_tpu_torch.parallel as tpar
from tests.test_torch_parallel import assert_outputs
from tests.test_torch_tick import _insert, step_inputs

CHILD = Path(__file__).resolve().parent / "torch_dist_child.py"
WORLD = 2
DEADLINE_S = 120


def run_ranks(tmp_path: Path, route: str, args) -> list:
    """Both ranks' six outputs, the ranks run as child processes."""
    inp = tmp_path / "inputs.pt"
    torch.save(tuple(args), inp)
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(CHILD), str(r), str(WORLD), init, route, str(inp),
             str(tmp_path / f"out{r}.pt")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(tmp_path / f"out{r}.pt") for r in range(WORLD)]


def gathered(outs):
    """Per-pod outputs of the ranks laid end to end; the per-throttle
    outputs, which every rank holds whole, must agree."""
    for k in range(2, 6):
        assert all(torch.equal(o[k], outs[0][k]) for o in outs[1:]), k
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]), *outs[0][2:])


def inputs(seed: int, wrap: bool):
    """(JAX args, port args, mask, cols) of a seeded tick; with ``wrap``,
    every request is 2^62 or 2^62 + 1, so the used sums pass 2^63."""
    jargs, targs, mask, cols = step_inputs(seed)
    if wrap:
        req = np.asarray(jargs[1].req)
        big = np.where(np.arange(req.size).reshape(req.shape) % 2, 2**62, 2**62 + 1)
        pods = dict(valid=np.asarray(jargs[1].valid), req=big.astype(np.int64),
                    req_present=np.asarray(jargs[1].req_present))
        jargs = (jargs[0], jschema.PodBatch(**pods), *jargs[2:])
        targs = (targs[0], tschema.pod_batch_from_arrays(pods, device="cpu"), *targs[2:])
    return jargs, targs, mask, cols


@pytest.mark.parametrize("route", ["gather", "dense"])
@pytest.mark.parametrize("wrap", [False, True])
def test_two_ranks_match_jax_and_one_device(tmp_path, route, wrap):
    jargs, targs, mask, cols = inputs(8, wrap)
    x = cols if route == "gather" else mask
    jbuild = (jsharded.sharded_full_update_gather if route == "gather"
              else jpar.sharded_full_update)
    want = jbuild(jpar.make_mesh(8, (4, 2)))(*_insert(jargs, x))
    got = gathered(run_ranks(tmp_path, route, _insert(targs, torch.from_numpy(x))))
    assert_outputs(got, want, f"2 ranks {route}")
    single = (tpar.full_update_step_gather if route == "gather" else tpar.full_update_step)(
        *_insert(targs, torch.from_numpy(x)))
    assert all(torch.equal(g, s) for g, s in zip(got, single))
    used_req = np.asarray(want[3])
    if wrap:
        assert (used_req < 0).any(), "no used sum wrapped past 2^63"
    else:
        assert (np.asarray(want[0]).sum(0) > 0).all(), "expected all 4 classes"
