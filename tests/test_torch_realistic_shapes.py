"""Port copy of ``tests/test_realistic_shapes.py``: the assertions of
``__graft_entry__._dryrun_realistic`` at P = 1024, T = 128, R = 8, in port
code on CPU slots — the 2-D grid step ≡ the 8-slot ring ≡ the 1×1 dense
step ≡ the sparse grid step over [P,K] global-id cols, every pod fully
classified, a verdict mix that is not degenerate — and every output ≡ the
JAX package's 8-device mesh on the same inputs. (The dryrun's other
assertion, no recompile on a second step of the same shapes, is about
``jax.jit``; the port compiles nothing per shape.)"""

from datetime import datetime, timedelta, timezone

import jax
import numpy as np
import torch

import kube_throttler_tpu.parallel as jpar
import kube_throttler_tpu_torch.parallel as tpar
from kube_throttler_tpu.api import ResourceAmount, TemporaryThresholdOverride
from kube_throttler_tpu.api.types import ThrottleSpecBase
from kube_throttler_tpu.ops.overrides import encode_override_schedule
from kube_throttler_tpu.ops.schema import DimRegistry, PodBatch
from tests.test_torch_parallel import assert_outputs, port_inputs

CPU = "cpu"
P, T, GROUPS = 1024, 128, 64  # each pod matches T / GROUPS = 2 throttles


def realistic_inputs():
    """The dryrun's seeded inputs: T specs (an eighth with an active
    override window), cpu requests on every pod, the grouped mask, half
    the pods counted."""
    rng = np.random.default_rng(42)
    now = datetime(2024, 1, 15, tzinfo=timezone.utc)
    rfc = lambda dt: dt.strftime("%Y-%m-%dT%H:%M:%SZ")  # noqa: E731

    def spec_for(j):
        pod_cap = int(rng.integers(1, 200)) if j % 3 else None
        cpu_cap = f"{int(rng.integers(1, 500)) * 100}m" if j % 2 else None
        overrides = ()
        if j % 8 == 0:
            overrides = (TemporaryThresholdOverride(
                begin=rfc(now - timedelta(hours=1)), end=rfc(now + timedelta(hours=1)),
                threshold=ResourceAmount.of(requests={"cpu": "100000"}),
            ),)
        return ThrottleSpecBase(
            threshold=ResourceAmount.of(pod=pod_cap,
                                        requests={"cpu": cpu_cap} if cpu_cap else None),
            temporary_threshold_overrides=overrides,
        )

    specs = [spec_for(j) for j in range(T)]
    dims = DimRegistry()
    sched = encode_override_schedule(specs, dims, throttle_capacity=T)
    R, cpu = dims.capacity, dims.index_of("cpu")
    pod_req = np.zeros((P, R), dtype=np.int64)
    pod_present = np.zeros((P, R), dtype=bool)
    pod_req[:, cpu] = rng.integers(100, 800, size=P) * 10
    pod_present[:, cpu] = True
    pods = PodBatch(valid=np.ones(P, dtype=bool), req=pod_req, req_present=pod_present)
    mask = (np.arange(P)[:, None] % GROUPS) == (np.arange(T)[None, :] % GROUPS)
    counted = rng.random(P) < 0.5
    res = (np.zeros(T, dtype=np.int64), np.zeros(T, dtype=bool),
           np.zeros((T, R), dtype=np.int64), np.zeros((T, R), dtype=bool))
    now_ns = np.int64(int(now.timestamp()) * 10**9)
    return (sched, pods, mask, counted, *res, np.ones(T, dtype=bool), now_ns)


def test_realistic_shape_parallel_agreement():
    assert len(jax.devices()) == 8
    inputs = realistic_inputs()
    want = jpar.sharded_full_update(jpar.make_mesh(8))(*inputs)
    targs = port_inputs(inputs)

    grid = tpar.make_mesh(8, device=CPU)
    assert grid.shape == {"pods": 4, "throttles": 2}
    a = tpar.sharded_full_update(grid)(*targs)
    b = tpar.ring_full_update(tpar.make_ring_mesh(8, device=CPU))(*targs)
    c = tpar.sharded_full_update(tpar.make_mesh(1, device=CPU))(*targs)  # the dense oracle
    K = T // GROUPS
    mask = inputs[2]
    cols = torch.from_numpy(np.stack([np.nonzero(mask[p])[0][:K] for p in range(P)])
                            .astype(np.int32))
    d = tpar.sharded_full_update_gather(grid)(*targs[:2], cols, *targs[3:])
    for label, out in (("2-D", a), ("ring", b), ("1x1 dense", c), ("sparse 2-D", d)):
        assert_outputs(out, want, label)

    counts, schedulable = a[0], a[1]
    assert counts.shape == (P, 4)
    assert (counts.sum(dim=1) == K).all(), "every pod fully classified"
    n_ok = int(schedulable.sum())
    assert 0 < n_ok < P, "degenerate verdict mix at realistic shapes"
