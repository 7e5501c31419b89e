"""Port parity for the grid forms of the full update step (a copy of
``tests/test_parallel.py``): on the same seeded inputs, the port's
sharded steps on a CPU grid ≡ the JAX package's ``shard_map`` programs on
the conftest's 8 host devices, for every mesh shape of 8 devices, bit for
bit and with the same dtypes; the port's grid ≡ its single-device step;
``sharded_apply_deltas`` ≡ JAX's sharded form with ids drawn from
[−T, T] (a negative id is dropped there), and the 1×1 apply ≡ JAX's
single-device form (which counts it from the end)."""

import random

import jax
import numpy as np
import pytest
import torch

import kube_throttler_tpu.parallel as jpar
import kube_throttler_tpu.parallel.sharded as jsharded
import kube_throttler_tpu_torch.parallel as tpar
from kube_throttler_tpu.ops.aggregate import apply_pod_deltas_batched as japply
from kube_throttler_tpu_torch.ops.aggregate import apply_pod_deltas_batched as tapply
from kube_throttler_tpu_torch.ops.schema import (
    override_schedule_from_arrays,
    pod_batch_from_arrays,
)
from kube_throttler_tpu_torch.parallel.mesh import Split
from tests.test_parallel import _build_inputs
from tests.test_torch_ops import _assert_same
from tests.test_torch_tick import NAMES, VARIANTS, _insert, step_inputs

CPU = "cpu"
SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]


def fields_np(dc):
    return {k: np.asarray(v) for k, v in vars(dc).items()}


def port_inputs(inputs):
    """The reference test's step inputs (schedule, pods, mask, counted,
    reservations, validity, now) as the port's CPU tensors."""
    sched, pods, *arrays = inputs
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return (override_schedule_from_arrays(fields_np(sched), device=CPU),
            pod_batch_from_arrays(fields_np(pods), device=CPU), *map(t, arrays))


def assert_outputs(got, want, label=""):
    assert len(got) == len(want) == len(NAMES)
    for name, g, w in zip(NAMES, got, want):
        _assert_same(g, w, f"{label} {name}")


def test_sharded_matches_single_device():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    rng = random.Random(0)
    inputs = _build_inputs(rng, 32, 16)  # 32 pods over dp=4, 16 throttles over tp=2
    want = jpar.sharded_full_update(jpar.make_mesh(8, shape=(4, 2)))(*inputs)
    grid = tpar.make_mesh(8, shape=(4, 2), device=CPU)
    got = tpar.sharded_full_update(grid)(*port_inputs(inputs))
    assert_outputs(got, want, "(4, 2)")
    assert_outputs(tpar.full_update_step(*port_inputs(inputs)), want, "1x1")


def test_mesh_factorization():
    for n in range(1, 9):
        grid = tpar.make_mesh(n, device=CPU)
        want = jpar.make_mesh(n).devices.shape
        assert (grid.dp, grid.tp) == want, n
        assert grid.shape == {"pods": want[0], "throttles": want[1]}
        assert all(d == torch.device(CPU) for row in grid.devices for d in row)
    grid = tpar.make_mesh(8, device=CPU)
    assert len(grid.slots()) == 8 and grid.world == 1
    # explicit slots, repeats allowed, laid pods-major
    grid = tpar.make_mesh(shape=(2, 2), devices=["cpu:0", "cpu:1", "cpu:2", "cpu:3"])
    assert grid.devices == ((torch.device("cpu", 0), torch.device("cpu", 1)),
                            (torch.device("cpu", 2), torch.device("cpu", 3)))
    # no shape, no count: one slot on the CPU
    assert tpar.make_mesh(device=CPU).shape == {"pods": 1, "throttles": 1}


@pytest.mark.parametrize("shape", [(8, 1), (2, 4), (1, 8)])
def test_all_mesh_shapes(shape):
    rng = random.Random(1)
    inputs = _build_inputs(rng, 16, 8)
    want = jpar.sharded_full_update(jpar.make_mesh(8, shape=shape))(*inputs)
    got = tpar.sharded_full_update(tpar.make_mesh(8, shape, device=CPU))(*port_inputs(inputs))
    assert_outputs(got, want, str(shape))
    assert_outputs(tpar.full_update_step(*port_inputs(inputs)), want, "1x1")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("on_equal,step3", VARIANTS)
def test_sparse_sharded_matches_jax(shape, on_equal, step3):
    """The sparse grid step (cols rebased per throttle tile) ≡ JAX's
    ``sharded_full_update_gather`` on the same mesh shape, for every
    (on_equal, step3) pair; on matches that all lie in [0, T) it also ≡
    the port's dense grid step and its single-device sparse step."""
    jargs, targs, mask, cols = step_inputs(8)
    want = jsharded.sharded_full_update_gather(
        jpar.make_mesh(8, shape), on_equal=on_equal, step3_on_equal=step3
    )(*_insert(jargs, cols))
    grid = tpar.make_mesh(8, shape, device=CPU)
    got = tpar.sharded_full_update_gather(grid, on_equal=on_equal, step3_on_equal=step3)(
        *_insert(targs, torch.from_numpy(cols)))
    assert_outputs(got, want, str(shape))
    assert (np.asarray(want[0]).sum(0) > 0).all(), "expected all 4 classes"
    dense = tpar.sharded_full_update(grid, on_equal=on_equal, step3_on_equal=step3)(
        *_insert(targs, torch.from_numpy(mask)))
    single = tpar.full_update_step_gather(*_insert(targs, torch.from_numpy(cols)),
                                          on_equal=on_equal, step3_on_equal=step3)
    for name, g, d, s in zip(NAMES, got, dense, single):
        assert torch.equal(g, d) and torch.equal(g, s), name


@pytest.mark.parametrize("shape", SHAPES)
def test_dense_sharded_matches_jax_on_tick_inputs(shape):
    """The dense grid step on the tick's override-laden schedule ≡ JAX's
    dense ``shard_map`` program (the reference test's inputs carry one
    override a throttle at most)."""
    jargs, targs, mask, _ = step_inputs(4)
    want = jpar.sharded_full_update(jpar.make_mesh(8, shape))(*_insert(jargs, mask))
    got = tpar.sharded_full_update(tpar.make_mesh(8, shape, device=CPU))(
        *_insert(targs, torch.from_numpy(mask)))
    assert_outputs(got, want, str(shape))


def delta_inputs(seed=3, T=16, R=4, N=24, K=3):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 50, T).astype(np.int64),
        rng.integers(0, 64, (T, R)).astype(np.int64) * 1000,
        rng.integers(0, 10, (T, R)).astype(np.int32),
        # ids from [-T, T]: negatives, and the pad T, that no tile owns
        rng.integers(-T, T + 1, (N, K)).astype(np.int32),
        rng.choice(np.array([-1, 0, 1], dtype=np.int64), (N, K)),
        rng.integers(0, 900, (N, R)).astype(np.int64),
        rng.random((N, R)) < 0.7,
    )


def as_torch(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("shape", [(1, 8), (4, 2), (8, 1)])
def test_sharded_deltas_match_single_device(shape):
    """The streaming scatter-add over a throttle-split grid ≡ JAX's
    sharded form on the same mesh shape: every in-range id lands in
    exactly one tile, and every other id (the pad T, a negative id) drops
    on every tile; on ids in [0, T] it ≡ the single-device apply."""
    arrays = delta_inputs()
    ids = arrays[3]
    assert (ids < 0).any() and (ids == 16).any()
    want = jsharded.sharded_apply_deltas(jpar.make_mesh(8, shape))(*arrays)
    got = tpar.sharded_apply_deltas(tpar.make_mesh(8, shape, device=CPU))(*as_torch(arrays))
    for name, g, w in zip(("used_cnt", "used_req", "contrib"), got, want):
        _assert_same(g, w, f"{shape} {name}")
    # the negative ids dropped: the single-device apply with them as pads
    in_range = list(as_torch(arrays))
    in_range[3] = torch.where(in_range[3] < 0, 16, in_range[3])
    for g, s in zip(got, tapply(*in_range)):
        assert torch.equal(g, s)


def test_single_device_deltas_count_negative_ids_from_the_end():
    """The 1×1 apply ≡ JAX's single-device ``apply_pod_deltas_batched``,
    which counts a negative id from the end (-1 adds into row T - 1)."""
    arrays = delta_inputs(seed=5)
    want = japply(*arrays)
    got = tapply(*as_torch(arrays))
    for name, g, w in zip(("used_cnt", "used_req", "contrib"), got, want):
        _assert_same(g, w, name)
    sharded = tpar.sharded_apply_deltas(tpar.make_mesh(device=CPU))(*as_torch(arrays))
    assert not all(torch.equal(g, s) for g, s in zip(got, sharded)), (
        "the seed draws no negative id that the two forms treat apart"
    )


def test_mesh_shardings_split_as_the_jax_specs():
    grid = tpar.make_mesh(8, (4, 2), device=CPU)
    pod, thr, mask, rep = tpar.mesh_shardings(grid)
    x = torch.arange(16 * 6).reshape(16, 6)
    coords = {"pods": (3, 4), "throttles": (1, 2)}
    assert torch.equal(pod.tile(x, coords, grid.slot(3, 1)), x[12:16])
    assert torch.equal(thr.tile(x, coords, grid.slot(3, 1)), x[8:16])
    tile = mask.tile(x, coords, grid.slot(3, 1))
    assert torch.equal(tile, x[12:16, 3:6]) and tile.is_contiguous()
    assert torch.equal(rep.tile(x, coords, grid.slot(3, 1)), x)
    assert Split((None, "throttles")).tile(x, coords, grid.slot(0, 0)).shape == (16, 3)
