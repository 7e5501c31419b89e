"""Port parity for the ring-rotation sweep (a copy of ``tests/test_ring.py``):
the port's ring over 8 CPU slots ≡ the JAX package's ring over the
conftest's 8 host devices ≡ the port's single-device step, bit for bit;
plus ``init_distributed``, ``hybrid_mesh`` and ``shard_global_array`` in a
single process."""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import kube_throttler_tpu.parallel as jpar
import kube_throttler_tpu_torch.parallel as tpar
from kube_throttler_tpu_torch.parallel.mesh import Split
from tests.test_parallel import _build_inputs
from tests.test_torch_parallel import assert_outputs, port_inputs
from tests.test_torch_tick import _insert, step_inputs

CPU = "cpu"


@pytest.mark.parametrize("seed,P_,T_", [(0, 32, 16), (7, 16, 8), (11, 64, 8)])
def test_ring_matches_single_device(seed, P_, T_):
    assert len(jax.devices()) == 8
    rng = random.Random(seed)
    inputs = _build_inputs(rng, P_, T_)
    want = jpar.ring_full_update(jpar.make_ring_mesh(8))(*inputs)
    ring = tpar.make_ring_mesh(8, device=CPU)
    assert ring.n == 8 and ring.axis_names == ("ring",)
    assert_outputs(tpar.ring_full_update(ring)(*port_inputs(inputs)), want, "ring")
    assert_outputs(tpar.full_update_step(*port_inputs(inputs)), want, "1x1")


def test_ring_asymmetric_flags():
    # the Throttle-kind step3 asymmetry must survive the ring decomposition
    jargs, targs, mask, _ = step_inputs(6)
    jring, tring = jpar.make_ring_mesh(8), tpar.make_ring_mesh(8, device=CPU)
    for on_equal, s3 in [(True, True), (False, False), (True, False), (False, True)]:
        want = jpar.ring_full_update(jring, on_equal=on_equal, step3_on_equal=s3)(
            *_insert(jargs, mask))
        got = tpar.ring_full_update(tring, on_equal=on_equal, step3_on_equal=s3)(
            *_insert(targs, torch.from_numpy(mask)))
        assert_outputs(got, want, f"ring {on_equal} {s3}")
        single = tpar.full_update_step(*_insert(targs, torch.from_numpy(mask)),
                                       on_equal=on_equal, step3_on_equal=s3)
        assert all(torch.equal(g, s) for g, s in zip(got, single))


def test_ring_refuses_a_grid_and_an_undivided_shape():
    with pytest.raises(TypeError, match="single 'ring' axis"):
        tpar.ring_full_update(tpar.make_mesh(8, device=CPU))
    rng = random.Random(2)
    inputs = port_inputs(_build_inputs(rng, 12, 8))
    with pytest.raises(ValueError, match="does not divide 12 pods"):
        tpar.ring_full_update(tpar.make_ring_mesh(8, device=CPU))(*inputs)


def test_init_distributed_single_process_noop(monkeypatch):
    for var in ("KT_TPU_COORDINATOR", "KT_TPU_NUM_PROCESSES", "KT_TPU_PROCESS_ID",
                "KT_TPU_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.init_distributed() is False  # no coordinator configured → no-op
    monkeypatch.setenv("KT_TPU_NUM_PROCESSES", "1")
    assert tpar.init_distributed() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="need a coordinator"):
        tpar.init_distributed(num_processes=2, process_id=0, device=CPU)


def test_hybrid_mesh_single_process():
    grid = tpar.hybrid_mesh(device=CPU)
    assert grid.shape == {"pods": 1, "throttles": 1}
    grid = tpar.hybrid_mesh(devices=[CPU] * 8)
    assert grid.shape == {"pods": 4, "throttles": 2} and len(grid.slots()) == 8
    assert grid.shape == dict(zip(("pods", "throttles"), jpar.hybrid_mesh().devices.shape))


def test_shard_global_array_single_process():
    grid = tpar.hybrid_mesh(ici_shape=(4, 2), device=CPU)
    arr = np.arange(32, dtype=np.int64).reshape(8, 4)
    want = jpar.shard_global_array(jpar.hybrid_mesh(ici_shape=(4, 2)), P("pods", None), arr)
    tiles = tpar.shard_global_array(grid, Split(("pods", None)), arr)
    assert len(tiles) == 8
    # slot (i, j) holds pod rows i, whole on the throttles axis
    for (i, j), tile in zip(grid.slots(), tiles):
        np.testing.assert_array_equal(tile.numpy(), arr[2 * i:2 * i + 2])
        assert tile.device == grid.slot(i, j)
    whole = np.concatenate([tiles[i * 2].numpy() for i in range(4)])
    np.testing.assert_array_equal(whole, np.asarray(want))
    np.testing.assert_array_equal(whole, arr)


def test_grid_entry_points_need_an_explicit_cpu_without_cuda(tmp_path):
    """``device=None`` means CUDA for every grid entry point: without a
    card the ring, the hybrid grid and a configured ``init_distributed``
    (whose default backend follows the device) raise before anything
    starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_ring_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.hybrid_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.init_distributed(f"file://{tmp_path / 'rendezvous'}", 2, 0)
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "rendezvous").exists()
