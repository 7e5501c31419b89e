"""The port's kernel plumbing on the CPU, with no ``nvcc`` and no card.

- ``kernels.load`` locks per name: one kernel's build never stalls the
  load of another, and concurrent loads of one name build once (the build
  and ``ctypes.CDLL`` are stubbed).
- ``check_dense._launch_shape`` stays within CUDA's launch limits and
  covers every (pod, throttle) cell exactly once, at extents up to
  2^31 - 1.
- ``check_dense.launch_args`` passes its planes in the order of the C
  signature in ``csrc/check_dense.cu``.
"""

import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kube_throttler_tpu_torch import kernels
from kube_throttler_tpu_torch.ops import check_dense as cd
from kube_throttler_tpu_torch.ops.schema import (
    check_precomp_from_arrays,
    pod_batch_from_arrays,
)

INT32_MAX = 2**31 - 1
GRID_Y_MAX = 65535


@pytest.fixture
def stub_build(monkeypatch):
    """Fresh loader state; ``build`` records its calls and, for a name in
    ``gates``, blocks until that gate's event is set."""
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_name_locks", {})
    calls, gates, entered = [], {}, {}

    def build(name):
        calls.append(name)
        entered.setdefault(name, threading.Event()).set()
        if name in gates:
            assert gates[name].wait(10), "test gate never opened"
        return Path(f"/nonexistent/{name}.so")

    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: ("lib", path))
    return calls, gates, entered


def _start(fn, *args):
    out = {}
    th = threading.Thread(target=lambda: out.setdefault("lib", fn(*args)), daemon=True)
    th.start()
    return th, out


def test_build_of_one_name_does_not_block_another(stub_build):
    calls, gates, entered = stub_build
    gates["slow"] = threading.Event()
    th, slow = _start(kernels.load, "slow")
    assert entered.setdefault("slow", threading.Event()).wait(5)
    t0 = time.perf_counter()
    fast = kernels.load("fast")
    assert time.perf_counter() - t0 < 1.0
    assert fast == ("lib", "/nonexistent/fast.so")
    assert th.is_alive()  # the slow build is still running
    gates["slow"].set()
    th.join(5)
    assert slow["lib"] == ("lib", "/nonexistent/slow.so")
    assert sorted(calls) == ["fast", "slow"]


def test_concurrent_loads_of_one_name_build_once(stub_build):
    calls, gates, entered = stub_build
    gates["k"] = threading.Event()
    first, a = _start(kernels.load, "k")
    assert entered.setdefault("k", threading.Event()).wait(5)
    second, b = _start(kernels.load, "k")
    time.sleep(0.05)  # the second load is now waiting on the name's lock
    gates["k"].set()
    first.join(5)
    second.join(5)
    assert calls == ["k"]
    assert a["lib"] is b["lib"]
    assert kernels.load("k") is a["lib"]
    assert calls == ["k"]


EXTENTS = [1, 15, 16, 17, 65536, 2097121, INT32_MAX]


def _rows_covered(shape, P):
    """How often the kernel's strip walk visits each pod row (its index
    math, in Python: blockIdx.y, threadIdx.y, the unrolled steps)."""
    _, by = shape.block
    seen = np.zeros(P, np.int64)
    for y in range(shape.grid[1]):
        begin, end = y * shape.strip, min(P, (y + 1) * shape.strip)
        for ty in range(by):
            for p0 in range(begin + ty, end, cd._UNROLL * by):
                for k in range(cd._UNROLL):
                    if p0 + k * by < end:
                        seen[p0 + k * by] += 1
    return seen


@pytest.mark.parametrize("R", [1, 8, 16, 17])
@pytest.mark.parametrize("T", EXTENTS)
@pytest.mark.parametrize("P", EXTENTS)
def test_launch_shape_within_cuda_limits(P, T, R):
    shape = cd._launch_shape(P, T, R)
    (bx, by), (gx, gy) = shape.block, shape.grid
    assert bx * by == 256 and bx >= 1 and by >= 1
    assert 1 <= gx <= INT32_MAX and 1 <= gy <= GRID_Y_MAX
    # throttle tiles on grid.x: every column once, no empty tile
    assert (gx - 1) * bx < T <= gx * bx
    # pod strips on grid.y: every row, no empty strip, int32 strip length
    assert 1 <= shape.strip <= min(P, INT32_MAX)
    assert (gy - 1) * shape.strip < P <= gy * shape.strip
    assert shape.strip == P or shape.strip % (by * cd._UNROLL) == 0
    if R <= 16:
        assert shape.rbucket >= R and shape.smem == 0
    else:
        assert shape.rbucket == 0 and bx * R * 17 <= shape.smem <= 232448
    if P <= 65536:
        assert (_rows_covered(shape, P) == 1).all()


@pytest.mark.parametrize("target_blocks,bt_max", [(1056, 256), (4224, 64), (1, 16)])
def test_launch_shape_variants_cover_every_row(target_blocks, bt_max):
    P, T = 5000, 300
    shape = cd._launch_shape(P, T, 8, target_blocks=target_blocks, bt_max=bt_max)
    assert shape.block[0] == bt_max and shape.grid[0] * bt_max >= T
    assert (_rows_covered(shape, P) == 1).all()


def test_launch_shape_main_path_and_sweep():
    """The geometry at the main path's dense shape and at the sweep."""
    assert cd._launch_shape(131072, 16, 8) == cd.LaunchShape((16, 16), (1, 2048), 64, 8, 0)
    assert cd._launch_shape(131072, 10240, 8) == cd.LaunchShape((64, 4), (160, 27), 4864, 8, 0)
    assert cd._launch_shape(131072, 10240, 8, bt_max=256) == \
        cd.LaunchShape((256, 1), (40, 106), 1240, 8, 0)
    # the T past grid.y's old cap runs as throttle tiles on grid.x
    assert cd._launch_shape(4, 2_200_000, 8).grid == (34375, 1)


def test_launch_shape_shared_route_narrows_the_tile():
    assert cd._launch_shape(64, 10240, 20).block == (64, 4)
    wide = cd._launch_shape(64, 10240, 300)
    assert wide.block == (32, 8) and wide.smem == 32 * 300 * 17
    assert cd._launch_shape(64, 10240, 13673).block == (1, 256)
    with pytest.raises(ValueError, match="shared-memory route"):
        cd._launch_shape(64, 10240, 13674)


def _c_params():
    """Parameter names of ``kt_check_dense`` in csrc/check_dense.cu."""
    src = (Path(cd.__file__).resolve().parent.parent / "csrc" / "check_dense.cu").read_text()
    sig = re.search(r'extern "C" int kt_check_dense\((.*?)\)\s*\{', src, re.S).group(1)
    return [re.split(r"[\s*]+", p.strip())[-1] for p in sig.split(",")]


def test_launch_args_follow_the_c_signature(monkeypatch):
    rng = np.random.default_rng(0)
    P, T, R = 5, 7, 3
    b = lambda *s: rng.random(s) < 0.5  # noqa: E731
    i = lambda *s: rng.integers(-9, 9, s)  # noqa: E731
    pre = check_precomp_from_arrays(dict(
        valid=b(T), thr_req=i(T, R), thr_req_present=b(T, R), exceeds_cnt=b(T), st_cnt=b(T),
        st_req=b(T, R), sat_cnt_ge=b(T), sat_cnt_gt=b(T), sat_req_ge=b(T, R),
        sat_req_gt=b(T, R), resid=i(T, R), over_cnt_ge=b(T), over_cnt_gt=b(T),
    ), device="cpu")
    pods = pod_batch_from_arrays(dict(valid=b(P), req=i(P, R), req_present=b(P, R)),
                                 device="cpu")
    mask = torch.from_numpy(b(P, T))
    out = torch.empty((P, T), dtype=torch.int8)

    class _Stream:
        cuda_stream = 12345

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    shape = cd._launch_shape(P, T, R)
    args = cd.launch_args(pre, pods, mask, out, True, False, shape)
    params = _c_params()
    assert len(args) == len(params) == 31
    tensors = {
        "pod_req": pods.req, "pod_present": pods.req_present, "pod_valid": pods.valid,
        "thr_present": pre.thr_req_present, "mask": mask, "out": out,
    }
    ptr_params = params[:18]
    for name, arg in zip(ptr_params, args):
        t = tensors.get(name)
        if t is None:
            t = getattr(pre, name)
        assert arg == t.data_ptr(), name
    ints = dict(zip(params[18:], args[18:]))
    assert ints == {
        "P": P, "T": T, "R": R, "on_equal": 1, "step3_on_equal": 0,
        "block_x": shape.block[0], "block_y": shape.block[1],
        "grid_x": shape.grid[0], "grid_y": shape.grid[1], "strip": shape.strip,
        "rbucket": shape.rbucket, "smem": shape.smem, "stream": 12345,
    }
