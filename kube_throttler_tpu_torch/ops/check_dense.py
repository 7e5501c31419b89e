"""The dense admission sweep as a hand-written CUDA kernel.

The counterpart of the JAX package's ``ops/pallas_check.py``
(``pallas_check_pods``): the full int8[P,T] 4-state classification from
the residual-form ``CheckPrecomp`` of ``ops/fastcheck.py``, for every
(pod, throttle) cell of a [P,T] selector mask. It is the dense route of
``DeviceStateManager._dispatch_batch_check``.

- :func:`check_dense` is the wrapper. On CUDA tensors it launches the
  kernel of ``csrc/check_dense.cu`` or raises; on CPU tensors it computes
  the plain version. There is no other route and no fallback.
- :func:`check_dense_reference` is the plain PyTorch version
  (``fast_check_pods``), which the kernel is held against on the card.
- :data:`launches` counts kernel launches (plain integer; the chip smoke
  zeroes it around the main path to prove the path went through the
  kernel).
- :class:`KernelLaunchError` is what a failed launch raises. The circuit
  breaker (``DeviceStateManager.guarded``) re-raises it, so a kernel that
  does not run never sends the batch to the host oracle.

The kernel reads the ``CheckPrecomp`` planes as they are and selects the
onEqual/step-3 variants itself (two template flags), so on CUDA tensors
the wrapper enqueues the output's ``torch.empty`` and one launch, nothing
else. :func:`_launch_shape` chooses the launch geometry in Python, where
the CPU tests hold it within CUDA's limits. Unlike the TPU kernel it takes
any P and T (the ragged edge is masked in the kernel) and keeps every
int64 whole (Hopper compares s64 natively).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Tuple

import torch

from .fastcheck import CheckPrecomp, fast_check_pods
from .schema import PodBatch

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

_INT32_MAX = 2**31 - 1
_GRID_Y_MAX = 65535
_THREADS = 256  # threads per block; csrc/check_dense.cu's __launch_bounds__
_UNROLL = 4  # pod rows per thread per loop step (kUnroll in the kernel)
_SMEM_MAX = 232448  # dynamic shared memory one block may use on Hopper
_SMEM_PER_DIM = 8 + 8 + 1  # threshold, residual, flag byte per (dim, throttle)
#: blocks the grid aims at: 4 waves if each of the 132 SMs held 8 blocks
#: (at the 2 blocks per SM the R <= 8 route's registers allow, 16 waves)
TARGET_BLOCKS = 4 * 132 * 8
#: widest throttle tile; the fastest of the widths timed on the card
#: (PERF.md §6: 64 lanes against 256 at the dense sweep)
BT_MAX = 64


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class LaunchShape(NamedTuple):
    """One launch of ``kt_check_dense``: ``block`` (throttle lanes, pod
    lanes), ``grid`` (throttle tiles, pod strips), ``strip`` pod rows per
    block, ``rbucket`` the R route (8 or 16: the throttle column in
    registers; 0: in shared memory) and ``smem`` its dynamic shared bytes."""

    block: Tuple[int, int]
    grid: Tuple[int, int]
    strip: int
    rbucket: int
    smem: int


def _launch_shape(P: int, T: int, R: int, *, target_blocks: int = TARGET_BLOCKS,
                  bt_max: int = BT_MAX) -> LaunchShape:
    """The launch geometry for a [P,T] mask over R dims (P, T >= 1).

    256 threads per block, one throttle column each: BT lanes wide (the
    smallest power of two >= T, within [16, ``bt_max``], halved while the
    shared-memory route's [R][BT] planes would not fit) and 256 / BT pod
    rows tall. Throttle tiles go on ``grid.x`` (up to 2^31 - 1), pod strips
    on ``grid.y`` (at most 65,535); the strip is a whole number of unrolled
    steps, long enough that the grid holds about ``target_blocks``."""
    bt = 16
    while bt < T and bt < bt_max:
        bt *= 2
    rbucket = 8 if R <= 8 else 16 if R <= 16 else 0
    smem = 0
    if rbucket == 0:
        while bt > 1 and bt * R * _SMEM_PER_DIM > _SMEM_MAX:
            bt //= 2
        smem = bt * R * _SMEM_PER_DIM
        if smem > _SMEM_MAX:
            raise ValueError(f"R={R} dims exceed the kernel's shared-memory route")
    by = _THREADS // bt
    gx = _ceil_div(T, bt)
    step = by * _UNROLL
    gy = max(1, min(_GRID_Y_MAX, _ceil_div(target_blocks, gx), _ceil_div(P, step)))
    strip = min(_ceil_div(_ceil_div(P, gy), step) * step, P)
    gy = _ceil_div(P, strip)
    return LaunchShape((bt, by), (gx, gy), strip, rbucket, smem)


class KernelLaunchError(RuntimeError):
    """The CUDA kernel did not launch (a nonzero ``cudaError_t``). A fault
    of the port or the card, never a transient device outage: it must
    reach the caller rather than open the breaker."""


def check_dense_reference(pre: CheckPrecomp, pods: PodBatch, mask: torch.Tensor,
                          on_equal: bool = False, step3_on_equal: bool = True) -> torch.Tensor:
    """The plain version: ``fast_check_pods``."""
    return fast_check_pods(pre, pods, mask, on_equal=on_equal, step3_on_equal=step3_on_equal)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; sets the C
    signature. Raises when the build or the load fails."""
    from ..kernels import load

    lib = load("check_dense")
    fn = lib.kt_check_dense
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    """Raise unless ``t`` is on ``device`` (a CUDA device with its index),
    of ``dtype`` and ``shape``, contiguous. The quick test runs on every
    launch, on the host's clock; a message is built only on failure."""
    if (t.dtype is dtype and t.shape == tuple(shape) and t.is_contiguous()
            and t.get_device() == device.index):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on(device: torch.device):
    """The context that makes ``device`` current for a launch: none when it
    already is (the switch costs host time on every call)."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_dense(pre: CheckPrecomp, pods: PodBatch, mask: torch.Tensor,
                on_equal: bool = False, step3_on_equal: bool = True) -> torch.Tensor:
    """Full [P,T] classification (int8) with ``pallas_check_pods``'
    contract: CHECK_NOT_AFFECTED wherever the mask is clear, the throttle
    row is invalid, or the pod row is invalid."""
    global launches
    if mask.device.type == "cpu":
        return check_dense_reference(pre, pods, mask, on_equal, step3_on_equal)
    if mask.device.type != "cuda":
        raise ValueError(f"check_dense runs on cuda or cpu tensors, not {mask.device}")
    device = mask.device
    P, R = pods.req.shape
    T = pre.thr_req.shape[0]
    _require(mask, "mask", torch.bool, (P, T), device)
    _require(pods.req, "pods.req", torch.int64, (P, R), device)
    _require(pods.req_present, "pods.req_present", torch.bool, (P, R), device)
    _require(pods.valid, "pods.valid", torch.bool, (P,), device)
    _require(pre.thr_req, "pre.thr_req", torch.int64, (T, R), device)
    _require(pre.resid, "pre.resid", torch.int64, (T, R), device)
    for name in ("thr_req_present", "st_req", "sat_req_ge", "sat_req_gt"):
        _require(getattr(pre, name), f"pre.{name}", torch.bool, (T, R), device)
    for name in ("valid", "exceeds_cnt", "st_cnt", "sat_cnt_ge", "sat_cnt_gt",
                 "over_cnt_ge", "over_cnt_gt"):
        _require(getattr(pre, name), f"pre.{name}", torch.bool, (T,), device)
    if max(P, T, R) > _INT32_MAX:
        raise ValueError(f"shape ({P},{T},{R}) exceeds the kernel's int32 extents")

    if P == 0 or T == 0:
        return torch.empty((P, T), dtype=torch.int8, device=device)
    shape = _launch_shape(P, T, R)
    lib = load_library()
    out = torch.empty((P, T), dtype=torch.int8, device=device)
    args = launch_args(pre, pods, mask, out, on_equal, step3_on_equal, shape)
    with _on(device):
        err = lib.kt_check_dense(*args)
    if err != 0:
        raise KernelLaunchError(f"check_dense kernel launch failed: cudaError {err}")
    launches += 1
    return out


def launch_args(pre: CheckPrecomp, pods: PodBatch, mask: torch.Tensor, out: torch.Tensor,
                on_equal: bool, step3_on_equal: bool, shape: LaunchShape):
    """The C arguments of ``kt_check_dense`` for validated tensors: their
    pointers, the extents, the variant flags, the geometry and the current
    stream. Builds no tensor and enqueues nothing."""
    P, R = pods.req.shape
    T = mask.shape[1]
    planes = (
        pods.req, pods.req_present, pods.valid,
        pre.thr_req, pre.resid, pre.thr_req_present, pre.st_req, pre.sat_req_ge, pre.sat_req_gt,
        pre.valid, pre.exceeds_cnt, pre.st_cnt, pre.sat_cnt_ge, pre.sat_cnt_gt,
        pre.over_cnt_ge, pre.over_cnt_gt, mask, out,
    )
    return (
        *(t.data_ptr() for t in planes),
        P, T, R, int(on_equal), int(step3_on_equal),
        *shape.block, *shape.grid, shape.strip, shape.rbucket, shape.smem,
        torch.cuda.current_stream(mask.device).cuda_stream,
    )
