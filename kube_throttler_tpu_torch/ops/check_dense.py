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

The wrapper resolves the onEqual/step-3 variants into per-throttle bit
planes with torch ops before the launch, as ``pallas_check.py:160-184``
does, so the kernel carries only the step-4 strictness as a template flag.
Unlike the TPU kernel it takes any P and T (the ragged edge is masked in
the kernel) and keeps every int64 whole (Hopper compares s64 natively).
"""

from __future__ import annotations

import ctypes

import torch

from .fastcheck import CheckPrecomp, fast_check_pods
from .schema import PodBatch

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

# tflag / tvec bit layout shared with csrc/check_dense.cu
_THR_PRESENT, _ST_OR_SAT = 1, 2
_TV_EXCEEDS_CNT, _TV_ST_OR_SAT, _TV_OVER_CNT, _TV_VALID = 1, 2, 4, 8

_INT32_MAX = 2**31 - 1


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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _block_shape(T: int):
    """(throttles, pods) per block: 16 throttle lanes when T fits in 16
    (the common small-kind case), else a full warp of 32; 512 threads."""
    bt = 16 if T <= 16 else 32
    return bt, 512 // bt


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

    out = torch.empty((P, T), dtype=torch.int8, device=device)
    if P == 0 or T == 0:
        return out
    lib = load_library()
    _planes, args = kernel_args(pre, pods, mask, out, on_equal, step3_on_equal)
    with torch.cuda.device(device):
        err = lib.kt_check_dense(*args)
    if err != 0:
        raise KernelLaunchError(f"check_dense kernel launch failed: cudaError {err}")
    launches += 1
    return out


def kernel_args(pre: CheckPrecomp, pods: PodBatch, mask: torch.Tensor, out: torch.Tensor,
                on_equal: bool, step3_on_equal: bool):
    """(planes, args): the C arguments of ``kt_check_dense`` for validated
    tensors, with the onEqual/step-3 variants resolved into the per-dim
    flag plane and the per-throttle ``tvec`` bits by torch ops on the
    tensors' device. ``planes`` holds those temporaries; keep it alive
    until the launch is enqueued."""
    P, R = pods.req.shape
    T = mask.shape[1]
    pod_nz = (pods.req_present & (pods.req != 0)).to(torch.uint8)
    sat_req = pre.sat_req_ge if step3_on_equal else pre.sat_req_gt
    tflag = (
        pre.thr_req_present.to(torch.uint8) * _THR_PRESENT
        + (pre.st_req | sat_req).to(torch.uint8) * _ST_OR_SAT
    )
    sat_cnt = pre.sat_cnt_ge if step3_on_equal else pre.sat_cnt_gt
    over_cnt = pre.over_cnt_ge if on_equal else pre.over_cnt_gt
    tvec = (
        pre.exceeds_cnt.to(torch.uint8) * _TV_EXCEEDS_CNT
        + (pre.st_cnt | sat_cnt).to(torch.uint8) * _TV_ST_OR_SAT
        + over_cnt.to(torch.uint8) * _TV_OVER_CNT
        + pre.valid.to(torch.uint8) * _TV_VALID
    )
    bt, bp = _block_shape(T)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    args = (
        pods.req.data_ptr(), pod_nz.data_ptr(), pods.valid.data_ptr(),
        pre.thr_req.data_ptr(), pre.resid.data_ptr(), tflag.data_ptr(),
        tvec.data_ptr(), mask.data_ptr(), out.data_ptr(),
        P, T, R, int(on_equal), bt, bp, stream,
    )
    return (pod_nz, tflag, tvec), args
