"""The sparse gather admission check as a hand-written CUDA kernel.

The counterpart of the JAX package's ``ops/check.py::_gather_statuses``
with ``statuses_to_compact`` (XLA there): for each pod, its int32[P,K]
matched throttle cols (-1 pads) name K rows of the ``ThrottleState``; the
ordered 4-step check runs over R for each, and the result is either the
int32[P,4] class counts with bool[P] schedulable (``check_pods_gather``)
or the int8[P,K] per-slot statuses (``check_pods_gather_statuses``, the
coalescer's reason strings). It is the Throttle kind's sparse route of
``DeviceStateManager._dispatch_batch_check``, of the sparse tick
(``parallel/sharded.py::full_update_step_gather``) and of
``check_pods_multi``'s device route.

- :func:`check_gather` is the wrapper. On CUDA tensors it launches the
  kernel of ``csrc/check_gather.cu`` or raises
  :class:`~.check_dense.KernelLaunchError`; on CPU tensors it computes the
  plain version. There is no other route and no fallback.
- :func:`check_gather_reference` is the plain PyTorch version
  (``_gather_statuses_blocked``, chunked over P by
  ``KT_GATHER_CHUNK_ELEMS``, then ``statuses_to_compact``), which the
  kernel is held against on the card.
- :data:`launches` counts kernel launches.

The kernel reads the ``ThrottleState`` planes as they are (it adds used
and reserved itself) and selects the variant and the output form with
template flags, so on CUDA tensors the wrapper enqueues the outputs'
``torch.empty`` and one launch, nothing else. A col is clamped into
[0, T) before its row is read, as a JAX gather clamps it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Tuple

import torch

from .check_dense import KernelLaunchError, _require
from .classify import _check_cols, _check_dims, _classify_core, statuses_to_compact
from .schema import PodBatch, ThrottleState

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

_INT32_MAX = 2**31 - 1
_GRID_X_MAX = 2**31 - 1
_THREADS = 256  # threads per block; csrc/check_gather.cu's kThreads
_PODS_PER_BLOCK = _THREADS // 32  # one warp per pod
#: ``ThrottleState`` planes by dtype; the C signature takes them in the
#: dataclass's field order
_STATE_I64_T = ("thr_cnt", "used_cnt", "res_cnt")
_STATE_I64_TR = ("thr_req", "used_req", "res_req")
_STATE_BOOL_T = ("valid", "thr_cnt_present", "used_cnt_present", "res_cnt_present",
                 "st_cnt_throttled")
_STATE_BOOL_TR = ("thr_req_present", "used_req_present", "res_req_present",
                  "st_req_throttled", "st_req_flag_present")
_STATE_ORDER = tuple(f.name for f in dataclasses.fields(ThrottleState))
#: ``kt_check_gather``'s C parameters: 16 state planes, 3 pod planes,
#: cols, 3 outputs; P, K, T, R, on_equal, step3_on_equal, write_statuses,
#: threads, blocks; the stream
ARGTYPES = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _launch_shape(P: int) -> Tuple[int, int]:
    """(threads per block, blocks) for P pods (P >= 1): one warp per pod,
    8 pods per block of 256 threads, blocks on ``grid.x``."""
    blocks = -(-P // _PODS_PER_BLOCK)
    if blocks > _GRID_X_MAX:
        raise ValueError(f"P={P} exceeds the kernel's grid")
    return _THREADS, blocks


def _gather_statuses(state, pods, cols, on_equal, step3_on_equal):
    """Shared body of the sparse gather forms: int8[P,K] per-slot statuses
    (CHECK_NOT_AFFECTED for padded/invalid slots). A col is clamped into
    [0, T) before the gather, as a JAX gather clamps it (torch would
    raise): pad slots (-1) read col 0 and are masked out by ``slot``, and a
    col >= T reads row T - 1."""
    c = cols.long().clamp(0, state.valid.shape[0] - 1)  # [P,K]
    slot = (cols >= 0) & state.valid[c] & pods.valid[:, None]

    pod_req = pods.req[:, None, :]  # [P,1,R]
    pod_present = pods.req_present[:, None, :]
    pod_nonzero = pod_present & (pod_req != 0)

    return _classify_core(
        pod_req, pod_present, pod_nonzero,
        state.thr_cnt[c], state.thr_cnt_present[c],
        state.thr_req[c], state.thr_req_present[c],
        state.st_cnt_throttled[c],
        state.st_req_flag_present[c], state.st_req_throttled[c],
        (state.used_cnt + state.res_cnt)[c],
        (state.used_cnt_present | state.res_cnt_present)[c],
        (state.used_req + state.res_req)[c],
        (state.used_req_present | state.res_req_present)[c],
        slot, on_equal, step3_on_equal,
    )


# Peak-footprint governor for the sparse gather forms: a [P,K] dispatch
# materializes several gathered [P,K,R] operands, so an unbounded P×K×R
# runs in P-blocks of at most KT_GATHER_CHUNK_ELEMS elements (bit-identical
# statuses). 64M elements ≈ 512 MB per int64 operand.
try:
    _GATHER_CHUNK_ELEMS = int(
        os.environ.get("KT_GATHER_CHUNK_ELEMS", str(64 * 1024 * 1024))
    )
except ValueError:
    # a malformed override must not kill module import; fall back to the
    # 64M default
    _GATHER_CHUNK_ELEMS = 64 * 1024 * 1024


def _gather_statuses_blocked(state, pods, cols, on_equal, step3_on_equal):
    """_gather_statuses, chunked over P when the gather footprint exceeds
    _GATHER_CHUNK_ELEMS; the blocks run in order into one int8[P,K]."""
    P, K = cols.shape
    R = pods.req.shape[1]
    if P * max(K, 1) * R <= _GATHER_CHUNK_ELEMS:
        return _gather_statuses(state, pods, cols, on_equal, step3_on_equal)
    pb = max(1, _GATHER_CHUNK_ELEMS // (max(K, 1) * R))
    out = torch.empty((P, K), dtype=torch.int8, device=cols.device)
    for s in range(0, P, pb):
        e = min(P, s + pb)
        block = PodBatch(
            valid=pods.valid[s:e], req=pods.req[s:e], req_present=pods.req_present[s:e]
        )
        out[s:e] = _gather_statuses(state, block, cols[s:e], on_equal, step3_on_equal)
    return out


def check_gather_reference(state: ThrottleState, pods: PodBatch, cols: torch.Tensor,
                           on_equal: bool = False, step3_on_equal: bool = True,
                           statuses: bool = False):
    """The plain version: int8[P,K] statuses, or ``(counts int32[P,4],
    schedulable bool[P])`` from them."""
    out = _gather_statuses_blocked(state, pods, cols, on_equal, step3_on_equal)
    return out if statuses else statuses_to_compact(out)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; sets the C
    signature. Raises when the build or the load fails."""
    from ..kernels import load

    lib = load("check_gather")
    fn = lib.kt_check_gather
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _validate(state: ThrottleState, pods: PodBatch, cols: torch.Tensor) -> None:
    """Raise unless every operand is what the kernel reads: on ``cols``'
    device, of its dtype and shape, contiguous, within int32 extents."""
    device = cols.device
    P, K = cols.shape
    T, R = state.thr_req.shape
    if T == 0:
        raise ValueError("check_gather needs at least one throttle row")
    if max(P, K, T, R) > _INT32_MAX:
        raise ValueError(f"shape ({P},{K},{T},{R}) exceeds the kernel's int32 extents")
    _require(cols, "cols", torch.int32, (P, K), device)
    _require(pods.valid, "pods.valid", torch.bool, (P,), device)
    _require(pods.req, "pods.req", torch.int64, (P, R), device)
    _require(pods.req_present, "pods.req_present", torch.bool, (P, R), device)
    for names, dtype, shape in ((_STATE_I64_T, torch.int64, (T,)),
                                (_STATE_I64_TR, torch.int64, (T, R)),
                                (_STATE_BOOL_T, torch.bool, (T,)),
                                (_STATE_BOOL_TR, torch.bool, (T, R))):
        for name in names:
            _require(getattr(state, name), f"state.{name}", dtype, shape, device)


def check_gather(state: ThrottleState, pods: PodBatch, cols: torch.Tensor,
                 on_equal: bool = False, step3_on_equal: bool = True,
                 statuses: bool = False):
    """The gather check of ``cols`` int32[P,K] against ``state``: int8[P,K]
    statuses when ``statuses``, else ``(counts int32[P,4], schedulable
    bool[P])``. CHECK_NOT_AFFECTED for a pad slot, an invalid throttle row
    or an invalid pod."""
    global launches
    _check_dims(state, pods)
    _check_cols(pods, cols)
    if cols.device.type == "cpu":
        return check_gather_reference(state, pods, cols, on_equal, step3_on_equal, statuses)
    if cols.device.type != "cuda":
        raise ValueError(f"check_gather runs on cuda or cpu tensors, not {cols.device}")
    device = cols.device
    _validate(state, pods, cols)
    P, K = cols.shape
    if statuses:
        out = torch.empty((P, K), dtype=torch.int8, device=device)
        counts = schedulable = None
    else:
        out = None
        counts = torch.empty((P, 4), dtype=torch.int32, device=device)
        schedulable = torch.empty(P, dtype=torch.bool, device=device)
    if P == 0:
        return out if statuses else (counts, schedulable)
    lib = load_library()
    args = launch_args(state, pods, cols, out, counts, schedulable, on_equal, step3_on_equal,
                       _launch_shape(P))
    with torch.cuda.device(device):
        err = lib.kt_check_gather(*args)
    if err != 0:
        raise KernelLaunchError(f"check_gather kernel launch failed: cudaError {err}")
    launches += 1
    return out if statuses else (counts, schedulable)


def launch_args(state: ThrottleState, pods: PodBatch, cols: torch.Tensor, out, counts,
                schedulable, on_equal: bool, step3_on_equal: bool, shape: Tuple[int, int]):
    """The C arguments of ``kt_check_gather`` for validated tensors: their
    pointers (0 for the other form's outputs), the extents, the flags, the
    geometry and the current stream. Builds no tensor and enqueues
    nothing."""
    P, K = cols.shape
    T, R = state.thr_req.shape
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    return (
        *(getattr(state, name).data_ptr() for name in _STATE_ORDER),
        pods.valid.data_ptr(), pods.req.data_ptr(), pods.req_present.data_ptr(),
        cols.data_ptr(), ptr(out), ptr(counts), ptr(schedulable),
        P, K, T, R, int(on_equal), int(step3_on_equal), int(out is not None),
        *shape,
        torch.cuda.current_stream(cols.device).cuda_stream,
    )
