"""The sparse gather admission check as hand-written CUDA kernels.

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

- :func:`check_gather` is the wrapper. On CUDA tensors it launches the two
  kernels of ``csrc/check_gather.cu`` on the current stream: the pack of
  the state's 16 planes into one record per throttle row
  (:func:`pack_gather_rows`, into a buffer it allocates and drops at
  return), then the check over the records. Either failure raises
  :class:`~.check_dense.KernelLaunchError`. On CPU tensors it computes the
  plain version. There is no other route and no fallback.
- :func:`check_gather_reference` is the plain PyTorch version
  (``_gather_statuses_blocked``, chunked over P by
  ``KT_GATHER_CHUNK_ELEMS``, then ``statuses_to_compact``), which the
  kernels are held against on the card.
- :func:`pack_gather_rows_reference` writes the records in torch ops, bit
  for bit the pack kernel's buffer; :func:`check_packed_reference`
  classifies from records in torch ops. The tests and ``chip_smoke.py``
  use them; the main path does not.
- :data:`launches` counts check kernel launches (one per call),
  :data:`pack_launches` pack kernel launches.

The record layout (:func:`record_layout`; documented field by field in
``csrc/check_gather.cu``) puts a row's count side and its per-dim flags
in one 32-byte header sector and each dim's {threshold, used + reserved}
in a 16-byte slot, so a slot whose pod requests one dim reads two sectors.
The record is built per call from the tensors handed in, so it can never
be stale against the device mirror's row writes or the tick's derived
state. A col is clamped into [0, T) before its row is read, as a JAX
gather clamps it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import NamedTuple

import torch

from .check_dense import KernelLaunchError, _on, _require
from .classify import _check_cols, _check_dims, _classify_core, statuses_to_compact
from .schema import PodBatch, ThrottleState

#: check kernel launches since the last reset (the wrapper adds one per launch)
launches = 0
#: pack kernel launches since the last reset
pack_launches = 0

_INT32_MAX = 2**31 - 1
_GRID_X_MAX = 2**31 - 1
_THREADS = 256  # check: threads per block; csrc/check_gather.cu's kThreads
_PODS_PER_WARP = 2  # csrc/check_gather.cu's kPodsPerWarp
_PODS_PER_BLOCK = _THREADS // 32 * _PODS_PER_WARP
_PACK_THREADS = 256  # pack: threads per block; csrc/check_gather.cu's kPackThreads
_ROWS_PER_BLOCK = _PACK_THREADS // 32  # one warp per throttle row
_PACK_BLOCKS_MAX = 65535  # the pack's grid; it strides past it
#: ``ThrottleState`` planes by dtype; the pack's C signature takes them in
#: the dataclass's field order
_STATE_I64_T = ("thr_cnt", "used_cnt", "res_cnt")
_STATE_I64_TR = ("thr_req", "used_req", "res_req")
_STATE_BOOL_T = ("valid", "thr_cnt_present", "used_cnt_present", "res_cnt_present",
                 "st_cnt_throttled")
_STATE_BOOL_TR = ("thr_req_present", "used_req_present", "res_req_present",
                  "st_req_throttled", "st_req_flag_present")
_STATE_ORDER = tuple(f.name for f in dataclasses.fields(ThrottleState))
#: ``kt_pack_gather_rows``' C parameters: 16 state planes, packed; T, R,
#: header_words, words, threads, blocks; the stream
PACK_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
#: ``kt_check_gather``'s C parameters: packed, 3 pod planes, cols, 3
#: outputs; P, K, T, R, header_words, words, on_equal, step3_on_equal,
#: write_statuses, threads, blocks; the stream
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]

# the lead word of mask group 0 (csrc/check_gather.cu)
_VALID, _THR_CNT_P, _AU_CNT_P, _ST_CNT = 1, 2, 4, 8


class RecordLayout(NamedTuple):
    """Sizes of one throttle row's record (``csrc/check_gather.cu``)."""

    mask_words: int  # W: u32 words of each per-dim mask, max(1, ceil(R / 32))
    header_words: int  # int64 words before dim slot 0: whole 32-byte sectors
    words: int  # int64 words of the record: a whole number of sectors


def record_layout(R: int) -> RecordLayout:
    """The record layout for R dims: a 16-byte count side, W mask groups
    of 16 bytes, rounded up to whole sectors; then R 16-byte dim slots,
    rounded up to a whole sector."""
    W = max(1, -(-R // 32))
    header = 4 * -(-(W + 1) // 2)
    return RecordLayout(W, header, header + 4 * -(-R // 2))


class LaunchShape(NamedTuple):
    """Both kernels' geometry (threads per block, blocks on ``grid.x``)."""

    threads: int
    blocks: int
    pack_threads: int
    pack_blocks: int


def _launch_shape(P: int, T: int) -> LaunchShape:
    """The check's geometry for P pods (P >= 1): two pods a warp, 16 pods
    per block of 256 threads. The pack's for T rows: one warp per row, 8
    rows per block of 256, in at most 65,535 blocks that stride over the
    rest."""
    blocks = -(-P // _PODS_PER_BLOCK)
    if blocks > _GRID_X_MAX:
        raise ValueError(f"P={P} exceeds the kernel's grid")
    pack_blocks = max(1, min(-(-T // _ROWS_PER_BLOCK), _PACK_BLOCKS_MAX))
    return LaunchShape(_THREADS, blocks, _PACK_THREADS, pack_blocks)


def _gather_statuses(state, pods, cols, on_equal, step3_on_equal):
    """Shared body of the sparse gather forms: int8[P,K] per-slot statuses
    (CHECK_NOT_AFFECTED for padded/invalid slots) from the state's planes."""
    return _classify_rows(_rows_of_state(state), pods, cols, on_equal, step3_on_equal)


class _Rows(NamedTuple):
    """The per-row operands the check reads, used and reserved combined:
    [T] and [T,R] tensors."""

    valid: torch.Tensor
    thr_cnt: torch.Tensor
    thr_cnt_present: torch.Tensor
    au_cnt: torch.Tensor
    au_cnt_present: torch.Tensor
    st_cnt: torch.Tensor
    thr_req: torch.Tensor
    thr_req_present: torch.Tensor
    au_req: torch.Tensor
    au_req_present: torch.Tensor
    st_req: torch.Tensor


def _rows_of_state(state: ThrottleState) -> _Rows:
    return _Rows(
        state.valid, state.thr_cnt, state.thr_cnt_present,
        state.used_cnt + state.res_cnt, state.used_cnt_present | state.res_cnt_present,
        state.st_cnt_throttled, state.thr_req, state.thr_req_present,
        state.used_req + state.res_req, state.used_req_present | state.res_req_present,
        state.st_req_flag_present & state.st_req_throttled,
    )


def _classify_rows(rows: _Rows, pods, cols, on_equal, step3_on_equal):
    """int8[P,K] statuses of the rows ``cols`` name. A col is clamped into
    [0, T) before the gather, as a JAX gather clamps it (torch would
    raise): pad slots (-1) read col 0 and are masked out by ``slot``, and a
    col >= T reads row T - 1."""
    c = cols.long().clamp(0, rows.valid.shape[0] - 1)  # [P,K]
    slot = (cols >= 0) & rows.valid[c] & pods.valid[:, None]

    pod_req = pods.req[:, None, :]  # [P,1,R]
    pod_present = pods.req_present[:, None, :]
    pod_nonzero = pod_present & (pod_req != 0)
    st_req = rows.st_req[c]

    return _classify_core(
        pod_req, pod_present, pod_nonzero,
        rows.thr_cnt[c], rows.thr_cnt_present[c],
        rows.thr_req[c], rows.thr_req_present[c],
        rows.st_cnt[c], st_req, st_req,
        rows.au_cnt[c], rows.au_cnt_present[c],
        rows.au_req[c], rows.au_req_present[c],
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


def _gather_statuses_blocked(state, pods, cols, on_equal, step3_on_equal, body=None):
    """``body`` (``_gather_statuses`` over a ``ThrottleState``, or
    ``_classify_rows`` over unpacked records), chunked over P when the
    gather footprint exceeds _GATHER_CHUNK_ELEMS; the blocks run in order
    into one int8[P,K]."""
    body = body or _gather_statuses
    P, K = cols.shape
    R = pods.req.shape[1]
    if P * max(K, 1) * R <= _GATHER_CHUNK_ELEMS:
        return body(state, pods, cols, on_equal, step3_on_equal)
    pb = max(1, _GATHER_CHUNK_ELEMS // (max(K, 1) * R))
    out = torch.empty((P, K), dtype=torch.int8, device=cols.device)
    for s in range(0, P, pb):
        e = min(P, s + pb)
        block = PodBatch(
            valid=pods.valid[s:e], req=pods.req[s:e], req_present=pods.req_present[s:e]
        )
        out[s:e] = body(state, block, cols[s:e], on_equal, step3_on_equal)
    return out


def check_gather_reference(state: ThrottleState, pods: PodBatch, cols: torch.Tensor,
                           on_equal: bool = False, step3_on_equal: bool = True,
                           statuses: bool = False):
    """The plain version: int8[P,K] statuses, or ``(counts int32[P,4],
    schedulable bool[P])`` from them."""
    out = _gather_statuses_blocked(state, pods, cols, on_equal, step3_on_equal)
    return out if statuses else statuses_to_compact(out)


def _mask_word(planes: torch.Tensor, w: int) -> torch.Tensor:
    """int32[T]: bit j = planes[:, 32w + j] (bool[T,R])."""
    part = planes[:, 32 * w:32 * w + 32].long()
    shifts = torch.arange(part.shape[1], dtype=torch.int64, device=part.device)
    v = (part << shifts).sum(1)  # [0, 2^32)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def pack_gather_rows_reference(state: ThrottleState) -> torch.Tensor:
    """The records in torch ops: int64[T, words], bit for bit what the
    pack kernel writes (``csrc/check_gather.cu`` documents the layout)."""
    T, R = state.thr_req.shape
    layout = record_layout(R)
    out = torch.zeros((T, layout.words), dtype=torch.int64, device=state.valid.device)
    u32 = out.view(torch.int32)  # [T, 2 * words]; little-endian halves
    rows = _rows_of_state(state)
    out[:, 0] = rows.thr_cnt
    out[:, 1] = rows.au_cnt
    u32[:, 4] = (rows.valid.int() * _VALID | rows.thr_cnt_present.int() * _THR_CNT_P
                 | rows.au_cnt_present.int() * _AU_CNT_P | rows.st_cnt.int() * _ST_CNT)
    for w in range(layout.mask_words):
        u32[:, 4 + 4 * w + 1] = _mask_word(rows.thr_req_present, w)
        u32[:, 4 + 4 * w + 2] = _mask_word(rows.au_req_present, w)
        u32[:, 4 + 4 * w + 3] = _mask_word(rows.st_req, w)
    h = layout.header_words
    out[:, h:h + 2 * R:2] = rows.thr_req
    out[:, h + 1:h + 2 * R:2] = rows.au_req
    return out


def _rows_of_packed(packed: torch.Tensor, R: int) -> _Rows:
    """The per-row operands read back from records (int64[T, words])."""
    layout = record_layout(R)
    T = packed.shape[0]
    if tuple(packed.shape) != (T, layout.words) or packed.dtype != torch.int64:
        raise ValueError(f"packed is {packed.dtype}{tuple(packed.shape)}, expected int64 "
                         f"[T, {layout.words}] for R={R}")
    u32 = packed.contiguous().view(torch.int32)
    lead = u32[:, 4]
    r = torch.arange(R, device=packed.device)
    group = 4 + 4 * (r // 32)  # the u32 column of dim r's mask group
    bit = (r % 32).to(torch.int32)

    def dims(field: int) -> torch.Tensor:  # bool[T,R] from one mask of each group
        return (u32[:, group + field] >> bit) & 1 != 0

    h = layout.header_words
    return _Rows(
        lead & _VALID != 0, packed[:, 0], lead & _THR_CNT_P != 0,
        packed[:, 1], lead & _AU_CNT_P != 0, lead & _ST_CNT != 0,
        packed[:, h:h + 2 * R:2], dims(1), packed[:, h + 1:h + 2 * R:2], dims(2), dims(3),
    )


def check_packed_reference(packed: torch.Tensor, pods: PodBatch, cols: torch.Tensor, R: int,
                           on_equal: bool = False, step3_on_equal: bool = True,
                           statuses: bool = False):
    """The check classified from records (int64[T, words], as
    :func:`pack_gather_rows_reference` or the pack kernel writes them) in
    torch ops: int8[P,K] statuses, or ``(counts int32[P,4], schedulable
    bool[P])``."""
    out = _gather_statuses_blocked(_rows_of_packed(packed, R), pods, cols, on_equal,
                                   step3_on_equal, body=_classify_rows)
    return out if statuses else statuses_to_compact(out)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; sets both C
    signatures. Raises when the build or the load fails."""
    from ..kernels import load

    lib = load("check_gather")
    for fn, argtypes in ((lib.kt_pack_gather_rows, PACK_ARGTYPES),
                         (lib.kt_check_gather, ARGTYPES)):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _validate_state(state: ThrottleState, device) -> None:
    """Raise unless every state plane is what the pack reads: on
    ``device``, of its dtype and shape, contiguous, its records within
    int32 extents."""
    T, R = state.thr_req.shape
    if T == 0:
        raise ValueError("check_gather needs at least one throttle row")
    if max(T, R, record_layout(R).words) > _INT32_MAX:
        raise ValueError(f"state ({T},{R}) exceeds the kernel's int32 extents")
    for names, dtype, shape in ((_STATE_I64_T, torch.int64, (T,)),
                                (_STATE_I64_TR, torch.int64, (T, R)),
                                (_STATE_BOOL_T, torch.bool, (T,)),
                                (_STATE_BOOL_TR, torch.bool, (T, R))):
        for name in names:
            _require(getattr(state, name), f"state.{name}", dtype, shape, device)


def _validate(state: ThrottleState, pods: PodBatch, cols: torch.Tensor) -> None:
    """Raise unless every operand is what the kernels read: on ``cols``'
    device, of its dtype and shape, contiguous, within int32 extents."""
    device = cols.device
    P, K = cols.shape
    R = state.thr_req.shape[1]
    if max(P, K) > _INT32_MAX:
        raise ValueError(f"cols shape ({P},{K}) exceeds the kernel's int32 extents")
    _validate_state(state, device)
    _require(cols, "cols", torch.int32, (P, K), device)
    _require(pods.valid, "pods.valid", torch.bool, (P,), device)
    _require(pods.req, "pods.req", torch.int64, (P, R), device)
    _require(pods.req_present, "pods.req_present", torch.bool, (P, R), device)


def _pack(lib: ctypes.CDLL, state: ThrottleState, shape: LaunchShape, stream: int) -> torch.Tensor:
    """Launch the pack on ``stream`` into a new buffer, with the state's
    device current; raises ``KernelLaunchError`` when the launch fails."""
    global pack_launches
    T, R = state.thr_req.shape
    packed = torch.empty((T, record_layout(R).words), dtype=torch.int64,
                         device=state.valid.device)
    err = lib.kt_pack_gather_rows(*pack_args(state, packed, shape, stream))
    if err != 0:
        raise KernelLaunchError(f"check_gather pack launch failed: cudaError {err}")
    pack_launches += 1
    return packed


def pack_gather_rows(state: ThrottleState) -> torch.Tensor:
    """The records of ``state``: int64[T, words]. On CUDA tensors, one
    launch of the pack kernel (or ``KernelLaunchError``); on CPU tensors,
    :func:`pack_gather_rows_reference`."""
    device = state.valid.device
    if device.type == "cpu":
        return pack_gather_rows_reference(state)
    if device.type != "cuda":
        raise ValueError(f"pack_gather_rows runs on cuda or cpu tensors, not {device}")
    _validate_state(state, device)
    T, R = state.thr_req.shape
    lib = load_library()
    with _on(device):
        return _pack(lib, state, _launch_shape(1, T), torch.cuda.current_stream(device).cuda_stream)


def _outputs(P: int, K: int, device, statuses: bool):
    """(statuses int8[P,K], None, None) for the statuses form, else (None,
    counts int32[P,4], schedulable bool[P])."""
    if statuses:
        return torch.empty((P, K), dtype=torch.int8, device=device), None, None
    return (None, torch.empty((P, 4), dtype=torch.int32, device=device),
            torch.empty(P, dtype=torch.bool, device=device))


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
    if P == 0:
        out, counts, schedulable = _outputs(P, K, device, statuses)
        return out if statuses else (counts, schedulable)
    lib = load_library()
    shape = _launch_shape(P, state.valid.shape[0])
    # the current stream's cudaStream_t, as torch.cuda.current_stream(device)
    # .cuda_stream gives it, without building a Stream object (host time on
    # every call)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    with _on(device):
        packed = _pack(lib, state, shape, stream)  # first: the allocations below overlap it
        out, counts, schedulable = _outputs(P, K, device, statuses)
        err = lib.kt_check_gather(*launch_args(packed, pods, cols, out, counts, schedulable,
                                               on_equal, step3_on_equal, shape, stream))
    if err != 0:
        raise KernelLaunchError(f"check_gather kernel launch failed: cudaError {err}")
    launches += 1
    return out if statuses else (counts, schedulable)


def pack_args(state: ThrottleState, packed: torch.Tensor, shape: LaunchShape, stream: int):
    """The C arguments of ``kt_pack_gather_rows``: the state planes'
    pointers in field order, the buffer's, T, R, the layout, the pack's
    geometry and ``stream`` (a ``cudaStream_t`` as an int). Builds no
    tensor and enqueues nothing."""
    T, R = state.thr_req.shape
    layout = record_layout(R)
    return (
        *(getattr(state, name).data_ptr() for name in _STATE_ORDER),
        packed.data_ptr(), T, R, layout.header_words, layout.words,
        shape.pack_threads, shape.pack_blocks, stream,
    )


def launch_args(packed: torch.Tensor, pods: PodBatch, cols: torch.Tensor, out, counts,
                schedulable, on_equal: bool, step3_on_equal: bool, shape: LaunchShape,
                stream: int):
    """The C arguments of ``kt_check_gather`` for validated tensors: their
    pointers (0 for the other form's outputs), the extents, the layout, the
    flags, the check's geometry and ``stream``. Builds no tensor and
    enqueues nothing."""
    P, K = cols.shape
    R = pods.req.shape[1]
    layout = record_layout(R)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    return (
        packed.data_ptr(), pods.valid.data_ptr(), pods.req.data_ptr(),
        pods.req_present.data_ptr(), cols.data_ptr(), ptr(out), ptr(counts), ptr(schedulable),
        P, K, packed.shape[0], R, layout.header_words, layout.words,
        int(on_equal), int(step3_on_equal), int(out is not None),
        shape.threads, shape.blocks, stream,
    )
