"""Batched victim selection — the greedy ranked-prefix walk as one
single-block CUDA kernel.

The counterpart of the JAX package's ``ops/victim_select.py``, which runs
the walk as one ``lax.scan``. Victim selection is inherently sequential:
whether candidate *i* is taken depends on which deficits its selected
predecessors already covered. The host oracle (policy/victims.py
``sequential_victim_select``) is a Python loop over the same ranked
arrays; the two are pinned equal by the seeded and hypothesis tests.

Operands (policy/victims.py ``build_selection_problem``):

- ``contrib`` int64[N, M] — row i = ranked candidate i's freed capacity
  per flattened deficit dim (zero-padded rows are never selected, so N
  ladder-pads freely);
- ``deficit`` int64[M] — the positive capacity shortfalls (≤ 0 cells are
  already met; zero-padded dims are inert).

``max_victims`` caps the takes (0 = uncapped), like the oracle's early
break. The step per candidate: take iff any dim has ``contrib > 0`` while
``remaining > 0`` (and the cap allows), then subtract the WHOLE row.

- :func:`victim_select` is the wrapper. On CUDA tensors it launches the
  kernel of ``csrc/victim_select.cu`` or raises
  :class:`~.check_dense.KernelLaunchError`; on CPU tensors it computes the
  plain version. There is no other route and no fallback.
- :func:`victim_select_reference` is the plain version: a row-by-row torch
  loop of exactly the scan step, which the kernel is held against on the
  card. It never reads a value back to the host inside the loop.
- :data:`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from .check_dense import KernelLaunchError, _on, _require

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

_INT32_MAX = 2**31 - 1
# The kernel's limits, which csrc/victim_select.cu's entry checks again:
_SMEM_MAX = 232448  # dynamic shared memory one block may use on Hopper
_HEADER_BYTES = 256  # the kernel's Header: stop flag, mbarriers
_CONSUMERS_MAX = 8  # consumer warps
_STAGES_MAX = 8  # ring stages
_REG_COLS_MAX = 32  # int64 columns a consumer lane holds in registers
#: one consumer warp up to this many deficit dims, else eight: one warp
#: measured faster at 64 columns, eight at 256 (PERF.md, section 6)
_ONE_WARP_COLS = 64
_STAGE_SHARE = 4  # a stage takes about a quarter of the ring's bytes
#: ``kt_victim_select``'s C parameters: contrib, deficit, selected, ok,
#: remaining; N, M, cap, consumers, reg_cols, stages, head_rows,
#: chunk_rows, smem; the stream
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


class LaunchShape(NamedTuple):
    """The one block's geometry for M deficit dims."""

    route: str  # "ring": rows streamed into shared memory; "wide": read from device memory
    consumers: int  # consumer warps, which hold remaining and decide each row: 1 or 8
    reg_cols: int  # int64 columns of remaining a consumer lane holds in registers
    group_rows: int  # rows decided per group: 4 at up to 8 register columns, else 1
    stages: int  # ring stages (0 on the wide route)
    head_rows: int  # rows of the first chunk: two groups, at most a stage's
    chunk_rows: int  # rows of every later chunk, a stage's: even (so every bulk copy
    # starts 16-byte aligned) and whole groups
    stage_bytes: int  # chunk_rows * M * 8 rounded up to 128
    smem: int  # dynamic shared bytes: the header, then the ring or remaining's extra columns
    threads: int  # 32 per consumer warp, plus the producer warp on the ring route
    remaining_in: str  # "registers", "registers+shared" or "registers+device"


def _round128(n: int) -> int:
    return -(-n // 128) * 128


@lru_cache(maxsize=256)
def _launch_shape(M: int) -> LaunchShape:
    """The geometry of the one block for M deficit dims (M >= 1), the route
    chosen by shape; the only place it is decided. ``ring`` when two
    stages of two rows fit in shared memory (M <= 7256): one consumer warp
    up to 64 columns, else 8, remaining in registers (KREG, the power of
    two at or above a lane's share of the columns), a first chunk of two
    row groups, and up to 8 stages of about a quarter of the budget each,
    their rows whole groups and even. Else ``wide``: 8 consumer warps read
    the rows from device memory; remaining's first 8192 columns sit in
    registers, the rest in shared memory where they fit (M <= 37216), else
    in device memory."""
    row = 8 * M
    ring = _SMEM_MAX - _HEADER_BYTES
    if 2 * _round128(2 * row) <= ring:
        c = 1 if M <= _ONE_WARP_COLS else _CONSUMERS_MAX
        reg_cols = 1 << max(0, -(-M // (32 * c)) - 1).bit_length()
        group = 4 if reg_cols <= 8 else 1
        unit = max(2, group)
        rows = max(unit, ring // _STAGE_SHARE // row // unit * unit)
        stage = _round128(rows * row)
        stages = min(_STAGES_MAX, ring // stage)
        return LaunchShape("ring", c, reg_cols, group, stages, min(rows, 2 * unit), rows, stage,
                           _HEADER_BYTES + stages * stage, 32 * (c + 1), "registers")
    c = _CONSUMERS_MAX
    ext = max(0, M - 32 * c * _REG_COLS_MAX)
    in_smem = _HEADER_BYTES + 8 * ext <= _SMEM_MAX
    where = "registers" if ext == 0 else "registers+shared" if in_smem else "registers+device"
    return LaunchShape("wide", c, _REG_COLS_MAX, 1, 0, 0, 0, 0,
                       _HEADER_BYTES + (8 * ext if in_smem else 0), 32 * c, where)


def launch_args(contrib, deficit, selected, ok, remaining, max_victims: int,
                shape: LaunchShape):
    """``kt_victim_select``'s arguments, in ARGTYPES' order, on the current
    stream of the operands' device."""
    N, M = contrib.shape
    return (contrib.data_ptr(), deficit.data_ptr(), selected.data_ptr(), ok.data_ptr(),
            remaining.data_ptr(), N, M, max_victims, shape.consumers, shape.reg_cols,
            shape.stages, shape.head_rows, shape.chunk_rows, shape.smem,
            torch.cuda.current_stream(contrib.device).cuda_stream)


def victim_select_reference(contrib: torch.Tensor, deficit: torch.Tensor,
                            max_victims: int = 0):
    """The plain version: the scan step, one row at a time, in torch ops on
    the operands' device → ``(selected bool[N], ok bool[], remaining
    int64[M])``."""
    remaining = deficit.clone()
    count = torch.zeros((), dtype=torch.int32, device=contrib.device)
    selected = torch.zeros(contrib.shape[0], dtype=torch.bool, device=contrib.device)
    for i in range(contrib.shape[0]):
        row = contrib[i]
        take = torch.any((row > 0) & (remaining > 0))
        if max_victims > 0:
            take = take & (count < max_victims)
        remaining = torch.where(take, remaining - row, remaining)
        count = count + take.to(torch.int32)
        selected[i] = take
    return selected, torch.all(remaining <= 0), remaining


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; sets the C
    signature. Raises when the build or the load fails."""
    from ..kernels import load

    lib = load("victim_select")
    fn = lib.kt_victim_select
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def victim_select(contrib: torch.Tensor, deficit: torch.Tensor, max_victims: int = 0):
    """→ ``(selected bool[N], ok bool[], remaining int64[M])`` — see module
    docstring. ``contrib``/``deficit`` must be int64 (exact milli-unit
    arithmetic)."""
    global launches
    if contrib.device.type == "cpu":
        return victim_select_reference(contrib, deficit, max_victims)
    if contrib.device.type != "cuda":
        raise ValueError(f"victim_select runs on cuda or cpu tensors, not {contrib.device}")
    device = contrib.device
    if contrib.dim() != 2:
        raise ValueError(f"contrib must be [N, M], not {tuple(contrib.shape)}")
    N, M = contrib.shape
    _require(contrib, "contrib", torch.int64, (N, M), device)
    _require(deficit, "deficit", torch.int64, (M,), device)
    if max(N, M) > _INT32_MAX or not 0 <= max_victims <= _INT32_MAX:
        raise ValueError(f"shape ({N},{M}) or cap {max_victims} exceeds the kernel's int32 range")
    if M == 0:  # no deficit dim: nothing helps and nothing is open
        return (torch.zeros(N, dtype=torch.bool, device=device),
                torch.ones((), dtype=torch.bool, device=device),
                torch.empty(0, dtype=torch.int64, device=device))
    shape = _launch_shape(M)
    if shape.route == "ring" and contrib.data_ptr() % 16:
        contrib = contrib.clone()  # a view off the allocation's alignment: bulk copies need 16 B
    lib = load_library()
    selected = torch.empty(N, dtype=torch.bool, device=device)
    ok = torch.empty((), dtype=torch.bool, device=device)
    remaining = torch.empty(M, dtype=torch.int64, device=device)
    with _on(device):
        err = lib.kt_victim_select(*launch_args(contrib, deficit, selected, ok, remaining,
                                                max_victims, shape))
    if err != 0:
        raise KernelLaunchError(f"victim_select kernel launch failed: cudaError {err}")
    launches += 1
    return selected, ok, remaining
