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
from typing import Tuple

import torch

from .check_dense import KernelLaunchError, _require

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

_INT32_MAX = 2**31 - 1
_THREADS_MAX = 1024  # csrc/victim_select.cu's __launch_bounds__
_SMEM_MAX = 232448  # dynamic shared memory one block may use on Hopper
#: ``kt_victim_select``'s C parameters: contrib, deficit, selected, ok,
#: remaining; N, M, cap, threads, smem; the stream
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _launch_shape(M: int) -> Tuple[int, int]:
    """(threads, dynamic shared bytes) of the one block for M deficit
    dims (M >= 1): a whole number of warps up to 1024, one column per
    thread per stride, and ``remaining`` in shared memory when its M int64
    fit there (else 0: it stays in device memory)."""
    threads = min(_THREADS_MAX, max(32, -(-M // 32) * 32))
    smem = M * 8 if M * 8 <= _SMEM_MAX else 0
    return threads, smem


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
    threads, smem = _launch_shape(M)
    lib = load_library()
    selected = torch.empty(N, dtype=torch.bool, device=device)
    ok = torch.empty((), dtype=torch.bool, device=device)
    remaining = torch.empty(M, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = lib.kt_victim_select(
            contrib.data_ptr(), deficit.data_ptr(), selected.data_ptr(), ok.data_ptr(),
            remaining.data_ptr(), N, M, max_victims, threads, smem,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError(f"victim_select kernel launch failed: cudaError {err}")
    launches += 1
    return selected, ok, remaining
