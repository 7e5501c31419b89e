"""Device selection for the daemon's entry point.

The JAX package's two helpers of this module have no counterpart here:

- ``honor_jax_platforms_env`` re-asserts ``JAX_PLATFORMS`` through JAX's
  config. The port reads no environment variable to pick a device: the
  caller chooses, and ``serve --device {cuda,cpu}`` is the daemon's form
  of that choice (:func:`select_device`).
- ``enable_persistent_compilation_cache`` points XLA's compilation cache
  at a directory. The port compiles its kernels once with ``nvcc`` into
  ``build/kernels/<name>-<hash>.so`` (``kernels.py``), a cache that
  already outlives the process; nothing else is compiled.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device

DEVICE_CHOICES = ("cuda", "cpu")


def select_device(choice: str, use_device: bool = True) -> Optional[torch.device]:
    """The device the daemon's data plane runs on: ``None`` when
    ``use_device`` is false (the host oracle answers alone and no device
    is touched), else ``choice`` (one of ``DEVICE_CHOICES``) resolved.
    ``"cuda"`` without a CUDA device raises ``RuntimeError``; there is no
    fallback to the CPU."""
    if not use_device:
        return None
    return resolve_device(choice)


def add_device_argument(parser, what: str) -> None:
    """``--device {cuda,cpu}`` (``cuda`` by default) on an entry point's
    argument parser; ``what`` names what runs there."""
    parser.add_argument(
        "--device", choices=DEVICE_CHOICES, default="cuda",
        help=f"where {what} runs: 'cuda' (default; exits non-zero when no "
        "CUDA device is present) or 'cpu'",
    )


def device_or_report(choice: str) -> Optional[torch.device]:
    """``choice`` resolved, or ``None`` after printing why it cannot be to
    stderr: an entry point then exits 1 before it builds anything."""
    import sys

    try:
        return resolve_device(choice)
    except RuntimeError as e:
        print(f"device unavailable: {e}", file=sys.stderr, flush=True)
        return None
