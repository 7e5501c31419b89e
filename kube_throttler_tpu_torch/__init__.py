"""kube_throttler_tpu_torch — the PyTorch/CUDA port of kube_throttler_tpu.

Same semantics as the JAX package (the ordered 4-state admission check,
presence-masked per-dimension comparison, temporary threshold overrides,
the reserve-until-observed handshake), with the device data plane written
as plain PyTorch functions on tensors plus hand-written CUDA kernels for
Hopper (``csrc/``).

Quantities stay exact int64 milli-units (``quantity.py``). PyTorch keeps
Python ints as int64, so unlike the JAX package there is no global x64
switch to flip at import.

The device is explicit: every entry point that owns device state takes a
``device`` argument, and ``None`` means CUDA. There is no silent CPU
fallback — on a machine without CUDA the caller must ask for
``device="cpu"`` (the tests do).
"""

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda`` (raising when CUDA is absent); anything else is
    taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
