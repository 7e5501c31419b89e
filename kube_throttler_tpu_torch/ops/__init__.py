"""Device data plane: the throttler's decision core as PyTorch tensor code.

The reference evaluates `used + reserved + pod.requests vs threshold` in a
per-pod × per-throttle × per-dimension nested Go loop on the scheduler hot
path (throttle_controller.go:349-397). Here that loop is a batched
elementwise/reduction pass over padded int64 milli-unit tensors:

- ``schema``      — tensor layout: presence-masked [T,R]/[P,R] state tensors,
  the resource-dimension registry, host→device encoding, and the state
  carry-across from host arrays.
- ``check``       — the batched ordered 4-state admission check.
- ``fastcheck``   — its residual form (pod-independent precompute).
- ``check_dense`` — the dense [P,T] sweep as a hand-written CUDA kernel.
- ``overrides``   — the override schedule and its resolution at ``now``.
- ``aggregate``   — exact int64 used sums and streaming delta scatters.
"""

from .schema import (  # noqa: F401
    DimRegistry,
    PodBatch,
    ThrottleState,
    encode_pods,
    encode_throttle_state,
)
from .check import (  # noqa: F401
    CHECK_ACTIVE,
    CHECK_INSUFFICIENT,
    CHECK_NOT_AFFECTED,
    CHECK_NOT_THROTTLED,
    CHECK_POD_EXCEEDS,
    STATUS_NAMES,
    check_pods,
    check_pods_compact,
    check_pods_gather,
)
