"""Typed API model: Throttle / ClusterThrottle CRDs and pure decision logic.

Layer 2 of the reference (pkg/apis/schedule/v1alpha1): the CRD structs plus
the pure functions the whole system hinges on — ``is_throttled``,
``check_throttled_for``, ``calculate_threshold``, selector matching. These
Python implementations are the *oracle*: every XLA kernel in ``ops/`` is
property-tested against them.
"""

from .pod import Container, Namespace, Pod, PodSpec, PodStatus  # noqa: F401
from .types import (  # noqa: F401
    CalculatedThreshold,
    CheckThrottleStatus,
    ClusterThrottle,
    ClusterThrottleSelector,
    ClusterThrottleSelectorTerm,
    ClusterThrottleSpec,
    IsResourceAmountThrottled,
    LabelSelector,
    ResourceAmount,
    TemporaryThresholdOverride,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
    ThrottleStatus,
    resource_amount_of_pod,
)
