"""The state engine's reconcilers (reference pkg/controllers/).

``ThrottleController`` / ``ClusterThrottleController`` recompute
``status.used`` / ``calculatedThreshold`` / ``throttled`` per throttle key,
write status back, un-reserve observed pods, and self-wake at override
boundaries, all driven by store watch events through a rate-limited
workqueue.
"""

from .base import ControllerBase  # noqa: F401
from .throttle import ThrottleController  # noqa: F401
from .clusterthrottle import ClusterThrottleController  # noqa: F401
