"""Host state engine: the event-driven control plane.

The reference's "distributed communication backend" is the Kubernetes API
server watch protocol (SURVEY §5): list-watch informer caches feed delta
event handlers, reconciles write status back optimistically, and the
scheduler hot path reads caches synchronously. This package reproduces that
protocol against a deterministic in-memory store — the reference's weakest
test dependency was a real kind cluster; a replayable in-process apiserver
lets the 100k-pod configs run anywhere — plus the pieces around it:

- ``store``        — object store with resourceVersion + watch fan-out
- ``workqueue``    — client-go-style rate-limited work queue with AddAfter
- ``reservations`` — the scheduler-cycle reservation ledger
- ``index``        — incremental [P,T] selector-mask maintenance
- ``devicestate``  — host→device tensor mirror serving the check kernels
"""

from .store import Event, EventType, Store  # noqa: F401
from .workqueue import RateLimitingQueue  # noqa: F401
from .reservations import ReservedResourceAmounts  # noqa: F401
