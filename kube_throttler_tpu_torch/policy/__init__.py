"""Preemption & policy engine (docs/policy.md).

``spec``    — PolicySpec / PolicyEngine: policy-as-data value weights and
              preemption knobs, hot-swappable with the same RFC3339
              activation-window + first-wins machinery as
              temporaryThresholdOverrides.
``victims`` — deficit derivation + eviction-unit ranking + the
              ``sequential_victim_select`` host oracle the batched kernel
              (ops/victim_select.py) is pinned to.
``preempt`` — PreemptionCoordinator: journaled (PREEMPT begin/commit/
              rollback), gang-atomic victim eviction driven by the
              scheduler when a high-priority group cannot fit.
"""

from .spec import (  # noqa: F401
    ClassWeight,
    PolicyEngine,
    PolicySpec,
    policy_spec_from_dict,
    policy_specs_from_config,
)
from .victims import (  # noqa: F401
    EvictionUnit,
    build_selection_problem,
    compute_gang_deficits,
    rank_eviction_units,
    sequential_victim_select,
)
from .preempt import PreemptionCoordinator  # noqa: F401
