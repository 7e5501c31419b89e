"""ResourceList arithmetic — host-side oracle.

Mirrors the semantics of the reference's ``pkg/resourcelist/resourcelist.go``
(the layer-1 quantity-map arithmetic everything else builds on):

- ``pod_request_resource_list``  — resourcelist.go:27-46: a pod's effective
  request is max(per-init-container max, sum of app containers) + overhead.
- ``add`` / ``sub``              — resourcelist.go:48-62: rhs keys are merged
  into lhs; missing lhs keys start at zero; Sub may go negative.
- ``greater_or_equal``           — resourcelist.go:64-74: lhs ≥ rhs over rhs's
  keys; a key missing from lhs fails the comparison.
- ``set_max`` / ``set_min``      — resourcelist.go:76-98: union-max /
  intersection-min (set_min drops lhs keys absent from rhs).
- ``equal_to``                   — resourcelist.go:100-111: bidirectional
  compare where a missing key reads as the zero quantity.

Here a ResourceList is a plain ``dict[str, Fraction]`` (exact decimals from
``quantity.parse_quantity``). Functions that mutate in Go mutate here too, so
call-site behavior matches the reference.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .api.pod import Pod

ResourceList = Dict[str, Fraction]

ZERO = Fraction(0)


def pod_request_resource_list(pod: "Pod") -> ResourceList:
    """Effective request of a pod (resourcelist.go:27-46)."""
    ic_res: ResourceList = {}
    for c in pod.spec.init_containers:
        set_max(ic_res, c.requests)

    c_res: ResourceList = {}
    for c in pod.spec.containers:
        add(c_res, c.requests)

    set_max(c_res, ic_res)

    if pod.spec.overhead:
        add(c_res, pod.spec.overhead)

    return c_res


def add(lhs: ResourceList, rhs: ResourceList) -> None:
    for name, q in rhs.items():
        lhs[name] = lhs.get(name, ZERO) + q


def sub(lhs: ResourceList, rhs: ResourceList) -> None:
    for name, q in rhs.items():
        lhs[name] = lhs.get(name, ZERO) - q


def greater_or_equal(lhs: ResourceList, rhs: ResourceList) -> bool:
    for name, q in rhs.items():
        if name not in lhs:
            return False
        if lhs[name] < q:
            return False
    return True


def set_max(lhs: ResourceList, rhs: ResourceList) -> None:
    for name, q in rhs.items():
        if name in lhs:
            lhs[name] = max(lhs[name], q)
        else:
            lhs[name] = q


def set_min(lhs: ResourceList, rhs: ResourceList) -> None:
    for name, q in rhs.items():
        if name in lhs:
            lhs[name] = min(lhs[name], q)
    for name in list(lhs.keys()):
        if name not in rhs:
            del lhs[name]


def equal_to(lhs: ResourceList, rhs: ResourceList) -> bool:
    # missing keys read as zero in either direction (resourcelist.go:100-111)
    for name, q in lhs.items():
        if q != rhs.get(name, ZERO):
            return False
    for name, q in rhs.items():
        if q != lhs.get(name, ZERO):
            return False
    return True
