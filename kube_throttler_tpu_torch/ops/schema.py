"""Tensor schema: how throttler state becomes padded device tensors.

Encoding rules (all derived from the oracle semantics in ``api/types.py``):

- Quantities are **int64 milli-units** (exact; see ``quantity.to_milli``).
  Encoding raises on sub-milli precision rather than silently rounding.
- Every value tensor carries a **presence mask**. Absent (Go-nil / missing
  map key) is distinct from zero: absent threshold dims are never evaluated,
  absent used dims never throttle (resource_amount.go:143,151-155). Absent
  cells hold value 0 so sums stay valid without branching.
- Tensors are padded to fixed capacities (throttles T, pods P, resource
  dims R) so shapes stay stable under object churn; validity masks mark
  live rows. Capacities grow geometrically.
- The per-throttle *effective* threshold (status.calculatedThreshold if
  calculatedAt is set, else spec.threshold — throttle_types.go:129-132) is
  resolved at encode time; the check kernel sees one threshold tensor.

The [P,T] selector mask is produced by the host selector index (engine/),
not here — matching is string/label work, which stays on host; the device
sees only its boolean result.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from ..api.pod import Pod
from ..api.types import ClusterThrottle, Throttle
from ..quantity import to_milli  # noqa: F401 — re-exported (engine/columnar.py)
from .. import resourcelist as rl

AnyThrottle = Union[Throttle, ClusterThrottle]

# The int64 planes. Every tensor named here carries exact int64 values —
# milli-unit quantities or pod counts summed over up to 1M pods — and
# must stay int64 end to end: an int32 accumulator overflows at ~2.1e6
# milli-cores (2.1 cores over 1k pods), float32 loses integer exactness
# past 2^24, and float64 past 2^53. The ``dtype`` static checker
# (analysis/device.py) reads this literal set from the AST (the registry
# idiom: keep it a literal) and flags any narrowing cast, narrow-dtype
# accumulator, or default-dtype allocation touching these names anywhere
# in ops/, parallel/, or the engine device/staging planes. The columnar
# arena intentionally stores int32 *columns* (engine/columnar.py); the
# encode boundary upcasts into these planes, which is exactly the cast
# surface the checker pins.
INT64_MILLI_PLANES = frozenset(
    {
        "thr_cnt",
        "thr_req",
        "used_cnt",
        "used_req",
        "res_cnt",
        "res_req",
        "req",  # PodBatch.req / the encoded pod-request rows
        "pod_req",  # engine/devicestate.py staging plane
        "row_req",  # the per-pod encoded [1,R] row
        "au_cnt",  # already-used = used + reserved (gang snapshot)
        "au_req",
        "cls_cnt",  # per-accel-class effective thresholds
        "cls_req",
    }
)


# The verdict-epoch coherence registry. Every attribute named here is a
# verdict-affecting plane or ledger: a PreFilter verdict is a pure
# function of (request-shape id, accel class, matched cols, per-col
# state), and the interned-verdict cache (engine/verdictcache.py) proves
# freshness by epoch sums — so any write to one of these planes that is
# not dominated by a ``col_epoch``/``global_epoch`` bump (or a call into
# a function that bumps) silently serves stale admission verdicts at
# cache-hit speed. The ``epochs`` static checker (analysis/epochs.py)
# reads this literal set from the AST (same registry idiom as
# INT64_MILLI_PLANES above) and flags undominated writes; vetted
# exceptions live in analysis/epoch_allow.txt with justifications.
# Functions that provide the bump for their callers are marked with an
# inline ``#: epoch-bumps:`` annotation at the def site.
VERDICT_EPOCH_PLANES = frozenset(
    {
        # threshold/spec columns (effective_threshold inputs)
        "thr_cnt",
        "thr_cnt_present",
        "thr_req",
        "thr_req_present",
        "thr_valid",
        # usage ledgers
        "used_cnt",
        "used_cnt_present",
        "used_req",
        "used_req_present",
        # reservation ledgers (gang reserve/bind writes land here)
        "res_cnt",
        "res_cnt_present",
        "res_req",
        "res_req_present",
        # throttle-status planes (the st_* flip state)
        "st_cnt_throttled",
        "st_req_throttled",
        "st_req_flag_present",
        # per-accel-class threshold overrides
        "accel_cols",
    }
)


class DimRegistry:
    """Stable resource-name → column-index mapping.

    Grows append-only; encoded arrays are padded to ``capacity`` columns so
    adding the (R+1)-th distinct resource name does not change array shapes
    until capacity doubles.
    """

    def __init__(self, capacity: int = 8):
        self._names: List[str] = []
        self._index: Dict[str, int] = {}
        self.capacity = capacity

    def index_of(self, name: str) -> int:
        idx = self._index.get(name)
        if idx is None:
            idx = len(self._names)
            self._names.append(name)
            self._index[name] = idx
            while idx >= self.capacity:
                self.capacity *= 2
        return idx

    @property
    def names(self) -> Sequence[str]:
        return tuple(self._names)

    def __len__(self) -> int:
        return len(self._names)


@dataclass
class ThrottleState:
    """Padded per-kind device state: [T] / [T,R] tensors + presence masks.

    One instance per kind (Throttle, ClusterThrottle), mirroring the two
    controllers in the reference. Field names and order match the JAX
    package's ``ThrottleState``.
    """

    valid: torch.Tensor  # bool[T] — live throttle rows
    thr_cnt: torch.Tensor  # int64[T] — effective threshold pod-count
    thr_cnt_present: torch.Tensor  # bool[T]
    thr_req: torch.Tensor  # int64[T,R]
    thr_req_present: torch.Tensor  # bool[T,R]
    used_cnt: torch.Tensor  # int64[T]
    used_cnt_present: torch.Tensor  # bool[T]
    used_req: torch.Tensor  # int64[T,R]
    used_req_present: torch.Tensor  # bool[T,R]
    res_cnt: torch.Tensor  # int64[T] — scheduler-cycle reservations
    res_cnt_present: torch.Tensor  # bool[T]
    res_req: torch.Tensor  # int64[T,R]
    res_req_present: torch.Tensor  # bool[T,R]
    st_cnt_throttled: torch.Tensor  # bool[T] — status.throttled.resourceCounts.pod
    st_req_throttled: torch.Tensor  # bool[T,R] — status.throttled.resourceRequests
    st_req_flag_present: torch.Tensor  # bool[T,R] — key present in the flag map

    @property
    def num_throttles(self) -> int:
        return self.valid.shape[0]

    @property
    def num_dims(self) -> int:
        return self.thr_req.shape[1]


@dataclass
class PodBatch:
    """Padded pod-side tensors: [P] / [P,R]. Pod count is implicitly 1/pod."""

    valid: torch.Tensor  # bool[P]
    req: torch.Tensor  # int64[P,R]
    req_present: torch.Tensor  # bool[P,R]

    @property
    def num_pods(self) -> int:
        return self.valid.shape[0]


def _tensors(arrays: Mapping[str, object], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays → tensors on ``device``; always a copy, so a tensor never
    aliases the caller's (possibly read-only) buffer."""
    return {
        name: torch.from_numpy(np.array(a)).to(device)
        for name, a in arrays.items()
    }


def _from_arrays(cls, arrays: Mapping[str, object], device):
    """``cls`` built from a dict of host arrays named like its fields (the
    JAX package's dataclass field names), moved to ``device``. Extra keys
    are an error: a misspelt field would otherwise be silently dropped."""
    names = [f.name for f in fields(cls)]
    if set(arrays) != set(names):
        raise ValueError(
            f"{cls.__name__} fields {sorted(names)} != given {sorted(arrays)}"
        )
    dev = resolve_device(device)
    return cls(**_tensors({n: arrays[n] for n in names}, dev))


def throttle_state_from_arrays(arrays: Mapping[str, object], device=None) -> ThrottleState:
    """The state carry-across: a ``ThrottleState`` from numpy arrays named
    like the JAX dataclass fields (e.g. ``{f: np.asarray(getattr(s, f))}``
    of a JAX-encoded state)."""
    return _from_arrays(ThrottleState, arrays, device)


def pod_batch_from_arrays(arrays: Mapping[str, object], device=None) -> PodBatch:
    return _from_arrays(PodBatch, arrays, device)


def check_precomp_from_arrays(arrays: Mapping[str, object], device=None):
    """A ``fastcheck.CheckPrecomp`` from host arrays named like its fields."""
    from .fastcheck import CheckPrecomp

    return _from_arrays(CheckPrecomp, arrays, device)


def _amount_into(
    row_req: np.ndarray,
    row_present: np.ndarray,
    requests: Optional[Dict[str, object]],
    dims: DimRegistry,
) -> None:
    for name, q in (requests or {}).items():
        j = dims.index_of(name)
        row_req[j] = to_milli(q)
        row_present[j] = True


def encode_throttle_state(
    throttles: Sequence[AnyThrottle],
    dims: DimRegistry,
    reserved: Optional[Sequence[Dict[str, object]]] = None,
    capacity: Optional[int] = None,
    device=None,
) -> ThrottleState:
    """Encode (Cluster)Throttle objects into a padded ThrottleState on
    ``device`` (``None`` → CUDA).

    ``reserved`` optionally supplies per-throttle reserved ResourceAmounts
    (as ``api.types.ResourceAmount``); defaults to empty.
    """
    from ..api.types import effective_threshold

    dev = resolve_device(device)
    n = len(throttles)
    # register every name first so R is final before array allocation
    for thr in throttles:
        eff = effective_threshold(thr.spec.threshold, thr.status)
        for name in (eff.resource_requests or {}):
            dims.index_of(name)
        for name in (thr.status.used.resource_requests or {}):
            dims.index_of(name)
        for name in (thr.status.throttled.resource_requests or {}):
            dims.index_of(name)
    if reserved is not None:
        for ra in reserved:
            if ra is not None:
                for name in (ra.resource_requests or {}):
                    dims.index_of(name)

    T = capacity if capacity is not None else max(n, 1)
    R = dims.capacity

    valid = np.zeros(T, dtype=bool)
    thr_cnt = np.zeros(T, dtype=np.int64)
    thr_cnt_present = np.zeros(T, dtype=bool)
    thr_req = np.zeros((T, R), dtype=np.int64)
    thr_req_present = np.zeros((T, R), dtype=bool)
    used_cnt = np.zeros(T, dtype=np.int64)
    used_cnt_present = np.zeros(T, dtype=bool)
    used_req = np.zeros((T, R), dtype=np.int64)
    used_req_present = np.zeros((T, R), dtype=bool)
    res_cnt = np.zeros(T, dtype=np.int64)
    res_cnt_present = np.zeros(T, dtype=bool)
    res_req = np.zeros((T, R), dtype=np.int64)
    res_req_present = np.zeros((T, R), dtype=bool)
    st_cnt_throttled = np.zeros(T, dtype=bool)
    st_req_throttled = np.zeros((T, R), dtype=bool)
    st_req_flag_present = np.zeros((T, R), dtype=bool)

    for i, thr in enumerate(throttles):
        valid[i] = True
        eff = effective_threshold(thr.spec.threshold, thr.status)
        if eff.resource_counts is not None:
            thr_cnt[i] = eff.resource_counts
            thr_cnt_present[i] = True
        _amount_into(thr_req[i], thr_req_present[i], eff.resource_requests, dims)

        used = thr.status.used
        if used.resource_counts is not None:
            used_cnt[i] = used.resource_counts
            used_cnt_present[i] = True
        _amount_into(used_req[i], used_req_present[i], used.resource_requests, dims)

        if reserved is not None and i < len(reserved) and reserved[i] is not None:
            ra = reserved[i]
            if ra.resource_counts is not None:
                res_cnt[i] = ra.resource_counts
                res_cnt_present[i] = True
            _amount_into(res_req[i], res_req_present[i], ra.resource_requests, dims)

        st = thr.status.throttled
        st_cnt_throttled[i] = st.resource_counts_pod
        for name, flag in (st.resource_requests or {}).items():
            j = dims.index_of(name)
            st_req_flag_present[i, j] = True
            st_req_throttled[i, j] = flag

    return ThrottleState(
        **_tensors(
            dict(
                valid=valid,
                thr_cnt=thr_cnt,
                thr_cnt_present=thr_cnt_present,
                thr_req=thr_req,
                thr_req_present=thr_req_present,
                used_cnt=used_cnt,
                used_cnt_present=used_cnt_present,
                used_req=used_req,
                used_req_present=used_req_present,
                res_cnt=res_cnt,
                res_cnt_present=res_cnt_present,
                res_req=res_req,
                res_req_present=res_req_present,
                st_cnt_throttled=st_cnt_throttled,
                st_req_throttled=st_req_throttled,
                st_req_flag_present=st_req_flag_present,
            ),
            dev,
        )
    )


def encode_pods(
    pods: Sequence[Pod],
    dims: DimRegistry,
    capacity: Optional[int] = None,
    device=None,
) -> PodBatch:
    """Encode pods' effective requests into a padded PodBatch on ``device``."""
    dev = resolve_device(device)
    n = len(pods)
    requests = [rl.pod_request_resource_list(p) for p in pods]
    for reqs in requests:
        for name in reqs:
            dims.index_of(name)

    P = capacity if capacity is not None else max(n, 1)
    R = dims.capacity
    valid = np.zeros(P, dtype=bool)
    req = np.zeros((P, R), dtype=np.int64)
    req_present = np.zeros((P, R), dtype=bool)
    for i, reqs in enumerate(requests):
        valid[i] = True
        for name, q in reqs.items():
            j = dims.index_of(name)
            req[i, j] = to_milli(q)
            req_present[i, j] = True
    return PodBatch(**_tensors(dict(valid=valid, req=req, req_present=req_present), dev))


def selector_mask(
    pods: Sequence[Pod],
    throttles: Sequence[AnyThrottle],
    namespaces: Optional[Dict[str, object]] = None,
    pod_capacity: Optional[int] = None,
    throttle_capacity: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Reference-semantics [P,T] selector mask (host loop; small scale /
    tests). Throttles additionally require namespace equality
    (affectedThrottles lists only the pod's namespace —
    throttle_controller.go:248-269); ClusterThrottles match via namespace +
    pod selectors."""
    dev = resolve_device(device)
    P = pod_capacity if pod_capacity is not None else max(len(pods), 1)
    T = throttle_capacity if throttle_capacity is not None else max(len(throttles), 1)
    mask = np.zeros((P, T), dtype=bool)
    for i, pod in enumerate(pods):
        for j, thr in enumerate(throttles):
            if isinstance(thr, Throttle):
                mask[i, j] = thr.namespace == pod.namespace and thr.spec.selector.matches_to_pod(pod)
            else:
                ns = (namespaces or {}).get(pod.namespace)
                if ns is None:
                    mask[i, j] = False
                else:
                    mask[i, j] = thr.spec.selector.matches_to_pod(pod, ns)
    return torch.from_numpy(mask).to(dev)
