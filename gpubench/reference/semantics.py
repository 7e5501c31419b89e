"""kube-throttler's admission semantics, written plainly over NumPy arrays.

What is computed here, from the cluster's plain data alone:

- selector matching: a Throttle matches the pods of its own namespace
  that any of its terms selects; a ClusterThrottle matches a pod when any
  term's namespaceSelector selects the pod's namespace and its
  podSelector selects the pod. Selectors are matchLabels; an empty one
  selects everything, no term selects nothing;
- the threshold in force at a time: when any temporaryThresholdOverride
  window (both ends inclusive, an empty end open) holds, the first active
  override that sets a dimension gives it, and the merge replaces the
  whole threshold;
- ``used``: the pod count and the summed requests of the counted pods a
  throttle matches (Running and bound to a node), a request dimension
  present only where some counted pod requests it;
- the throttled flags (``used >= threshold`` on each dimension both hold);
- the ordered four-step check of each (pod, throttle) pair: the pod alone
  exceeds the threshold; the flags block it; used saturates the threshold
  (``>=`` for Throttles, ``>`` for ClusterThrottles under PreFilter); used
  plus the pod overflows it (``>``). A request dimension blocks a pod only
  where the pod requests it non-zero; the pod-count dimension always.

All quantities are exact int64 milli-units. ``control`` names a guarantee
to break, for the control run that has to come out not correct:
``ignore_overrides`` resolves no override window.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NOT_THROTTLED, ACTIVE, INSUFFICIENT, EXCEEDS = 0, 1, 2, 3


@dataclass
class Threshold:
    """One ResourceAmount: a pod count (absent when ``cnt_p`` is false)
    and per-dimension requests (absent where ``req_p`` is false)."""

    cnt: int
    cnt_p: bool
    req: np.ndarray  # int64[R]
    req_p: np.ndarray  # bool[R]


@dataclass
class Override:
    begin: Optional[datetime]  # None: open
    end: Optional[datetime]  # None: open
    threshold: Threshold


@dataclass
class Selector:
    """One selector term: matchLabels on the namespace and on the pod."""

    namespace: Dict[str, str] = field(default_factory=dict)
    pod: Dict[str, str] = field(default_factory=dict)


@dataclass
class ThrottleSet:
    """The throttles of one kind. ``ns[t]`` is the namespace index of a
    Throttle, -1 for a ClusterThrottle."""

    kind: str  # "throttle" | "clusterthrottle"
    keys: List[str]
    ns: np.ndarray  # int64[T]
    terms: List[List[Selector]]
    base: List[Threshold]
    overrides: List[List[Override]]


@dataclass
class Namespaces:
    names: List[str]
    labels: Dict[str, np.ndarray]  # key -> object[N] of values (None: unset)


@dataclass
class Pods:
    """The pod table; rows are never reused. ``alive`` is false once a
    pod is deleted; ``counted`` is Running and bound to a node."""

    names: List[str]
    ns: np.ndarray  # int64[P]
    labels: Dict[str, np.ndarray]  # key -> object[P] of values (None: unset)
    req: np.ndarray  # int64[P,R] milli-units
    present: np.ndarray  # bool[P,R]
    counted: np.ndarray  # bool[P]
    alive: np.ndarray  # bool[P]

    def key(self, i: int, namespaces: Namespaces) -> str:
        return f"{namespaces.names[self.ns[i]]}/{self.names[i]}"


# ------------------------------------------------------------------ matching


def _encode(labels: Dict[str, np.ndarray]):
    """key -> (value -> code, int64 codes); an unset label is code -1."""
    out = {}
    for k, col in labels.items():
        vocab: Dict[str, int] = {}
        codes = np.fromiter((-1 if v is None else vocab.setdefault(v, len(vocab)) for v in col),
                            dtype=np.int64, count=len(col))
        out[k] = (vocab, codes)
    return out


def _label_mask(encoded, sel: Dict[str, str], rows) -> np.ndarray:
    """bool over ``rows``: every matchLabels entry of ``sel`` holds."""
    out = np.ones(len(rows), dtype=bool)
    for k, v in sel.items():
        vocab, codes = encoded.get(k, ({}, None))
        if v not in vocab:
            return np.zeros(len(rows), dtype=bool)
        out &= codes[rows] == vocab[v]
    return out


def match_pairs(ts: ThrottleSet, pods: Pods, namespaces: Namespaces) -> Tuple[np.ndarray, np.ndarray]:
    """(pod rows, throttle indices) of every live matched pair, sorted by
    throttle."""
    live = np.flatnonzero(pods.alive)
    by_ns: Dict[int, np.ndarray] = {}
    if ts.kind == "throttle":
        order = np.argsort(pods.ns[live], kind="stable")
        sorted_ns = pods.ns[live][order]
        bounds = np.searchsorted(sorted_ns, np.arange(len(namespaces.names) + 1))
        for n in range(len(namespaces.names)):
            by_ns[n] = live[order[bounds[n]:bounds[n + 1]]]
    all_ns = np.arange(len(namespaces.names))
    pod_codes, ns_codes = _encode(pods.labels), _encode(namespaces.labels)
    p_out, t_out = [], []
    for t, terms in enumerate(ts.terms):
        rows = by_ns[int(ts.ns[t])] if ts.kind == "throttle" else live
        hit = np.zeros(len(rows), dtype=bool)
        for term in terms:
            m = _label_mask(pod_codes, term.pod, rows)
            if ts.kind == "clusterthrottle":
                ns_ok = _label_mask(ns_codes, term.namespace, all_ns)
                m &= ns_ok[pods.ns[rows]]
            hit |= m
        sel = rows[hit]
        p_out.append(sel)
        t_out.append(np.full(sel.size, t, dtype=np.int64))
    if not p_out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(p_out).astype(np.int64), np.concatenate(t_out)


# ---------------------------------------------------------------- thresholds


def _active(o: Override, now: datetime) -> bool:
    return (o.begin is None or o.begin <= now) and (o.end is None or now <= o.end)


def resolve(ts: ThrottleSet, now: datetime, R: int, control: Optional[str] = None):
    """(cnt int64[T], cnt_p bool[T], req int64[T,R], req_p bool[T,R]): the
    threshold each throttle has in force at ``now``."""
    T = len(ts.keys)
    cnt = np.zeros(T, np.int64)
    cnt_p = np.zeros(T, bool)
    req = np.zeros((T, R), np.int64)
    req_p = np.zeros((T, R), bool)
    for t in range(T):
        active = [] if control == "ignore_overrides" else [
            o.threshold for o in ts.overrides[t] if _active(o, now)
        ]
        if not active:
            b = ts.base[t]
            cnt[t], cnt_p[t], req[t], req_p[t] = b.cnt, b.cnt_p, b.req, b.req_p
            continue
        for th in active:  # first active override wins, per dimension
            if not cnt_p[t] and th.cnt_p:
                cnt[t], cnt_p[t] = th.cnt, True
            take = th.req_p & ~req_p[t]
            req[t][take] = th.req[take]
            req_p[t] |= take
    return cnt, cnt_p, req, req_p


# ---------------------------------------------------------------------- used


def _segment_sum(values: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    """Exact int64 sums of ``values`` rows by segment id ``seg`` (sorted)."""
    bounds = np.searchsorted(seg, np.arange(n + 1))
    csum = np.zeros((values.shape[0] + 1,) + values.shape[1:], np.int64)
    np.cumsum(values, axis=0, out=csum[1:])
    return csum[bounds[1:]] - csum[bounds[:-1]]


def used(pairs, pods: Pods, T: int):
    """(used_cnt int64[T], used_req int64[T,R], contrib int64[T,R]): the
    counted pods' count, summed requests and the number requesting each
    dimension, over each throttle's matched pods."""
    p, t = pairs
    keep = pods.counted[p]
    p, t = p[keep], t[keep]
    cnt = _segment_sum(np.ones(p.size, np.int64), t, T)
    req = _segment_sum(np.where(pods.present[p], pods.req[p], 0), t, T)
    contrib = _segment_sum(pods.present[p].astype(np.int64), t, T)
    return cnt, req, contrib


def flags(thr, use):
    """The throttled flags reconcile writes: ``threshold.is_throttled(used,
    onEqual=True)``. Returns (st_cnt bool[T], st_req bool[T,R]); a request
    flag exists only where the threshold sets that dimension."""
    cnt, cnt_p, req, req_p = thr
    u_cnt, u_req, contrib = use
    st_cnt = cnt_p & (u_cnt > 0) & (u_cnt >= cnt)
    st_req = req_p & (contrib > 0) & (u_req >= req)
    return st_cnt, st_req


# ------------------------------------------------------------------- checks


def classify(pairs, pods: Pods, thr, use, st, on_equal: bool, step3_on_equal: bool) -> np.ndarray:
    """The four-step status of every pair (NOT_THROTTLED, ACTIVE,
    INSUFFICIENT, EXCEEDS), nothing reserved."""
    p, t = pairs
    cnt, cnt_p, req, req_p = thr
    u_cnt, u_req, contrib = use
    st_cnt, st_req = st
    preq, pnz = pods.req[p], pods.present[p] & (pods.req[p] != 0)
    hit3 = np.greater_equal if step3_on_equal else np.greater
    hit4 = np.greater_equal if on_equal else np.greater
    t_req, t_req_p = req[t], req_p[t]
    exceeds = (cnt_p[t] & (1 > cnt[t])) | np.any(t_req_p & pnz & (preq > t_req), axis=1)
    active = st_cnt[t] | np.any(st_req[t] & pnz, axis=1)
    active |= cnt_p[t] & (u_cnt[t] > 0) & hit3(u_cnt[t], cnt[t])
    active |= np.any(t_req_p & (contrib[t] > 0) & hit3(u_req[t], t_req) & pnz, axis=1)
    insufficient = (cnt_p[t] & hit4(u_cnt[t] + 1, cnt[t])) | np.any(
        t_req_p & hit4(u_req[t] + preq, t_req) & pnz, axis=1
    )
    return np.where(exceeds, EXCEEDS, np.where(
        active, ACTIVE, np.where(insufficient, INSUFFICIENT, NOT_THROTTLED)))


@dataclass
class KindState:
    """One kind's derived state at a point in time."""

    ts: ThrottleSet
    pairs: Tuple[np.ndarray, np.ndarray]
    thr: tuple
    use: tuple
    st: tuple


def kind_state(ts: ThrottleSet, pods: Pods, namespaces: Namespaces, now: datetime,
               control: Optional[str] = None) -> KindState:
    R = pods.req.shape[1]
    pairs = match_pairs(ts, pods, namespaces)
    thr = resolve(ts, now, R, control)
    use = used(pairs, pods, len(ts.keys))
    return KindState(ts, pairs, thr, use, flags(thr, use))


def step3_of(kind: str) -> bool:
    """Step 3 compares with ``>=`` for a Throttle always, and for a
    ClusterThrottle as PreFilter's onEqual (false)."""
    return kind == "throttle"


def verdicts(states: Sequence[KindState], pods: Pods, namespaces: Namespaces) -> Dict[str, bool]:
    """PreFilter's gate for every live pod: no pair of either kind is
    throttled. (Every pod's namespace exists, so no pod is in error.)"""
    blocked = np.zeros(len(pods.names), bool)
    for ks in states:
        status = classify(ks.pairs, pods, ks.thr, ks.use, ks.st, False, step3_of(ks.ts.kind))
        blocked[ks.pairs[0][status != NOT_THROTTLED]] = True
    live = np.flatnonzero(pods.alive)
    return {pods.key(i, namespaces): not blocked[i] for i in live.tolist()}
