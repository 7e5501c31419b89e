"""The cluster a configuration file describes, as plain data from a seed.

One general generator reads a configuration (``configs/<name>.json``) and
a seed and returns a :class:`Cluster`: namespaces, pods, Throttles and
ClusterThrottles as the plain reference's arrays, plus the quantity
strings the program is given. Every seed gets the same sizes: each
drawn property is a fixed multiset of values (the configuration's
weights times the count) in a seeded order, so a seed changes which pod
or throttle gets what, not how much work there is.

Configuration keys read here:

- ``dims``: the request dimensions, in order;
- ``namespaces``: ``count`` and ``labels`` (``{key: {"values": n}}``,
  each namespace drawing ``key-0`` .. ``key-(n-1)``);
- ``pods``: ``per_namespace``, ``running`` (the first pods of each
  namespace, Running and bound; the rest Pending), ``labels`` as above,
  and ``requests`` (``{dim: {"values": [...], "weights": [...],
  "share": s}}``: a share ``s`` of the pods requests the dimension);
- ``throttles`` / ``cluster_throttles``: ``per_namespace`` or ``count``,
  ``terms`` (selector templates, below), ``classes`` with ``assign``
  (``weights`` or ``cycle``), and optionally ``overrides``.

A selector template maps a label key to ``"index"`` (value number
``i mod n`` for throttle ``i``) or ``"draw"`` (a seeded value). A
threshold class maps ``pod`` and each dimension to an absolute quantity
or to ``{"sum_plus": [...]}``: the counted pods' sum over the throttle's
matched pods plus one of the listed headrooms, so thresholds sit where
the cluster's own usage puts them. Override windows are hours relative to
the run's start (``begin_h``, ``end_h``; null is open).
"""

from __future__ import annotations

import json
from bisect import bisect_right
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from pathlib import Path
from itertools import accumulate
from typing import Dict, List, Optional

import numpy as np

from .reference.quantity import milli
from .reference.semantics import (
    Namespaces, Override, Pods, Selector, Threshold, ThrottleSet, match_pairs, used,
)

ROOT = Path(__file__).resolve().parent


@dataclass
class Spec:
    """A threshold as the program is given it: pod count and request
    quantity strings (None: the family is absent)."""

    pod: Optional[int]
    requests: Optional[Dict[str, str]]


@dataclass
class Cluster:
    config: dict
    dims: List[str]
    namespaces: Namespaces
    pods: Pods
    pod_requests: List[Dict[str, str]]  # per pod row: dim -> quantity
    throttles: ThrottleSet
    cluster_throttles: ThrottleSet
    specs: Dict[str, List[Spec]]  # kind -> base spec per throttle
    override_specs: Dict[str, List[List[tuple]]]  # kind -> [(begin, end, Spec)]
    base_time: datetime
    seed: int


def load_config(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def rfc3339(dt: datetime) -> str:
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


def fixed_multiset(rng: np.random.Generator, n: int, weights) -> np.ndarray:
    """``n`` indices into ``weights``: each index as often as its weight
    gives (largest remainders fill the rest), in a seeded order."""
    w = np.asarray(weights, dtype=float)
    w = w / w.sum()
    counts = np.floor(w * n).astype(np.int64)
    rest = n - counts.sum()
    if rest:
        counts[np.argsort(-(w * n - counts), kind="stable")[:rest]] += 1
    return rng.permutation(np.repeat(np.arange(len(w)), counts))


def draw(rng, spec: dict) -> str:
    """One value of a menu ``{"values": [...], "weights": [...]}``."""
    values = spec["values"]
    cum = list(accumulate(spec.get("weights", [1.0] * len(values))))
    return str(values[bisect_right(cum, rng.random() * cum[-1])])


def _labels(rng, n: int, spec: dict) -> Dict[str, np.ndarray]:
    out = {}
    for key, lab in spec.items():
        k = int(lab["values"])
        codes = fixed_multiset(rng, n, [1.0] * k)
        out[key] = np.array([f"{key}-{c}" for c in range(k)], dtype=object)[codes]
    return out


def quantity_str(v_milli: int) -> str:
    return str(v_milli // 1000) if v_milli % 1000 == 0 else f"{v_milli}m"


def draw_pods(rng, cfg: dict, namespaces: Namespaces, dims: List[str]):
    """(Pods, per-row request strings) for the configuration's pods."""
    pc = cfg["pods"]
    n_ns = len(namespaces.names)
    per, running = int(pc["per_namespace"]), int(pc["running"])
    P = n_ns * per
    ns = np.repeat(np.arange(n_ns, dtype=np.int64), per)
    counted = np.tile(np.arange(per) < running, n_ns)
    labels = _labels(rng, P, pc.get("labels", {}))
    R = len(dims)
    req = np.zeros((P, R), np.int64)
    present = np.zeros((P, R), bool)
    strings: List[Dict[str, str]] = [{} for _ in range(P)]
    for r, dim in enumerate(dims):
        spec = pc["requests"].get(dim)
        if spec is None:
            continue
        values = spec["values"]
        weights = spec.get("weights", [1.0] * len(values))
        n_req = int(round(float(spec.get("share", 1.0)) * P))
        who = np.sort(rng.permutation(P)[:n_req])
        picks = fixed_multiset(rng, n_req, weights)
        vm = np.array([milli(v) for v in values], np.int64)
        req[who, r] = vm[picks]
        present[who, r] = True
        for i, j in zip(who.tolist(), picks.tolist()):
            strings[i][dim] = str(values[j])
    names = [f"p{i}" for i in range(P)]
    pods = Pods(names=names, ns=ns, labels=labels, req=req, present=present,
                counted=counted, alive=np.ones(P, bool))
    return pods, strings


def _selector(template: Dict[str, str], i: int, label_spec: dict, rng) -> Dict[str, str]:
    out = {}
    for key, how in template.items():
        k = int(label_spec[key]["values"])
        c = i % k if how == "index" else int(rng.integers(k))
        out[key] = f"{key}-{c}"
    return out


def _threshold(cls: dict, sums, dims: List[str], rng) -> Spec:
    """One class made concrete against ``sums`` = (count, req[R])."""
    cnt_sum, req_sum = sums

    def value(spec, base_milli: int) -> int:
        if isinstance(spec, dict):
            return base_milli + milli(spec["sum_plus"][int(rng.integers(len(spec["sum_plus"])))])
        return milli(spec)

    pod = None
    if "pod" in cls:
        pod = max(value(cls["pod"], int(cnt_sum) * 1000) // 1000, 1)
    requests = None
    for r, dim in enumerate(dims):
        if dim in cls:
            requests = requests or {}
            requests[dim] = quantity_str(value(cls[dim], int(req_sum[r])))
    return Spec(pod, requests)


def _as_threshold(spec: Spec, dims: List[str]) -> Threshold:
    R = len(dims)
    req, req_p = np.zeros(R, np.int64), np.zeros(R, bool)
    for r, dim in enumerate(dims):
        if spec.requests and dim in spec.requests:
            req[r], req_p[r] = milli(spec.requests[dim]), True
    return Threshold(cnt=spec.pod or 0, cnt_p=spec.pod is not None, req=req, req_p=req_p)


def _classes(rng, n: int, tc: dict) -> List[dict]:
    classes = tc["classes"]
    if tc.get("assign", "weights") == "cycle":
        return [classes[i % len(classes)] for i in range(n)]
    picks = fixed_multiset(rng, n, [c.get("weight", 1.0) for c in classes])
    return [classes[j] for j in picks]


def draw_throttles(rng, kind: str, tc: dict, cfg: dict, namespaces: Namespaces, pods: Pods,
                   dims: List[str], base_time: datetime):
    """(ThrottleSet, base specs, override specs) of one kind."""
    n_ns = len(namespaces.names)
    if kind == "throttle":
        per = int(tc["per_namespace"])
        T = n_ns * per
        ns = np.repeat(np.arange(n_ns, dtype=np.int64), per)
        keys = [f"{namespaces.names[ns[i]]}/t{i}" for i in range(T)]
    else:
        T = int(tc["count"])
        ns = np.full(T, -1, np.int64)
        keys = [f"/c{i}" for i in range(T)]
    pod_labels = cfg["pods"].get("labels", {})
    ns_labels = cfg["namespaces"].get("labels", {})
    terms = [
        [Selector(namespace=_selector(term.get("namespace", {}), i, ns_labels, rng),
                  pod=_selector(term.get("pod", {}), i, pod_labels, rng))
         for term in tc["terms"]]
        for i in range(T)
    ]
    ts = ThrottleSet(kind=kind, keys=keys, ns=ns, terms=terms, base=[], overrides=[[]] * T)
    cnt, req, _ = used(match_pairs(ts, pods, namespaces), pods, T)
    specs = [_threshold(c, (cnt[i], req[i]), dims, rng)
             for i, c in enumerate(_classes(rng, T, tc))]
    ts.base = [_as_threshold(s, dims) for s in specs]
    override_specs: List[List[tuple]] = [[] for _ in range(T)]
    oc = tc.get("overrides")
    if oc:
        chosen = np.sort(rng.permutation(T)[: int(oc["count"])])
        per_window = []
        for w in oc["windows"]:
            per_window.append(_classes(rng, chosen.size, w))
        for j, i in enumerate(chosen.tolist()):
            for w, cls in zip(oc["windows"], per_window):
                begin = base_time + timedelta(hours=w["begin_h"])
                end = None if w["end_h"] is None else base_time + timedelta(hours=w["end_h"])
                override_specs[i].append((begin, end, _threshold(cls[j], (cnt[i], req[i]), dims, rng)))
    ts.overrides = [
        [Override(begin=b, end=e, threshold=_as_threshold(s, dims)) for b, e, s in row]
        for row in override_specs
    ]
    return ts, specs, override_specs


def generate(cfg: dict, seed: int, base_time: Optional[datetime] = None) -> Cluster:
    """The configuration's cluster for ``seed``; override windows are
    placed around ``base_time`` (default: now, to the second)."""
    base_time = base_time or datetime.now(timezone.utc).replace(microsecond=0)
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 1])
    dims = list(cfg["dims"])
    nc = cfg["namespaces"]
    n_ns = int(nc["count"])
    namespaces = Namespaces(names=[f"ns-{i}" for i in range(n_ns)],
                            labels=_labels(rng, n_ns, nc.get("labels", {})))
    pods, strings = draw_pods(rng, cfg, namespaces, dims)
    sets, specs, ovs = {}, {}, {}
    for kind, section in (("throttle", "throttles"), ("clusterthrottle", "cluster_throttles")):
        tc = cfg.get(section)
        if tc is None:
            tc = {"count": 0, "terms": [], "classes": [{}]}
        sets[kind], specs[kind], ovs[kind] = draw_throttles(
            rng, kind, tc, cfg, namespaces, pods, dims, base_time)
    return Cluster(config=cfg, dims=dims, namespaces=namespaces, pods=pods,
                   pod_requests=strings, throttles=sets["throttle"],
                   cluster_throttles=sets["clusterthrottle"], specs=specs,
                   override_specs=ovs, base_time=base_time, seed=int(seed))


def add_pods(cluster: Cluster, new: List[tuple]) -> List[int]:
    """Append live pods, each ``(namespace row, labels, requests,
    counted)``, to the plain table; returns their rows. The arrays grow
    by doubling, the spare rows dead (``alive`` false) until used."""
    p = cluster.pods
    first, n, R = len(p.names), len(new), len(cluster.dims)
    if first + n > p.ns.shape[0]:
        cap = max(2 * p.ns.shape[0], first + n)

        def grow(a, fill):
            out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
            out[: a.shape[0]] = a
            return out

        p.ns, p.req, p.present = grow(p.ns, 0), grow(p.req, 0), grow(p.present, False)
        p.counted, p.alive = grow(p.counted, False), grow(p.alive, False)
        p.labels = {k: grow(v, None) for k, v in p.labels.items()}
    rows = list(range(first, first + n))
    p.names.extend(f"p{r}" for r in rows)
    for r, (ns, labels, requests, counted) in zip(rows, new):
        p.ns[r], p.counted[r], p.alive[r] = ns, counted, True
        for key, col in p.labels.items():
            col[r] = labels.get(key)
        cluster.pod_requests.append({})
        set_requests(cluster, r, requests)
    return rows


def set_requests(cluster: Cluster, row: int, requests: Dict[str, str]) -> None:
    p = cluster.pods
    p.req[row] = 0
    p.present[row] = False
    for r, dim in enumerate(cluster.dims):
        if dim in requests:
            p.req[row, r], p.present[row, r] = milli(requests[dim]), True
    cluster.pod_requests[row] = dict(requests)
