"""A seeded small cluster as manifest dicts (numpy's generator), shared by
the port's daemon and host-only parity tests: 3 namespaces, 48 Throttles,
3 ClusterThrottles and ``n_pods`` pods, three in four of them bound.

Each package decodes the same dicts with its own ``api/serialization``,
so the JAX package and the port see one cluster."""

import numpy as np

NAMESPACES = (("ns-a", {"team": "red"}), ("ns-b", {"team": "blue"}), ("ns-c", {"team": "red"}))
SCHEDULER = "my-scheduler"
THROTTLER = "kube-throttler"
N_THROTTLES = 48
N_CLUSTER_THROTTLES = 3


def _threshold(rng, scale=1):
    pick = int(rng.integers(4))
    if pick == 0:
        return {"resourceCounts": {"pod": int(rng.integers(4, 16)) * scale}}
    if pick == 1:
        return {"resourceRequests": {"cpu": f"{int(rng.integers(10, 50)) * 100 * scale}m"}}
    if pick == 2:
        return {"resourceRequests": {"memory": f"{int(rng.integers(6, 20)) * 256 * scale}Mi"}}
    return {
        "resourceCounts": {"pod": int(rng.integers(6, 20)) * scale},
        "resourceRequests": {"cpu": f"{int(rng.integers(20, 50)) * 100 * scale}m"},
    }


def manifests(seed=0, n_pods=240):
    """Namespaces first, then Throttles, ClusterThrottles and Pods — the
    order a client applies them in."""
    rng = np.random.default_rng(seed)
    out = [
        {"kind": "Namespace", "metadata": {"name": name, "labels": labels}}
        for name, labels in NAMESPACES
    ]
    for i in range(N_THROTTLES):
        out.append({
            "kind": "Throttle",
            "metadata": {"name": f"t{i}", "namespace": NAMESPACES[i % 3][0]},
            "spec": {
                "throttlerName": THROTTLER,
                "threshold": _threshold(rng),
                "selector": {"selectorTerms": [
                    {"podSelector": {"matchLabels": {"app": f"a{i % 12}"}}}
                ]},
            },
        })
    for j in range(N_CLUSTER_THROTTLES):
        out.append({
            "kind": "ClusterThrottle",
            "metadata": {"name": f"c{j}"},
            "spec": {
                "throttlerName": THROTTLER,
                # c0 roomy, c1-c2 tight
                "threshold": _threshold(rng, scale=8 if j == 0 else 1),
                "selector": {"selectorTerms": [{
                    "podSelector": {"matchLabels": {"tier": f"s{j}"}},
                    "namespaceSelector": {"matchLabels": {"team": "red" if j % 2 else "blue"}},
                }]},
            },
        })
    for k in range(n_pods):
        bound = k % 4 != 0
        out.append({
            "kind": "Pod",
            "metadata": {
                "name": f"p{k}",
                "namespace": NAMESPACES[k % 3][0],
                "labels": {"app": f"a{int(rng.integers(12))}", "tier": f"s{int(rng.integers(3))}"},
            },
            "spec": {
                "schedulerName": SCHEDULER,
                "nodeName": "node-1" if bound else "",
                "containers": [{"name": "c", "resources": {"requests": {
                    "cpu": f"{int(rng.integers(1, 6)) * 100}m",
                    "memory": f"{int(rng.integers(1, 5)) * 128}Mi",
                }}}],
            },
            "status": {"phase": "Running" if bound else "Pending"},
        })
    return out


def pod_keys(docs, pending_only=False):
    return [
        f"{d['metadata']['namespace']}/{d['metadata']['name']}"
        for d in docs
        if d["kind"] == "Pod" and not (pending_only and d["spec"]["nodeName"])
    ]
