"""Shared-nothing multiprocess keyspace sharding.

Measured thread scaling of the single-process engine is ~1.05 at 1→4
threads: the GIL, not the kernels, caps decisions/s and
ingest/s per host. This package cuts the control plane along PAPER.md's
layer 4-5 controller/plugin seam into N worker *processes*:

- :mod:`ring` — consistent-hash partitioning of the Throttle /
  ClusterThrottle keyspace with **selector-affinity route keys**
  (throttles sharing a selector land on one shard, so a pod event
  routes to few shards instead of all of them);
- :mod:`worker` — one shard's full vertical: store + SelectorIndex +
  journal/snapshot/recovery + device planes + micro-batch ingest + both
  controllers + fenced leadership, behind a framed IPC server;
- :mod:`front` — the thin admission front: routes watch/relist events
  to owning shards, scatter-gathers ``pre_filter``/``pre_filter_batch``
  with an AND-merge of shard-local verdicts, two-phase reserves, and
  gang routing by group id;
- :mod:`ipc` — the local transport (length-prefixed pickle frames over
  a socketpair; JSON-line event bodies reuse the journal/replication
  event encoding where objects cross a durability boundary);
- :mod:`supervisor` — spawns and monitors the worker processes,
  restarting and re-syncing a shard that dies.

See docs/PERFORMANCE.md "Multiprocess keyspace sharding".
"""

from .ring import HashRing, route_key_for, stable_hash64  # noqa: F401
from .front import AdmissionFront  # noqa: F401

__all__ = ["HashRing", "route_key_for", "stable_hash64", "AdmissionFront"]
