"""HTTP daemon surface: the standalone throttler service.

The reference ships as a plugin living inside kube-scheduler's process (its
API surface is the scheduler framework + the CRDs on the apiserver). The
standalone TPU framework exposes the same operations over HTTP so any
scheduler (or test driver) can use it without embedding Python:

- ``GET  /healthz``                  liveness
- ``GET  /readyz``                   component readiness (device breaker,
                                     workqueue depths)
- ``GET  /metrics``                  Prometheus exposition (the 16 families)
- ``POST /v1/objects``               create-or-update a manifest
                                     (Pod / Namespace / Throttle / ClusterThrottle)
- ``DELETE /v1/objects/{kind}/{key}``
- ``GET  /v1/throttles`` ``/v1/clusterthrottles`` ``/v1/pods``  list + status
- ``POST /v1/prefilter``             {pod manifest | {"podKey": ...}} → status/reasons
- ``POST /v1/reserve`` ``/v1/unreserve``
- ``POST /v1/bind``                  {"podKey", "nodeName"} — scheduler-sim
                                     convenience: marks the pod scheduled+Running

Handlers are thin wrappers over the plugin's typed clientset + listers
(the client layer the reference reads/writes through, plugin.go:76-88);
concurrency is whatever the plugin already guarantees.
"""

from __future__ import annotations

import json
import threading
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from .utils.lockorder import make_lock
from .api.pod import Namespace
from .api.serialization import object_from_dict
from .api.types import ClusterThrottle, Throttle
from .utils import tracing
from .engine.store import NotFoundError, Store
from .plugin import KubeThrottler


def _throttle_to_dict(thr) -> dict:
    out = {
        "metadata": {"name": thr.name},
        "status": {
            "used": thr.status.used.to_dict(),
            "throttled": thr.status.throttled.to_dict(),
            "calculatedThreshold": {
                "threshold": thr.status.calculated_threshold.threshold.to_dict(),
                "calculatedAt": (
                    thr.status.calculated_threshold.calculated_at.isoformat()
                    if thr.status.calculated_threshold.calculated_at
                    else None
                ),
                "messages": list(thr.status.calculated_threshold.messages),
            },
        },
        "spec": {"threshold": thr.spec.threshold.to_dict()},
    }
    if isinstance(thr, Throttle):
        out["metadata"]["namespace"] = thr.namespace
        out["kind"] = "Throttle"
    else:
        out["kind"] = "ClusterThrottle"
    return out


class ThrottlerHTTPServer:
    def __init__(
        self,
        plugin: Optional[KubeThrottler],
        host: str = "127.0.0.1",
        port: int = 10259,
        remote: bool = False,
        ha=None,
        metrics_registry=None,
        replica_gate=None,
        owner_url: Optional[str] = None,
    ):
        """``remote=True`` (daemon synced from a real apiserver via
        reflectors) disables the local object-mutation endpoints: a local
        write to a reflector-owned kind would be silently reverted by the
        next watch event — mutate the real cluster instead. Admission
        endpoints (/v1/prefilter, reserve, unreserve) stay available.

        ``plugin=None`` + ``ha`` (an engine.replication.HaCoordinator) is
        STANDBY mode: the server answers /healthz (alive), reports role
        ``standby`` on /readyz (503 — probes must not route admission
        traffic here), and refuses every /v1 endpoint except the
        replication routes. :meth:`set_plugin` flips it to serving at
        promotion. A LEADER passes ``ha`` too: its replication source is
        served from ``/v1/replication/*`` so warm standbys can bootstrap
        and stream the journal tail.

        ``metrics_registry`` makes ``/metrics`` scrapeable BEFORE the
        plugin exists — a standby's replication lag is exactly the metric
        that only matters pre-promotion; falls back to the plugin's
        registry when absent (they are the same object in the daemon).

        ``replica_gate`` (an engine.replication.ReplicaGate) + ``owner_url``
        is READ-REPLICA mode: /v1/prefilter and /v1/prefilter-batch are
        served LOCALLY from the replicated mirror — gated on the staleness
        bound (503 when the replica cannot prove freshness) — and every
        write surface (/v1/objects, reserve/unreserve, bind, tick, DELETE)
        is transparently forwarded to the owner, so a client can point at
        either tier without caring which one it hit."""
        if plugin is None and ha is None:
            raise ValueError("plugin-less server requires an HA coordinator")
        if replica_gate is not None and (plugin is None or not owner_url):
            raise ValueError("replica mode requires a plugin and an owner URL")
        self.plugin = plugin
        self.remote = remote
        self.ha = ha
        self.replica_gate = replica_gate
        self.owner_url = owner_url
        self.metrics_registry = (
            metrics_registry
            if metrics_registry is not None
            else (plugin.metrics_registry if plugin is not None else None)
        )
        self.store = plugin.store if plugin is not None else None
        self.clientset = plugin.clientset if plugin is not None else None
        self.listers = plugin.listers if plugin is not None else None
        # serializes get-then-update pod mutations (re-apply, bind): the
        # handler pool is threaded and a lost update here silently unbinds
        # a running pod
        self._pod_write_lock = make_lock("server.pod_write")
        # graceful-shutdown flag (single writer: the SIGTERM path). While
        # set, /readyz answers 503 "down" so the load balancer / kubelet
        # drains this instance before the final snapshot + journal fsync;
        # /healthz stays 200 — the process is alive and must not be killed
        # mid-flush.
        self._draining = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, body, content_type="application/json"):
                data = (
                    body.encode() if isinstance(body, str) else json.dumps(body).encode()
                )
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", "0"))
                if length == 0:
                    return {}
                return json.loads(self.rfile.read(length))

            def do_GET(self):
                try:
                    outer._get(self)
                except Exception as e:  # pragma: no cover
                    self._send(500, {"error": str(e)})

            def do_POST(self):
                try:
                    outer._post(self)
                except NotFoundError as e:
                    self._send(404, {"error": str(e)})
                except Exception as e:
                    self._send(400, {"error": str(e)})

            def do_DELETE(self):
                try:
                    outer._delete(self)
                except NotFoundError as e:
                    self._send(404, {"error": str(e)})
                except Exception as e:
                    self._send(400, {"error": str(e)})

            def do_PUT(self):
                try:
                    outer._put(self)
                except Exception as e:
                    self._send(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- handlers

    def _put(self, h) -> None:
        # dynamic verbosity — the scheduler's PUT /debug/flags/v analog
        # (reference Makefile:94-95: log-level / log-level-debug targets)
        if h.path == "/debug/flags/v":
            length = int(h.headers.get("Content-Length", "0"))
            raw = h.rfile.read(length).decode().strip() if length else ""
            level = int(raw)
            prev = tracing.set_verbosity(level)
            h._send(200, f"successfully set klog.logging.verbosity to {level} (was {prev})",
                    content_type="text/plain")
        else:
            h._send(404, {"error": f"unknown path {h.path}"})

    def _get(self, h) -> None:
        if self.ha is not None and self.ha.source is not None:
            from .engine.replication import handle_replication_get

            if handle_replication_get(h, self.ha.source, h.path):
                return
        if h.path == "/healthz":
            h._send(200, "ok", content_type="text/plain")
        elif h.path == "/metrics" and self.metrics_registry is not None:
            # served on a standby too (plugin still None): replication lag
            # is the one family operators need exactly while standing by
            h._send(
                200,
                self.metrics_registry.exposition(),
                content_type="text/plain; version=0.0.4",
            )
        elif self.plugin is None:
            # standby: alive but not serving — /readyz reports the role
            # (503 keeps admission traffic away until promotion) and every
            # other surface refuses
            if h.path == "/readyz":
                state, detail = self.ha.health_state()
                h._send(
                    503,
                    {
                        "ok": False,
                        "state": "standby",
                        "components": {"ha": {"state": state, **detail}},
                    },
                )
            else:
                h._send(503, {"error": "standby replica; not serving yet"})
        elif h.path == "/readyz":
            # component readiness via the health state machine (health.py):
            # 200 while serving is possible — ok AND degraded both serve
            # (an open device breaker is a latency regression, the host
            # oracle answers); 503 only when a component is down (e.g. a
            # reflector that never synced — verdicts would be fabricated
            # from an empty cache). Legacy keys (ok/device/workqueues) are
            # kept for existing probes.
            dm = self.plugin.device_manager
            snap = self.plugin.health.snapshot()
            if self._draining:
                snap["state"] = "down"
                snap["components"]["shutdown"] = {
                    "state": "down",
                    "reason": "draining (SIGTERM received)",
                }
            body = {
                "ok": snap["state"] != "down",
                "state": snap["state"],
                "components": snap["components"],
                "device": (
                    {"enabled": False}
                    if dm is None
                    else {
                        "enabled": True,
                        "available": dm.device_available(),
                        "breaker": dm.breaker_state(),
                    }
                ),
                # the sharded front has no local controllers — its
                # workqueues live in the worker processes (per-shard
                # depths come back on the shards component instead)
                "workqueues": (
                    {
                        "throttle": len(self.plugin.throttle_ctr.workqueue),
                        "clusterthrottle": len(
                            self.plugin.cluster_throttle_ctr.workqueue
                        ),
                    }
                    if hasattr(self.plugin, "throttle_ctr")
                    else {}
                ),
            }
            if self.ha is not None:
                body["role"] = self.ha.role
                body["epoch"] = self.ha.epoch.current()
            if self.replica_gate is not None:
                # the gate's component (registered on plugin.health by the
                # CLI) already drives state: a stale replica reports down,
                # so probes stop routing admission traffic here
                body["role"] = "replica"
            h._send(200 if snap["state"] != "down" else 503, body)
        elif h.path == "/v1/throttles":
            h._send(200, [_throttle_to_dict(t) for t in self.listers.throttles.list()])
        elif h.path == "/v1/clusterthrottles":
            h._send(
                200, [_throttle_to_dict(t) for t in self.listers.cluster_throttles.list()]
            )
        elif h.path == "/v1/pods":
            h._send(
                200,
                [
                    {
                        "key": p.key,
                        "nodeName": p.spec.node_name,
                        "phase": p.status.phase,
                        "labels": p.labels,
                    }
                    for p in self.listers.pods.list()
                ],
            )
        else:
            h._send(404, {"error": f"unknown path {h.path}"})

    def _resolve_pod(self, body: dict):
        if "podKey" in body:
            namespace, _, name = body["podKey"].partition("/")
            return self.store.get_pod(namespace, name)
        pod = object_from_dict(body)
        return pod

    _REMOTE_REFUSAL = (
        "this daemon mirrors a remote apiserver (kubeconfig mode); local "
        "object writes would be reverted by the watch stream — mutate the "
        "objects on the cluster instead"
    )

    _REPLICA_READ_PATHS = ("/v1/prefilter", "/v1/prefilter-batch")

    def _forward_to_owner(self, h, method: str, body: Optional[dict]) -> None:
        """Relay a write-surface request to the owner and stream its answer
        back verbatim. The replica adds one hop of latency to writes — the
        price of letting clients stay owner-oblivious; reads never forward."""
        from http.client import HTTPConnection, HTTPException
        from urllib.parse import urlsplit

        split = urlsplit(self.owner_url)
        conn = HTTPConnection(
            split.hostname or "127.0.0.1", split.port or 80, timeout=10.0
        )
        try:
            payload = json.dumps(body or {}).encode()
            conn.request(
                method,
                h.path,
                body=payload if method != "DELETE" else None,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, HTTPException) as e:
            h._send(502, {"error": f"owner unreachable: {e}"})
            return
        finally:
            conn.close()
        h.send_response(resp.status)
        h.send_header(
            "Content-Type", resp.getheader("Content-Type") or "application/json"
        )
        h.send_header("Content-Length", str(len(data)))
        h.send_header("X-KT-Forwarded-By", "replica")
        h.end_headers()
        h.wfile.write(data)

    def _post(self, h) -> None:
        if self.plugin is None:
            h._send(503, {"error": "standby replica; not serving yet"})
            return
        body = h._body()
        if self.replica_gate is not None:
            if h.path not in self._REPLICA_READ_PATHS:
                # every write surface belongs to the owner — forward
                self._forward_to_owner(h, "POST", body)
                return
            if not self.replica_gate.admit():
                # staleness bound breached: refusing beats serving a
                # verdict that may predate a flip — the client retries
                # against the owner (or another replica)
                h._send(
                    503,
                    {
                        "error": "replica stale: replication lag exceeds "
                        "the staleness bound",
                        "maxLagSeconds": self.replica_gate.max_lag_s,
                    },
                )
                return
        if self.remote and h.path in ("/v1/objects", "/v1/bind"):
            h._send(409, {"error": self._REMOTE_REFUSAL})
            return
        if h.path == "/v1/objects":
            kind = body.get("kind", "")
            core = self.clientset.core_v1()
            schedule = self.clientset.schedule_v1alpha1()
            if kind == "Namespace":
                ns = Namespace(
                    name=body["metadata"]["name"],
                    labels=dict(body["metadata"].get("labels") or {}),
                )
                try:
                    core.namespaces().create(ns)
                except ValueError:
                    core.namespaces().update(ns)
                h._send(200, {"applied": f"namespace/{ns.name}"})
                return
            obj = object_from_dict(body)
            try:
                if kind == "Pod":
                    core.pods(obj.namespace).create(obj)
                elif kind == "Throttle":
                    schedule.throttles(obj.namespace).create(obj)
                else:
                    schedule.cluster_throttles().create(obj)
            except ValueError:
                if kind == "Pod":
                    # a manifest re-apply must not clobber server-owned state:
                    # nodeName (set by bind) and phase live on the stored pod
                    with self._pod_write_lock:
                        current = core.pods(obj.namespace).get(obj.name)
                        if not obj.spec.node_name:
                            obj = replace(obj, spec=replace(obj.spec, node_name=current.spec.node_name))
                        if "status" not in body:
                            obj = replace(obj, status=replace(current.status))
                        core.pods(obj.namespace).update(obj)
                elif kind == "Throttle":
                    # the clientset's update has main-resource semantics: the
                    # stored status is preserved (status subresource)
                    schedule.throttles(obj.namespace).update(obj)
                else:
                    schedule.cluster_throttles().update(obj)
            h._send(200, {"applied": getattr(obj, "key", obj.name)})
        elif h.path == "/v1/prefilter":
            pod = self._resolve_pod(body)
            status = self.plugin.pre_filter(pod)
            h._send(
                200,
                {"code": status.code.value, "reasons": list(status.reasons)},
            )
        elif h.path == "/v1/prefilter-batch":
            h._send(200, self.plugin.pre_filter_batch())
        elif h.path == "/v1/tick":
            # fused reconcile+PreFilter sweep over a device mesh;
            # body: {"devices": N?, "shape": [dp, tp]?}
            h._send(
                200,
                self.plugin.full_tick_sharded(
                    body.get("devices"), body.get("shape")
                ),
            )
        elif h.path == "/v1/reserve":
            pod = self._resolve_pod(body)
            status = self.plugin.reserve(pod)
            h._send(200, {"code": status.code.value, "reasons": list(status.reasons)})
        elif h.path == "/v1/unreserve":
            pod = self._resolve_pod(body)
            self.plugin.unreserve(pod)
            h._send(200, {"code": "Success"})
        elif h.path == "/v1/bind":
            namespace, _, name = body["podKey"].partition("/")
            with self._pod_write_lock:
                pod = self.store.get_pod(namespace, name)
                # replace status as a fresh object: dataclasses.replace is
                # shallow and mutating pod.status in place would alias the
                # store's live object outside its lock
                bound = replace(
                    pod,
                    spec=replace(pod.spec, node_name=body.get("nodeName", "node-1")),
                    status=replace(pod.status, phase="Running"),
                )
                self.store.update_pod(bound)
            h._send(200, {"bound": pod.key})
        else:
            h._send(404, {"error": f"unknown path {h.path}"})

    def _delete(self, h) -> None:
        if self.plugin is None:
            h._send(503, {"error": "standby replica; not serving yet"})
            return
        if self.replica_gate is not None:
            self._forward_to_owner(h, "DELETE", None)
            return
        if self.remote:
            h._send(409, {"error": self._REMOTE_REFUSAL})
            return
        parts = h.path.strip("/").split("/")
        if len(parts) < 3 or parts[0] != "v1" or parts[1] != "objects":
            h._send(404, {"error": f"unknown path {h.path}"})
            return
        kind = parts[2]
        key = "/".join(parts[3:])
        if kind == "pods":
            namespace, _, name = key.partition("/")
            self.clientset.core_v1().pods(namespace).delete(name)
        elif kind == "throttles":
            namespace, _, name = key.partition("/")
            self.clientset.schedule_v1alpha1().throttles(namespace).delete(name)
        elif kind == "clusterthrottles":
            self.clientset.schedule_v1alpha1().cluster_throttles().delete(key)
        else:
            h._send(404, {"error": f"unknown kind {kind}"})
            return
        h._send(200, {"deleted": f"{kind}/{key}"})

    # ------------------------------------------------------------ lifecycle

    def set_plugin(self, plugin: KubeThrottler) -> None:
        """Promotion flip: a standby server starts answering the full
        surface. Plain attribute rebinds — handler threads read them per
        request, and each is atomic in CPython (a request races only into
        seeing the old 503-standby behaviour, never a torn state)."""
        self.plugin = plugin
        self.store = plugin.store
        self.clientset = plugin.clientset
        self.listers = plugin.listers
        if self.metrics_registry is None:
            self.metrics_registry = plugin.metrics_registry

    def mark_draining(self) -> None:
        """Flip /readyz to 503 (graceful shutdown step 1) while keeping the
        server up: in-flight and stray requests still get answers during
        the drain window, but probes stop routing new traffic here."""
        self._draining = True

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()  # release the listening socket fd
        if self._thread:
            self._thread.join(timeout=2)
