"""Simulated kube-apiserver speaking the list+watch wire protocol over real
HTTP — the integration-tier fixture SURVEY §4 calls for (the reference's
weakest point is its hard dependency on a kind cluster,
Makefile:130-142; this in-process server lets the same scenarios run
deterministically and at 100k-object scale).

Backed by a :class:`~kube_throttler_tpu_torch.engine.store.Store`: tests (or a
driver process) mutate ``server.store`` and every watch connection streams
the resulting events exactly like a real apiserver:

- ``GET <collection>`` → a List document with per-item and list-level
  ``metadata.resourceVersion``;
- ``GET <collection>?watch=true&resourceVersion=N`` → chunked stream of
  ``{"type": ..., "object": ...}`` lines, replaying retained events with
  rv > N first, then live events; BOOKMARK events are emitted on idle so
  clients can advance their resume point (and detect dead streams);
- a resume point older than the retained per-kind event log → a 410-coded
  ERROR event (client-go relists on it; so does our Reflector);
- ``PUT .../status`` → optimistic-concurrency status update (stale
  ``metadata.resourceVersion`` → 409), mirroring the status subresource.

The event-log bound (``log_size``) is deliberately small-able so tests can
force the 410→relist path.

Server-side fault verbs: assigning a :class:`~..faults.FaultPlan` to
``server.faults`` lets integration tests script outages the CLIENT cannot
distinguish from real ones — sites ``mock.list`` (500 / 410 / stall),
``mock.watch.cut`` (stream severed mid-flight), ``mock.watch.gone``
(410 ERROR event mid-stream), ``mock.status.conflict`` (forced 409),
``mock.status.error`` (500 on a status PUT), ``mock.status.delay`` (a
status PUT stalls for the rule's delay) and ``mock.lease`` (lease
endpoint 500s/409s/stalls — leader-election chaos). This is the other half
of the fault matrix: client-side injection (transport.py) exercises our
error handling; server-side verbs exercise the full wire round trip through
real sockets.

HA fencing: writes may carry an ``X-Kube-Throttler-Epoch`` header
(engine/replication.py). The server tracks the highest epoch presented and
409s (reason ``FencedEpoch``) any write from a lower one — the wire half of
split-brain prevention: a paused-then-resumed deposed leader's status and
lease writes bounce without touching state.
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..utils.lockorder import guard_attrs, make_lock
from ..api.serialization import (
    cluster_throttle_from_dict,
    object_to_dict,
    throttle_from_dict,
)
from ..engine.store import Event, EventType, NotFoundError, Store, key_of
from .transport import COLLECTION_PATHS, GROUP, LIST_KINDS, VERSION

_EVENT_TYPES = {
    EventType.ADDED: "ADDED",
    EventType.MODIFIED: "MODIFIED",
    EventType.DELETED: "DELETED",
}

_STATUS_RE = re.compile(
    rf"^/apis/{re.escape(GROUP)}/{re.escape(VERSION)}/"
    rf"(?:namespaces/(?P<ns>[^/]+)/throttles|clusterthrottles)"
    rf"/(?P<name>[^/]+)/status$"
)

_LEASE_RE = re.compile(
    r"^/apis/coordination\.k8s\.io/v1/namespaces/(?P<ns>[^/]+)/leases/(?P<name>[^/]+)$"
)
_LEASE_COLLECTION_RE = re.compile(
    r"^/apis/coordination\.k8s\.io/v1/namespaces/(?P<ns>[^/]+)/leases$"
)
_EVENTS_RE = re.compile(
    r"^/api/v1/namespaces/(?P<ns>[^/]+)/events(?:/(?P<name>[^/]+))?$"
)


@guard_attrs
class MockApiServer:
    """In-process apiserver double. ``start()`` binds an ephemeral port;
    ``server.url`` is the client-facing base URL."""

    # event logs, watch fan-out lists, lease/event docs, and continue
    # tokens are touched from every handler thread — all under the one
    # server lock. (self.store has its own lock; the two nest
    # store-inside-server only at the consistent-snapshot sites.)
    GUARDED_BY = {
        "_logs": "self._lock",
        "_dropped_rv": "self._lock",
        "_watchers": "self._lock",
        "_leases": "self._lock",
        "_lease_rv": "self._lock",
        "_events": "self._lock",
        "_continues": "self._lock",
        "_fencing_epoch": "self._lock",
        "stale_epoch_rejected": "self._lock",
    }

    def __init__(
        self,
        store: Optional[Store] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        log_size: int = 4096,
        bookmark_interval: float = 0.2,
        token: str = "",
    ):
        self.store = store or Store()
        self.host = host
        self._port = port
        self.token = token
        self.bookmark_interval = bookmark_interval
        self._lock = make_lock("mockserver")
        # per-kind bounded event log: deque of (rv, type_str, obj_dict)
        self._logs: Dict[str, deque] = {
            kind: deque(maxlen=log_size) for kind in COLLECTION_PATHS
        }
        # max rv ever evicted from each log — watches must 410 below it
        self._dropped_rv: Dict[str, int] = {kind: 0 for kind in COLLECTION_PATHS}
        # live watch subscriptions: kind -> list of Queues
        self._watchers: Dict[str, List[Queue]] = {
            kind: [] for kind in COLLECTION_PATHS
        }
        self._shutdown = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # serving generation: bumped by every start(); zombie watch loops
        # from a previous incarnation compare their captured generation and
        # exit instead of streaming from a "restarted" server (a real
        # apiserver restart severs every stream)
        self._generation = 0
        # coordination.k8s.io Lease objects (leader election): (ns, name) →
        # (doc, rv); versioned off their own counter under self._lock
        self._leases: Dict[Tuple[str, str], Tuple[Dict[str, Any], int]] = {}
        self._lease_rv = 0
        # v1 Events (Warning emission from remote daemons): (ns, name) → doc
        self._events: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # paginated-LIST continue tokens: token → (remaining items, list rv,
        # deadline). The real apiserver serves continue reads from the
        # snapshot the first page was cut at; the mock holds the remainder
        # server-side, TTL'd + capped so abandoned paginations can't leak
        # snapshots for the server's lifetime (this class also backs the
        # standalone daemon's wire mode, not just tests).
        self._continues: Dict[str, Tuple[List[Dict[str, Any]], int, float]] = {}
        self.continue_ttl = 300.0  # ≈ the apiserver's etcd compaction window
        self._continue_cap = 64
        # observability for tests: largest single LIST response (items)
        self.max_list_page_items = 0
        self.list_requests = 0
        # server-side fault verbs: a FaultPlan scripted by tests (see module
        # docstring); None = no injection
        self.faults = None
        # HA fencing (engine/replication.py): the highest epoch any writer
        # has presented via the X-Kube-Throttler-Epoch header. A write
        # carrying a LOWER epoch is a paused-then-resumed deposed leader —
        # rejected 409 with reason FencedEpoch and counted, exactly what
        # the real apiserver's resourceVersion + Lease machinery achieves
        # for the reference's embedded scheduler. Writes with no header
        # pass (non-HA clients are unaffected).
        self._fencing_epoch = 0
        self.stale_epoch_rejected = 0
        for kind in COLLECTION_PATHS:
            self.store.add_event_handler(kind, self._make_recorder(kind), replay=False)

    # -- event capture -----------------------------------------------------

    def _obj_dict(self, kind: str, obj, rv: int) -> Dict[str, Any]:
        doc = object_to_dict(obj)
        doc.setdefault("metadata", {})["resourceVersion"] = str(rv)
        return doc

    def _make_recorder(self, kind: str):
        def record(event: Event) -> None:
            # the event carries its own rv (batched dispatch runs after the
            # whole batch mutated, so latest_resource_version would report
            # the batch's LAST version for every event); events from older
            # dispatch paths without one fall back to the live counter
            rv = event.rv
            if rv is None:  # pragma: no cover — all store paths stamp rv now
                rv = self.store.latest_resource_version
            entry = (rv, _EVENT_TYPES[event.type], self._obj_dict(kind, event.obj, rv))
            with self._lock:
                log = self._logs[kind]
                if log.maxlen is not None and len(log) == log.maxlen and log:
                    self._dropped_rv[kind] = max(self._dropped_rv[kind], log[0][0])
                log.append(entry)
                for q in self._watchers[kind]:
                    q.put(entry)

        return record

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # response headers and body go out as separate sends; with
            # Nagle on, keep-alive clients wait out a ~40ms delayed ACK
            # per request (measured) — the real apiserver serves with
            # TCP_NODELAY too (Go net/http default)
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send_json(self, code: int, doc: Dict[str, Any]) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if not server.token:
                    return True
                if self.headers.get("Authorization") == f"Bearer {server.token}":
                    return True
                self._send_json(401, {"message": "unauthorized"})
                return False

            def _json_body(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    return json.loads(self.rfile.read(length)) if length else {}
                except json.JSONDecodeError:
                    self._send_json(400, {"message": "invalid JSON"})
                    return None

            def do_GET(self):
                if not self._authorized():
                    return
                split = urlsplit(self.path)
                query = parse_qs(split.query)
                if _LEASE_RE.match(split.path):
                    server._serve_lease(self, "GET", split.path, None)
                    return
                kind = next(
                    (k for k, p in COLLECTION_PATHS.items() if p == split.path), None
                )
                if kind is None:
                    self._send_json(404, {"message": f"no route {split.path}"})
                    return
                if query.get("watch", ["false"])[0] == "true":
                    server._serve_watch(self, kind, query)
                else:
                    server._serve_list(self, kind, query)

            def do_POST(self):
                if not self._authorized():
                    return
                body = self._json_body()
                if body is None:
                    return
                path = urlsplit(self.path).path
                if _LEASE_COLLECTION_RE.match(path):
                    # create is POST to the collection, like the real
                    # apiserver; the object name comes from the body
                    server._serve_lease(self, "POST", path, body)
                elif _LEASE_RE.match(path):
                    self._send_json(
                        405, {"message": "POST to a named resource; use the collection"}
                    )
                elif _EVENTS_RE.match(path):
                    server._serve_event(self, "POST", path, body)
                else:
                    self._send_json(404, {"message": f"no route {path}"})

            def do_PUT(self):
                if not self._authorized():
                    return
                body = self._json_body()
                if body is None:
                    return
                path = urlsplit(self.path).path
                if _LEASE_RE.match(path):
                    server._serve_lease(self, "PUT", path, body)
                    return
                if _EVENTS_RE.match(path):
                    server._serve_event(self, "PUT", path, body)
                    return
                server._serve_status_put(self, self.path, body)

        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        self._httpd.daemon_threads = True
        # remember the RESOLVED port so a restart rebinds the same address
        # (clients keep their base URL across an apiserver restart)
        self._port = self._httpd.server_address[1]
        self._shutdown = threading.Event()
        self._generation += 1
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="mock-apiserver", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # -- restart semantics (scenario engine: apiserver restart) -----------

    stop_serving = stop  # alias: state survives; only the listener dies

    def reset_rv_window(self) -> int:
        """Fresh resourceVersion retention horizon, as if the restarted
        apiserver's watch cache started empty over a compacted etcd: every
        retained event log is dropped, the per-kind 410 floor jumps to the
        CURRENT store RV, and outstanding LIST continue tokens expire. A
        client re-watching from any pre-restart resume point gets the 410
        ERROR event and must relist; a mid-pagination continue read gets
        410 and falls back to an unpaginated LIST — together the
        post-restart relist storm. Returns the new 410 floor."""
        floor = self.store.latest_resource_version
        with self._lock:
            for kind in self._logs:
                self._logs[kind].clear()
                self._dropped_rv[kind] = floor
            self._continues.clear()
        return floor

    def restart(self, reset_rv_window: bool = True, downtime_s: float = 0.0) -> None:
        """Stop serving, optionally reset the RV window (the
        apiserver-restart shape: clients must relist), wait ``downtime_s``
        (connection-refused window), then serve again on the SAME port."""
        self.stop_serving()
        if reset_rv_window:
            self.reset_rv_window()
        if downtime_s > 0:
            time.sleep(downtime_s)
        self.start()

    @property
    def port(self) -> int:
        assert self._httpd is not None, "server not started"
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- endpoint implementations -----------------------------------------

    def _fault(self, site: str):
        """One fault-point check against the scripted plan (None when no
        plan is installed or the site stays quiet this hit)."""
        if self.faults is None:
            return None
        fault = self.faults.check(site)
        if fault is not None:
            fault.sleep()
        return fault

    # -- HA fencing ---------------------------------------------------------

    def _check_fencing(self, handler) -> bool:
        """Epoch gate for every write verb: a request whose
        ``X-Kube-Throttler-Epoch`` is below the highest epoch ever
        presented is a deposed leader's write — 409 (reason FencedEpoch),
        counted, and the state it targeted stays untouched. Requests
        without the header pass unexamined."""
        raw = handler.headers.get("X-Kube-Throttler-Epoch")
        if not raw:
            return True
        try:
            epoch = int(raw)
        except ValueError:
            handler._send_json(400, {"message": f"bad fencing epoch {raw!r}"})
            return False
        with self._lock:
            if epoch < self._fencing_epoch:
                self.stale_epoch_rejected += 1
                current = self._fencing_epoch
            else:
                self._fencing_epoch = epoch
                return True
        handler._send_json(
            409,
            {
                "message": f"stale fencing epoch: writer epoch {epoch} < "
                f"fenced epoch {current}",
                "reason": "FencedEpoch",
            },
        )
        return False

    @property
    def fencing_epoch(self) -> int:
        with self._lock:
            return self._fencing_epoch

    def stale_rejections(self) -> int:
        """Locked read of the stale-epoch PUT counter (GUARDED_BY; the
        harness asserts reading it bare raced the request threads —
        lockset detector, gen-3)."""
        with self._lock:
            return self.stale_epoch_rejected

    def _serve_list(self, handler, kind: str, query=None) -> None:
        fault = self._fault("mock.list")
        if fault is not None:
            if fault.mode == "gone":
                handler._send_json(
                    410, {"message": "injected: resourceVersion too old", "code": 410}
                )
                return
            if fault.mode == "error":
                handler._send_json(500, {"message": "injected apiserver error"})
                return
            # mode "delay": the sleep already happened — serve normally
        query = query or {}
        try:
            limit = int((query.get("limit") or ["0"])[0] or "0")
        except ValueError:
            limit = 0
        token = (query.get("continue") or [""])[0]
        now = time.monotonic()
        with self._lock:  # prune abandoned paginations
            for k in [k for k, (_, _, dl) in self._continues.items() if dl < now]:
                del self._continues[k]
        if token:
            with self._lock:
                entry = self._continues.pop(token, None)
            if entry is None:
                # expired/unknown continue token — the real apiserver 410s
                # and the client falls back to a full relist
                handler._send_json(
                    410, {"message": "The provided continue parameter is too old", "code": 410}
                )
                return
            items, list_rv, _ = entry
        else:
            with self.store._lock:  # consistent snapshot: items + list rv
                if kind == "Pod":
                    objs = self.store.list_pods()
                elif kind == "Namespace":
                    objs = self.store.list_namespaces()
                elif kind == "Throttle":
                    objs = self.store.list_throttles()
                else:
                    objs = self.store.list_cluster_throttles()
                items = [
                    self._obj_dict(
                        kind, o, self.store.resource_version(kind, key_of(kind, o))
                    )
                    for o in objs
                ]
                list_rv = self.store.latest_resource_version
        meta: Dict[str, Any] = {"resourceVersion": str(list_rv)}
        if limit and len(items) > limit:
            page, rest = items[:limit], items[limit:]
            next_token = uuid.uuid4().hex
            with self._lock:
                while len(self._continues) >= self._continue_cap:
                    # drop the oldest outstanding snapshot (dicts are
                    # insertion-ordered); that pagination will 410 and relist
                    del self._continues[next(iter(self._continues))]
                self._continues[next_token] = (
                    rest, list_rv, now + self.continue_ttl
                )
            meta["continue"] = next_token
            meta["remainingItemCount"] = len(rest)
        else:
            page = items
        with self._lock:
            self.list_requests += 1
            self.max_list_page_items = max(self.max_list_page_items, len(page))
        handler._send_json(
            200,
            {
                "apiVersion": "v1" if kind in ("Pod", "Namespace") else f"{GROUP}/{VERSION}",
                "kind": LIST_KINDS[kind],
                "metadata": meta,
                "items": page,
            },
        )

    def expire_continue_tokens(self) -> int:
        """Test hook: drop all outstanding continue tokens so the next
        continue read 410s (simulates the apiserver's token TTL)."""
        with self._lock:
            n = len(self._continues)
            self._continues.clear()
        return n

    def _write_watch_line(self, handler, doc: Dict[str, Any]) -> bool:
        data = json.dumps(doc).encode() + b"\n"
        try:
            handler.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            handler.wfile.flush()
            return True
        except (BrokenPipeError, ConnectionResetError, OSError):
            return False

    def _serve_watch(self, handler, kind: str, query) -> None:
        # capture THIS incarnation's shutdown event + generation: start()
        # replaces the event, so a zombie loop re-reading self._shutdown
        # after a restart would never see the stop signal
        shutdown = self._shutdown
        generation = self._generation
        since = int(query.get("resourceVersion", ["0"])[0] or "0")
        try:
            timeout_s = float(query.get("timeoutSeconds", ["0"])[0] or "0")
        except ValueError:
            timeout_s = 0.0
        deadline = (time.monotonic() + timeout_s) if timeout_s > 0 else None
        q: Queue = Queue()
        with self._lock:
            if since < self._dropped_rv[kind]:
                # compacted past the resume point → 410 ERROR event
                handler.send_response(200)
                handler.send_header("Content-Type", "application/json")
                handler.send_header("Transfer-Encoding", "chunked")
                handler.end_headers()
                self._write_watch_line(
                    handler,
                    {
                        "type": "ERROR",
                        "object": {
                            "kind": "Status",
                            "code": 410,
                            "reason": "Expired",
                            "message": f"too old resource version: {since}",
                        },
                    },
                )
                try:
                    handler.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass
                return
            replay = [e for e in self._logs[kind] if e[0] > since]
            self._watchers[kind].append(q)
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()
            last_rv = since
            for rv, etype, obj in replay:
                if not self._write_watch_line(handler, {"type": etype, "object": obj}):
                    return
                last_rv = rv
            while not shutdown.is_set() and generation == self._generation:
                if deadline is not None and time.monotonic() >= deadline:
                    break  # graceful timeoutSeconds expiry; client re-watches
                fault = self._fault("mock.watch.cut")
                if fault is not None:
                    # sever the stream abruptly: no chunked terminator, so
                    # the client sees a mid-body connection loss (the torn
                    # TCP session a crashing apiserver leaves behind).
                    # shutdown(), not just close(): the handler's
                    # rfile/wfile still hold the socket, so close() alone
                    # would defer the FIN until the keep-alive loop ends
                    # and leave the client blocked on a silent stream.
                    import socket as _socket

                    try:
                        handler.connection.shutdown(_socket.SHUT_RDWR)
                    except OSError:
                        pass
                    handler.close_connection = True
                    return
                fault = self._fault("mock.watch.gone")
                if fault is not None:
                    # mid-stream 410 ERROR event (compaction overtook the
                    # resume point while the stream was open)
                    self._write_watch_line(
                        handler,
                        {
                            "type": "ERROR",
                            "object": {
                                "kind": "Status",
                                "code": 410,
                                "reason": "Expired",
                                "message": "injected: too old resource version",
                            },
                        },
                    )
                    try:
                        handler.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        pass
                    return
                got = None
                try:
                    got = q.get(timeout=self.bookmark_interval)
                except Empty:
                    pass
                if got is not None:
                    rv, etype, obj = got
                    # batch-drain: one wfile.write for everything queued
                    # (the real apiserver's http2 frames coalesce the same
                    # way). Per-event write+flush cost one GIL round trip
                    # each — at ~1k ev/s with busy reconcile threads that
                    # queueing dominated wire-in delivery latency.
                    batch = [(rv, etype, obj)]
                    while len(batch) < 64:
                        try:
                            batch.append(q.get_nowait())
                        except Empty:
                            break
                    chunks = []
                    for rv, etype, obj in batch:
                        if rv <= last_rv:
                            continue  # already replayed
                        data = (
                            json.dumps({"type": etype, "object": obj}).encode()
                            + b"\n"
                        )
                        chunks.append(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                        last_rv = rv
                    if chunks:
                        try:
                            handler.wfile.write(b"".join(chunks))
                            handler.wfile.flush()
                        except (BrokenPipeError, ConnectionResetError, OSError):
                            return
                    continue
                # idle stream (queue empty for a bookmark interval): the
                # bookmark RV must never cover an event this watcher
                # has not been sent, or a reconnecting client resumes
                # past it and loses it forever. Read the store RV FIRST
                # (lock order is store→mock; taking mock then store
                # would deadlock against the recorder), then confirm
                # the queue is still empty under the mock lock: any
                # event recorded after the RV read is either already in
                # the queue (→ skip the bookmark) or carries a strictly
                # greater RV (→ the bookmark doesn't cover it).
                bm_rv = self.store.latest_resource_version
                with self._lock:
                    if not q.empty():
                        continue  # deliver the raced-in event first
                bookmark = {
                    "type": "BOOKMARK",
                    "object": {
                        "kind": kind,
                        "metadata": {"resourceVersion": str(bm_rv)},
                    },
                }
                if not self._write_watch_line(handler, bookmark):
                    return
            try:  # graceful stream end: chunked terminator → client sees EOF
                handler.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
        finally:
            with self._lock:
                try:
                    self._watchers[kind].remove(q)
                except ValueError:
                    pass

    def _serve_lease(
        self, handler, verb: str, path: str, body: Optional[Dict[str, Any]]
    ) -> None:
        """coordination.k8s.io Lease object: GET / POST(create) /
        PUT(update, optimistic via metadata.resourceVersion) — the three
        verbs client-go leader election needs. POST takes the collection
        path (name from body.metadata); GET/PUT take the named path.

        Fault verbs (site ``mock.lease``): mode "error" 500s any lease
        verb, "conflict" 409s a write, "delay" stalls — the leader-election
        chaos the failover e2e tests script. Writes also pass the fencing
        gate: a deposed leader's renew attempt must bounce."""
        fault = self._fault("mock.lease")
        if fault is not None:
            if fault.mode == "error":
                handler._send_json(500, {"message": "injected lease apiserver error"})
                return
            if fault.mode == "conflict" and verb in ("POST", "PUT"):
                handler._send_json(
                    409, {"message": "injected: the lease has been modified"}
                )
                return
            # mode "delay": the sleep already happened — serve normally
        if verb in ("POST", "PUT") and not self._check_fencing(handler):
            return
        if verb == "POST":
            m = _LEASE_COLLECTION_RE.match(path)
            name = str(((body or {}).get("metadata") or {}).get("name", ""))
            if not name:
                handler._send_json(400, {"message": "lease body missing metadata.name"})
                return
            key = (m.group("ns"), name)
        else:
            m = _LEASE_RE.match(path)
            key = (m.group("ns"), m.group("name"))
        with self._lock:
            existing = self._leases.get(key)
            if verb == "GET":
                if existing is None:
                    handler._send_json(404, {"message": f"lease {key} not found"})
                    return
                doc, rv = existing
                out = dict(doc)
                out["metadata"] = {**(doc.get("metadata") or {}), "resourceVersion": str(rv)}
                handler._send_json(200, out)
                return
            if verb == "POST":
                if existing is not None:
                    handler._send_json(409, {"message": f"lease {key} exists"})
                    return
                self._lease_rv += 1
                self._leases[key] = (body, self._lease_rv)
                out = dict(body)
                out["metadata"] = {
                    **(body.get("metadata") or {}),
                    "resourceVersion": str(self._lease_rv),
                }
                handler._send_json(201, out)
                return
            # PUT
            if existing is None:
                handler._send_json(404, {"message": f"lease {key} not found"})
                return
            _, current_rv = existing
            rv_raw = str((body.get("metadata") or {}).get("resourceVersion", "") or "")
            if rv_raw and rv_raw != str(current_rv):
                handler._send_json(
                    409,
                    {"message": f"lease {key}: resourceVersion conflict"},
                )
                return
            self._lease_rv += 1
            self._leases[key] = (body, self._lease_rv)
            out = dict(body)
            out["metadata"] = {
                **(body.get("metadata") or {}),
                "resourceVersion": str(self._lease_rv),
            }
            handler._send_json(200, out)

    def _serve_event(
        self, handler, verb: str, path: str, body: Dict[str, Any]
    ) -> None:
        """v1 Events: POST to the collection creates (409 if the name
        exists, like the real apiserver); PUT to the named path replaces
        (the recorder's count-bump). Tests read via the in-process
        ``events_in`` accessor — there is no GET route."""
        m = _EVENTS_RE.match(path)
        ns = m.group("ns")
        if verb == "POST":
            name = str(((body or {}).get("metadata") or {}).get("name", ""))
            if not name:
                handler._send_json(400, {"message": "event missing metadata.name"})
                return
            with self._lock:
                if (ns, name) in self._events:
                    handler._send_json(409, {"message": f"event {ns}/{name} exists"})
                    return
                self._events[(ns, name)] = body
            handler._send_json(201, body)
            return
        # PUT named
        name = m.group("name") or ""
        with self._lock:
            if (ns, name) not in self._events:
                handler._send_json(404, {"message": f"event {ns}/{name} not found"})
                return
            self._events[(ns, name)] = body
        handler._send_json(200, body)

    def events_in(self, namespace: str):
        """Test accessor: the Event docs posted for a namespace."""
        with self._lock:
            return [doc for (ns, _), doc in self._events.items() if ns == namespace]

    def _serve_status_put(self, handler, path: str, body: Dict[str, Any]) -> None:
        m = _STATUS_RE.match(urlsplit(path).path)
        if m is None:
            handler._send_json(404, {"message": f"no route {path}"})
            return
        if not self._check_fencing(handler):
            return  # deposed leader: the status write never touches state
        fault = self._fault("mock.status.conflict")
        if fault is not None:
            handler._send_json(
                409, {"message": "injected: the object has been modified"}
            )
            return
        fault = self._fault("mock.status.error")
        if fault is not None:
            handler._send_json(500, {"message": "injected apiserver error"})
            return
        # mock.status.delay: the _fault helper already slept the rule's
        # delay — the PUT then serves normally (publication slowdown, the
        # scenario engine's injected-regression knob)
        self._fault("mock.status.delay")
        kind = "Throttle" if m.group("ns") else "ClusterThrottle"
        rv_raw = str((body.get("metadata") or {}).get("resourceVersion", "") or "")
        try:
            if kind == "Throttle":
                obj = throttle_from_dict(body)
                key = f"{obj.namespace}/{obj.name}"
            else:
                obj = cluster_throttle_from_dict(body)
                key = obj.name
            try:
                rv_wanted = int(rv_raw) if rv_raw else None
            except ValueError:
                handler._send_json(400, {"message": f"bad resourceVersion {rv_raw!r}"})
                return
            with self.store._lock:  # version check + write atomically
                current_rv = self.store.resource_version(kind, key)
                if rv_wanted is not None and rv_wanted != current_rv:
                    handler._send_json(
                        409,
                        {
                            "message": f"Operation cannot be fulfilled on {kind} "
                            f"{key!r}: the object has been modified",
                        },
                    )
                    return
                if kind == "Throttle":
                    updated = self.store.update_throttle_status(obj)
                else:
                    updated = self.store.update_cluster_throttle_status(obj)
                new_rv = self.store.resource_version(kind, key)
            handler._send_json(200, self._obj_dict(kind, updated, new_rv))
        except NotFoundError:
            handler._send_json(404, {"message": f"{kind} {path} not found"})
        except KeyError:
            handler._send_json(404, {"message": f"{kind} {path} not found"})
