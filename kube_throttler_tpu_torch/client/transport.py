"""Kubernetes apiserver wire transport: list+watch reflectors feeding the
local :class:`~kube_throttler_tpu.engine.store.Store`, plus a remote status
writer — the analog of the reference's client-go stack
(plugin.go:71-130: ``clientcmd.BuildConfigFromFlags(kubeconfig)`` →
clientset + SharedInformerFactory → WaitForCacheSync).

Design: the in-process ``Store`` stays the single informer-cache the whole
daemon reads (device mirror, informers/listers, controllers). In remote
mode a :class:`Reflector` per kind keeps that cache synced with a real
apiserver over the list+watch wire protocol:

- LIST once, diff against the cache (synthesizing ADDED/MODIFIED/DELETED so
  downstream handlers observe a consistent stream), remember the list
  resourceVersion;
- WATCH from that resourceVersion with ``allowWatchBookmarks``; BOOKMARK
  events advance the resume point without touching the cache
  (client-go reflector.go semantics);
- a closed/timed-out stream re-watches from the last seen resourceVersion;
  ``410 Gone`` (resourceVersion too old) falls back to a full relist —
  exactly client-go's ListAndWatch loop.

Status write-back goes straight to the apiserver (UpdateStatus,
throttle_controller.go:170); the local cache is NOT updated in place — the
write echoes back through the watch, which is the reference's
update-then-observe loop (§3.4 of SURVEY.md). Conflicts (409) surface as
:class:`~kube_throttler_tpu.engine.store.ConflictError` so the reconcile
requeues rate-limited, like client-go retry-on-conflict.

Only stdlib (http.client/json/ssl) — no kubernetes python client exists in
this environment, and the wire protocol is small enough to speak directly.
"""

from __future__ import annotations

import json
import logging
import os
import random
import socket
import ssl
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from http.client import HTTPConnection, HTTPException, HTTPSConnection
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple
from urllib.parse import urlencode, urlsplit

from ..api.serialization import (
    API_GROUP as GROUP,
    VERSION,
    object_from_dict,
    object_to_dict,
)
from ..api.types import ClusterThrottle, Throttle
from ..engine.store import ConflictError, NotFoundError, Store, key_of
from ..utils.lockorder import make_lock

logger = logging.getLogger(__name__)

# collection paths per kind (cluster-wide list+watch, like the reference's
# cluster-scoped informer factories)
COLLECTION_PATHS = {
    "Pod": "/api/v1/pods",
    "Namespace": "/api/v1/namespaces",
    "Throttle": f"/apis/{GROUP}/{VERSION}/throttles",
    "ClusterThrottle": f"/apis/{GROUP}/{VERSION}/clusterthrottles",
}

LIST_KINDS = {
    "Pod": "PodList",
    "Namespace": "NamespaceList",
    "Throttle": "ThrottleList",
    "ClusterThrottle": "ClusterThrottleList",
}


class ApiError(Exception):
    def __init__(self, status: int, message: str = ""):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class GoneError(ApiError):
    """410: the requested resourceVersion is no longer retained — relist."""

    def __init__(self, message: str = "resourceVersion too old"):
        super().__init__(410, message)


class FencedError(ApiError):
    """409 with reason ``FencedEpoch``: this writer's fencing epoch is
    stale — a newer leader has taken over (engine/replication.py). Unlike
    an ordinary optimistic-concurrency 409, this is TERMINAL for the
    writer: retrying can never succeed, and continuing to serve would be
    split brain. Callers fence themselves and stop."""

    def __init__(self, message: str = "stale fencing epoch"):
        super().__init__(409, message)


@dataclass(frozen=True)
class RestConfig:
    """The slice of a kubeconfig the transport needs (the analog of
    clientcmd's rest.Config)."""

    server: str
    token: str = ""
    verify_tls: bool = True
    ca_file: str = ""
    cert_file: str = ""  # client certificate (mTLS auth)
    key_file: str = ""
    # bearer token re-read from disk per request (mtime-cached): in-cluster
    # BoundServiceAccountTokens rotate ~hourly and a static string would
    # expire mid-run (client-go re-reads the mount the same way)
    token_file: str = ""


# decoded kubeconfig credential material: memfd-backed on Linux (never
# touches disk, gone with the process no matter how it dies); tempfile
# fallback elsewhere, cleaned at interpreter exit (best-effort — atexit
# does not run on SIGKILL, which is the memfd path's whole point)
_credential_fds: List[int] = []  # keep memfds alive for the process
_materialized_credentials: List[str] = []


def _cleanup_materialized() -> None:
    for path in _materialized_credentials:
        try:
            os.unlink(path)
        except OSError:
            pass
    _materialized_credentials.clear()


def _inline_or_file(data_b64: str, file_path: str, suffix: str) -> str:
    """kubeconfigs carry credentials either as file paths or inline base64
    ``*-data`` fields; the ssl module only takes paths, so inline data is
    materialized — into an anonymous memfd exposed via /proc/self/fd on
    Linux (a path that works in-process and can never outlive it), or a
    0600 temp file with atexit cleanup as the portable fallback."""
    if not data_b64:
        return file_path
    import base64

    raw = base64.b64decode(data_b64)
    if hasattr(os, "memfd_create"):
        try:
            fd = os.memfd_create(f"kubeconfig{suffix}")
            os.write(fd, raw)
            _credential_fds.append(fd)  # must stay open for the path to resolve
            return f"/proc/self/fd/{fd}"
        except OSError:
            pass  # fall through to the tempfile path
    import atexit
    import tempfile

    fd, tmp = tempfile.mkstemp(suffix=suffix)
    with os.fdopen(fd, "wb") as f:
        f.write(raw)
    if not _materialized_credentials:
        atexit.register(_cleanup_materialized)
    _materialized_credentials.append(tmp)
    return tmp


def parse_kubeconfig(path: str) -> RestConfig:
    """Minimal kubeconfig loader: current-context → cluster server + user
    credentials. Supports bearer tokens AND client certificates (both as
    file paths and inline ``*-data`` base64); exec/auth-provider plugins
    are not supported."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}

    def by_name(items, name):
        for item in items or []:
            if item.get("name") == name:
                return item
        raise ValueError(f"kubeconfig: no entry named {name!r}")

    current = cfg.get("current-context") or ""
    if not current:
        contexts = cfg.get("contexts") or []
        if not contexts:
            raise ValueError("kubeconfig: no contexts")
        current = contexts[0]["name"]
    ctx = by_name(cfg.get("contexts"), current).get("context", {})
    cluster = by_name(cfg.get("clusters"), ctx.get("cluster", "")).get("cluster", {})
    user: Dict[str, Any] = {}
    if ctx.get("user"):
        user = by_name(cfg.get("users"), ctx["user"]).get("user", {}) or {}
    return RestConfig(
        server=str(cluster.get("server", "")).rstrip("/"),
        token=str(user.get("token", "") or ""),
        verify_tls=not bool(cluster.get("insecure-skip-tls-verify")),
        ca_file=_inline_or_file(
            str(cluster.get("certificate-authority-data", "") or ""),
            str(cluster.get("certificate-authority", "") or ""),
            ".ca.crt",
        ),
        cert_file=_inline_or_file(
            str(user.get("client-certificate-data", "") or ""),
            str(user.get("client-certificate", "") or ""),
            ".client.crt",
        ),
        key_file=_inline_or_file(
            str(user.get("client-key-data", "") or ""),
            str(user.get("client-key", "") or ""),
            ".client.key",
        ),
    )


_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def in_cluster_config(sa_dir: str = _SA_DIR) -> RestConfig:
    """rest.InClusterConfig analog: apiserver address from the
    ``KUBERNETES_SERVICE_{HOST,PORT}`` env the kubelet injects, bearer
    token + CA from the ServiceAccount mount. The reference reaches this
    via ``BuildConfigFromFlags("")`` when no kubeconfig is configured
    (plugin.go:71 → clientcmd fallback)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host:
        raise ValueError(
            "not running in-cluster: KUBERNETES_SERVICE_HOST is unset"
        )
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"  # IPv6 service host
    token_file = os.path.join(sa_dir, "token")
    ca_file = os.path.join(sa_dir, "ca.crt")
    if not os.path.exists(token_file):
        raise ValueError(f"in-cluster token missing at {token_file}")
    if not os.path.exists(ca_file):
        # never downgrade to an unverified connection while still sending
        # the bearer token: warn and verify against system roots instead
        # (client-go's ICC behavior for a partial SA mount)
        logger.warning(
            "in-cluster ca.crt missing at %s; verifying against system roots",
            ca_file,
        )
        ca_file = ""
    return RestConfig(
        server=f"https://{host}:{port}",
        token_file=token_file,
        ca_file=ca_file,
        verify_tls=True,
    )


class Backoff:
    """Jittered exponential backoff with a cap and reset-on-success — the
    client-go wait.Backoff analog the reflector loop uses instead of its
    former fixed 1.0s sleep (a thundering-herd and a 30×-too-slow recovery
    at the same time).

    ``next()`` returns ``base * factor^n`` capped at ``cap``, with the top
    half jittered (half-fixed/half-random, the "equal jitter" scheme): under
    a mass disconnect N reflectors spread over [d/2, d] instead of stamping
    the apiserver in lockstep. ``reset()`` (on a healthy stream) snaps the
    next delay back to ``base``."""

    def __init__(
        self,
        base: float = 1.0,
        cap: float = 30.0,
        factor: float = 2.0,
        rng: Optional[random.Random] = None,
    ):
        self.base = max(0.001, float(base))
        self.cap = float(cap)
        self.factor = float(factor)
        self._rng = rng or random.Random()
        self._attempts = 0  #: guarded-by: self._lock
        self._lock = make_lock("transport.backoff")

    @property
    def attempts(self) -> int:
        return self._attempts

    def next(self) -> float:
        with self._lock:
            raw = min(self.cap, self.base * (self.factor**self._attempts))
            self._attempts += 1
        return raw / 2 + self._rng.random() * (raw / 2)

    def reset(self) -> None:
        with self._lock:
            self._attempts = 0


class _TokenBucket:
    """Client-side write rate limiter — the analog of client-go's
    rest.Config QPS/Burst that the reference's generated clientset
    inherits (flowcontrol token bucket behind every request). Blocking
    ``take`` is the back-pressure: the status-writer thread slows down
    instead of flooding the apiserver."""

    def __init__(self, qps: float, burst: int):
        if qps <= 0 or burst < 1:
            # ValueError, not assert: reachable from CLI flags, and under
            # python -O a stripped assert would build a bucket whose take()
            # blocks forever (refill capped at burst=0)
            raise ValueError(f"qps must be > 0 and burst >= 1 (got {qps}, {burst})")
        self.qps = float(qps)
        self.burst = float(burst)
        self._tokens = float(burst)  #: guarded-by: self._lock
        self._stamp = time.monotonic()  #: guarded-by: self._lock
        self._lock = make_lock("transport.tokenbucket")

    def take(self) -> None:
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._stamp) * self.qps
                )
                self._stamp = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)


class ApiClient:
    """Blocking REST client for the four watched kinds + status subresource.

    One short-lived connection per request; ``watch`` holds a streaming
    connection and yields decoded watch events.

    Mutating verbs (POST/PUT) pass a client-side token bucket
    (``qps``/``burst``), mirroring client-go's rest.Config rate limiting
    that the reference inherits (plugin.go:71 BuildConfigFromFlags →
    default 5 QPS / 10 burst). The defaults here are the kube-scheduler's
    clientConnection values (50/100): the streaming status pipeline
    sustains ~1k coalesced writes/sec against the in-memory store, and a
    5-QPS ceiling would make the remote mode's write lag pathological.
    Reads are not limited — they are a handful of long-lived watches.
    ``qps=None`` disables limiting (in-process/mock servers)."""

    def __init__(
        self,
        config: RestConfig,
        timeout: float = 10.0,
        qps: Optional[float] = 50.0,
        burst: int = 100,
        page_size: Optional[int] = None,
        faults=None,
        epoch_provider: Optional[Callable[[], Optional[int]]] = None,
    ):
        self.config = config
        self.timeout = timeout
        # optional FaultPlan (faults/plan.py): deterministic client-side
        # failure injection — connection resets, 409/410 storms, stalled
        # watch reads — for chaos tests. None in production.
        self.faults = faults
        # HA fencing (engine/replication.py): when set, every request
        # carries X-Kube-Throttler-Epoch so a fenced server can reject a
        # deposed leader's writes (FencedError). None for non-HA clients.
        self.epoch_provider = epoch_provider
        self.page_size = (
            self.DEFAULT_PAGE_SIZE if page_size is None else max(0, page_size)
        )
        self._write_bucket = _TokenBucket(qps, burst) if qps else None
        split = urlsplit(config.server)
        if split.scheme not in ("http", "https"):
            raise ValueError(f"unsupported server scheme: {config.server!r}")
        self._scheme = split.scheme
        self._host = split.hostname or "127.0.0.1"
        self._port = split.port or (443 if self._scheme == "https" else 80)
        # SSLContext cached per credential-file mtimes: re-parsing PEMs per
        # request would burden the status-write hot path, but a fully
        # static context would hold expired certs across on-disk rotation
        # (kubeadm renewal) for the process lifetime — a cheap stat per
        # connect picks up rotated files and rebuilds only then
        self._ssl_ctx = None
        self._ssl_ctx_stamp = None
        self._token_cache: Optional[Tuple[int, str]] = None
        self._conn_local = threading.local()  # keep-alive conn per thread
        if self._scheme == "https":
            self._ssl_ctx = self._build_ssl_ctx()

    def _cred_stamp(self):
        def mtime(path):
            try:
                return os.stat(path).st_mtime_ns
            except OSError:
                return None

        cfg = self.config
        return tuple(mtime(p) for p in (cfg.ca_file, cfg.cert_file, cfg.key_file) if p)

    def _build_ssl_ctx(self):
        cfg = self.config
        if cfg.verify_tls:
            ctx = ssl.create_default_context(cafile=cfg.ca_file or None)
        else:
            ctx = ssl._create_unverified_context()
        if cfg.cert_file:
            # mTLS client auth (kubeconfig client-certificate/key)
            ctx.load_cert_chain(cfg.cert_file, cfg.key_file or None)
        self._ssl_ctx_stamp = self._cred_stamp()
        return ctx

    # -- connection plumbing ----------------------------------------------

    def _connect(self, timeout: float):
        if self._scheme == "https":
            if self._ssl_ctx_stamp != self._cred_stamp():
                self._ssl_ctx = self._build_ssl_ctx()  # credentials rotated
            conn = HTTPSConnection(
                self._host, self._port, timeout=timeout, context=self._ssl_ctx
            )
        else:
            conn = HTTPConnection(self._host, self._port, timeout=timeout)
        # http.client writes headers and body as separate sends; with Nagle
        # on, the body segment waits out the peer's delayed ACK (~40ms per
        # request on a reused keep-alive connection — measured). client-go
        # disables Nagle the same way (net/http DisableKeepAlives=false +
        # TCP_NODELAY default in Go's net.TCPConn).
        conn.connect()
        try:
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except (OSError, AttributeError):
            pass  # non-TCP transports (tests with mocks) have no sockopt
        # the credential stamp THIS connection handshaked under: rotation
        # checks must be per-connection, not against the shared context
        # stamp (another thread's reconnect refreshes that, which would
        # let a stale-credential connection pass the check forever)
        conn._kt_cred_stamp = self._cred_stamp()
        return conn

    def _headers(self) -> Dict[str, str]:
        headers = {"Accept": "application/json"}
        token = self.config.token
        if self.config.token_file:
            token = self._file_token() or token
        if token:
            headers["Authorization"] = f"Bearer {token}"
        if self.epoch_provider is not None:
            epoch = self.epoch_provider()
            if epoch:
                headers["X-Kube-Throttler-Epoch"] = str(epoch)
        return headers

    def _file_token(self) -> str:
        """Token from ``token_file``, re-read on mtime change (rotating
        ServiceAccount mounts)."""
        path = self.config.token_file
        try:
            stamp = os.stat(path).st_mtime_ns
        except OSError:
            return self._token_cache[1] if self._token_cache else ""
        if self._token_cache is None or self._token_cache[0] != stamp:
            try:
                with open(path) as f:
                    self._token_cache = (stamp, f.read().strip())
            except OSError:
                return self._token_cache[1] if self._token_cache else ""
        return self._token_cache[1]

    def _request(
        self, method: str, path: str, body: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """One REST round trip over a per-thread KEEP-ALIVE connection.

        client-go multiplexes everything over reused connections; opening a
        fresh TCP (+TLS) connection per status PUT dominated the remote
        write path. The cached connection is retried ONCE on a fresh one
        when it fails — a reused keep-alive socket the server closed
        between requests is indistinguishable from a network error, and
        the single retry is the standard stale-socket pattern. Credential
        rotation invalidates the cache (the SSL context is stamped)."""
        if self.faults is not None:
            # a reset here is indistinguishable from a mid-request network
            # failure: callers see the same exception surface they would
            # from a dying apiserver
            self.faults.maybe_raise("transport.request", default=ConnectionResetError)
        headers = self._headers()
        payload = None
        if body is not None:
            payload = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        cached = getattr(self._conn_local, "conn", None)
        if cached is not None and self._scheme == "https":
            if getattr(cached, "_kt_cred_stamp", None) != self._cred_stamp():
                cached.close()
                cached = None  # rotated credentials: next connect rebuilds
        conn, reused = cached, cached is not None
        try:
            while True:
                if conn is None:
                    conn = self._connect(self.timeout)
                    reused = False
                try:
                    conn.request(method, path, body=payload, headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()
                    break
                except (HTTPException, OSError, ssl.SSLError) as e:
                    conn.close()
                    conn = None
                    if isinstance(e, (socket.timeout, TimeoutError)):
                        # a timeout is NOT a stale keep-alive socket: the
                        # server may still be processing the (possibly
                        # non-idempotent) request — re-sending could
                        # double-apply it and blocks up to 2× timeout
                        raise
                    if method not in ("GET", "PUT", "DELETE", "HEAD"):
                        # non-idempotent (POST: event create, lease acquire):
                        # a reset AFTER the server processed the request is
                        # indistinguishable from a stale socket, and a
                        # resend double-applies. Same policy as Go net/http,
                        # which only retries idempotent methods (or when no
                        # request bytes were written).
                        raise
                    if not reused:
                        raise  # a fresh connection failing is a real error
            if resp.will_close:
                conn.close()
                self._conn_local.conn = None
            else:
                self._conn_local.conn = conn
        except BaseException:
            self._conn_local.conn = None
            raise
        if resp.status == 409:
            text = data.decode(errors="replace")[:200]
            if "FencedEpoch" in text or "stale fencing epoch" in text:
                raise FencedError(text)
            raise ConflictError(path)
        if resp.status == 404:
            raise NotFoundError(path)
        if resp.status == 410:
            raise GoneError(data.decode(errors="replace")[:200])
        if resp.status >= 400:
            raise ApiError(resp.status, data.decode(errors="replace")[:200])
        return json.loads(data) if data else {}

    # -- verbs -------------------------------------------------------------

    # client-go's pager chunks relists at 500 items/page by default; at 100k
    # pods an unbounded LIST is one giant response body on a single socket
    # read (reference client layer takes ListOptions on every List/Watch —
    # throttle.go:82-103)
    DEFAULT_PAGE_SIZE = 500

    def list_pages(
        self, kind: str, page_size: Optional[int] = None
    ) -> Iterator[Tuple[List[Dict[str, Any]], str]]:
        """Chunked LIST: yield ``(page items, list resourceVersion)`` per
        page, following ``metadata.continue`` tokens until exhausted.
        ``page_size=0`` disables chunking (one unbounded page). A 410 on an
        expired continue token surfaces as :class:`GoneError` — the caller
        decides whether to fall back to an unpaginated full relist."""
        limit = self.page_size if page_size is None else page_size
        token = ""
        while True:
            params = {}
            if limit:
                params["limit"] = str(limit)
            if token:
                params["continue"] = token
            path = COLLECTION_PATHS[kind]
            if params:
                path = f"{path}?{urlencode(params)}"
            doc = self._request("GET", path)
            meta = doc.get("metadata") or {}
            yield list(doc.get("items") or []), str(meta.get("resourceVersion", "0"))
            token = str(meta.get("continue") or "")
            if not token:
                return

    def list(
        self, kind: str, page_size: Optional[int] = None
    ) -> Tuple[List[Dict[str, Any]], str]:
        """LIST a collection → (item dicts, list resourceVersion). Paginates
        internally; use :meth:`list_pages` to stream pages without
        accumulating (the reflector's relist does)."""
        items: List[Dict[str, Any]] = []
        rv = "0"
        for page, rv in self.list_pages(kind, page_size):
            items.extend(page)
        return items, rv

    # a real apiserver bookmarks roughly once a minute on a quiet cluster;
    # the server-side timeoutSeconds ends the stream gracefully well before
    # the socket read timeout would tear the connection down, so idle
    # watches are NOT reconnect churn (client-go uses 5-10 min here)
    WATCH_TIMEOUT_SECONDS = 300

    def watch(
        self,
        kind: str,
        resource_version: str,
        stop: Optional[threading.Event] = None,
        read_timeout: Optional[float] = None,
    ) -> Iterator[Dict[str, Any]]:
        """WATCH a collection from ``resource_version``; yields raw watch
        event dicts ``{"type": ..., "object": {...}}`` (BOOKMARK included —
        the reflector advances its resume point on them). The stream ends
        on server close / timeoutSeconds expiry / read timeout (caller
        re-watches from the last RV) and raises :class:`GoneError` on an
        ERROR event carrying 410."""
        if read_timeout is None:
            read_timeout = self.WATCH_TIMEOUT_SECONDS + 30.0
        if self.faults is not None:
            self.faults.maybe_raise(
                "transport.watch.open", default=lambda: ApiError(500, "injected")
            )
        query = urlencode(
            {
                "watch": "true",
                "resourceVersion": resource_version,
                "allowWatchBookmarks": "true",
                "timeoutSeconds": str(self.WATCH_TIMEOUT_SECONDS),
            }
        )
        conn = self._connect(read_timeout)
        try:
            conn.request(
                "GET", f"{COLLECTION_PATHS[kind]}?{query}", headers=self._headers()
            )
            resp = conn.getresponse()
            if resp.status == 410:
                resp.read()
                raise GoneError()
            if resp.status >= 400:
                raise ApiError(resp.status, resp.read().decode(errors="replace")[:200])
            while stop is None or not stop.is_set():
                if self.faults is not None:
                    fault = self.faults.check("transport.watch.read")
                    if fault is not None:
                        fault.sleep()  # "delay" stalls the read (slow stream)
                        if fault.mode == "close":
                            return  # stream torn down — caller re-watches
                        if fault.mode == "gone":
                            raise GoneError("injected 410")
                        if fault.mode == "error":
                            raise fault.make_error()
                try:
                    line = resp.readline()
                except (socket.timeout, TimeoutError):
                    return  # idle stream — caller resumes from last RV
                except (OSError, ssl.SSLError):
                    return  # connection torn down
                except HTTPException:
                    # chunked stream severed mid-chunk (IncompleteRead):
                    # same recovery as a torn connection — re-watch
                    return
                if not line:
                    return  # server closed the stream
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                if event.get("type") == "ERROR":
                    obj = event.get("object") or {}
                    if obj.get("code") == 410:
                        raise GoneError(str(obj.get("message", "")))
                    raise ApiError(
                        int(obj.get("code", 500)), str(obj.get("message", ""))
                    )
                yield event
        finally:
            conn.close()

    def get(self, path: str) -> Dict[str, Any]:
        """GET a JSON document; 404 raises NotFoundError."""
        return self._request("GET", path)

    def post(self, path: str, body: Dict[str, Any]) -> Dict[str, Any]:
        """POST (create) a JSON document; 409 raises ConflictError."""
        if self._write_bucket is not None:
            self._write_bucket.take()
        return self._request("POST", path, body=body)

    def put(self, path: str, body: Dict[str, Any]) -> Dict[str, Any]:
        """PUT a JSON document (status-subresource / lease writes). The body
        must carry ``metadata.resourceVersion`` for optimistic concurrency;
        409 raises ConflictError."""
        if self._write_bucket is not None:
            self._write_bucket.take()
        if self.faults is not None:
            # 409 storm: same surface as a real optimistic-concurrency loss
            self.faults.maybe_raise(
                "transport.put.conflict", default=lambda: ConflictError(path)
            )
        return self._request("PUT", path, body=body)


@dataclass
class RemoteVersions:
    """Last-seen remote resourceVersion per (kind, key) — shared between the
    reflectors (writers) and the status writer (reader), because the local
    Store assigns its own local versions and the apiserver requires the
    REMOTE one on updates.

    ``set`` is MONOTONE for numeric resourceVersions: under watch/ingest
    backlog (a relist storm, sustained overload) the echo of an OLDER
    write can arrive hundreds of ms after a PUT response already recorded
    a fresher rv — last-writer-wins would plant the stale rv and turn
    every subsequent PUT of that key into a 409, whose retry backoff then
    head-of-line blocks the committer shard (measured as persistent
    "dropping status publication after N attempts" storms in the scenario
    corpus' saturated runs). etcd resourceVersions are globally
    monotonic, so keeping the max is always the freshest truth; a
    non-numeric rv (foreign server) falls back to last-writer-wins."""

    _lock: threading.Lock = field(
        default_factory=lambda: make_lock("transport.remoteversions")
    )
    #: guarded-by: self._lock
    _versions: Dict[Tuple[str, str], str] = field(default_factory=dict)

    def set(self, kind: str, key: str, rv: str) -> None:
        with self._lock:
            cur = self._versions.get((kind, key), "")
            if cur:
                try:
                    if int(rv) < int(cur):
                        return  # late echo: never regress the freshest rv
                except ValueError:
                    pass
            self._versions[(kind, key)] = rv

    def get(self, kind: str, key: str) -> str:
        with self._lock:
            return self._versions.get((kind, key), "")

    def drop(self, kind: str, key: str) -> None:
        with self._lock:
            self._versions.pop((kind, key), None)


class ReflectorMetrics:
    """client-go reflector-metrics analog, exported through the daemon's
    /metrics registry: lists/relists, watch (re)connects, events applied,
    410 falls — the signals that tell an operator the watch path is
    healthy vs thrashing."""

    def __init__(self, registry) -> None:
        self.lists = registry.counter_vec(
            "kube_throttler_reflector_lists_total",
            "LIST operations performed per kind (first sync + 410 relists)",
            ["kind"],
        )
        self.watches = registry.counter_vec(
            "kube_throttler_reflector_watches_total",
            "WATCH streams opened per kind (reconnects included)",
            ["kind"],
        )
        self.events = registry.counter_vec(
            "kube_throttler_reflector_events_total",
            "Watch events applied to the local cache per kind (bookmarks "
            "and unknown types excluded)",
            ["kind"],
        )
        self.gone = registry.counter_vec(
            "kube_throttler_reflector_gone_total",
            "410-expired resume points per kind (forced relists)",
            ["kind"],
        )


class Reflector:
    """client-go reflector for one kind: ListAndWatch into the Store."""

    def __init__(
        self,
        client: ApiClient,
        kind: str,
        store: Store,
        versions: Optional[RemoteVersions] = None,
        backoff: float = 1.0,
        metrics: Optional[ReflectorMetrics] = None,
        backoff_cap: float = 30.0,
        backoff_rng: Optional[random.Random] = None,
        ingest_batcher=None,
    ):
        self.client = client
        self.kind = kind
        self.store = store
        # optional MicroBatchIngest (engine/ingest.py): watch events route
        # through the adaptive micro-batcher instead of per-event store
        # calls — the wire parser never waits on the store lock, and a
        # backlog group-commits. Relists FLUSH it first (a relist diffs
        # the live store; unapplied queued events would read as deletions).
        self.ingest_batcher = ingest_batcher
        self.versions = versions
        # ``backoff`` stays the BASE delay (compat kwarg); the loop now
        # walks base→cap with jitter and resets on a healthy stream instead
        # of sleeping a fixed second per failure (transport hardening)
        self.backoff = backoff
        self._backoff = Backoff(base=backoff, cap=backoff_cap, rng=backoff_rng)
        self.metrics = metrics
        self.last_resource_version = "0"
        # consecutive failed list/watch attempts since the last healthy
        # stream — the /readyz health probe reads this (0 = healthy)
        self.consecutive_failures = 0
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _count(self, counter) -> None:
        if self.metrics is not None:
            counter(self.metrics).inc({"kind": self.kind})

    # -- store application -------------------------------------------------

    def _obj_from(self, item: Dict[str, Any]):
        obj = object_from_dict({**item, "kind": self.kind})
        rv = str((item.get("metadata") or {}).get("resourceVersion", ""))
        if self.versions is not None and rv:
            self.versions.set(self.kind, key_of(self.kind, obj), rv)
        return obj

    def _upsert(self, obj) -> None:
        store = self.store
        try:
            if self.kind == "Pod":
                store.update_pod(obj)
            elif self.kind == "Namespace":
                store.update_namespace(obj)
            elif self.kind == "Throttle":
                store.update_throttle(obj)
            else:
                store.update_cluster_throttle(obj)
        except NotFoundError:
            self._create(obj)

    def _create(self, obj) -> None:
        store = self.store
        try:
            if self.kind == "Pod":
                store.create_pod(obj)
            elif self.kind == "Namespace":
                store.create_namespace(obj)
            elif self.kind == "Throttle":
                store.create_throttle(obj)
            else:
                store.create_cluster_throttle(obj)
        except ValueError:
            self._upsert(obj)  # raced: exists already

    def _delete(self, obj) -> None:
        key = key_of(self.kind, obj)
        if self.versions is not None:
            self.versions.drop(self.kind, key)
        try:
            if self.kind == "Pod":
                self.store.delete_pod(obj.namespace, obj.name)
            elif self.kind == "Namespace":
                self.store.delete_namespace(obj.name)
            elif self.kind == "Throttle":
                self.store.delete_throttle(obj.namespace, obj.name)
            else:
                self.store.delete_cluster_throttle(obj.name)
        except NotFoundError:
            pass

    def _current_keys(self) -> Dict[str, Any]:
        if self.kind == "Pod":
            objs = self.store.list_pods()
        elif self.kind == "Namespace":
            objs = self.store.list_namespaces()
        elif self.kind == "Throttle":
            objs = self.store.list_throttles()
        else:
            objs = self.store.list_cluster_throttles()
        return {key_of(self.kind, o): o for o in objs}

    def _sync_list(self, items: List[Dict[str, Any]]) -> None:
        """Reconcile the cache with a full LIST: synthesize the minimal
        ADDED/MODIFIED/DELETED set (client-go's Replace)."""
        self._sync_pages(iter([(items, self.last_resource_version)]))

    # batched relist application: one store.apply_events per this many
    # changed objects. The store lock is held once per chunk (group-commit
    # journal line batch, one informer mirror pass, one workqueue fan-out)
    # and RELEASED between chunks — so a 100k-object relist storm no longer
    # serializes the controllers' flip express drains behind one per-event
    # lock acquisition per object (relist-storm backpressure)
    RELIST_APPLY_CHUNK = 128

    def _sync_pages(
        self, pages: Iterator[Tuple[List[Dict[str, Any]], str]]
    ) -> str:
        """Streaming Replace: apply each LIST page to the cache as it
        arrives, then delete whatever the relist didn't mention. Memory
        high-water is one page of raw item dicts plus the seen-key set —
        not the whole collection — so a 100k-pod cold start never holds
        one giant response body.

        With an ingest batcher wired (the daemon's micro-batched mode) the
        changed objects land through :meth:`Store.apply_events` in bounded
        chunks instead of per-object store calls: the same batched path
        watch bursts take, with the same equivalence contract — and the
        flip express lane breathes between chunks instead of starving for
        the duration of a full relist."""
        current = self._current_keys()
        seen: set = set()
        rv = self.last_resource_version
        batched = self.ingest_batcher is not None
        chunk: List[Tuple[str, str, Any]] = []

        def flush_chunk() -> None:
            if chunk:
                self.store.apply_events(chunk)
                chunk.clear()

        for items, rv in pages:
            for item in items:
                obj = self._obj_from(item)
                key = key_of(self.kind, obj)
                seen.add(key)
                if key not in current:
                    if batched:
                        chunk.append(("upsert", self.kind, obj))
                    else:
                        self._create(obj)
                elif current[key] != obj:
                    if batched:
                        chunk.append(("upsert", self.kind, obj))
                    else:
                        self._upsert(obj)
                if len(chunk) >= self.RELIST_APPLY_CHUNK:
                    flush_chunk()
            flush_chunk()  # page boundary: never carry ops across pages
        for key, obj in current.items():
            if key not in seen:
                if batched:
                    if self.versions is not None:
                        self.versions.drop(self.kind, key)
                    chunk.append(("delete", self.kind, key))
                    if len(chunk) >= self.RELIST_APPLY_CHUNK:
                        flush_chunk()
                else:
                    self._delete(obj)
        flush_chunk()
        return rv

    def _relist(self) -> str:
        """Paginated relist; on a mid-pagination 410 (continue token
        expired server-side) fall back to ONE unpaginated full LIST, the
        same way client-go's pager does. Returns the list RV."""
        if self.ingest_batcher is not None:
            # the replace diff reads the live store; queued-but-unapplied
            # events would make current objects look deleted
            self.ingest_batcher.flush(timeout=30.0)
        self._count(lambda m: m.lists)
        try:
            return self._sync_pages(self.client.list_pages(self.kind))
        except GoneError:
            self._count(lambda m: m.gone)
            logger.info(
                "reflector %s: continue token expired mid-relist; "
                "falling back to unpaginated LIST",
                self.kind,
            )
            return self._sync_pages(self.client.list_pages(self.kind, 0))

    def _apply_event(self, event: Dict[str, Any]) -> None:
        etype = event.get("type")
        item = event.get("object") or {}
        rv = str((item.get("metadata") or {}).get("resourceVersion", ""))
        if etype == "BOOKMARK":
            if rv:
                self.last_resource_version = rv
            return
        obj = self._obj_from(item)
        if etype in ("ADDED", "MODIFIED") and self.ingest_batcher is not None:
            self.ingest_batcher.upsert(self.kind, obj)
        elif etype == "ADDED":
            self._create(obj)
        elif etype == "MODIFIED":
            self._upsert(obj)
        elif etype == "DELETED":
            if self.ingest_batcher is not None:
                if self.versions is not None:
                    self.versions.drop(self.kind, key_of(self.kind, obj))
                self.ingest_batcher.delete(self.kind, key_of(self.kind, obj))
            else:
                self._delete(obj)
        else:
            logger.warning("reflector %s: unknown watch event %r", self.kind, etype)
            return
        self._count(lambda m: m.events)  # applied to the cache (not bookmarks)
        if self._backoff.attempts or self.consecutive_failures:
            # an applied event IS the health signal: snap the retry ladder
            # back to base so the next hiccup starts cheap again
            self._backoff.reset()
            self.consecutive_failures = 0
        if rv:
            self.last_resource_version = rv

    # -- loop --------------------------------------------------------------

    def list_and_watch_once(self) -> None:
        """One LIST + one WATCH stream (until it ends). Split out for
        deterministic tests."""
        self._count(lambda m: m.watches)
        rv = self._relist()
        self.last_resource_version = rv
        self._synced.set()
        for event in self.client.watch(self.kind, rv, stop=self._stop):
            self._apply_event(event)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.last_resource_version = self._relist()
                self._synced.set()
                self._backoff.reset()  # healthy list
                self.consecutive_failures = 0
            except Exception:
                if self._stop.is_set():
                    return
                self.consecutive_failures += 1
                delay = self._backoff.next()
                logger.exception(
                    "reflector %s: list failed; backing off %.2fs", self.kind, delay
                )
                self._stop.wait(delay)
                continue
            # watch → re-watch from last RV; Gone → fall through to relist
            force_relist = False
            while not self._stop.is_set() and not force_relist:
                try:
                    self._count(lambda m: m.watches)
                    for event in self.client.watch(
                        self.kind, self.last_resource_version, stop=self._stop
                    ):
                        self._apply_event(event)
                        if self.ingest_batcher is not None and (
                            self.ingest_batcher.take_overflow(self.kind)
                        ):
                            # the bounded ingest queue shed events of OUR
                            # kind (verdict-safe pod upserts only): the
                            # cache has a gap no watch resume can close —
                            # force a relist to repair it
                            logger.warning(
                                "reflector %s: ingest overflow shed events; "
                                "forcing relist to repair the gap",
                                self.kind,
                            )
                            force_relist = True
                            break
                except GoneError:
                    self._count(lambda m: m.gone)
                    logger.info(
                        "reflector %s: resourceVersion %s gone, relisting",
                        self.kind,
                        self.last_resource_version,
                    )
                    break
                except Exception:
                    if self._stop.is_set():
                        return
                    self.consecutive_failures += 1
                    delay = self._backoff.next()
                    logger.exception(
                        "reflector %s: watch failed; backing off %.2fs",
                        self.kind, delay,
                    )
                    self._stop.wait(delay)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"reflector-{self.kind}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def wait_for_sync(self, timeout: float = 30.0) -> bool:
        return self._synced.wait(timeout)

    def health_state(self) -> str:
        """Health-component contract (health.py): ``down`` before the first
        successful list, ``degraded`` while retrying behind backoff, ``ok``
        on a healthy stream."""
        if not self._synced.is_set():
            return "down"
        if self.consecutive_failures >= 3:
            return "degraded"
        return "ok"


class RemoteStatusWriter:
    """Store-compatible status-writer facade the controllers call in remote
    mode (``update_throttle_status`` / ``update_cluster_throttle_status``):
    PUTs the status subresource with the last-seen REMOTE resourceVersion.
    The local cache is left alone — the watch echoes the write back, closing
    the reference's update-then-observe loop (§3.4)."""

    def __init__(self, client: ApiClient, versions: RemoteVersions):
        self.client = client
        self.versions = versions

    def _put(self, kind: str, obj) -> None:
        body = object_to_dict(obj)
        rv = self.versions.get(kind, key_of(kind, obj))
        if rv:
            body["metadata"]["resourceVersion"] = rv
        if isinstance(obj, Throttle):
            path = (
                f"/apis/{GROUP}/{VERSION}/namespaces/{obj.namespace}"
                f"/throttles/{obj.name}/status"
            )
        else:
            path = f"/apis/{GROUP}/{VERSION}/clusterthrottles/{obj.name}/status"
        doc = self.client.put(path, body)
        new_rv = str((doc.get("metadata") or {}).get("resourceVersion", ""))
        if new_rv:
            # remember the post-write RV so a second write racing the watch
            # echo doesn't 409 against our own update
            self.versions.set(kind, key_of(kind, obj), new_rv)

    def update_throttle_status(self, thr: Throttle, expected_version=None) -> Throttle:
        self._put("Throttle", thr)
        return thr

    def update_cluster_throttle_status(
        self, thr: ClusterThrottle, expected_version=None
    ) -> ClusterThrottle:
        self._put("ClusterThrottle", thr)
        return thr

    def refresh_version(self, kind: str, obj) -> None:
        """GET the live object and adopt its resourceVersion — the 409
        recovery read (client-go's RetryOnConflict re-read)."""
        if isinstance(obj, Throttle):
            path = (
                f"/apis/{GROUP}/{VERSION}/namespaces/{obj.namespace}"
                f"/throttles/{obj.name}"
            )
        else:
            path = f"/apis/{GROUP}/{VERSION}/clusterthrottles/{obj.name}"
        doc = self.client.get(path)
        rv = str((doc.get("metadata") or {}).get("resourceVersion", ""))
        if rv:
            self.versions.set(kind, key_of(kind, obj), rv)


class AsyncStatusCommitter:
    """Concurrent per-key-coalescing status commits for remote mode.

    The reference PUTs each status synchronously inside its reconcile
    (throttle_controller.go:157-173 UpdateStatus via the typed clientset,
    throttle.go:152-167); over a real wire that serializes the whole drain
    behind ~1ms HTTP round trips and caps the event pipeline at the
    single-connection PUT rate. This committer decouples reconcile from
    publication:

    - ``submit`` stores the NEWEST planned object per key (newest-wins: a
      hot throttle re-reconciled 10× between wire commits costs ONE PUT);
    - TWO LANES per shard: keys whose ``throttled`` flags or
      ``calculatedThreshold`` changed (flips — the only status bits that
      change admission verdicts) land in a priority lane drained before
      the value-only ``used``-refresh lane. At the all-keys-dirty
      equilibrium the refresh lane holds thousands of queued PUTs; without
      the lane split a flip waited behind all of them (measured p99
      2.3-2.8s at full scale), with it a flip waits at most one in-flight
      PUT plus the other queued flips;
    - N workers drain the key slots concurrently over their own keep-alive
      connections (ApiClient is per-thread-connection already);
    - PER-KEY ORDERING is structural, not locked: a key hashes to exactly
      one worker shard, lives in exactly ONE lane slot at a time (a flip
      submit promotes the key's pending slot; a later refresh updates that
      slot in place without demoting it), and a shard is drained by one
      worker — so two PUTs for one key can neither race nor reorder. Lane
      assignment is a scheduling hint only: what gets PUT is always the
      newest object, whichever lane it sat in;
    - 409 conflicts re-read the live resourceVersion and retry (bounded);
      transient transport errors retry with backoff; a REFRESH that fails
      while flips are queued re-stages itself (keeping its retry budget)
      so a conflict storm on the refresh lane cannot head-of-line block a
      flip; a key that exhausts retries is dropped with a counter bump —
      the controller's resync re-plans it (crash-only stance: the next
      reconcile regenerates any dropped publication from local truth).

    The daemon's serving truth (host aggregates + reservations) is local;
    the PUT is publication. Reconcile therefore proceeds (unreserve-on-
    observe, wakeups) as soon as the newest status is QUEUED — the local
    aggregate snapshot the status was computed from is already coherent —
    matching the batched local-store commit semantics rather than the
    reference's write-then-continue."""

    # per-shard lanes and the busy flags move under that shard's condition;
    # the deliberate lock-free reads (pending(), the retry path's
    # lane-pressure hints) are waived in the analyzer baseline
    GUARDED_BY = {
        "_hi_shards": "self._conds",
        "_lo_shards": "self._conds",
        "_busy": "self._conds",
    }

    def __init__(self, writer: "RemoteStatusWriter", workers: int = 4,
                 metrics_registry=None, max_retries: int = 4,
                 on_fenced: Optional[Callable[[], None]] = None):
        self._writer = writer
        self._n = max(1, int(workers))
        # HA fencing: a FencedError from a PUT is terminal — the callback
        # fires ONCE (wired to FencingEpoch.fence + the daemon stop event)
        # and the slot is dropped, never retried (retries cannot succeed
        # and would hammer the fenced apiserver)
        self.on_fenced = on_fenced
        self._fenced_fired = False
        # per-shard lanes: key → (kind, obj, event_ts|None, flip, attempts)
        self._hi_shards: list = [{} for _ in range(self._n)]
        self._lo_shards: list = [{} for _ in range(self._n)]
        self._conds = [threading.Condition() for _ in range(self._n)]
        self._busy = [False] * self._n
        self._threads: list = []
        self._stopped = False
        self._max_retries = max_retries
        self._commits = None
        self._lag = None
        if metrics_registry is not None:
            from ..metrics import StatusLagMetrics

            self._commits = metrics_registry.counter_vec(
                "kube_throttler_remote_status_commit_total",
                "remote status PUT outcomes by kind and result",
                ["kind", "result"],
            )
            self._lag = StatusLagMetrics(metrics_registry, "remote")

    # -- writer-compatible surface (status_writer duck type) --------------

    def update_throttle_status(self, thr: Throttle, expected_version=None) -> Throttle:
        self._submit("Throttle", thr, thr.key)
        return thr

    def update_cluster_throttle_status(
        self, thr: ClusterThrottle, expected_version=None
    ) -> ClusterThrottle:
        self._submit("ClusterThrottle", thr, thr.name)
        return thr

    def update_throttle_statuses(self, thrs) -> Dict[str, object]:
        return self.update_throttle_statuses_prioritized(thrs)

    def update_cluster_throttle_statuses(self, thrs) -> Dict[str, object]:
        return self.update_cluster_throttle_statuses_prioritized(thrs)

    def update_throttle_statuses_prioritized(
        self, thrs, flip_keys=frozenset(), event_ts=None
    ) -> Dict[str, object]:
        """Batch submit with lane routing: ``flip_keys`` (store keys) take
        the priority lane; ``event_ts`` ({store key: monotonic ts of the
        causing event}) feeds the flip/total lag histograms at PUT
        completion."""
        out: Dict[str, object] = {}
        ts = event_ts or {}
        for thr in thrs:
            key = thr.key
            self._submit(
                "Throttle", thr, key, flip=key in flip_keys, event_ts=ts.get(key)
            )
            out[key] = thr
        return out

    def update_cluster_throttle_statuses_prioritized(
        self, thrs, flip_keys=frozenset(), event_ts=None
    ) -> Dict[str, object]:
        out: Dict[str, object] = {}
        ts = event_ts or {}
        for thr in thrs:
            key = thr.name
            self._submit(
                "ClusterThrottle", thr, key, flip=key in flip_keys,
                event_ts=ts.get(key),
            )
            out[key] = thr
        return out

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._threads:
            return
        self._stopped = False
        for i in range(self._n):
            t = threading.Thread(
                target=self._run, args=(i,), name=f"status-commit-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self, timeout: float = 5.0) -> None:
        self.flush(timeout)
        self._stopped = True
        for cond in self._conds:
            with cond:
                cond.notify_all()
        for t in self._threads:
            t.join(timeout=1.0)
        self._threads = []

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every queued status has been PUT (or timeout).
        True when fully drained."""
        deadline = time.monotonic() + timeout
        for i, cond in enumerate(self._conds):
            with cond:
                while (
                    self._hi_shards[i] or self._lo_shards[i] or self._busy[i]
                ) and time.monotonic() < deadline:
                    cond.wait(0.05)
                if self._hi_shards[i] or self._lo_shards[i] or self._busy[i]:
                    return False
        return True

    def pending(self) -> int:
        return sum(len(s) for s in self._hi_shards) + sum(
            len(s) for s in self._lo_shards
        )

    # -- internals --------------------------------------------------------

    def _submit(
        self, kind: str, obj, key: str, flip: bool = False, event_ts=None
    ) -> None:
        i = hash(key) % self._n
        cond = self._conds[i]
        with cond:
            hi, lo = self._hi_shards[i], self._lo_shards[i]
            prev = hi.pop(key, None)
            was_hi = prev is not None
            if prev is None:
                prev = lo.pop(key, None)
            ts = event_ts
            if prev is not None and prev[2] is not None:
                # the lag sample spans from the OLDEST unpublished event:
                # coalescing must not shrink the measured staleness window
                ts = prev[2] if ts is None else min(ts, prev[2])
            # promote-never-demote while pending: the newest object carries
            # the flipped state until it is published, so the key keeps its
            # lane even when the latest submit is a value-only refresh
            is_flip = flip or (prev is not None and prev[3])
            (hi if (flip or was_hi) else lo)[key] = (kind, obj, ts, is_flip, 0)
            cond.notify_all()

    def _count(self, kind: str, result: str) -> None:
        if self._commits is not None:
            self._commits.inc({"kind": kind, "result": result})

    def _run(self, i: int) -> None:
        """Shard worker: one slot at a time, priority lane first. Taking a
        single slot per lock hold (instead of the whole shard) is what lets
        a flip submitted mid-backlog overtake queued refreshes: the lane
        check re-runs before every PUT. The lock is ~ns against the ~ms
        PUT it brackets."""
        cond = self._conds[i]
        hi, lo = self._hi_shards[i], self._lo_shards[i]
        while True:
            with cond:
                while not hi and not lo and not self._stopped:
                    cond.wait(0.2)
                if self._stopped and not hi and not lo:
                    return
                lane = hi if hi else lo
                key = next(iter(lane))  # dicts preserve insertion order
                slot = lane.pop(key)
                self._busy[i] = True
            try:
                self._put_with_retry(i, key, slot)
            finally:
                with cond:
                    self._busy[i] = False
                    cond.notify_all()  # wake flush()

    def _restage(self, i: int, key: str, slot) -> bool:
        """Put a failed refresh back at the tail of its lane so queued
        flips go first; keeps the slot's retry budget. False when a newer
        submit claimed the key meanwhile (newest-wins: this older object
        is obsolete — drop it silently)."""
        cond = self._conds[i]
        with cond:
            if key in self._hi_shards[i] or key in self._lo_shards[i]:
                return False
            lane = self._hi_shards[i] if slot[3] else self._lo_shards[i]
            lane[key] = slot
            return True

    def _put_with_retry(self, i: int, key: str, slot) -> None:
        kind, obj, ts, flip, attempts = slot
        for attempt in range(attempts, self._max_retries + 1):
            delay = min(0.01 * (2 ** attempt), 0.5)
            try:
                self._writer._put(kind, obj)
                self._count(kind, "ok")
                if self._lag is not None and ts is not None:
                    self._lag.observe(kind, time.monotonic() - ts, flip)
                return
            except NotFoundError:
                # the object was deleted while its status sat queued —
                # permanent; retrying would head-of-line block the shard
                self._count(kind, "not_found")
                return
            except FencedError:
                # a newer leader owns publication now: drop the slot, fire
                # the demotion hook once, and stop writing (split-brain
                # prevention — see engine/replication.py)
                self._count(kind, "fenced")
                if not self._fenced_fired:
                    self._fenced_fired = True
                    logger.warning(
                        "status PUT rejected by fencing (%s %s): a newer "
                        "leader has taken over — demoting",
                        kind, key_of(kind, obj),
                    )
                    if self.on_fenced is not None:
                        try:
                            self.on_fenced()
                        except Exception:
                            logger.exception("on_fenced callback failed")
                return
            except ConflictError:
                self._count(kind, "conflict")
                try:
                    self._writer.refresh_version(kind, obj)
                except Exception:
                    pass  # retry PUTs with the stale RV; bounded anyway
                if self._stopped:
                    break
                # a failing REFRESH must not head-of-line block queued
                # flips: hand the shard back with the retry budget intact
                # and let the worker drain the priority lane first
                if not flip and self._hi_shards[i]:
                    if self._restage(i, key, (kind, obj, ts, flip, attempt + 1)):
                        return
                # client-go's RetryOnConflict backs off too: under a
                # persistent conflict (two writers fighting) immediate
                # GET+PUT pairs multiply apiserver load exactly when it is
                # already contended
                time.sleep(delay)
            except Exception:
                self._count(kind, "retry")
                if self._stopped:
                    break
                if not flip and self._hi_shards[i]:
                    if self._restage(i, key, (kind, obj, ts, flip, attempt + 1)):
                        return
                time.sleep(delay)
        self._count(kind, "dropped")
        logger.warning(
            "dropping status publication for %s %s after %d attempts "
            "(resync will re-plan it)", kind, key_of(kind, obj), self._max_retries + 1
        )


class RemoteEventRecorder:
    """Event recorder that emits v1 Events to the apiserver — the
    reference's Warning events reach the cluster through the framework
    handle's recorder (plugin.go:190-201); in remote mode ours go through
    the same wire.

    Emission is ASYNCHRONOUS (the real kube recorder buffers too): eventf
    enqueues and returns — the scheduling hot path never blocks on an
    apiserver round trip, and a full queue drops the event (best-effort
    semantics, logged at debug). Identical events aggregate client-side
    into a count (the event-correlator behavior); the aggregation map is
    bounded with oldest-first eviction like RecordingEventRecorder. Event
    object names use a DETERMINISTIC content hash so count bumps keep
    landing on the same object across restarts and replicas, and created
    names are remembered so steady-state repeats cost one RPC (PUT), not a
    doomed POST + PUT."""

    def __init__(
        self,
        client: ApiClient,
        component: str = "kube-throttler",
        max_entries: int = 10_000,
        queue_size: int = 1024,
    ):
        import queue as _queue

        self.client = client
        self.component = component
        self._lock = threading.Lock()
        self._max_entries = max_entries
        self._counts: "OrderedDict[Tuple[str, str, str], int]" = OrderedDict()
        self._created: set = set()
        self._queue: "_queue.Queue" = _queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._drain, name="event-recorder", daemon=True
        )
        self._worker.start()

    @staticmethod
    def _object_name(pod_name: str, reason: str, note: str) -> str:
        import hashlib

        digest = hashlib.sha1(f"{reason}\x00{note}".encode()).hexdigest()[:10]
        return f"{pod_name}.{digest}"

    def eventf(
        self, pod_key: str, event_type: str, reason: str, action: str, note: str
    ) -> None:
        import queue as _queue

        key = (pod_key, reason, note)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            count = self._counts[key]
            self._counts.move_to_end(key)
            while len(self._counts) > self._max_entries:
                self._counts.popitem(last=False)
        try:
            self._queue.put_nowait((pod_key, event_type, reason, action, note, count))
        except _queue.Full:
            logger.debug("event queue full; dropping %s %s", pod_key, reason)

    def _drain(self) -> None:
        import queue as _queue

        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.5)
            except _queue.Empty:
                continue
            try:
                self._emit(*item)
            except Exception:
                logger.debug("event emission failed", exc_info=True)

    def _emit(
        self,
        pod_key: str,
        event_type: str,
        reason: str,
        action: str,
        note: str,
        count: int,
    ) -> None:
        namespace, _, name = pod_key.partition("/")
        obj_name = self._object_name(name, reason, note)
        body = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"namespace": namespace, "name": obj_name},
            "involvedObject": {"kind": "Pod", "namespace": namespace, "name": name},
            "type": event_type,
            "reason": reason,
            "action": action,
            "message": note,
            "count": count,
            "source": {"component": self.component},
        }
        named = f"/api/v1/namespaces/{namespace}/events/{obj_name}"
        known = (namespace, obj_name) in self._created
        try:
            if known:
                self.client.put(named, body)
                return
            self.client.post(f"/api/v1/namespaces/{namespace}/events", body)
            self._created.add((namespace, obj_name))
        except ConflictError:
            # created by a previous incarnation/replica: bump in place
            self._created.add((namespace, obj_name))
            try:
                self.client.put(named, body)
            except Exception:
                logger.debug("event update failed", exc_info=True)
        except Exception:
            logger.debug("event post failed", exc_info=True)

    def flush(self, timeout: float = 5.0) -> None:
        """Best-effort wait for queued events to emit (tests/shutdown)."""
        deadline = time.monotonic() + timeout
        while not self._queue.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def close(self) -> None:
        self.flush(timeout=1.0)
        self._stop.set()


class RemoteSession:
    """Everything the daemon needs to run against a real apiserver: four
    reflectors feeding the local Store + the remote status writer. The
    plugin-side analog of plugin.go:71-130 (build config → clients →
    informers → WaitForCacheSync)."""

    KINDS = ("Namespace", "Throttle", "ClusterThrottle", "Pod")

    def __init__(
        self,
        config: RestConfig,
        store: Store,
        metrics_registry=None,
        qps: Optional[float] = 50.0,
        burst: int = 100,
        faults=None,
        ingest_batch=None,
    ):
        self.config = config
        self.store = store
        self.client = ApiClient(config, qps=qps, burst=burst, faults=faults)
        self.versions = RemoteVersions()
        metrics = (
            ReflectorMetrics(metrics_registry) if metrics_registry is not None else None
        )
        # ``ingest_batch`` ("adaptive" or a fixed int) routes every
        # reflector's watch events through ONE shared micro-batcher
        # (engine/ingest.py) — per-event store application otherwise
        self.ingest = None
        if ingest_batch is not None:
            from ..engine.ingest import MicroBatchIngest

            self.ingest = MicroBatchIngest(
                store, batch_policy=ingest_batch, faults=faults,
                metrics_registry=metrics_registry,
            )
        self.reflectors = {
            kind: Reflector(
                self.client, kind, store, versions=self.versions, metrics=metrics,
                ingest_batcher=self.ingest,
            )
            for kind in self.KINDS
        }
        self.status_writer = RemoteStatusWriter(self.client, self.versions)
        # the committer is what controllers should use as their
        # status_writer: same duck type plus batch + coalescing + N
        # concurrent PUT workers (the raw writer stays for direct callers)
        try:
            put_workers = int(os.environ.get("KT_STATUS_PUT_WORKERS", "4"))
        except ValueError:
            put_workers = 4  # malformed override must not kill session setup
        self.status_committer = AsyncStatusCommitter(
            self.status_writer,
            workers=put_workers,
            metrics_registry=metrics_registry,
        )
        self.event_recorder = RemoteEventRecorder(self.client)

    @classmethod
    def from_kubeconfig(cls, path: str, store: Store) -> "RemoteSession":
        return cls(parse_kubeconfig(path), store)

    def start(self, sync_timeout: float = 30.0) -> None:
        """Start reflectors; namespaces first so namespaced objects land in
        existing namespaces. Blocks until every cache lists once
        (WaitForCacheSync, plugin.go:114-130)."""
        for kind in self.KINDS:
            self.reflectors[kind].start()
            if not self.reflectors[kind].wait_for_sync(sync_timeout):
                raise TimeoutError(f"reflector {kind} did not sync")
        self.status_committer.start()

    def stop(self) -> None:
        self.status_committer.stop()
        self.event_recorder.close()
        for refl in self.reflectors.values():
            refl.stop()
        if self.ingest is not None:
            self.ingest.stop()

    def register_health(self, health) -> None:
        """Expose each reflector as a /readyz component (health.Health):
        the watch path being down/degraded is exactly what an operator's
        readiness probe needs to see before blaming admission."""
        for kind, refl in self.reflectors.items():
            health.register(
                f"reflector.{kind}",
                lambda r=refl: (
                    r.health_state(),
                    {
                        "resourceVersion": r.last_resource_version,
                        "consecutiveFailures": r.consecutive_failures,
                    },
                ),
            )
