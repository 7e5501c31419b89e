"""Active/standby HA: fenced leadership epochs + journal-tail streaming.

The reference inherits HA from the embedded kube-scheduler's client-go
LeaderElector (deploy/config.yaml ``leaderElection``): replicas block on a
Lease and the apiserver is the shared state of record, so a failover is
just "the next replica starts serving the same apiserver". The standalone
daemon's state of record is its OWN store + journal (engine/journal.py),
so HA needs two more pieces, built here:

- **Fencing epochs** (:class:`FencingEpoch`): every leadership term gets a
  monotonically increasing integer, persisted in ``<data-dir>/epoch``,
  stamped into every journal batch (``EPOCH`` control lines), snapshot
  header, and outbound status write (``X-Kube-Throttler-Epoch``). Writers
  that learn they are stale — leadership lost, a write rejected by a
  fenced peer — flip the gate and every guarded write path (journal
  append, snapshot cut, remote status PUT) refuses from then on. A
  paused-then-resumed old leader therefore cannot corrupt state it no
  longer owns: its local appends are dropped and counted, and the
  mockserver/transport reject its wire writes (no split brain).

- **Warm standby** (:class:`StandbyReplicator`): bootstraps from the
  leader's newest snapshot, then continuously streams the journal tail
  over HTTP (:class:`ReplicationSource` serves ``/v1/replication/*`` —
  the wire form of the journal's ``attach(start_offset, resume_hash)``
  contract: byte offsets + prefix sha256 continuity). Streamed events are
  applied into the standby's own store — its attached journal re-journals
  them, its index/device planes follow via the normal handler fan-out —
  so at takeover the standby only fast-forwards the remaining tail, runs
  the recovery plane reconcile, bumps the epoch, and serves.

Chunk protocol (``GET /v1/replication/journal?offset=N&hash=H``):

- the source serves exactly ``[offset, accounted_position)`` — the bytes
  the journal's running ``(bytes, sha256)`` position covers, so a chunk
  always ends on a complete line (torn crash artifacts live BEYOND the
  accounted position and are never shipped);
- ``hash`` is the sha256 hexdigest of the journal prefix up to ``offset``
  as the standby last knew it; a mismatch (the leader compacted the
  journal underneath the stream) answers 409 and the standby discards
  its resume point and re-bootstraps from the leader's newest snapshot
  rather than applying bytes from a rewritten file;
- the response carries ``X-KT-End-Sha`` (prefix hash at the chunk end) so
  the standby's resume pair stays verified without re-hashing, plus
  ``X-KT-Epoch`` and ``X-KT-Position`` for fencing and lag accounting.

Crash site ``ha.replication.send`` (faults/plan.py) SIGKILLs the leader
after flushing HALF a chunk body: the standby sees a short read, discards
the partial, and re-fetches from its last verified offset — the harness
(tools/hatest.py) proves zero divergence for that artifact.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from http.client import HTTPConnection, HTTPException
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..api.serialization import object_from_dict
from ..utils.lockorder import guard_attrs, make_lock
from ..version import local_proto_version
from .journal import JournalFormatError, StoreJournal
from .snapshot import SnapshotError, find_snapshots, load_snapshot
from .store import Store

logger = logging.getLogger(__name__)

EPOCH_FILE = "epoch"
EPOCH_HEADER = "X-Kube-Throttler-Epoch"
# replication wire version stamp (version.py): every /v1/replication/*
# response carries the leader's protocol version so a skewed standby can
# refuse an incompatible major BY NAME instead of misparsing the stream
PROTO_HEADER = "X-KT-Proto-Version"


class ReplicationDiverged(Exception):
    """The standby's resume point no longer matches the leader's journal
    (compaction/rewrite under the stream) — applying further bytes would
    silently fork state; the standby must re-bootstrap instead."""


@guard_attrs
class FencingEpoch:
    """One process's view of the leadership epoch: the highest epoch it
    has observed, whether ITS writes are still fresh, and (optionally)
    durable persistence in ``<data-dir>/epoch``.

    ``bump()`` is the takeover step: highest-known + 1, persisted BEFORE
    any write carries it, so a crash right after promotion still recovers
    a strictly larger epoch than the dead leader's. ``fence()`` is the
    demotion step: once stale, every guarded writer (journal, snapshot,
    remote status committer) refuses and counts."""

    GUARDED_BY = {
        "_epoch": "self._lock",
        "_stale": "self._lock",
        "_claimed": "self._lock",
    }

    def __init__(self, data_dir: Optional[str] = None, epoch: int = 0):
        self._lock = make_lock("ha.epoch")
        self._path = os.path.join(data_dir, EPOCH_FILE) if data_dir else None
        self._epoch = int(epoch)
        self._stale = False
        # True once bump() has run: this process claimed a term of its own.
        # Only a claimant is deposed by a higher observed epoch — a standby
        # legitimately observes every new leader term while streaming and
        # must NOT fence itself out of its own journal.
        self._claimed = False
        if self._path is not None and os.path.exists(self._path):
            try:
                with open(self._path) as f:
                    self._epoch = max(self._epoch, int(f.read().strip() or 0))
            except (OSError, ValueError):
                logger.warning("unreadable epoch file %s; starting at %d",
                               self._path, self._epoch)

    def current(self) -> int:
        with self._lock:
            return self._epoch

    def is_stale(self) -> bool:
        with self._lock:
            return self._stale

    def observe(self, epoch: int) -> None:
        """Learn an epoch from the environment (snapshot header, journal
        EPOCH line, replication stream). Raises the known high-water; if a
        STRICTLY higher epoch appears while we hold a claimed term (bump()
        ran) and are not yet stale, someone else has taken over — fence
        ourselves. A process that never claimed (a streaming standby) just
        tracks the high-water: new leader terms are its normal diet."""
        epoch = int(epoch)
        with self._lock:
            if epoch > self._epoch:
                fence_now = self._claimed and not self._stale
                self._epoch = epoch
            else:
                return
        if fence_now:
            self.fence(f"observed higher epoch {epoch}")

    def bump(self) -> int:
        """Start a new leadership term: epoch := highest-known + 1,
        persisted durably, staleness cleared. Returns the new epoch."""
        with self._lock:
            self._epoch += 1
            self._stale = False
            self._claimed = True
            epoch, path = self._epoch, self._path
        if path is not None:
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                f.write(str(epoch))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        logger.info("fencing epoch bumped to %d", epoch)
        return epoch

    def fence(self, reason: str) -> None:
        """Mark this process's epoch stale — all guarded writes refuse
        from here on. Idempotent; logs once."""
        with self._lock:
            if self._stale:
                return
            self._stale = True
        logger.warning("FENCED (epoch %d is stale): %s", self.current(), reason)


# --------------------------------------------------------------------------
# leader side: the replication source + HTTP plumbing
# --------------------------------------------------------------------------


class ReplicationSource:
    """Leader-side read API over the data directory: newest snapshot blob
    + journal tail chunks with prefix-hash continuity. Stateless reads —
    safe from any HTTP handler thread."""

    MAX_CHUNK = 4 << 20  # bytes per journal response

    def __init__(
        self,
        data_dir: str,
        journal: StoreJournal,
        epoch: FencingEpoch,
        faults=None,
    ):
        self.data_dir = data_dir
        self.journal = journal
        self.epoch = epoch
        self.faults = faults
        # single-writer stats (probes/tests read them)
        self.chunks_served = 0
        self.snapshots_served = 0

    def status(self) -> Dict[str, Any]:
        offset, sha = self.journal.position()
        snaps = find_snapshots(self.data_dir)
        return {
            "epoch": self.epoch.current(),
            "journalOffset": offset,
            "journalSha256": sha,
            "snapshotSeq": snaps[0][0] if snaps else None,
        }

    def snapshot_blob(self) -> Optional[Tuple[bytes, int]]:
        """Raw bytes + seq of the newest VALID snapshot (checksum-gated:
        a torn one must not bootstrap a standby), or None when the leader
        has not cut one yet (the standby streams from offset 0 instead)."""
        for seq, path in find_snapshots(self.data_dir):
            try:
                load_snapshot(path)  # header/length/sha256 gate
            except SnapshotError as e:
                logger.warning("replication: skipping invalid snapshot %s (%s)",
                               path, e)
                continue
            with open(path, "rb") as f:
                self.snapshots_served += 1
                return f.read(), seq
        return None

    def journal_chunk(
        self, offset: int, sha_hex: str = "", want_start_sha: bool = False
    ) -> Dict[str, Any]:
        """One tail chunk past ``offset``; verifies ``sha_hex`` (prefix
        hash at ``offset``) when given. Returns {data, endOffset, endSha,
        position, epoch, startSha?}; raises :class:`ReplicationDiverged`
        on any continuity failure. The journal computes the start/end
        prefix hashes under its own lock, so a compaction racing this read
        cannot produce a hash over a rewritten file."""
        chunk = self.journal.replication_chunk(
            offset,
            max_bytes=self.MAX_CHUNK,
            want_start_sha=bool(sha_hex) or want_start_sha,
        )
        if chunk is None:
            raise ReplicationDiverged(
                f"offset {offset} beyond journal position (compacted?)"
            )
        data, end_offset, end_sha, position, start_sha = chunk
        if sha_hex and sha_hex != start_sha:
            raise ReplicationDiverged(
                f"prefix hash mismatch at offset {offset} — journal "
                "rewritten since the standby attached"
            )
        out = {
            "data": data,
            "endOffset": end_offset,
            "endSha": end_sha,
            "position": position,
            "epoch": self.epoch.current(),
        }
        if want_start_sha:
            out["startSha"] = start_sha
        self.chunks_served += 1
        return out


def handle_replication_get(handler, source: ReplicationSource, raw_path: str) -> bool:
    """Serve ``GET /v1/replication/{status,snapshot,journal}`` on a
    BaseHTTPRequestHandler. Returns False when ``raw_path`` is not a
    replication route (the caller falls through to its own routing).

    Crash site ``ha.replication.send``: flush HALF the journal chunk body,
    then SIGKILL — the torn-stream artifact the standby must survive."""
    split = urlsplit(raw_path)
    path = split.path
    if not path.startswith("/v1/replication/"):
        return False

    proto = "%d.%d" % local_proto_version()

    def send_json(code: int, doc: dict) -> None:
        body = json.dumps(doc).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.send_header(PROTO_HEADER, proto)
        handler.end_headers()
        handler.wfile.write(body)

    def send_raw(body: bytes, headers: Dict[str, str], torn: bool = False) -> None:
        handler.send_response(200)
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header("Content-Length", str(len(body)))
        handler.send_header(PROTO_HEADER, proto)
        for k, v in headers.items():
            handler.send_header(k, v)
        handler.end_headers()
        if torn:
            # half the body on the wire, then die: the standby's read
            # comes up short (IncompleteRead) and must discard the chunk
            handler.wfile.write(body[: max(1, len(body) // 2)])
            handler.wfile.flush()
            return
        handler.wfile.write(body)

    try:
        if path == "/v1/replication/status":
            send_json(200, source.status())
        elif path == "/v1/replication/snapshot":
            blob = source.snapshot_blob()
            if blob is None:
                send_json(404, {"message": "no snapshot yet; stream from 0"})
            else:
                data, seq = blob
                send_raw(
                    data,
                    {
                        EPOCH_HEADER: str(source.epoch.current()),
                        "X-KT-Snapshot-Seq": str(seq),
                    },
                )
        elif path == "/v1/replication/journal":
            query = parse_qs(split.query)
            offset = int((query.get("offset") or ["0"])[0] or "0")
            sha_hex = (query.get("hash") or [""])[0]
            want_start = (query.get("rehash") or ["0"])[0] == "1"
            try:
                chunk = source.journal_chunk(
                    offset, sha_hex, want_start_sha=want_start
                )
            except ReplicationDiverged as e:
                send_json(409, {"message": str(e), "reason": "Diverged"})
                return True
            headers = {
                EPOCH_HEADER: str(chunk["epoch"]),
                "X-KT-End-Offset": str(chunk["endOffset"]),
                "X-KT-End-Sha": chunk["endSha"],
                "X-KT-Position": str(chunk["position"]),
            }
            if "startSha" in chunk:
                headers["X-KT-Start-Sha"] = chunk["startSha"]
            torn = False
            if source.faults is not None and chunk["data"]:
                fault = source.faults.check("ha.replication.send")
                if fault is not None and fault.mode == "kill":
                    torn = True
                    send_raw(chunk["data"], headers, torn=True)
                    fault.kill()
            if not torn:
                send_raw(chunk["data"], headers)
        else:
            send_json(404, {"message": f"no replication route {path}"})
    except (BrokenPipeError, ConnectionResetError, OSError):
        pass  # standby went away mid-response; it will re-poll
    return True


class ReplicationServer:
    """Minimal standalone HTTP server over a :class:`ReplicationSource` —
    what the chaos harness's leader child runs (the daemon serves the same
    routes from server.py)."""

    def __init__(self, source: ReplicationSource, host: str = "127.0.0.1",
                 port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer_source = source

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                if not handle_replication_get(self, outer_source, self.path):
                    body = b'{"message": "replication endpoint only"}'
                    self.send_response(404)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="replication", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)


# --------------------------------------------------------------------------
# standby side
# --------------------------------------------------------------------------


class StandbyReplicator:
    """Warm standby: bootstrap from the leader's newest snapshot, then
    poll the journal tail and apply every event into the LOCAL store. The
    standby's own attached journal re-journals what lands, so its data
    directory independently satisfies the crash-recovery invariant ("the
    journal alone reproduces the store") at every instant — promotion is
    a local recovery, not a data copy.

    Single consumer thread; probe attributes (lag, counters, epoch) are
    single-writer values read lock-free by health/metrics probes (same
    stance as the journal's robustness counters)."""

    def __init__(
        self,
        store: Store,
        journal: StoreJournal,
        leader_url: str,
        epoch: Optional[FencingEpoch] = None,
        poll_interval: float = 0.2,
        request_timeout: float = 5.0,
    ):
        self.store = store
        self.journal = journal
        self.epoch = epoch
        split = urlsplit(leader_url)
        self._host = split.hostname or "127.0.0.1"
        self._port = split.port or 80
        self.leader_url = leader_url
        self.poll_interval = poll_interval
        self.request_timeout = request_timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # resume pair: consumed leader-journal offset + verified prefix sha
        self._offset = 0
        self._sha_hex = ""
        self._needs_rehash = False
        self.bootstrap_snapshot: Optional[dict] = None
        # single-writer probe stats
        self.leader_position = 0
        self.leader_epoch = 0
        self.events_applied = 0
        self.bytes_applied = 0
        self.lines_skipped = 0
        self.apply_errors = 0
        self.polls = 0
        self.rebootstraps = 0
        self.last_contact_monotonic: Optional[float] = None
        self.diverged = False
        self.bootstrapped = False
        # rolling-upgrade format refusal: the leader served a snapshot
        # version, protocol major, or control line this build cannot read.
        # Deterministic — retrying fetches the same bytes — so bootstrap
        # fails fast (no retry-until-deadline) and health names the demand.
        self.format_refused = 0
        self.format_refused_reason: Optional[str] = None

    # -- wire ---------------------------------------------------------------

    def _get(self, path: str) -> Tuple[int, bytes, Dict[str, str]]:
        conn = HTTPConnection(self._host, self._port, timeout=self.request_timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data, {k: v for k, v in resp.getheaders()}
        except HTTPException as e:
            # a torn chunk (leader died mid-send, Content-Length declared
            # but the connection closed short) surfaces from resp.read()
            # as IncompleteRead — an HTTPException, NOT an OSError.
            # Normalize so every caller's retry path (bootstrap, _run,
            # catch_up) treats it like any other transport failure.
            raise OSError(f"replication fetch failed: {e!r}") from e
        finally:
            conn.close()

    def _proto_refusal(self, headers: Dict[str, str]) -> Optional[str]:
        """Non-None when the leader's stamped protocol major (PROTO_HEADER)
        is incompatible with ours. A missing or malformed stamp is treated
        as the pre-versioning 1.x baseline — never a refusal (a rolling
        upgrade must interoperate with the build that predates the
        stamp)."""
        raw = headers.get(PROTO_HEADER)
        if not raw:
            return None
        try:
            major = int(str(raw).split(".", 1)[0])
        except ValueError:
            return None
        ours = local_proto_version()
        if major != ours[0]:
            return (
                f"leader speaks replication protocol {raw}; this build "
                f"speaks {ours[0]}.{ours[1]} (incompatible major)"
            )
        return None

    # -- bootstrap ----------------------------------------------------------

    def bootstrap(self, deadline_s: float = 30.0) -> bool:
        """Fetch the leader's newest snapshot (404 → genesis stream) and
        apply it into the local store; seeds the resume pair from the
        snapshot's journal anchor. Retries transport errors AND transient
        non-200 answers (a restarting leader's 500 is as temporary as a
        refused socket) until the deadline passes. Never raises — returns
        True when bootstrapped, False on deadline/stop, so callers have
        exactly one failure path."""
        deadline = time.monotonic() + deadline_s
        while not self._stop.is_set():
            try:
                status, data, headers = self._get("/v1/replication/snapshot")
            except OSError:
                if time.monotonic() >= deadline:
                    return False
                self._stop.wait(0.1)
                continue
            self.last_contact_monotonic = time.monotonic()
            refusal = self._proto_refusal(headers)
            if refusal:
                self.format_refused += 1
                self.format_refused_reason = refusal
                logger.error("standby bootstrap REFUSED: %s", refusal)
                return False
            if status == 404:
                self._offset, self._sha_hex = 0, ""
            elif status == 200:
                from .snapshot import parse_snapshot_bytes

                try:
                    payload = parse_snapshot_bytes(data)
                except SnapshotError as e:
                    # version/format refusal (rolling-upgrade skew): the
                    # leader's snapshot is NEWER than this reader. This is
                    # deterministic — every retry fetches the same bytes —
                    # so retrying until the deadline would just burn it
                    # and then report a generic timeout. Fail fast instead,
                    # with the version named for the operator; health
                    # reports down until this build is upgraded.
                    self.format_refused += 1
                    self.format_refused_reason = str(e)
                    logger.error(
                        "standby bootstrap REFUSED (no retry): %s", e
                    )
                    return False
                self._apply_snapshot(payload)
                self.bootstrap_snapshot = payload
                jinfo = payload.get("journal") or {}
                self._offset = int(jinfo.get("offset") or 0)
                self._sha_hex = str(jinfo.get("sha256") or "")
                snap_epoch = int(payload.get("epoch") or 0)
                if snap_epoch:
                    # stamp OUR journal too: the snapshot's term predates
                    # the tail we stream, so a restarted standby must not
                    # re-learn epoch 0 from a log missing the marker
                    if self.epoch is not None:
                        self.epoch.observe(snap_epoch)
                    self.journal.set_epoch(snap_epoch)
            else:
                logger.warning(
                    "snapshot fetch: HTTP %d %r; retrying",
                    status, data[:200],
                )
                if time.monotonic() >= deadline:
                    return False
                self._stop.wait(0.1)
                continue
            ep = headers.get(EPOCH_HEADER)
            if ep:
                self.leader_epoch = int(ep)
            # drain the tail once NOW, so "bootstrapped" means caught up
            # to the leader's position at this instant — a leader killed
            # right after bootstrap must not take the whole journal with
            # it just because the first background poll never ran
            try:
                while True:
                    self.poll_once()
                    if self._offset >= self.leader_position:
                        break
            except OSError:
                pass  # leader vanished mid-drain: keep what landed
            except ReplicationDiverged:
                # the anchor went stale under us: the leader compacted
                # after cutting the snapshot we just applied. Compaction
                # triggers a fresh snapshot on the leader, so re-fetching
                # yields one with a resolvable anchor — loop back
                self.diverged = False
                if time.monotonic() >= deadline:
                    return False
                self._stop.wait(0.1)
                continue
            self.bootstrapped = True
            logger.info(
                "standby bootstrapped from %s (offset=%d, epoch=%s)",
                self.leader_url, self._offset, self.leader_epoch,
            )
            return True
        return False

    def _apply_snapshot(self, payload: dict) -> None:
        from .store import key_of

        want: Dict[str, set] = {}
        ops: List[Tuple[str, str, object]] = []
        for d in payload.get("objects", []):
            kind = d.get("kind")
            obj = object_from_dict(d)
            want.setdefault(kind, set()).add(key_of(kind, obj))
            ops.append(("upsert", kind, obj))
        # snapshot v2 ships pods as a columnar block instead of manifest
        # dicts; materialize through the shared reader so the standby's
        # apply path (events → its own journal) stays unchanged
        block = payload.get("podColumns")
        if block:
            from .columnar import pods_from_columns

            for pod in pods_from_columns(block):
                want.setdefault("Pod", set()).add(key_of("Pod", pod))
                ops.append(("upsert", "Pod", pod))
        # a RESTARTED standby recovers its previous replicated state first;
        # anything it holds that the leader's snapshot no longer carries
        # was deleted while we were down — drop it BEFORE the upserts, or
        # stale extras would survive every future comparison. Dependents
        # first (pods before namespaces).
        stale: List[Tuple[str, str, object]] = []
        for kind, lister in (
            ("Pod", self.store.list_pods),
            ("Throttle", self.store.list_throttles),
            ("ClusterThrottle", self.store.list_cluster_throttles),
            ("Namespace", self.store.list_namespaces),
        ):
            have = want.get(kind, set())
            for obj in lister():
                if key_of(kind, obj) not in have:
                    stale.append(("delete", kind, obj))
        ops = stale + ops
        if ops:
            results = self.store.apply_events(ops)
            self.apply_errors += sum(
                1 for r in results if isinstance(r, Exception)
            )
            self.events_applied += len(ops)
        self.store.advance_resource_version_to(int(payload.get("rv", 0)))

    # -- tail streaming ------------------------------------------------------

    def poll_once(self) -> int:
        """One tail fetch + apply; returns events applied. Raises OSError
        on transport failure (caller decides retry policy) and
        :class:`ReplicationDiverged` on a 409 continuity failure."""
        q = f"offset={self._offset}"
        if self._sha_hex:
            q += f"&hash={self._sha_hex}"
        if self._needs_rehash:
            q += "&rehash=1"
        status, data, headers = self._get(f"/v1/replication/journal?{q}")
        self.polls += 1
        self.last_contact_monotonic = time.monotonic()
        refusal = self._proto_refusal(headers)
        if refusal:
            # the leader was upgraded across a protocol major mid-stream:
            # stop consuming BEFORE the offset advances. OSError keeps the
            # run loop's quiet paced retry (no hot loop); health names the
            # incompatibility via format_refused_reason.
            if self.format_refused_reason != refusal:
                logger.error("journal tail REFUSED: %s", refusal)
            self.format_refused += 1
            self.format_refused_reason = refusal
            raise OSError(f"replication refused: {refusal}")
        if status == 409:
            self.diverged = True
            raise ReplicationDiverged(data.decode(errors="replace")[:200])
        if status != 200:
            raise OSError(f"journal fetch failed: HTTP {status}")
        # a torn send (leader died mid-chunk) never reaches here: read()
        # raises IncompleteRead inside _get, normalized to OSError there
        if self._needs_rehash and "X-KT-Start-Sha" in headers:
            self._sha_hex = headers["X-KT-Start-Sha"]
            self._needs_rehash = False
        ep = headers.get(EPOCH_HEADER)
        if ep:
            self.leader_epoch = int(ep)
            if self.epoch is not None:
                self.epoch.observe(self.leader_epoch)
        self.leader_position = int(headers.get("X-KT-Position", "0") or 0)
        if not data:
            return 0
        # the chunk ends at the leader's accounted position — complete
        # lines, except when a torn-mode fault left an unterminated
        # fragment at the accounted tail: consume only whole lines and
        # re-fetch the fragment once its terminator lands
        valid_len = data.rfind(b"\n") + 1
        consumed = data[:valid_len]
        applied = self._apply_lines(consumed)
        self._offset += valid_len
        self.bytes_applied += valid_len
        if valid_len == len(data):
            self._sha_hex = headers.get("X-KT-End-Sha", "")
        else:
            # offset now sits mid-chunk; the verified hash no longer
            # matches — ask the source to re-hash our prefix next poll
            self._sha_hex = ""
            self._needs_rehash = True
        return applied

    def _apply_lines(self, data: bytes) -> int:
        ops: List[Tuple[str, str, object]] = []
        epochs: List[int] = []
        gangs: List[Tuple[str, str, Optional[list]]] = []
        preempts: List[dict] = []
        for raw in data.split(b"\n"):
            line = raw.strip()
            if not line:
                continue
            try:
                event = json.loads(line.decode("utf-8"))
                if event.get("type") == "EPOCH":
                    epochs.append(int(event.get("epoch", 0)))
                    continue
                if event.get("type") == "GANG":
                    # gang control line (protocol checker): forward into
                    # OUR journal so a promoted standby still knows which
                    # groups have a begin-without-commit tail to roll back
                    # — dropping it here counted the line as corruption
                    # and silently lost the mid-reserve crash marker
                    gangs.append(
                        (
                            str(event.get("op", "")),
                            str(event.get("group", "")),
                            event.get("members"),
                        )
                    )
                    continue
                if event.get("type") == "PREEMPT":
                    # preemption control line (protocol checker): forward
                    # into OUR journal so a promoted standby still knows
                    # which mid-eviction preemptions to roll back to zero
                    # victims — dropping it would count as corruption and
                    # silently lose the crash-rollback payload
                    preempts.append(event)
                    continue
                etype = event.get("type")
                if (
                    isinstance(etype, str)
                    and etype.isupper()
                    and etype not in ("ADDED", "MODIFIED", "DELETED")
                    and "object" not in event
                ):
                    # unknown-but-versioned control line from a NEWER
                    # leader build (journal.JournalFormatError stance):
                    # refuse by name BEFORE any of this chunk applies or
                    # the offset advances — counting it as corruption
                    # would silently drop semantics we do not understand.
                    need = event.get("minReader", "unknown")
                    ours = "%d.%d" % local_proto_version()
                    refusal = (
                        f"unknown control line type {etype!r} requires "
                        f"reader >= {need} (this reader speaks {ours})"
                    )
                    self.format_refused += 1
                    self.format_refused_reason = refusal
                    raise JournalFormatError(refusal)
                kind = event["kind"]
                obj = object_from_dict({**event["object"], "kind": kind})
                if event["type"] == "DELETED":
                    ops.append(("delete", kind, obj))
                else:
                    ops.append(("upsert", kind, obj))
            except (ValueError, KeyError, UnicodeDecodeError):
                # mirror journal-replay semantics: interior corruption is
                # skipped and counted, never fatal
                self.lines_skipped += 1
        if ops:
            results = self.store.apply_events(ops)
            self.apply_errors += sum(
                1 for r in results if isinstance(r, Exception)
            )
            self.events_applied += len(ops)
        for e in epochs:
            # propagate the leader's epoch marker into OUR journal so a
            # restart of this standby still knows the high-water term
            if self.epoch is not None:
                self.epoch.observe(e)
            self.journal.set_epoch(e)
        for op, group, members in gangs:
            if group:
                self.journal.append_gang(op, group, members)
        for event in preempts:
            pid = str(event.get("id", ""))
            if pid:
                self.journal.append_preempt(
                    str(event.get("op", "")),
                    pid,
                    victims=event.get("victims"),
                    objects=event.get("victimObjects"),
                )
        return len(ops)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="standby-replicator", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except ReplicationDiverged as e:
                # the leader rewrote the journal under the stream (any
                # compaction does this): the resume pair is worthless, so
                # discard it and re-bootstrap from the newest snapshot —
                # exactly what ReplicationDiverged's contract demands. The
                # standby reports down (diverged) until the re-bootstrap
                # lands; on a dead/unreachable leader the bootstrap times
                # out and the next poll's 409 brings us back here.
                logger.warning("replication diverged: %s — re-bootstrapping "
                               "from the leader's newest snapshot", e)
                self._offset, self._sha_hex = 0, ""
                self._needs_rehash = False
                if self.bootstrap(deadline_s=30.0):
                    self.diverged = False
                    self.rebootstraps += 1
            except JournalFormatError:
                # format refusal: already counted and named in
                # format_refused_reason (health reports down). Keep the
                # paced poll — a leader rollback or our own upgrade is the
                # only thing that clears it; no hot loop, no log storm.
                pass
            except OSError:
                # leader unreachable (crashed, restarting, network): keep
                # polling — the lease decides when WE take over, not the
                # socket
                pass
            except Exception:  # noqa: BLE001 — route the death, keep polling
                # the silent-replicator-death class: an unexpected
                # exception (malformed header, apply bug) must not kill
                # the thread while health keeps reporting a live standby —
                # count it where health_state/probes can see it and retry
                self.apply_errors += 1
                logger.exception("standby replicator poll failed; retrying")
            self._stop.wait(self.poll_interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def catch_up(self, attempts: int = 3, delay: float = 0.05) -> int:
        """Promotion fast-forward: drain whatever tail the (probably dead)
        leader can still serve. Transport errors end the attempt quietly —
        the surviving prefix IS the state to promote."""
        total = 0
        for _ in range(attempts):
            try:
                applied = self.poll_once()
            except (OSError, ReplicationDiverged):
                break
            total += applied
            if self._offset >= self.leader_position:
                break
            time.sleep(delay)
        return total

    # -- probes --------------------------------------------------------------

    def lag_bytes(self) -> int:
        return max(0, self.leader_position - self._offset)

    def consumed_offset(self) -> int:
        return self._offset

    def health_state(self) -> Tuple[str, dict]:
        age = (
            round(time.monotonic() - self.last_contact_monotonic, 3)
            if self.last_contact_monotonic is not None
            else None
        )
        detail = {
            "role": "standby",
            "leader": self.leader_url,
            "bootstrapped": self.bootstrapped,
            "lagBytes": self.lag_bytes(),
            "eventsApplied": self.events_applied,
            "linesSkipped": self.lines_skipped,
            "lastContactAgeSeconds": age,
            "leaderEpoch": self.leader_epoch,
            "rebootstraps": self.rebootstraps,
            "formatRefused": self.format_refused,
        }
        if self.format_refused_reason:
            # version skew, not an outage: the leader serves a format this
            # build cannot read. Down with the demand NAMED, so the
            # operator reads "upgrade me", not "network flake".
            return "down", {
                **detail,
                "error": f"format refused: {self.format_refused_reason}",
            }
        if self.diverged:
            return "down", {**detail, "error": "replication diverged"}
        if not self.bootstrapped:
            return "down", {**detail, "error": "not bootstrapped"}
        return "ok", detail


class ReplicaGate:
    """Staleness gate for the stateless read-replica admission tier.

    A read replica serves ``pre_filter``/``pre_filter_batch`` from its
    replicated mirror; every verdict is therefore as old as the last
    journal-tail confirmation. This gate enforces the staleness bound
    (replica verdict lag ≤ the flip SLO, ``max_lag_s``): a request that
    arrives while the replica cannot prove it has heard from the leader
    within the bound is REFUSED (the server answers 503 and the client
    retries against the owner) instead of served from state that may
    predate a flip.

    Lag is measured as seconds since the replicator's last successful
    tail poll (``last_contact_monotonic``): a successful poll drains the
    leader's accounted tail, so fresh contact means the mirror is within
    one poll interval of the leader's position. Divergence and
    pre-bootstrap states count as infinite lag. Counters are
    single-writer-per-request and read racily by metrics — the same
    stance as the replicator's own probe stats."""

    def __init__(self, replicator: "StandbyReplicator", max_lag_s: float = 5.0):
        self.replicator = replicator
        self.max_lag_s = float(max_lag_s)
        # admit() refuses on `lag > max_lag_s`, and every float comparison
        # against NaN is False — a NaN bound would therefore serve
        # arbitrarily stale verdicts forever (fail-OPEN, silently). A
        # non-positive bound is the opposite dead state. +inf is allowed:
        # it is the explicit "never refuse on staleness" operator choice.
        if self.max_lag_s != self.max_lag_s or self.max_lag_s <= 0:
            raise ValueError(
                f"replica max lag must be a positive number of seconds "
                f"(got {max_lag_s!r})"
            )
        self._monotonic = time.monotonic  # test injection point
        self.served_total = 0
        self.refused_total = 0
        self.lag_events_total = 0

    def current_lag(self) -> float:
        """Seconds since the replica last confirmed the leader's tail;
        +inf before bootstrap or while diverged."""
        r = self.replicator
        if r.diverged or not r.bootstrapped or r.last_contact_monotonic is None:
            return float("inf")
        return max(0.0, self._monotonic() - r.last_contact_monotonic)

    def admit(self) -> bool:
        """Gate one serving request: True ⇒ serve, False ⇒ refuse
        (stale). Counts either way."""
        if self.current_lag() > self.max_lag_s:
            self.refused_total += 1
            self.lag_events_total += 1
            return False
        self.served_total += 1
        return True

    def health_state(self) -> Tuple[str, dict]:
        lag = self.current_lag()
        detail = {
            "role": "replica",
            "maxLagSeconds": self.max_lag_s,
            "lagSeconds": (round(lag, 3) if lag != float("inf") else None),
            "served": self.served_total,
            "refused": self.refused_total,
        }
        if lag > self.max_lag_s:
            return "down", {**detail, "error": "staleness bound exceeded"}
        return "ok", detail


# --------------------------------------------------------------------------
# the facade the server/CLI/metrics read
# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# resharding: the chunk protocol re-pointed at an in-memory handoff slice,
# plus range-scoped fencing (the FencingEpoch discipline per keyspace range)
# --------------------------------------------------------------------------


class SliceChunkSource:
    """The StandbyReplicator journal-chunk contract re-pointed at an
    in-memory handoff slice: serve ``[offset, len(blob))`` windows with
    prefix-sha256 continuity, so a live-resharding source shard streams
    its keyspace slice over the framed-pickle IPC with exactly the
    torn-stream detection the replication wire already has. A chunk whose
    claimed prefix hash mismatches raises :class:`ReplicationDiverged` —
    the coordinator's abort-back-to-source trigger."""

    def __init__(self, blob: bytes, max_chunk: int = 1 << 20):
        self.blob = blob
        self.max_chunk = int(max_chunk)
        self.chunks_served = 0

    def chunk(self, offset: int, sha_hex: str = "") -> Dict[str, Any]:
        offset = int(offset)
        if offset > len(self.blob):
            raise ReplicationDiverged(
                f"offset {offset} beyond slice length {len(self.blob)}"
            )
        if sha_hex:
            want = hashlib.sha256(self.blob[:offset]).hexdigest()
            if sha_hex != want:
                raise ReplicationDiverged(
                    f"slice prefix hash mismatch at offset {offset}"
                )
        data = self.blob[offset : offset + self.max_chunk]
        end = offset + len(data)
        self.chunks_served += 1
        return {
            "data": data,
            "endOffset": end,
            "endSha": hashlib.sha256(self.blob[:end]).hexdigest(),
            "position": len(self.blob),
            # protocol stamp (version.py): the sink refuses a major it
            # cannot read instead of misparsing the slice payload
            "proto": list(local_proto_version()),
        }


class SliceChunkSink:
    """Destination-side assembler for a :class:`SliceChunkSource` stream:
    verifies every chunk's offset continuity and end-prefix hash before
    appending; a torn or reordered chunk raises
    :class:`ReplicationDiverged` and the partial buffer is discarded by
    the caller (never applied). ``done`` flips when the verified buffer
    reaches the source's position."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self.position: Optional[int] = None

    def offset(self) -> int:
        return len(self._buf)

    def sha_hex(self) -> str:
        return hashlib.sha256(bytes(self._buf)).hexdigest()

    @property
    def done(self) -> bool:
        return self.position is not None and len(self._buf) >= self.position

    def feed(self, chunk: Dict[str, Any]) -> int:
        proto = chunk.get("proto")
        if proto:
            # version stamp (SliceChunkSource): an incompatible major is
            # the coordinator's abort-back-to-source trigger — authority
            # stays with the source, nothing half-parsed is applied. An
            # unstamped chunk is the pre-versioning baseline (accepted).
            try:
                major = int(proto[0])
            except (TypeError, ValueError, IndexError, KeyError):
                major = None
            if major is not None and major != local_proto_version()[0]:
                ours = "%d.%d" % local_proto_version()
                raise ReplicationDiverged(
                    f"slice stream speaks protocol {proto}; this sink "
                    f"speaks {ours} (incompatible major)"
                )
        data = chunk.get("data") or b""
        end = int(chunk.get("endOffset", 0))
        if end != len(self._buf) + len(data):
            raise ReplicationDiverged(
                f"chunk end {end} does not extend verified prefix "
                f"{len(self._buf)}+{len(data)}"
            )
        candidate = bytes(self._buf) + bytes(data)
        if hashlib.sha256(candidate).hexdigest() != chunk.get("endSha"):
            raise ReplicationDiverged("slice chunk hash mismatch (torn stream)")
        self._buf = bytearray(candidate)
        self.position = int(chunk.get("position", end))
        return len(data)

    def payload(self) -> bytes:
        if not self.done:
            raise ReplicationDiverged("slice stream incomplete")
        return bytes(self._buf)


@guard_attrs
class RangeFence:
    """Range-scoped fencing: the :class:`FencingEpoch` discipline applied
    per keyspace range during a live reshard. Once a handoff's ranges are
    fenced at an epoch, the source's write path refuses every
    authoritative (throttle-keyspace) write whose route hash lands in a
    fenced range — a racing event routed before the cutover cannot mutate
    state the destination now owns. Fences are lifted by the cutover's
    retire (the slice left with the range) or by an abort/TTL-reap
    (authority returns to the source)."""

    GUARDED_BY = {
        "_fences": "self._lock",
        "writes_refused": "self._lock",
    }

    def __init__(self) -> None:
        self._lock = make_lock("reshard.rangefence")
        # handoff id -> (epoch, ((lo, hi), ...))
        self._fences: Dict[str, Tuple[int, Tuple[Tuple[int, int], ...]]] = {}
        self.writes_refused = 0

    def fence(self, handoff: str, ranges, epoch: int) -> None:
        with self._lock:
            self._fences[handoff] = (
                int(epoch),
                tuple((int(lo), int(hi)) for lo, hi in ranges),
            )

    def lift(self, handoff: str) -> bool:
        with self._lock:
            return self._fences.pop(handoff, None) is not None

    def fenced_handoffs(self) -> List[str]:
        with self._lock:
            return sorted(self._fences)

    def covers(self, h: int) -> bool:
        """True when ``h`` lies in any fenced range — the write refusal
        predicate the source's event path consults."""
        with self._lock:
            for _epoch, ranges in self._fences.values():
                for lo, hi in ranges:
                    if lo <= h < hi:
                        return True
            return False

    def refuse(self, n: int = 1) -> None:
        with self._lock:
            self.writes_refused += n

    def refused(self) -> int:
        with self._lock:
            return self.writes_refused


class HaCoordinator:
    """Role + epoch + replication wiring for one replica. The HTTP server
    reads ``role`` for /readyz, serves ``source`` when present; metrics
    read the lag/rejection aggregates; the CLI drives :meth:`promote`."""

    def __init__(
        self,
        epoch: FencingEpoch,
        role: str = "standby",
        source: Optional[ReplicationSource] = None,
        replicator: Optional[StandbyReplicator] = None,
        journal: Optional[StoreJournal] = None,
        snapshotter=None,
    ):
        self.epoch = epoch
        self.role = role
        self.source = source
        self.replicator = replicator
        self.journal = journal
        self.snapshotter = snapshotter
        self.failover_duration_s: Optional[float] = None
        self.promotions = 0

    def become_leader(self) -> int:
        """Leader startup (no failover): bump + stamp the journal."""
        epoch = self.epoch.bump()
        if self.journal is not None:
            self.journal.set_epoch(epoch)
        self.role = "leader"
        return epoch

    def promote(self) -> int:
        """Standby → leader: fast-forward the remaining tail, stop
        replicating, bump the epoch past every observed term, stamp the
        journal. The caller then builds the serving plugin (cache-sync
        replay rebuilds index/planes), runs the recovery-style reconcile,
        and re-enqueues every key so flips the dead leader never committed
        are recomputed and published through the two-lane pipeline."""
        t0 = time.monotonic()
        if self.replicator is not None:
            self.replicator.catch_up()
            self.replicator.stop()
        epoch = self.epoch.bump()
        if self.journal is not None:
            self.journal.set_epoch(epoch)
        self.role = "leader"
        self.promotions += 1
        self.failover_duration_s = time.monotonic() - t0
        logger.info(
            "promoted to leader (epoch %d) in %.3fs",
            epoch, self.failover_duration_s,
        )
        return epoch

    def promote_reconcile(self, plugin) -> int:
        """Post-promotion flip re-publication: enqueue EVERY live key on
        both controllers so the first reconcile sweep recomputes statuses
        from replicated truth — any flip the dead leader had computed but
        not durably published is re-derived and goes out flips-first
        through the two-lane pipeline. Returns the number of keys."""
        n = 0
        for ctr, informer in (
            (plugin.throttle_ctr, plugin.informers.throttles()),
            (plugin.cluster_throttle_ctr, plugin.informers.cluster_throttles()),
        ):
            keys = list(informer.snapshot_objects().keys())
            ctr.enqueue_all(keys)
            n += len(keys)
        return n

    def stale_epoch_rejections(self) -> int:
        total = 0
        if self.journal is not None:
            total += getattr(self.journal, "stale_epoch_rejected", 0)
        if self.snapshotter is not None:
            total += getattr(self.snapshotter, "stale_epoch_rejected", 0)
        return total

    def health_state(self) -> Tuple[str, dict]:
        detail: Dict[str, Any] = {
            "role": self.role,
            "epoch": self.epoch.current(),
            "fenced": self.epoch.is_stale(),
            "staleEpochRejections": self.stale_epoch_rejections(),
        }
        if self.failover_duration_s is not None:
            detail["failoverDurationSeconds"] = round(self.failover_duration_s, 4)
        if self.epoch.is_stale():
            return "down", detail
        if self.role == "standby" and self.replicator is not None:
            state, rdetail = self.replicator.health_state()
            return state, {**detail, **rdetail}
        return "ok", detail
