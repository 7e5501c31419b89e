"""IPC between the admission front and shard workers — socketpair or TCP.

Frame protocol (both directions, over one stream socket per shard):

    [4-byte little-endian length][pickled (mtype, rid, body, epoch)]

Message types:

- ``"evt"``  front→shard, one-way: an ordered batch of store ops
  ``[(verb, kind, payload), ...]`` for the shard's ingest pipeline.
  Objects travel as their dataclass form (pickle protocol 5) — the
  supervisor spawns the workers from the same code tree, so this is the
  trusted-local analog of the replication stream's JSON event lines
  (engine/replication.py), chosen over JSON for the ~2× lower
  per-event encode+decode cost on the ingest hot path.
- ``"req"``/``"res"`` — RPC with a front-assigned request id; the
  scatter-gather calls (pre_filter, two-phase reserve, gang ops,
  stats/drain) ride this.
- ``"push"`` shard→front, one-way: status events (the shard's
  controllers wrote a Throttle/ClusterThrottle status) streaming back
  so the front's store stays the merged read view — flips first, like
  the two-lane pipeline they came from.
- ``"sub"``  front→shard, one-way: subscribe THIS connection to the
  shard's push stream. A socketpair carries exactly one connection so
  the worker binds pushes at accept; a TCP client keeps a small pool of
  connections and nominates its primary lane. The body is the front's
  HELLO — ``{"proto": [major, minor], "caps": [...], "build": ...}``
  (``version.py``) — or ``None`` from a pre-handshake
  build, which negotiates as the zero-capability 1.0 baseline.
- ``"hello"`` shard→front: the worker's handshake answer. On agreement
  it carries the negotiated ``(proto, caps)`` plus the worker's build
  id; on an incompatible MAJOR it carries a typed refusal
  (``{"error": "VersionMismatch: ..."}``) and the worker drops the
  connection — the front surfaces :class:`VersionMismatch`, reports the
  shard degraded, counts the refusal, and redials at the backoff CAP
  (an operator fixes versions; the client must not hot-spin). Minor
  capabilities negotiate down to the intersection, so an old worker and
  a new front interoperate for the whole rolling upgrade.

Epoch fencing (``FencingEpoch``, end to end over the wire): every
frame carries the sender's view of the shard's fencing epoch. The front
owns the counter — it bumps it at the head of every resync (a restart,
a reconnect after a partition, a reshard retarget) — and the worker
tracks the max it has seen. A frame stamped with a LOWER epoch is a
message from the past: a partitioned-then-healed peer, or bytes that sat
in a kernel buffer across a heal. The worker drops stale ``evt`` batches
and refuses stale ``req`` frames with a :class:`FencedError` body (the
on-the-wire 409); the front drops stale ``push`` frames. Socketpair
transports never bump (epoch 0 both sides), so the fencing layer is
inert there — a dead child's socket dies with it.

Network fault sites (``net.*`` in faults/plan.py), injected HERE at the
framing layer so one seeded :class:`~..faults.plan.FaultPlan` drives
both transports identically:

- ``net.partition``       — sends raise without writing a byte
  (blackholed link). Armed per-plan-holder, so arming only one
  direction makes an ASYMMETRIC partition.
- ``net.send.torn_frame`` — a send writes only a prefix of the frame,
  then dies; the peer's ``read_frame`` must surface it as a clean EOF,
  never a partial frame.
- ``net.recv.stall``      — the receive path sleeps the rule's
  ``delay`` before the next frame (slow link / half-open socket).
- ``net.connect.refused`` — the TCP client's connect attempt is
  refused (checked in the reconnector).
- ``net.reconnect.storm`` — a just-reestablished connection dies again
  immediately (flapping link; the backoff must keep growing).

Overflow posture mirrors ``MicroBatchIngest``: the event queue is
bounded and sheds ONLY pod upserts (verdict-safe); a shed marks the
shard dirty so the supervisor's next resync repairs the gap. Sends to a
dead shard count as route misses and mark it dirty likewise.

TRUST BOUNDARY — the payload is pickle, and ``pickle.loads`` on
attacker-controlled bytes is arbitrary code execution. Over a
socketpair the peer is a child the supervisor forked from this code
tree, so the trusted-local assumption holds by construction. Over TCP
it does NOT: anything that can reach the port could feed the
deserializer. Cross-host mode therefore authenticates every frame with
a pre-shared key — ``[len][HMAC-SHA256(key, payload)][payload]`` — and
the MAC is verified BEFORE the payload is unpickled; a frame that
fails the MAC (no key, wrong key, tampered bytes) is dropped as a torn
stream and the lane dies. The worker refuses to listen on a
non-loopback address without a key (``worker.py --auth-key-file`` /
``KT_SHARD_AUTH_KEY``). The key authenticates, it does not encrypt:
frames still travel plaintext, so keep the port scoped to the fleet
(NetworkPolicy, private network) — see deploy/sharded-fleet.yaml and
docs/robustness.md "Transport security".
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import pickle
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..utils.lockorder import guard_attrs, make_lock
from ..version import CAPABILITIES, PROTO_VERSION, local_hello

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<I")
PICKLE_PROTO = 5
# A 4-byte length from a torn/hostile stream can claim up to 4 GiB;
# nothing legitimate approaches this (evt batches cap at EVT_BATCH ops,
# reshard slices chunk well below it) — anything larger is a misaligned
# tear or garbage and must die as a torn stream, not an allocation.
MAX_FRAME = 64 * 1024 * 1024
_MAC_LEN = hashlib.sha256().digest_size  # 32

AuthKey = Optional[Union[str, bytes]]


def _as_key_bytes(key: AuthKey) -> Optional[bytes]:
    if key is None or isinstance(key, bytes):
        return key
    return key.encode("utf-8")


def load_auth_key(path: str = "", env: str = "KT_SHARD_AUTH_KEY") -> Optional[bytes]:
    """Resolve the fleet's frame-auth pre-shared key: an explicit key
    file (a mounted Secret) wins over the environment variable; either
    is stripped of surrounding whitespace. ``None`` = unauthenticated
    (loopback/socketpair only)."""
    if path:
        with open(path, "rb") as fh:
            key = fh.read().strip()
        if not key:
            raise ValueError(f"auth key file {path!r} is empty")
        return key
    val = os.environ.get(env, "").strip()
    return val.encode("utf-8") if val else None

# (verb, kind, payload) — the Store.apply_events op shape
Op = Tuple[str, str, object]


class ShardUnavailable(Exception):
    """The shard's transport is down (process died / socket closed /
    partitioned / RPC deadline exceeded)."""


class FencedError(RuntimeError):
    """The peer refused a stale-epoch frame — the wire-level 409. The
    holder of a stale epoch missed a resync/reshard/promotion while
    partitioned and must NOT be trusted until re-synced."""


class VersionMismatch(RuntimeError):
    """The peer refused the handshake: incompatible protocol MAJOR
    (version.py compatibility rules). Deliberate and terminal until one
    side is upgraded — the front degrades fail-safe and keeps redialing
    slowly; nothing crash-loops."""


# Capability-gated "evt" batch encodings. v1 (the only pre-handshake
# form) is the plain op list; "evt-columnar" peers accept the
# struct-of-arrays transpose — shared verb/kind strings collapse into
# three homogeneous columns instead of riding every row's tuple. The
# DECODER is shape-sniffing and always available; the negotiated
# capability gates the SENDER, so an old worker only ever sees v1.
_EVT_COLS_V2 = "__kt_evt_cols_v2__"


def encode_evt_batch(ops: Sequence["Op"]) -> tuple:
    return (
        _EVT_COLS_V2,
        [op[0] for op in ops],
        [op[1] for op in ops],
        [op[2] for op in ops],
    )


def decode_evt_batch(body) -> List["Op"]:
    if (
        isinstance(body, tuple)
        and len(body) == 4
        and body[0] == _EVT_COLS_V2
    ):
        return list(zip(body[1], body[2], body[3]))
    return list(body)


# pickles PrepickledPayload performed (the fan-out dedup invariant:
# one shared body fanned to N shards serializes exactly once)
PREPICKLE_SERIALIZATIONS = 0


class PrepickledPayload:
    """One event body fanned out to MANY shard queues: pickle at most once.

    The router regularly enqueues the *same* payload object to several
    shards (namespace broadcasts, pod upserts to owner + mirror sets).
    Without this wrapper each shard's sender re-pickles the identical
    object inside its own ``evt`` frame. The wrapper pickles lazily on
    first use and replays the cached bytes into every later frame via
    ``__reduce__``, so the receiving side unpickles transparently back
    to the original object — no capability gate, any peer decodes it.
    The shm event lane reads ``.obj`` for pod rows and ``pickled()``
    for blob rows. Two sender threads may race ``pickled()``; the worst
    case is a duplicate serialization, never a wrong frame.
    """

    __slots__ = ("obj", "blob")
    _kt_prepickled = True  # duck-type marker (shmring avoids the import)

    def __init__(self, obj):
        self.obj = obj
        self.blob: Optional[bytes] = None

    def pickled(self) -> bytes:
        blob = self.blob
        if blob is None:
            global PREPICKLE_SERIALIZATIONS
            PREPICKLE_SERIALIZATIONS += 1
            blob = pickle.dumps(self.obj, protocol=PICKLE_PROTO)
            self.blob = blob
        return blob

    def __reduce__(self):
        return (pickle.loads, (self.pickled(),))


def unwrap_op(op: "Op") -> "Op":
    """The in-process form of an op: prepickled wrappers unwrapped."""
    verb, kind, payload = op
    if getattr(payload, "_kt_prepickled", False):
        return (verb, kind, payload.obj)
    return op


def send_frame(
    sock: socket.socket, send_lock, mtype: str, rid: int, body,
    epoch: int = 0, faults=None, key: AuthKey = None,
) -> None:
    """Pickle and send one frame. ``faults`` arms the framing-layer
    ``net.*`` sites (same seeded plan drives socketpair and TCP).
    ``key`` prepends an HMAC-SHA256 of the payload (cross-host mode:
    the peer verifies it before unpickling a byte)."""
    payload = pickle.dumps((mtype, rid, body, epoch), protocol=PICKLE_PROTO)
    kb = _as_key_bytes(key)
    if kb is not None:
        payload = hmac.new(kb, payload, hashlib.sha256).digest() + payload
    frame = _LEN.pack(len(payload)) + payload
    if faults is not None:
        fault = faults.check("net.partition")
        if fault is not None:
            # blackholed link: nothing reaches the wire; the caller
            # handles it exactly like a peer that vanished
            raise OSError(f"injected partition (hit {fault.hit}): frame blackholed")
        fault = faults.check("net.send.torn_frame")
        if fault is not None:
            with send_lock:
                sock.sendall(frame[: max(1, len(frame) // 2)])
            raise OSError(f"injected torn frame (hit {fault.hit}): prefix only")
    with send_lock:
        sock.sendall(frame)


def read_frame(
    rfile, faults=None, key: AuthKey = None,
) -> Optional[Tuple[str, int, object, int]]:
    """Read one frame from a buffered reader; None on EOF or a torn
    (short) frame — a partial frame is never surfaced. With ``key`` the
    leading HMAC is verified before ``pickle.loads`` ever runs: a frame
    from a peer without the key (or tampered in flight) is dropped as a
    torn stream, so an unauthenticated client can never reach the
    deserializer."""
    if faults is not None:
        fault = faults.check("net.recv.stall")
        if fault is not None:
            fault.sleep()  # slow link: the peer's deadlines must fire
    header = rfile.read(_LEN.size)
    if not header or len(header) < _LEN.size:
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        # a misaligned tear (or garbage) parses as a length up to 4 GiB;
        # reading toward it would stall the lane and spike memory — the
        # framing is lost either way, so die as a torn stream
        return None
    payload = rfile.read(n)
    if len(payload) < n:
        return None
    kb = _as_key_bytes(key)
    if kb is not None:
        if n < _MAC_LEN:
            return None
        mac, payload = payload[:_MAC_LEN], payload[_MAC_LEN:]
        if not hmac.compare_digest(
            mac, hmac.new(kb, payload, hashlib.sha256).digest()
        ):
            return None  # unauthenticated peer / wrong key / tampered
    try:
        return pickle.loads(payload)
    except Exception:  # noqa: BLE001 — undecodable bytes = torn stream
        # a torn write can leave the stream mid-frame: the bytes after
        # the tear parse as a bogus length and land here. The lane is
        # unrecoverable (framing lost) — report EOF, the peer redials.
        return None


def _raise_shard_error(shard_id: int, op: str, body) -> None:
    """Map a shard-side ``(False, body)`` RPC answer to the right client
    exception: a ``FencedError:``-prefixed body is the wire 409."""
    msg = str(body)
    if msg.startswith("FencedError"):
        raise FencedError(f"shard {shard_id} {op} fenced: {msg}")
    if msg.startswith("VersionMismatch"):
        raise VersionMismatch(f"shard {shard_id} {op} refused: {msg}")
    raise RuntimeError(f"shard {shard_id} {op} failed: {msg}")


def _sheddable(op: Op) -> bool:
    verb, kind, _ = op
    return kind == "Pod" and verb != "delete"


def _apply_hello(handle, body) -> None:
    """Record a worker's ``hello`` answer on a client handle (runs on
    the handle's reader thread — the negotiation fields are that
    thread's single-writer state, read racily by metrics/health)."""
    if isinstance(body, dict) and "error" in body:
        # counted before it is published: a reader that sees the refusal
        # (request()'s fast fail, health, a test's wait) sees it counted
        handle.version_mismatches += 1
        handle.version_refused = str(body["error"])
        logger.warning(
            "shard %d: handshake refused: %s",
            handle.shard_id, handle.version_refused,
        )
        return
    try:
        proto = (int(body["proto"][0]), int(body["proto"][1]))
        caps = frozenset(
            c for c in body.get("caps", ()) if isinstance(c, str)
        )
    except (TypeError, KeyError, ValueError, IndexError):
        logger.warning(
            "shard %d: malformed hello %r", handle.shard_id, body
        )
        return
    handle.negotiated_proto = proto
    handle.negotiated_caps = caps
    handle.peer_build = body.get("build")
    handle.version_refused = None


@guard_attrs
class ShardClient:
    """Front-side handle for one shard over a stream socket.

    A sender thread drains the bounded event queue into ``evt`` frames
    (one frame per drain — the IPC analog of the store's group commit);
    a reader thread demultiplexes ``res`` frames into pending request
    slots and hands ``push`` frames to the front's applier. All three
    are decoupled from the store lock the router runs under.
    """

    transport = "socketpair"
    MAX_QUEUE = 65536
    EVT_BATCH = 512

    GUARDED_BY = {
        "_queue": "self._qlock",
        "_pending": "self._plock",
        "_rid": "self._plock",
        "deadline_exceeded": "self._plock",
        "dropped": "self._qlock",
        "dirty": "self._qlock",
    }
    # NOT guarded by design: shm_lane (supervisor single-writer, bound
    # once before any event flows; the lane's own lock covers close
    # racing push), _shm_active (sender-thread single-writer),
    # shm_fallback_batches (sender-thread single-writer, read by
    # metrics at scrape like events_sent).

    def __init__(
        self,
        shard_id: int,
        sock: socket.socket,
        on_push: Optional[Callable[[int, list], None]] = None,
        on_down: Optional[Callable[[int], None]] = None,
        faults=None,
        maxsize: Optional[int] = None,
        default_deadline: float = 30.0,
        deadlines: Optional[Dict[str, float]] = None,
    ):
        self.shard_id = shard_id
        self.sock = sock
        self.on_push = on_push
        self.on_down = on_down
        self.faults = faults
        self.maxsize = maxsize or self.MAX_QUEUE
        # per-op RPC deadline budget: explicit per-op entries override
        # the default; ``request(timeout=None)`` resolves through this
        self.default_deadline = float(default_deadline)
        self.deadlines: Dict[str, float] = dict(deadlines or {})
        self.epoch = 0  # socketpair transport never bumps (fencing inert)
        self._send_lock = make_lock(f"shard.client.send.{shard_id}")
        self._qlock = make_lock(f"shard.client.queue.{shard_id}")
        self._qcond = threading.Condition(self._qlock)
        self._queue: "deque[Op]" = deque()
        self._plock = make_lock(f"shard.client.pending.{shard_id}")
        self._pending = {}  # rid -> [threading.Event, response|None]
        self._rid = 0
        self._rfile = sock.makefile("rb")
        self._alive = True  # single-writer (reader thread) after init
        self._closed = False
        # single-writer stats (sender/reader threads); read by metrics
        self.events_sent = 0
        self.frames_sent = 0
        self.dropped = 0  # verdict-safe sheds (queue overflow)
        self.dirty = False  # lost events/sends — needs resync
        self.deadline_exceeded = 0  # RPCs that outran their budget
        self.reconnects = 0  # a socketpair cannot reconnect (metrics parity)
        # handshake outcome (reader-thread single-writer after the
        # worker's hello lands; None until then = 1.0 baseline, no caps)
        self.negotiated_proto: Optional[Tuple[int, int]] = None
        self.negotiated_caps: Optional[frozenset] = None
        self.peer_build: Optional[str] = None
        self.version_refused: Optional[str] = None
        self.version_mismatches = 0
        # shared-memory event lane (sharding/shmring.py): bound by the
        # supervisor right after construction when the ring spawned with
        # the worker; None ⇒ pickle frames on the socket, always
        self.shm_lane = None
        self._shm_active = False  # sender-thread: barrier completed
        self.shm_fallback_batches = 0  # evt batches pickled despite a lane
        self._sender = threading.Thread(
            target=self._send_loop, name=f"shard{shard_id}-send", daemon=True
        )
        self._reader = threading.Thread(
            target=self._read_loop, name=f"shard{shard_id}-read", daemon=True
        )
        self._sender.start()
        self._reader.start()
        # version/capability handshake: a socketpair has exactly one
        # "connection", so the hello rides a sub frame at construction
        # (the worker re-binds the same push sink — idempotent). Sent
        # without the fault plan: the handshake is not a chaos target.
        try:
            send_frame(self.sock, self._send_lock, "sub", 0, local_hello(),
                       epoch=self.epoch)
        except OSError:
            pass  # a dead-at-birth child surfaces through the reader

    # ------------------------------------------------------------- events

    def enqueue_ops(self, ops: Sequence[Op]) -> None:
        """Queue ops for the shard; never blocks (verdict-safe shed)."""
        with self._qcond:
            if self._closed:
                return
            for op in ops:
                if len(self._queue) >= self.maxsize:
                    idx = next(
                        (i for i, q in enumerate(self._queue) if _sheddable(q)),
                        None,
                    )
                    if idx is not None:
                        del self._queue[idx]
                        self.dropped += 1
                        self.dirty = True
                    elif _sheddable(op):
                        self.dropped += 1
                        self.dirty = True
                        continue
                self._queue.append(op)
            self._qcond.notify()

    def mark_dirty(self) -> None:
        with self._qcond:
            self.dirty = True

    def clear_dirty(self) -> None:
        with self._qcond:
            self.dirty = False

    def is_dirty(self) -> bool:
        """Locked read of the needs-resync flag — ``dirty`` is GUARDED_BY
        the queue lock; the health probe reading it bare raced the sender
        marking it (lockset detector, gen-3)."""
        with self._qcond:
            return self.dirty

    def pending_events(self) -> int:
        lane = self.shm_lane
        in_ring = lane.inflight() if (lane is not None and self._shm_active) else 0
        with self._qcond:
            return len(self._queue) + in_ring

    def _send_loop(self) -> None:
        # top-level routing (threads checker): ANY death of the sender —
        # transport failure or a bug — must surface as a down shard (the
        # supervisor restarts + resyncs), never as a silently growing
        # queue behind a dead thread
        try:
            while True:
                with self._qcond:
                    while not self._queue and not self._closed:
                        self._qcond.wait(0.2)
                    if self._closed and not self._queue:
                        return
                    batch = [
                        self._queue.popleft()
                        for _ in range(min(len(self._queue), self.EVT_BATCH))
                    ]
                lane = self.shm_lane
                if (
                    lane is not None
                    and not self._shm_active
                    and not lane.dead
                    and self.has_cap("evt-shm")
                ):
                    # one-time ordering barrier before cutting over to
                    # the ring: the socket is FIFO into the worker's
                    # serve loop, so a completed RPC proves every
                    # earlier socket evt frame was already ingested.
                    # After this flips, evt NEVER rides the socket again
                    # (a failed ring push kills the lane → shard down →
                    # restart + resync, same repair as a dead socket).
                    try:
                        self.request("stats")
                        self._shm_active = True
                    except Exception:  # noqa: BLE001 — stay on the socket
                        pass
                try:
                    if self.faults is not None:
                        fault = self.faults.check("shard.ipc.send")
                        if fault is not None:
                            raise OSError(
                                f"injected IPC send failure (hit {fault.hit})"
                            )
                    if lane is not None and self._shm_active:
                        if not lane.send(batch, epoch=self.epoch):
                            raise OSError(
                                "shm event lane dead (ring stalled or closed)"
                            )
                    else:
                        if lane is not None:
                            self.shm_fallback_batches += 1
                        body = (
                            encode_evt_batch(batch)
                            if self.has_cap("evt-columnar")
                            else batch
                        )
                        send_frame(self.sock, self._send_lock, "evt", 0, body,
                                   epoch=self.epoch, faults=self.faults)
                    self.events_sent += len(batch)
                    self.frames_sent += 1
                except OSError:
                    # shard gone mid-send: these events are lost to it — the
                    # supervisor's restart+resync repairs the gap
                    with self._qcond:
                        self.dropped += len(batch)
                        self.dirty = True
                    if not self._closed:
                        self._mark_down()
                    return
        except Exception:  # noqa: BLE001 — route the death, don't hide it
            logger.exception("shard %d: sender died", self.shard_id)
            if not self._closed:
                self._mark_down()

    # ---------------------------------------------------------------- RPC

    def deadline_for(self, op: str) -> float:
        return self.deadlines.get(op, self.default_deadline)

    def request(self, op: str, payload=None, timeout: Optional[float] = None):
        """Blocking RPC; raises :class:`ShardUnavailable` on a dead shard
        or an exceeded deadline, :class:`FencedError` on a stale-epoch
        refusal, re-raises other shard-side errors as RuntimeError.
        ``timeout=None`` resolves through the per-op deadline budget."""
        if timeout is None:
            timeout = self.deadline_for(op)
        if not self._alive:
            raise ShardUnavailable(f"shard {self.shard_id} is down")
        with self._plock:
            self._rid += 1
            rid = self._rid
            slot = [threading.Event(), None]
            self._pending[rid] = slot
        try:
            send_frame(self.sock, self._send_lock, "req", rid, (op, payload),
                       epoch=self.epoch, faults=self.faults)
        except OSError:
            with self._plock:
                self._pending.pop(rid, None)
            self._mark_down()
            raise ShardUnavailable(f"shard {self.shard_id} send failed") from None
        if not slot[0].wait(timeout):
            with self._plock:
                self._pending.pop(rid, None)
                self.deadline_exceeded += 1
            raise ShardUnavailable(
                f"shard {self.shard_id} did not answer {op} within {timeout}s"
            )
        if slot[1] is None:
            raise ShardUnavailable(f"shard {self.shard_id} died during {op}")
        ok, body = slot[1]
        if not ok:
            _raise_shard_error(self.shard_id, op, body)
        return body

    def _read_loop(self) -> None:
        try:
            while True:
                frame = read_frame(self._rfile, self.faults)
                if frame is None:
                    break
                mtype, rid, body, _epoch = frame
                if mtype == "res":
                    with self._plock:
                        slot = self._pending.pop(rid, None)
                    if slot is not None:
                        slot[1] = body
                        slot[0].set()
                elif mtype == "push" and self.on_push is not None:
                    self.on_push(self.shard_id, body)
                elif mtype == "hello":
                    _apply_hello(self, body)
        except (OSError, pickle.UnpicklingError, EOFError):
            pass
        finally:
            if not self._closed:
                self._mark_down()

    # ----------------------------------------------------------- lifecycle

    @property
    def alive(self) -> bool:
        return self._alive and not self._closed

    def has_cap(self, name: str) -> bool:
        """True iff the handshake negotiated this minor capability.
        False before the worker's hello lands — pre-handshake traffic
        uses the v1 baseline encodings by construction."""
        caps = self.negotiated_caps
        return caps is not None and name in caps

    def _mark_down(self) -> None:
        was = self._alive
        self._alive = False
        # wake every waiter: their shard will not answer
        with self._plock:
            pending = list(self._pending.values())
            self._pending.clear()
        for slot in pending:
            slot[0].set()
        with self._qcond:
            self.dirty = True
            self._qcond.notify_all()
        if was and self.on_down is not None:
            self.on_down(self.shard_id)

    def close(self) -> None:
        self._closed = True
        with self._qcond:
            self._qcond.notify_all()
        lane = self.shm_lane
        if lane is not None:
            lane.close()  # unlinks the segment — the creator owns the name
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class _Conn:
    """One established TCP connection in a :class:`TcpShardClient` pool:
    socket + its send lock + the reader thread bound to it.

    Concurrency contract (no GUARDED_BY table — every field is
    effectively immutable after the maintainer publishes the lane):
    ``idx``/``sock``/``send_lock`` are assigned once at construction;
    ``reader`` is bound exactly once by the maintainer thread before the
    _Conn is stored into ``_conns[idx]`` under ``_clock``, and that
    publication is the happens-before edge every other thread reads
    through. Frame WRITES on ``sock`` serialize under ``send_lock``;
    frame READS belong to the single reader thread alone."""

    def __init__(self, shard_id: int, idx: int, sock: socket.socket):
        self.idx = idx
        self.sock = sock
        self.send_lock = make_lock(f"shard.tcp.send.{shard_id}.{idx}")
        self.reader: Optional[threading.Thread] = None

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


@guard_attrs
class TcpShardClient:
    """Front-side handle for one shard over TCP — the cross-host fleet
    transport. Same surface as :class:`ShardClient`, plus:

    - a small **connection pool**: lane 0 is the primary (carries the
      ordered ``evt`` stream and subscribes to the shard's ``push``
      stream via a ``sub`` frame); extra lanes are parallel RPC lanes so
      a slow scatter call cannot head-of-line-block its neighbors.
    - a **reconnector** with jittered-exponential backoff (the
      ``Backoff``): connection loss does NOT kill the handle. While the
      primary lane is down the client reports ``alive=False`` — the
      front degrades to fail-safe verdicts, exactly like a dead child —
      and on re-establishment it fires ``on_up`` so the supervisor runs
      the resync (which first bumps the fencing epoch).
    - **per-op deadlines** (``deadline_for``) and **epoch stamping** on
      every outgoing frame; stale ``push`` frames from a
      healed-but-not-yet-resynced worker are dropped, stale-epoch RPC
      refusals surface as :class:`FencedError`.

    The bounded send queue keeps the watch-queue discipline: store
    dispatch NEVER blocks on the network — overflow sheds pod upserts
    (verdict-safe) and marks the shard dirty for the next resync.
    """

    transport = "tcp"
    MAX_QUEUE = 65536
    EVT_BATCH = 512

    GUARDED_BY = {
        "_queue": "self._qlock",
        "_pending": "self._plock",
        "_rid": "self._plock",
        "_rr": "self._plock",
        "deadline_exceeded": "self._plock",
        "dropped": "self._qlock",
        "dirty": "self._qlock",
        "_conns": "self._clock",
        "reconnects": "self._clock",
        "partition_seconds": "self._clock",
        "_down_since": "self._clock",
        # state-machine flags of the reconnector: every WRITE happens
        # under _ccond (the Condition over _clock — holding either
        # satisfies the guard). _alive is deliberately read lock-free by
        # the alive property (waived): a stale read degrades exactly one
        # admission to the fail-safe verdict, which is the transport's
        # contract for a down shard anyway.
        "_ever_up": "self._clock",
        "_alive": "self._clock",
    }
    # NOT guarded by design: events_sent/frames_sent (sender-thread
    # single-writer), fenced_pushes (reader-thread single-writer), epoch
    # (supervisor single-writer, stamped racily onto outgoing frames —
    # a frame stamped one bump early is refused and retried post-resync).

    def __init__(
        self,
        shard_id: int,
        host: str,
        port: int,
        on_push: Optional[Callable[[int, list], None]] = None,
        on_down: Optional[Callable[[int], None]] = None,
        on_up: Optional[Callable[[int], None]] = None,
        faults=None,
        maxsize: Optional[int] = None,
        pool_size: int = 2,
        default_deadline: float = 30.0,
        deadlines: Optional[Dict[str, float]] = None,
        connect_timeout: float = 5.0,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        auth_key: AuthKey = None,
    ):
        from ..client.transport import Backoff  # jittered exponential

        self.shard_id = shard_id
        self.host = host
        self.port = int(port)
        self.on_push = on_push
        self.on_down = on_down
        self.on_up = on_up
        self.faults = faults
        # cross-host frame auth (HMAC per frame, see module docstring);
        # None = unauthenticated — loopback/test rigs only
        self.auth_key = _as_key_bytes(auth_key)
        self.maxsize = maxsize or self.MAX_QUEUE
        self.pool_size = max(1, int(pool_size))
        self.default_deadline = float(default_deadline)
        self.deadlines: Dict[str, float] = dict(deadlines or {})
        self.connect_timeout = connect_timeout
        # the fencing epoch this front believes the shard is at.
        # Single-writer: only bump_epoch (the resync path) advances it;
        # sender/request threads read the int (atomic in CPython)
        self.epoch = 1
        self._backoff = Backoff(base=backoff_base, cap=backoff_cap)
        self._qlock = make_lock(f"shard.tcp.queue.{shard_id}")
        self._qcond = threading.Condition(self._qlock)
        self._queue: "deque[Op]" = deque()
        self._plock = make_lock(f"shard.tcp.pending.{shard_id}")
        self._pending = {}  # rid -> [threading.Event, response|None, conn]
        self._rid = 0
        self._rr = 0  # round-robin cursor over live RPC lanes
        self._clock = make_lock(f"shard.tcp.conns.{shard_id}")
        self._ccond = threading.Condition(self._clock)
        self._conns: List[Optional[_Conn]] = [None] * self.pool_size
        self._alive = False  # primary lane state; flips in _set_primary
        self._ever_up = False
        self._closed = False
        # single-writer stats; read by metrics at scrape
        self.events_sent = 0
        self.frames_sent = 0
        self.dropped = 0
        self.dirty = False
        self.deadline_exceeded = 0
        self.reconnects = 0  # primary-lane re-establishments after a drop
        self.partition_seconds = 0.0  # cumulative primary-lane downtime
        self.fenced_pushes = 0  # stale-epoch pushes dropped (reader thread)
        # handshake outcome (reader-thread single-writer, like
        # fenced_pushes): None until the worker's hello lands = the
        # zero-capability 1.0 baseline. version_refused holds the
        # worker's typed refusal while the majors disagree — the
        # reconnector slows to the backoff CAP and request() fails fast
        # with VersionMismatch instead of burning its deadline.
        self.negotiated_proto: Optional[Tuple[int, int]] = None
        self.negotiated_caps: Optional[frozenset] = None
        self.peer_build: Optional[str] = None
        self.version_refused: Optional[str] = None
        self.version_mismatches = 0
        self._refusal_delay = max(1.0, float(backoff_cap))
        self._down_since: Optional[float] = time.monotonic()
        self._sender = threading.Thread(
            target=self._send_loop, name=f"shard{shard_id}-tcp-send", daemon=True
        )
        self._maintainer = threading.Thread(
            target=self._maintain_loop, name=f"shard{shard_id}-tcp-conn", daemon=True
        )
        self._sender.start()
        self._maintainer.start()

    # ------------------------------------------------------------ connection

    def _open_conn(self, idx: int) -> _Conn:
        """Dial one lane (NOT under any lock — connect blocks). Raises
        OSError on failure; installs + returns the live conn."""
        if self.faults is not None:
            fault = self.faults.check("net.connect.refused")
            if fault is not None:
                raise ConnectionRefusedError(
                    f"injected connect refusal (hit {fault.hit})"
                )
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout
        )
        try:
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(self.shard_id, idx, sock)
            if idx == 0:
                # nominate this lane as the push stream (and teach the
                # worker our current epoch before any RPC rides it).
                # The body is our HELLO: the worker answers with the
                # negotiated version/caps (or a VersionMismatch refusal)
                # on a "hello" frame. Faults apply here too: under
                # net.partition the sub frame blackholes like any other
                # send, so a partitioned client stays DOWN in backoff
                # instead of flapping up-then-down once per establishment
                send_frame(sock, conn.send_lock, "sub", 0, local_hello(),
                           epoch=self.epoch, faults=self.faults,
                           key=self.auth_key)
            if self.faults is not None:
                fault = self.faults.check("net.reconnect.storm")
                if fault is not None:
                    raise OSError(
                        f"injected reconnect storm (hit {fault.hit}): "
                        "fresh connection killed"
                    )
        except BaseException:
            sock.close()
            raise
        reader = threading.Thread(
            target=self._read_conn, args=(conn,),
            name=f"shard{self.shard_id}-tcp-read{idx}", daemon=True,
        )
        conn.reader = reader
        with self._ccond:
            self._conns[idx] = conn
        reader.start()
        return conn

    def _maintain_loop(self) -> None:
        # top-level routing (threads checker): the reconnector IS the
        # heal path — if it died, a transient partition would be
        # permanent while the front reports degraded forever
        try:
            while True:
                with self._ccond:
                    if self._closed:
                        return
                    missing = [
                        i for i in range(self.pool_size) if self._conns[i] is None
                    ]
                    if not missing:
                        self._ccond.wait(0.2)
                        continue
                primary_was_down = 0 in missing
                opened_primary = False
                failed = False
                for idx in missing:
                    if self._closed:
                        return
                    try:
                        self._open_conn(idx)
                        if idx == 0:
                            opened_primary = True
                    except OSError:
                        failed = True
                if opened_primary and primary_was_down:
                    self._backoff.reset()
                    self._set_primary_up()
                if failed and not self._closed:
                    delay = self._backoff.next()
                    with self._ccond:
                        if not self._closed:
                            self._ccond.wait(delay)
                elif self.version_refused is not None and not self._closed:
                    # the worker refused our major and dropped the lane:
                    # redialing faster cannot help (an operator upgrades
                    # one side), so pace at the cap — degraded, counted,
                    # never a crash loop
                    with self._ccond:
                        if not self._closed:
                            self._ccond.wait(self._refusal_delay)
        except Exception:  # noqa: BLE001 — route the death, don't hide it
            logger.exception("shard %d: tcp reconnector died", self.shard_id)

    def _set_primary_up(self) -> None:
        reconnected = False
        with self._ccond:
            if self._ever_up:
                self.reconnects += 1
                reconnected = True
            if self._down_since is not None:
                self.partition_seconds += time.monotonic() - self._down_since
                self._down_since = None
            self._ever_up = True
            self._alive = True
            self._ccond.notify_all()
        with self._qcond:
            self._qcond.notify_all()  # sender: the evt lane is back
        logger.info(
            "shard %d: tcp primary lane %s (%s:%d)",
            self.shard_id, "reconnected" if reconnected else "connected",
            self.host, self.port,
        )
        if reconnected and self.on_up is not None:
            # the supervisor's heal path: bump the fencing epoch, then
            # resync (replay + prune + re-push — no lost flips)
            self.on_up(self.shard_id)

    def _conn_dead(self, conn: _Conn) -> None:
        """Tear down one lane; lane 0 dying marks the shard down."""
        conn.close()
        with self._ccond:
            if self._conns[conn.idx] is not conn:
                return  # already replaced
            self._conns[conn.idx] = None
            primary = conn.idx == 0
            if primary:
                was = self._alive
                self._alive = False
                if self._down_since is None:
                    self._down_since = time.monotonic()
            self._ccond.notify_all()
        # fail only the RPCs that were in flight on THIS lane
        stale = []
        with self._plock:
            for rid, slot in list(self._pending.items()):
                if slot[2] is conn:
                    stale.append(self._pending.pop(rid))
        for slot in stale:
            slot[0].set()
        if primary:
            with self._qcond:
                self.dirty = True
                self._qcond.notify_all()
            if was and not self._closed and self.on_down is not None:
                self.on_down(self.shard_id)

    def _primary(self) -> Optional[_Conn]:
        with self._ccond:
            return self._conns[0]

    def _pick_conn(self) -> Optional[_Conn]:
        with self._ccond:
            live = [c for c in self._conns if c is not None]
        if not live:
            return None
        with self._plock:
            self._rr += 1
            return live[self._rr % len(live)]

    # ------------------------------------------------------------- events

    def enqueue_ops(self, ops: Sequence[Op]) -> None:
        """Queue ops for the shard; never blocks — store dispatch must
        not wait on the network (verdict-safe shed on overflow)."""
        with self._qcond:
            if self._closed:
                return
            for op in ops:
                if len(self._queue) >= self.maxsize:
                    idx = next(
                        (i for i, q in enumerate(self._queue) if _sheddable(q)),
                        None,
                    )
                    if idx is not None:
                        del self._queue[idx]
                        self.dropped += 1
                        self.dirty = True
                    elif _sheddable(op):
                        self.dropped += 1
                        self.dirty = True
                        continue
                self._queue.append(op)
            self._qcond.notify()

    def _send_loop(self) -> None:
        # top-level routing (threads checker): sender death = down shard.
        # Unlike ShardClient this handle SURVIVES link loss, so an
        # unexpected sender error cannot just log-and-exit — events would
        # queue/shed forever behind a dead thread while health read
        # merely "degraded" and even a resync would re-enqueue into the
        # same dead queue. Tear down the primary lane instead (on_down
        # fires, the front degrades fail-safe, the reconnect's resync
        # repairs the gap) and keep the sender alive.
        while True:
            try:
                self._drain_until_closed()
                return  # clean exit: closed and drained
            except Exception:  # noqa: BLE001 — route the death, don't hide it
                logger.exception("shard %d: tcp sender error", self.shard_id)
                with self._qcond:
                    if self._closed:
                        return
                    self.dirty = True
                conn = self._primary()
                if conn is not None:
                    self._conn_dead(conn)
                time.sleep(0.05)  # a persistent bug must not spin-degrade

    def _drain_until_closed(self) -> None:
        while True:
            with self._qcond:
                while not self._queue and not self._closed:
                    self._qcond.wait(0.2)
                if self._closed and not self._queue:
                    return
            conn = self._primary()
            if conn is None:
                if self._closed:
                    return
                # partitioned: hold the (bounded) queue; the shed +
                # dirty + resync-on-heal path repairs any overflow
                with self._ccond:
                    if self._conns[0] is None and not self._closed:
                        self._ccond.wait(0.2)
                continue
            with self._qcond:
                batch = [
                    self._queue.popleft()
                    for _ in range(min(len(self._queue), self.EVT_BATCH))
                ]
            if not batch:
                continue
            try:
                if self.faults is not None:
                    fault = self.faults.check("shard.ipc.send")
                    if fault is not None:
                        raise OSError(
                            f"injected IPC send failure (hit {fault.hit})"
                        )
                body = (
                    encode_evt_batch(batch)
                    if self.has_cap("evt-columnar")
                    else batch
                )
                send_frame(conn.sock, conn.send_lock, "evt", 0, body,
                           epoch=self.epoch, faults=self.faults,
                           key=self.auth_key)
                self.events_sent += len(batch)
                self.frames_sent += 1
            except OSError:
                # link gone mid-send: these events are lost — the
                # reconnect's resync (replay + prune) repairs the gap
                with self._qcond:
                    self.dropped += len(batch)
                    self.dirty = True
                self._conn_dead(conn)

    # ---------------------------------------------------------------- RPC

    def deadline_for(self, op: str) -> float:
        return self.deadlines.get(op, self.default_deadline)

    def request(self, op: str, payload=None, timeout: Optional[float] = None):
        """Blocking RPC with a per-op deadline; raises
        :class:`ShardUnavailable` when the link is down or the deadline
        passes, :class:`FencedError` on a stale-epoch refusal."""
        if timeout is None:
            timeout = self.deadline_for(op)
        refused = self.version_refused
        if refused is not None:
            raise VersionMismatch(
                f"shard {self.shard_id} refused the handshake: {refused}"
            )
        if not self.alive:
            raise ShardUnavailable(
                f"shard {self.shard_id} is unreachable ({self.host}:{self.port})"
            )
        conn = self._pick_conn()
        if conn is None:
            raise ShardUnavailable(
                f"shard {self.shard_id} has no live connection"
            )
        with self._plock:
            self._rid += 1
            rid = self._rid
            slot = [threading.Event(), None, conn]
            self._pending[rid] = slot
        try:
            send_frame(conn.sock, conn.send_lock, "req", rid, (op, payload),
                       epoch=self.epoch, faults=self.faults,
                       key=self.auth_key)
        except OSError:
            with self._plock:
                self._pending.pop(rid, None)
            self._conn_dead(conn)
            raise ShardUnavailable(
                f"shard {self.shard_id} send failed ({self.host}:{self.port})"
            ) from None
        if not slot[0].wait(timeout):
            with self._plock:
                self._pending.pop(rid, None)
                self.deadline_exceeded += 1
            raise ShardUnavailable(
                f"shard {self.shard_id} did not answer {op} within {timeout}s"
            )
        if slot[1] is None:
            raise ShardUnavailable(
                f"shard {self.shard_id} connection died during {op}"
            )
        ok, body = slot[1]
        if not ok:
            _raise_shard_error(self.shard_id, op, body)
        return body

    def _read_conn(self, conn: _Conn) -> None:
        rfile = conn.sock.makefile("rb")
        try:
            while True:
                frame = read_frame(rfile, self.faults, key=self.auth_key)
                if frame is None:
                    break
                mtype, rid, body, epoch = frame
                if mtype == "res":
                    with self._plock:
                        slot = self._pending.pop(rid, None)
                    if slot is not None:
                        slot[1] = body
                        slot[0].set()
                elif mtype == "push":
                    if epoch < self.epoch:
                        # a healed worker replaying its pre-partition view:
                        # fenced — the resync re-push will carry the truth
                        self.fenced_pushes += 1
                    elif self.on_push is not None:
                        self.on_push(self.shard_id, body)
                elif mtype == "hello":
                    _apply_hello(self, body)
        except (OSError, pickle.UnpicklingError, EOFError):
            pass
        except Exception:  # noqa: BLE001 — route the death, don't hide it
            logger.exception("shard %d: tcp reader died", self.shard_id)
        finally:
            try:
                rfile.close()
            except OSError:
                pass
            self._conn_dead(conn)

    # ----------------------------------------------------------- lifecycle

    @property
    def alive(self) -> bool:
        return self._alive and not self._closed

    def has_cap(self, name: str) -> bool:
        """True iff the handshake negotiated this minor capability.
        False before the worker's hello lands — pre-handshake traffic
        uses the v1 baseline encodings by construction."""
        caps = self.negotiated_caps
        return caps is not None and name in caps

    def bump_epoch(self) -> int:
        """Advance the fencing epoch (resync head): frames stamped with
        the previous epoch — from a partitioned peer or a stale kernel
        buffer — are refused from here on."""
        self.epoch += 1
        return self.epoch

    def is_dirty(self) -> bool:
        with self._qcond:
            return self.dirty

    def mark_dirty(self) -> None:
        with self._qcond:
            self.dirty = True

    def clear_dirty(self) -> None:
        with self._qcond:
            self.dirty = False

    def pending_events(self) -> int:
        with self._qcond:
            return len(self._queue)

    def outage_seconds(self) -> float:
        """Cumulative primary-lane downtime, including the current
        outage if one is in progress (the partition_seconds metric)."""
        with self._ccond:
            total = self.partition_seconds
            if self._down_since is not None:
                total += time.monotonic() - self._down_since
            return total

    def close(self) -> None:
        self._closed = True
        with self._qcond:
            self._qcond.notify_all()
        with self._ccond:
            conns = [c for c in self._conns if c is not None]
            self._conns = [None] * self.pool_size
            self._alive = False
            self._ccond.notify_all()
        for conn in conns:
            conn.close()
        with self._plock:
            pending = list(self._pending.values())
            self._pending.clear()
        for slot in pending:
            slot[0].set()
        self._maintainer.join(timeout=2.0)
        self._sender.join(timeout=2.0)


class LocalShard:
    """In-process shard handle for deterministic tests: wraps a
    :class:`worker.ShardCore` directly — same surface as
    :class:`ShardClient`, no sockets, events applied synchronously."""

    transport = "local"

    def __init__(self, shard_id: int, core, on_push=None):
        self.shard_id = shard_id
        self.core = core
        self.events_sent = 0
        self.frames_sent = 0
        self.dropped = 0
        self.dirty = False
        self.alive = True
        self.epoch = 0
        self.deadline_exceeded = 0
        self.reconnects = 0
        # in-process "handshake": trivially the local build's identity
        self.negotiated_proto = PROTO_VERSION
        self.negotiated_caps = CAPABILITIES
        self.peer_build = None
        self.version_refused = None
        self.version_mismatches = 0
        if on_push is not None:
            core.push = lambda items: on_push(shard_id, items)

    def enqueue_ops(self, ops: Sequence[Op]) -> None:
        if not self.alive:
            self.dropped += len(ops)
            self.dirty = True
            return
        self.core.handle_events([unwrap_op(op) for op in ops])
        self.events_sent += len(ops)
        self.frames_sent += 1

    def is_dirty(self) -> bool:
        return self.dirty  # synchronous single-thread handle: no lock

    def pending_events(self) -> int:
        return 0

    def mark_dirty(self) -> None:
        self.dirty = True

    def clear_dirty(self) -> None:
        self.dirty = False

    def deadline_for(self, op: str) -> float:
        return 30.0

    def has_cap(self, name: str) -> bool:
        return name in self.negotiated_caps

    def request(self, op: str, payload=None, timeout: Optional[float] = None):
        if not self.alive:
            raise ShardUnavailable(f"shard {self.shard_id} is down")
        ok, body = self.core.rpc(op, payload)
        if not ok:
            _raise_shard_error(self.shard_id, op, body)
        return body

    def close(self) -> None:
        self.alive = False


__all__ = [
    "Op",
    "ShardClient",
    "TcpShardClient",
    "ShardUnavailable",
    "FencedError",
    "VersionMismatch",
    "LocalShard",
    "send_frame",
    "read_frame",
    "encode_evt_batch",
    "decode_evt_batch",
    "PrepickledPayload",
    "unwrap_op",
    "PICKLE_PROTO",
]
