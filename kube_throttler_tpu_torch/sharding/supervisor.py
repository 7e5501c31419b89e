"""Shard worker supervisor: spawn, monitor, restart, resync.

``cli.py serve --shards N`` builds one of these. Each worker is a real
OS process (``python -m kube_throttler_tpu_torch.sharding.worker``) connected
over an inherited socketpair — SIGKILLing a worker is exactly the chaos
case the kill-a-shard smoke drives, and the monitor turns it into:
mark down (front degrades fail-safe) → respawn → full resync from the
front's merged store (replay + prune) → shard recomputes and re-pushes
every status (no lost flips).

Fleet modes ("from one wide host to a fleet"):

- ``transport="tcp"`` — children still spawn locally but serve the
  framed protocol over TCP (``--listen 127.0.0.1:0``; the bound port
  rendezvous is an atomically-written ``--port-file``, race-free even
  with ephemeral ports). The front talks :class:`~.ipc.TcpShardClient`.
- ``remote_workers={sid: "host:port"}`` — those shards are NOT spawned:
  somebody else runs them (another host, a StatefulSet pod). The
  supervisor only dials them; there is no process to babysit.

The monitor distinguishes **process died** (``proc.poll()`` — respawn +
resync) from **connection lost** (``on_down`` while the process is
alive, or any remote worker): the TCP client reconnects on its own with
jittered-exponential backoff and the heal path (``on_up``) runs the
epoch-bump + resync — a transient partition never triggers a spurious
local restart.

Every child gets ``--device`` (the supervisor's ``device``, ``"cuda"`` by
default): a spawned interpreter creates its own CUDA context, so N
workers on one card are N contexts whose kernels time-slice. A child that
cannot get its device exits non-zero before it serves, and ``start``
raises for it.
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from ..utils.lockorder import guard_attrs, make_lock
from .front import AdmissionFront
from .ipc import ShardClient, TcpShardClient
from .shmring import ShmEventLane, ShmRingWriter, shm_available, sweep_segments

logger = logging.getLogger(__name__)


@guard_attrs
class ShardSupervisor:
    """Spawns and babysits ``n_shards`` worker processes for a front."""

    # the proc/restart tables are shared between the spawning thread
    # (start), the monitor thread, and stop() — snapshot under the lock,
    # operate on locals (never hold it across a spawn or a sleep)
    GUARDED_BY = {
        "procs": "self._proc_lock",
        "restarts": "self._proc_lock",
        "conn_lost": "self._proc_lock",
        "_backoffs": "self._proc_lock",
        "_last_backoff": "self._proc_lock",
        "_suspended": "self._proc_lock",
        "_shm_seq": "self._proc_lock",
    }

    def __init__(
        self,
        front: AdmissionFront,
        name: str = "kube-throttler",
        target_scheduler: str = "my-scheduler",
        use_device: bool = True,
        data_dir: Optional[str] = None,
        ingest_batch="adaptive",
        restart_backoff: float = 0.5,
        restart_backoff_cap: float = 30.0,
        max_restarts: int = 10,
        worker_args: Optional[List[str]] = None,
        per_shard_args: Optional[Dict[int, List[str]]] = None,
        env: Optional[dict] = None,
        transport: str = "socketpair",
        remote_workers: Optional[Dict[int, str]] = None,
        auth_key: Optional[bytes] = None,
        device: str = "cuda",
    ):
        if transport not in ("socketpair", "tcp"):
            raise ValueError(f"unknown shard transport {transport!r}")
        self.front = front
        # the build-metrics flush samples backoff_seconds() through this
        # (register_build_metrics — the front registers the family before
        # any supervisor exists, so the wiring is late-bound)
        front.supervisor_ref = self
        self.n_shards = front.n_shards
        self.name = name
        self.target_scheduler = target_scheduler
        self.use_device = use_device
        self.device = device
        self.data_dir = data_dir
        self.ingest_batch = ingest_batch
        self.restart_backoff = restart_backoff
        # crash-loop guard ceiling: per-shard restart delays grow
        # jittered-exponentially (Backoff) from restart_backoff up
        # to this cap, and reset once a restarted shard resyncs healthy —
        # a worker dying on a version refusal or bad config paces out
        # instead of hot-spinning through its restart budget
        self.restart_backoff_cap = max(float(restart_backoff_cap),
                                       float(restart_backoff))
        self.max_restarts = max_restarts
        self.worker_args = list(worker_args or [])
        # one-shot per-shard args for each shard's FIRST incarnation only
        # (chaos rules that must not re-arm on a monitor respawn)
        self.per_shard_args: Dict[int, List[str]] = dict(per_shard_args or {})
        self.env = env
        self.transport = transport
        # shards somebody else runs (cross-host fleet): dialed, never
        # spawned, never restarted — their heal path is reconnect+resync
        self.remote_workers: Dict[int, str] = dict(remote_workers or {})
        # fleet frame-auth PSK (HMAC per frame, ipc.py trust boundary):
        # used by every TcpShardClient and exported to spawned TCP
        # children via $KT_SHARD_AUTH_KEY so both ends of a local lane
        # run the same keyed framing the remote workers require
        self.auth_key = auth_key
        self._rendezvous_dir: Optional[str] = None
        self._port_seq = 0
        # per-incarnation shm ring generation: a respawned worker gets a
        # FRESH segment (the crashed reader may have died mid-frame; a
        # fresh ring + fresh encoder string table is the resync story)
        self._shm_seq = 0
        self._proc_lock = make_lock("shard.supervisor.procs")
        self.procs: Dict[int, subprocess.Popen] = {}
        self.restarts: Dict[int, int] = {i: 0 for i in range(self.n_shards)}
        self.conn_lost: Dict[int, int] = {i: 0 for i in range(self.n_shards)}
        # per-shard restart pacing state (crash-loop guard) + the shards
        # a rolling_restart() currently owns (the monitor must not race
        # the roll's own bounce with a second restart)
        self._backoffs: Dict[int, object] = {}
        self._last_backoff: Dict[int, float] = {i: 0.0 for i in range(self.n_shards)}
        self._suspended: set = set()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # one rescale at a time: concurrent callers fail fast (two ring
        # retargets would fight over the front's single transition
        # router); callers wanting a scale PATH sequence steps themselves
        self._rescale_busy = threading.Lock()

    # ------------------------------------------------------------- spawning

    def _base_argv(self, shard_id: int) -> List[str]:
        argv = [
            sys.executable, "-m", "kube_throttler_tpu_torch.sharding.worker",
            "--shard-id", str(shard_id),
            "--shards", str(self.n_shards),
            "--name", self.name,
            "--target-scheduler-name", self.target_scheduler,
            "--ingest-batch", str(self.ingest_batch),
            "--device", self.device,
        ]
        if not self.use_device:
            argv.append("--no-device")
        if self.data_dir:
            argv += ["--data-dir", os.path.join(self.data_dir, f"shard-{shard_id}")]
        return argv

    def _extra_argv(self, shard_id: int, extra_args: Optional[List[str]]) -> List[str]:
        argv = list(self.worker_args)
        # one-shot args (a chaos rule armed for THIS incarnation only:
        # a monitor respawn after the armed kill must come up clean,
        # not re-arm the same crash forever)
        if extra_args is None:
            extra_args = self.per_shard_args.pop(shard_id, None)
        if extra_args:
            argv += list(extra_args)
        return argv

    def _child_env(self) -> dict:
        env = dict(os.environ if self.env is None else self.env)
        if self.auth_key is not None:
            env["KT_SHARD_AUTH_KEY"] = self.auth_key.decode("utf-8")
        # rolling-upgrade skew knobs (version.py): reach children even
        # when a custom env snapshot predates the harness exporting them
        # (tools/upgradetest.py re-masks capabilities between bounces)
        for var in ("KT_PROTO_CAPS_MASK", "KT_PROTO_MAJOR"):
            if var in os.environ:
                env.setdefault(var, os.environ[var])
        return env

    def _tcp_client(self, shard_id: int, host: str, port: int) -> TcpShardClient:
        return TcpShardClient(
            shard_id,
            host,
            port,
            on_push=self.front.apply_status_push,
            on_down=self._on_shard_down,
            on_up=self._on_shard_up,
            faults=self.front.faults,
            default_deadline=self.front.rpc_deadline,
            deadlines=self.front.rpc_deadlines,
            auth_key=self.auth_key,
        )

    def _attach_remote(self, shard_id: int) -> None:
        """Dial a worker somebody else runs (``remote_workers``): no
        process, no restarts — connection loss is the client's problem
        (backoff + reconnect + resync), never the monitor's."""
        host, _, port = self.remote_workers[shard_id].rpartition(":")
        client = self._tcp_client(shard_id, host or "127.0.0.1", int(port))
        self.front.attach_shard(shard_id, client)
        return None

    def _spawn_tcp(
        self, shard_id: int, extra_args: Optional[List[str]] = None
    ) -> subprocess.Popen:
        """Spawn a local child serving TCP (``--listen 127.0.0.1:0``) and
        dial it. The kernel picks the port; the child publishes it via an
        atomically-renamed port file — no parse-the-stdout races."""
        if self._rendezvous_dir is None:
            self._rendezvous_dir = tempfile.mkdtemp(prefix="kt-shard-ports-")
        self._port_seq += 1
        port_file = os.path.join(
            self._rendezvous_dir, f"shard-{shard_id}.{self._port_seq}.port"
        )
        argv = self._base_argv(shard_id) + [
            "--listen", "127.0.0.1:0",
            "--port-file", port_file,
        ] + self._extra_argv(shard_id, extra_args)
        proc = subprocess.Popen(
            argv,
            env=self._child_env(),
            stdout=subprocess.DEVNULL if self._child_env().get("KT_SHARD_QUIET") else None,
            stderr=None,
        )
        try:
            hostport = self._await_port_file(port_file, proc, timeout=120.0)
            host, _, port = hostport.rpartition(":")
            client = self._tcp_client(shard_id, host, int(port))
        except BaseException:
            proc.kill()
            raise
        with self._proc_lock:
            self.procs[shard_id] = proc
        self.front.attach_shard(shard_id, client)
        return proc

    @staticmethod
    def _await_port_file(path: str, proc: subprocess.Popen, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    text = fh.read().strip()
                if text:
                    return text
            except OSError:
                pass
            if proc.poll() is not None:
                raise RuntimeError(
                    f"worker exited rc={proc.returncode} before publishing "
                    "its port"
                )
            time.sleep(0.05)
        raise RuntimeError(f"no port file at {path} within {timeout}s")

    def _spawn(
        self, shard_id: int, extra_args: Optional[List[str]] = None
    ) -> Optional[subprocess.Popen]:
        if shard_id in self.remote_workers:
            return self._attach_remote(shard_id)
        if self.transport == "tcp":
            return self._spawn_tcp(shard_id, extra_args)
        parent_sock, child_sock = socket.socketpair()
        ring_writer: Optional[ShmRingWriter] = None
        door_rfd = -1
        try:
            argv = (
                self._base_argv(shard_id)
                + ["--ipc-fd", str(child_sock.fileno())]
                + self._extra_argv(shard_id, extra_args)
            )
            if os.environ.get("KT_SHM_RING", "1") != "0" and shm_available():
                # zero-copy event lane: a per-incarnation SPSC ring the
                # child attaches read-only by name, doorbelled over an
                # inherited pipe. Any failure here degrades to the plain
                # pickle socketpair — the ring is a fast path, never a
                # spawn dependency.
                with self._proc_lock:
                    self._shm_seq += 1
                    gen = self._shm_seq
                door_wfd = -1
                try:
                    door_rfd, door_wfd = os.pipe()
                    ring_writer = ShmRingWriter(
                        f"kt_evt_{os.getpid()}_{shard_id}_{gen}",
                        slots=int(os.environ.get("KT_SHM_RING_SLOTS", "1024")),
                        arena_bytes=int(
                            os.environ.get("KT_SHM_RING_ARENA", str(4 << 20))
                        ),
                        doorbell_wfd=door_wfd,
                        faults=self.front.faults,
                    )
                except Exception:  # noqa: BLE001 — fall back to pickle
                    logger.warning(
                        "shard %d: shm ring unavailable, falling back to "
                        "pickle socketpair", shard_id, exc_info=True,
                    )
                    if door_rfd >= 0:
                        os.close(door_rfd)
                    if door_wfd >= 0 and ring_writer is None:
                        os.close(door_wfd)
                    door_rfd = -1
                    ring_writer = None
            if ring_writer is not None:
                argv += [
                    "--shm-ring", ring_writer.name,
                    "--shm-doorbell-fd", str(door_rfd),
                ]
            env = self._child_env()
            pass_fds = [child_sock.fileno()]
            if door_rfd >= 0:
                pass_fds.append(door_rfd)
            proc = subprocess.Popen(
                argv,
                pass_fds=pass_fds,
                env=env,
                stdout=subprocess.DEVNULL if env.get("KT_SHARD_QUIET") else None,
                stderr=None,
            )
            child_sock.close()
            if door_rfd >= 0:
                os.close(door_rfd)  # child inherited its copy
                door_rfd = -1
            client = ShardClient(
                shard_id,
                parent_sock,
                on_push=self.front.apply_status_push,
                on_down=self._on_shard_down,
                faults=self.front.faults,
                default_deadline=self.front.rpc_deadline,
                deadlines=self.front.rpc_deadlines,
            )
            if ring_writer is not None:
                client.shm_lane = ShmEventLane(ring_writer)
        except BaseException:
            # a failed exec (or client construction) must not leak the
            # socketpair: each monitor-driven respawn retry would strand
            # two fds, and fd exhaustion then takes down the FRONT — the
            # lease-elector fd leak class. Same
            # rule for the ring: close(unlink=True) drops the /dev/shm
            # segment and the doorbell write end.
            parent_sock.close()
            child_sock.close()
            if ring_writer is not None:
                try:
                    ring_writer.close(unlink=True)
                except Exception:  # noqa: BLE001
                    pass
            if door_rfd >= 0:
                os.close(door_rfd)
            raise
        with self._proc_lock:
            self.procs[shard_id] = proc
        self.front.attach_shard(shard_id, client)
        return proc

    def start(self, ready_timeout: float = 120.0) -> None:
        """Spawn every worker and block until each answers a ping (the
        workers compile/prewarm serially on small hosts — be patient)."""
        spawned = [self._spawn(sid) for sid in range(self.n_shards)]
        deadline = time.monotonic() + ready_timeout
        for sid in range(self.n_shards):
            while True:
                try:
                    self.front.shards[sid].request("ping", None, timeout=5.0)
                    break
                except Exception:  # noqa: BLE001 — keep waiting until deadline
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"shard {sid} did not become ready in {ready_timeout}s"
                        ) from None
                    if spawned[sid] is not None and spawned[sid].poll() is not None:
                        raise RuntimeError(
                            f"shard {sid} exited rc={spawned[sid].returncode} "
                            "during startup"
                        ) from None
                    time.sleep(0.1)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="shard-monitor", daemon=True
        )
        self._monitor.start()

    # ------------------------------------------------------------ monitoring

    def _on_shard_down(self, shard_id: int) -> None:
        with self._proc_lock:
            proc = self.procs.get(shard_id)
        if shard_id in self.remote_workers or (
            proc is not None and proc.poll() is None
        ):
            # CONNECTION lost, not a process death: the TCP client is
            # already backing off toward a reconnect, and the heal path
            # (on_up → epoch bump + resync) repairs state. The monitor
            # keys restarts on proc.poll() alone, so a transient
            # partition never triggers a spurious local restart
            with self._proc_lock:
                self.conn_lost[shard_id] = self.conn_lost.get(shard_id, 0) + 1
            logger.warning(
                "shard %d connection lost (worker alive; reconnecting)",
                shard_id,
            )
            return
        logger.warning("shard %d transport down", shard_id)

    def _on_shard_up(self, shard_id: int) -> None:
        """TCP heal path: the client reconnected on its own (the worker
        never died, it was partitioned). Epoch-bump + full resync — the
        no-lost-flips repair, fenced against the stale past."""
        logger.info("shard %d reconnected; resyncing", shard_id)
        try:
            self.front.resync_shard(shard_id)
        except Exception:  # noqa: BLE001 — the reconnector must survive
            logger.exception("shard %d post-reconnect resync failed", shard_id)
            handle = self.front.shards.get(shard_id)
            if handle is not None:
                handle.mark_dirty()

    def connection_losses(self) -> Dict[int, int]:
        """Copy of the per-shard connection-loss counters (the monitor's
        'connection lost ≠ process died' evidence; tests/scenarios poll
        this next to restart_counts)."""
        with self._proc_lock:
            return dict(self.conn_lost)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(0.2):
            # loop-level routing (threads checker): the monitor IS the
            # restart policy — if it died of an unexpected exception, dead
            # shards would stay dead forever while the front reports
            # degraded and nothing ever repairs it
            try:
                self._monitor_tick()
            except Exception:  # noqa: BLE001 — keep the restart policy alive
                logger.exception("shard monitor tick failed")

    def _monitor_tick(self) -> None:
        with self._proc_lock:
            sids = sorted(self.procs)
        for sid in sids:
            with self._proc_lock:
                if sid in self._suspended:
                    continue  # rolling_restart() owns this bounce
                proc = self.procs.get(sid)
            if proc is None or proc.poll() is None:
                continue
            if self._stop.is_set():
                return
            with self._proc_lock:
                self.restarts[sid] = self.restarts.get(sid, 0) + 1
                budget_spent = self.restarts[sid] > self.max_restarts
                attempt = self.restarts[sid]
            if budget_spent:
                logger.error(
                    "shard %d died rc=%s; restart budget exhausted",
                    sid, proc.returncode,
                )
                with self._proc_lock:
                    self.procs[sid] = None
                continue
            logger.warning(
                "shard %d died rc=%s; restarting (%d/%d)",
                sid, proc.returncode, attempt, self.max_restarts,
            )
            old = self.front.shards.get(sid)
            if old is not None:
                old.close()
            time.sleep(self._restart_delay(sid))
            if self._stop.is_set():
                return
            try:
                fresh = self._spawn(sid)
                # wait for readiness, then replay its keyspace slice
                deadline = time.monotonic() + 120.0
                while True:
                    try:
                        self.front.shards[sid].request("ping", None, timeout=5.0)
                        break
                    except Exception:  # noqa: BLE001
                        if (
                            time.monotonic() > deadline
                            or self._stop.is_set()
                            or fresh.poll() is not None
                        ):
                            raise
                        time.sleep(0.1)
                self.front.resync_shard(sid)
                self._reset_backoff(sid)
            except Exception:  # noqa: BLE001 — retried on the next tick
                logger.exception("shard %d restart failed", sid)

    def _restart_delay(self, sid: int) -> float:
        """Next restart delay for a shard that just died: per-shard
        jittered-exponential growth (Backoff) from restart_backoff
        to restart_backoff_cap. A shard whose restart resyncs healthy
        resets to the base — only consecutive deaths pace out."""
        from ..client.transport import Backoff

        with self._proc_lock:
            bo = self._backoffs.get(sid)
            if bo is None:
                bo = Backoff(base=self.restart_backoff,
                             cap=self.restart_backoff_cap)
                self._backoffs[sid] = bo
            delay = bo.next()
            self._last_backoff[sid] = delay
        return delay

    def _reset_backoff(self, sid: int) -> None:
        with self._proc_lock:
            bo = self._backoffs.get(sid)
            if bo is not None:
                bo.reset()
            self._last_backoff[sid] = 0.0

    def backoff_seconds(self) -> Dict[int, float]:
        """Per-shard most-recent restart-backoff delay, 0.0 when healthy
        (the kube_throttler_shard_restart_backoff_seconds gauge samples
        this at scrape; tests pin growth-then-reset)."""
        with self._proc_lock:
            return dict(self._last_backoff)

    # ------------------------------------------------------ live resharding

    def _wait_ready(self, sid: int, proc: Optional[subprocess.Popen],
                    ready_timeout: float) -> None:
        deadline = time.monotonic() + ready_timeout
        while True:
            try:
                self.front.shards[sid].request("ping", None, timeout=5.0)
                return
            except Exception:  # noqa: BLE001 — keep waiting until deadline
                if time.monotonic() > deadline or self._stop.is_set():
                    raise RuntimeError(
                        f"shard {sid} did not become ready in {ready_timeout}s"
                    ) from None
                if proc is not None and proc.poll() is not None:
                    raise RuntimeError(
                        f"shard {sid} exited rc={proc.returncode} during startup"
                    ) from None
                time.sleep(0.1)

    def restart_counts(self) -> Dict[int, int]:
        """Copy of the per-shard restart counters under their lock — the
        polling surface for tests/scenarios (``restarts`` is GUARDED_BY;
        bare dict reads from the poll loops raced the monitor's bumps)."""
        with self._proc_lock:
            return dict(self.restarts)

    def shard_proc(self, shard_id: int):
        """The shard's live Popen (or None), read under the proc lock.
        Callers may poll()/kill() the returned handle lock-free — only
        the ``procs`` map itself is guarded."""
        with self._proc_lock:
            return self.procs.get(shard_id)

    def rolling_restart(
        self,
        ready_timeout: float = 120.0,
        settle_timeout: float = 60.0,
        shard_ids: Optional[List[int]] = None,
        gate=None,
    ) -> Dict:
        """Bounce every local worker ONE AT A TIME behind a resync
        barrier — the orchestrated roll of a live upgrade (new binary,
        new env, new capability mask). Each bounce: suspend the monitor's
        restart policy for that shard, terminate the old incarnation (the
        front degrades fail-safe for exactly that keyspace slice), spawn
        the replacement, wait ready, resync (replay + prune + flip
        re-publication), then hold at the barrier until the shard reports
        healthy (alive + not dirty) before the next bounce begins — the
        roll never darkens two keyspaces at once.

        ``gate`` (optional, ``gate(shard_id) -> falsy | reason``) runs
        after every bounce; a truthy reason ABORTS the roll with the rest
        of the fleet still on its old incarnation. Remote workers are
        skipped (somebody else's process; roll them from their own host).
        Returns ``{"bounces": [...], "aborted": None | {...}}``."""
        if not self._rescale_busy.acquire(blocking=False):
            raise RuntimeError("a rescale or rolling restart is already in progress")
        try:
            return self._rolling_restart_locked(
                ready_timeout, settle_timeout, shard_ids, gate
            )
        finally:
            self._rescale_busy.release()

    def _rolling_restart_locked(
        self, ready_timeout, settle_timeout, shard_ids, gate
    ) -> Dict:
        sids = sorted(range(self.n_shards) if shard_ids is None else shard_ids)
        report: Dict = {"bounces": [], "aborted": None}
        for sid in sids:
            if sid in self.remote_workers:
                continue
            t0 = time.monotonic()
            with self._proc_lock:
                self._suspended.add(sid)
                proc = self.procs.get(sid)
            try:
                old = self.front.shards.get(sid)
                if old is not None:
                    old.close()
                if proc is not None and proc.poll() is None:
                    proc.terminate()
                    try:
                        proc.wait(timeout=10.0)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait(timeout=5.0)
                fresh = self._spawn(sid)
                self._wait_ready(sid, fresh, ready_timeout)
                self.front.resync_shard(sid)
                self._settle_shard(sid, settle_timeout)
            except Exception as e:  # noqa: BLE001 — abort, don't cascade
                # abort the roll: the rest of the fleet stays on its old
                # incarnation, and the monitor resumes babysitting this
                # shard once it leaves the suspended set below
                logger.exception("rolling restart aborted at shard %d", sid)
                report["aborted"] = {
                    "shard": sid,
                    "reason": f"{e.__class__.__name__}: {e}",
                }
                break
            finally:
                with self._proc_lock:
                    self._suspended.discard(sid)
            self._reset_backoff(sid)
            bounce = {"shard": sid, "seconds": time.monotonic() - t0}
            if gate is not None:
                breach = gate(sid)
                if breach:
                    bounce["gate"] = str(breach)
                    report["bounces"].append(bounce)
                    report["aborted"] = {
                        "shard": sid, "reason": f"gate breach: {breach}",
                    }
                    return report
            report["bounces"].append(bounce)
        return report

    def _settle_shard(self, sid: int, settle_timeout: float) -> None:
        """The resync barrier: a bounced shard must report healthy
        (alive, resynced, not dirty) before the roll moves on — taking a
        second worker down while the first still warms is the
        double-failure the one-at-a-time discipline exists to avoid."""
        deadline = time.monotonic() + settle_timeout
        while time.monotonic() < deadline:
            handle = self.front.shards.get(sid)
            if handle is not None and handle.alive and not handle.is_dirty():
                return
            if self._stop.is_set():
                raise RuntimeError("supervisor stopping mid-roll")
            time.sleep(0.05)
        raise RuntimeError(
            f"shard {sid} did not settle within {settle_timeout}s of its bounce"
        )

    def rescale(
        self,
        n_new: int,
        ready_timeout: float = 120.0,
        handoff_deadline_s: float = 180.0,
        spawn_args: Optional[Dict[int, List[str]]] = None,
    ) -> Dict:
        """Live split/merge to ``n_new`` shards, NO restarts of existing
        workers: spawn any missing destinations, run the fenced two-phase
        handoff for every moving range (sharding/reshard.py), then retire
        workers above the new count. ``spawn_args`` arms one-shot chaos
        flags (e.g. ``--fault-site reshard.dest.crash:kill:2``) on a
        specific NEW shard's first incarnation — its monitor respawn
        comes up clean, which is exactly the kill-mid-handoff retry path
        the resharding scenario drives."""
        from .reshard import ReshardCoordinator
        from .ring import HashRing

        if not self._rescale_busy.acquire(blocking=False):
            raise RuntimeError("a rescale is already in progress")
        try:
            return self._rescale_step(
                n_new, ready_timeout, handoff_deadline_s, spawn_args,
                ReshardCoordinator, HashRing,
            )
        finally:
            self._rescale_busy.release()

    def _rescale_step(
        self, n_new, ready_timeout, handoff_deadline_s, spawn_args,
        ReshardCoordinator, HashRing,
    ) -> Dict:
        n_old = self.n_shards
        if n_new == n_old:
            return {"from_shards": n_old, "to_shards": n_new, "moves": 0}
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        new_ring = HashRing(n_new)
        # the front spans the union while ranges are in flight (health,
        # batch triage, and the scatter pool all index by shard id)
        self.front.n_shards = max(n_old, n_new)
        for sid in range(n_old, n_new):
            extra = (spawn_args or {}).get(sid)
            proc = self._spawn(sid, extra_args=extra)
            with self._proc_lock:
                self.restarts.setdefault(sid, 0)
            self._wait_ready(sid, proc, ready_timeout)
            # seed the empty destination with namespaces (it owns no keys
            # yet, so this is broadcast-state only + a no-op prune)
            self.front.resync_shard(sid)
        coordinator = ReshardCoordinator(self.front)
        report = coordinator.rescale(new_ring, deadline_s=handoff_deadline_s)
        for sid in range(n_new, n_old):
            handle = self.front.shards.pop(sid, None)
            if handle is not None:
                handle.close()
            with self._proc_lock:
                proc = self.procs.pop(sid, None)
                self.restarts.pop(sid, None)
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5.0)
        self.n_shards = n_new
        return report

    # -------------------------------------------------------------- shutdown

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        for sid, handle in list(self.front.shards.items()):
            try:
                handle.close()
            except Exception:  # noqa: BLE001
                pass
        deadline = time.monotonic() + timeout
        with self._proc_lock:
            procs = [p for p in self.procs.values() if p is not None]
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        # backstop: handle.close() unlinks each ring, but a handle that
        # never attached (spawn raced stop) or a writer whose unlink was
        # fault-injected away would strand a /dev/shm segment — sweep
        # everything this supervisor process created
        leaked = sweep_segments(f"kt_evt_{os.getpid()}_")
        if leaked:
            logger.warning("swept %d leaked shm segment(s): %s",
                           len(leaked), ", ".join(leaked))


__all__ = ["ShardSupervisor"]
