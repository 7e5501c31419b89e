"""Leader election for the standalone daemon.

The reference inherits leader election from the embedded kube-scheduler
(the ``leaderElection`` block of KubeSchedulerConfiguration —
deploy/config.yaml in both repos; client-go leaderelection over a
coordination.k8s.io Lease); a standby replica blocks until the lease is
free. Two backends here:

- :class:`FileLeaseElector` — exclusive ``flock`` on a file in a private
  runtime directory; single-host scope, crash-safe (the OS drops the lock
  on process death).
- :class:`HttpLeaseElector` — a Lease object on the control-plane
  apiserver (`/apis/coordination.k8s.io/v1/.../leases/`), renewed on a
  heartbeat and taken over when ``renewTime`` goes stale — client-go's
  LeaderElector loop. Multi-host capable: replicas coordinate through the
  shared apiserver exactly like the reference.
"""

from __future__ import annotations

import fcntl
import logging
import os
import threading
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional, Tuple

from .clock import Clock, RealClock

logger = logging.getLogger(__name__)


def default_lease_path(name: str) -> str:
    """Default flock lease location: a per-user 0700 runtime dir —
    NOT world-writable /tmp, where a predictable filename invites a
    pre-create / symlink squat (ADVICE r2 item 1)."""
    base = os.environ.get("XDG_RUNTIME_DIR") or os.environ.get("XDG_CACHE_HOME")
    root = Path(base) if base else Path.home() / ".cache"
    d = root / "kube-throttler-tpu"
    d.mkdir(mode=0o700, parents=True, exist_ok=True)
    return str(d / f"{name}.lock")


class FileLeaseElector:
    """Blocking file-lock lease: ``acquire`` polls flock(LOCK_EX|LOCK_NB)
    until it wins or ``stop`` is set; the OS releases the lease on process
    death, so a crashed leader frees its standby automatically."""

    def __init__(self, lock_path: str, retry_period: float = 2.0):
        self.lock_path = lock_path
        self.retry_period = retry_period
        self._fd: Optional[int] = None

    @property
    def is_leader(self) -> bool:
        return self._fd is not None

    def try_acquire(self) -> bool:
        if self._fd is not None:
            return True
        try:
            # O_NOFOLLOW: refuse a symlink planted at the lease path
            fd = os.open(
                self.lock_path, os.O_CREAT | os.O_RDWR | os.O_NOFOLLOW, 0o600
            )
        except OSError as e:
            # unusable path (missing dir, permission-denied) is a config
            # error, not a held lease — fail loudly instead of retrying
            raise RuntimeError(
                f"cannot open leadership lease {self.lock_path}: {e}"
            ) from e
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        except BaseException:
            # anything else (KeyboardInterrupt between open and flock, a
            # monkeypatched flock raising in tests) must not leak the fd:
            # a leaked descriptor HOLDS the flock for the process lifetime,
            # wedging every future acquire on this host
            os.close(fd)
            raise
        self._fd = fd  # leadership is held from here even if the pid write fails
        try:
            os.ftruncate(fd, 0)
            os.write(fd, str(os.getpid()).encode())
        except OSError:
            pass  # the pid note is advisory only
        return True

    def acquire(self, stop: Optional[threading.Event] = None) -> bool:
        """Block until leadership is acquired (True) or ``stop`` fires
        (False)."""
        waiting_logged = False
        while True:
            if self.try_acquire():
                logger.info("acquired leadership lease %s", self.lock_path)
                return True
            if not waiting_logged:
                logger.info(
                    "lease %s held by another replica; standing by", self.lock_path
                )
                waiting_logged = True
            if stop is not None:
                if stop.wait(self.retry_period):
                    return False
            else:
                time.sleep(self.retry_period)

    def release(self) -> None:
        """Idempotent: a double release (or a release after a failed
        acquire) is a no-op — the fd is nulled FIRST so even an unlock
        error cannot leave a half-released elector that a second call
        would double-close (closing a reused fd number belonging to
        someone else)."""
        fd, self._fd = self._fd, None
        if fd is None:
            return
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        except OSError:
            pass  # close() drops the lock regardless
        finally:
            os.close(fd)
        logger.info("released leadership lease %s", self.lock_path)


def _rfc3339(dt: datetime) -> str:
    return dt.astimezone(timezone.utc).isoformat().replace("+00:00", "Z")


class HttpLeaseElector:
    """client-go-style leader election over a coordination.k8s.io Lease on
    the apiserver (the backend the reference's embedded kube-scheduler
    uses). Multi-host: any number of replicas, on any hosts, coordinate
    through the shared control plane.

    Protocol (leaderelection.go semantics):
    - create the Lease if absent (win by creation);
    - if held by someone else, take over only when ``renewTime`` is older
      than ``lease_duration`` (the holder died or lost connectivity);
    - while leading, renew every ``renew_period`` by PUT with the last
      resourceVersion — a 409 means another replica wrote the Lease, so
      re-read and possibly demote (leadership loss is observable via
      ``is_leader``).
    """

    def __init__(
        self,
        client,  # client.transport.ApiClient
        name: str,
        identity: str,
        namespace: str = "kube-system",
        lease_duration: float = 15.0,
        renew_period: float = 5.0,
        retry_period: float = 2.0,
        renew_deadline: Optional[float] = None,
        on_lost=None,
        clock: Optional[Clock] = None,
    ):
        """``on_lost``: zero-arg callback fired when held leadership is LOST
        (renew conflict won by another replica, or the renew deadline
        passing without a successful write). The reference's embedded
        kube-scheduler exits the process here — wire ``on_lost`` to the
        daemon's stop event for the same fail-fast behavior.

        ``renew_deadline`` must be STRICTLY less than ``lease_duration``
        (client-go defaults 10s vs 15s): the demoting side gives up before
        a standby's takeover clock expires, so there is never a window with
        two leaders. Defaults to 2/3 of ``lease_duration``.

        ``clock``: staleness and renew-deadline math run on
        ``clock.monotonic()`` (client-go's observedTime semantics) — the
        holder's ``renewTime`` string is treated as an opaque heartbeat
        value, and takeover happens only after OUR monotonic clock sees it
        unchanged for a full ``lease_duration``. Wall-clock skew between
        replicas or an NTP step on either side can therefore neither
        trigger a premature takeover nor wedge a stale lease."""
        self.client = client
        self.clock = clock or RealClock()
        self.name = name
        self.identity = identity
        # create is POST to the COLLECTION, read/update to the named
        # resource — the real apiserver 405s a POST to a named path
        self.collection_path = (
            f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases"
        )
        self.path = f"{self.collection_path}/{name}"
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.retry_period = retry_period
        self.renew_deadline = (
            renew_deadline if renew_deadline is not None else lease_duration * 2 / 3
        )
        if self.renew_deadline >= lease_duration:
            raise ValueError("renewDeadline must be < leaseDuration")
        self.on_lost = on_lost
        self._leader = False
        self._rv = ""
        self._stop = threading.Event()
        self._renewer: Optional[threading.Thread] = None
        # last observed (holder, renewTime string) + the monotonic instant
        # we FIRST saw that exact pair — the takeover clock (see __init__)
        self._observed: Optional[Tuple[str, str, float]] = None

    @property
    def is_leader(self) -> bool:
        return self._leader

    # -- lease document ----------------------------------------------------

    def _spec(self, acquire_time: Optional[str] = None) -> dict:
        now = _rfc3339(datetime.now(timezone.utc))
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_duration),
            "acquireTime": acquire_time or now,
            "renewTime": now,
        }

    def _doc(self, spec: dict, rv: str = "") -> dict:
        meta = {"name": self.name}
        if rv:
            meta["resourceVersion"] = rv
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": meta,
            "spec": spec,
        }

    def try_acquire(self) -> bool:
        """One acquisition attempt (non-blocking). Races and held leases
        return False quietly; unexpected errors are LOGGED (an auth or URL
        misconfiguration must not masquerade as 'lease held')."""
        from ..client.transport import ApiError
        from ..engine.store import ConflictError, NotFoundError

        try:
            current = self.client.get(self.path)
        except NotFoundError:
            try:
                created = self.client.post(
                    self.collection_path, self._doc(self._spec())
                )
                self._rv = str((created.get("metadata") or {}).get("resourceVersion", ""))
                self._won()
                return True
            except ConflictError:
                return False  # another replica created it first
            except (ApiError, OSError) as e:
                logger.warning("lease create on %s failed: %s", self.collection_path, e)
                return False
        except (ApiError, OSError) as e:
            logger.warning("lease read on %s failed: %s", self.path, e)
            return False  # apiserver unreachable: not leader

        spec = current.get("spec") or {}
        rv = str((current.get("metadata") or {}).get("resourceVersion", ""))
        holder = spec.get("holderIdentity") or ""
        renew_raw = str(spec.get("renewTime") or "")
        duration = float(spec.get("leaseDurationSeconds") or self.lease_duration)
        # staleness on OUR monotonic clock, not wall-clock renewTime deltas:
        # the heartbeat string is opaque — any CHANGE restarts the takeover
        # window; only the same (holder, renewTime) pair observed for a full
        # lease_duration of local monotonic time means the holder is dead.
        # An NTP step (local or on the holder) changes neither condition.
        mono = self.clock.monotonic()
        if self._observed is None or self._observed[:2] != (holder, renew_raw):
            self._observed = (holder, renew_raw, mono)
            expired = not renew_raw  # a never-renewed lease is free game
        else:
            expired = (mono - self._observed[2]) > duration
        if holder == self.identity or expired or not holder:
            acquire = (
                spec.get("acquireTime") if holder == self.identity else None
            )
            try:
                updated = self.client.put(self.path, self._doc(self._spec(acquire), rv))
            except ConflictError:
                return False  # raced another replica; retry later
            except (ApiError, OSError) as e:
                logger.warning("lease takeover on %s failed: %s", self.path, e)
                return False
            self._rv = str((updated.get("metadata") or {}).get("resourceVersion", ""))
            self._won()
            return True
        return False

    def _won(self) -> None:
        if not self._leader:
            logger.info(
                "acquired leadership lease %s as %s", self.path, self.identity
            )
        self._leader = True

    def _lost(self, why: str) -> None:
        self._leader = False
        logger.warning("lost leadership lease %s (%s)", self.path, why)
        if self.on_lost is not None:
            try:
                self.on_lost()
            except Exception:
                logger.exception("on_lost callback failed")

    def _renew_loop(self) -> None:
        from ..engine.store import ConflictError

        last_renew = self.clock.monotonic()
        wait = self.renew_period
        while not self._stop.wait(wait):
            wait = self.renew_period
            try:
                updated = self.client.put(
                    self.path, self._doc(self._spec(), self._rv)
                )
                self._rv = str(
                    (updated.get("metadata") or {}).get("resourceVersion", "")
                )
                last_renew = self.clock.monotonic()
            except ConflictError:
                # someone else wrote the Lease — re-read; demote unless it
                # was our own write racing (then try_acquire re-renews)
                self._leader = False
                if self.try_acquire():
                    last_renew = self.clock.monotonic()
                else:
                    self._lost("conflict — another replica holds the lease")
                    return
            except Exception:
                # transient apiserver failure: retry FAST (retry_period, not
                # renew_period) and DEMOTE once renew_deadline passes with
                # no successful write — strictly before a standby's
                # lease_duration takeover clock can expire, so two replicas
                # never both lead (client-go renewDeadline semantics). The
                # deadline runs on the injectable monotonic clock: an NTP
                # step must not fabricate (or eat) elapsed renew time.
                logger.exception("lease renew failed; retrying")
                if self.clock.monotonic() - last_renew > self.renew_deadline:
                    self._lost(
                        f"renew deadline passed ({self.renew_deadline:.0f}s "
                        "without a successful write)"
                    )
                    return
                wait = self.retry_period

    def acquire(self, stop: Optional[threading.Event] = None) -> bool:
        """Block until leadership is acquired (True) or ``stop`` fires
        (False); starts the background renewer on success."""
        waiting_logged = False
        while True:
            if self.try_acquire():
                self._stop.clear()
                self._renewer = threading.Thread(
                    target=self._renew_loop, name="lease-renew", daemon=True
                )
                self._renewer.start()
                return True
            if not waiting_logged:
                logger.info(
                    "lease %s held by another replica; standing by", self.path
                )
                waiting_logged = True
            if stop is not None:
                if stop.wait(self.retry_period):
                    return False
            else:
                time.sleep(self.retry_period)

    def release(self) -> None:
        """Stop renewing and relinquish by zeroing the holder (a clean
        hand-off; a crashed leader is simply taken over on expiry)."""
        self._stop.set()
        if self._renewer is not None:
            self._renewer.join(timeout=2)
            self._renewer = None
        if not self._leader:
            return
        self._leader = False
        try:
            spec = self._spec()
            spec["holderIdentity"] = ""
            self.client.put(self.path, self._doc(spec, self._rv))
        except Exception:
            pass  # expiry will free it
        logger.info("released leadership lease %s", self.path)
