"""Version & format contracts for rolling upgrades.

Single source of truth for everything two *different* builds of this
package must agree on before they exchange bytes:

- the shard wire protocol's ``(major, minor)`` version and the minor
  capability set the ``sub``/hello handshake negotiates
  (sharding/ipc.py ↔ sharding/worker.py);
- the durable-format registry: every framed-pickle frame type, journal
  control-line type, and snapshot payload version maps to the minimum
  reader version that understands it (``FORMAT_REGISTRY``).

Compatibility rules (docs/robustness.md "Upgrades & version skew"):

- equal MAJOR is required; a major mismatch is refused with a typed
  ``VersionMismatch`` frame — degraded health, counted metric, never a
  crash loop;
- MINOR differences negotiate down: the effective capability set is the
  intersection of what both ends advertise, so an old worker and a new
  front interoperate for the whole roll (capabilities gate encodings,
  never semantics);
- durable formats only ever ADD registry entries; removing or re-keying
  one breaks replay of committed journals/snapshots and is forbidden
  (the pre-bump fixture pair under tests/fixtures/ pins this forever).

Deliberately jax-free: the journal, the snapshot reader, and the IPC
framing layer consult this module at runtime on paths where importing
the device stack would be dead weight.
"""

from __future__ import annotations

import os
from typing import Dict, FrozenSet, Iterable, Optional, Tuple

from . import __version__ as BUILD_VERSION

# Wire-protocol version of THIS build. Bump MINOR when adding a
# negotiable capability; bump MAJOR only for changes an old peer cannot
# safely ignore (frame layout, handshake shape, fencing semantics).
PROTO_MAJOR = 1
PROTO_MINOR = 2
PROTO_VERSION: Tuple[int, int] = (PROTO_MAJOR, PROTO_MINOR)

# Human-debuggable build identity carried in the hello exchange and the
# build_info gauge — never an input to negotiation.
BUILD_ID = f"kube-throttler-tpu/{BUILD_VERSION}"

# Minor capabilities THIS build can speak. Negotiation intersects both
# ends' advertised sets; using a capability the peer did not advertise
# is a bug (the interop sweep in tests/test_upgrade.py gates this).
#
#   evt-columnar   "evt" store-op batches may ship column-packed
#                  (struct-of-arrays transpose) instead of the v1
#                  row-list pickle — same events, cheaper frames
#   build-info     the peer answers stats RPCs with negotiated
#                  version/caps/build fields (kube_throttler_build_info)
#   evt-shm        the worker attached the supervisor's shared-memory
#                  event ring (sharding/shmring.py): the front may move
#                  "evt" batches through it as ring-v1 columnar frames
#                  instead of pickle frames on the socket. A worker
#                  only advertises this when its ring attach succeeded;
#                  either side masking it falls back to pickle frames
#                  byte-identically (mixed fleets / rolling upgrades)
CAPABILITIES: FrozenSet[str] = frozenset({"evt-columnar", "build-info", "evt-shm"})

# Durable/wire format registry: ``<domain>:<name> -> minimum reader
# version`` (the oldest PROTO_MAJOR-series reader that understands the
# format). The static analyzer's `protocol` checker machine-checks this
# literal: every frame mtype passed to send_frame, every journal
# control-line type emitted anywhere in the package, and every entry of
# SUPPORTED_SNAPSHOT_VERSIONS must have a row here, and every row must
# still be referenced by code (a stale row is a finding). Keep it a
# plain literal — the checker reads it from the AST without importing.
FORMAT_REGISTRY: Dict[str, int] = {
    # framed-pickle shard protocol (sharding/ipc.py)
    "frame:evt": 1,
    "frame:req": 1,
    "frame:res": 1,
    "frame:push": 1,
    "frame:sub": 1,
    "frame:hello": 1,
    # journal control lines (engine/journal.py, engine/replication.py)
    "journal:EPOCH": 1,
    "journal:GANG": 1,
    "journal:PREEMPT": 1,
    # snapshot payload versions (engine/snapshot.py)
    "snapshot:1": 1,
    "snapshot:2": 1,
    # shared-memory event-ring layouts (sharding/shmring.py SHM_FORMATS)
    "shm:ring-v1": 1,
}


def min_reader_version(domain: str, name: object) -> Optional[int]:
    """Minimum reader version for a registered format, or None if the
    format is unknown to this build."""
    return FORMAT_REGISTRY.get(f"{domain}:{name}")


def advertised_capabilities(env: Optional[Dict[str, str]] = None) -> FrozenSet[str]:
    """The capability set this process advertises in its hello.

    ``KT_PROTO_CAPS_MASK`` (comma-separated capability names) restricts
    the advertisement to the named subset — the rolling-upgrade harness
    uses it to make a current binary *behave* like an older minor
    (empty string ⇒ advertise nothing, i.e. the 1.0 baseline). Unset ⇒
    the full built-in set.
    """
    env = os.environ if env is None else env
    mask = env.get("KT_PROTO_CAPS_MASK")
    if mask is None:
        return CAPABILITIES
    allowed = {c.strip() for c in mask.split(",") if c.strip()}
    return CAPABILITIES & frozenset(allowed)


def local_proto_version(env: Optional[Dict[str, str]] = None) -> Tuple[int, int]:
    """This process's advertised ``(major, minor)``.

    ``KT_PROTO_MAJOR`` overrides the major — the upgrade chaos matrix
    uses it to stage an incompatible-major pairing without building a
    second wheel. A non-integer value is ignored (never crash on env).
    """
    env = os.environ if env is None else env
    raw = env.get("KT_PROTO_MAJOR")
    if raw:
        try:
            return (int(raw), PROTO_MINOR)
        except ValueError:
            pass
    return (PROTO_MAJOR, PROTO_MINOR)


def local_hello(env: Optional[Dict[str, str]] = None) -> Dict[str, object]:
    """The hello payload carried by the lane-0 ``sub`` frame (front →
    worker) and echoed back in the worker's ``hello`` reply."""
    return {
        "proto": list(local_proto_version(env)),
        "caps": sorted(advertised_capabilities(env)),
        "build": BUILD_ID,
    }


class NegotiationError(ValueError):
    """Raised by :func:`negotiate` on an incompatible-major pairing.
    Wire layers translate this into the typed ``VersionMismatch``
    refusal; it never crosses a process boundary itself."""


def negotiate(
    ours: Tuple[int, int],
    our_caps: Iterable[str],
    theirs: object,
    their_caps: object,
) -> Tuple[Tuple[int, int], FrozenSet[str]]:
    """Intersect two hellos into the effective ``(version, caps)``.

    A peer that sent no hello (``theirs is None`` — a pre-handshake
    build) negotiates as the ``(major, 1.0-minor)`` baseline with zero
    capabilities: old peers keep working, they just get v1 encodings.
    Raises :class:`NegotiationError` on a major mismatch.
    """
    if theirs is None:
        return ((ours[0], 0), frozenset())
    try:
        their_major, their_minor = int(theirs[0]), int(theirs[1])
    except (TypeError, ValueError, IndexError):
        raise NegotiationError(f"malformed peer proto version {theirs!r}")
    if their_major != ours[0]:
        raise NegotiationError(
            f"incompatible protocol major: ours {ours[0]}.{ours[1]}, "
            f"peer {their_major}.{their_minor}"
        )
    caps = frozenset(our_caps) & frozenset(
        c for c in (their_caps or ()) if isinstance(c, str)
    )
    return ((ours[0], min(ours[1], their_minor)), caps)
