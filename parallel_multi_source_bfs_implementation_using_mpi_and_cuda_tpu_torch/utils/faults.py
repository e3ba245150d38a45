"""Deterministic fault injection for the resilient execution runtime.

The port's copy of the JAX package's utils/faults.py, for the batch CLI:
a seeded, replayable plan of injected faults that the runtime's seams
consult at well-known sites, so every recovery path of
:mod:`..runtime.supervisor` can be rehearsed on the CPU.

Grammar (``MSBFS_FAULTS`` / :meth:`FaultPlan.parse`)::

    MSBFS_FAULTS="<kind>:<site>:<n>[,<kind>:<site>:<n>...]"

Each spec arms one fault that fires exactly once, on the ``n``-th trip
(1-based) of its site (``poison`` fires on every matching trip from the
``n``-th on).  The sites the port trips: ``load_graph`` / ``load_query``
(the binary loaders, utils/io.py, before any decode), ``dispatch`` (every
supervised engine call, runtime/supervisor.py), ``plane<i>`` (the ELL
route's chunk boundaries, ops/bfs.py) and ``dist`` (the supervisor's
result seam).  Kinds that fire here:

``io``         raise ``IOError``;
``corrupt``    raise ``ValueError``;
``oom``        raise a simulated ``RESOURCE_EXHAUSTED`` error, classified
               as ``CapacityError``: the supervisor steps down its ladder;
``transient``  raise a simulated ``UNAVAILABLE`` error, retried;
``hang``       stall ``MSBFS_FAULT_HANG`` seconds (default 60), then raise
               ``UNAVAILABLE``, so the dispatch watchdog fires first;
``chip``       site ``rank<r>``, trips on ``dispatch``: a simulated chip
               loss carrying ``failed_ranks={r}`` (``DeviceError``);
``crash``      ``os._exit(137)``: a process death with no cleanup;
``poison``     site ``vertex<v>``, trips on ``dispatch``: fails every
               dispatch whose query batch holds ``v``;
``bitflip``    site ``plane<i>``, ``dist`` or ``wplane``: flips one
               deterministic bit of a live buffer (:func:`corrupt`).

The serving daemon and the fleet (serve/) add the seams of the JAX
package's serving runtime:

``disk_full``  site ``journal``: trips inside ``StateJournal.append``
               (the ``journal_append`` site) and raises
               :class:`SimulatedDiskFull`, an ``OSError`` with the ENOSPC
               shape, which the journal turns into ``StorageError``;
               ``journal_append`` / ``journal_replay`` are also the sites
               where ``crash`` and the other raising kinds rehearse the
               journal;
``wire_corrupt``  site ``route<r>``: arms a thread-local taint that the
               next ``protocol.send_frame`` consumes, flipping one body
               bit after the crc32 was computed;
``net_partition``, ``net_delay``, ``net_dup``, ``net_reorder``,
``half_open``  arm thread-local frame filters that ``send_frame`` /
               ``recv_frame`` consume (:func:`arm_frame_chaos`,
               :func:`arm_read_blackhole`, :func:`heal`).

``replica_kill``  site ``replica<r>``: tripped by the fleet supervisor's
               heartbeat of replica ``r``; raises
               :class:`SimulatedReplicaKill`, and the supervisor SIGKILLs
               the replica's process;
``replica_slow``  site ``route<r>``: tripped by the router's forwarding
               attempt to replica ``r``; stalls it ``MSBFS_FAULT_SLOW``
               seconds (default 0.25) once, then the call proceeds;
``net_drop``   site ``route<r>``: raises :class:`SimulatedNetDrop` before
               the attempt sends a byte (UNAVAILABLE: the router fails
               over);
``host_down``  site a bare host label: tripped once a heartbeat per
               distinct host label of the fleet; raises
               :class:`SimulatedHostDown`, and the supervisor SIGKILLs
               every replica advertising the label;
``disk_full``  site ``shard``: trips inside the shard artifact writer
               (``shard_write``, serve/shards.py); the planner turns the
               ENOSPC into ``StorageError``.

The batch CLI and a single daemon trip none of the fleet's sites.
"""

from __future__ import annotations

import os
import re
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

KINDS = ("io", "corrupt", "oom", "transient", "hang", "chip", "crash",
         "poison", "replica_kill", "replica_slow", "net_drop", "bitflip",
         "wire_corrupt", "host_down", "net_partition", "net_delay",
         "net_dup", "net_reorder", "half_open", "disk_full")

# disk_full's site names the durable-write seam, not the trip string.
_DISK_FULL_SITES = {"journal": "journal_append", "shard": "shard_write"}

_RANK_RE = re.compile(r"rank(\d+)\Z")
_VERTEX_RE = re.compile(r"vertex(\d+)\Z")
_REPLICA_RE = re.compile(r"replica(\d+)\Z")
_ROUTE_RE = re.compile(r"route(\d+)\Z")
_PLANE_RE = re.compile(r"plane(\d+)\Z")
_HOST_RE = re.compile(r"[A-Za-z0-9._-]+\Z")


class SimulatedResourceExhausted(RuntimeError):
    """Stands in for a device out-of-memory error (the message carries
    RESOURCE_EXHAUSTED, which classification keys on)."""


class SimulatedUnavailable(RuntimeError):
    """Stands in for a transient runtime error: succeeds if tried again."""


class SimulatedChipLoss(RuntimeError):
    """A device disappearing mid-batch; carries the failed rank set."""

    def __init__(self, msg: str, failed_ranks):
        super().__init__(msg)
        self.failed_ranks = frozenset(int(r) for r in failed_ranks)


class SimulatedReplicaKill(RuntimeError):
    """A whole serving replica dying on cue (the fleet supervisor's
    heartbeat seam); carries the replica index."""

    def __init__(self, msg: str, replica: int):
        super().__init__(msg)
        self.replica = int(replica)


class SimulatedNetDrop(RuntimeError):
    """The network path to one replica going away before the request is
    sent; the message carries the UNAVAILABLE mark (transient)."""

    def __init__(self, msg: str, replica: int):
        super().__init__(msg)
        self.replica = int(replica)


class SimulatedHostDown(RuntimeError):
    """A whole host going dark at once; carries the host label."""

    def __init__(self, msg: str, host: str):
        super().__init__(msg)
        self.host = str(host)


class SimulatedPartitionDrop(SimulatedNetDrop):
    """A frame dropped at an armed ``net_partition`` cut; carries both
    sides of the cut."""

    def __init__(self, msg: str, replica: int, side: str, target_side: str):
        super().__init__(msg, replica)
        self.side = str(side)
        self.target_side = str(target_side)


class SimulatedHalfOpen(RuntimeError):
    """A read against a half-open connection: the request went into a
    black hole and the response never comes (TIMED OUT: transient)."""

    def __init__(self, msg: str, replica: int):
        super().__init__(msg)
        self.replica = int(replica)


class SimulatedDiskFull(OSError):
    """A durable write that hit the end of the disk: ENOSPC, an
    ``OSError`` the journal's own handler turns into ``StorageError``."""

    def __init__(self, msg: str):
        import errno

        super().__init__(errno.ENOSPC, msg)


class SimulatedPoison(RuntimeError):
    """A query whose content deterministically kills its dispatch.  It
    carries no taxonomy mark: it classifies as the base ``MsbfsError``."""


@dataclass
class FaultSpec:
    kind: str
    site: str
    at: int  # fires on the at-th trip of trip_site, 1-based
    rank: Optional[int] = None  # chip faults only
    vertex: Optional[int] = None  # poison faults only
    replica: Optional[int] = None  # fleet faults
    host: Optional[str] = None  # host_down faults only
    fired: bool = False
    matches: int = 0  # poison/partition/delay: matching trips so far
    groups: Optional[tuple] = None  # net_partition: (frozenset, frozenset)
    delay_ms: int = 0  # net_delay: injected per-frame latency
    healed: bool = False  # net_partition: True once heal() lifted the cut

    @property
    def trip_site(self) -> str:
        # Chips die during dispatches, and poison is a property of the
        # dispatched data; both specs' sites name which rank/vertex.
        if self.kind in ("chip", "poison"):
            return "dispatch"
        if self.kind == "disk_full":
            return _DISK_FULL_SITES[self.site]
        return self.site


class FaultPlan:
    """An armed set of :class:`FaultSpec` with per-site trip counters.
    Thread-safe: the dispatch seam runs inside the supervisor's watchdog
    thread, so counter updates take a lock (the fire happens outside)."""

    def __init__(self, specs, hang_seconds: float = 60.0,
                 slow_seconds: float = 0.25):
        self.specs: List[FaultSpec] = list(specs)
        self.hang_seconds = float(hang_seconds)
        self.slow_seconds = float(slow_seconds)
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str, hang_seconds: float = 60.0,
              slow_seconds: float = 0.25) -> "FaultPlan":
        """Parse the ``kind:site:n`` grammar; a malformed spec raises
        ``ValueError`` with the JAX package's message."""
        specs = []
        for raw in text.split(","):
            raw = raw.strip()
            if not raw:
                continue
            parts = raw.split(":")
            if len(parts) != 3:
                raise ValueError(
                    f"fault spec {raw!r}: want <kind>:<site>:<n>"
                )
            kind, site, n = parts
            if kind not in KINDS:
                raise ValueError(
                    f"fault spec {raw!r}: unknown kind {kind!r} "
                    f"(one of {', '.join(KINDS)})"
                )
            try:
                at = int(n)
            except ValueError:
                raise ValueError(f"fault spec {raw!r}: trip count {n!r} "
                                 "is not an integer") from None
            if at < 1:
                raise ValueError(f"fault spec {raw!r}: trip count must be >= 1")
            rank = None
            vertex = None
            if kind == "chip":
                m = _RANK_RE.match(site)
                if not m:
                    raise ValueError(
                        f"fault spec {raw!r}: chip faults need site "
                        "rank<r> (e.g. chip:rank1:1)"
                    )
                rank = int(m.group(1))
            if kind == "poison":
                m = _VERTEX_RE.match(site)
                if not m:
                    raise ValueError(
                        f"fault spec {raw!r}: poison faults need site "
                        "vertex<v> (e.g. poison:vertex7:1)"
                    )
                vertex = int(m.group(1))
            replica = None
            if kind == "replica_kill":
                m = _REPLICA_RE.match(site)
                if not m:
                    raise ValueError(
                        f"fault spec {raw!r}: replica_kill faults need "
                        "site replica<r> (e.g. replica_kill:replica0:3)"
                    )
                replica = int(m.group(1))
            if kind in ("replica_slow", "net_drop", "wire_corrupt",
                        "net_dup", "net_reorder", "half_open",
                        "net_delay"):
                m = _ROUTE_RE.match(site)
                if not m:
                    raise ValueError(
                        f"fault spec {raw!r}: {kind} faults need site "
                        f"route<r> (e.g. {kind}:route1:1)"
                    )
                replica = int(m.group(1))
            delay_ms = 0
            if kind == "net_delay":
                # The third slot is milliseconds, not a trip count.
                delay_ms = at
                at = 1
            groups = None
            if kind == "net_partition":
                halves = site.split("|")
                if len(halves) != 2 or not all(halves):
                    raise ValueError(
                        f"fault spec {raw!r}: net_partition needs site "
                        "<groupA|groupB> with '.'-joined route members "
                        "(e.g. net_partition:route0.route1|route2:1)"
                    )
                parsed_groups = []
                for half in halves:
                    members = set()
                    for member in half.split("."):
                        m = _ROUTE_RE.match(member)
                        if not m:
                            raise ValueError(
                                f"fault spec {raw!r}: net_partition "
                                f"group member {member!r} is not "
                                "route<r>"
                            )
                        members.add(int(m.group(1)))
                    parsed_groups.append(frozenset(members))
                if parsed_groups[0] & parsed_groups[1]:
                    both = sorted(parsed_groups[0] & parsed_groups[1])
                    raise ValueError(
                        f"fault spec {raw!r}: routes {both} appear on "
                        "both sides of the partition"
                    )
                groups = tuple(parsed_groups)
            if kind == "bitflip" and site not in ("dist", "wplane") \
                    and not _PLANE_RE.match(site):
                raise ValueError(
                    f"fault spec {raw!r}: bitflip faults need site "
                    "plane<i>, dist or wplane (e.g. bitflip:plane0:1, "
                    "bitflip:dist:1, bitflip:wplane:1)"
                )
            if kind == "disk_full" and site not in _DISK_FULL_SITES:
                raise ValueError(
                    f"fault spec {raw!r}: disk_full faults need site "
                    f"{' or '.join(sorted(_DISK_FULL_SITES))} "
                    "(e.g. disk_full:journal:1)"
                )
            host = None
            if kind == "host_down":
                if not _HOST_RE.match(site):
                    raise ValueError(
                        f"fault spec {raw!r}: host_down faults need a "
                        "host label site of [A-Za-z0-9._-]+ "
                        "(e.g. host_down:hostA:1)"
                    )
                host = site
            specs.append(FaultSpec(kind=kind, site=site, at=at, rank=rank,
                                   vertex=vertex, replica=replica,
                                   host=host, groups=groups,
                                   delay_ms=delay_ms))
        return cls(specs, hang_seconds=hang_seconds,
                   slow_seconds=slow_seconds)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """Plan from ``MSBFS_FAULTS`` (with ``MSBFS_FAULT_HANG`` and
        ``MSBFS_FAULT_SLOW``), or None when unset or empty."""
        from . import knobs

        raw = knobs.raw("MSBFS_FAULTS", "").strip()
        if not raw:
            return None
        return cls.parse(
            raw,
            hang_seconds=knobs.get_float("MSBFS_FAULT_HANG", 60.0),
            slow_seconds=knobs.get_float("MSBFS_FAULT_SLOW", 0.25),
        )

    def reset(self) -> None:
        """Re-arm every spec and zero the counters (replay)."""
        with self._lock:
            self.counters.clear()
            for s in self.specs:
                s.fired = False
                s.matches = 0
                s.healed = False

    @staticmethod
    def _poison_match(spec: FaultSpec, context) -> bool:
        """True when the dispatched payload (a 2-D integer query batch)
        contains the poisoned vertex; other payloads never match."""
        if context is None:
            return False
        try:
            arr = np.asarray(context)
        except Exception:  # noqa: BLE001 — non-array payloads never match
            return False
        return (
            arr.ndim == 2
            and arr.dtype.kind in "iu"
            and bool((arr == spec.vertex).any())
        )

    def trip(self, site: str, context=None) -> None:
        """One execution of ``site``: count it and fire any spec due at
        this count.  ``context`` is the site's payload (the query batch
        at ``dispatch``); only ``poison`` reads it, and fires on every
        matching trip from its ``at``-th match on."""
        with self._lock:
            count = self.counters.get(site, 0) + 1
            self.counters[site] = count
            due = [
                s
                for s in self.specs
                # bitflip is delivered by corrupt(); poison and the
                # repeating network kinds have their own matches below.
                if s.kind not in ("poison", "bitflip", "net_partition",
                                  "net_delay")
                and s.trip_site == site
                and s.at == count
                and not s.fired
            ]
            for s in due:
                s.fired = True
            route = _ROUTE_RE.match(site)
            route_idx = int(route.group(1)) if route else None
            for s in self.specs:
                if (
                    s.kind == "poison"
                    and s.trip_site == site
                    and self._poison_match(s, context)
                ):
                    s.matches += 1
                    if s.matches >= s.at:
                        due.append(s)
                elif s.kind == "net_delay" and s.trip_site == site:
                    # A slow link delays every frame, never one-shot.
                    s.matches += 1
                    s.fired = True
                    due.append(s)
                elif (
                    s.kind == "net_partition"
                    and not s.healed
                    and route_idx is not None
                    and (route_idx in s.groups[0]
                         or route_idx in s.groups[1])
                ):
                    # Latched: from the at-th trip of any member route on,
                    # every crossing frame drops until heal().
                    s.matches += 1
                    if s.matches >= s.at and _crosses(s, route_idx):
                        s.fired = True
                        due.append(s)
        for s in due:  # outside the lock: hangs sleep, fires raise
            self._fire(s, tripped_site=site)

    def pending(self) -> List[FaultSpec]:
        with self._lock:
            return [s for s in self.specs if not s.fired]

    def bitflip_armed(self) -> bool:
        """True while any bitflip spec is still unfired."""
        return any(s.kind == "bitflip" and not s.fired for s in self.specs)

    def corrupt(self, site: str, arr):
        """The mutating seam: one execution of ``site`` against ``arr``.
        Counts the trip like :meth:`trip`; when a ``bitflip`` spec is due
        returns a NumPy copy of ``arr`` with one deterministic bit flipped
        (:func:`_flip_bit`), else ``arr`` itself."""
        with self._lock:
            count = self.counters.get(site, 0) + 1
            self.counters[site] = count
            due = [
                s
                for s in self.specs
                if s.kind == "bitflip"
                and s.site == site
                and s.at == count
                and not s.fired
            ]
            for s in due:
                s.fired = True
        if not due:
            return arr
        return _flip_bit(arr, site)

    def heal(self) -> None:
        """Lift every armed ``net_partition``: crossing frames flow
        again.  Counters and every other spec are untouched."""
        with self._lock:
            for s in self.specs:
                if s.kind == "net_partition":
                    s.healed = True

    def _fire(self, s: FaultSpec, tripped_site: Optional[str] = None) -> None:
        where = f"at {s.site} (trip {s.at})"
        if s.kind == "io":
            raise IOError(f"injected io fault {where}")
        if s.kind == "corrupt":
            raise ValueError(f"injected corrupt input {where}")
        if s.kind == "oom":
            raise SimulatedResourceExhausted(
                f"RESOURCE_EXHAUSTED: injected oom {where}"
            )
        if s.kind == "transient":
            raise SimulatedUnavailable(
                f"UNAVAILABLE: injected transient fault {where}"
            )
        if s.kind == "hang":
            time.sleep(self.hang_seconds)
            raise SimulatedUnavailable(
                f"UNAVAILABLE: injected hang {where} released after "
                f"{self.hang_seconds:g}s"
            )
        if s.kind == "chip":
            raise SimulatedChipLoss(
                f"injected chip loss: rank {s.rank} {where}", {s.rank}
            )
        if s.kind == "crash":
            # kill -9 semantics: no atexit, no finally, no flushes.
            os._exit(137)
        if s.kind == "poison":
            raise SimulatedPoison(
                f"injected poison query: batch contains vertex "
                f"{s.vertex} {where}"
            )
        if s.kind == "replica_kill":
            raise SimulatedReplicaKill(
                f"injected replica kill: replica {s.replica} {where}",
                s.replica,
            )
        if s.kind == "replica_slow":
            # A straggler, not a failure: the routed call proceeds after
            # the stall, so only hedging (or the deadline) saves the tail.
            time.sleep(self.slow_seconds)
            return
        if s.kind == "net_drop":
            raise SimulatedNetDrop(
                f"UNAVAILABLE: injected net drop to replica "
                f"{s.replica} {where}",
                s.replica,
            )
        if s.kind == "host_down":
            raise SimulatedHostDown(
                f"injected host down: host {s.host} {where}", s.host
            )
        if s.kind == "disk_full":
            raise SimulatedDiskFull(
                f"injected disk full: no space left on device {where}"
            )
        if s.kind == "wire_corrupt":
            # Not a raise: the call proceeds so the corrupt frame crosses
            # the wire and the receiver's crc32 check catches it.
            arm_wire_corruption()
            return
        # The frame-level network kinds arm thread-local filters that the
        # protocol seam (serve/protocol.py) consumes at the actual frame.
        if s.kind == "net_partition":
            m = _ROUTE_RE.match(tripped_site or "")
            target = int(m.group(1)) if m else (s.replica or 0)
            target_side = "A" if target in s.groups[0] else "B"
            arm_frame_chaos("drop", replica=target, spec=s,
                            side=net_side.current(), target_side=target_side)
            return
        if s.kind == "net_delay":
            arm_frame_chaos("delay", replica=s.replica,
                            delay_ms=s.delay_ms, spec=s)
            return
        mode = {"net_dup": "dup", "net_reorder": "reorder",
                "half_open": "half_open"}.get(s.kind)
        if mode is not None:
            arm_frame_chaos(mode, replica=s.replica, spec=s)
            return
        raise AssertionError(f"unreachable kind {s.kind!r}")


# ---- process-wide active plan (the seams' lookup point) -------------------
_active: Optional[FaultPlan] = None


def activate(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` as the process-wide plan (None clears).  The CLI
    installs a fresh plan from the environment on every ``main()`` call."""
    global _active
    _active = plan
    if plan is not None:
        plan.reset()


def active_plan() -> Optional[FaultPlan]:
    return _active


def trip(site: str, context=None) -> None:
    """Seam entry point: a no-op when no plan is active."""
    if _active is not None:
        _active.trip(site, context)


def corruption_armed() -> bool:
    """Cheap gate for the mutating seams: True only while the active plan
    still has an unfired ``bitflip`` spec."""
    return _active is not None and _active.bitflip_armed()


def corrupt(site: str, arr):
    """Mutating seam entry point: ``arr``, or a NumPy copy with one bit
    flipped when a spec is due at ``site``."""
    if _active is None:
        return arr
    return _active.corrupt(site, arr)


def _flip_bit(arr, token: str):
    """A NumPy copy of ``arr`` with one bit flipped, its position
    ``zlib.crc32(token) % bits`` over the array's bytes — the JAX
    package's choice, so both flip the same bit of the same array.  A
    tensor is read back to the host (its logical layout, row-major)."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    out = np.array(arr, copy=True)
    flat = out.view(np.uint8).reshape(-1)
    if flat.size == 0:
        return out
    bit = zlib.crc32(token.encode()) % (flat.size * 8)
    flat[bit // 8] ^= np.uint8(1 << (bit % 8))
    return out


# ---- wire taint (wire_corrupt) --------------------------------------------
_WIRE_TAINT = threading.local()


def arm_wire_corruption() -> None:
    """Arm the thread-local taint: the next frame this thread sends has
    one body bit flipped after its crc32 is computed."""
    _WIRE_TAINT.armed = True


def consume_wire_taint() -> bool:
    """Check-and-clear the taint (called by ``protocol.send_frame``)."""
    armed = getattr(_WIRE_TAINT, "armed", False)
    _WIRE_TAINT.armed = False
    return armed


# ---- frame chaos (net_partition/net_delay/net_dup/net_reorder/half_open) --
# Armed at the trip, consumed at the protocol seam: a list of filters that
# the next send_frame on the thread applies in arm order.
_FRAME_CHAOS = threading.local()

_NET_SIDES = ("A", "B")


def _crosses(spec: FaultSpec, route_idx: int) -> bool:
    """True when the calling thread's side and ``route_idx``'s group sit
    on opposite shores of ``spec``'s partition."""
    target_side = "A" if route_idx in spec.groups[0] else "B"
    return net_side.current() != target_side


class net_side:
    """``with net_side("B"):`` — declare which shore of an armed
    ``net_partition`` this thread's traffic comes from (default "A")."""

    def __init__(self, side: str):
        side = str(side).upper()
        if side not in _NET_SIDES:
            raise ValueError(f"net_side {side!r}: want one of {_NET_SIDES}")
        self.side = side
        self._prev: Optional[str] = None

    @staticmethod
    def current() -> str:
        return getattr(_FRAME_CHAOS, "side", "A")

    def __enter__(self) -> "net_side":
        self._prev = getattr(_FRAME_CHAOS, "side", None)
        _FRAME_CHAOS.side = self.side
        return self

    def __exit__(self, *exc) -> None:
        _FRAME_CHAOS.side = "A" if self._prev is None else self._prev


def arm_frame_chaos(mode: str, replica=None, delay_ms: int = 0,
                    spec: Optional[FaultSpec] = None, side: str = "A",
                    target_side: str = "A") -> None:
    """Arm one thread-local frame filter; the next ``send_frame`` on this
    thread consumes the whole list."""
    pending = getattr(_FRAME_CHAOS, "pending", None)
    if pending is None:
        pending = _FRAME_CHAOS.pending = []
    pending.append({
        "mode": mode,
        "replica": replica,
        "delay_ms": int(delay_ms),
        "spec": spec,
        "side": side,
        "target_side": target_side,
    })


def consume_frame_chaos() -> list:
    """Check-and-clear the armed filter list (``send_frame``)."""
    pending = getattr(_FRAME_CHAOS, "pending", None)
    _FRAME_CHAOS.pending = []
    return pending or []


def peek_frame_chaos() -> list:
    """Non-consuming view of the armed filters (tests check a
    ``net_delay`` without paying its sleep)."""
    return list(getattr(_FRAME_CHAOS, "pending", None) or [])


def arm_read_blackhole(replica=None) -> None:
    """Arm the half-open read black hole: the next ``recv_frame`` on this
    thread raises :class:`SimulatedHalfOpen` instead of reading."""
    _FRAME_CHAOS.blackhole = -1 if replica is None else int(replica)


def consume_read_blackhole():
    """Check-and-clear the black hole (``recv_frame``): None when unarmed,
    else the armed replica index (-1 when unknown)."""
    armed = getattr(_FRAME_CHAOS, "blackhole", None)
    _FRAME_CHAOS.blackhole = None
    return armed


def raise_partition_drop(replica, side: str, target_side: str):
    """Deliver a consumed ``drop`` filter (called by ``send_frame``), so
    every ``Simulated*`` raise stays in this module."""
    raise SimulatedPartitionDrop(
        f"simulated network partition: frame to replica {replica} "
        "crossed the cut and was dropped (UNAVAILABLE)",
        replica if replica is not None else -1,
        side, target_side,
    )


def raise_half_open(replica: int):
    """Deliver a consumed read black hole (called by ``recv_frame``)."""
    raise SimulatedHalfOpen(
        "simulated half-open connection: the request to replica "
        f"{replica} was swallowed by a dead peer's socket and the "
        "read TIMED OUT",
        replica,
    )


def heal() -> None:
    """Lift every ``net_partition`` of the active plan (no-op without
    one)."""
    if _active is not None:
        _active.heal()


class injected:
    """``with injected(plan):`` — scoped activation for tests."""

    def __init__(self, plan: Optional[FaultPlan]):
        self.plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> Optional[FaultPlan]:
        self._prev = _active
        activate(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        activate(self._prev)
