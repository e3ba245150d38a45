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

Every other kind of the JAX grammar (``replica_kill``, ``replica_slow``,
``net_drop``, ``wire_corrupt``, ``host_down``, ``net_partition``,
``net_delay``, ``net_dup``, ``net_reorder``, ``half_open``,
``disk_full``) parses with the same checks and messages, and fires
nowhere: its sites belong to the serving runtime, which the port does
not have yet — as in the JAX batch CLI, which never trips them either.
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
    healed: bool = False  # net_partition

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

    def __init__(self, specs, hang_seconds: float = 60.0):
        self.specs: List[FaultSpec] = list(specs)
        self.hang_seconds = float(hang_seconds)
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str, hang_seconds: float = 60.0) -> "FaultPlan":
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
        return cls(specs, hang_seconds=hang_seconds)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """Plan from ``MSBFS_FAULTS`` (with ``MSBFS_FAULT_HANG``), or None
        when unset or empty."""
        from . import knobs

        raw = knobs.raw("MSBFS_FAULTS", "").strip()
        if not raw:
            return None
        return cls.parse(raw, hang_seconds=knobs.get_float("MSBFS_FAULT_HANG", 60.0))

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
                # bitflip is delivered by corrupt(); poison has its own
                # match below; the latched network kinds never fire here.
                if s.kind not in ("poison", "bitflip", "net_partition",
                                  "net_delay")
                and s.trip_site == site
                and s.at == count
                and not s.fired
            ]
            for s in due:
                s.fired = True
            for s in self.specs:
                if (
                    s.kind == "poison"
                    and s.trip_site == site
                    and self._poison_match(s, context)
                ):
                    s.matches += 1
                    if s.matches >= s.at:
                        due.append(s)
        for s in due:  # outside the lock: hangs sleep, fires raise
            self._fire(s)

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

    def _fire(self, s: FaultSpec) -> None:
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
        raise NotImplementedError(
            f"{s.kind} faults fire at the serving runtime's seams, which "
            "are not yet ported to the PyTorch/CUDA package"
        )


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
