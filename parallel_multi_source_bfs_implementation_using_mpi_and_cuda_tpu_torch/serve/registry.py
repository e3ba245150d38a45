"""Graph registry: load-once, device-resident, versioned.

The port's copy of the JAX package's serve/registry.py (its
docs/SERVING.md is the operator manual).  Each registered graph is keyed
by *name + content hash*: registering the same file under the same name
is a no-op (load-once), registering different bytes under an existing
name is refused (``reload`` means replacement).  ``reload`` re-reads the
file, rebuilds the engine and bumps the integer *version*; ``mutate``
appends an edge-delta batch (dynamic/delta.py) and swaps in an entry
serving the patched CSR, its chained digest in the key.  Every cache key
downstream includes the version and digest, so stale results are
unreachable by construction.

Engines are built on the registry's device (``cuda`` unless the caller
passes ``device="cpu"``) through the route choice of the JAX registry
(:func:`build_supervised_engine`), wrapped in the supervisor; the batch
CLI's ``verify`` uses the same builders.  The engines update their
carries in place, so every engine call on an entry holds the entry's
``engine_lock`` (serve/server.py).  A swapped-out entry's engine is
released when the last in-flight request drops its reference.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..runtime.supervisor import (
    ChunkSupervisor,
    CorruptionError,
    InputError,
    RetryPolicy,
)
from ..utils import knobs
from ..utils.io import load_graph_bin


def content_hash(path: str) -> str:
    """Streaming sha256 of the graph file (hex, 12 chars: an identity
    label, not a security boundary)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()[:12]


def audit_sample_rate() -> float:
    """``MSBFS_AUDIT``: ``off``/unset/``0`` disables, ``full``/``1`` audits
    every f_values call, a float in (0, 1) that sampled share; a malformed
    value is off."""
    raw = knobs.raw("MSBFS_AUDIT", "").strip().lower()
    if raw in ("", "off", "0"):
        return 0.0
    if raw in ("full", "1"):
        return 1.0
    try:
        rate = float(raw)
    except ValueError:
        return 0.0
    return min(max(rate, 0.0), 1.0)


def _supervise(engine, ladder=(), auditor=None, sample=0.0) -> ChunkSupervisor:
    """The batch CLI's supervisor knobs around ``engine``."""
    return ChunkSupervisor(
        engine,
        policy=RetryPolicy(
            max_retries=knobs.get_int("MSBFS_RETRIES", 2),
            base_delay=knobs.get_float("MSBFS_BACKOFF", 0.1),
            seed=knobs.get_int("MSBFS_FAULT_SEED", 0),
        ),
        watchdog=knobs.get_float("MSBFS_WATCHDOG", 0.0) or None,
        ladder=ladder,
        auditor=auditor,
        audit_sample=sample,
    )


# --- mxu tile-index cache ------------------------------------------------
# Densifying the adjacency into per-tile blocks is the mxu route's only
# host preprocessing cost.  The daemon keys graphs by content hash, so the
# packed MxuGraph is cached under (content digest, tile size, device): a
# warm reload of unchanged bytes reuses the device-resident tiles.  LRU
# with a byte cap (``MSBFS_MXU_CACHE_BYTES``, default 256 MiB; <= 0
# disables), sized by the packed tensors' bytes.

_MXU_CACHE_DEFAULT_BYTES = 256 << 20

_mxu_tile_cache: "OrderedDict[tuple, Tuple[object, int]]" = OrderedDict()
_mxu_tile_cache_lock = threading.Lock()
_mxu_tile_cache_hits = 0
_mxu_tile_cache_evictions = 0
_mxu_tile_cache_bytes = 0


def _mxu_cache_cap_bytes() -> int:
    return knobs.get_int("MSBFS_MXU_CACHE_BYTES", _MXU_CACHE_DEFAULT_BYTES)


def _mxu_graph_nbytes(mg) -> int:
    """Footprint of one packed tile index: its tensors' bytes."""
    total = 0
    for name in ("tiles", "tile_row", "tile_col", "row_ptr", "start", "count", "vals"):
        t = getattr(mg, name, None)
        if t is not None:
            total += int(t.numel()) * int(t.element_size())
    return max(total, 1)  # never let an entry count as free


def _cached_mxu_graph(graph, content_digest: Optional[str], device, native: bool = True):
    """MxuGraph for ``graph`` on ``device``, reusing the packed tile index
    when the serving content digest (and MSBFS_MXU_TILE) match a prior
    build."""
    global _mxu_tile_cache_hits, _mxu_tile_cache_evictions
    global _mxu_tile_cache_bytes
    from ..ops.mxu import MxuGraph, resolve_tile

    if content_digest is None:
        return MxuGraph.from_host(graph, device, native=native)
    key = (content_digest, resolve_tile(), str(device))
    with _mxu_tile_cache_lock:
        have = _mxu_tile_cache.get(key)
        if have is not None:
            _mxu_tile_cache.move_to_end(key)
            _mxu_tile_cache_hits += 1
            return have[0]
    mg = MxuGraph.from_host(graph, device, native=native)
    cap = _mxu_cache_cap_bytes()
    if cap <= 0:
        return mg
    size = _mxu_graph_nbytes(mg)
    with _mxu_tile_cache_lock:
        have = _mxu_tile_cache.get(key)
        if have is not None:  # lost the build race: reuse the winner
            _mxu_tile_cache.move_to_end(key)
            _mxu_tile_cache_hits += 1
            return have[0]
        _mxu_tile_cache[key] = (mg, size)
        _mxu_tile_cache_bytes += size
        # Oldest first down to the cap; an entry larger than the whole cap
        # evicts itself at once (the build still returns).
        while _mxu_tile_cache_bytes > cap and _mxu_tile_cache:
            _, (_, old_size) = _mxu_tile_cache.popitem(last=False)
            _mxu_tile_cache_bytes -= old_size
            _mxu_tile_cache_evictions += 1
    return mg


def mxu_tile_cache_stats() -> dict:
    """Entry count, hits, evictions, resident bytes and the byte cap."""
    with _mxu_tile_cache_lock:
        return {
            "entries": len(_mxu_tile_cache),
            "hits": _mxu_tile_cache_hits,
            "evictions": _mxu_tile_cache_evictions,
            "bytes": _mxu_tile_cache_bytes,
            "cap_bytes": _mxu_cache_cap_bytes(),
        }


def build_supervised_engine(graph, device=None, native: bool = True,
                            content_digest: Optional[str] = None) -> ChunkSupervisor:
    """The stock route under the supervisor: the stencil probe as the
    batch CLI runs it, else the engine lattice (``MSBFS_BACKEND`` vmap,
    mxu or lowk by name, ``csr`` as vmap, every other name bitbell, with
    its capacity ladder).  Audited against the host-CSR certificate when
    ``MSBFS_AUDIT`` is armed.

    The lattice's choice copies the JAX registry's, not the batch CLI's
    (``MSBFS_BACKEND=push`` runs bitbell here, as it does under JAX's
    ``verify``); the chunk policy, the stencil probe and the ladder are
    the CLI's own functions.  ``content_digest`` keys the mxu route's
    tile cache (serving passes the entry's digest)."""
    from ..cli import bitbell_ladder, chunk_policy, resolve_device, stencil_probe
    from ..models.bell import BellGraph
    from ..ops.bitbell import BitBellEngine
    from ..ops.engine import Engine, negotiate_engine, resolve_axes
    from ..ops.lowk import LowKEngine
    from ..ops.mxu import MxuEngine
    from ..ops.stencil import StencilEngine

    dev = resolve_device(device)
    explicit_chunk, level_chunk, megachunk = chunk_policy(graph)
    backend = knobs.raw("MSBFS_BACKEND", "auto")
    ladder = []
    probed = stencil_probe(graph, dev, backend, level_chunk, explicit_chunk)
    if probed is not None:
        sg, stencil_chunk = probed
        label = "stencil"
        engine = StencilEngine(sg, level_chunk=stencil_chunk, megachunk=megachunk)
    else:
        routed = backend if backend in ("vmap", "mxu", "lowk") else (
            "vmap" if backend == "csr" else "bitbell"
        )
        _, required = resolve_axes(routed)
        label, engine = negotiate_engine(
            required,
            [
                ("bitbell", BitBellEngine, lambda: BitBellEngine(
                    BellGraph.from_host(graph, dev, native=native),
                    level_chunk=level_chunk, megachunk=megachunk)),
                ("lowk", LowKEngine, lambda: LowKEngine(
                    BellGraph.from_host(graph, dev, native=native),
                    level_chunk=level_chunk, megachunk=megachunk)),
                ("mxu", MxuEngine, lambda: MxuEngine(
                    _cached_mxu_graph(graph, content_digest, dev, native),
                    level_chunk=level_chunk, megachunk=megachunk)),
                ("vmap", Engine, lambda: Engine(
                    graph.to_device(dev), level_chunk=level_chunk)),
            ],
        )
        if label == "bitbell":
            ladder = bitbell_ladder(graph, level_chunk, dev, native)
    sample = audit_sample_rate()
    auditor = None
    if sample > 0.0:
        from ..ops.certify import make_auditor

        auditor = make_auditor(graph)
    sup = _supervise(engine, ladder, auditor, sample)
    sup.engine_label = label
    return sup


def build_supervised_weighted_engine(graph, device=None, native: bool = True) -> ChunkSupervisor:
    """The weighted route under the supervisor: a delta-stepping engine
    negotiated by flavor (``MSBFS_WEIGHTED_ENGINE``), audited against the
    weighted certificate when ``MSBFS_AUDIT`` is armed.  Raises
    InputError on a weightless graph."""
    from ..cli import resolve_device
    from ..weighted import negotiate_weighted_engine

    _, engine = negotiate_weighted_engine(
        graph, device=resolve_device(device), native=native
    )
    sample = audit_sample_rate()
    auditor = None
    if sample > 0.0:
        from ..ops.certify import make_weighted_auditor

        auditor = make_weighted_auditor(graph)
    return _supervise(engine, auditor=auditor, sample=sample)


@dataclass
class GraphEntry:
    """One registered graph: host CSR + supervised device engine.

    ``deltas``/``delta_version`` carry the dynamic-graph version chain: a
    ``mutate`` appends to the :class:`..dynamic.delta.DeltaLog` and swaps
    in a new entry serving the patched CSR, with the chained content
    digest riding every cache key.  ``engine_lock`` serialises every
    engine call on the entry (warm-ups, dispatches, quarantine
    re-dispatches, the weighted engine's too): the engines update their
    device carries in place.
    """

    name: str
    path: str
    hash: str
    version: int
    graph: object
    supervisor: ChunkSupervisor
    device: object = None
    native: bool = True
    loaded_at: float = field(default_factory=time.time)
    lock: threading.Lock = field(default_factory=threading.Lock)
    engine_lock: threading.Lock = field(default_factory=threading.Lock)
    deltas: Optional[object] = None  # dynamic.delta.DeltaLog
    delta_version: int = 0
    # Built on first use: most registered graphs never see a weighted query.
    weighted_supervisor: Optional[ChunkSupervisor] = None

    def get_weighted_supervisor(self) -> ChunkSupervisor:
        """The entry's weighted serving engine, built on first use under
        the entry lock.  Raises InputError when the graph carries no cost
        section."""
        sup = self.weighted_supervisor
        if sup is not None:
            return sup
        with self.lock:
            if self.weighted_supervisor is None:
                self.weighted_supervisor = build_supervised_weighted_engine(
                    self.graph, self.device, self.native
                )
            return self.weighted_supervisor

    @property
    def digest(self) -> str:
        """The file hash at delta-version 0, the chained delta digest
        after a mutate."""
        if self.deltas is None or self.delta_version == 0:
            return self.hash
        return self.deltas.digest(self.delta_version)

    @property
    def key(self) -> str:
        """Cache-key stem: name, content hash and version, plus the
        chained delta digest after a mutate."""
        stem = f"{self.name}@{self.hash}/v{self.version}"
        if self.delta_version:
            stem += f"+m{self.delta_version}.{self.digest}"
        return stem

    def version_chain(self) -> list:
        """The ``versions`` verb payload: one row per delta version,
        digests chained from the base content hash."""
        out = [{"version": 0, "digest": self.hash, "inserts": 0, "deletes": 0}]
        if self.deltas is not None:
            out.extend(
                {
                    "version": int(b.version),
                    "digest": b.digest,
                    "inserts": int(b.inserts.shape[0]),
                    "deletes": int(b.deletes.shape[0]),
                }
                for b in self.deltas.batches
            )
        return out

    def describe(self) -> dict:
        return {
            "name": self.name,
            "path": self.path,
            "hash": self.hash,
            "version": self.version,
            "delta_version": self.delta_version,
            "digest": self.digest,
            "n": int(self.graph.n),
            "directed_edges": int(self.graph.num_directed_edges),
            "weighted": bool(getattr(self.graph, "has_weights", False)),
            "engine": getattr(self.supervisor, "engine_label", None),
            "loaded_at": round(self.loaded_at, 3),
        }


class GraphRegistry:
    """Named, versioned graph store behind the daemon's verbs, building
    every engine on ``device`` (``native=False`` runs the host
    preprocessing's NumPy versions)."""

    def __init__(self, device=None, native: bool = True):
        from ..cli import resolve_device

        self.device = resolve_device(device)
        self.native = native
        self._entries: Dict[str, GraphEntry] = {}
        self._lock = threading.Lock()

    def _entry(self, name: str, path: str, digest: str, version: int,
               graph, engine_digest: str, **extra) -> GraphEntry:
        return GraphEntry(
            name=name,
            path=path,
            hash=digest,
            version=version,
            graph=graph,
            supervisor=build_supervised_engine(
                graph, self.device, self.native, content_digest=engine_digest
            ),
            device=self.device,
            native=self.native,
            **extra,
        )

    def load(self, name: str, path: str, expected_hash: Optional[str] = None) -> GraphEntry:
        """Register ``path`` under ``name`` (load-once).  Same name + same
        bytes returns the existing entry; same name + different bytes is
        an InputError (use :meth:`reload`).  ``expected_hash`` (journal
        replay) refuses typed with :class:`CorruptionError` when the file
        no longer hashes to it."""
        digest = content_hash(path)
        if expected_hash is not None and digest != expected_hash:
            raise CorruptionError(
                f"graph {name!r} at {path} hashes to {digest}, but its "
                f"registration records {expected_hash}: the file changed "
                "underneath the journal — refusing to re-register "
                "silently different content",
                invariants=("content-digest",),
            )
        with self._lock:
            have = self._entries.get(name)
            if have is not None:
                if have.hash == digest:
                    return have
                raise InputError(
                    f"graph {name!r} is already registered with different "
                    f"content (have {have.hash}, file is {digest}); use "
                    "reload to replace it"
                )
        graph = load_graph_bin(path, native=self.native)
        entry = self._entry(name, path, digest, 1, graph, digest)
        with self._lock:
            # Lost-race rule: first registration wins.
            have = self._entries.get(name)
            if have is not None and have.hash == digest:
                return have
            if have is not None:
                raise InputError(
                    f"graph {name!r} was concurrently registered with "
                    "different content"
                )
            self._entries[name] = entry
        return entry

    def reload(self, name: str) -> GraphEntry:
        """Re-read the entry's path, rebuild the engine, bump version.
        In-flight requests against the old entry finish on the old
        engine, released when the last of them drops it."""
        with self._lock:
            have = self._entries.get(name)
        if have is None:
            raise InputError(f"no graph registered as {name!r}")
        digest = content_hash(have.path)
        graph = load_graph_bin(have.path, native=self.native)
        entry = self._entry(name, have.path, digest, have.version + 1, graph, digest)
        with self._lock:
            self._entries[name] = entry
        return entry

    def mutate(self, name: str, inserts, deletes) -> Tuple[GraphEntry, object]:
        """Append one edge-delta batch to ``name``'s version chain and
        swap in an entry serving the patched dedup CSR (bit-identical to a
        from-scratch rebuild).  Returns (new entry, appended batch).
        Callers serialise mutations per name; a concurrent reload loses
        the swap loudly."""
        from ..dynamic.delta import DeltaLog

        with self._lock:
            have = self._entries.get(name)
        if have is None:
            raise InputError(f"no graph registered as {name!r}")
        with have.lock:
            log = have.deltas
            if log is None:
                log = DeltaLog.from_graph(have.graph, have.hash, native=self.native)
            try:
                batch = log.append(inserts, deletes)
            except ValueError as exc:
                raise InputError(f"mutate {name!r}: {exc}")
            graph, _ = log.apply(native=self.native)
            entry = self._entry(
                name, have.path, have.hash, have.version, graph, batch.digest,
                deltas=log, delta_version=log.version,
            )
        with self._lock:
            cur = self._entries.get(name)
            if cur is not have:
                raise InputError(
                    f"graph {name!r} was replaced while mutating; "
                    "re-issue the mutation against the new registration"
                )
            self._entries[name] = entry
        return entry, batch

    def get(self, name: str) -> GraphEntry:
        with self._lock:
            entry = self._entries.get(name)
            have = sorted(self._entries)
        if entry is None:
            raise InputError(
                f"no graph registered as {name!r} "
                f"(have: {', '.join(have) or 'none'})"
            )
        return entry

    def maybe_get(self, name: str) -> Optional[GraphEntry]:
        with self._lock:
            return self._entries.get(name)

    def evict(self, name: str) -> Optional[GraphEntry]:
        """Drop a registration; in-flight requests against it finish on
        its engine."""
        with self._lock:
            return self._entries.pop(name, None)

    def describe(self) -> dict:
        with self._lock:
            entries = list(self._entries.values())
        return {e.name: e.describe() for e in entries}
