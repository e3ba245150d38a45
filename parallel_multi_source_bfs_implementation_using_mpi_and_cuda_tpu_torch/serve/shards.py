"""Cross-replica graph sharding: the planner behind "Sharded graphs".

The port's copy of the JAX package's serve/shards.py: from the same input
file it writes byte-equal shard artifacts and the same manifest.

The fleet (serve/fleet.py) replicates WHOLE graphs onto single replicas;
this module shards at the fleet layer: a graph whose artifact
footprint exceeds ``MSBFS_SHARD_MAX_BYTES`` is planned into contiguous
ROW-RANGE shards — each an ordinary reference-format ``.bin`` artifact
(utils/io.py) carrying the full vertex space and exactly the adjacency
records of its own rows — placed on distinct fleet members through the
existing :class:`~.ring.PlacementRing` with ``MSBFS_SHARD_REPLICAS``
copies each.  The row split is edge-balanced
(:func:`edge_balanced_row_splits`, the JAX package's 2D mesh seam in
parallel/partition2d.py, copied here): a power-law graph split by
row COUNT would land the whole hub block in one shard, and a shard's
cost is its adjacency bytes, not its row count.

Because each shard is a plain registered graph under a derived name
(``<graph>#shard<i>``), every existing fleet mechanism applies verbatim:
rendezvous placement, digest-verified (re-)registration, journal replay
on replica restart, and the minimal-movement reheal when a member dies —
"re-replicate the lost shard" IS "reconcile the shard's ring owners",
recorded in the fleet manifest journal and epoch-bumped so in-flight
frames against the old placement are refusable (docs/SERVING.md
"Sharded graphs").

Failure posture: artifact writes hit the ``shard_write`` fault seam
(``disk_full:shard``, utils/faults.py) and convert ENOSPC/short-write
into the typed :class:`~..runtime.supervisor.StorageError` instead of
crashing the planner's daemon (docs/RESILIENCE.md "Disk exhaustion").
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..runtime.supervisor import InputError, StorageError
from ..utils import faults
from ..utils.io import GRAPH_HEADER, load_graph_bin, save_graph_bin

# Derived-name grammar: "<graph>#shard<i>".  '#' keeps shard names out
# of the ordinary registration namespace by convention (nothing stops an
# operator naming a whole graph this way, so the planner refuses parents
# containing the marker rather than trusting the convention blindly).
SHARD_SEP = "#shard"

# One reference-format edge record: two int32s (utils/io.py).
RECORD_BYTES = 8


def edge_balanced_row_splits(row_offsets, num_parts: int) -> List[int]:
    """Row boundaries splitting a CSR's vertex space into ``num_parts``
    contiguous ranges of roughly equal DIRECTED-EDGE weight: boundary k
    is the first row whose cumulative edge count reaches k/num_parts of
    the total.  Returns ``num_parts + 1`` monotone boundaries with
    ``[0] ... [n]`` at the ends — range i is ``[out[i], out[i+1])``.
    Degenerate rows (n < num_parts) yield empty trailing ranges rather
    than an error; callers drop empty ranges."""
    ro = np.asarray(row_offsets, dtype=np.int64)
    n = ro.shape[0] - 1
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    total = int(ro[-1])
    targets = (total * np.arange(1, num_parts, dtype=np.int64)) // num_parts
    cuts = np.searchsorted(ro, targets, side="left")
    out = [0] + [int(min(c, n)) for c in cuts] + [n]
    for i in range(1, len(out)):  # monotone under ties/empty rows
        out[i] = max(out[i], out[i - 1])
    return out


def shard_name(graph: str, index: int) -> str:
    return f"{graph}{SHARD_SEP}{index}"


def is_shard_name(name: str) -> bool:
    return SHARD_SEP in name


def parent_of(name: str) -> str:
    return name.split(SHARD_SEP, 1)[0]


@dataclass(frozen=True)
class ShardInfo:
    """One row-range shard: a registered-artifact identity plus the
    global row interval [lo, hi) it owns complete adjacency for."""

    name: str  # derived registration name, "<graph>#shard<i>"
    index: int
    path: str  # artifact on disk (reference .bin format)
    digest: str  # content hash of the artifact (ring key + integrity)
    lo: int
    hi: int
    records: int  # directed edge records written

    def describe(self) -> dict:
        return {
            "name": self.name,
            "digest": self.digest,
            "rows": [self.lo, self.hi],
            "records": self.records,
        }


@dataclass
class ShardPlan:
    """A graph's complete shard topology: what the supervisor places,
    the router scatters over, and the manifest journal records."""

    graph: str
    digest: str  # parent artifact's content hash
    n: int  # full vertex space (every shard shares it)
    replicas: int  # copies wanted per shard (MSBFS_SHARD_REPLICAS)
    shards: List[ShardInfo]

    def shard_for_row(self, row: int) -> ShardInfo:
        for s in self.shards:
            if s.lo <= row < s.hi:
                return s
        raise InputError(
            f"row {row} outside graph {self.graph!r}'s vertex space "
            f"[0, {self.n})"
        )

    def to_record(self) -> dict:
        """The manifest journal record (serve/journal.py op "shard")."""
        return {
            "op": "shard",
            "name": self.graph,
            "hash": self.digest,
            "n": self.n,
            "replicas": self.replicas,
            "shards": [
                {
                    "name": s.name,
                    "path": s.path,
                    "hash": s.digest,
                    "lo": s.lo,
                    "hi": s.hi,
                }
                for s in self.shards
            ],
        }

    @classmethod
    def from_manifest(cls, graph: str, manifest: dict) -> "ShardPlan":
        """Rebuild a plan from a replayed manifest record (the shape
        :meth:`~.journal.StateJournal._apply` validated)."""
        shards = [
            ShardInfo(
                name=row["name"],
                index=i,
                path=row["path"],
                digest=row["hash"],
                lo=int(row["lo"]),
                hi=int(row["hi"]),
                records=0,  # not journaled; observability only
            )
            for i, row in enumerate(manifest["shards"])
        ]
        return cls(
            graph=graph,
            digest=manifest["hash"],
            n=int(manifest["n"]),
            replicas=int(manifest["replicas"]),
            shards=shards,
        )

    def describe(self) -> dict:
        return {
            "digest": self.digest,
            "n": self.n,
            "replicas": self.replicas,
            "shards": [s.describe() for s in self.shards],
        }


def artifact_footprint(path: str) -> int:
    """The planner's sharding gate: the registered artifact's on-disk
    bytes.  Deliberately the FILE size, not the in-memory CSR — the cap
    knob talks about what a replica must hold, and the artifact is the
    portable unit of placement and digest verification."""
    return os.path.getsize(path)


def plan_shards(
    graph: str,
    path: str,
    out_dir: str,
    max_bytes: int,
    replicas: int = 2,
    digest: Optional[str] = None,
) -> Optional[ShardPlan]:
    """Plan ``path`` into row-range shard artifacts under ``out_dir``
    when its footprint exceeds ``max_bytes``; None = serve whole (the
    default single-replica path).  Deterministic for a given artifact:
    same bytes -> same split -> same shard digests, which is what lets a
    resurrected supervisor re-plan instead of trusting a lost manifest.

    Shard i's artifact holds one directed record per adjacency entry of
    rows [lo_i, hi_i) — complete out-adjacency for its own rows.  The
    loader's undirected doubling re-inserts each record's reverse, so a
    loaded shard also carries PARTIAL adjacency for out-of-range rows;
    the ``shard_step`` verb refuses to expand those (serve/server.py).
    """
    from .registry import content_hash  # lazy: registry imports io too

    if max_bytes <= 0:
        return None
    if is_shard_name(graph):
        raise InputError(
            f"graph name {graph!r} contains the reserved shard marker "
            f"{SHARD_SEP!r}"
        )
    if replicas < 1:
        raise InputError(f"shard replicas must be >= 1, got {replicas}")
    if artifact_footprint(path) <= max_bytes:
        return None
    # The native loader (the JAX package decodes with NumPy here): the
    # same CSR bytes, so the same shards, in a fraction of the time.
    g = load_graph_bin(path)
    if getattr(g, "has_weights", False):
        raise InputError(
            f"graph {graph!r} carries a weight section; sharded serving "
            "is unit-cost only — raise MSBFS_SHARD_MAX_BYTES to serve "
            "it whole, or strip the weights"
        )
    directed = int(g.num_directed_edges)
    est_total = GRAPH_HEADER.size + RECORD_BYTES * directed
    num = max(2, -(-est_total // max_bytes))
    num = min(num, max(1, g.n))
    bounds = edge_balanced_row_splits(g.row_offsets, num)
    parent_digest = digest or content_hash(path)
    os.makedirs(out_dir, exist_ok=True)
    ro = np.asarray(g.row_offsets, dtype=np.int64)
    ci = np.asarray(g.col_indices, dtype=np.int64)
    shards: List[ShardInfo] = []
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        if lo >= hi:
            continue  # degenerate split tail (n < num)
        src = np.repeat(
            np.arange(lo, hi, dtype=np.int64), np.diff(ro[lo : hi + 1])
        )
        dst = ci[ro[lo] : ro[hi]]
        edges = np.stack([src, dst], axis=1).astype(np.int32)
        sname = shard_name(graph, len(shards))
        spath = os.path.join(out_dir, f"shard{len(shards):04d}.bin")
        try:
            faults.trip("shard_write")  # disk_full:shard (utils/faults)
            save_graph_bin(spath, g.n, edges)
        except OSError as exc:
            raise StorageError(
                f"shard artifact write to {spath} failed: {exc} — "
                f"graph {graph!r} stays unsharded and unregistered; "
                "free disk and re-register"
            ) from exc
        shards.append(
            ShardInfo(
                name=sname,
                index=len(shards),
                path=spath,
                digest=content_hash(spath),
                lo=int(lo),
                hi=int(hi),
                records=int(edges.shape[0]),
            )
        )
    if len(shards) < 2:
        # Everything collapsed into one range (tiny n, hub graph): a
        # single shard is just the whole graph with extra steps.
        return None
    return ShardPlan(
        graph=graph,
        digest=parent_digest,
        n=int(g.n),
        replicas=int(replicas),
        shards=shards,
    )


def scatter_frontier(
    plan: ShardPlan, frontier: Sequence[np.ndarray]
) -> Dict[int, List[List[int]]]:
    """Split per-query frontier vertex arrays by owning shard: the
    row-gather half of the 2D mesh's row-gather/OR-merge discipline,
    rebuilt over the wire.  Returns {shard index: per-query vertex
    lists}, with shards whose row range the frontier never touches
    absent (no fragment, no wire)."""
    out: Dict[int, List[List[int]]] = {}
    for si, s in enumerate(plan.shards):
        rows = [
            [int(v) for v in verts[(verts >= s.lo) & (verts < s.hi)]]
            for verts in frontier
        ]
        if any(rows):
            out[si] = rows
    return out


def or_merge_fragments(
    n: int, fragments: Sequence[Sequence[Sequence[int]]], k: int
) -> List[np.ndarray]:
    """OR-merge shard fragments into one per-query neighbor set: the
    merge half of the row-gather/OR-merge discipline.  Duplicate
    neighbors across fragments (a vertex adjacent to rows in two
    shards) collapse — the OR is idempotent, which is also why a
    hedged/duplicated fragment answer is safe to merge twice."""
    merged: List[np.ndarray] = []
    for q in range(k):
        parts = [
            np.asarray(frag[q], dtype=np.int64)
            for frag in fragments
            if len(frag) > q and len(frag[q])
        ]
        merged.append(
            np.unique(np.concatenate(parts))
            if parts
            else np.zeros(0, dtype=np.int64)
        )
    return merged


__all__ = [
    "SHARD_SEP",
    "ShardInfo",
    "ShardPlan",
    "artifact_footprint",
    "edge_balanced_row_splits",
    "is_shard_name",
    "or_merge_fragments",
    "parent_of",
    "plan_shards",
    "scatter_frontier",
    "shard_name",
]
