"""Incremental BFS repair: re-settle only the cone a delta invalidates.

The port's copy of the JAX package's dynamic/repair.py.  The repair is
host NumPy there and here, over the port's own reference sweeps
(ops/certify.py); a cone the cost model finds too large falls back to the
full host sweep (``RepairStats.fallback``, JAX's cost model, counted).

A localized edge delta leaves most of a cached distance plane exact —
full recompute re-streams all L levels of (n x words) planes to change
a handful of entries.  Repair runs in two cone-proportional phases per
query row, on the host, with the same certified-sweep machinery the
auditor uses (``ops.certify``):

**Phase 1 — invalidation (deletes).**  A deleted edge (u, v) can only
*raise* distances of v's BFS-tree descendants.  Seed candidates from
deleted-edge endpoints whose old distance was parent+1, then walk
levels ascending: a candidate at level d stays valid iff it still has a
*kept-edge* witness at d-1 (the certify witness invariant, applied
incrementally).  Survivors keep exact distances on the graph-minus-
deletes: validity at d depends only on validity at d-1, so one
ascending pass is a fixpoint, and a surviving witness chain exhibits a
path of the old length while deletes can never shorten one.

**Phase 2 — settle sweep (inserts + recompute).**  Kept distances are
upper bounds on the new graph (inserts only decrease).  Seed a bucket
queue from (a) inserted-edge endpoints at their kept level (the
distance-decrease cone) and (b) the still-valid fringe adjacent to the
invalidated region (the recompute cone), then run a level-synchronous
push relaxation: pop bucket d, relax neighbors to d+1 when that
improves (or first sets) them, enqueue what changed.  Every vertex
whose distance must differ from its kept value has a shortest-path
predecessor that is itself dirty or an inserted-edge/fringe seed, so
the frontier covers exactly the affected cone — work scales with cone
adjacency, not n.  BFS distance fields are unique (certify), so the
result is bit-identical to a cold full recompute.

A host-side cost model (:func:`repair_cost_estimate`) decides repair vs
full recompute BEFORE the settle sweep, from the measured invalidation
cone and seed counts; both paths account analytic plane bytes through
``utils.timing.record_plane_pass``, which the daemon's ``metrics`` verb
exports.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.certify import reference_distances, reference_weighted_distances
from ..utils import knobs
from ..utils.timing import record_plane_pass

__all__ = [
    "RepairStats",
    "repair_cost_estimate",
    "repair_distances",
    "repair_weighted_distances",
]

# Fallback threshold: repair estimated to touch more than this fraction
# of the full-recompute plane bytes falls back to the full sweep (the
# crossover is below 1.0 because repair's per-vertex constant factor —
# bucket bookkeeping, stale skips — is higher than the dense sweep's).
_DEFAULT_MAX_FRAC = 0.5


def _max_frac() -> float:
    raw = knobs.raw("MSBFS_REPAIR_MAX_FRAC")
    if raw is None:
        return _DEFAULT_MAX_FRAC
    try:
        v = float(raw)
        if not 0.0 < v:
            raise ValueError(raw)
        return v
    except ValueError:
        print(
            f"msbfs: malformed MSBFS_REPAIR_MAX_FRAC={raw!r}; "
            f"using default {_DEFAULT_MAX_FRAC}",
            file=sys.stderr,
        )
        return _DEFAULT_MAX_FRAC


@dataclasses.dataclass
class RepairStats:
    """Analytic accounting for one repair call (bench detail.dynamic)."""

    cone_size: int = 0  # distinct (row, vertex) pairs invalidated/re-settled
    repaired_plane_bytes: int = 0  # bytes the cone sweep actually touched
    full_plane_bytes: int = 0  # what the dense sweep would have streamed
    invalidated: int = 0  # (row, vertex) pairs that lost their witness
    seeds: int = 0  # frontier seeds (insert endpoints + fringe)
    levels: int = 0  # max settle level processed over the batch
    fallback: bool = False  # cost model routed to full recompute

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _segments(
    row_offsets: np.ndarray, col_indices: np.ndarray, verts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat CSR gather for a vertex subset: (owner_index, neighbor) for
    every directed slot of every vertex in ``verts`` — the repeat/
    cumsum segment trick, no per-vertex Python loop."""
    deg = (row_offsets[verts + 1] - row_offsets[verts]).astype(np.int64)
    total = int(deg.sum())
    if total == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e
    starts = row_offsets[verts].astype(np.int64)
    seg_base = np.cumsum(deg) - deg
    pos = np.arange(total, dtype=np.int64) + np.repeat(starts - seg_base, deg)
    owner = np.repeat(np.arange(verts.size, dtype=np.int64), deg)
    return owner, col_indices[pos].astype(np.int64)


def _pair_keys(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    lo = np.minimum(u, v).astype(np.int64)
    hi = np.maximum(u, v).astype(np.int64)
    return (lo << 32) | hi


def _in_sorted(keys_sorted: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Membership of ``keys`` in a sorted unique key array, bool mask."""
    if keys_sorted.size == 0 or keys.size == 0:
        return np.zeros(keys.shape, dtype=bool)
    idx = np.searchsorted(keys_sorted, keys)
    idx = np.minimum(idx, keys_sorted.size - 1)
    return keys_sorted[idx] == keys


def _full_sweep_bytes(n: int, k_total: int, levels: int) -> int:
    """What ``reference_distances`` streams: one (n, words) uint64
    frontier plane gather + OR-reduce per level, plus the int32 distance
    plane writes — the dense baseline repair is judged against."""
    words = max(1, (k_total + 63) // 64)
    return max(1, int(levels)) * n * (words * 8 + 4)


def _invalidate_row(
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    dist: np.ndarray,
    delete_pairs: np.ndarray,
    insert_keys: np.ndarray,
) -> Tuple[np.ndarray, int]:
    """Phase 1 for one query row: bool valid mask over reached vertices
    (False = distance no longer certified) and the slots-scanned count.
    ``row_offsets``/``col_indices`` are the NEW graph; kept edges are
    its slots minus the inserted keys (old graph = kept + deleted)."""
    valid = dist >= 0
    scanned = 0
    if delete_pairs.size == 0:
        return valid, scanned
    buckets: Dict[int, List[np.ndarray]] = {}
    queued = np.zeros(dist.size, dtype=bool)

    def enqueue(verts: np.ndarray) -> None:
        verts = verts[~queued[verts]]
        if verts.size == 0:
            return
        queued[verts] = True
        for d in np.unique(dist[verts]):
            buckets.setdefault(int(d), []).append(verts[dist[verts] == d])

    du = dist[delete_pairs[:, 0].astype(np.int64)]
    dv = dist[delete_pairs[:, 1].astype(np.int64)]
    # A deleted edge only threatens the endpoint it parented (child =
    # parent + 1); same-level or unreached endpoints keep their witness.
    child_v = (du >= 0) & (dv == du + 1)
    child_u = (dv >= 0) & (du == dv + 1)
    enqueue(delete_pairs[child_v, 1].astype(np.int64))
    enqueue(delete_pairs[child_u, 0].astype(np.int64))

    while buckets:
        d = min(buckets)
        verts = np.unique(np.concatenate(buckets.pop(d)))
        verts = verts[valid[verts]]
        if verts.size == 0:
            continue
        owner, nbrs = _segments(row_offsets, col_indices, verts)
        scanned += nbrs.size
        ok = valid[nbrs] & (dist[nbrs] == d - 1)
        if insert_keys.size and ok.any():
            # An inserted edge exists only in the new graph — it cannot
            # witness an OLD distance.
            ok &= ~_in_sorted(insert_keys, _pair_keys(verts[owner], nbrs))
        has_witness = np.zeros(verts.size, dtype=bool)
        np.logical_or.at(has_witness, owner, ok)
        lost = verts[~has_witness]
        if lost.size == 0:
            continue
        valid[lost] = False
        # Children one level down may have leaned on the lost vertices;
        # kept-edge children only — deleted-edge children were seeded.
        owner_l, nbrs_l = _segments(row_offsets, col_indices, lost)
        scanned += nbrs_l.size
        cand = valid[nbrs_l] & (dist[nbrs_l] == d + 1)
        if insert_keys.size and cand.any():
            cand &= ~_in_sorted(insert_keys, _pair_keys(lost[owner_l], nbrs_l))
        enqueue(np.unique(nbrs_l[cand]))
    return valid, scanned


def _wsegments(
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    weights: np.ndarray,
    verts: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`_segments` plus the per-slot edge cost: (owner_index,
    neighbor, cost) for every directed slot of ``verts``."""
    deg = (row_offsets[verts + 1] - row_offsets[verts]).astype(np.int64)
    total = int(deg.sum())
    if total == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e
    starts = row_offsets[verts].astype(np.int64)
    seg_base = np.cumsum(deg) - deg
    pos = np.arange(total, dtype=np.int64) + np.repeat(starts - seg_base, deg)
    owner = np.repeat(np.arange(verts.size, dtype=np.int64), deg)
    return (
        owner,
        col_indices[pos].astype(np.int64),
        weights[pos].astype(np.int64),
    )


def _invalidate_row_weighted(
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    weights: np.ndarray,
    dist: np.ndarray,
    delete_pairs: np.ndarray,
    insert_keys: np.ndarray,
) -> Tuple[np.ndarray, int]:
    """Weighted Phase 1 for one query row: the certify weighted-witness
    invariant applied incrementally — a reached vertex at cost c stays
    valid iff some KEPT slot offers a valid neighbor with
    ``dist[neighbor] + w == c``.  Deleted edges carry no cost in the
    net delta (the old graph is gone), so BOTH reached endpoints of
    every deleted edge seed the candidate set — over-seeding is safe
    (an intact witness survives the check), under-seeding is not.
    Ascending-cost order is a fixpoint: validity at c depends only on
    validity at c - w with w >= 1."""
    valid = dist >= 0
    scanned = 0
    if delete_pairs.size == 0:
        return valid, scanned
    buckets: Dict[int, List[np.ndarray]] = {}
    queued = np.zeros(dist.size, dtype=bool)

    def enqueue(verts: np.ndarray) -> None:
        verts = verts[~queued[verts]]
        if verts.size == 0:
            return
        queued[verts] = True
        for d in np.unique(dist[verts]):
            buckets.setdefault(int(d), []).append(verts[dist[verts] == d])

    ends = np.unique(delete_pairs.reshape(-1)).astype(np.int64)
    enqueue(ends[(dist[ends] >= 1)])  # sources witness themselves

    while buckets:
        d = min(buckets)
        verts = np.unique(np.concatenate(buckets.pop(d)))
        verts = verts[valid[verts] & (dist[verts] == d)]
        if verts.size == 0:
            continue
        owner, nbrs, w = _wsegments(row_offsets, col_indices, weights, verts)
        scanned += nbrs.size
        ok = valid[nbrs] & (dist[nbrs] + w == d) & (dist[nbrs] >= 0)
        if insert_keys.size and ok.any():
            # Inserted slots exist only in the new graph — they cannot
            # witness an OLD cost.
            ok &= ~_in_sorted(insert_keys, _pair_keys(verts[owner], nbrs))
        has_witness = np.zeros(verts.size, dtype=bool)
        np.logical_or.at(has_witness, owner, ok)
        lost = verts[~has_witness]
        if lost.size == 0:
            continue
        valid[lost] = False
        # Dependents leaned on the lost vertices: kept-slot neighbors
        # whose old cost is exactly dist[lost] + w (strictly larger, so
        # they land in a later bucket).
        owner_l, nbrs_l, w_l = _wsegments(
            row_offsets, col_indices, weights, lost
        )
        scanned += nbrs_l.size
        cand = valid[nbrs_l] & (dist[nbrs_l] == dist[lost[owner_l]] + w_l)
        if insert_keys.size and cand.any():
            cand &= ~_in_sorted(
                insert_keys, _pair_keys(lost[owner_l], nbrs_l)
            )
        enqueue(np.unique(nbrs_l[cand]))
    return valid, scanned


def repair_weighted_distances(
    graph_new,
    rows: np.ndarray,
    old_dist: np.ndarray,
    inserts: np.ndarray,
    deletes: np.ndarray,
    max_frac: Optional[float] = None,
) -> Tuple[np.ndarray, "RepairStats"]:
    """Weighted twin of :func:`repair_distances`: repair cached
    delta-stepping cost planes across one net edge delta.

    Same two cone-proportional phases, hop arithmetic replaced by cost
    arithmetic.  Phase 1 invalidates by the incremental
    weighted-witness check (:func:`_invalidate_row_weighted`) — the
    invalidation cone is seeded with the TENTATIVE COSTS the surviving
    plane entries already hold.  Phase 2 is a lazy best-first settle
    (host Dijkstra with stale-entry skips) seeded from (a) inserted-
    slot relaxations off settled endpoints — the cost-decrease cone —
    and (b) the still-valid fringe adjacent to the invalidated region —
    the recompute cone.  Survivor costs are achievable in the new graph
    (their witness chains use kept slots only), so they are exact upper
    bounds, and an unchanged interior vertex never needs to settle: its
    kept-slot relaxations were already tight in the old field.  With
    positive costs the SSSP fixpoint is unique, so the result is
    bit-identical to a cold :func:`ops.certify.
    reference_weighted_distances` run — which the weighted certificate
    pins.

    ``graph_new`` must carry ``edge_weights`` (ValueError otherwise);
    inserted slots take their cost from the NEW graph's CSR.  The cost
    model and fallback contract mirror the unit-cost path
    (``MSBFS_REPAIR_MAX_FRAC``); stats reuse :class:`RepairStats` with
    ``levels`` = max settle-heap cost bucket processed.
    """
    if getattr(graph_new, "edge_weights", None) is None:
        raise ValueError("repair_weighted_distances: graph has no edge_weights")
    row_offsets = np.asarray(graph_new.row_offsets, dtype=np.int64)
    col_indices = np.asarray(graph_new.col_indices, dtype=np.int64)
    weights = np.asarray(graph_new.edge_weights, dtype=np.int64)
    n = row_offsets.size - 1
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[None, :]
    old_dist = np.asarray(old_dist, dtype=np.int32)
    if old_dist.ndim == 1:
        old_dist = old_dist[None, :]
    k_total = rows.shape[0]
    inserts = np.asarray(inserts, dtype=np.int64).reshape(-1, 2)
    deletes = np.asarray(deletes, dtype=np.int64).reshape(-1, 2)
    insert_keys = (
        np.unique(_pair_keys(inserts[:, 0], inserts[:, 1]))
        if inserts.size
        else np.zeros(0, dtype=np.int64)
    )
    frac = _max_frac() if max_frac is None else float(max_frac)
    stats = RepairStats()
    # Hop-count proxy for the dense-baseline level estimate: eccentricity
    # in cost units deflated by the mean slot cost.
    w_mean = float(weights.mean()) if weights.size else 1.0
    est_levels = max(1, int(old_dist.max(initial=0) / max(1.0, w_mean)))
    avg_degree = float(col_indices.size) / max(1, n)

    # ---- Phase 1: weighted invalidation, all rows ------------------------
    valids: List[np.ndarray] = []
    scanned_slots = 0
    for k in range(k_total):
        valid, scanned = _invalidate_row_weighted(
            row_offsets, col_indices, weights, old_dist[k], deletes,
            insert_keys,
        )
        valids.append(valid)
        scanned_slots += scanned
        stats.invalidated += int((~valid & (old_dist[k] >= 0)).sum())

    seed_count = 0
    for k in range(k_total):
        invalid_count = int((~valids[k] & (old_dist[k] >= 0)).sum())
        seed_count += 2 * inserts.shape[0] + invalid_count  # upper bound
    stats.seeds = seed_count
    est_repair, full_bytes = repair_cost_estimate(
        n, k_total, est_levels, stats.invalidated, seed_count, avg_degree
    )
    est_repair += scanned_slots * 4
    stats.full_plane_bytes = full_bytes
    if est_repair > frac * full_bytes:
        dist_new = reference_weighted_distances(
            row_offsets, col_indices, weights, rows
        )
        stats.fallback = True
        stats.levels = max(0, int(dist_new.max(initial=0)))
        stats.repaired_plane_bytes = full_bytes
        record_plane_pass(stats.repaired_plane_bytes)
        return dist_new, stats

    # ---- Phase 2: lazy best-first settle, per row ------------------------
    import heapq

    touched = scanned_slots
    dist_new = old_dist.copy()
    for k in range(k_total):
        dist = dist_new[k].astype(np.int64)
        valid = valids[k]
        invalid = ~valid & (old_dist[k] >= 0)
        big = np.int64(1) << np.int64(62)
        dist[invalid] = big
        dist[dist < 0] = big  # never-reached entries are candidates too
        cone = invalid.copy()
        heap: List[Tuple[int, int]] = []

        # (a) inserted-slot relaxations off settled endpoints: walk each
        # insert endpoint's row in the NEW graph (which holds the
        # inserted slots and their costs) and offer dist + w.
        if inserts.size:
            ends = np.unique(inserts.reshape(-1))
            ends = ends[dist[ends] < big]
            if ends.size:
                owner, nbrs, w = _wsegments(
                    row_offsets, col_indices, weights, ends
                )
                touched += nbrs.size
                keyed = _in_sorted(
                    insert_keys, _pair_keys(ends[owner], nbrs)
                )
                cand = dist[ends[owner]] + w
                improve = keyed & (cand < dist[nbrs])
                for tgt, c in zip(nbrs[improve], cand[improve]):
                    if c < dist[tgt]:
                        dist[tgt] = c
                        heapq.heappush(heap, (int(c), int(tgt)))
        # (b) the still-valid fringe around the invalidated region.
        inv_verts = invalid.nonzero()[0]
        if inv_verts.size:
            _, fringe, _ = _wsegments(
                row_offsets, col_indices, weights, inv_verts
            )
            touched += fringe.size
            fringe = np.unique(fringe[dist[fringe] < big])
            for f in fringe:
                heapq.heappush(heap, (int(dist[f]), int(f)))

        while heap:
            d, u = heapq.heappop(heap)
            if d != dist[u]:
                continue  # stale entry
            stats.levels = max(stats.levels, d)
            lo, hi = int(row_offsets[u]), int(row_offsets[u + 1])
            touched += hi - lo + 1
            for pos in range(lo, hi):
                v = int(col_indices[pos])
                nd = d + int(weights[pos])
                if nd < dist[v]:
                    dist[v] = nd
                    cone[v] = True
                    heapq.heappush(heap, (nd, v))
        dist[dist >= big] = -1
        dist_new[k] = dist.astype(np.int32)
        stats.cone_size += int(cone.sum())
    stats.full_plane_bytes = _full_sweep_bytes(
        n,
        k_total,
        max(1, int(dist_new.max(initial=0) / max(1.0, w_mean))),
    )
    stats.repaired_plane_bytes = touched * 4
    record_plane_pass(stats.repaired_plane_bytes)
    return dist_new, stats


def repair_cost_estimate(
    n: int,
    k_total: int,
    est_levels: int,
    invalidated: int,
    seeds: int,
    avg_degree: float,
) -> Tuple[int, int]:
    """(estimated_repair_bytes, full_sweep_bytes) for one delta batch,
    BEFORE the settle sweep runs: the cone is bounded by the measured
    invalidation set plus the frontier seeds, each costing its adjacency
    plus the int32 distance touches.  Pinned by the same plane-byte
    counters the stencil window diet uses, so the fallback decision is
    deterministic and CI-observable — never a wall-clock guess."""
    cone = invalidated + seeds
    est_repair = int(cone * (avg_degree + 2.0) * 4)
    return est_repair, _full_sweep_bytes(n, k_total, est_levels)


def repair_distances(
    graph_new,
    rows: np.ndarray,
    old_dist: np.ndarray,
    inserts: np.ndarray,
    deletes: np.ndarray,
    max_frac: Optional[float] = None,
) -> Tuple[np.ndarray, RepairStats]:
    """Repair cached distance planes across one net edge delta.

    Parameters
    ----------
    graph_new : models.csr.CSRGraph — the post-delta graph.
    rows : (K, S) int32 padded query batch (-1 padding).
    old_dist : (K, n) int32 pre-delta distance planes (certified; e.g.
        ``ops.certify.reference_distances`` on the pre-delta graph).
    inserts / deletes : (M, 2) int arrays — the NET canonical delta
        from the cached version to the new graph
        (``DeltaLog.net_delta``): inserts present in new only, deletes
        present in old only, u < v, no overlap.
    max_frac : fallback threshold override (default
        ``MSBFS_REPAIR_MAX_FRAC`` or 0.5).

    Returns ``(dist_new, stats)`` with ``dist_new`` bit-identical to
    ``reference_distances`` on the new graph (BFS fields are unique, so
    passing the certificate pins this).  When the cost model says the
    cone is too large, falls back to the full sweep (``stats.fallback``)
    — the answer contract is identical either way.
    """
    row_offsets = np.asarray(graph_new.row_offsets, dtype=np.int64)
    col_indices = np.asarray(graph_new.col_indices, dtype=np.int64)
    n = row_offsets.size - 1
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[None, :]
    old_dist = np.asarray(old_dist, dtype=np.int32)
    if old_dist.ndim == 1:
        old_dist = old_dist[None, :]
    k_total = rows.shape[0]
    inserts = np.asarray(inserts, dtype=np.int64).reshape(-1, 2)
    deletes = np.asarray(deletes, dtype=np.int64).reshape(-1, 2)
    insert_keys = (
        np.unique(_pair_keys(inserts[:, 0], inserts[:, 1]))
        if inserts.size
        else np.zeros(0, dtype=np.int64)
    )
    frac = _max_frac() if max_frac is None else float(max_frac)
    stats = RepairStats()
    est_levels = max(1, int(old_dist.max(initial=0)))
    avg_degree = float(col_indices.size) / max(1, n)

    # ---- Phase 1: invalidation, all rows (cone-proportional) -------------
    valids: List[np.ndarray] = []
    scanned_slots = 0
    for k in range(k_total):
        valid, scanned = _invalidate_row(
            row_offsets, col_indices, old_dist[k], deletes, insert_keys
        )
        valids.append(valid)
        scanned_slots += scanned
        stats.invalidated += int((~valid & (old_dist[k] >= 0)).sum())

    # Seeds counted before the sweep so the cost model can refuse it.
    seed_count = 0
    for k in range(k_total):
        invalid_count = int((~valids[k] & (old_dist[k] >= 0)).sum())
        seed_count += 2 * inserts.shape[0] + invalid_count  # upper bound
    stats.seeds = seed_count
    est_repair, full_bytes = repair_cost_estimate(
        n, k_total, est_levels, stats.invalidated, seed_count, avg_degree
    )
    est_repair += scanned_slots * 4  # phase 1 is already spent
    stats.full_plane_bytes = full_bytes
    if est_repair > frac * full_bytes:
        dist_new = reference_distances(row_offsets, col_indices, rows)
        stats.fallback = True
        stats.levels = max(0, int(dist_new.max(initial=0)))
        stats.full_plane_bytes = _full_sweep_bytes(
            n, k_total, max(1, stats.levels)
        )
        stats.repaired_plane_bytes = stats.full_plane_bytes
        record_plane_pass(stats.repaired_plane_bytes)
        return dist_new, stats

    # ---- Phase 2: settle sweep, per row ----------------------------------
    touched = scanned_slots  # slots + vertex touches, x4 bytes at the end
    dist_new = old_dist.copy()
    for k in range(k_total):
        dist = dist_new[k]
        valid = valids[k]
        invalid = ~valid & (old_dist[k] >= 0)
        dist[invalid] = -1
        cone = invalid.copy()  # (row, vertex) pairs repaired
        buckets: Dict[int, List[np.ndarray]] = {}

        def enqueue(verts: np.ndarray, d: int) -> None:
            if verts.size:
                buckets.setdefault(int(d), []).append(verts)

        # (a) inserted-edge endpoints at their kept level: the
        # distance-decrease cone starts where a new edge touches a
        # settled vertex.
        if inserts.size:
            ends = np.unique(inserts.reshape(-1))
            ends = ends[dist[ends] >= 0]
            for d in np.unique(dist[ends]):
                enqueue(ends[dist[ends] == d], int(d))
        # (b) the still-valid fringe around the invalidated region: the
        # recompute cone re-enters through these witnesses.
        inv_verts = invalid.nonzero()[0]
        if inv_verts.size:
            _, fringe = _segments(row_offsets, col_indices, inv_verts)
            touched += fringe.size
            fringe = np.unique(fringe[dist[fringe] >= 0])
            for d in np.unique(dist[fringe]):
                enqueue(fringe[dist[fringe] == d], int(d))

        while buckets:
            d = min(buckets)
            frontier = np.unique(np.concatenate(buckets.pop(d)))
            frontier = frontier[dist[frontier] == d]  # stale skips
            if frontier.size == 0:
                continue
            stats.levels = max(stats.levels, d)
            owner, nbrs = _segments(row_offsets, col_indices, frontier)
            touched += nbrs.size + frontier.size
            relax = (dist[nbrs] == -1) | (dist[nbrs] > d + 1)
            targets = np.unique(nbrs[relax])
            if targets.size == 0:
                continue
            dist[targets] = d + 1
            cone[targets] = True
            enqueue(targets, d + 1)
        stats.cone_size += int(cone.sum())
    stats.levels = max(
        stats.levels, max(0, int(dist_new.max(initial=0)))
    )
    # Re-anchor the dense baseline on the ACTUAL post-delta level count
    # (the pre-sweep figure used the old eccentricity as a proxy) so
    # bench/perf-smoke speedups compare against what the full sweep
    # would really have streamed.
    stats.full_plane_bytes = _full_sweep_bytes(
        n, k_total, max(1, stats.levels)
    )
    stats.repaired_plane_bytes = touched * 4
    record_plane_pass(stats.repaired_plane_bytes)
    return dist_new, stats
