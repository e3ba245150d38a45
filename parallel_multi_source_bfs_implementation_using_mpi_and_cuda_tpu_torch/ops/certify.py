"""Output certification: prove a distance-to-set answer, don't trust it.

The port's own copy of the JAX package's ops/certify.py (NumPy only, the
same invariants, messages and digests; the port imports nothing of that
package).  A flipped bit in a plane, a distance buffer or a payload
becomes a wrong F(U_k) and a wrong argmin with no error raised, so the
answer is checked, independently of the engine that made it, in one
O(E) vectorized pass over the host CSR:

``source-zero``      every valid in-range source has distance 0;
``zero-is-source``   every distance-0 vertex IS a source;
``edge-relaxation``  for every directed slot u->v with u reached, v is
                     reached and dist[v] <= dist[u] + 1 (both slot
                     directions are stored, so |dist[u] - dist[v]| <= 1);
``witness``          every vertex at distance d >= 1 has a neighbor at
                     distance d - 1.

An int array satisfying all four IS the BFS distance field of its source
set.  The engines report only F(U_k), so the auditor recomputes the field
with an untrusted host sweep, certifies the recompute against the
invariants (a fault in the audit path flunks too), then checks the claimed
F against it (``f-mismatch``).  The weighted certificate
(:data:`WEIGHTED_INVARIANTS`) replaces hop bounds by cost bounds.

:func:`fold_digest` is the companion fingerprint: a position-sensitive
xor-fold of any buffer set, for per-plane digest trails.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = [
    "INVARIANTS",
    "WEIGHTED_INVARIANTS",
    "fold_digest",
    "reference_distances",
    "certify_distances",
    "f_from_distances",
    "audit_f_values",
    "make_auditor",
    "reference_weighted_distances",
    "certify_weighted_distances",
    "audit_weighted_f_values",
    "make_weighted_auditor",
    "start_plane_trail",
    "stop_plane_trail",
    "plane_trail",
    "trail_armed",
    "record_plane_digest",
]

INVARIANTS = (
    "source-zero",
    "zero-is-source",
    "edge-relaxation",
    "witness",
    "f-mismatch",
)

#: The weighted certificate (weighted/ delta-stepping outputs): same
#: one-pass self-certifying structure, hop bounds replaced by cost
#: bounds.  ``weighted-relaxation`` is the triangle inequality over
#: every directed CSR slot — dist[v] <= dist[u] + w(u, v) with u
#: reached forcing v reached (both slot directions carry the record's
#: cost, so this pins |dist[u] - dist[v]| <= w from both sides);
#: ``weighted-witness`` demands every reached non-source v have a
#: neighbor u with dist[u] + w(u, v) == dist[v] (a tight predecessor).
#: An int field satisfying all five IS the weighted distance-to-set
#: field — positive costs make the SSSP fixpoint unique.
WEIGHTED_INVARIANTS = (
    "source-zero",
    "zero-is-source",
    "weighted-relaxation",
    "weighted-witness",
    "f-mismatch",
)

_W_INF = np.int64(1) << np.int64(62)  # audit-side unreached sentinel

_MIX_A = np.uint32(0x9E3779B9)  # golden-ratio index salt
_MIX_B = np.uint32(0x7FEB352D)  # 2-round integer-hash finalizer
_MIX_C = np.uint32(0x846CA68B)


def _host(a) -> np.ndarray:
    """``a`` as a host array: a tensor (on any device) is read back."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _mix32(x: np.ndarray) -> np.ndarray:
    """Elementwise avalanche finalizer (uint32 -> uint32): a plain
    xor-fold would let two flips cancel and is insensitive to WHERE a
    bit flipped; mixing each word with its position salt first makes
    every (position, bit) pair land on an independent-looking word."""
    with np.errstate(over="ignore"):  # uint32 wraparound is the point
        x = x ^ (x >> np.uint32(16))
        x = x * _MIX_B
        x = x ^ (x >> np.uint32(15))
        x = x * _MIX_C
        return x ^ (x >> np.uint32(16))


def fold_digest(*arrays) -> int:
    """Position-sensitive xor-fold digest of one or more buffers.

    Returns a python int in [0, 2^32).  Any single-bit change in any
    buffer — including moving a value between positions, or between
    buffers — changes the digest (up to 32-bit collision odds).  Cost:
    one vectorized pass over the bytes; safe on any dtype/shape, and on
    tensors on any device (read back to the host).
    """
    acc = np.uint32(len(arrays))
    for ordinal, a in enumerate(arrays):
        v = np.ascontiguousarray(_host(a))
        b = v.view(np.uint8).reshape(-1)
        if b.size % 4:
            b = np.concatenate(
                [b, np.zeros(4 - b.size % 4, dtype=np.uint8)]
            )
        w = b.view(np.uint32)
        idx = np.arange(w.size, dtype=np.uint32)
        with np.errstate(over="ignore"):  # uint32 wraparound is the point
            mixed = _mix32(w ^ (idx * _MIX_A) ^ np.uint32(ordinal + 1))
        acc ^= np.bitwise_xor.reduce(mixed) if w.size else np.uint32(0)
        acc = _mix32(acc ^ np.uint32(b.size))
    return int(acc)


def _edge_endpoints(row_offsets: np.ndarray, col_indices: np.ndarray):
    """(u_all, v_all): source/target of every directed CSR slot."""
    n = row_offsets.size - 1
    degrees = np.diff(row_offsets)
    u_all = np.repeat(np.arange(n, dtype=np.int64), degrees)
    return u_all, np.asarray(col_indices, dtype=np.int64)


def _valid_sources(rows: np.ndarray, n: int) -> np.ndarray:
    """(K, S) bool: which padded source slots are live — the reference
    loader's bounds contract (out-of-range sources are dropped, -1 is
    padding)."""
    rows = np.asarray(rows)
    return (rows >= 0) & (rows < n)


def reference_distances(
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    rows: np.ndarray,
    endpoints=None,
) -> np.ndarray:
    """Untrusted audit recompute: (K, n) int32 distance-to-set fields
    for the padded query batch ``rows`` ((K, S) int32, -1 padding), by
    a batched host-side level sweep over the CSR — one vectorized
    (K, E) expansion per BFS level for the WHOLE batch, no shared code
    with any engine's device path.  "Untrusted" is fine:
    :func:`certify_distances` validates the result before anything is
    compared against it.  ``endpoints`` takes a precomputed
    :func:`_edge_endpoints` pair (the auditor closure caches it)."""
    row_offsets = np.asarray(row_offsets)
    n = row_offsets.size - 1
    u_all, v_all = (
        _edge_endpoints(row_offsets, col_indices)
        if endpoints is None else endpoints
    )
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[None, :]
    k_total = rows.shape[0]
    # (n, K) internal layout: the per-level gather becomes an axis-0
    # take of contiguous K-wide rows — numpy's fast fancy-index path —
    # instead of K strided axis-1 gathers.
    dist_t = np.full((n, k_total), -1, dtype=np.int32)
    live = _valid_sources(rows, n)
    k_idx = np.repeat(np.arange(k_total), live.sum(axis=1))
    dist_t[rows[live], k_idx] = 0
    if v_all.size == 0:
        return np.ascontiguousarray(dist_t.T)  # no edges: sources only
    # Pull sweep over K bit-planes (the host-side analogue of the
    # bitbell engines' packing, arrived at independently so the audit
    # shares no formulation with the audited path): each vertex carries
    # ceil(K/64) uint64 words, one bit per query, so a level is ONE
    # contiguous axis-0 take plus ONE bitwise_or.reduceat — per-query
    # cost amortizes to a bit.  The gathered edge array carries one
    # zero pad row so a trailing empty row's start (== E) stays a valid
    # reduceat index WITHOUT clamping — clamping would truncate the
    # last non-empty row's segment; empty rows are masked out after the
    # reduction either way.
    starts = np.asarray(row_offsets[:-1], dtype=np.intp)
    empty = np.diff(row_offsets) == 0
    words = (k_total + 63) // 64
    pad = np.zeros((1, words), dtype=np.uint64)
    shifts = np.arange(64, dtype=np.uint64)
    frontier = np.zeros((n, words), dtype=np.uint64)
    seed_v, seed_k = (dist_t == 0).nonzero()
    np.bitwise_or.at(
        frontier,
        (seed_v, seed_k // 64),
        np.uint64(1) << (seed_k % 64).astype(np.uint64),
    )
    visited = frontier.copy()
    level = np.int32(0)
    while frontier.any():
        reach = np.bitwise_or.reduceat(
            np.concatenate([frontier[v_all], pad]), starts, axis=0
        )
        reach[empty] = 0
        new_bits = reach & ~visited
        hot = new_bits.any(axis=1)
        if not hot.any():
            break
        level += 1
        visited |= new_bits
        rows_hot = hot.nonzero()[0]
        mask = (
            ((new_bits[rows_hot, :, None] >> shifts) & np.uint64(1))
            .astype(bool)
            .reshape(rows_hot.size, words * 64)[:, :k_total]
        )
        block = dist_t[rows_hot]
        block[mask] = level
        dist_t[rows_hot] = block
        frontier = new_bits
    return np.ascontiguousarray(dist_t.T)


def certify_distances(
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    rows: np.ndarray,
    dist: np.ndarray,
    endpoints=None,
) -> List[str]:
    """The O(E) certificate: check ``dist`` ((K, n) int) against the
    four BFS invariants for the padded query batch ``rows``.  Returns
    the failing invariant names ([] = ``dist`` IS the distance field).
    """
    row_offsets = np.asarray(row_offsets)
    n = row_offsets.size - 1
    u_all, v_all = (
        _edge_endpoints(row_offsets, col_indices)
        if endpoints is None else endpoints
    )
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[None, :]
    dist = np.asarray(dist)
    if dist.ndim == 1:
        dist = dist[None, :]
    k_total = rows.shape[0]
    live = _valid_sources(rows, n)
    failing: List[str] = []

    # canonical-unreached: unreached is exactly -1.  Every other
    # negative encodes the same ANSWER (f ignores negatives), which is
    # precisely how a bit flipped into an unreached slot would hide —
    # pinning the encoding closes that blind spot, so any single-bit
    # corruption of the field is detectable.
    if bool((dist < -1).any()):
        failing.append("canonical-unreached")

    # source-zero / zero-is-source: (K, n) source membership mask.
    is_source = np.zeros((k_total, n), dtype=bool)
    k_idx = np.repeat(np.arange(k_total), live.sum(axis=1))
    is_source[k_idx, rows[live]] = True
    if not bool((dist[is_source] == 0).all()):
        failing.append("source-zero")
    if bool(((dist == 0) & ~is_source).any()):
        failing.append("zero-is-source")

    # edge-relaxation + witness, one (E, K) pass in the same transposed
    # layout as the recompute sweep (axis-0 takes).  int16 halves the
    # gather traffic; the cast is gated on the WHOLE field (corrupt
    # values included) fitting well inside int16, so a flipped-to-
    # garbage entry can never wrap into a plausible value — out-of-
    # range fields keep the exact int32 path.
    if v_all.size == 0:
        if bool((dist >= 1).any()):
            failing.append("witness")  # reached depth >= 1 with no edges
        return failing
    d_t = np.ascontiguousarray(dist.T)
    if d_t.size and -2**14 <= d_t.min() and d_t.max() < 2**14:
        d_t = d_t.astype(np.int16)  # diff below stays in range
    du = d_t[u_all]
    dv = d_t[v_all]
    diff = dv - du  # |values| < 2^14, so the difference fits int16
    reached_u = du >= 0
    if bool((reached_u & ((dv < 0) | (diff > 1))).any()):
        failing.append("edge-relaxation")
    # witness[u, k] = some row-u slot's neighbor sits at dist[u] - 1
    # (same pad-row segment reduction as the recompute sweep — trailing
    # empty rows keep start == E valid without clamping into the last
    # non-empty row's segment; du >= 1 keeps a dv == -1 unreached
    # neighbor from "witnessing" a source).
    starts = np.asarray(row_offsets[:-1], dtype=np.intp)
    empty = np.diff(row_offsets) == 0
    witness = np.maximum.reduceat(
        np.concatenate(
            [(du >= 1) & (diff == -1),
             np.zeros((1, k_total), dtype=bool)]
        ),
        starts,
        axis=0,
    )
    witness[empty] = False
    if bool(((d_t >= 1) & ~witness).any()):
        failing.append("witness")
    return failing


def f_from_distances(dist: np.ndarray) -> np.ndarray:
    """The objective on a host distance field: F = sum of non-negative
    distances, int64 — the same contract as ``ops.objective.f_of_u``."""
    dist = np.asarray(dist)
    return np.where(dist >= 0, dist, 0).sum(axis=-1, dtype=np.int64)


def audit_f_values(
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    rows: np.ndarray,
    f_claimed: np.ndarray,
    endpoints=None,
) -> List[str]:
    """End-to-end audit of a claimed F vector for the padded query
    batch ``rows``: recompute the distance fields, certify the
    recompute, compare F.  Returns failing invariant names ([] = the
    claimed output is certified correct)."""
    dist = reference_distances(
        row_offsets, col_indices, rows, endpoints=endpoints
    )
    failing = certify_distances(
        row_offsets, col_indices, rows, dist, endpoints=endpoints
    )
    f_ref = f_from_distances(dist)
    f_claimed = np.asarray(f_claimed, dtype=np.int64).reshape(f_ref.shape)
    if not bool(np.array_equal(f_ref, f_claimed)):
        failing.append("f-mismatch")
    return failing


def reference_weighted_distances(
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    edge_weights: np.ndarray,
    rows: np.ndarray,
    endpoints=None,
) -> np.ndarray:
    """Untrusted weighted audit recompute: (K, n) int32 weighted
    distance-to-set fields by a vectorized host Jacobi Bellman-Ford
    sweep over the CSR — per pass, every row pulls
    ``min(dist[neighbor] + w)`` via one contiguous gather plus one
    ``minimum.reduceat``, iterated to fixpoint.  Deliberately a
    DIFFERENT formulation from the engines' bucketed delta-stepping
    (no buckets, no light/heavy split): with positive costs
    both converge to the unique SSSP fixpoint, and
    :func:`certify_weighted_distances` validates this recompute before
    anything is compared against it, so the recompute stays untrusted.
    Each pass extends shortest paths by at least one edge, so the sweep
    terminates within n - 1 passes (far fewer in practice)."""
    row_offsets = np.asarray(row_offsets)
    n = row_offsets.size - 1
    _, v_all = (
        _edge_endpoints(row_offsets, col_indices)
        if endpoints is None else endpoints
    )
    w_all = np.asarray(edge_weights, dtype=np.int64)
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[None, :]
    k_total = rows.shape[0]
    # Same (n, K) transposed layout as the unit-cost sweep: the gather
    # is an axis-0 take of contiguous K-wide rows.
    dist_t = np.full((n, k_total), _W_INF, dtype=np.int64)
    live = _valid_sources(rows, n)
    k_idx = np.repeat(np.arange(k_total), live.sum(axis=1))
    dist_t[rows[live], k_idx] = 0
    if v_all.size and k_total:
        starts = np.asarray(row_offsets[:-1], dtype=np.intp)
        empty = np.diff(row_offsets) == 0
        pad = np.full((1, k_total), _W_INF, dtype=np.int64)
        w_col = w_all[:, None]
        for _ in range(max(1, n - 1)):
            offers = np.minimum.reduceat(
                np.concatenate([dist_t[v_all] + w_col, pad]),
                starts,
                axis=0,
            )
            offers[empty] = _W_INF
            new = np.minimum(dist_t, offers)
            if np.array_equal(new, dist_t):
                break
            dist_t = new
    out = np.where(dist_t >= _W_INF, np.int64(-1), dist_t)
    return np.ascontiguousarray(out.T).astype(np.int32)


def certify_weighted_distances(
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    edge_weights: np.ndarray,
    rows: np.ndarray,
    dist: np.ndarray,
    endpoints=None,
) -> List[str]:
    """The O(E) weighted certificate: check ``dist`` ((K, n) int)
    against :data:`WEIGHTED_INVARIANTS` for the padded query batch
    ``rows``.  Returns the failing invariant names ([] = ``dist`` IS
    the weighted distance field — positive costs make it unique)."""
    row_offsets = np.asarray(row_offsets)
    n = row_offsets.size - 1
    u_all, v_all = (
        _edge_endpoints(row_offsets, col_indices)
        if endpoints is None else endpoints
    )
    w_all = np.asarray(edge_weights, dtype=np.int64)
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[None, :]
    dist = np.asarray(dist)
    if dist.ndim == 1:
        dist = dist[None, :]
    k_total = rows.shape[0]
    live = _valid_sources(rows, n)
    failing: List[str] = []

    # canonical-unreached: same encoding pin as the unit-cost
    # certificate — unreached is exactly -1, nothing else.
    if bool((dist < -1).any()):
        failing.append("canonical-unreached")

    is_source = np.zeros((k_total, n), dtype=bool)
    k_idx = np.repeat(np.arange(k_total), live.sum(axis=1))
    is_source[k_idx, rows[live]] = True
    if not bool((dist[is_source] == 0).all()):
        failing.append("source-zero")
    if bool(((dist == 0) & ~is_source).any()):
        failing.append("zero-is-source")

    if v_all.size == 0 or k_total == 0:
        if bool((dist >= 1).any()):
            failing.append("weighted-witness")  # reached with no edges
        return failing
    # Both checks in one (E, K) transposed pass.  int64 throughout:
    # du + w must never wrap, whatever garbage a flipped bit wrote.
    d_t = np.ascontiguousarray(dist.T).astype(np.int64)
    du = d_t[u_all]
    dv = d_t[v_all]
    w_col = w_all[:, None]
    reached_u = du >= 0
    # Triangle inequality over every directed slot; a reached ->
    # unreached slot is a violation by itself.
    if bool((reached_u & ((dv < 0) | (dv > du + w_col))).any()):
        failing.append("weighted-relaxation")
    # weighted-witness[u, k]: some slot in u's row has a reached
    # neighbor v with dv + w == du — a tight predecessor (both slot
    # directions carry the record's cost, so checking from the row-
    # owner side covers every vertex).  Same pad-row reduceat as the
    # unit-cost certificate.
    starts = np.asarray(row_offsets[:-1], dtype=np.intp)
    empty = np.diff(row_offsets) == 0
    witness = np.maximum.reduceat(
        np.concatenate(
            [(du >= 1) & (dv >= 0) & (dv + w_col == du),
             np.zeros((1, k_total), dtype=bool)]
        ),
        starts,
        axis=0,
    )
    witness[empty] = False
    if bool(((d_t >= 1) & ~witness).any()):
        failing.append("weighted-witness")
    return failing


def audit_weighted_f_values(
    row_offsets: np.ndarray,
    col_indices: np.ndarray,
    edge_weights: np.ndarray,
    rows: np.ndarray,
    f_claimed: np.ndarray,
    endpoints=None,
) -> List[str]:
    """End-to-end weighted audit of a claimed F vector: recompute the
    weighted distance fields, certify the recompute, compare F.
    Returns failing invariant names ([] = certified correct)."""
    dist = reference_weighted_distances(
        row_offsets, col_indices, edge_weights, rows, endpoints=endpoints
    )
    failing = certify_weighted_distances(
        row_offsets, col_indices, edge_weights, rows, dist,
        endpoints=endpoints,
    )
    f_ref = f_from_distances(dist)
    f_claimed = np.asarray(f_claimed, dtype=np.int64).reshape(f_ref.shape)
    if not bool(np.array_equal(f_ref, f_claimed)):
        failing.append("f-mismatch")
    return failing


def make_weighted_auditor(graph) -> Callable[[object, object], List[str]]:
    """The weighted twin of :func:`make_auditor`: a ChunkSupervisor
    auditor closure over one weighted host graph's CSR + cost buffers.
    Raises ValueError on a weightless graph — building a weighted
    auditor over a graph with no costs is a wiring bug, not a runtime
    condition."""
    if not getattr(graph, "has_weights", False):
        raise ValueError("make_weighted_auditor: graph has no edge_weights")
    row_offsets = np.asarray(graph.row_offsets)
    col_indices = np.asarray(graph.col_indices)
    edge_weights = np.asarray(graph.edge_weights)
    endpoints = _edge_endpoints(row_offsets, col_indices)

    def auditor(queries, f) -> List[str]:
        return audit_weighted_f_values(
            row_offsets,
            col_indices,
            edge_weights,
            _host(queries),
            _host(f),
            endpoints=endpoints,
        )

    return auditor


def make_auditor(graph) -> Callable[[object, object], List[str]]:
    """Build the :class:`..runtime.supervisor.ChunkSupervisor` auditor
    for one host graph (``models.csr.CSRGraph``): a closure
    ``auditor(queries, f) -> [failing invariants]`` over the graph's
    CSR buffers.  The edge-endpoint expansion is precomputed — one
    O(E) int64 buffer per graph, shared by every audited call."""
    row_offsets = np.asarray(graph.row_offsets)
    col_indices = np.asarray(graph.col_indices)
    endpoints = _edge_endpoints(row_offsets, col_indices)

    def auditor(queries, f) -> List[str]:
        return audit_f_values(
            row_offsets,
            col_indices,
            _host(queries),
            _host(f),
            endpoints=endpoints,
        )

    return auditor


# ---- per-plane digest trail (chunk/stream/megachunk boundaries) -----------
# Opt-in: the host drive loops record fold_digest(state) after every
# committed chunk while the trail is armed.  Two clean runs of the same
# program produce identical trails; a corrupted run's trail diverges at
# exactly the corrupted chunk — the localization tool behind the
# bitflip property tests and `msbfs verify`.
_TRAIL: Optional[List[int]] = None


def start_plane_trail() -> None:
    global _TRAIL
    _TRAIL = []


def stop_plane_trail() -> List[int]:
    global _TRAIL
    trail, _TRAIL = list(_TRAIL or ()), None
    return trail


def plane_trail() -> List[int]:
    return list(_TRAIL or ())


def trail_armed() -> bool:
    return _TRAIL is not None


def record_plane_digest(state) -> None:
    """One committed chunk's state digest.  ``state`` may be any array
    or sequence of arrays (a drive-loop carry)."""
    if _TRAIL is None:
        return
    if isinstance(state, (tuple, list)):
        _TRAIL.append(fold_digest(*state))
    else:
        _TRAIL.append(fold_digest(state))
