"""The distance-matrix level loop shared by the generic engine, the
level-loop guards shared by the chunked engines, and the CSR pull's
plain expansion (``frontier_expand``, kernel K9's reference).

Reference semantics (main.cu:16-73): distances start at -1, in-range
sources (``0 <= s < n``) at 0; each level labels the unvisited neighbours
of the vertices at distance ``level`` with ``level + 1``; a query stops
after the first level that labels nothing.

The JAX package vmaps a single-query ``while_loop``; here the batch
dimension is written out.  :class:`DistCarry` holds (K, size) int32
distances and per-query ``level`` / ``updated`` counters, so each query
advances to its own convergence exactly as under vmap, and a converged
query's row is a fixed point.  The control stays on the device: a chunk
arms a per-query level bound (``stop``) and a go flag (``ctrl[0]``), and
every level is a gated step that does nothing once no query may run, so
the host enqueues a whole chunk and reads the state once per chunk
(:func:`host_chunked_loop`).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import faults
from ..utils.timing import record_dispatch
from .objective import f_of_u

NOT_REACHED = -1
INT32_MAX = 2**31 - 1


def validate_level_chunk(level_chunk):
    """A non-positive bound would make every chunk a no-op while
    ``updated`` stays true, so the host driver would loop forever: fail
    loud at construction instead.  ``None`` disables the bound."""
    if level_chunk is not None and level_chunk <= 0:
        raise ValueError(
            f"level_chunk must be positive (got {level_chunk}); "
            "use None to disable the bound"
        )
    return level_chunk


def init_distances(n: int, sources, state_size: Optional[int] = None, device="cpu"):
    """-1 everywhere, 0 at in-range sources: (S,) sources give a (size,)
    vector, (K, S) give (K, size).  Out-of-range entries (the -1 padding
    included) are dropped — the reference's bounds check (main.cu:46-51)."""
    size = n if state_size is None else int(state_size)
    src = torch.as_tensor(np.asarray(sources, dtype=np.int64), device=device)
    batch = src.dim() == 2
    src = src.reshape(-1, src.shape[-1])
    dist = torch.full((src.shape[0], size), NOT_REACHED, dtype=torch.int32, device=device)
    rows, cols = torch.nonzero((src >= 0) & (src < n), as_tuple=True)
    dist[rows, src[rows, cols]] = 0
    return dist if batch else dist[0]


def segment_max_(out: torch.Tensor, dim: int, index: torch.Tensor, src: torch.Tensor) -> None:
    """``out.index_reduce_(dim, index, src, "amax")``, without torch's
    one-time notice that ``index_reduce_`` is in beta on the CLI's
    stderr."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="index_reduce", category=UserWarning)
        out.index_reduce_(dim, index, src, "amax")


def _as_rows(level, k: int, device) -> torch.Tensor:
    """A scalar or (K,) level -> (K, 1), for comparing with (K, n)."""
    return torch.as_tensor(level, device=device).reshape(-1, 1).expand(k, 1)


def frontier_expand(dist: torch.Tensor, level, graph) -> torch.Tensor:
    """The JAX package's ``frontier_expand`` for (n,) or (K, n) distances
    at ``level`` (a scalar or (K,)): gather the frontier flag of every
    slot's neighbour, reduce per owning row (sorted ``edge_src``) with a
    byte max, keep the unreached rows.  Returns the newly-reached mask,
    shaped like ``dist``."""
    d = dist.reshape(-1, dist.shape[-1])
    k, n = d.shape
    frontier = (d == _as_rows(level, k, d.device)).to(torch.uint8)
    slot_active = frontier[:, graph.col_indices.long()]
    reached = torch.zeros((k, n), dtype=torch.uint8, device=d.device)
    segment_max_(reached, 1, graph.edge_src.long(), slot_active)
    return ((d == NOT_REACHED) & (reached > 0)).reshape(dist.shape)


def graph_expand(dist: torch.Tensor, level, graph) -> torch.Tensor:
    """The default expansion: the graph container's own
    (``graph.expand_frontier``), as in the JAX package."""
    return graph.expand_frontier(dist, level)


@dataclass
class DistCarry:
    """The distance loop's state, updated in place by every level.

    ``dist`` (K, size) int32; ``level``, ``updated``, ``stop`` and the
    scratch ``found`` (K,) int32, zero between levels; ``ctrl`` (4,) int32
    with ctrl[0] = some query may run the next level and ctrl[2] the ELL
    kernel's last-block ticket, zero between levels (the others unused).

    ``planes`` is the ELL level's own state beside ``dist``
    (:class:`.cuda_bfs.EllPlanes`, made at its first level): bit planes
    that stay true only while that level is the one writing the carry.
    Whoever else writes a field — a chunk being armed, the plain step, a
    test restoring ``dist`` — calls :meth:`touch`, and the next ELL level
    rebuilds its planes from ``dist``."""

    dist: torch.Tensor
    level: torch.Tensor
    updated: torch.Tensor
    stop: torch.Tensor
    found: torch.Tensor
    ctrl: torch.Tensor
    planes: Optional[object] = None

    def touch(self) -> None:
        """The carry was written outside the ELL level: its planes are
        stale."""
        if self.planes is not None:
            self.planes.valid = False


def distance_carry_init(n: int, sources, state_size=None, device="cpu") -> DistCarry:
    """The carry with sources at distance 0; ``updated`` starts true for
    the queries with a valid source (an empty group converges at once,
    like the reference's single no-op launch)."""
    dist = init_distances(n, np.atleast_2d(sources), state_size, device)
    k = dist.shape[0]
    updated = (dist == 0).any(dim=1).to(torch.int32)
    return DistCarry(
        dist=dist,
        level=torch.zeros(k, dtype=torch.int32, device=device),
        updated=updated,
        stop=torch.zeros(k, dtype=torch.int32, device=device),
        found=torch.zeros(k, dtype=torch.int32, device=device),
        ctrl=torch.zeros(4, dtype=torch.int32, device=device),
    )


def level_active(carry: DistCarry) -> torch.Tensor:
    """(K,) bool: the queries that run the next level of this chunk."""
    return (carry.updated != 0) & (carry.level < carry.stop)


def arm_chunk(carry: DistCarry, chunk: Optional[int], max_levels: Optional[int]) -> None:
    """Set each query's level bound for the next chunk — ``min(level +
    chunk, max_levels)``, JAX's per-query ``start + chunk`` — and the go
    flag, with device ops only."""
    cap = INT32_MAX if max_levels is None else int(max_levels)
    if chunk is None:
        carry.stop.fill_(cap)
    else:
        carry.stop.copy_(torch.clamp(carry.level.to(torch.int64) + int(chunk), max=cap))
    carry.ctrl[:1].copy_(level_active(carry).any().view(1))
    carry.touch()


def apply_new(carry: DistCarry, new: torch.Tensor) -> None:
    """Fold one level's newly-reached mask into the carry for the queries
    that may run it (the ``where``/``level + 1``/``any`` of JAX's loop
    body), then refresh the go flag."""
    active = level_active(carry)
    new = new & active[:, None]
    carry.dist.copy_(torch.where(new, carry.level[:, None] + 1, carry.dist))
    carry.updated.copy_(torch.where(active, new.any(dim=1).to(torch.int32), carry.updated))
    carry.level.add_(active.to(torch.int32))
    carry.ctrl[:1].copy_(level_active(carry).any().view(1))
    carry.touch()


def expand_step(expand: Callable) -> Callable[[DistCarry], None]:
    """A gated one-level step from ``expand(dist, level) -> (K, size)
    newly-reached mask`` (the plain formulation, with host reads)."""

    def step(carry: DistCarry) -> None:
        if int(carry.ctrl[0]):
            apply_new(carry, expand(carry.dist, carry.level))

    return step


def distance_chunk(
    carry: DistCarry,
    step: Callable[[DistCarry], None],
    chunk: Optional[int],
    max_levels: Optional[int],
) -> DistCarry:
    """Advance every query by at most ``chunk`` levels (``None``: to
    convergence or ``max_levels``).  ``step(carry)`` runs one gated level
    in place; at most ``chunk`` of them are enqueued, fewer once the
    device control shows that no query runs."""
    from .bitbell import bit_level_chunk  # lazy: bitbell -> packed -> engine

    if isinstance(chunk, int) and chunk <= 0:
        raise ValueError(f"chunk must be positive (got {chunk})")
    arm_chunk(carry, chunk, max_levels)
    bit_level_chunk(carry, step, chunk)
    return carry


def host_chunked_loop(
    carry: DistCarry, advance: Callable[[DistCarry], object], max_levels
) -> DistCarry:
    """Re-run ``advance`` (one bounded chunk) until every query has
    converged or reached ``max_levels``; one blocking read per chunk.
    Always advances at least once.

    This loop is also the plane-commit seam of the fault plan
    (utils/faults.py): after chunk ``i`` an armed ``bitflip:plane<i>``
    flips one bit of ``dist`` — the bit the JAX package flips in its
    ``carry[0]``, the same (K, n_pad) int32 distances — and the carry's
    derived planes go stale.  While a certify plane trail is armed
    (ops/certify.py), each chunk's ``dist`` digest is recorded, as JAX
    records its ``carry[0]``'s.  The trace spans of this loop come with
    serving."""
    from . import certify

    cap = INT32_MAX if max_levels is None else int(max_levels)
    chunk_ix = 0
    while True:
        advance(carry)
        if faults.corruption_armed():
            flipped = faults.corrupt(f"plane{chunk_ix}", carry.dist)
            if flipped is not carry.dist:
                carry.dist.copy_(torch.from_numpy(flipped))
                carry.touch()
        if certify.trail_armed():
            certify.record_plane_digest(carry.dist)
        chunk_ix += 1
        active = bool(((carry.updated != 0) & (carry.level < cap)).any())
        record_dispatch()
        if not active:
            return carry


def multi_source_bfs(graph, sources, max_levels: Optional[int] = None, expand=None):
    """BFS from (S,) or (K, S) -1-padded sources; (n,) or (K, n) int32
    distances, -1 where unreached (reference main.cu:40-73).
    ``expand(dist, level, graph)`` is the plain expansion (default: the
    graph's ``expand_frontier``)."""
    expand = expand or graph_expand
    device = getattr(graph, "device", "cpu")
    carry = distance_carry_init(graph.n, sources, device=device)
    distance_chunk(
        carry, expand_step(lambda d, lvl: expand(d, lvl, graph)), None, max_levels
    )
    return carry.dist if np.ndim(sources) == 2 else carry.dist[0]


def stats_from_distances(dist: torch.Tensor):
    """Per-query (levels, reached, f) over the last axis of final
    distances: levels = max distance + 1 (the reference's launch count,
    main.cu:61-71), 0 when no source was valid; reached counts the
    vertices at distance >= 0; f = F(U)."""
    reached = (dist >= 0).sum(dim=-1, dtype=torch.int32)
    top = dist.amax(dim=-1) if dist.shape[-1] else torch.zeros_like(reached)
    levels = torch.where(reached > 0, top + 1, 0).to(torch.int32)
    return levels, reached, f_of_u(dist)
