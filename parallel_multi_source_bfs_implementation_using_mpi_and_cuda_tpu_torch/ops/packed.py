"""Query-minor packed BFS over the flat CSR (the ``packed`` route), the
query padding every packed engine shares, and the ordered sub-batch split.

The JAX package's ops/packed.py: distances live as an (n, K) matrix, so
one level for all K queries pulls each vertex's neighbour rows of K
contiguous distances.  There a level is a row gather of the (n, K)
frontier over ``col_indices`` and a sorted ``segment_max`` over
``edge_src`` — an (E, K) intermediate that ``edge_chunks`` cuts into
slices.  Here the level is kernel K9 (``ops/cuda_csr.py``,
``csrc/csr_pull.cu``) on the (K, n) view of the matrix, query-minor, one
launch with no intermediate; the plain version keeps JAX's chunked form.
The loop is the distance loop of ops/bfs.py with per-query counters: the
JAX engine advances one level counter for all K queries, and a query
whose column stopped changing is a fixed point either way, so the final
matrix is the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .bfs import (
    NOT_REACHED,
    DistCarry,
    distance_chunk,
    host_chunked_loop,
    init_distances,
    segment_max_,
    stats_from_distances,
    validate_level_chunk,
)
from .engine import Engine, QueryEngineBase
from .objective import f_of_u

K_ALIGN = 8


def packed_init(n: int, queries, device="cpu") -> torch.Tensor:
    """(K, S) -1-padded queries -> (n, K) int32 distances (-1, and 0 at
    each query's in-range sources, main.cu:46-51)."""
    return init_distances(n, np.atleast_2d(queries), device=device).T.contiguous()


def _packed_expand(dist: torch.Tensor, level, graph, edge_chunks: int = 1) -> torch.Tensor:
    """The JAX package's ``_packed_expand``: one level for all K queries
    of the query-minor (n, K) ``dist`` at ``level`` (a scalar or (K,)),
    the (E, K) row gather and sorted byte max cut into ``edge_chunks``
    fixed-size slices whose maxima accumulate (the tail slice starts
    early and re-reads a few slots, harmless for a max).  Returns the
    (n, K) newly-reached mask."""
    n, k = dist.shape
    lvl = torch.as_tensor(level, device=dist.device).reshape(1, -1).expand(1, k)
    frontier = (dist == lvl).to(torch.uint8)
    e = graph.num_edges
    chunk = -(-e // max(edge_chunks, 1))
    cols, srcs = graph.col_indices.long(), graph.edge_src.long()
    hit = torch.zeros((n, k), dtype=torch.uint8, device=dist.device)
    if edge_chunks <= 1 or chunk >= e:
        segment_max_(hit, 0, srcs, frontier[cols])
    else:
        for c in range(edge_chunks):
            start = min(c * chunk, max(e - chunk, 0))
            part = torch.zeros_like(hit)
            segment_max_(part, 0, srcs[start : start + chunk],
                          frontier[cols[start : start + chunk]])
            torch.maximum(hit, part, out=hit)
    return (dist == NOT_REACHED) & (hit > 0)


def packed_carry_init(graph, queries) -> DistCarry:
    """The distance loop's carry over the query-minor matrix: ``dist`` is
    the (K, n) view of the (n, K) matrix :func:`packed_init` makes."""
    dist = packed_init(graph.n, queries, graph.device)
    k = dist.shape[1]
    level, stop, found = (
        torch.zeros(k, dtype=torch.int32, device=dist.device) for _ in range(3)
    )
    return DistCarry(
        dist=dist.T,
        level=level,
        updated=(dist == 0).any(dim=0).to(torch.int32),
        stop=stop,
        found=found,
        ctrl=torch.zeros(4, dtype=torch.int32, device=dist.device),
    )


def _pull_step(graph, edge_chunks: int, plain: bool):
    from .cuda_csr import csr_pull, csr_pull_plain  # lazy: cuda_csr -> bitbell -> packed

    pull = csr_pull_plain if plain else csr_pull
    return lambda carry: pull(graph, carry, edge_chunks)


def _packed_chunk(graph, carry, chunk, max_levels, edge_chunks, plain=False):
    """Advance the carry by at most ``chunk`` levels (None: to
    convergence or ``max_levels``), in place."""
    return distance_chunk(carry, _pull_step(graph, edge_chunks, plain), chunk, max_levels)


def packed_distances(
    graph, queries, max_levels: Optional[int] = None, edge_chunks: int = 1,
    plain: bool = False,
) -> torch.Tensor:
    """(K, S) queries -> (n, K) int32 distances, one run to convergence."""
    carry = packed_carry_init(graph, queries)
    _packed_chunk(graph, carry, None, max_levels, edge_chunks, plain)
    return carry.dist.T


def packed_distances_chunked(
    graph, queries, level_chunk: int, max_levels: Optional[int] = None,
    edge_chunks: int = 1, plain: bool = False,
) -> torch.Tensor:
    """:func:`packed_distances` with one host read every ``level_chunk``
    levels (ops.bfs.host_chunked_loop)."""
    carry = host_chunked_loop(
        packed_carry_init(graph, queries),
        lambda c: _packed_chunk(graph, c, level_chunk, max_levels, edge_chunks, plain),
        max_levels,
    )
    return carry.dist.T


def _f_from_packed_distances(dist: torch.Tensor) -> torch.Tensor:
    """(n, K) distances -> (K,) int64 F values."""
    return f_of_u(dist.T)


def packed_f_values(
    graph, queries, max_levels: Optional[int] = None, edge_chunks: int = 1,
    plain: bool = False,
) -> torch.Tensor:
    """(K, S) queries -> (K,) int64 F values (main.cu:75-89)."""
    return _f_from_packed_distances(
        packed_distances(graph, queries, max_levels, edge_chunks, plain)
    )


class PackedEngineBase(QueryEngineBase):
    """Shared surface of the query-minor engines: K-alignment padding,
    and the per-query stats from ``_distances(padded) -> (n, K)`` where a
    subclass has it."""

    k_align: int = K_ALIGN

    def _pad_queries(self, queries) -> Tuple[np.ndarray, int]:
        """(K, S) host queries -> (Kpad, S) int32 with -1 rows, and K.
        K = 0 still pads to one full alignment group so the level loop
        runs a fixed shape (results are sliced back to length 0)."""
        queries = np.asarray(queries, dtype=np.int32)
        k, s = queries.shape
        pad = (-k) % self.k_align if k else self.k_align
        if pad:
            queries = np.concatenate(
                [queries, np.full((pad, s), -1, dtype=np.int32)], axis=0
            )
        return queries, k

    def _distances(self, queries) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def query_stats(self, queries):
        """Per-query (levels, reached, F) from the packed distance matrix,
        at the padding ``f_values`` uses."""
        queries, k = self._pad_queries(queries)
        levels, reached, f = stats_from_distances(self._distances(queries).T)
        return tuple(x.cpu().numpy()[:k] for x in (levels, reached, f))


class PackedEngine(PackedEngineBase):
    """All queries at once over a DeviceCSR, distances query-minor.

    ``edge_chunks`` cuts the plain version's (E, K) gather into slices
    (the JAX package's memory knob; the kernel makes no such
    intermediate); ``k_align`` pads the query axis; ``level_chunk``
    bounds the levels between host reads (None: one run); ``plain`` runs
    the kernel's plain torch version."""

    def __init__(
        self,
        graph,
        max_levels: Optional[int] = None,
        edge_chunks: int = 1,
        k_align: int = K_ALIGN,
        level_chunk: Optional[int] = None,
        plain: bool = False,
    ):
        self.graph = graph
        self.device = graph.device
        self.max_levels = max_levels
        self.edge_chunks = edge_chunks
        self.k_align = k_align
        self.level_chunk = validate_level_chunk(level_chunk)
        self.plain = bool(plain)

    def _distances(self, queries) -> torch.Tensor:
        if self.level_chunk:
            return packed_distances_chunked(
                self.graph, queries, self.level_chunk, self.max_levels,
                self.edge_chunks, self.plain,
            )
        return packed_distances(
            self.graph, queries, self.max_levels, self.edge_chunks, self.plain
        )

    def f_values(self, queries) -> torch.Tensor:
        queries, k = self._pad_queries(queries)
        return _f_from_packed_distances(self._distances(queries))[:k]

    compile = Engine.compile


class SubBatchEngine:
    """Split very wide query batches into ordered ``batch_k``-wide
    sub-batches sharing one graph residency.

    The cross-batch winner is accepted on STRICT improvement only, so the
    result is the first strict minimum exactly as one batch computes it
    (reference tie-break, main.cu:379-397), ``min_k`` re-offset by the
    sub-batch's start row."""

    def __init__(self, inner, batch_k: int = 256):
        if batch_k <= 0:
            raise ValueError(f"batch_k must be positive (got {batch_k})")
        self.inner = inner
        self.batch_k = int(batch_k)

    def __getattr__(self, name):
        # Everything not overridden (graph, last_window_trace, ...) is the
        # wrapped engine's.
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _chunks(self, queries):
        for start in range(0, queries.shape[0], self.batch_k):
            yield start, queries[start : start + self.batch_k]

    def best(self, queries) -> Tuple[int, int]:
        queries = np.asarray(queries, dtype=np.int32)
        if queries.shape[0] <= self.batch_k:
            return self.inner.best(queries)
        best_f, best_k = -1, -1
        for start, sub in self._chunks(queries):
            f, kk = self.inner.best(sub)
            if kk >= 0 and (best_k < 0 or f < best_f):
                best_f, best_k = f, kk + start
        return best_f, best_k

    def f_values(self, queries) -> torch.Tensor:
        queries = np.asarray(queries, dtype=np.int32)
        if queries.shape[0] <= self.batch_k:
            return self.inner.f_values(queries)
        return torch.cat(
            [self.inner.f_values(sub) for _, sub in self._chunks(queries)]
        )

    def query_stats(self, queries):
        queries = np.asarray(queries, dtype=np.int32)
        if queries.shape[0] <= self.batch_k:
            return self.inner.query_stats(queries)
        parts = [self.inner.query_stats(sub) for _, sub in self._chunks(queries)]
        return tuple(
            np.concatenate([p[i] for p in parts]) for i in range(len(parts[0]))
        )

    def compile(self, queries_shape, **kwargs) -> None:
        """Warm the inner engine for every sub-batch shape the split
        produces (one full-width shape plus at most one tail shape)."""
        k, s = queries_shape
        shapes = {(min(self.batch_k, k) if k else 0, s)}
        if k > self.batch_k and k % self.batch_k:
            shapes.add((k % self.batch_k, s))
        for shape in sorted(shapes):
            self.inner.compile(shape, **kwargs)
