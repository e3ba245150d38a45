"""Packed-lane push BFS: one union frontier queue for all K queries (the
``ppush`` route).

The JAX package's ops/push_packed.py: the per-query push (ops.push) is
work-optimal for each query, but a level costs K separate hit scatters.
This engine keeps the K queries as bit lanes of (n, K/32) word planes and
ONE compacted queue over the union of their frontiers — the rows with a
nonzero word, ascending, at most ``capacity`` — so a level scatters each
listed row's words into its neighbours' rows once for the whole batch.
The capacity protocol (grow on overflow, shrink on measured headroom) is
PushEngine's, on the union queue's row count (``peak``).

Here a level is two kernels: K3 (``csrc/push_or.cu``, ops/bitbell.py
``sparse_hits_or``), whose walk ORs each listed row's words into its
neighbours' hit rows over the padded table's dedup CSR (the table's rows
without their sentinel slots: no slot names n, so nothing lands on a
sentinel row; on a road grid about 70 % of the table's slots are
sentinels, and their atomics on one hit word would serialise the walk);
then K11's row mode (``ops/cuda_push.py`` ``row_compact``): the apply
(new = hits & ~visited, the per-lane counters, the control) and the next
union queue in the same pass, each listed row with its first edge, into
the worklist K3 reads.  The level-apply kernel K2 is not on this route:
the list its switch epilogue makes is appended in any order, where the
union queue must hold the ascending first ``capacity`` rows (the later
levels' row counts, and so the capacity protocol, depend on which rows
were kept), so K2 would leave a second pass over the planes to make.
"""

from __future__ import annotations

import numpy as np
import torch

from .bfs import INT32_MAX
from .bitbell import (
    DIR_PUSH,
    WORD_BITS,
    PushSwitch,
    batch_start,
    bit_level_chunk,
    sparse_hits_or,
    sparse_hits_or_plain,
)
from .cuda_push import (
    RowQueueCarry,
    row_compact,
    row_compact_plain,
    row_queue_scratch,
)
from .push import PaddedAdjacency, PushEngine, push_run
from .push import table_csr as _table_csr


def _packed_init_batch(adj: PaddedAdjacency, queries, capacity: int, plain: bool = False):
    """The carry (:class:`.cuda_push.RowQueueCarry`) from a (k_pad, S)
    -1-padded batch, k_pad a multiple of 32: the sources' plane from the
    batch start (K4), made the hit plane of a level -1 that nothing has
    visited, so that K11's row mode counts the sources at distance 0
    (levels 1, reached, F 0, the control) and lists their union queue and
    ``peak``, as the JAX init does; with ``plain``, the plain versions of
    both."""
    n, dev = adj.n, adj.device
    _, vals, deg = _table_csr(adj)
    start = batch_start(n, queries, dev, plain=plain)
    w = start.visited.shape[1]
    switch = PushSwitch.new(deg, capacity, int(vals.shape[0]), w)
    switch.hits.copy_(start.frontier)
    for t in (start.visited, start.frontier, start.levels, start.reached):
        t.zero_()
    start.ctrl[0] = 1
    start.ctrl[1] = -1
    start.ctrl[3] = DIR_PUSH
    offsets, nonzero = row_queue_scratch(n, dev)
    carry = RowQueueCarry(
        visited=start.visited, frontier=start.frontier, hits=switch.hits,
        f=start.f, levels=start.levels, reached=start.reached, counts=start.counts,
        switch=switch, count=torch.zeros(1, dtype=torch.int32, device=dev),
        peak=torch.zeros(1, dtype=torch.int32, device=dev),
        offsets=offsets, ctrl=start.ctrl, nonzero=nonzero,
    )
    (row_compact_plain if plain else row_compact)(carry)
    return carry


def packed_push_level(adj: PaddedAdjacency, carry: RowQueueCarry, max_levels: int,
                      plain: bool = False) -> None:
    """One gated level: K3 over the union queue, then K11's row mode (or
    their plain versions)."""
    start, vals, _ = _table_csr(adj)
    scatter = sparse_hits_or_plain if plain else sparse_hits_or
    scatter(carry.frontier, start, vals, carry.hits, carry.ctrl, carry.switch, max_levels)
    compact = row_compact_plain if plain else row_compact
    compact(carry, max_levels)


def _packed_chunk_batch(adj, carry, capacity, chunk, max_levels, plain: bool = False):
    """Advance the union-frontier BFS by at most ``chunk`` levels (or to
    ``max_levels`` / convergence), in place; one level counter for the
    batch, on the device."""
    bound = INT32_MAX if max_levels is None else int(max_levels)
    bit_level_chunk(carry, lambda c: packed_push_level(adj, c, bound, plain), chunk, bound)
    return carry


def _pad_rows(queries, k_pad: int) -> np.ndarray:
    q = np.asarray(queries)
    out = np.full((k_pad, q.shape[1]), -1, dtype=np.int32)
    out[: q.shape[0]] = q
    return out


def _k_pad(k: int) -> int:
    return -(-max(k, 1) // WORD_BITS) * WORD_BITS


class PackedPushEngine(PushEngine):
    """Union-frontier packed-lane push engine over a PaddedAdjacency: the
    whole PushEngine surface (auto or explicit ``capacity`` with the same
    protocol, ``max_levels``, the chunked loop, query_stats, the stepped
    trace), with ``capacity`` bounding the union queue's rows."""

    def _dispatch(self, queries):
        k_pad = _k_pad(queries.shape[0])
        if self.graph.n == 0:
            z32 = torch.zeros(k_pad, dtype=torch.int32, device=self.device)
            return (torch.zeros(k_pad, dtype=torch.int64, device=self.device), z32, z32,
                    torch.zeros(1, dtype=torch.int32, device=self.device))
        return push_run(
            self.graph, _pad_rows(queries, k_pad), self.capacity, self.max_levels,
            init_fn=_packed_init_batch, chunk_fn=_packed_chunk_batch, plain=self.plain,
        )

    # The stepped trace: the same carry a level at a time; its per-lane
    # rows are k_pad wide, trimmed to the batch's queries.
    def _trace_init(self, queries):
        self._trace_k = queries.shape[0]
        return _packed_init_batch(
            self.graph, _pad_rows(queries, _k_pad(queries.shape[0])), self.capacity,
            self.plain,
        )

    def _trace_chunk(self, carry):
        return _packed_chunk_batch(self.graph, carry, self.capacity, 1, self.max_levels,
                                   self.plain)

    def _to_query_order(self, x) -> np.ndarray:
        return x.cpu().numpy()[: self._trace_k]
