"""Frontier-compacted push BFS for high-diameter, low-degree graphs (the
``push`` route).

The JAX package's ops/push.py: the level-synchronous pull engines touch
every edge slot every level, which is O(D * E) on road networks and grids
whose diameter D runs to thousands of levels.  This engine does the
work-optimal dual, the queue-based BFS the reference's kernel
approximates by skipping non-frontier threads (main.cu:21-23): each
query keeps a compacted queue of at most ``capacity`` frontier ids; a
level gathers only the queued rows of a width-padded adjacency table and
marks their neighbours in a byte hit plane; the next queue is the new
vertices in ascending order.  If a level's frontier exceeds the capacity
the run is rejected (the engine grows and reruns, or raises), never
silently truncated.

Here a level is two kernels (``ops/cuda_push.py``): K10 ``queue_expand``
(the queued rows' neighbours over the table's dedup CSR, ``table_csr``:
their hit bytes and the flags of the tiles they land in) and K11
``queue_compact`` (on the flagged tiles, new = hit & ~visited, the
counters and the ascending capped queue), gated on the device; the host
reads one flag a chunk of levels.
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.csr import CSRGraph
from ..runtime.supervisor import CapacityError
from ..utils import knobs
from ..utils.timing import record_dispatch
from .bfs import arm_chunk
from .bitbell import bit_level_chunk
from .cuda_push import (
    compact_queue_plain,
    queue_carry_init,
    queue_compact,
    queue_compact_plain,
    queue_expand,
    queue_expand_plain,
)
from .engine import QueryEngineBase

DEFAULT_MAX_WIDTH = 64


def compact_indices(mask: torch.Tensor, capacity: int, fill_value: Optional[int] = None):
    """(m,) 0/1 plane -> (capacity,) int32 indices of the set entries,
    ascending, padded with ``fill_value`` (default m); entries past the
    capacity drop (the caller's count sees them)."""
    m = mask.shape[0]
    fill = m if fill_value is None else fill_value
    return compact_queue_plain(mask[None, :], capacity, fill)[0]


def compact_frontier_planes(planes: torch.Tensor, budget: int, block: int):
    """Compact an (L, W) int32 bit-plane frontier under ``budget`` rows:
    (count, ids, valid, words) — the active rows' count in full, their
    ids ascending (sentinel ``block`` past them), the real-entry mask, and
    each listed row's words (zero on padding)."""
    active = (planes != 0).any(dim=1)
    count = active.sum(dtype=torch.int32)
    ids = compact_indices(active, budget, fill_value=block)
    valid = ids < block
    words = torch.where(
        valid[:, None], planes[torch.clamp(ids, max=block - 1).long()], 0
    )
    return count, ids, valid, words


class PaddedAdjacency:
    """(n+1, w) neighbour table on one device: row v = v's deduped
    neighbours ascending, sentinel n after them; row n all sentinel.
    Requires max degree <= w, the defining property of the road class."""

    def __init__(self, rows: torch.Tensor, n: int, width: int, num_edges: int):
        self.rows = rows  # (n+1, w) int32
        self.n = int(n)
        self.width = int(width)
        self.num_edges = int(num_edges)  # directed slots after dedup

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @staticmethod
    def host_rows(g: CSRGraph, max_width: int = DEFAULT_MAX_WIDTH, native: bool = True):
        """(rows (n+1, w) int32 NumPy, w, dedup slots); duplicate
        neighbours and self-loops are dropped (set semantics)."""
        n = g.n
        u, v, deg = g.deduped_pairs(native)
        w = int(deg.max()) if n and deg.size else 0
        w = max(w, 1)
        if w > max_width:
            raise ValueError(
                f"max degree {w} exceeds width cap {max_width}: this "
                "engine targets low-degree (road-class) graphs; use the "
                "bitbell engine instead"
            )
        rows = np.full((n + 1, w), n, dtype=np.int32)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg, out=offs[1:])
        col = np.arange(u.size, dtype=np.int64) - offs[u]
        rows[u, col] = v.astype(np.int32)
        return rows, w, int(u.size)

    @staticmethod
    def from_host(
        g: CSRGraph, device, max_width: int = DEFAULT_MAX_WIDTH, native: bool = True
    ) -> "PaddedAdjacency":
        rows, w, e = PaddedAdjacency.host_rows(g, max_width, native)
        return PaddedAdjacency(torch.from_numpy(rows).to(device), g.n, w, e)

    def __repr__(self):
        return f"PaddedAdjacency(n={self.n}, width={self.width})"


def table_csr(adj: PaddedAdjacency):
    """The padded table's rows without their sentinel slots, as a CSR:
    (start (n,), vals (E,), out-degrees (n,)) int32, the rows' neighbours
    ascending as in the table; built once and cached on the table (K10
    and K3 walk it: on a road grid about 70 % of the table's slots are
    sentinels).  ``start`` is the head of the (n + 1,) offsets, whose last
    entry E lies past it: K10 reads a row's end beside its start."""
    csr = getattr(adj, "_csr", None)
    if csr is None:
        table = adj.rows[: adj.n]
        real = table != adj.n
        deg = real.sum(dim=1, dtype=torch.int32)
        offsets = torch.zeros(adj.n + 1, dtype=torch.int32, device=table.device)
        torch.cumsum(deg, 0, dtype=torch.int32, out=offsets[1:])
        csr = adj._csr = (offsets[: adj.n], table[real].contiguous(), deg)
    return csr


def _push_init_batch(adj: PaddedAdjacency, queries, capacity: int, plain: bool = False):
    """The batch's carry (:class:`.cuda_push.QueueCarry`) from (K, S)
    -1-padded queries."""
    return queue_carry_init(adj.n, adj.rows, queries, capacity, plain)


def push_level(adj: PaddedAdjacency, carry, plain: bool = False) -> None:
    """One gated level: K10 then K11 (or their plain versions)."""
    if plain:
        queue_expand_plain(adj.rows, carry)
        queue_compact_plain(carry)
    else:
        queue_expand(adj.rows, carry, table_csr(adj))
        queue_compact(carry)


def _push_chunk_batch(adj, carry, capacity, chunk, max_levels, plain: bool = False):
    """Advance every query by at most ``chunk`` levels (or to
    ``max_levels`` / convergence), in place: each query's bound is its
    own level + chunk, as under JAX's vmap."""
    arm_chunk(carry, chunk, max_levels)
    bit_level_chunk(carry, lambda c: push_level(adj, c, plain), chunk)
    return carry


def default_push_chunk() -> int:
    """Levels a dispatch (``MSBFS_PUSH_CHUNK``, default 64; a malformed or
    non-positive value gives 64 or 1, as in the JAX package)."""
    try:
        return max(1, knobs.get_int("MSBFS_PUSH_CHUNK", 64))
    except ValueError:
        return 64


def push_run(
    adj,
    queries,
    capacity: int,
    max_levels=None,
    chunk: Optional[int] = None,
    init_fn=_push_init_batch,
    chunk_fn=_push_chunk_batch,
    plain: bool = False,
):
    """Per-query (f, levels, reached, max_count) device tensors in the
    batch layout of ``init_fn``; max_count > capacity means the run
    overflowed.  Each chunk advances every query by at most ``chunk``
    levels; the host then reads one flag (is any query still running)."""
    if chunk is None:
        chunk = default_push_chunk()
    carry = init_fn(adj, queries, capacity, plain)
    while True:
        carry = chunk_fn(adj, carry, capacity, chunk, max_levels, plain)
        record_dispatch()
        if not bool(carry.running(max_levels)):
            break
    return carry.outputs()


class FrontierOverflow(CapacityError):
    """A level's frontier exceeded the engine's capacity; rerun with a
    larger ``capacity`` (results were not truncated: the run is
    rejected).  A :class:`~..runtime.supervisor.CapacityError`: exit 3."""


class PushEngine(QueryEngineBase):
    """Queue-based per-query engine over a PaddedAdjacency.

    ``capacity`` bounds each queue.  None is the auto mode: start at
    min(n, max(2048, 8 sqrt(n))); a run that overflows reruns at
    min(n, max(2 capacity, 4 need)), said on stderr; once a run fits and
    found something, shrink to min(n, max(1024, 2 peak)) when that is
    below half the capacity (the peak over every run so far).  An
    explicit int is a hard bound: overflow raises
    :class:`FrontierOverflow`.  ``plain`` runs the kernels' plain torch
    versions."""

    def __init__(
        self,
        graph: PaddedAdjacency,
        capacity: Optional[int] = None,
        max_levels: Optional[int] = None,
        plain: bool = False,
    ):
        self.graph = graph
        self.device = graph.device
        self.auto_capacity = capacity is None
        n = max(graph.n, 1)
        if self.auto_capacity:
            self.capacity = min(n, max(2048, 8 * int(n**0.5)))
        else:
            self.capacity = int(capacity)
        self.max_levels = max_levels
        self.plain = bool(plain)
        self._max_need = 0  # the peak frontier over every run so far

    def _dispatch(self, queries):
        """One full push BFS of the (K, S) batch at the current capacity:
        per-query (f, levels, reached, max_count) tensors."""
        return push_run(self.graph, queries, self.capacity, self.max_levels, plain=self.plain)

    # The stepped trace (level_stats): subclasses with another carry
    # override these three.
    def _trace_init(self, queries):
        return _push_init_batch(self.graph, queries, self.capacity, self.plain)

    def _trace_chunk(self, carry):
        return _push_chunk_batch(self.graph, carry, self.capacity, 1, self.max_levels,
                                 self.plain)

    def _to_query_order(self, x) -> np.ndarray:
        return x.cpu().numpy()

    def _overflow(self, need: int):
        return FrontierOverflow(
            f"frontier exceeded capacity={self.capacity} (a level "
            f"needed >= {need}); construct PushEngine with a larger "
            "capacity"
        )

    def _grow(self, need: int, verb: str) -> None:
        grown = min(self.graph.n, max(2 * self.capacity, 4 * need))
        print(
            f"PushEngine: frontier overflowed capacity={self.capacity} "
            f"(level needed >= {need}); {verb} at {grown}",
            file=sys.stderr,
        )
        self.capacity = grown

    def _run(self, queries) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        queries = np.asarray(queries, dtype=np.int32)
        k = queries.shape[0]
        if k == 0:
            queries = np.full((1, queries.shape[1]), -1, dtype=np.int32)
        while True:
            f, levels, reached, max_count = self._dispatch(queries)
            need = int(max_count[:k].max()) if k else 0
            if need <= self.capacity:
                self._max_need = max(self._max_need, need)
                if (
                    self.auto_capacity
                    and need > 0
                    and 2 * self._max_need < self.capacity // 2
                ):
                    # Growth overshoots on purpose (a retry costs a whole
                    # run); once the peak is known, shrink.  The peak over
                    # every run is the bound, so alternating thin and fat
                    # batches do not thrash, and a batch with no source
                    # (the warm-up's) never adapts the capacity.
                    self.capacity = min(
                        max(self.graph.n, 1), max(1024, 2 * self._max_need)
                    )
                return f[:k], levels[:k], reached[:k]
            if not self.auto_capacity:
                raise self._overflow(need)
            self._grow(need, "re-running")

    def f_values(self, queries) -> torch.Tensor:
        return self._run(queries)[0]

    def query_stats(self, queries):
        f, levels, reached = self._run(queries)
        return levels.cpu().numpy(), reached.cpu().numpy(), f.cpu().numpy()

    def level_stats(self, queries):
        """Per-level trace (MSBFS_STATS=2): one level a step, each timed,
        with the BitBellEngine.level_stats contract — (levels, reached, f,
        level_counts, level_seconds), row d of ``level_counts`` the
        vertices found at distance d a query (row 0 the sources); an
        auto-capacity overflow restarts the trace at the grown capacity."""
        queries = np.asarray(queries, dtype=np.int32)
        k = queries.shape[0]
        if k == 0:
            z = np.zeros(0, dtype=np.int64)
            return (z.astype(np.int32), z.astype(np.int32), z,
                    np.zeros((0, 0), dtype=np.int64), np.zeros(0))
        while True:
            t0 = time.perf_counter()
            carry = self._trace_init(queries)
            f, levels, reached_t, need_t = carry.outputs()
            reached_prev = self._to_query_order(reached_t).astype(np.int64)
            level_counts = [reached_prev.copy()]
            level_seconds = [time.perf_counter() - t0]
            while True:
                t0 = time.perf_counter()
                carry = self._trace_chunk(carry)
                f, levels, reached_t, need_t = carry.outputs()
                reached = self._to_query_order(reached_t).astype(np.int64)
                level_seconds.append(time.perf_counter() - t0)
                level_counts.append(reached - reached_prev)
                reached_prev = reached
                if not bool(carry.running(self.max_levels)):
                    break
            need = int(need_t.max())
            if need <= self.capacity:
                break
            if not self.auto_capacity:
                raise self._overflow(need)
            self._grow(need, "re-tracing")
        return (
            self._to_query_order(levels),
            reached_prev.astype(np.int32),
            self._to_query_order(f),
            np.stack(level_counts),
            np.asarray(level_seconds),
        )

    def compile(self, queries_shape, warm_stats: bool = False, warm_levels: bool = False) -> None:
        """Build and load the kernels, then run one all-padding batch (as
        the JAX engine warms: a source-less batch never adapts the
        capacity)."""
        if self.device.type == "cuda" and not self.plain:
            from ..runtime import kernels

            kernels.library()
        super().compile(queries_shape, warm_stats, warm_levels)
