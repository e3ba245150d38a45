"""Owner-partitioned push BFS over the 'v' mesh axis.

The JAX package's parallel/push_sharded.py: a road-class graph cut into p
vertex blocks, shard b holding only the width-padded rows of its block
(global neighbour ids), each shard advancing a compacted queue of its own
frontier rows for all K bit-packed queries at once, and the shards
exchanging per level only their boundary discoveries — neighbours that
another shard owns — as compacted (global id, words) pairs over one
all-gather.  A level of one q-shard:

* each shard's expansion (H3 ``owner_push_expand``): its queue's table
  rows, the in-block neighbours ORed into its own hit rows, the
  out-of-block ones compacted in slot order into at most ``boundary``
  pairs, the boundary count and its peak;
* the pairs all-gathered over 'v' and landed at their owner (H1
  ``halo_pair_or``, rows offset by the receiver's block);
* each shard's apply and next queue in one pass (K11 ``queue_compact``'s
  row mode, capacity ``capacity``), which also keeps the peak of the own
  frontier's rows.

Each shard counts its own discoveries (merged over 'v' as in
parallel/sharded_bell.py), and the updated flags are max-reduced after
every level on the device, so no host read happens inside a chunk.
Capacities are shapes: a run whose peaks (max over the mesh) exceeded
``capacity`` or ``boundary`` is discarded and rerun at the grown bounds
(auto), or raises :class:`..ops.push.FrontierOverflow` (explicit bounds);
the truncated run keeps JAX's order, so its peaks, and the grown bounds,
are JAX's.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.csr import CSRGraph
from ..ops.bfs import INT32_MAX, validate_level_chunk
from ..ops.bitbell import PushSwitch, _ConvergencePeek, batch_start
from ..ops.cuda_halo import ScanScratch, expand_tiles, halo_pair_or, owner_push_expand
from ..ops.cuda_push import RowQueueCarry, row_compact, row_queue_scratch
from ..ops.engine import QueryEngineBase
from ..ops.push import DEFAULT_MAX_WIDTH
from ..utils.timing import record_dispatch
from .collectives import all_gather, on_device, pmax, psum
from .distributed import pad_qblock, stacked_read, stepped_level_stats
from .mesh import QUERY_AXIS, VERTEX_AXIS
from .scheduler import merge_local_f, shard_queries


def build_sharded_adjacency(
    g: CSRGraph, p: int, max_width: int = DEFAULT_MAX_WIDTH, native: bool = True
) -> Tuple[np.ndarray, int, int, int]:
    """Partition ``g`` into ``p`` contiguous vertex blocks of length L and
    build the stacked (p, L + 1, w) width-padded own-row tables: global
    neighbour ids, sentinel n_pad, row L of every block all sentinel;
    duplicates and self-loops dropped.  Raises ValueError when the max
    degree exceeds ``max_width``.  Returns (tables, L, n_pad, w)."""
    n = g.n
    L = -(-max(n, 1) // p)
    n_pad = p * L
    u, v, deg = g.deduped_pairs(native)
    w = int(deg.max()) if n and deg.size else 0
    w = max(w, 1)
    if w > max_width:
        raise ValueError(
            f"max degree {w} exceeds width cap {max_width}: the "
            "owner-partitioned push engine targets low-degree "
            "(road-class) graphs; use the sharded bitbell engine instead"
        )
    stacked = np.full((p, L + 1, w), n_pad, dtype=np.int32)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    col = np.arange(u.size, dtype=np.int64) - offs[u]
    stacked[u // L, u % L, col] = v.astype(np.int32)
    return stacked, L, n_pad, w


def default_capacity(n_pad: int, block: int) -> int:
    """Auto own-frontier capacity per shard: 8 sqrt(n), floor 2048, at
    most the block length (always enough)."""
    return int(min(max(block, 1), max(2048, 8 * int(max(n_pad, 1) ** 0.5))))


def default_boundary(capacity: int, width: int) -> int:
    """Auto boundary-pair budget per shard: well below the worst case
    (capacity * width, always enough); the overflow protocol grows it."""
    return int(min(capacity * width, max(1024, capacity // 2)))


class _Shard:
    """One (q, v) shard's carry, its boundary send buffers and H3's scan
    scratch."""

    def __init__(self, carry, bnd_ids, bnd_words, bcount, peak_b, scan):
        self.carry = carry
        self.bnd_ids = bnd_ids
        self.bnd_words = bnd_words
        self.bcount = bcount
        self.peak_b = peak_b
        self.scan = scan


def sharded_push_run(engine: "ShardedPushEngine", grid: np.ndarray, k: int, k_pad: int):
    """One owner-partitioned push over the whole mesh at the engine's
    bounds, chunk after chunk with one stacked read each.  Returns (f,
    levels, reached) merged (k_pad,) and the peaks (own frontier rows,
    boundary slots), max over the mesh; a peak above its bound means the
    run was truncated and must be discarded."""
    rows, j = engine._init(grid)
    while True:
        engine._chunk(rows, engine.level_chunk)
        ctrl = engine._status(rows)
        if not ctrl[:, 0].any() or ctrl[:, 1].max() >= engine._max_levels:
            break
    peak_f, peak_b = engine._peaks(rows)
    return (*engine._finish(rows, j, k, k_pad), peak_f, peak_b)


class ShardedPushEngine(QueryEngineBase):
    """Owner-partitioned work-optimal BFS: queries round-robin over 'q',
    the adjacency partitioned over 'v', a boundary-pair exchange a level.

    ``capacity`` / ``boundary`` bound each shard's queue and boundary send;
    None is the auto mode (:func:`default_capacity`,
    :func:`default_boundary`, grown and rerun on overflow), ints are hard
    bounds.  ``level_chunk``: levels between host reads (default
    ``MSBFS_PUSH_CHUNK``, 64)."""

    CAPABILITIES = frozenset(
        {
            "query_sharded",
            "vertex_sharded",
            "plane:word",
            "residency:hbm",
            "partition:1d",
            "kernel:xla",
        }
    )

    def __init__(
        self,
        mesh,
        graph: CSRGraph,
        max_levels: Optional[int] = None,
        max_width: int = DEFAULT_MAX_WIDTH,
        capacity: Optional[int] = None,
        boundary: Optional[int] = None,
        level_chunk: Optional[int] = None,
        native: bool = True,
    ):
        from ..ops.push import default_push_chunk

        self.mesh = mesh
        self.w = mesh.shape[QUERY_AXIS]
        self.p = mesh.shape[VERTEX_AXIS]
        self.n = graph.n
        stacked, self.block, self.n_pad, self.width = build_sharded_adjacency(
            graph, self.p, max_width, native)
        self.tables = {
            (b, dev): torch.from_numpy(stacked[b]).to(dev)
            for b in range(self.p) for dev in dict.fromkeys(mesh.devices[:, b])
        }
        self.max_levels = max_levels
        self._max_levels = INT32_MAX if max_levels is None else int(max_levels)
        self.auto_capacity = capacity is None
        self.capacity = (default_capacity(self.n_pad, self.block) if capacity is None
                         else int(capacity))
        self.auto_boundary = boundary is None
        self.boundary = (default_boundary(self.capacity, self.width) if boundary is None
                         else int(boundary))
        self.level_chunk = validate_level_chunk(level_chunk) or default_push_chunk()
        self._peak_f = 0  # the peaks over every run so far
        self._peak_b = 0
        self._level_warm_shapes = set()

    def _bounds_held(self, peak_f: int, peak_b: int) -> bool:
        """True when the run's peaks fit the bounds; otherwise grow (auto,
        the caller reruns) or raise (explicit bounds)."""
        from ..ops.push import FrontierOverflow

        ok_f, ok_b = peak_f <= self.capacity, peak_b <= self.boundary
        if ok_f and ok_b:
            self._peak_f = max(self._peak_f, peak_f)
            self._peak_b = max(self._peak_b, peak_b)
            return True
        if (not ok_f and not self.auto_capacity) or (not ok_b and not self.auto_boundary):
            raise FrontierOverflow(
                f"sharded push overflow: a level needed frontier >= "
                f"{peak_f} (capacity={self.capacity}) or boundary >= "
                f"{peak_b} (boundary={self.boundary}); construct "
                "ShardedPushEngine with larger bounds"
            )
        if not ok_f:
            self.capacity = min(self.block, max(2 * self.capacity, 4 * peak_f))
        if not ok_b:
            self.boundary = min(self.capacity * self.width, max(2 * self.boundary, 4 * peak_b))
        print(
            "ShardedPushEngine: overflow (frontier "
            f"{peak_f}, boundary {peak_b}); re-running at "
            f"capacity={self.capacity}, boundary={self.boundary}",
            file=sys.stderr,
        )
        return False

    def _prologue(self, queries):
        queries = np.asarray(queries)
        queries = np.where((queries >= 0) & (queries < self.n), queries, -1)
        return shard_queries(self.mesh, queries, None)

    # ---- the level loop -----------------------------------------------------
    def _init(self, grid) -> Tuple[List[List[_Shard]], int]:
        """Every (q, v) shard's own-block carry (the sources as the hits of
        a level -1, counted at distance 0 by K11's row mode, which lists
        their queue and peak) and its boundary buffers."""
        L = self.block
        rows = []
        for r in range(self.w):
            qblock, _ = pad_qblock(grid[r])
            w_words = qblock.shape[0] // 32
            shards = []
            for b, dev in enumerate(self.mesh.devices[r]):
                lo = b * L
                local = np.where((qblock >= lo) & (qblock < lo + L), qblock - lo, -1)
                with on_device(dev):
                    start = batch_start(L, local, dev)
                    switch = PushSwitch.new(torch.zeros(L, dtype=torch.int32, device=dev),
                                            self.capacity, 0, w_words)
                    switch.hits.copy_(start.frontier)
                    for t in (start.visited, start.frontier, start.levels, start.reached):
                        t.zero_()
                    start.ctrl.copy_(torch.tensor([1, -1, 0, 0], dtype=torch.int32))
                    offsets, nonzero = row_queue_scratch(L, dev)
                    carry = RowQueueCarry(
                        visited=start.visited, frontier=start.frontier, hits=switch.hits,
                        f=start.f, levels=start.levels, reached=start.reached,
                        counts=start.counts, switch=switch,
                        count=torch.zeros(1, dtype=torch.int32, device=dev),
                        peak=torch.zeros(1, dtype=torch.int32, device=dev),
                        offsets=offsets, ctrl=start.ctrl, nonzero=nonzero,
                    )
                    self._apply(carry)
                    zi = torch.zeros(1, dtype=torch.int32, device=dev)
                    shards.append(_Shard(
                        carry,
                        torch.full((self.boundary,), self.n_pad, dtype=torch.int32, device=dev),
                        torch.zeros((self.boundary, w_words), dtype=torch.int32, device=dev),
                        zi, zi.clone(), ScanScratch(expand_tiles(self.capacity, self.width), dev),
                    ))
            self._combine(r, shards)
            rows.append(shards)
        return rows, grid.shape[1]

    def _apply(self, carry) -> None:
        row_compact(carry, self._max_levels)

    def _combine(self, r: int, shards: List[_Shard]) -> None:
        """The q-shard's updated flag: the max over its 'v' shards."""
        if len(shards) == 1:
            return
        merged = pmax([s.carry.ctrl[:1] for s in shards])
        for dev, s, m in zip(self.mesh.devices[r], shards, merged):
            with on_device(dev):
                s.carry.ctrl[:1].copy_(m)

    def _level(self, r: int, shards: List[_Shard]) -> None:
        devs = self.mesh.devices[r]
        L = self.block
        for b, (dev, s) in enumerate(zip(devs, shards)):
            c = s.carry
            with on_device(dev):
                owner_push_expand(self.tables[b, dev], c.switch.worklist[0], c.count,
                                  c.frontier, c.hits, b * L, self.n_pad, s.bnd_ids,
                                  s.bnd_words, s.bcount, s.peak_b, c.ctrl, self._max_levels,
                                  s.scan)
        if len(shards) > 1:
            ids = all_gather([s.bnd_ids for s in shards])
            words = all_gather([s.bnd_words for s in shards])
            for b, (dev, s) in enumerate(zip(devs, shards)):
                with on_device(dev):
                    halo_pair_or(ids[b], words[b], s.carry.hits, b * L, s.carry.ctrl,
                                 self._max_levels)
        for dev, s in zip(devs, shards):
            with on_device(dev):
                self._apply(s.carry)
        self._combine(r, shards)

    def _chunk(self, rows, bound) -> None:
        """Up to ``bound`` levels of every q-shard, stopping early once a
        non-blocking peek shows every q-shard stopped; no host read."""
        peeks = [_ConvergencePeek(shards[0].carry.ctrl, self._max_levels) for shards in rows]

        def stopped(r, pk):
            with on_device(self.mesh.devices[r, 0]):
                return pk.stopped()

        for _ in range(bound):
            if all([stopped(r, pk) for r, pk in enumerate(peeks)]):
                return
            for r, shards in enumerate(rows):
                self._level(r, shards)

    def _status(self, rows) -> np.ndarray:
        return stacked_read([shards[0].carry.ctrl[:2] for shards in rows])

    def _peaks(self, rows) -> Tuple[int, int]:
        peaks = stacked_read([torch.cat([s.carry.peak, s.peak_b])
                              for shards in rows for s in shards])
        return int(peaks[:, 0].max()), int(peaks[:, 1].max())

    def _finish(self, rows, j: int, k: int, k_pad: int):
        out = []
        for name, reduce in (("f", psum), ("levels", pmax), ("reached", psum)):
            parts = [reduce([getattr(s.carry, name) for s in shards])[0] for shards in rows]
            out.append(merge_local_f(parts, j, self.w, k, k_pad)[0])
        return tuple(out)

    def _run(self, queries):
        grid, k, k_pad, _ = self._prologue(queries)
        while True:
            f, levels, reached, peak_f, peak_b = sharded_push_run(self, grid, k, k_pad)
            if self._bounds_held(peak_f, peak_b):
                return f, levels, reached, k

    def level_stats(self, queries):
        """Per-level trace (``MSBFS_STATS=2``): the shared stepped loop
        at one level a step; an overflowed trace is discarded and retraced
        at the grown bounds, as :meth:`_run` does."""
        grid, k, k_pad, _ = self._prologue(queries)
        while True:
            state = {}

            def init():
                rows, state["j"] = self._init(grid)
                state["rows"] = rows
                return rows

            def step(rows):
                self._chunk(rows, 1)
                return rows

            def finish(rows):
                return self._finish(rows, state["j"], k, k_pad)

            def running(rows):
                return bool(self._status(rows)[:, 0].any())

            key = (np.asarray(queries).shape, self.capacity, self.boundary)
            out = stepped_level_stats(init, step, finish, k, self.max_levels,
                                      key in self._level_warm_shapes, running)
            self._level_warm_shapes.add(key)
            peak_f, peak_b = self._peaks(state["rows"])
            if self._bounds_held(peak_f, peak_b):
                return out

    def f_values(self, queries) -> torch.Tensor:
        f, _, _, k = self._run(queries)
        return f[:k]

    def query_stats(self, queries):
        f, levels, reached, k = self._run(queries)
        record_dispatch()
        return (
            levels[:k].cpu().numpy().astype(np.int32),
            reached[:k].cpu().numpy().astype(np.int32),
            f[:k].cpu().numpy(),
        )
