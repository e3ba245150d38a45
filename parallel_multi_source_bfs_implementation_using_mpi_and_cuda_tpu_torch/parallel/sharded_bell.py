"""Vertex-sharded bit-plane BFS: the bitbell engine over a partitioned CSR.

The JAX package's parallel/sharded_bell.py.  All K queries of a q-shard
advance together as bit planes, and the graph is cut into p vertex blocks
over the 'v' axis: shard b owns rows [b*L, (b+1)*L) and a BELL forest
over the global owner space in which only its own rows have neighbours.
A level of one q-shard:

* the halo: the global frontier planes are all-gathered from the shards'
  own (L, W) blocks (the dense route), or, when every shard's own
  frontier has at most ``halo_budget`` rows, each shard sends its
  compacted (global id, words) pairs instead (the sparse route), and the
  receivers rebuild the planes from them (H1 ``halo_pair_or``) or, when
  the pairs' in-block edges fit ``push_budget``, push them straight into
  their own hit rows (H2: ``halo_push_match`` finds each pair's in-block
  edges once, its total feeds the route decision, and ``halo_push_or``
  spreads the matched edges);
* each shard's forest pass (K1 ``forest_or``) over the gathered planes,
  whose own rows are the shard's hits;
* each shard's apply and row queue in one pass (K11 ``queue_compact``'s
  row mode): new = hits & ~visited over its own block, the counters of
  its own discoveries, and the compacted own frontier the sparse route
  sends next level.

Each shard counts its own discoveries; the merge adds the shards' F and
reached over 'v' and takes the max of their levels, which is JAX's psum
of the own-block counts.  The shards' updated flags are max-reduced after
every level on the device, so the level loop of a q-shard stops when no
shard of it found anything.

The port decides each level's route as the JAX ``pmax`` / ``cond`` do —
the max over 'v' of the own-frontier rows against ``halo_budget``, then
per shard the pairs' in-block edges against ``push_budget`` — with one
stacked read of every shard's counts a level (only when the sparse
route is on); the dense-only loop reads once a chunk.  ``last_halo_trace``
and the collective-bytes counter therefore equal the JAX package's.
JAX pads the shards' forests to one shape for its SPMD program
(``harmonize_forests``); no reported number depends on those shapes, so
each shard here keeps its own forest.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.bell import DEFAULT_WIDTHS, BellGraph
from ..models.csr import CSRGraph
from ..ops.bfs import INT32_MAX, validate_level_chunk
from ..ops.bitbell import PushSwitch, _ConvergencePeek, batch_start
from ..ops.cuda_bell import forest_or, forest_scratch
from ..ops.cuda_halo import halo_pair_or, halo_push_match, halo_push_or, pair_words
from ..ops.cuda_push import RowQueueCarry, row_compact, row_queue_scratch
from ..ops.engine import QueryEngineBase
from ..utils.timing import record_collective_bytes, record_dispatch
from .collectives import all_gather, on_device, pmax, psum, to_device
from .distributed import pad_qblock, stacked_read, stacked_read_ragged, stepped_level_stats
from .mesh import QUERY_AXIS, VERTEX_AXIS
from .scheduler import merge_local_f, shard_queries


def _block_csr(g: CSRGraph, lo: int, hi: int, n_pad: int) -> CSRGraph:
    """CSR over the global owner space [0, n_pad) in which only rows
    [lo, hi) keep their neighbours (the shard's partition)."""
    degrees = np.zeros(n_pad, dtype=np.int64)
    degrees[lo:hi] = np.diff(g.row_offsets[lo : hi + 1])
    row_offsets = np.zeros(n_pad + 1, dtype=np.int64)
    np.cumsum(degrees, out=row_offsets[1:])
    s, e = int(g.row_offsets[lo]), int(g.row_offsets[hi])
    return CSRGraph(
        n=n_pad,
        m=0,  # a row block's undirected record count is meaningless
        row_offsets=row_offsets,
        col_indices=np.asarray(g.col_indices[s:e], dtype=np.int32),
    )


def sharded_widths(g: CSRGraph, widths=DEFAULT_WIDTHS, min_bucket_rows=None):
    """One width ladder for every shard (the whole graph's pruning)."""
    return BellGraph.resolve_widths(
        widths, np.asarray(g.degrees), g.n, g.num_directed_edges, min_bucket_rows
    )


def build_sharded_forest(
    g: CSRGraph,
    p: int,
    device,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    min_bucket_rows: Optional[int] = None,
    blocks: Optional[Sequence[int]] = None,
    native: bool = True,
) -> Tuple[List[BellGraph], int, int]:
    """Partition ``g`` into ``p`` vertex blocks and build each block's BELL
    forest over the global space on ``device`` (``blocks``: only these).
    Returns (forests, block length L, padded vertex count n_pad = p * L)."""
    L = -(-max(g.n, 1) // p)
    n_pad = p * L
    widths = sharded_widths(g, widths, min_bucket_rows)
    forests = [
        BellGraph.from_host(
            _block_csr(g, min(b * L, g.n), min((b + 1) * L, g.n), n_pad),
            device, widths=widths, min_bucket_rows=0, keep_sparse=False, native=native,
        )
        for b in (range(p) if blocks is None else blocks)
    ]
    return forests, L, n_pad


def build_push_halo(g: CSRGraph, p: int, L: int, native: bool = True):
    """Each shard's in-block push CSR: for shard b, global source u -> u's
    neighbours inside block b (block-local rows), keyed by the sorted
    table of the sources with at least one in-block edge.  Returns a list
    of p NumPy (src_ids, src_start, src_cnt, vals) int32 tuples — the JAX
    package's stacked arrays without their cross-shard padding."""
    u, v, _ = g.deduped_pairs(native)  # sorted by (src, dst)
    blk = v // L
    order = np.argsort(blk, kind="stable")
    u_s, v_s, blk_s = u[order], v[order], blk[order]
    bounds = np.searchsorted(blk_s, np.arange(p + 1))
    out = []
    for b in range(p):
        sl = slice(bounds[b], bounds[b + 1])
        ub, vb = u_s[sl], v_s[sl] - b * L
        uniq, first = np.unique(ub, return_index=True)
        cnt = np.diff(np.append(first, ub.size))
        out.append(tuple(np.ascontiguousarray(a, dtype=np.int32)
                         for a in (uniq, first, cnt, vb)))
    return out


def halo_level_bytes(n_pad: int, w_words: int, p: int, halo_budget: int, own_rows: int):
    """(route, bytes) of one q-shard's halo exchange for a level whose
    max-over-'v' own-frontier rows is ``own_rows``: the routing predicate
    of the level loop.  Dense: every shard's (L, W) block, n_pad * W * 4
    bytes; sparse: p shards' (budget,) ids and (budget, W) words,
    p * budget * 4 * (1 + W) bytes."""
    if halo_budget and own_rows <= halo_budget:
        return "sparse", p * halo_budget * 4 * (1 + w_words)
    return "dense", n_pad * w_words * 4


def dense_halo_level_bytes(mesh, j: int, block: int) -> int:
    """Whole-mesh bytes one dense-halo level moves: every 'v' shard of
    every q-shard receives the other p-1 shards' (L, W) blocks,
    w_q * p * (p-1) * L * W * 4 bytes (``j`` the per-q-shard query rows
    before the multiple-of-32 pad)."""
    p = mesh.shape[VERTEX_AXIS]
    w_q = mesh.shape[QUERY_AXIS]
    words = -(-j // 32)
    return w_q * p * (p - 1) * block * words * 4


def default_halo_budget(n_pad: int, p: int) -> int:
    """Auto compacted-halo budget in own-frontier rows per shard."""
    return int(max(2048, n_pad // (64 * max(p, 1))))


def default_push_halo_budget(e_directed: int, p: int) -> int:
    """Auto in-block push budget in edge slots per shard (E/(64 p),
    floored at 2^14, capped at 2^22)."""
    return int(min(max(e_directed // (64 * max(p, 1)), 1 << 14), 1 << 22))


class _Row:
    """One q-shard's state: a RowQueueCarry per 'v' shard (own block)
    and the forest outputs whose own rows are the carries' hit planes."""

    def __init__(self, carries, devices, outs):
        self.carries = carries
        self.devices = devices
        self.outs = outs


class ShardedBellEngine(QueryEngineBase):
    """Queries round-robin over 'q', the CSR vertex-sharded over 'v', an
    all-K bit-plane level loop with one halo exchange a level.

    ``level_chunk``: levels between host reads (None runs to convergence).
    ``halo_budget`` / ``push_budget``: the sparse halo's own-frontier rows
    and the in-block push's edges; None is the JAX package's auto value
    off a TPU, 0 (every level exchanges planes, and no push), as the port
    routes; the CLI sets them from ``MSBFS_HALO_BUDGET`` and
    ``MSBFS_PUSH_HALO``."""

    CAPABILITIES = frozenset(
        {
            "query_sharded",
            "vertex_sharded",
            "collective_bytes",
            "plane:bit",
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
        widths: Sequence[int] = DEFAULT_WIDTHS,
        min_bucket_rows: Optional[int] = None,
        level_chunk: Optional[int] = None,
        halo_budget: Optional[int] = None,
        push_budget: Optional[int] = None,
        native: bool = True,
    ):
        self.mesh = mesh
        self.w = mesh.shape[QUERY_AXIS]
        self.p = p = mesh.shape[VERTEX_AXIS]
        self.n = graph.n
        self.block = L = -(-max(graph.n, 1) // p)
        self.n_pad = p * L
        widths = sharded_widths(graph, widths, min_bucket_rows)
        # Block b's forest on every distinct device of mesh column b.
        self.forests = {}
        for b in range(p):
            for dev in dict.fromkeys(mesh.devices[:, b]):
                with on_device(dev):
                    (self.forests[b, dev],), _, _ = build_sharded_forest(
                        graph, p, dev, widths, 0, blocks=[b], native=native)
        self.max_levels = max_levels
        self._max_levels = INT32_MAX if max_levels is None else int(max_levels)
        self.level_chunk = validate_level_chunk(level_chunk)
        self.halo_budget = int(halo_budget or 0)
        explicit_push = push_budget is not None
        self.push_budget = int(push_budget or 0)
        self.push = None
        if self.halo_budget and self.push_budget:
            host = build_push_halo(graph, p, L, native)
            self.push = {
                (b, dev): tuple(torch.from_numpy(a).to(dev) for a in host[b])
                for b in range(p) for dev in dict.fromkeys(mesh.devices[:, b])
            }
            # No shard has an in-block edge (an edgeless graph): the forest.
            self._can_push = (max(len(h[0]) for h in host) > 0
                              and max(len(h[3]) for h in host) > 0)
        else:
            if explicit_push and self.push_budget and not self.halo_budget:
                # The in-block push is reachable only inside the sparse
                # halo; a lone explicit budget would be silently dead.
                print(
                    f"warning: push_budget={self.push_budget} ignored "
                    "because halo_budget is 0 — the in-block push runs "
                    "only inside the sparse-halo branch (set "
                    "MSBFS_HALO_BUDGET too)",
                    file=sys.stderr,
                )
            self.push_budget = 0
            self._can_push = False
        self._scratch = {}
        self._level_warm_shapes = set()

    # ---- the level loop -----------------------------------------------------
    def _prologue(self, queries):
        # Sources outside [0, n) are dropped (main.cu:48-50): an id in
        # [n, n_pad) would otherwise land on a padding vertex.
        queries = np.asarray(queries)
        queries = np.where((queries >= 0) & (queries < self.n), queries, -1)
        return shard_queries(self.mesh, queries, None)

    def _init(self, grid) -> Tuple[List[_Row], int]:
        """Every (q, v) shard's own-block carry: the sources of its block
        as the hits of a level -1 that nothing has visited, counted at
        distance 0 by K11's row mode (with the own frontier's row queue)."""
        L, n_pad = self.block, self.n_pad
        cap = max(1, min(self.halo_budget, L))
        rows = []
        for r in range(self.w):
            qblock, j = pad_qblock(grid[r])
            w_words = qblock.shape[0] // 32
            devs = list(self.mesh.devices[r])
            carries, outs = [], []
            for b, dev in enumerate(devs):
                lo = b * L
                local = np.where((qblock >= lo) & (qblock < lo + L), qblock - lo, -1)
                with on_device(dev):
                    start = batch_start(L, local, dev)
                    out = torch.zeros((n_pad, w_words), dtype=torch.int32, device=dev)
                    hits = out[lo : lo + L]
                    hits.copy_(start.frontier)
                    for t in (start.visited, start.levels, start.reached):
                        t.zero_()
                    start.ctrl.copy_(torch.tensor([1, -1, 0, 0], dtype=torch.int32))
                    switch = PushSwitch.new(torch.zeros(L, dtype=torch.int32, device=dev),
                                            cap, 0, w_words)
                    offsets, nonzero = row_queue_scratch(L, dev)
                    carry = RowQueueCarry(
                        visited=start.visited,
                        frontier=torch.zeros((L, w_words), dtype=torch.int32, device=dev),
                        hits=hits, f=start.f, levels=start.levels, reached=start.reached,
                        counts=start.counts, switch=switch,
                        count=torch.zeros(1, dtype=torch.int32, device=dev),
                        peak=torch.zeros(1, dtype=torch.int32, device=dev),
                        offsets=offsets, ctrl=start.ctrl, nonzero=nonzero,
                    )
                    self._apply(carry)
                carries.append(carry)
                outs.append(out)
            row = _Row(carries, devs, outs)
            self._combine(row)
            rows.append(row)
        return rows, grid.shape[1]

    def _apply(self, carry) -> None:
        row_compact(carry, self._max_levels)

    def _combine(self, row: _Row) -> None:
        """The q-shard's updated flag: the max over its 'v' shards, written
        back to each (JAX's psum of the own-block counts, as a flag)."""
        if len(row.carries) == 1:
            return
        merged = pmax([c.ctrl[:1] for c in row.carries])
        for dev, c, m in zip(row.devices, row.carries, merged):
            with on_device(dev):
                c.ctrl[:1].copy_(m)

    def _forest(self, b, dev, frontier, row: _Row) -> None:
        carry = row.carries[b]
        graph = self.forests[b, dev]
        with on_device(dev):
            key = (b, dev, frontier.shape[1])
            if dev.type == "cuda" and key not in self._scratch:
                self._scratch[key] = forest_scratch(graph, frontier.shape[1], dev)
            forest_or(frontier, graph, row.outs[b], carry.ctrl, self._max_levels, None,
                      self._scratch.get(key))

    def _dense_level(self, row: _Row) -> None:
        gathered = all_gather([c.frontier for c in row.carries])
        for b, dev in enumerate(row.devices):
            self._forest(b, dev, gathered[b], row)

    def _pairs(self, row: _Row):
        """Each shard's (global ids, words) send buffers, all-gathered."""
        sends = []
        for b, (dev, c) in enumerate(zip(row.devices, row.carries)):
            with on_device(dev):
                sends.append(pair_words(c.frontier, c.switch.worklist[0], c.count,
                                        b * self.block, self.n_pad))
        ids = all_gather([s[0] for s in sends])
        words = all_gather([s[1] for s in sends])
        return ids, words

    def _matches(self, row: _Row, ids):
        """Per shard, the gathered pairs matched against its push CSR (H2's
        match, one launch): each pair's in-block edges and their total."""
        out = []
        for b, dev in enumerate(row.devices):
            with on_device(dev):
                out.append(halo_push_match(ids[b], self.push[b, dev]))
        return out

    def _sparse_level(self, row: _Row, ids, words, push_ok, matches, edges) -> None:
        rebuilt = {}
        for b, (dev, c) in enumerate(zip(row.devices, row.carries)):
            with on_device(dev):
                if push_ok[b]:
                    halo_push_or(ids[b], words[b], self.push[b, dev], c.hits, matches[b],
                                 int(edges[b]))
                    continue
                if dev not in rebuilt:
                    plane = torch.zeros((self.n_pad, c.frontier.shape[1]),
                                        dtype=torch.int32, device=dev)
                    halo_pair_or(ids[b], words[b], plane)
                    rebuilt[dev] = plane
                self._forest(b, dev, rebuilt[dev], row)

    def _finish_level(self, row: _Row) -> None:
        for dev, c in zip(row.devices, row.carries):
            with on_device(dev):
                self._apply(c)
        self._combine(row)

    def _level(self, rows: List[_Row]) -> bool:
        """One level of every q-shard; False when none may run.  With the
        sparse halo on, one stacked read decides every route."""
        if not self.halo_budget:
            for row in rows:
                self._dense_level(row)
                self._finish_level(row)
            return True
        gathered = [self._pairs(row) for row in rows]
        matches = [self._matches(row, ids) if self._can_push else None
                   for row, (ids, _) in zip(rows, gathered)]
        parts = []
        for row, found in zip(rows, matches):
            parts += [c.count.to(torch.int64) for c in row.carries]
            parts += [c.ctrl[:2].to(torch.int64) for c in row.carries[:1]]
            if found is not None:
                parts += [m.total for m in found]
        flat = np.concatenate(list(stacked_read_ragged(parts)))
        at = 0
        any_running = False
        for row, (ids, words), found in zip(rows, gathered, matches):
            p = len(row.carries)
            own = flat[at : at + p]
            updated, level = flat[at + p], flat[at + p + 1]
            at += p + 2
            edges = flat[at : at + p] if self._can_push else np.zeros(p)
            at += p if self._can_push else 0
            if not updated or level >= self._max_levels:
                continue
            any_running = True
            if own.max() <= self.halo_budget:
                self._sparse_level(row, ids, words,
                                   [self._can_push and e <= self.push_budget for e in edges],
                                   found, edges)
            else:
                self._dense_level(row)
            self._finish_level(row)
        return any_running

    def _chunk(self, rows: List[_Row], bound) -> None:
        """Up to ``bound`` levels (None: to convergence) of every q-shard."""
        if self.halo_budget:
            i = 0
            while bound is None or i < bound:
                if not self._level(rows):
                    return
                i += 1
            return
        peeks = [_ConvergencePeek(row.carries[0].ctrl, self._max_levels) for row in rows]

        def stopped(pk, row):
            with on_device(row.devices[0]):
                return pk.stopped()

        i = 0
        while bound is None or i < bound:
            if all([stopped(pk, row) for pk, row in zip(peeks, rows)]):
                return
            self._level(rows)
            i += 1

    def _finish(self, rows: List[_Row], j: int, k: int, k_pad: int):
        """Merged (f, levels, reached): the own-block counters summed (F,
        reached) or max-reduced (levels) over 'v', then merged over 'q'."""
        out = []
        for name, reduce in (("f", psum), ("levels", pmax), ("reached", psum)):
            parts = [reduce([getattr(c, name) for c in row.carries])[0] for row in rows]
            out.append(merge_local_f(parts, j, self.w, k, k_pad)[0])
        return tuple(out)

    def _status(self, rows: List[_Row]) -> np.ndarray:
        return stacked_read([row.carries[0].ctrl[:2] for row in rows])

    def _run(self, queries):
        grid, k, k_pad, _ = self._prologue(queries)
        rows, j = self._init(grid)
        bound = self.level_chunk or None
        level_bytes = (dense_halo_level_bytes(self.mesh, j, self.block)
                       if self.level_chunk and not self.halo_budget else 0)
        prev = 0
        while True:
            self._chunk(rows, bound)
            ctrl = self._status(rows)
            if level_bytes:
                now = int(ctrl[:, 1].max())
                record_collective_bytes(max(0, now - prev) * level_bytes)
                prev = now
            if bound is None or not ctrl[:, 0].any() or ctrl[:, 1].max() >= self._max_levels:
                break
        return (*self._finish(rows, j, k, k_pad), k)

    def f_values(self, queries) -> torch.Tensor:
        f, _, _, k = self._run(queries)
        return f[:k]

    def query_stats(self, queries):
        """Per-query (levels, reached, F)."""
        f, levels, reached, k = self._run(queries)
        record_dispatch()
        return (
            levels[:k].cpu().numpy().astype(np.int32),
            reached[:k].cpu().numpy().astype(np.int32),
            f[:k].cpu().numpy(),
        )

    def level_stats(self, queries):
        """Per-level trace (``MSBFS_STATS=2``): the shared stepped loop
        over this engine's init, one level and merge.  Also sets
        ``last_halo_trace``: a dict per executed level with the max-over-'v'
        own-frontier rows, each q-shard's route and the exchange's bytes
        (:func:`halo_level_bytes`)."""
        grid, k, k_pad, _ = self._prologue(queries)
        j = grid.shape[1]
        w_words = -(-j // 32)
        rows_trace = []
        jj = {}

        def init():
            rows, jj["j"] = self._init(grid)
            return rows

        def step(rows):
            rows_trace.append([torch.stack([to_device(c.count, row.carries[0].count.device)
                                            for c in row.carries]).amax().clone()
                               for row in rows])
            self._chunk(rows, 1)
            return rows

        def finish(rows):
            return self._finish(rows, jj["j"], k, k_pad)

        def running(rows):
            return bool(self._status(rows)[:, 0].any())

        key = np.asarray(queries).shape
        warmed = key in self._level_warm_shapes
        out = stepped_level_stats(init, step, finish, k, self.max_levels, warmed, running)
        self._level_warm_shapes.add(key)
        if not warmed and rows_trace:
            rows_trace.pop(0)  # the untimed first pass's step
        self.last_halo_trace = []
        for level in rows_trace:
            own = [int(x) for x in stacked_read([x.view(1) for x in level])[:, 0]] if level else []
            per = [halo_level_bytes(self.n_pad, w_words, self.p, self.halo_budget, r)
                   for r in own]
            self.last_halo_trace.append({
                "own_rows": max(own) if own else 0,
                "routes": [route for route, _ in per],
                "bytes": int(sum(nbytes for _, nbytes in per)),
            })
        return out

