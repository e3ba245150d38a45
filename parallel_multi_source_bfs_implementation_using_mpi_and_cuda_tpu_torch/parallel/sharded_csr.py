"""Vertex-sharded CSR BFS: the distance loop over a partitioned graph.

The JAX package's parallel/sharded_csr.py.  The vertex space is padded to
p * L and shard b of the 'v' axis owns rows [b*L, (b+1)*L): its edge slots
live only on its device.  Each query's BFS runs on every shard of its
q-shard at once: per level each shard pulls its own rows from the global
frontier, then the shards' newly reached blocks are all-gathered into the
next frontier (the halo exchange), and F(U) adds the shards' partial sums.

Here each shard's pull is the CSR pull kernel, K9 ``csr_pull``
(ops/cuda_csr.py), over its row block presented in the global row space:
a CSR of n_pad rows whose rows outside the block are empty
(parallel/sharded_bell.py ``_block_csr``, as the forests are built).  The distances of a q-shard's queries are
one query-minor (n_pad, J) matrix per device, whose row blocks the shards
write (a shard only ever reaches its own rows) and the all-gather shares;
on a shared device the blocks are views of one matrix and the gather
copies nothing.  After a level each shard's per-query updated flags are
max-reduced over 'v' on the device, so a query stops when no shard found
anything, with no host read inside the loop.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.csr import CSRGraph
from ..ops.bfs import INT32_MAX, DistCarry, arm_chunk, init_distances, level_active
from ..ops.bitbell import _ConvergencePeek
from ..ops.engine import QueryEngineBase
from ..ops.objective import f_of_u
from ..utils.timing import record_dispatch
from .collectives import all_gather, on_device, pmax
from .mesh import QUERY_AXIS, VERTEX_AXIS
from .scheduler import merge_local_f, shard_queries
from .sharded_bell import _block_csr


class ShardedCSR:
    """Host-side partition of a CSR graph into p row blocks.

    Stacked layout (leading axis = shard): ``row_offsets`` (p, L+1) rebased
    per shard, ``col_indices`` / ``edge_src`` (p, E_max) padded — padding
    slots carry ``edge_src = L``, out of range for the shard's rows."""

    def __init__(self, g: CSRGraph, num_shards: int):
        n, p = g.n, num_shards
        L = -(-max(n, 1) // p)
        n_pad = p * L
        degrees = np.zeros(n_pad, dtype=np.int64)
        degrees[:n] = g.degrees
        block_deg = degrees.reshape(p, L)
        e_max = int(block_deg.sum(axis=1).max()) if n else 0
        e_max = max(e_max, 1)
        row_offsets = np.zeros((p, L + 1), dtype=np.int64)
        np.cumsum(block_deg, axis=1, out=row_offsets[:, 1:])
        col_indices = np.zeros((p, e_max), dtype=np.int32)
        edge_src = np.full((p, e_max), L, dtype=np.int32)
        global_src = np.repeat(np.arange(n_pad, dtype=np.int64), degrees)
        for b in range(p):
            lo = int(g.row_offsets[min(b * L, n)]) if n else 0
            hi = int(g.row_offsets[min((b + 1) * L, n)]) if n else 0
            col_indices[b, : hi - lo] = g.col_indices[lo:hi]
            edge_src[b, : hi - lo] = (global_src[lo:hi] - b * L).astype(np.int32)
        self.n = n
        self.n_pad = n_pad
        self.block = L
        self.num_shards = p
        self.e_max = e_max
        self.row_offsets = row_offsets
        self.col_indices = col_indices
        self.edge_src = edge_src


class _Batch:
    """One q-shard's batch of queries: a distance matrix per device and a
    carry per 'v' shard over it."""

    def __init__(self, devices, dists, carries):
        self.devices = devices
        self.dists = dists
        self.carries = carries


class ShardedEngine(QueryEngineBase):
    """Query execution with the CSR sharded over 'v' and queries round
    robin over 'q' — the full ('q', 'v') mesh.  ``query_chunk``: queries
    a batch of a q-shard (None: all of its queries)."""

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
        query_chunk: Optional[int] = None,
    ):
        self.mesh = mesh
        self.w = mesh.shape[QUERY_AXIS]
        self.p = mesh.shape[VERTEX_AXIS]
        self.parts = parts = ShardedCSR(graph, self.p)
        self.graphs = {}
        for b in range(self.p):
            lo, hi = min(b * parts.block, graph.n), min((b + 1) * parts.block, graph.n)
            block = _block_csr(graph, lo, hi, parts.n_pad)
            for dev in dict.fromkeys(mesh.devices[:, b]):
                with on_device(dev):
                    self.graphs[b, dev] = block.to_device(dev)
        self.max_levels = max_levels
        self._max_levels = INT32_MAX if max_levels is None else int(max_levels)
        self.query_chunk = query_chunk

    def _batch(self, r: int, queries: np.ndarray) -> _Batch:
        devs = list(self.mesh.devices[r])
        dists = {}
        for dev in dict.fromkeys(devs):
            dists[dev] = init_distances(self.parts.n, queries, self.parts.n_pad,
                                        dev).T.contiguous()
        carries = []
        for dev in devs:
            dist = dists[dev].T  # (K, n_pad), query-minor
            k = dist.shape[0]
            z = lambda: torch.zeros(k, dtype=torch.int32, device=dev)  # noqa: E731
            carry = DistCarry(dist=dist, level=z(), updated=(dist == 0).any(dim=1).to(
                torch.int32), stop=z(), found=z(),
                ctrl=torch.zeros(4, dtype=torch.int32, device=dev))
            with on_device(dev):
                arm_chunk(carry, None, self.max_levels)
            carries.append(carry)
        return _Batch(devs, dists, carries)

    def _level(self, batch: _Batch) -> None:
        """One level of every shard, the blocks gathered, the updated flags
        max-reduced over 'v'."""
        L = self.parts.block
        for b, (dev, carry) in enumerate(zip(batch.devices, batch.carries)):
            with on_device(dev):
                self.graphs[b, dev].level_step()(carry)
        if len(batch.dists) > 1:
            gathered = all_gather([batch.dists[dev][b * L : (b + 1) * L]
                                   for b, dev in enumerate(batch.devices)])
            for dev, full in dict(zip(batch.devices, gathered)).items():
                with on_device(dev):
                    batch.dists[dev].copy_(full)
        if len(batch.carries) > 1:
            merged = pmax([c.updated for c in batch.carries])
            for dev, c, m in zip(batch.devices, batch.carries, merged):
                with on_device(dev):
                    c.updated.copy_(m)
                    c.ctrl[:1].copy_(level_active(c).any().view(1))
                    c.touch()

    def _run(self, grid: np.ndarray, chunk: int) -> List[torch.Tensor]:
        """Each q-shard's (J,) F values, its queries ``chunk`` at a time,
        every q-shard's batch advanced level by level in lockstep."""
        j = grid.shape[1]
        out = [[] for _ in range(self.w)]
        for lo in range(0, j, chunk):
            batches = [self._batch(r, grid[r, lo : lo + chunk]) for r in range(self.w)]
            peeks = [_ConvergencePeek(b.carries[0].ctrl, INT32_MAX) for b in batches]

            def stopped(pk, batch):
                with on_device(batch.devices[0]):
                    return pk.stopped()

            while not all([stopped(pk, b) for pk, b in zip(peeks, batches)]):
                for batch in batches:
                    self._level(batch)
            for r, batch in enumerate(batches):
                out[r].append(f_of_u(batch.dists[batch.devices[0]].T))
        record_dispatch()
        return [torch.cat(parts) for parts in out]

    def f_values(self, queries) -> torch.Tensor:
        """(K, S) -1-padded queries -> (K,) int64 F values (on q-shard 0's
        device)."""
        grid, k, k_pad, chunk = shard_queries(self.mesh, np.asarray(queries), self.query_chunk)
        parts = self._run(grid, chunk)
        return merge_local_f(parts, grid.shape[1], self.w, k, k_pad)[0][:k]
