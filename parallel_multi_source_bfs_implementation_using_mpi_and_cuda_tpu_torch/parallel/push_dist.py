"""Query-sharded push engine: work-optimal road-class BFS at -gn > 1.

The JAX package's parallel/push_dist.py: the padded adjacency is
replicated over the mesh (the reference's full-graph-per-rank model),
the (W, J, S) cyclic query grid (main.cu:303-307) puts row r on q-shard
r, and each q-shard runs the port's queue push on its rows — K10
``queue_expand`` and K11 ``queue_compact`` on its device, through the
grid variants of ops/push.py (``_push_init_grid``, ``_push_chunk_grid``)
— with no collective inside the level loop.  The chunks run in lockstep: every
shard's chunk is enqueued, then one stacked read of the shards' running
flags decides whether another chunk runs.

The capacity protocol (auto growth on overflow, the historical-peak
shrink, :class:`..ops.push.FrontierOverflow` on an explicit bound) is
PushEngine's, unchanged: only the dispatch differs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.csr import CSRGraph
from ..ops.push import (
    PaddedAdjacency,
    PushEngine,
    _push_chunk_grid,
    _push_init_grid,
    push_run,
)
from ..utils.timing import record_dispatch
from .distributed import query_devices
from .mesh import QUERY_AXIS
from .scheduler import shard_queries


class DistributedPushEngine(PushEngine):
    """PushEngine whose queries run sharded over the 'q' mesh axis."""

    def __init__(
        self,
        mesh,
        graph: CSRGraph,
        capacity: Optional[int] = None,
        max_levels: Optional[int] = None,
        max_width: Optional[int] = None,
        native: bool = True,
    ):
        self.mesh = mesh
        self.w = mesh.shape[QUERY_AXIS]
        self._qdev = query_devices(mesh)
        host = (PaddedAdjacency.host_rows(graph, native=native) if max_width is None
                else PaddedAdjacency.host_rows(graph, max_width, native))
        rows, width, edges = host
        # Replicate the table on every device (main.cu:242-295: the full
        # graph per rank, uploaded once).
        self._tables = {
            dev: PaddedAdjacency(torch.from_numpy(rows).to(dev), graph.n, width, edges)
            for dev in dict.fromkeys(self._qdev)
        }
        self._row_tables = [self._tables[dev] for dev in self._qdev]
        super().__init__(self._tables[self._qdev[0]], capacity=capacity,
                         max_levels=max_levels)

    def _grid(self, queries):
        return shard_queries(self.mesh, np.asarray(queries), None)[0]

    def _dispatch(self, queries):
        """One push BFS of the batch over the mesh at the current capacity:
        per-query (f, levels, reached, max_count) in global query order
        (k_pad long), on q-shard 0's device."""
        out = push_run(self._row_tables, self._grid(queries), self.capacity, self.max_levels,
                       init_fn=_push_init_grid, chunk_fn=_push_chunk_grid)
        return tuple(self._query_order(x) for x in out)

    # The stepped trace: the same grid carry a level at a time.
    def _trace_init(self, queries):
        return _push_init_grid(self._row_tables, self._grid(queries), self.capacity)

    def _trace_chunk(self, carry):
        return _push_chunk_grid(self._row_tables, carry, self.capacity, 1, self.max_levels)

    @staticmethod
    def _query_order(x: torch.Tensor) -> torch.Tensor:
        # grid[r, j] holds global query r + j*W (main.cu:303-307):
        # transposing restores the global order.
        return x.T.reshape(-1)

    def _to_query_order(self, x) -> np.ndarray:
        out = self._query_order(x).cpu().numpy()
        record_dispatch()
        return out

    def level_stats(self, queries):
        """Per-level trace in global query order, cut to the true K (the
        cyclic grid pads K up to a multiple of the 'q' axis)."""
        k = np.asarray(queries).shape[0]
        levels, reached, f, lc, secs = super().level_stats(queries)
        return levels[:k], reached[:k], f[:k], lc[:, :k], secs
