"""Dense-adjacency frontier engine: a BFS level as one matrix product.

The JAX package's ops/dense.py: for graphs whose adjacency fits device
memory densely (n up to ~16k), a level for all K queries is the
(K, n_pad) @ (n_pad, n_pad) product of the bf16 frontier and the 0/1
adjacency.  XLA computes it there outside any Pallas kernel, so here it is
``torch.matmul`` on the tensor cores, with no kernel of the port's own.

Exactness: the entries are 0 and 1, bf16 products of them are exact, the
card accumulates a bf16 product in fp32, and only ``hits > 0`` is read —
a positive fp32 sum stays positive when it is rounded to the bf16 result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.csr import CSRGraph
from .bfs import NOT_REACHED, DistCarry, apply_new

LANE = 128  # n_pad is rounded up to a multiple of this, as in JAX


def dense_expand(dist: torch.Tensor, level, adjacency: torch.Tensor) -> torch.Tensor:
    """(K, n_pad) distances at ``level`` (a scalar or (K,)) -> the (K,
    n_pad) newly-reached mask: ``(dist == -1) & (frontier @ A > 0)``."""
    lvl = torch.as_tensor(level, device=dist.device).reshape(-1, 1)
    frontier = (dist == lvl).to(torch.bfloat16)
    hits = torch.matmul(frontier, adjacency)
    return (dist == NOT_REACHED) & (hits > 0)


class DenseGraph:
    """(n_pad, n_pad) bf16 0/1 adjacency on one device, n_pad rounded up
    to 128.  ``adjacency[u, v] == 1`` iff the CSR has the slot u -> v
    (duplicates and self-loops collapse, harmless for reachability);
    padding rows and columns are zero, so padded vertices are never
    reached and never count in F(U)."""

    def __init__(self, adjacency: torch.Tensor, n: int):
        self.adjacency = adjacency
        self.n = int(n)

    @property
    def n_pad(self) -> int:
        return self.adjacency.shape[0]

    @property
    def device(self) -> torch.device:
        return self.adjacency.device

    @staticmethod
    def from_host(g: CSRGraph, device) -> "DenseGraph":
        """Fill the matrix on ``device`` from the CSR's slots (no host
        copy of the n_pad^2 matrix)."""
        n_pad = max(LANE, -(-g.n // LANE) * LANE)
        adj = torch.zeros((n_pad, n_pad), dtype=torch.bfloat16, device=device)
        src = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees.astype(np.int64))
        rows = torch.from_numpy(src).to(device)
        cols = torch.from_numpy(np.asarray(g.col_indices, dtype=np.int64)).to(device)
        adj[rows, cols] = 1.0
        return DenseGraph(adj, g.n)

    def expand_frontier(self, dist, level):
        """One level's newly-reached mask over the padded state."""
        return dense_expand(dist, level, self.adjacency)

    def level_step(self, plain: bool = False):
        """One level of the distance loop, gated on the device: a level no
        query may run changes nothing (``apply_new`` masks it), so the
        step reads nothing back.  ``plain`` is accepted for the engine's
        sake: the matmul has no kernel of the port's own."""

        def step(carry: DistCarry) -> None:
            apply_new(carry, dense_expand(carry.dist, carry.level, self.adjacency))

        return step

    def __repr__(self):
        return f"DenseGraph(n={self.n}, n_pad={self.n_pad})"
