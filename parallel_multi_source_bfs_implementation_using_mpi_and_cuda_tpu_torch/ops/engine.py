"""The engine surface every query engine shares (``f_values``, ``best``,
``query_stats``, ``compile``), the host-side source band, and the
frontier-density estimate the direction switches route on."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.timing import record_dispatch
from .objective import select_best


def frontier_activity(frontier: torch.Tensor, edge_counts: torch.Tensor):
    """(active, cnt, edges) frontier-density estimate of an (n, lanes)
    plane (a nonzero row is a frontier vertex) against the per-vertex
    dedup out-degree: the (n,) bool active mask, the int32 active-row
    count and the int32 outgoing-edge total of the active rows, all on
    the frontier's device (no host read)."""
    active = (frontier != 0).any(dim=1)
    cnt = active.sum(dtype=torch.int32)
    edges = torch.where(active, edge_counts, 0).sum(dtype=torch.int32)
    return active, cnt, edges


def source_band(queries, n: int):
    """Initial frontier band ``[lo, hi)`` from (K, S) host queries — the
    active-row estimate the stencil window sizes its first chunk from;
    ``[0, 0]`` when no source is in range."""
    q = np.asarray(queries)
    valid = (q >= 0) & (q < n)
    if not valid.any():
        return [0, 0]
    vs = q[valid]
    return [int(vs.min()), int(vs.max()) + 1]


class QueryEngineBase:
    """Selection/compile surface over any ``f_values`` implementation."""

    def f_values(self, queries) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def best(self, queries) -> Tuple[int, int]:
        """Run all groups; return (minF, minK) — reference main.cu:309-397."""
        f = self.f_values(queries)
        min_f, min_k = torch.stack(select_best(f, f >= 0)).tolist()
        record_dispatch()
        return min_f, min_k

    def compile(self, queries_shape: Tuple[int, int]) -> None:
        """Warm everything a (K, S) batch runs so the cost lands in the
        preprocessing span: one run on an all-padding batch."""
        self.best(np.full(queries_shape, -1, dtype=np.int32))

    def query_stats(self, queries):
        """Per-query (levels, reached, F) numpy arrays, or None."""
        return None
