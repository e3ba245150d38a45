"""Query padding for the packed engines, and the ordered sub-batch split."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .engine import QueryEngineBase

K_ALIGN = 8


class PackedEngineBase(QueryEngineBase):
    """Shared surface of the query-minor engines: K-alignment padding."""

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
