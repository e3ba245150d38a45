"""Host-side CSR of an undirected graph.

Reproduces the reference's adjacency exactly (main.cu:106-129): every
undirected edge record (u, v) is inserted in both adjacency lists, in file
order, duplicates and self-loops preserved.  ``row_offsets`` is int64 so
2m > 2^31 cannot overflow (the reference uses int, main.cu:119-121).

The build and the per-row dedup run in the native runtime
(runtime/native_loader.py) unless the caller passes ``native=False``,
which takes the NumPy versions kept here: the same bytes, slower.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` of a 1-D array, by a sort and a neighbour
    compare.  NumPy 2.3's ``np.unique`` hashes before it sorts, and on the
    tens of millions of distinct (src * n + dst) keys of an RMAT-20 graph
    that hash costs many times the sort (see PERF.md)."""
    keys = np.sort(keys)
    if keys.size > 1:
        keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
    return keys


@dataclasses.dataclass
class CSRGraph:
    """``m`` undirected edge records; the CSR holds ``2m`` directed slots."""

    n: int
    m: int
    row_offsets: np.ndarray  # (n+1,) int64
    col_indices: np.ndarray  # (2m,) int32

    @property
    def num_directed_edges(self) -> int:
        return int(self.row_offsets[-1])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets)

    def dedup_rows(self, native: bool = True):
        """(dst int32, per-vertex counts int64): each row's neighbours
        sorted, duplicates and self-loops removed, rows concatenated.
        Set semantics per row are safe for any "is some neighbour in the
        frontier" step, and a self-loop never reaches a new vertex."""
        if native:
            from ..runtime import native_loader  # lazy: avoid an import cycle

            return native_loader.dedup_rows(self.row_offsets, self.col_indices)
        n = self.n
        src = np.repeat(np.arange(n, dtype=np.int64), self.degrees)
        dst = np.asarray(self.col_indices, dtype=np.int64)
        keep = src != dst
        pairs = sorted_unique(src[keep] * n + dst[keep])
        return (pairs % max(n, 1)).astype(np.int32), np.bincount(
            pairs // max(n, 1), minlength=n
        )

    def deduped_pairs(self, native: bool = True):
        """The dedup slots of :meth:`dedup_rows` as (src, dst, per-vertex
        counts), int64, sorted by (src, dst)."""
        dst, deg = self.dedup_rows(native)
        src = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        return src, dst.astype(np.int64), deg

    def to_device(self, device) -> "DeviceCSR":
        return DeviceCSR.from_host(self, device)

    @staticmethod
    def from_edges(n: int, edges: np.ndarray, native: bool = True) -> "CSRGraph":
        """Build CSR from an (m, 2) int array of undirected edge records:
        for record i = (u, v), v is appended to adj[u] and u to adj[v], in
        file order.  Natively a counting pass and a placement pass; with
        ``native=False`` a stable sort of the interleaved directed
        sequence [(u0,v0),(v0,u0),(u1,v1),...] by source."""
        edges = np.asarray(edges)
        m = edges.shape[0]
        if m and (edges.min() < 0 or edges.max() >= n):
            # The reference indexes adj[u]/adj[v] unchecked (main.cu:114-115)
            # — undefined behavior on a corrupt file; fail loudly instead.
            raise ValueError(f"edge endpoint out of range [0, {n})")
        if m == 0:
            return CSRGraph(
                n=n,
                m=0,
                row_offsets=np.zeros(n + 1, dtype=np.int64),
                col_indices=np.zeros(0, dtype=np.int32),
            )
        if native:
            from ..runtime import native_loader  # lazy: avoid an import cycle

            row_offsets, col_indices = native_loader.csr_from_edges(n, edges)
            return CSRGraph(n=n, m=m, row_offsets=row_offsets, col_indices=col_indices)
        src = np.empty(2 * m, dtype=np.int64)
        dst = np.empty(2 * m, dtype=np.int32)
        src[0::2] = edges[:, 0]
        src[1::2] = edges[:, 1]
        dst[0::2] = edges[:, 1]
        dst[1::2] = edges[:, 0]
        counts = np.bincount(src, minlength=n).astype(np.int64)
        row_offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_offsets[1:])
        order = np.argsort(src, kind="stable")
        return CSRGraph(
            n=n, m=m, row_offsets=row_offsets, col_indices=dst[order]
        )


# The CSR pull's work layout (kernel K9, csrc/csr_pull.cu): a row of at
# most SHORT_ROW_SLOTS slots is walked by one thread, a longer one is cut
# into virtual rows of at most VROW_SLOTS slots, each walked by a warp.
SHORT_ROW_SLOTS = 32
VROW_SLOTS = 256


def virtual_rows(row_offsets: np.ndarray, short_slots: int = SHORT_ROW_SLOTS,
                 vrow_slots: int = VROW_SLOTS):
    """((R, 3) int32 (start, end, owner) slot ranges, number of short
    ones): first every nonempty row of at most ``short_slots`` slots whole,
    in vertex order, then every longer row cut into consecutive pieces of
    ``vrow_slots`` slots (the last one shorter), in slot order.  Together
    they cover every slot once; empty rows have none."""
    offs = np.asarray(row_offsets, dtype=np.int64)
    deg = np.diff(offs)
    short = np.flatnonzero((deg > 0) & (deg <= short_slots))
    long_rows = np.flatnonzero(deg > short_slots)
    pieces = -(-deg[long_rows] // vrow_slots)
    owner = np.repeat(long_rows, pieces)
    first = np.cumsum(pieces) - pieces
    start = offs[owner] + (np.arange(owner.size) - np.repeat(first, pieces)) * vrow_slots
    out = np.empty((short.size + owner.size, 3), dtype=np.int32)
    out[: short.size, 0] = offs[short]
    out[: short.size, 1] = offs[short + 1]
    out[: short.size, 2] = short
    out[short.size :, 0] = start
    out[short.size :, 1] = np.minimum(start + vrow_slots, offs[owner + 1])
    out[short.size :, 2] = owner
    return out, int(short.size)


class DeviceCSR:
    """The CSR on one device, made once and reused by every query (the
    reference's one-time copy, main.cu:282-295); the JAX package's
    ``DeviceCSR`` with the same int32 fields:

    * ``row_offsets`` (n+1,) — int64 on the host, int32 here while
      2m < 2^31;
    * ``col_indices`` (E,) — neighbour ids, E = 2m directed slots;
    * ``edge_src`` (E,) — the row owning each slot, ascending (the plain
      versions' segment ids);

    and the port's work layout of the CSR pull kernel, made with them:
    ``vrows`` (R, 3) int32 virtual rows and ``num_short``, the count of
    whole short rows in front (:func:`virtual_rows`)."""

    def __init__(self, row_offsets, col_indices, edge_src, n: int, num_edges: int,
                 vrows, num_short: int):
        self.row_offsets = row_offsets
        self.col_indices = col_indices
        self.edge_src = edge_src
        self.n = int(n)
        self.num_edges = int(num_edges)
        self.vrows = vrows
        self.num_short = int(num_short)

    @staticmethod
    def from_host(g: CSRGraph, device) -> "DeviceCSR":
        e = g.num_directed_edges
        if e >= 2**31:
            raise ValueError(
                "2m >= 2^31 directed slots: use the sharded-CSR path "
                "(parallel.sharded_csr), which splits edge arrays per shard."
            )
        edge_src = np.repeat(np.arange(g.n, dtype=np.int32), g.degrees.astype(np.int64))
        vrows, num_short = virtual_rows(g.row_offsets)
        offs, cols, src, vrows = (
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
            for a in (g.row_offsets, g.col_indices, edge_src, vrows)
        )
        return DeviceCSR(offs, cols, src, g.n, e, vrows, num_short)

    @property
    def n_pad(self) -> int:
        """Distance-state length: the CSR engine's state is unpadded."""
        return self.n

    @property
    def device(self) -> torch.device:
        return self.col_indices.device

    def expand_frontier(self, dist, level):
        """One level of the CSR pull in torch (ops.cuda_csr)."""
        from ..ops.bfs import frontier_expand  # lazy: models stays op-free

        return frontier_expand(dist, level, self)

    def level_step(self, plain: bool = False):
        """One gated level of the distance loop over this CSR: kernel K9
        (``csrc/csr_pull.cu``), or its plain version."""
        from ..ops import cuda_csr  # lazy: models stays op-free

        pull = cuda_csr.csr_pull_plain if plain else cuda_csr.csr_pull
        return lambda carry: pull(self, carry)

    def __repr__(self):
        return f"DeviceCSR(n={self.n}, directed_edges={self.num_edges})"
