"""ELL-slab graph layout for the ELL route (``MSBFS_BACKEND=pallas``).

CSR rows are split into fixed-width *virtual rows* of ``width`` neighbour
slots: a vertex of degree d occupies ceil(d / width) consecutive virtual
rows.  Built on the host with NumPy, exactly as the JAX package's
models/ell.py builds it, then moved to one device:

* ``cols``        (width, R) int32 — neighbour ids, column-major so that
  neighbouring virtual rows are neighbouring addresses for a fixed slot;
  padding slots hold ``n`` (a frontier index that always reads 0);
* ``vrow_vertex`` (R,) int32 — owning vertex per virtual row, sorted
  ascending; padding rows hold ``n`` (dropped by the per-vertex reduce).

R is the number of used virtual rows rounded up to a ``tile_rows``
multiple (at least one tile).
"""

from __future__ import annotations

import numpy as np
import torch

from .csr import CSRGraph


class EllGraph:
    """Device-resident ELL-slab layout (see module docstring)."""

    def __init__(self, cols, vrow_vertex, n: int, num_vrows: int, width: int):
        self.cols = cols  # (width, R) int32
        self.vrow_vertex = vrow_vertex  # (R,) int32
        self.n = int(n)
        self.num_vrows = int(num_vrows)
        self.width = int(width)

    @property
    def n_pad(self) -> int:
        return self.n

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @staticmethod
    def host_arrays(g: CSRGraph, width: int = 16, tile_rows: int = 512):
        """(cols (width, R), vrow_vertex (R,), R) as NumPy int32 arrays."""
        if width < 1:
            raise ValueError("width must be >= 1")
        deg = g.degrees.astype(np.int64)
        vrows_per_vertex = -(-deg // width)  # ceil; 0 for isolated vertices
        r_used = int(vrows_per_vertex.sum())
        r = max(tile_rows, -(-max(r_used, 1) // tile_rows) * tile_rows)
        cols = np.full((r, width), g.n, dtype=np.int32)  # sentinel n
        vrow_vertex = np.full(r, g.n, dtype=np.int32)  # sentinel n (dropped)
        owners = np.repeat(np.arange(g.n, dtype=np.int32), vrows_per_vertex)
        vrow_vertex[:r_used] = owners
        # Slot (i, j) holds the j-th neighbour of virtual row i's chunk:
        # flat position = row_offsets(vertex) + chunk_index * width + j.
        first_vrow = np.zeros(g.n + 1, dtype=np.int64)
        np.cumsum(vrows_per_vertex, out=first_vrow[1:])
        chunk_idx = np.arange(r_used, dtype=np.int64) - first_vrow[owners]
        flat_start = g.row_offsets[owners] + chunk_idx * width
        take = np.minimum(deg[owners] - chunk_idx * width, width)
        for j in range(width):
            mask = take > j
            cols[:r_used][mask, j] = g.col_indices[flat_start[mask] + j]
        return np.ascontiguousarray(cols.T), vrow_vertex, r

    @classmethod
    def from_host(
        cls, g: CSRGraph, device, width: int = 16, tile_rows: int = 512
    ) -> "EllGraph":
        """Build the layout on the host and move it to ``device``."""
        cols, vrow_vertex, r = cls.host_arrays(g, width, tile_rows)
        return cls(
            torch.from_numpy(cols).to(device),
            torch.from_numpy(vrow_vertex).to(device),
            g.n, r, width,
        )

    def expand_frontier(self, dist, level):
        """The plain per-level expansion over this layout (ops.cuda_bfs)."""
        from ..ops.cuda_bfs import ell_expand_plain  # lazy: models stays op-free

        return ell_expand_plain(dist, level, self)

    def level_step(self, plain: bool = False):
        """One gated level of the distance loop over this layout: kernel
        K8 (``csrc/ell_hits.cu``), or its plain version."""
        from ..ops import cuda_bfs  # lazy: models stays op-free

        level = cuda_bfs.ell_level_plain if plain else cuda_bfs.ell_level
        return lambda carry: level(self, carry)

    def __repr__(self):
        return f"EllGraph(n={self.n}, vrows={self.num_vrows}, width={self.width})"
