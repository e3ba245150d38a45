"""Bucketed hierarchical ELL ("BELL"): the reduction-forest layout of the
default route.

Each vertex's (dedup) neighbour list is assigned to a width bucket — the
smallest W in ``widths`` with deg <= W — and padded to exactly W slots
with a sentinel index that points at an always-zero row.  Vertices with
more neighbours than the widest rung ("hubs") are split into chunk rows,
and a further forest level reduces each hub's chunk rows the same way,
until every vertex owns one row.  ``final_slot[v]`` indexes that row in
the concatenation of all level outputs (the total row count means a zero
row: an isolated vertex).

Built on the host with NumPy exactly as the JAX package's models/bell.py
builds it (its native loader, its host-only ``device=False`` layout and
its weight column are not ported), then moved to one device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .csr import CSRGraph

# Width ladder: dense 1..16, then ~1.3x geometric steps to the 256-wide hub
# chunk rows (the JAX package's ladder).
DEFAULT_WIDTHS = tuple(range(1, 17)) + (21, 27, 34, 44, 56, 72, 92, 118, 152, 196, 256)


def _bucket_rows(
    item_start: np.ndarray,  # (V,) int64: start of each owner's item range
    item_count: np.ndarray,  # (V,) int64: number of items per owner
    widths: Sequence[int],
    sentinel: int,
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """Assign each owner's contiguous item range to padded fixed-width
    rows.  Returns (cols_per_bucket, row_owner_count, owner_first_row):
    cols_per_bucket[b] is an (R_b, W_b) int64 array of item indices
    (padding = ``sentinel``); rows are ordered bucket by bucket, then by
    owner; an owner's rows are consecutive from owner_first_row[v]."""
    v_total = item_count.shape[0]
    w_max = widths[-1]
    cols_per_bucket: List[np.ndarray] = []
    owner_first_row = np.zeros(v_total, dtype=np.int64)
    owner_rows = np.zeros(v_total, dtype=np.int64)
    row_base = 0
    prev_w = 0
    for w in widths:
        if w == w_max:
            sel = item_count > prev_w  # hubs fall into chunked W_max rows
            rows_per = -(-item_count // w)  # ceil
        else:
            sel = (item_count > prev_w) & (item_count <= w)
            rows_per = np.ones(v_total, dtype=np.int64)
        owners = np.nonzero(sel)[0]
        prev_w = w
        if owners.size == 0:
            cols_per_bucket.append(np.empty((0, w), dtype=np.int64))
            continue
        rpo = rows_per[owners]
        r_b = int(rpo.sum())
        first = np.zeros(owners.size + 1, dtype=np.int64)
        np.cumsum(rpo, out=first[1:])
        oidx = np.repeat(np.arange(owners.size, dtype=np.int64), rpo)
        chunk = np.arange(r_b, dtype=np.int64) - first[oidx]
        start = item_start[owners][oidx] + chunk * w
        remain = np.minimum(item_count[owners][oidx] - chunk * w, w)
        cols = start[:, None] + np.arange(w, dtype=np.int64)[None, :]
        cols[np.arange(w)[None, :] >= remain[:, None]] = sentinel
        cols_per_bucket.append(cols)
        owner_first_row[owners] = row_base + first[:-1]
        owner_rows[owners] = rpo
        row_base += r_b
    return cols_per_bucket, owner_rows, owner_first_row


class BellGraph:
    """Device-resident BELL layout (see module docstring).

    ``level_cols[li]`` is one flat int32 tensor per forest level (its
    buckets concatenated row-major) with ``level_shapes[li]`` = ((R_b,
    W_b), ...); indices address rows of the previous level's value array
    (the frontier for level 0), whose row ``prev_rows`` is the zero
    sentinel.  ``sparse`` is the dedup CSR (start (n,), count (n,), vals
    (E,), int32) that the push direction scatters through, or None."""

    def __init__(
        self, level_cols, level_shapes, final_slot, n, n_pad, level_sizes,
        fill, sparse=None, walk=None,
    ):
        self.level_cols = list(level_cols)
        self.level_shapes = tuple(tuple(tuple(x) for x in s) for s in level_shapes)
        self.final_slot = final_slot  # (n,) int32 into the concat of outputs
        self.n = int(n)
        self.n_pad = int(n_pad)
        self.level_sizes = tuple(int(x) for x in level_sizes)
        self.fill = float(fill)
        self.sparse = sparse
        self._kernel_tables = {}  # device -> forest_or bucket tables
        # (rows per owner, first row) of every forest level, as built.
        self._walk = walk
        self._row_owner = {}  # device -> row_owner()

    @property
    def device(self) -> torch.device:
        return self.final_slot.device

    @property
    def total_rows(self) -> int:
        return sum(self.level_sizes)

    def row_owner(self, device) -> torch.Tensor:
        """(total_rows,) int32: the vertex that owns each forest row, in
        the order of the level outputs' concatenation (a hub's chunk rows
        and the rows reducing them are all the hub's).  A pure function of
        the layout, built once per device from the walk ``from_host``
        kept."""
        key = str(device)
        if key not in self._row_owner:
            parts = [np.zeros(0, dtype=np.int64)]
            for rows_per_owner, first_row in self._walk or ():
                owners = np.flatnonzero(rows_per_owner)
                count = rows_per_owner[owners]
                # Each owner's rows are consecutive from its first row.
                out = np.empty(int(count.sum()), dtype=np.int64)
                within = np.arange(out.shape[0]) - np.repeat(np.cumsum(count) - count, count)
                out[np.repeat(first_row[owners], count) + within] = np.repeat(owners, count)
                parts.append(out)
            owner = np.concatenate(parts).astype(np.int32)
            if owner.shape[0] != self.total_rows:
                raise ValueError("the layout's walk does not cover its forest rows")
            self._row_owner[key] = torch.from_numpy(owner).to(device)
        return self._row_owner[key]

    @staticmethod
    def pack_level(cols_per_bucket):
        """(list of (R_b, W_b) arrays) -> (flat (S,) array, shapes)."""
        shapes = tuple(tuple(c.shape[-2:]) for c in cols_per_bucket)
        if not cols_per_bucket:
            return np.zeros((0,), dtype=np.int32), shapes
        lead = cols_per_bucket[0].shape[:-2]
        flats = [np.reshape(c, lead + (-1,)) for c in cols_per_bucket]
        return np.concatenate(flats, axis=-1), shapes

    @staticmethod
    def estimate_hbm_bytes(n: int, e: int, k: int = 64, vertex_shards: int = 1) -> int:
        """Worst-case per-device footprint of the hybrid bit-plane run over
        this layout, the JAX package's model kept as it is so that both
        CLIs route alike: forest cols (~e/fill slots x 4 B), the per-level
        gather intermediate (slots x ceil(k/32) words x 4 B), the dedup
        CSR ((e + 2n) x 4 B) and the bit planes with byte-lane scratch
        (n x (16W + k_pad) B); plus the byte pull's per-row arrays
        (:meth:`flag_pull_bytes`), which the JAX package does not have."""
        k_pad = max(32, -(-k // 32) * 32)
        w = k_pad // 32
        fill_floor = 0.7 if e >= (1 << 25) else 0.33
        slots = int(e / fill_floor) + 1
        shards = max(1, vertex_shards)
        per_shard_edges = (4 * slots + 4 * w * slots) // shards
        flag_pull = BellGraph.flag_pull_bytes(n, e) // shards
        if vertex_shards > 1:
            push_csr = (4 * e + 12 * min(n, e)) // vertex_shards
            return per_shard_edges + push_csr + 16 * w * n + flag_pull
        return per_shard_edges + 4 * (e + 2 * n) + n * (16 * w + k_pad) + flag_pull

    @staticmethod
    def flag_pull_bytes(n: int, e: int) -> int:
        """The byte pull's arrays (ops/cuda_flag_pull.py): the owner of
        every forest row (4 B) and the pre-pass's bits, one a row and one
        a vertex.  Rows are at most n plus one hub chunk row per 128 edges
        (the widest rung holds 256)."""
        rows = n + e // 128
        return 4 * rows + (rows + n) // 8

    @staticmethod
    def default_min_bucket_rows(n: int, e: int) -> int:
        """Auto rung-pruning threshold (the JAX package's policy)."""
        return min(16384 if e < (1 << 24) else 2048, max(1, n // 4))

    @staticmethod
    def resolve_widths(
        widths: Sequence[int], degrees: np.ndarray, n: int, e: int,
        min_bucket_rows: Optional[int],
    ) -> Tuple[int, ...]:
        """Prune the default ladder by the e-scaled threshold; an explicit
        ladder is kept unless ``min_bucket_rows`` is given."""
        widths = tuple(sorted(widths))
        if min_bucket_rows is None:
            min_bucket_rows = (
                BellGraph.default_min_bucket_rows(n, e)
                if widths == tuple(sorted(DEFAULT_WIDTHS))
                else 0
            )
        if min_bucket_rows:
            widths = BellGraph.adaptive_widths(degrees, widths, min_bucket_rows)
        return widths

    @staticmethod
    def adaptive_widths(
        degrees: np.ndarray, widths: Sequence[int] = DEFAULT_WIDTHS,
        min_bucket_rows: int = 4096,
    ) -> Tuple[int, ...]:
        """Drop rungs whose bucket would hold < ``min_bucket_rows`` owners
        (they pad up to the next kept width); the widest rung stays."""
        widths = sorted(widths)
        hist = np.bincount(np.clip(degrees, 0, widths[-1]), minlength=widths[-1] + 1)
        kept = []
        prev_w = 0
        pending = 0
        for w in widths[:-1]:
            pending += int(hist[prev_w + 1 : w + 1].sum())
            prev_w = w
            if pending >= min_bucket_rows:
                kept.append(w)
                pending = 0
        kept.append(widths[-1])
        return tuple(kept)

    @staticmethod
    def from_host(
        g: CSRGraph,
        device,
        widths: Sequence[int] = DEFAULT_WIDTHS,
        dedup: bool = True,
        min_bucket_rows: Optional[int] = None,
        keep_sparse: bool = True,
    ) -> "BellGraph":
        """Build the layout on ``device``.  ``dedup`` drops duplicate
        neighbours and self-loops (the hit is a set predicate, so BFS
        distances cannot change); ``keep_sparse`` also keeps the dedup CSR
        for the push direction (skipped when E >= 2^31)."""
        n = g.n
        e = int(g.num_directed_edges)
        if dedup and e:
            _, item_vals, item_count = g.deduped_pairs()
            item_start = np.zeros(n, dtype=np.int64)
            np.cumsum(item_count[:-1], out=item_start[1:])
        else:
            item_vals = np.asarray(g.col_indices, dtype=np.int64)
            item_start = np.asarray(g.row_offsets[:-1], dtype=np.int64)
            item_count = np.asarray(g.degrees, dtype=np.int64)
        widths = BellGraph.resolve_widths(widths, item_count, n, e, min_bucket_rows)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

        item_count_0 = item_count
        sparse = None
        if keep_sparse and n and item_vals.shape[0] < (1 << 31):
            sparse = (put(item_start), put(item_count), put(item_vals))
        level_cols, level_shapes, level_sizes = [], [], []
        padded_slots = 0
        out_offset: List[int] = []
        walk: List[Tuple[np.ndarray, np.ndarray]] = []  # (rpo, first row) per level
        while True:
            # Sentinel slots point at the previous value array's zero row:
            # index n of the frontier for level 0, the previous level's row
            # count for deeper levels.
            prev_rows = n if not level_sizes else level_sizes[-1]
            cols_b, rows_per_owner, first_row = _bucket_rows(
                item_start, item_count, widths, item_vals.shape[0]
            )
            vals_ext = np.concatenate([item_vals, np.asarray([prev_rows], dtype=np.int64)])
            flat, shapes = BellGraph.pack_level([vals_ext[cb].astype(np.int32) for cb in cols_b])
            walk.append((rows_per_owner, first_row))
            level_rows = sum(r for r, _ in shapes)
            level_cols.append(put(flat))
            level_shapes.append(shapes)
            level_sizes.append(level_rows)
            padded_slots += sum(r * w for r, w in shapes)
            out_offset.append(sum(level_sizes[:-1]))
            if int(rows_per_owner.max(initial=0)) <= 1:
                break
            # Next level: owners unchanged, items = this level's output rows
            # (consecutive per owner); owners already down to one row drop out.
            item_vals = np.arange(level_rows, dtype=np.int64)
            item_start = first_row
            item_count = np.where(rows_per_owner == 1, 0, rows_per_owner)

        # Each vertex with rows ends at the first level where it owns one
        # row; degree-0 vertices (and any left over) take the zero row.
        final_slot = np.full(n, -1, dtype=np.int64)
        done = np.asarray(g.degrees) == 0
        for li, (rpo, fr) in enumerate(walk):
            newly = (~done) & (rpo == 1)
            final_slot[newly] = out_offset[li] + fr[newly]
            done |= newly
        final_slot[final_slot < 0] = sum(level_sizes)
        return BellGraph(
            level_cols=level_cols,
            level_shapes=level_shapes,
            final_slot=put(final_slot),
            n=n,
            n_pad=n,
            level_sizes=level_sizes,
            fill=int(np.sum(item_count_0)) / max(padded_slots, 1),
            sparse=sparse,
            walk=walk,
        )

    def __repr__(self):
        return f"BellGraph(n={self.n}, levels={list(self.level_sizes)}, fill={self.fill:.2f})"
