"""The BELL forest OR-fold as a hand-written CUDA kernel.

Counterpart of the JAX package's ops/bell.py ``forest_hits`` as
ops/bitbell.py ``bell_hits_or`` runs it over packed bit planes: every
forest level's gather and OR-fold, and the final ``final_slot`` gather,
in ``csrc/forest_or.cu`` (one launch per forest level, then the gather).

Its segment form, for the host-streamed engine (ops/streamed.py): the
same level kernel over one uploaded slot segment
(:func:`forest_segment`, with the per-segment bucket tables of
:class:`SegmentTables`), and the final gather as a launch of its own
(:func:`forest_final_gather`); their plain versions are
:func:`.bell.segment_fold` and a take.

:func:`forest_or` launches the kernel on CUDA tensors and runs
:func:`forest_or_plain` (the plain torch forest of :mod:`.bell`) on CPU
tensors only.  Both are gated on the level control: they write ``hits``
only when the level may run and ctrl[3] is the pull direction.  The
kernel's warps walk row-aligned runs of slots described by
:func:`forest_tables`, a pure function of the forest's shapes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..runtime import kernels
from .bell import forest_hits, segment_fold
from .bitbell import (
    DIR_PULL,
    INT32_MAX,
    KERNEL_WIDTHS,
    _check_device,
    _check_plane,
    direction_go,
)

# Buckets one forest level may have: the kernel's shared-memory table.
MAX_KERNEL_BUCKETS = 64
# Bucket widths up to this take rows packed into 32-lane chunks; wider
# ones a warp per row (csrc/forest_or.cu).
NARROW_WIDTH = 32
# Words a pass of the kernel's generic width (csrc/forest_or.cu kPass).
PASS_WORDS = 8


class ForestPlan(NamedTuple):
    """How the forest kernel runs one call (:func:`forest_plan`)."""

    w_instance: int  # 1, 2, 4 or 8, or 0 for the generic width
    vec16: bool  # vector row loads and stores
    chunks: int  # 32-slot chunks of a narrow run a warp has in flight

    @property
    def label(self) -> str:
        """The variant tally's name: "W2/vec16", "Wn/vec4"."""
        width = f"W{self.w_instance}" if self.w_instance else "Wn"
        return f"{width}/{'vec16' if self.vec16 else 'vec4'}"


def forest_plan(w: int, vec16: bool = True) -> ForestPlan:
    """The forest kernel's plan for planes of ``w`` words a row: a pure
    function of the shapes (``vec16``: frontier, scratch and hits are
    16-byte aligned; it matters from two words a row).  A row read 8
    words at a time (W = 8, and the generic width's passes) keeps two
    chunks in flight, narrower rows four."""
    w_instance = w if w in KERNEL_WIDTHS else 0
    words = w_instance or PASS_WORDS
    return ForestPlan(w_instance, bool(vec16) and w_instance > 1, 2 if words >= 8 else 4)


def forest_tables(graph, w: int, device):
    """The kernel's bucket table ((buckets, 6) int64 on ``device``: slot
    offset, rows, width, level-local first row, first run, rows per
    32-slot chunk — 0 for a wide bucket, whose runs are single rows) and
    per-level host metadata (a ctypes int64 array of (cols pointer,
    previous rows, output row offset, first bucket, buckets, runs) per
    level).  A narrow bucket of width W_b packs 32 // W_b rows into a
    chunk and ``forest_plan(w).chunks`` chunks into a run, so runs hold
    whole rows.  Built once per graph, device and chunk count."""
    chunks = forest_plan(w).chunks
    key = (str(device), chunks)
    if key in graph._kernel_tables:
        return graph._kernel_tables[key]
    entries, meta = [], []
    prev_rows, out_offset = graph.n, 0
    for flat, shapes, size in zip(graph.level_cols, graph.level_shapes, graph.level_sizes):
        begin = len(entries)
        off = row_base = first = 0
        for r_b, w_b in shapes:
            if r_b:
                rpc = NARROW_WIDTH // w_b if w_b <= NARROW_WIDTH else 0
                entries.append((off, r_b, w_b, row_base, first, rpc))
                first += -(-r_b // (chunks * rpc)) if rpc else r_b
            off += r_b * w_b
            row_base += r_b
        if len(entries) - begin > MAX_KERNEL_BUCKETS:
            raise ValueError(
                f"a forest level has {len(entries) - begin} buckets; the "
                f"kernel takes at most {MAX_KERNEL_BUCKETS}"
            )
        meta += [flat.data_ptr(), prev_rows, out_offset, begin, len(entries) - begin, first]
        prev_rows, out_offset = size, out_offset + size
    table = torch.tensor(entries or [(0,) * 6], dtype=torch.int64, device=device)
    host = (ctypes.c_longlong * max(len(meta), 1))(*meta)
    graph._kernel_tables[key] = (table, host)
    return table, host


def forest_scratch(graph, w: int, device) -> torch.Tensor:
    """All level outputs, (total_rows + 1, w) int32, last row zero."""
    return torch.zeros((graph.total_rows + 1, w), dtype=torch.int32, device=device)


def forest_or_plain(
    frontier, graph, hits, ctrl, max_levels=INT32_MAX, slot_budget=None, scratch=None
) -> None:
    """The kernel's function in torch (``scratch`` is not used)."""
    if not direction_go(ctrl, max_levels, DIR_PULL):
        return
    hits.copy_(forest_hits(frontier, graph, slot_budget))


def forest_or(
    frontier: torch.Tensor,
    graph,
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    max_levels: int = INT32_MAX,
    slot_budget: Optional[int] = None,
    scratch: Optional[torch.Tensor] = None,
) -> None:
    """Kernel K1 (``csrc/forest_or.cu``): (n, W) frontier planes -> every
    word of the (n, W) ``hits`` over a BellGraph, gated on the device.
    ``slot_budget`` is accepted for the plain version's sake: the kernel
    never materialises the per-level gather it bounds.  ``scratch`` is the
    level-output buffer of :func:`forest_scratch` (allocated when None)."""
    n, w = graph.n, frontier.shape[1]
    _check_plane("frontier", frontier, (n, w))
    _check_plane("hits", hits, (n, w))
    _check_plane("final_slot", graph.final_slot, (n,))
    _check_plane("ctrl", ctrl, (4,))
    for li, flat in enumerate(graph.level_cols):
        _check_plane(f"level_cols[{li}]", flat)
    dev = _check_device(frontier, hits, graph.final_slot, ctrl, *graph.level_cols)
    if dev.type == "cpu":
        forest_or_plain(frontier, graph, hits, ctrl, max_levels, slot_budget)
        return
    table, meta = forest_tables(graph, w, dev)
    if scratch is None:
        scratch = forest_scratch(graph, w, dev)
    _check_plane("scratch", scratch, (graph.total_rows + 1, w))
    _check_device(frontier, scratch, table)
    ptrs = (frontier.data_ptr(), scratch.data_ptr(), hits.data_ptr())
    plan = forest_plan(w, (ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0)
    kernels.launch(
        "forest_or", dev,
        ptrs[0], table.data_ptr(), meta, len(graph.level_cols),
        ptrs[1], graph.final_slot.data_ptr(), ptrs[2], n, w,
        graph.total_rows, plan.chunks, int(plan.vec16),
        ctrl.data_ptr(), int(max_levels), variant=plan.label,
    )


def segment_table(pieces, chunks: int):
    """One segment's bucket table for the kernel: a row (slot offset from
    the segment's start, rows, width, first output row from the segment's
    first row, first run, rows per 32-slot chunk) per ``(rows, width)``
    piece, as :func:`forest_tables` cuts a level; and the segment's runs."""
    entries = []
    off = row_base = first = 0
    for r_b, w_b in pieces:
        rpc = NARROW_WIDTH // w_b if w_b <= NARROW_WIDTH else 0
        entries.append((off, r_b, w_b, row_base, first, rpc))
        first += -(-r_b // (chunks * rpc)) if rpc else r_b
        off += r_b * w_b
        row_base += r_b
    if len(entries) > MAX_KERNEL_BUCKETS:
        raise ValueError(
            f"a forest segment has {len(entries)} bucket pieces; the kernel "
            f"takes at most {MAX_KERNEL_BUCKETS}"
        )
    return entries, first


class SegmentTables:
    """The bucket tables of every segment of a streamed forest
    (``segments``: each segment's ``(rows, width)`` pieces, in upload
    order), at both run lengths :func:`forest_plan` uses, built on the
    host once and uploaded once to ``device`` (none for the plain
    versions, which read only the pieces)."""

    def __init__(self, segments, device=None):
        self.pieces = [tuple((int(r), int(w)) for r, w in seg) for seg in segments]
        self._by_chunks = {}
        if device is None:
            return
        for chunks in (2, 4):
            rows, index = [], []
            for pieces in self.pieces:
                entries, runs = segment_table(pieces, chunks)
                index.append((len(rows), len(entries), runs))
                rows += entries
            table = torch.tensor(rows or [(0,) * 6], dtype=torch.int64, device=device)
            self._by_chunks[chunks] = (table, index)

    def entry(self, i: int, chunks: int):
        """Segment ``i``'s (table pointer, buckets, runs) at ``chunks``."""
        table, index = self._by_chunks[chunks]
        row, buckets, runs = index[i]
        return table.data_ptr() + row * 6 * table.element_size(), buckets, runs

    @property
    def device(self):
        """The tables' device (None when built for the plain versions)."""
        return self._by_chunks[2][0].device if self._by_chunks else None


def _rows_vec16(w: int, *tensors: torch.Tensor) -> bool:
    """Vector row access: every base pointer aligned to a row's vector
    (8 bytes at two words, 16 at four or eight)."""
    align = 16 if w % 4 == 0 else 8
    return all(t.data_ptr() % align == 0 for t in tensors)


def forest_segment_plain(
    prev, prev_rows, cols, pieces, out, ctrl, max_levels=INT32_MAX
) -> None:
    """The segment kernel's function in torch: :func:`.bell.segment_fold`
    over ``prev`` with its zero sentinel row at ``prev_rows``."""
    if not direction_go(ctrl, max_levels, DIR_PULL):
        return
    v_prev = torch.cat([prev[:prev_rows], prev.new_zeros((1, prev.shape[1]))])
    out.copy_(segment_fold(v_prev, cols, pieces))


def forest_segment(
    prev: torch.Tensor,
    prev_rows: int,
    cols: torch.Tensor,
    tables: SegmentTables,
    i: int,
    out: torch.Tensor,
    ctrl: torch.Tensor,
    max_levels: int = INT32_MAX,
) -> None:
    """Kernel K1s (``csrc/forest_or.cu`` ``msbfs_forest_segment``), one
    streamed segment ``i`` of a forest level: out[r] = OR over each
    piece's width of prev[cols[...]], a slot equal to ``prev_rows`` the
    zero row.  ``prev`` (prev_rows, W) the previous level's rows (the
    frontier at level 0), ``cols`` the uploaded segment (at least its
    slots), ``out`` the segment's (rows, W) output rows.  Gated on the
    device like :func:`forest_or`."""
    pieces = tables.pieces[i]
    w = prev.shape[1]
    slots = sum(r * c for r, c in pieces)
    _check_plane("prev", prev, (prev_rows, w))
    _check_plane("cols", cols)
    _check_plane("out", out, (sum(r for r, _ in pieces), w))
    _check_plane("ctrl", ctrl, (4,))
    if cols.dim() != 1 or cols.shape[0] < slots:
        raise ValueError(f"cols must be 1-D with at least {slots} slots")
    dev = _check_device(prev, cols, out, ctrl)
    if dev.type == "cpu":
        forest_segment_plain(prev, prev_rows, cols[:slots], pieces, out, ctrl, max_levels)
        return
    plan = forest_plan(w, _rows_vec16(w, prev, out))
    table, buckets, runs = tables.entry(i, plan.chunks)
    if tables.device != dev:
        raise ValueError(f"segment tables on {tables.device}, planes on {dev}")
    kernels.launch(
        "forest_segment", dev,
        prev.data_ptr(), int(prev_rows), cols.data_ptr(), table, buckets, runs,
        out.data_ptr(), w, plan.chunks, int(plan.vec16), ctrl.data_ptr(),
        int(max_levels), variant=plan.label,
    )


def forest_final_gather_plain(v_cat, final_slot, hits, ctrl, max_levels=INT32_MAX) -> None:
    """The gather's function in torch."""
    if not direction_go(ctrl, max_levels, DIR_PULL):
        return
    hits.copy_(v_cat[final_slot.long()])


def forest_final_gather(
    v_cat: torch.Tensor,
    final_slot: torch.Tensor,
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    max_levels: int = INT32_MAX,
) -> None:
    """The segment form's final take (``msbfs_forest_gather``):
    hits[v] = v_cat[final_slot[v]] over the (total_rows + 1, W) scratch
    of all forest levels, its last row zero.  Gated like the levels."""
    n, w = hits.shape
    _check_plane("v_cat", v_cat)
    _check_plane("final_slot", final_slot, (n,))
    _check_plane("hits", hits)
    _check_plane("ctrl", ctrl, (4,))
    if v_cat.dim() != 2 or v_cat.shape[1] != w:
        raise ValueError(f"v_cat must be (rows, {w})")
    dev = _check_device(v_cat, final_slot, hits, ctrl)
    if dev.type == "cpu":
        forest_final_gather_plain(v_cat, final_slot, hits, ctrl, max_levels)
        return
    if n == 0:
        return
    plan = forest_plan(w, _rows_vec16(w, v_cat, hits))
    kernels.launch(
        "forest_gather", dev,
        v_cat.data_ptr(), final_slot.data_ptr(), hits.data_ptr(), n, w,
        int(plan.vec16), ctrl.data_ptr(), int(max_levels), variant=plan.label,
    )
