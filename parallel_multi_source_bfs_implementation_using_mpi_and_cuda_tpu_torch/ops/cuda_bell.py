"""The BELL forest OR-fold as a hand-written CUDA kernel.

Counterpart of the JAX package's ops/bell.py ``forest_hits`` as
ops/bitbell.py ``bell_hits_or`` runs it over packed bit planes: every
forest level's gather and OR-fold, and the final ``final_slot`` gather,
in ``csrc/forest_or.cu`` (one launch per forest level, then the gather).

Its segment form, for the host-streamed engine (ops/streamed.py): the
level kernel over one uploaded slot segment (:func:`forest_segment`,
with the per-segment bucket tables of :class:`SegmentTables`), at forest
level 0 reading a frontier map built once a BFS level
(:func:`frontier_map`: a bit a vertex, or per two, and the nonzero
rows' weight, so that a slot whose source row is zero reads nothing
while the frontier is thin; the instance by :func:`segment_plan`), and
the final gather as a launch of its own
(:func:`forest_final_gather`); their plain versions are
:func:`.bell.segment_fold`, the packed ``(frontier != 0).any(1)`` and a
take.

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
# Shared memory one block may opt into on an H100 (227 KB), and what a
# level kernel's bucket table takes of it (64 buckets of six int64).
BLOCK_SMEM_BYTES = 232_448
TABLE_BYTES = MAX_KERNEL_BUCKETS * 6 * 8
# One SM's shared memory (228 KB), the runtime's share of each block, and
# the blocks an SM the map instance holds (csrc/forest_or.cu
# kMapBlocksPerSm): the map's resolution is chosen so that they fit.
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024
MAP_BLOCKS_PER_SM = 2
# A level-0 segment launch reads the frontier map while the nonzero rows'
# weight (the level-0 slots naming them, summed by the map launch and
# read on the device) is at most this share of all level-0 slots; above
# it, it reads every slot's row (measured: PERF.md §6).
MAP_DENSE_SHARE = 0.8
# csrc/forest_or.cu's map modes, by segment_plan instance.
MAP_MODES = {"nomap": 0, "map": 1, "gmap": 2}


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


def map_words(n: int) -> int:
    """32-bit words of a frontier map: n bits in whole 16-byte units."""
    return -(-n // 128) * 4


def map_shift(n: int) -> Optional[int]:
    """log2 of the vertices a bit of the shared-memory map covers: the
    finest resolution (one or two vertices a bit) at which
    MAP_BLOCKS_PER_SM blocks of the map instance fit an SM; None beyond
    (n above 1,802,240: the ``gmap`` instance, one vertex a bit)."""
    for shift in (0, 1):
        block = TABLE_BYTES + 4 * map_words(-(-n >> shift)) + BLOCK_RESERVED_BYTES
        if MAP_BLOCKS_PER_SM * block <= SM_SMEM_BYTES:
            return shift
    return None


class SegmentPlan(NamedTuple):
    """How a segment launch runs (:func:`segment_plan`)."""

    forest: ForestPlan  # width instance, vector access, chunks (K1's)
    instance: str  # "map", "gmap" or "nomap"

    @property
    def label(self) -> str:
        """The variant tally's name: "W2/vec16/map", "Wn/vec4/nomap"."""
        return f"{self.forest.label}/{self.instance}"


def segment_plan(w: int, vec16: bool, level: int, n: int, instance=None) -> SegmentPlan:
    """The segment kernel's plan for (n, w) previous rows at forest level
    ``level``: a pure function of the shapes.  Level 0 reads the frontier
    map, in shared memory while two blocks an SM can hold it
    (:func:`map_shift`: ``map``), else from device memory (``gmap``);
    later levels read every slot's row (``nomap``).  ``instance`` forces
    one (tests, measurements).  Never chosen after a failure: a launch
    that fails raises."""
    if instance is None:
        if level > 0:
            instance = "nomap"
        else:
            instance = "gmap" if map_shift(n) is None else "map"
    if instance not in MAP_MODES:
        raise ValueError(f"unknown segment instance {instance!r}")
    return SegmentPlan(forest_plan(w, vec16), instance)


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


# FrontierMap.counts: the launch's running sums and finished blocks (zero
# between launches), then the nonzero rows and their weights' sum.
ROWS, SLOTS = 3, 4


class FrontierMap(NamedTuple):
    """The frontier map of one BFS level (:func:`frontier_map`)."""

    bits: torch.Tensor  # int32: bit b set iff a frontier row v with v >> shift == b is nonzero
    counts: torch.Tensor  # (5,) int64: [ROWS] nonzero rows, [SLOTS] their weights' sum
    weights: torch.Tensor  # (n,) int32: the level-0 slots naming each vertex
    total: int  # the weights' sum over all vertices
    shift: int  # log2 of the vertices a bit covers (0 or 1)


def frontier_map_scratch(n: int, device, weights: torch.Tensor, shift: int = 0) -> FrontierMap:
    """A zeroed map for n vertices on ``device``, a bit per 2**shift of
    them; ``weights`` (int32, on the device): each vertex's weight in the
    dense test (:func:`slot_weights`)."""
    _check_plane("weights", weights, (n,))
    if shift not in (0, 1):
        raise ValueError(f"a map bit covers one or two vertices, not 2**{shift}")
    total = int(weights.sum())
    return FrontierMap(
        torch.zeros(map_words(-(-n >> shift)), dtype=torch.int32, device=device),
        torch.zeros(5, dtype=torch.int64, device=device),
        weights,
        total,
        shift,
    )


def slot_weights(level0_cols, n: int) -> torch.Tensor:
    """Each vertex's count of forest level-0 slots (int32, CPU): the
    weight :func:`frontier_map` sums over the nonzero rows.  ``level0_cols``:
    the level's cols, whole or in pieces (NumPy or CPU tensors)."""
    counts = torch.zeros(n + 1, dtype=torch.int64)
    for cols in level0_cols:
        c = torch.as_tensor(cols).long()
        counts += torch.bincount(c[c < n], minlength=n + 1)[: n + 1]
    return counts[:n].to(torch.int32)


def frontier_map_plain(frontier, fmap: FrontierMap, ctrl, max_levels=INT32_MAX) -> None:
    """The map launch's function in torch."""
    if not direction_go(ctrl, max_levels, DIR_PULL):
        return
    on = (frontier != 0).any(dim=1)
    span = 1 << fmap.shift
    padded = on.new_zeros(32 * span * fmap.bits.shape[0])
    padded[: on.shape[0]] = on
    padded = padded.view(-1, span).any(dim=1)
    place = torch.ones(32, dtype=torch.int64, device=on.device) << torch.arange(
        32, device=on.device)
    words = (padded.view(-1, 32).to(torch.int64) * place).sum(dim=1)
    fmap.bits.copy_(torch.where(words >= 2**31, words - 2**32, words).to(torch.int32))
    fmap.counts[ROWS] = int(on.sum())
    fmap.counts[SLOTS] = int(fmap.weights[on].long().sum())


def frontier_map(
    frontier: torch.Tensor, fmap: FrontierMap, ctrl: torch.Tensor, max_levels: int = INT32_MAX
) -> None:
    """The segment form's pre-pass (``csrc/forest_or.cu``
    ``msbfs_forest_map``), once a BFS level before forest level 0's
    segments: the (n, W) frontier as a bitmap (a bit per 2**fmap.shift
    vertices) into ``fmap.bits``, its nonzero rows into
    ``fmap.counts[ROWS]`` and their weights' sum
    into ``fmap.counts[SLOTS]``, on the device.  Gated like
    :func:`forest_segment`."""
    n, w = frontier.shape
    _check_plane("frontier", frontier)
    _check_plane("bits", fmap.bits, (map_words(-(-n >> fmap.shift)),))
    _check_plane("ctrl", ctrl, (4,))
    if fmap.counts.dtype != torch.int64 or tuple(fmap.counts.shape) != (5,):
        raise ValueError("counts must be (5,) int64")
    dev = _check_device(frontier, fmap.bits, fmap.counts, fmap.weights, ctrl)
    if dev.type == "cpu":
        frontier_map_plain(frontier, fmap, ctrl, max_levels)
        return
    plan = forest_plan(w, _rows_vec16(w, frontier))
    kernels.launch(
        "forest_map", dev,
        frontier.data_ptr(), n, w, int(plan.vec16), fmap.bits.data_ptr(),
        fmap.bits.shape[0], fmap.shift, fmap.weights.data_ptr(), fmap.counts.data_ptr(),
        ctrl.data_ptr(), int(max_levels), variant=plan.label,
    )


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
    fmap: Optional[FrontierMap] = None,
    instance: Optional[str] = None,
) -> None:
    """Kernel K1s (``csrc/forest_or.cu`` ``msbfs_forest_segment``), one
    streamed segment ``i`` of a forest level: out[r] = OR over each
    piece's width of prev[cols[...]], a slot equal to ``prev_rows`` the
    zero row.  ``prev`` (prev_rows, W) the previous level's rows (the
    frontier at level 0), ``cols`` the uploaded segment (at least its
    slots), ``out`` the segment's (rows, W) output rows.  ``fmap``: at
    forest level 0, the frontier's map (:func:`frontier_map`, already
    launched on ``prev``); without one the launch reads every slot's row.
    ``instance`` forces :func:`segment_plan`'s choice.  Gated on the
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
    level = 1 if fmap is None else 0
    plan = segment_plan(w, _rows_vec16(w, prev, out), level, prev_rows, instance)
    table, buckets, runs = tables.entry(i, plan.forest.chunks)
    if tables.device != dev:
        raise ValueError(f"segment tables on {tables.device}, planes on {dev}")
    bits = counts = None
    words = shift = dense = 0
    if plan.instance != "nomap":
        if fmap is None:
            raise ValueError(f"the {plan.instance} instance needs the frontier map")
        shift, words = fmap.shift, fmap.bits.shape[0]
        _check_plane("bits", fmap.bits, (map_words(-(-prev_rows >> shift)),))
        _check_device(prev, fmap.bits, fmap.counts)
        if plan.instance == "map" and TABLE_BYTES + 4 * words > BLOCK_SMEM_BYTES:
            raise ValueError(f"a {4 * words}-byte map does not fit a block's shared memory")
        bits, counts = fmap.bits.data_ptr(), fmap.counts.data_ptr()
        dense = int(MAP_DENSE_SHARE * fmap.total)
    kernels.launch(
        "forest_segment", dev,
        prev.data_ptr(), int(prev_rows), cols.data_ptr(), table, buckets, runs,
        out.data_ptr(), w, plan.forest.chunks, int(plan.forest.vec16),
        MAP_MODES[plan.instance], bits, words, shift, counts, dense,
        ctrl.data_ptr(), int(max_levels), variant=plan.label,
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
    of all forest levels, its last row zero (never read: a vertex whose
    slot is that row is written 0).  Gated like the levels."""
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
        v_cat.data_ptr(), final_slot.data_ptr(), hits.data_ptr(), n, v_cat.shape[0] - 1, w,
        int(plan.vec16), ctrl.data_ptr(), int(max_levels), variant=plan.label,
    )
