"""The BELL forest OR-fold as a hand-written CUDA kernel.

Counterpart of the JAX package's ops/bell.py ``forest_hits`` as
ops/bitbell.py ``bell_hits_or`` runs it over packed bit planes: every
forest level's gather and OR-fold, and the final ``final_slot`` gather,
in ``csrc/forest_or.cu`` (one launch per forest level, then the gather).

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
from .bell import forest_hits
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
