"""Kernel K5's pull as a hand-written CUDA kernel: the byte-flag BELL
forest with the visited mask, ``csrc/flag_pull.cu``.

Counterpart of the JAX package's ``bell_hits_packed`` as its byte-flag
engines consume it (ops/lowk.py ``lowk_expand``'s pull, ops/bell.py
``bell_expand_packed``): over (n, Kp) uint8 0/1 planes,

    hits[v, q] = (OR over v's dedup neighbours u of frontier[u, q])
                 AND NOT visited[v, q]

every byte of ``hits`` written, the padding lanes included.  The level
apply computes ``hits & ~visited`` again, which changes nothing.

:func:`flag_pull` launches the kernel on CUDA tensors (a pre-pass, one
launch per forest level, the final gather) and runs :func:`flag_pull_plain`
on CPU tensors only.  Both are gated on the level control: they write
``hits`` only when the level may run and ctrl[3] is the pull direction.
The kernel skips forest rows whose owner vertex needs nothing (every lane
it has not visited is idle this level) and, with the frontier bitmap in
shared memory (:func:`flag_pull_plan`), the frontier rows of sources that
are not in the frontier.  Its walk reuses the forest kernel's bucket
tables (:func:`flag_tables`) and its level-output scratch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..runtime import kernels
from .bell import _max_rows, byte_words, forest_hits
from .bitbell import (
    DIR_PULL,
    INT32_MAX,
    _check_device,
    _check_plane,
    _check_switch,
    direction_go,
)
from .cuda_bell import BLOCK_SMEM_BYTES, TABLE_BYTES, forest_scratch, forest_tables, map_words

# Lanes between two queries' counters in the word view of a byte plane.
LANE_STRIDE = 8


class FlagPullPlan(NamedTuple):
    """How the kernel runs one call (:func:`flag_pull_plan`)."""

    w_instance: int  # 1 (the low-K route), 16 (the bell route at K = 64) or 0
    vec16: bool  # 16-byte row loads (W = 16 on 16-byte aligned planes)
    bitmap: bool  # the frontier bitmap staged in shared memory
    bits: bool  # k = 1: the bitmap is the frontier, no frontier row is read
    chunks: int  # 32-slot chunks of a narrow run a warp has in flight

    @property
    def label(self) -> str:
        """The variant tally's name: "W1/map/bits", "W16/vec16/map",
        "Wn/vec4/nomap"."""
        width = f"W{self.w_instance}" if self.w_instance else "Wn"
        parts = [width]
        if self.w_instance != 1:
            parts.append("vec16" if self.vec16 else "vec4")
        parts.append("map" if self.bitmap else "nomap")
        if self.bits:
            parts.append("bits")
        return "/".join(parts)


def run_chunks(w: int) -> int:
    """32-slot chunks a warp keeps in flight on rows of ``w`` words
    (csrc/flag_pull.cu ``run_chunks``): eight one-word rows, four of 16
    words, two of the generic width's 8-word passes."""
    return 8 if w == 1 else 4 if w == 16 else 2


def flag_pull_plan(w: int, n: int, k: int, vec16: bool = True) -> FlagPullPlan:
    """The kernel's plan for (n, 4w) byte planes with ``k`` real lanes: a
    pure function of the shapes.  The bitmap goes to shared memory when
    it fits beside the bucket table (n up to 1,835,008); ``vec16``
    (frontier, visited, scratch and hits 16-byte aligned) matters only at
    W = 16."""
    w_instance = w if w in (1, 16) else 0
    bitmap = TABLE_BYTES + 4 * map_words(n) <= BLOCK_SMEM_BYTES
    return FlagPullPlan(
        w_instance,
        bool(vec16) and w_instance == 16,
        bitmap,
        bitmap and w == 1 and k == 1,
        run_chunks(w),
    )


def flag_tables(graph, chunks: int, device):
    """The forest kernel's bucket table and per-level metadata
    (:func:`.cuda_bell.forest_tables`) with its runs cut for ``chunks``
    32-slot chunks: a narrow bucket of R_b rows, rpc to a chunk, takes
    ceil(R_b / (chunks * rpc)) runs, a wide one R_b.  Built once per
    graph, device and chunk count."""
    key = ("flag_pull", str(device), chunks)
    if key not in graph._kernel_tables:
        table, meta = forest_tables(graph, 1, device)
        table, meta = table.cpu().clone(), list(meta)
        for li in range(len(graph.level_cols)):
            begin, count = meta[6 * li + 3], meta[6 * li + 4]
            first = 0
            for e in range(begin, begin + count):
                rows, rpc = int(table[e, 1]), int(table[e, 5])
                table[e, 4] = first
                first += -(-rows // (chunks * rpc)) if rpc else rows
            meta[6 * li + 5] = first
        host = (ctypes.c_longlong * max(len(meta), 1))(*meta)
        graph._kernel_tables[key] = (table.to(device), host)
    return graph._kernel_tables[key]


class FlagPullScratch(NamedTuple):
    """The kernel's device scratch (:func:`flag_pull_scratch`)."""

    v_cat: torch.Tensor  # (total_rows + 1, w) int32 level outputs, last row zero
    fmap: torch.Tensor  # (map_words(n),) int32 frontier bitmap
    live: torch.Tensor  # (ceil(total_rows / 32),) int32 live bits of the rows
    mask: torch.Tensor  # (w,) int32 active lanes, one 0x01 byte each


def flag_pull_scratch(graph, w: int, device) -> FlagPullScratch:
    """Scratch for planes of ``w`` words a row on ``device``."""
    return FlagPullScratch(
        forest_scratch(graph, w, device),
        torch.zeros(map_words(graph.n), dtype=torch.int32, device=device),
        torch.zeros(-(-graph.total_rows // 32), dtype=torch.int32, device=device),
        torch.zeros(w, dtype=torch.int32, device=device),
    )


def flag_pull_plain(
    frontier, visited, graph, hits, ctrl, k, max_levels=INT32_MAX, scratch=None,
    levels=None,
) -> None:
    """The kernel's function in torch, over the bytes: the forest with
    each bucket's width folded by ``amax`` (the plain byte pull), then
    ``hits &= ~visited``.  ``k``, ``scratch`` and ``levels`` are not used."""
    if not direction_go(ctrl, max_levels, DIR_PULL):
        return
    hits.copy_(forest_hits(frontier, graph, reduce=_max_rows))
    hits &= ~visited


def _check_args(frontier, visited, graph, hits, ctrl, k, levels, switch) -> torch.device:
    """The checks of a byte-pull call (:func:`flag_pull`, :class:`FlagPullCall`):
    the planes' shapes and types, the real lanes, the counters and the
    switch; returns the device of every tensor."""
    n = graph.n
    kp = frontier.shape[1]
    w = kp // 4
    for name, t in (("frontier", frontier), ("visited", visited), ("hits", hits)):
        _check_plane(name, byte_words(t), (n, w))
    _check_plane("final_slot", graph.final_slot, (n,))
    _check_plane("ctrl", ctrl, (4,))
    for li, flat in enumerate(graph.level_cols):
        _check_plane(f"level_cols[{li}]", flat)
    if not 0 <= k <= kp:
        raise ValueError(f"k = {k} real lanes in rows of {kp} bytes")
    extra = () if levels is None else (levels,)
    if levels is not None:
        _check_plane("levels", levels, (LANE_STRIDE * kp,))
    if switch is not None:
        if graph.sparse is None:
            raise ValueError("the push needs the BellGraph's dedup CSR")
        start, _, vals = graph.sparse
        _check_switch(switch, n, w)
        _check_plane("start", start, (n,))
        _check_plane("vals", vals)
        extra += (switch.count, switch.worklist, switch.state, switch.hits, start, vals)
    return _check_device(frontier, visited, hits, graph.final_slot, ctrl, *extra,
                         *graph.level_cols)


class FlagPullCall:
    """One byte-pull call (``csrc/flag_pull.cu``) with its arguments
    checked: built once (the byte engines' stepper builds it once per
    batch and plane width), then each call launches with no further
    checks.  Arguments as :func:`flag_pull`'s, on CUDA tensors.

    ``switch``: the carry's :class:`.bitbell.PushSwitch` on the low-K
    route, whose push over the dedup CSR (``graph.sparse``) then runs in
    the first launch on the levels ctrl[3] sends to the push, into the
    switch's hit plane (K5's push, with no launch of its own); None pulls
    only.  The variant tally names it with "/push"."""

    def __init__(
        self, frontier, visited, graph, hits, ctrl, k, max_levels=INT32_MAX, scratch=None,
        levels=None, switch=None,
    ):
        dev = _check_args(frontier, visited, graph, hits, ctrl, k, levels, switch)
        if dev.type != "cuda":
            raise ValueError(f"the byte pull's kernel runs on CUDA tensors, not {dev}")
        n = graph.n
        f_w, v_w, h_w = byte_words(frontier), byte_words(visited), byte_words(hits)
        w = f_w.shape[1]
        if scratch is None:
            scratch = flag_pull_scratch(graph, w, dev)
        _check_plane("scratch", scratch.v_cat, (graph.total_rows + 1, w))
        _check_plane("fmap", scratch.fmap, (map_words(n),))
        _check_plane("live", scratch.live, (-(-graph.total_rows // 32),))
        _check_plane("mask", scratch.mask, (w,))
        aligned = (f_w.data_ptr() | v_w.data_ptr() | h_w.data_ptr() | scratch.v_cat.data_ptr()) % 16 == 0
        plan = flag_pull_plan(w, n, k, aligned)
        table, meta = flag_tables(graph, plan.chunks, dev)
        row_owner = graph.row_owner(dev)
        _check_device(frontier, *scratch, table, row_owner)
        push = (None, None, None, None, 0, None, 0)
        if switch is not None:
            start, _, vals = graph.sparse
            push = (switch.hits.data_ptr(), start.data_ptr(), vals.data_ptr(),
                    switch.worklist.data_ptr(), switch.capacity, switch.state.data_ptr(),
                    min(switch.edge_limit, int(vals.shape[0])))
        self.device = dev
        self.variant = plan.label + ("" if switch is None else "/push")
        self.args = (
            f_w.data_ptr(), v_w.data_ptr(), None if levels is None else levels.data_ptr(),
            int(k), table.data_ptr(), meta, len(graph.level_cols),
            scratch.v_cat.data_ptr(), scratch.fmap.data_ptr(), map_words(n),
            scratch.live.data_ptr(), scratch.mask.data_ptr(), row_owner.data_ptr(),
            graph.final_slot.data_ptr(), h_w.data_ptr(), n, w, graph.total_rows,
            plan.chunks, int(plan.vec16), int(plan.bitmap), int(plan.bits), *push,
            ctrl.data_ptr(), int(max_levels),
        )
        # The tensors behind the pointers live as long as the call.
        self._keep = (frontier, visited, hits, ctrl, levels, scratch, switch, table)

    def __call__(self) -> None:
        kernels.launch("flag_pull", self.device, *self.args, variant=self.variant)


def flag_pull(
    frontier: torch.Tensor,
    visited: torch.Tensor,
    graph,
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    k: int,
    max_levels: int = INT32_MAX,
    scratch: Optional[FlagPullScratch] = None,
    levels: Optional[torch.Tensor] = None,
) -> None:
    """Kernel K5's pull (``csrc/flag_pull.cu``): (n, Kp) uint8 0/1
    frontier and visited planes over a BellGraph -> every byte of the
    (n, Kp) ``hits``, gated on the device.

    ``k``: the real lanes; the frontier's bytes past k must be zero.
    ``levels``: the carry's per-lane level counters (query q at lane 8q,
    (8 Kp,) int32) or None; with them only the queries whose frontier is
    not empty (levels == ctrl[1] + 1) keep a row live, so a query's
    frontier bytes must be zero unless its counter says so.  ``scratch``
    is :func:`flag_pull_scratch`'s (allocated when None).  Checks its
    arguments on every call (:class:`FlagPullCall` once for many)."""
    if frontier.device.type == "cpu":
        _check_args(frontier, visited, graph, hits, ctrl, k, levels, None)
        flag_pull_plain(frontier, visited, graph, hits, ctrl, k, max_levels)
        return
    FlagPullCall(frontier, visited, graph, hits, ctrl, k, max_levels, scratch, levels)()
