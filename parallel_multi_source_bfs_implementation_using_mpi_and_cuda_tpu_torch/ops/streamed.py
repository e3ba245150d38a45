"""The host-streamed bit-plane BELL engine: the forest stays in host
memory and streams through the device every BFS level.

The port of the JAX package's ops/streamed.py ``StreamedBitBellEngine``,
the last rung of the default route's capacity ladder and the route
``MSBFS_BACKEND=streamed``.  Its semantics are the bit-plane engine's
exactly: every level is a forest pull (no push), the carry is
:func:`.bitbell.batch_start`'s and :func:`.bitbell.bit_level_apply` of
``hits & ~visited`` (kernels K4 and K2), and the host reads the level
control once per BFS level (one :func:`..utils.timing.record_dispatch`).

Each forest level's cols go up in segments of at most ``slot_budget``
slots (whole levels when there is none), cut by the in-memory engine's
own partition (:func:`.bell._slot_segments`), and each segment is folded
by the segment form of K1 (:func:`.cuda_bell.forest_segment`) into one
(total_rows + 1, W) scratch; the final take by ``final_slot`` is its
second entry point (:func:`.cuda_bell.forest_final_gather`).  Forest
level 0's segments read the frontier's map (:func:`.cuda_bell.frontier_map`,
one launch a BFS level, before the first upload is waited on), so a slot
whose source row is zero costs no read of it while the frontier is thin;
the map weighs each vertex by its level-0 slots, counted once here.

The upload pipeline on the card (``prefetch`` deep, ``MSBFS_STREAM_PREFETCH``,
default 2): the host cols are pinned once, at construction, so a
``non_blocking`` copy is a real asynchronous DMA (from pageable memory it
would stage synchronously and the overlap would become a sum); the
copies run on a copy stream the engine owns into a fixed ring of
``prefetch`` device buffers sized to the largest segment, allocated once;
CUDA events guard the ring both ways — the fold of segment i waits for
"segment i uploaded", the upload of segment i + prefetch into the same
buffer waits for "segment i consumed".  With prefetch 1 upload and fold
alternate; with 2 the next segment's upload overlaps the current fold.
Every call enters the engine's device and its compute stream explicitly:
the supervisor's watchdog may run it on a worker thread, and torch's
current stream and device are per thread.  Off the card the same ring
runs with synchronous copies and the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..runtime import kernels
from ..utils import knobs
from ..utils.timing import record_dispatch
from .bell import _slot_segments
from .bitbell import (
    INT32_MAX,
    WORD_BITS,
    BitCarry,
    SourceStaging,
    _pack_status,
    batch_start,
    bit_level_apply,
    bit_level_apply_plain,
)
from .cuda_bell import (
    SegmentTables,
    forest_final_gather,
    forest_final_gather_plain,
    forest_scratch,
    forest_segment,
    forest_segment_plain,
    frontier_map,
    frontier_map_scratch,
    map_shift,
    slot_weights,
)
from .cuda_mesh import forest_max, forest_max_plain
from .packed import PackedEngineBase


class _Segment(NamedTuple):
    """One upload of the streaming schedule."""

    level: int  # forest level
    row0: int  # its first output row within the level
    rows: int  # output rows
    slots: int  # cols uploaded


class StreamedBitBellEngine(PackedEngineBase):
    """Bit-plane BELL engine whose reduction forest streams from host
    memory, over a layout built with ``BellGraph.from_host(...,
    device=False)`` (a device layout is read back once).

    ``device``: where the planes live and the kernels run.
    ``slot_budget`` bounds each uploaded segment in slots (None:
    ``MSBFS_SLOT_BUDGET``, else whole forest levels); ``prefetch`` is the
    ring's depth (None: ``MSBFS_STREAM_PREFETCH``, else 2).  ``plain``
    runs the kernels' plain versions on any device (the reference the
    kernels are held against on the card).

    The per-level host read makes this strictly a large-graph engine:
    below the memory ceiling the in-memory engine's chunked loop wins."""

    # Lattice axes: single-device bit planes with the forest host-resident.
    CAPABILITIES = frozenset(
        {
            "streamed",
            "plane:bit",
            "residency:streamed",
            "partition:single",
            "kernel:xla",
        }
    )

    k_align = WORD_BITS

    def __init__(
        self,
        graph,
        device,
        max_levels: Optional[int] = None,
        slot_budget: Optional[int] = None,
        prefetch: Optional[int] = None,
        plain: bool = False,
    ):
        self.n = int(graph.n)
        self.device = torch.device(device)
        self.max_levels = max_levels
        self._max_levels = INT32_MAX if max_levels is None else int(max_levels)
        # The streamed loop is one level per host read.
        self.level_chunk = 1
        self.megachunk = 1
        if slot_budget is None:
            slot_budget = knobs.get_int("MSBFS_SLOT_BUDGET", 0) or None
        self.slot_budget = slot_budget
        if prefetch is None:
            prefetch = knobs.get_int("MSBFS_STREAM_PREFETCH", 2)
        self.prefetch = max(1, int(prefetch))
        self.plain = bool(plain)
        self._staging = SourceStaging()
        cuda = self.device.type == "cuda"
        self.final_slot = torch.as_tensor(
            np.ascontiguousarray(np.asarray(_host(graph.final_slot), dtype=np.int32))
        ).to(self.device)
        self.level_rows = tuple(int(x) for x in graph.level_sizes)
        self.total_rows = sum(self.level_rows)
        self._row_offset = tuple(int(x) for x in np.cumsum((0,) + self.level_rows)[:-1])
        # The host snapshot (pinned on the card) and the static schedule:
        # _segments[i] is upload i, _slices[i] its host cols, in order.
        segments: List[_Segment] = []
        slices: List[torch.Tensor] = []
        pieces = []
        for li, (flat, shapes) in enumerate(zip(graph.level_cols, graph.level_shapes)):
            host = torch.from_numpy(np.ascontiguousarray(_host(flat), dtype=np.int32))
            if cuda:
                host = host.pin_memory()
            total = int(host.shape[-1])
            if not total:
                continue
            if slot_budget and total > slot_budget:
                cuts = [
                    (seg[0][0], tuple((rc, wb) for _, rc, wb in seg))
                    for seg in _slot_segments(shapes, slot_budget)
                ]
            else:
                cuts = [(0, tuple((r, w) for r, w in shapes if r))]
            row0 = 0
            for a, seg_pieces in cuts:
                slots = sum(rc * wb for rc, wb in seg_pieces)
                rows = sum(rc for rc, _ in seg_pieces)
                segments.append(_Segment(li, row0, rows, slots))
                slices.append(host[a : a + slots])
                pieces.append(seg_pieces)
                row0 += rows
        self._segments = segments
        self._slices = slices
        self.slots_total = sum(s.slots for s in segments)  # uploaded each level
        self._tables = SegmentTables(pieces, self.device if cuda and not self.plain else None)
        # The ring of device buffers and, on the card, the engine's streams
        # and the events that guard the ring both ways.
        max_slots = max((s.slots for s in segments), default=0)
        self._ring = [
            torch.empty(max_slots, dtype=torch.int32, device=self.device)
            for _ in range(self.prefetch)
        ]
        self._compute = self._copy = None
        if cuda:
            self._compute = torch.cuda.Stream(device=self.device)
            self._copy = torch.cuda.Stream(device=self.device)
            self._uploaded = [torch.cuda.Event() for _ in range(self.prefetch)]
            self._consumed = [torch.cuda.Event() for _ in range(self.prefetch)]
        self._scratch = {}  # plane width -> (total_rows + 1, W) level outputs
        # Forest level 0's frontier map, weighted by each vertex's level-0
        # slots (the map instances' dense test, csrc/forest_or.cu).
        self._map = None
        if not self.plain:
            level0 = [c for c, seg in zip(slices, segments) if seg.level == 0]
            weights = slot_weights(level0, self.n).to(self.device)
            shift = map_shift(self.n) or 0  # gmap reads a bit a vertex
            self._map = frontier_map_scratch(self.n, self.device, weights, shift)

    @contextlib.contextmanager
    def _streams(self):
        """Enter the engine's device and compute stream (the card), and
        make the caller's stream wait for the compute on the way out."""
        if self._compute is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self._compute):
            self._compute.wait_stream(caller)
            yield
        caller.wait_stream(self._compute)

    def _upload(self, j: int) -> None:
        """Issue upload ``j`` into ring buffer j % prefetch."""
        slot = j % self.prefetch
        dst = self._ring[slot][: self._segments[j].slots]
        if self._copy is None:
            dst.copy_(self._slices[j])
            return
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(self._consumed[slot])
            dst.copy_(self._slices[j], non_blocking=True)
            self._uploaded[slot].record(self._copy)

    def _scratch_for(self, w: int) -> torch.Tensor:
        if w not in self._scratch:
            self._scratch[w] = forest_scratch(self, w, self.device)
        return self._scratch[w]

    def forest_pass(self, frontier: torch.Tensor, hits: torch.Tensor, ctrl: torch.Tensor,
                    floor: Optional[int] = None) -> None:
        """One BFS level's hit planes: every forest level's segments folded
        as they arrive through the ring, then the final take, into
        ``hits``; gated on ``ctrl`` like the in-memory pull.  Runs on the
        current stream (the engine's compute stream inside its calls).

        With ``floor`` the planes are int32 neg lanes and every segment is
        max-folded by M4 (:func:`.cuda_mesh.forest_max`), the async drive's
        candidate step (at ``floor``) applied to forest level 0's reads,
        and only the final take is gated on ``ctrl`` (the 2D mesh's
        streamed async drive)."""
        if self.n == 0:
            return
        w = frontier.shape[1]
        scratch = self._scratch_for(w)
        count = len(self._segments)
        for j in range(min(self.prefetch, count)):
            self._upload(j)
        if self._map is not None and floor is None:
            frontier_map(frontier, self._map, ctrl, self._max_levels)
        for i, seg in enumerate(self._segments):
            slot = i % self.prefetch
            if seg.level == 0:
                prev, prev_rows = frontier, self.n
            else:
                lo = self._row_offset[seg.level - 1]
                prev_rows = self.level_rows[seg.level - 1]
                prev = scratch[lo : lo + prev_rows]
            lo = self._row_offset[seg.level] + seg.row0
            out = scratch[lo : lo + seg.rows]
            cols = self._ring[slot][: seg.slots]
            if self._compute is not None:
                torch.cuda.current_stream(self.device).wait_event(self._uploaded[slot])
            if floor is not None:
                level_floor = floor if seg.level == 0 else None
                if self.plain:
                    forest_max_plain(prev, prev_rows, cols, self._tables.pieces[i], out,
                                     level_floor)
                else:
                    forest_max(prev, prev_rows, cols, self._tables, i, out, level_floor)
            elif self.plain:
                forest_segment_plain(
                    prev, prev_rows, cols, self._tables.pieces[i], out, ctrl, self._max_levels)
            else:
                forest_segment(prev, prev_rows, cols, self._tables, i, out, ctrl,
                               self._max_levels, fmap=self._map if seg.level == 0 else None)
            if self._compute is not None:
                self._consumed[slot].record(torch.cuda.current_stream(self.device))
            if i + self.prefetch < count:
                self._upload(i + self.prefetch)
        gather = forest_final_gather_plain if self.plain else forest_final_gather
        gather(scratch, self.final_slot, hits, ctrl, self._max_levels)

    def _init_carry(self, queries) -> BitCarry:
        return batch_start(self.n, queries, self.device, plain=self.plain,
                           staging=self._staging)

    def _run(self, queries, max_levels: Optional[int] = None) -> BitCarry:
        """Padded (Kpad, S) queries -> the converged carry: one blocking
        read of the control a BFS level (counted), the level's uploads and
        folds asynchronous within it."""
        cap = self._max_levels if max_levels is None else int(max_levels)
        carry = self._init_carry(queries)
        hits = torch.empty_like(carry.frontier)
        apply = bit_level_apply_plain if self.plain else bit_level_apply
        while True:
            updated, level = carry.ctrl[:2].tolist()
            record_dispatch()
            if not updated or level >= cap:
                break
            self.forest_pass(carry.frontier, hits, carry.ctrl)
            apply(carry, hits, cap)
        return carry

    def f_values(self, queries) -> torch.Tensor:
        padded, k = self._pad_queries(queries)
        with self._streams():
            f = self._run(padded).f[:k]
        if self._compute is not None:
            f.record_stream(torch.cuda.current_stream(self.device))
        return f

    def best(self, queries) -> Tuple[int, int]:
        padded, k = self._pad_queries(queries)
        with self._streams():
            status = _pack_status(self._run(padded), k).tolist()
        record_dispatch()
        return status[2], status[3]

    def query_stats(self, queries):
        padded, k = self._pad_queries(queries)
        with self._streams():
            carry = self._run(padded)
            return (
                carry.levels[:k].cpu().numpy(),
                carry.reached[:k].cpu().numpy(),
                carry.f[:k].cpu().numpy(),
            )

    def compile(self, queries_shape, warm_stats: bool = False, warm_levels: bool = False) -> None:
        """Build and load the kernels and run one real level from one
        source, so module loads and the scratch allocation land in the
        preprocessing span (the stats paths run the same loop)."""
        if self.device.type == "cuda" and not self.plain:
            kernels.library()
        padded, _ = self._pad_queries(np.full(queries_shape, -1, dtype=np.int32))
        if self.n:
            padded[0, 0] = 0
        with self._streams():
            _pack_status(self._run(padded, max_levels=1), 0).tolist()


def _host(a) -> np.ndarray:
    """A layout array as NumPy (a device layout's tensor is read back)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)
