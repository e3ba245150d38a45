"""Banded-adjacency ("stencil") BFS: frontier expansion as masked shifts.

Port of the JAX package's ops/stencil.py.  On lattice-like graphs almost
every directed edge (u, v) has a diff ``d = v - u`` from a handful of
values, so one BFS level is, per diff, ``shift(frontier & mask_d, d)`` —
a streamed pass with no gather.  Edges off the dominant diffs (and
offsets too sparse to pay for a plane pass) form a small residual list,
OR-ed into the hits per level.  Semantics are the reference's exactly
(main.cu:16-89): level-synchronous expansion until a level discovers
nothing, -1/out-of-range sources dropped, unreached vertices excluded
from F.

One level on the device is two kernels on one stream:
``csrc/stencil_sweep.cu`` (the masked shifts, with the residual edges ORed
in by the same launch) and ``csrc/level_apply.cu`` (the bit-plane apply
with per-query counts).  The engine's ``plain`` mode runs their plain
torch versions instead, on any device: the reference the kernels are held
against on the card.

The active-row window (``StencilEngine``) slices each chunk of levels to
the frontier band plus its growth margin on residual-free graphs, exactly
as the JAX engine does, and records the same ``last_window_trace``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime import kernels
from ..utils import knobs
from ..utils.timing import record_dispatch, record_plane_pass
from .bfs import validate_level_chunk
from .bitbell import (
    INT32_MAX,
    WORD_BITS,
    BitCarry,
    FusedBestEngine,
    SourceStaging,
    _pack_status,
    batch_start,
    bit_level_apply,
    bit_level_apply_plain,
    bit_level_chunk,
    resolve_megachunk,
    stepped_level_trace,
)
from .cuda_stencil import (
    SweepResidual,
    stencil_sweep,
    stencil_sweep_plain,
)
from .engine import source_band

# Routing defaults: at most this many distinct diffs, covering all but
# MAX_RESIDUAL_FRAC of directed edges.
MAX_OFFSETS = 16
MAX_RESIDUAL_FRAC = 0.02

# An offset whose mask covers fewer than n/DEMOTE_DENSITY vertices is not
# worth a full plane pass; its edges ride the residual instead (capped).
DEMOTE_DENSITY = 64


class StencilGraph:
    """Stencil decomposition of a CSR graph, on ``device``.

    ``offsets``: tuple of nonzero int diffs; ``mask_bits`` (n,) int32 (read
    as uint32) with bit i set iff directed edge (u, u + offsets[i])
    exists.  The residual is compacted by destination: ``res_src`` (R,)
    int32 source rows, ``res_seg`` (R,) int32 sorted segment ids into
    ``res_dst_unique`` (U,) int32.  Self-loops never change reachability
    and are dropped.  ``residual`` holds the same edges as the sweep
    takes them (None without any)."""

    def __init__(
        self, n, num_directed_edges, offsets, mask_bits, res_src, res_seg,
        res_dst_unique,
    ):
        self.n = n
        self.num_directed_edges = num_directed_edges
        self.offsets = offsets
        self.mask_bits = mask_bits
        self.res_src = res_src
        self.res_seg = res_seg
        self.res_dst_unique = res_dst_unique
        self.residual = (
            SweepResidual(n, res_src, res_seg, res_dst_unique)
            if int(res_src.shape[0]) else None
        )

    @property
    def device(self) -> torch.device:
        return self.mask_bits.device

    @classmethod
    def from_numpy(
        cls, n, num_directed_edges, offsets, mask_bits, res_src, res_seg,
        res_dst_unique, device,
    ) -> "StencilGraph":
        """Carry a built decomposition (NumPy arrays, e.g. the JAX
        package's StencilGraph fields) onto ``device``; uint32
        ``mask_bits`` are reinterpreted as int32."""
        mask_bits = np.ascontiguousarray(mask_bits)
        if mask_bits.dtype == np.uint32:
            mask_bits = mask_bits.view(np.int32)

        def put(a):
            return torch.from_numpy(
                np.ascontiguousarray(np.asarray(a, dtype=np.int32))
            ).to(device)

        return cls(
            int(n), int(num_directed_edges), tuple(int(d) for d in offsets),
            put(mask_bits), put(res_src), put(res_seg), put(res_dst_unique),
        )

    @classmethod
    def from_decomposition(
        cls, n, num_directed_edges, offsets, masks, res_src, res_dst, device
    ) -> "StencilGraph":
        """Pack a :func:`detect_stencil` decomposition: demote sparse
        offsets to the residual, bit-pack the kept masks, compact the
        residual by destination (same arrays as the JAX package)."""
        if len(offsets) > 32:
            raise ValueError(
                f"{len(offsets)} offsets exceed the 32-bit mask word "
                "(max_offsets must be <= 32)"
            )
        masks = np.asarray(masks, dtype=np.uint8)
        res_src = np.asarray(res_src, dtype=np.int64)
        res_dst = np.asarray(res_dst, dtype=np.int64)
        if len(offsets):
            counts = masks.sum(axis=0, dtype=np.int64)
            order = np.argsort(counts)  # sparsest first
            budget = max(num_directed_edges // 8, 4096) - res_src.size
            keep = np.ones(len(offsets), dtype=bool)
            for i in order:
                if counts[i] >= max(n // DEMOTE_DENSITY, 1):
                    break  # the rest are denser still
                if counts[i] > budget:
                    break  # demotion cap reached
                keep[i] = False
                budget -= counts[i]
                rows = np.nonzero(masks[:, i])[0]
                res_src = np.concatenate([res_src, rows])
                res_dst = np.concatenate([res_dst, rows + offsets[i]])
            offsets = tuple(o for o, k in zip(offsets, keep) if k)
            masks = masks[:, keep]
        mask_bits = np.zeros(n, dtype=np.uint32)
        for i in range(len(offsets)):
            mask_bits |= masks[:, i].astype(np.uint32) << np.uint32(i)
        if res_src.size:
            order = np.argsort(res_dst, kind="stable")
            res_src = res_src[order]
            res_dst = res_dst[order]
            uniq, seg = np.unique(res_dst, return_inverse=True)
        else:
            uniq = np.zeros(0, dtype=np.int64)
            seg = np.zeros(0, dtype=np.int64)
        return cls.from_numpy(
            n, num_directed_edges, offsets, mask_bits, res_src, seg, uniq,
            device,
        )

    @classmethod
    def from_host(
        cls,
        graph,
        device,
        max_offsets: int = MAX_OFFSETS,
        max_residual_frac: float = MAX_RESIDUAL_FRAC,
    ) -> "StencilGraph":
        """Build from a host CSRGraph; raises ValueError when the graph is
        not banded enough (:func:`detect_stencil` is the no-raise probe)."""
        dec = detect_stencil(graph, max_offsets, max_residual_frac)
        if dec is None:
            raise ValueError(
                "graph is not banded: no small diff set covers "
                f"{1 - max_residual_frac:.0%} of edges "
                "(MSBFS_BACKEND=stencil needs a lattice/banded graph)"
            )
        return cls.from_decomposition(
            graph.n, graph.num_directed_edges, *dec, device
        )


def _edge_arrays(graph):
    """(src, dst) int64 directed-edge arrays from a host CSRGraph."""
    deg = np.diff(np.asarray(graph.row_offsets))
    src = np.repeat(np.arange(graph.n, dtype=np.int64), deg)
    dst = np.asarray(graph.col_indices, dtype=np.int64)
    return src, dst


def detect_stencil(
    graph,
    max_offsets: int = MAX_OFFSETS,
    max_residual_frac: float = MAX_RESIDUAL_FRAC,
):
    """Probe a host CSRGraph for a banded decomposition: (offsets, masks
    (n, #offsets) uint8, res_src, res_dst int32) or None when no
    ``max_offsets``-diff set covers ``1 - max_residual_frac`` of the
    directed edges.  O(m) NumPy passes on the host."""
    n, m = graph.n, graph.num_directed_edges
    if n == 0 or m == 0:
        return None
    src, dst = _edge_arrays(graph)
    diffs = dst - src
    nz = diffs != 0  # self-loops never change reachability
    vals, counts = np.unique(diffs[nz], return_counts=True)
    if vals.size == 0:
        return (
            (),
            np.zeros((n, 0), dtype=np.uint8),
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int32),
        )
    order = np.argsort(counts)[::-1]
    top = order[:max_offsets]
    covered = counts[top].sum()
    if (diffs[nz].size - covered) > max_residual_frac * m:
        return None
    offsets = tuple(int(v) for v in vals[top])
    masks = np.zeros((n, len(offsets)), dtype=np.uint8)
    in_set = np.isin(diffs, vals[top]) & nz
    if len(offsets):
        off_arr = np.fromiter(offsets, dtype=np.int64, count=len(offsets))
        sorter = np.argsort(off_arr)
        cols = sorter[np.searchsorted(off_arr[sorter], diffs[in_set])]
        masks[src[in_set], cols] = 1
    res = nz & ~in_set
    return offsets, masks, src[res].astype(np.int32), dst[res].astype(np.int32)


def _expand_into(
    hits, frontier, mask_bits, graph, ctrl, max_levels, plain
) -> None:
    """One level's hit planes: the masked-shift sweep with the residual."""
    sweep = stencil_sweep_plain if plain else stencil_sweep
    sweep(frontier, mask_bits, graph.offsets, hits, ctrl, max_levels, graph.residual)


def _go_ctrl(device) -> torch.Tensor:
    return torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=device)


def stencil_hits(
    frontier: torch.Tensor, graph: StencilGraph, plain: bool = False
) -> torch.Tensor:
    """(n, W) int32 frontier planes -> (n, W) hit planes via masked shifts
    plus the residual OR."""
    hits = torch.empty_like(frontier)
    _expand_into(
        hits, frontier, graph.mask_bits, graph, _go_ctrl(frontier.device),
        INT32_MAX, plain,
    )
    return hits


def stencil_new(visited, frontier, graph: StencilGraph, plain: bool = False):
    """Newly reached planes: hits & ~visited."""
    return stencil_hits(frontier, graph, plain) & ~visited


def stencil_level_bytes(
    num_offsets: int, rows: int, w_words: int, block: int = 1
) -> int:
    """Analytic full-plane-equivalent bytes one level streams over
    ``rows`` vertices (the JAX package's stream model, kept identical so
    the plane-pass counters of both packages agree): per offset a
    frontier read + a hits write (2W words), the visited/new/F update
    streams (6W words), and the mask word per offset (amortised over
    ``block`` levels)."""
    plane_words = num_offsets * 2 * w_words + 6 * w_words
    mask_words = num_offsets
    return 4 * rows * plane_words + (4 * rows * mask_words) // max(int(block), 1)


# Levels between host syncs when the CLI routes here (the JAX package's
# bound; megachunk multiplies it).
AUTO_STENCIL_LEVEL_CHUNK = 1024


class StencilEngine(FusedBestEngine):
    """All-queries-at-once masked-shift engine over a StencilGraph.

    ``level_chunk`` (times ``megachunk``) bounds the levels between host
    syncs; ``None`` runs to convergence with one final sync.  ``window``
    (``MSBFS_STENCIL_WINDOW``, default on, "0" disables) slices each chunk
    to the frontier band ± max|offset| * chunk rows; it engages only on
    residual-free graphs (a residual edge can jump across the band) with a
    chunked drive, and every chunk's (level entered, band lo, band hi,
    window lo, rows) lands in ``last_window_trace``.  ``plain`` runs the
    kernels' plain torch versions (the reference, on any device)."""

    # Lattice axes and the structural "banded" token: stencil layouts exist
    # only for bandable graphs (ops.engine.BACKEND_EXTRAS demands it).
    CAPABILITIES = frozenset(
        {
            "banded",
            "plane:bit",
            "residency:hbm",
            "partition:single",
            "kernel:xla",
            "kernel:pallas",
        }
    )

    def __init__(
        self,
        graph: StencilGraph,
        max_levels: Optional[int] = None,
        level_chunk: Optional[int] = None,
        megachunk: Optional[int] = None,
        window: Optional[bool] = None,
        plain: bool = False,
    ):
        self.graph = graph
        self.device = graph.device
        self.max_levels = max_levels
        self._max_levels = INT32_MAX if max_levels is None else int(max_levels)
        self.level_chunk = validate_level_chunk(level_chunk)
        self.megachunk = resolve_megachunk(megachunk, self.level_chunk)
        self.plain = bool(plain)
        self._staging = SourceStaging()
        if window is None:
            window = knobs.raw("MSBFS_STENCIL_WINDOW", "") != "0"
        self.window_requested = bool(window)
        self.window_active = (
            self.window_requested
            and int(graph.res_src.shape[0]) == 0
            and bool(self.level_chunk)
        )
        self._maxd = max((abs(d) for d in graph.offsets), default=0)
        self.last_window_trace = []

    # -- the active-row window ------------------------------------------

    def _band_of(self, queries):
        """Initial frontier band [lo, hi), or None when windowing is off."""
        if not self.window_active:
            return None
        return source_band(queries, self.graph.n)

    def _window_for(self, band, steps) -> Tuple[int, int]:
        """(wlo, rows) covering ``band`` + max|d| * steps margin; rows is
        a power of two clamped so rows == n means the full plane."""
        n = self.graph.n
        if band is None:
            return 0, n
        margin = self._maxd * int(steps)
        lo = max(band[0] - margin, 0)
        hi = min(band[1] + margin, n)
        size = max(hi - lo, 1)
        rows = 1 << (size - 1).bit_length()
        if rows >= n:
            return 0, n
        return min(lo, n - rows), rows

    def _account(self, band, wlo, rows, w_words, level0, advanced) -> None:
        """Record the chunk in the window trace and its analytic streamed
        bytes in the plane-pass counter."""
        lo, hi = (0, self.graph.n) if band is None else (band[0], band[1])
        self.last_window_trace.append((level0, lo, hi, int(wlo), int(rows)))
        if advanced > 0:
            record_plane_pass(
                advanced
                * stencil_level_bytes(len(self.graph.offsets), rows, w_words)
            )

    def _grow_band(self, band, advanced) -> None:
        """After ``advanced`` levels the frontier lies within max|d| *
        advanced rows of where it was."""
        if band is not None and advanced > 0:
            band[0] = max(band[0] - self._maxd * advanced, 0)
            band[1] = min(band[1] + self._maxd * advanced, self.graph.n)

    # -- the level loop --------------------------------------------------

    def _init_carry(self, queries) -> BitCarry:
        return batch_start(self.graph.n, queries, self.device, plain=self.plain,
                           staging=self._staging)

    def _step(self, carry: BitCarry, wlo: int, hits: torch.Tensor) -> None:
        """One gated level over the carry's rows (a window starting at
        row ``wlo``, or the whole plane)."""
        rows = carry.visited.shape[0]
        _expand_into(
            hits, carry.frontier, self.graph.mask_bits[wlo : wlo + rows],
            self.graph, carry.ctrl, self._max_levels, self.plain,
        )
        apply = bit_level_apply_plain if self.plain else bit_level_apply
        apply(carry, hits, self._max_levels)

    def _stepper(self, carry: BitCarry):
        """One gated level over the whole plane (the stepped trace's)."""
        hits = torch.empty_like(carry.frontier)
        return lambda c: self._step(c, 0, hits)

    def level_stats(self, queries):
        """Per-level trace (``MSBFS_STATS=2``) via the shared
        :func:`.bitbell.stepped_level_trace`, as BitBellEngine's."""
        padded, k = self._pad_queries(queries)
        return stepped_level_trace(self, padded, k)

    def _chunk(self, carry: BitCarry, wlo: int, rows: int, bound, hits) -> None:
        view = carry.rows(wlo, rows)
        bit_level_chunk(
            view, lambda c: self._step(c, wlo, hits[:rows]), bound,
            self._max_levels,
        )

    def _drive(self, queries, k):
        carry = self._init_carry(queries)
        n = self.graph.n
        hits = torch.empty_like(carry.frontier)
        if not self.level_chunk:
            self._chunk(carry, 0, n, None, hits)
            status = _pack_status(carry, k).tolist()
            record_dispatch()
            return carry, status
        bound = self.level_chunk * self.megachunk
        band = self._band_of(queries)
        w_words = max(1, queries.shape[0] // WORD_BITS)
        self.last_window_trace = []
        prev_level = 0
        while True:
            wlo, rows = self._window_for(band, bound)
            self._chunk(carry, wlo, rows, bound, hits)
            # One blocking read per chunk serves the continue-check and,
            # on the last chunk, the answer.
            status = _pack_status(carry, k).tolist()
            record_dispatch()
            level, updated = status[0], status[1]
            self._account(band, wlo, rows, w_words, prev_level, level - prev_level)
            self._grow_band(band, level - prev_level)
            prev_level = level
            if not updated or level >= self._max_levels:
                break
        return carry, status

    def _warm(self, queries) -> None:
        """Build and load the kernels, then run one real level from one
        source: CUDA loads each kernel module (torch's sort and scatter
        behind the plain batch start included) at its first launch, and the
        chunk loop and the batch start allocate their pinned buffers, so
        none of that lands in the first timed run."""
        if self.device.type == "cuda" and not self.plain:
            kernels.library()
        if self.graph.n:
            queries = queries.copy()
            queries[0, 0] = 0
        carry = self._init_carry(queries)
        self._chunk(carry, 0, self.graph.n, 1, torch.empty_like(carry.frontier))
        _pack_status(carry, 0).tolist()
