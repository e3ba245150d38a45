"""Tensor-core BFS over blocked adjacency tiles, with a direction switch.

Port of the JAX package's ops/mxu.py.  The dedup CSR is densified on the
host into (T, T) 0/1 int8 blocks, one per NONZERO (row tile, col tile)
pair, indexed by a (tile_row, tile_col) list sorted by (row, col); the
all-zero tiles are skipped.  A level is hits = OR_b tiles[b] @
frontier[tile_col[b]] (:mod:`.cuda_mxu`).  Thin frontiers — at most
``switch`` active rows AND at most ``push_budget`` outgoing dedup edges
(:func:`.engine.frontier_activity`) — go through the push scatter-OR
instead (:func:`.bitbell.sparse_hits_or`): Beamer's direction switch,
with the dense direction on the tensor cores.  Same hit planes either way.

The switch costs no host sync and no host op.  The level apply
(``csrc/level_apply.cu``) counts the new frontier's active rows and
edges, lists its rows for the push and writes the next level's
direction into the control word ctrl[3] (:class:`.bitbell.PushSwitch`;
the sources' direction is made once per batch); both expansion kernels
are launched every level and each returns at once unless ctrl[3] names
its direction, so the host enqueues whole chunks of levels and reads one
status per chunk, as on the stencil route.  A level is the push
(``csrc/push_or.cu``), the tile kernel (``csrc/tile_hits.cu``,
``MSBFS_MXU_KERNEL=1``) or the batched bf16 ``torch.bmm`` route (the
counterpart of the JAX package's XLA einsum; knob unset), then the level
apply.  A requested kernel that fails to build or launch raises: there
is no fallback.

Feasibility bound: densification costs nt * T^2 bytes, so ``from_host``
refuses graphs whose nonzero tile count exceeds MSBFS_MXU_MAX_TILES
(default 2^15, 512 MiB at T = 128).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.csr import sorted_unique
from ..utils import knobs
from ..utils.timing import record_dispatch, record_mxu_tiles
from ..runtime import kernels
from .bfs import validate_level_chunk
from .bitbell import (
    DIR_MATMUL,
    INT32_MAX,
    WORD_BITS,
    BitCarry,
    FusedBestEngine,
    SourceStaging,
    SwitchLimits,
    _pack_status,
    batch_start,
    bit_level_apply,
    bit_level_apply_plain,
    bit_level_chunk,
    default_sparse_budget,
    resolve_megachunk,
    sparse_hits_or,
    sparse_hits_or_plain,
)
from .cuda_mxu import bmm_tile_hits, tile_matmul_hits, tile_matmul_hits_plain
from .engine import frontier_activity

DEFAULT_TILE = 128
# Densification ceiling in nonzero tiles (512 MiB of int8 blocks at T=128).
DEFAULT_MAX_TILES = 1 << 15
# Auto direction switch: push when active rows <= n / this (and the edge
# budget holds).
AUTO_SWITCH_DIVISOR = 64


def resolve_tile(tile: Optional[int] = None) -> int:
    """Effective tile size: explicit argument, else MSBFS_MXU_TILE, else
    128."""
    if tile is None:
        tile = knobs.get_int("MSBFS_MXU_TILE", 0)
        tile = tile or DEFAULT_TILE
    tile = int(tile)
    if tile < 8 or tile % 8:
        raise ValueError(
            f"MSBFS_MXU_TILE={tile}: tile size must be a multiple of "
            "8 (>= 8); 128 is the MXU-native width"
        )
    return tile


def densify_pairs(u: np.ndarray, v: np.ndarray, tile: int, ntr: int):
    """Directed (u, v) edge pairs over an (ntr, ntr) tile grid -> the
    nonzero (T, T) int8 blocks and their (tile_row, tile_col) index,
    sorted by (row, col); NumPy arrays, ``nt >= 0`` leading length."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    tid = (u // tile) * ntr + (v // tile)
    uniq, inv = np.unique(tid, return_inverse=True)
    tiles = np.zeros((uniq.size, tile, tile), dtype=np.int8)
    if uniq.size:
        tiles[inv, u % tile, v % tile] = 1
    return (
        tiles,
        (uniq // ntr).astype(np.int32),
        (uniq % ntr).astype(np.int32),
    )


class MxuGraph:
    """Densified per-tile adjacency and the push direction's dedup CSR,
    on one device.

    ``tiles`` (nt, T, T) int8, ``tile_row``/``tile_col`` (nt,) int32
    sorted by (row, col), ``row_ptr`` (ntr + 1,) int32 with row tile r's
    tiles at [row_ptr[r], row_ptr[r + 1]) (the tile kernel's index);
    ``start``/``count`` (n_pad,) int32 and ``vals`` (E,) int32 are the
    dedup CSR padded to ``n_pad`` rows — the push operand and the
    direction predicate's degree vector."""

    def __init__(self, tiles, tile_row, tile_col, row_ptr, start, count,
                 vals, n, tile):
        self.tiles = tiles
        self.tile_row = tile_row
        self.tile_col = tile_col
        self.row_ptr = row_ptr
        self.start = start
        self.count = count
        self.vals = vals
        self.n = int(n)
        self.tile = int(tile)
        self._tiles_bf16 = None

    @property
    def device(self) -> torch.device:
        return self.count.device

    @property
    def ntr(self) -> int:
        """Tiles per side of the (ntr, ntr) tile grid."""
        return max(1, -(-self.n // self.tile))

    @property
    def n_pad(self) -> int:
        """Vertex rows padded to a whole number of tiles."""
        return self.ntr * self.tile

    @property
    def nt(self) -> int:
        """Nonzero tiles multiplied per dense level."""
        return int(self.tiles.shape[0])

    @property
    def tiles_total(self) -> int:
        """Tiles a dense formulation without the index would multiply."""
        return self.ntr * self.ntr

    @property
    def level_flops(self) -> int:
        """Analytic FLOPs of one dense level per frontier lane."""
        return 2 * self.nt * self.tile * self.tile

    @property
    def tiles_bf16(self) -> torch.Tensor:
        """The tiles in bfloat16, converted once and kept (the bmm
        route's operand)."""
        if self._tiles_bf16 is None:
            self._tiles_bf16 = self.tiles.to(torch.bfloat16)
        return self._tiles_bf16

    @classmethod
    def from_host(
        cls,
        g,
        device,
        tile: Optional[int] = None,
        max_tiles: Optional[int] = None,
        native: bool = True,
    ) -> "MxuGraph":
        """Densify a host CSRGraph's dedup adjacency onto ``device``.
        Raises ValueError when the nonzero tile count exceeds
        ``max_tiles`` (MSBFS_MXU_MAX_TILES).  ``native=False`` dedups
        with NumPy instead of the native runtime."""
        tile = resolve_tile(tile)
        if max_tiles is None:
            max_tiles = knobs.get_int("MSBFS_MXU_MAX_TILES", 0)
            max_tiles = max_tiles or DEFAULT_MAX_TILES
        n = g.n
        u, v, count_n = g.deduped_pairs(native=native)
        ntr = max(1, -(-n // tile))
        n_pad = ntr * tile
        count = np.zeros(n_pad, dtype=np.int32)
        count[:n] = count_n
        start = np.zeros(n_pad, dtype=np.int32)
        np.cumsum(count[: n_pad - 1], out=start[1:])
        nt = int(sorted_unique((u // tile) * ntr + (v // tile)).size)
        if nt > max_tiles:
            raise ValueError(
                f"mxu densification needs {nt} nonzero {tile}x{tile} "
                f"tiles (> MSBFS_MXU_MAX_TILES={max_tiles}, "
                f"~{nt * tile * tile >> 20} MB): graph too "
                "tile-dense for the MXU route; use the gather engines"
            )
        tiles, tile_row, tile_col = densify_pairs(u, v, tile, ntr)
        row_ptr = np.searchsorted(
            tile_row, np.arange(ntr + 1, dtype=np.int32)
        ).astype(np.int32)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(
            put(tiles), put(tile_row), put(tile_col), put(row_ptr),
            put(start), put(count), put(v.astype(np.int32)), n, tile,
        )


def mxu_matmul_hits(
    graph: MxuGraph, frontier: torch.Tensor, kernel: bool = False
) -> torch.Tensor:
    """(n_pad, W) frontier planes -> new (n_pad, W) hit planes over the
    graph's nonzero tiles: the tile kernel (its plain version on the CPU)
    or the bf16 bmm route."""
    if not kernel:
        return bmm_tile_hits(
            graph.tiles_bf16, graph.tile_row, graph.tile_col,
            graph.ntr, frontier, torch.bfloat16,
        )
    hits = torch.empty_like(frontier)
    go = torch.tensor([1, 0, 0, DIR_MATMUL], dtype=torch.int32, device=frontier.device)
    tile_matmul_hits(
        graph.tiles, graph.tile_row, graph.tile_col, graph.row_ptr, frontier,
        hits, go,
    )
    return hits


def mxu_expand(graph: MxuGraph, kernel: bool = False, plain: bool = False):
    """The direction-switched expansion of one level, as a function
    ``expand(carry, hits, max_levels)`` from ``carry.frontier``: the push
    into the switch's plane and the matmul into ``hits``, each gated on
    the direction the previous level's apply wrote into ctrl[3] (the
    carry's :class:`.bitbell.PushSwitch`).  ``plain`` runs the kernels'
    plain versions; else ``kernel`` picks the tile kernel over the bf16
    bmm route."""
    push = sparse_hits_or_plain if plain else sparse_hits_or

    def expand(carry: BitCarry, hits: torch.Tensor, max_levels: int) -> None:
        sw = carry.switch
        push(
            carry.frontier, graph.start, graph.vals, sw.hits, carry.ctrl, sw,
            max_levels,
        )
        if plain or kernel:
            matmul = tile_matmul_hits_plain if plain else tile_matmul_hits
            matmul(
                graph.tiles, graph.tile_row, graph.tile_col, graph.row_ptr,
                carry.frontier, hits, carry.ctrl, max_levels,
            )
            return
        # The library route cannot be gated on the device: it runs every
        # level, and the apply reads its plane only on a matmul level.
        hits.copy_(mxu_matmul_hits(graph, carry.frontier))

    return expand


class MxuEngine(FusedBestEngine):
    """Tensor-core direction-switched engine over an :class:`MxuGraph`.

    ``switch``: active-row threshold of the per-level direction switch
    (MSBFS_MXU_SWITCH; None = auto n / 64, 0 = never push).
    ``push_budget``: edge budget of the push direction
    (:func:`.bitbell.default_sparse_budget` auto), clamped to
    [1, n_pad + E].  ``kernel`` (MSBFS_MXU_KERNEL=1): the CUDA tile kernel
    for the matmul direction, else the bf16 bmm route.  ``plain`` runs
    every kernel's plain torch version (the reference, on any device).

    Every chunked drive records the analytic tile FLOPs and zero-tile
    skips of the levels it advanced (utils.timing.record_mxu_tiles, an
    issued-if-matmul model); the unchunked drive records nothing.
    ``level_direction_trace`` is the host-stepped diagnostic of the exact
    per-level decisions."""

    # Lattice axes (ops.engine.resolve_axes): the tensor-core kernel on
    # single-device bit planes.
    CAPABILITIES = frozenset({"plane:bit", "residency:hbm", "partition:single", "kernel:mxu"})

    k_align = WORD_BITS

    def __init__(
        self,
        graph: MxuGraph,
        max_levels: Optional[int] = None,
        switch: Optional[int] = None,
        push_budget: Optional[int] = None,
        level_chunk: Optional[int] = None,
        megachunk: Optional[int] = None,
        kernel: Optional[bool] = None,
        plain: bool = False,
    ):
        self.graph = graph
        self.device = graph.device
        self.max_levels = max_levels
        self._max_levels = INT32_MAX if max_levels is None else int(max_levels)
        self.level_chunk = validate_level_chunk(level_chunk)
        self.megachunk = resolve_megachunk(megachunk, self.level_chunk)
        if switch is None:
            env = knobs.raw("MSBFS_MXU_SWITCH", "")
            switch = int(env) if env.strip() else None
        if switch is None:
            switch = max(1, graph.n // AUTO_SWITCH_DIVISOR)
        self.switch = int(switch)
        e = int(graph.vals.shape[0])
        if push_budget is None:
            push_budget = default_sparse_budget(e)
        self.push_budget = max(1, min(int(push_budget), graph.n_pad + e))
        if kernel is None:
            kernel = knobs.raw("MSBFS_MXU_KERNEL", "") == "1"
        self.kernel = bool(kernel)
        self.plain = bool(plain)
        self._expand = mxu_expand(graph, self.kernel, self.plain)
        self._staging = SourceStaging()
        self.last_direction_trace = []

    def _account(self, advanced: int, k: int) -> None:
        """Record ``advanced`` levels of analytic tile work at the
        WORD_BITS-padded lane width."""
        if advanced > 0:
            g = self.graph
            lanes = -(-max(int(k), 1) // WORD_BITS) * WORD_BITS
            record_mxu_tiles(
                advanced * g.level_flops * lanes,
                advanced * (g.tiles_total - g.nt),
                advanced * g.tiles_total,
            )

    # -- the level loop --------------------------------------------------

    def _init_carry(self, queries) -> BitCarry:
        """The carry over (n_pad, W) planes (sources at or past n dropped,
        the tile padding's rows zero), with the switch's push predicate
        ``active rows <= switch and their edges <= push_budget`` decided for
        the sources."""
        limits = SwitchLimits(self.graph.count, min(self.switch, INT32_MAX), self.push_budget)
        return batch_start(self.graph.n, queries, self.device, rows=self.graph.n_pad,
                           switch=limits, plain=self.plain, staging=self._staging)

    def _step(self, carry: BitCarry, hits: torch.Tensor) -> None:
        """One gated level: expansion in the switched direction, apply."""
        self._expand(carry, hits, self._max_levels)
        apply = bit_level_apply_plain if self.plain else bit_level_apply
        apply(carry, hits, self._max_levels)

    def _chunk(self, carry: BitCarry, bound, hits) -> None:
        bit_level_chunk(
            carry, lambda c: self._step(c, hits), bound, self._max_levels
        )

    def _drive(self, queries, k):
        carry = self._init_carry(queries)
        hits = torch.empty_like(carry.frontier)
        if not self.level_chunk:
            self._chunk(carry, None, hits)
            status = _pack_status(carry, k).tolist()
            record_dispatch()
            return carry, status
        bound = self.level_chunk * self.megachunk
        prev_level = 0
        while True:
            self._chunk(carry, bound, hits)
            # One blocking read per chunk serves the continue-check and,
            # on the last chunk, the answer.
            status = _pack_status(carry, k).tolist()
            record_dispatch()
            level, updated = status[0], status[1]
            self._account(level - prev_level, k)
            prev_level = level
            if not updated or level >= self._max_levels:
                break
        return carry, status

    def _warm(self, queries) -> None:
        """Build and load the kernels (and convert the bmm route's tiles),
        then run one real level from one source, so module loads and
        first-call allocations land in the preprocessing span."""
        if self.device.type == "cuda" and not self.plain:
            kernels.library()
        if self.graph.n:
            queries = queries.copy()
            queries[0, 0] = 0
        carry = self._init_carry(queries)
        self._chunk(carry, 1, torch.empty_like(carry.frontier))
        _pack_status(carry, 0).tolist()

    # -- diagnostics -----------------------------------------------------

    def level_direction_trace(self, queries, max_levels=None):
        """Exact per-level push/matmul decisions: a host-stepped drive
        (one density read and one single-level chunk per executed level —
        a diagnostic, not the perf path) evaluating the predicate the
        device writes into ctrl[3].  Returns (and stores in
        ``last_direction_trace``) one dict per executed level:
        {level, direction, active_rows, active_edges}."""
        queries, _ = self._pad_queries(queries)
        cap = max_levels or self.max_levels or self.graph.n + 1
        carry = self._init_carry(queries)
        hits = torch.empty_like(carry.frontier)
        trace = []
        while len(trace) < cap:
            _, cnt, edges = frontier_activity(carry.frontier, self.graph.count)
            cnt, edges = torch.stack([cnt, edges]).tolist()
            record_dispatch()
            if cnt == 0:  # empty frontier: the loop would have exited
                break
            push = cnt <= self.switch and edges <= self.push_budget
            trace.append(
                {
                    "level": len(trace) + 1,
                    "direction": "push" if push else "matmul",
                    "active_rows": cnt,
                    "active_edges": edges,
                }
            )
            self._chunk(carry, 1, hits)
        self.last_direction_trace = trace
        return trace
