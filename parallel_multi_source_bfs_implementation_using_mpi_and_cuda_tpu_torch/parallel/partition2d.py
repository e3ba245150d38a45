"""2D adjacency partitioning: the bitbell engine over an (R, C) tile mesh.

The JAX package's parallel/partition2d.py.  The CSR is cut into an R x C
grid of tiles over an ('r', 'c') mesh: entry (i, j) holds the adjacency
rows of row block i restricted to the columns of col block j, and owns
the global vertex segment s = j*R + i, rows [s*Lsub, (s+1)*Lsub).  Col
block j is segments (0..R-1, j) in order, and chunk c of row block i's
tile rows is segment (i, c).  A level of shard (i, j):

* the row-axis gather of col block j from the R own frontiers of mesh
  column j (a copy per segment; on a logical mesh of one device the
  column's shards share one block), padded to the square tile space Lt;
* one forest pass over the shard's tile: K1 ``forest_or`` (bit planes),
  K5's byte pull ``flag_pull`` (``plane="byte"``), K7 ``tile_hits`` on
  the mesh-uniform matmul levels of ``kernel="mxu"``, or K1s's streamed
  segments (``residency="streamed"``), into (Lt, W) tile hits;
* the col-axis reduce-scatter (:func:`.collectives.reduce_scatter`):
  each col-axis peer's chunk c reaches shard (i, c) as one copy and one
  launch of M1 ``chunk_merge`` folds them by OR;
* the apply, K2 ``level_apply`` over the own segment; each shard counts
  its own discoveries and the merge sums F and reached and takes the max
  of the levels, which is JAX's psum over both axes.  The updated flags
  are max-reduced over the mesh after every level, so every shard's
  level loop stops together.

The density-adaptive sparse wire (``MSBFS_WIRE_SPARSE``): each shard
encodes its own frontier as budget-padded (index, word) pairs (M2
``wire_encode``), and when the largest count over the mesh fits the
budget the row gather decodes pairs instead of copying segments (H1
``halo_pair_or``'s segmented form: a col block's R segments in one
launch); then each tile's chunks are encoded and, when the col-axis sum
of chunk counts fits (JAX's union bound), the col leg ships pairs too
(the C peers' pairs in one launch, ORed into the zeroed own plane with no
M1, or decoded into C slices for M1's MAX commit).  The route decisions
are JAX's ``pmax`` predicates, taken on one stacked host read of the
shards' counts a leg (only while the sparse wire is on); the bytes
recorded with
:func:`..utils.timing.record_collective_bytes` are the JAX package's
ledger of the branch taken, and :func:`..utils.timing.
record_collective_rounds` ticks once a level.  ``pipelined`` runs its
word stripes one after another: the same planes and the same ledger.

The bounded-staleness async drive (``MSBFS_ASYNC_LEVELS=k > 1``) runs on
int32 neg-distance planes (``ops/bitbell.py`` ``NEG_BASE``): an exchange
round ships the changed entries, M4 ``forest_max`` max-folds the col
block through the tile with the candidate step fused into its reads and
the final take into its last level's launch, and
M1 merges the col-axis chunks by MAX and commits them into the own neg
plane (``neg_commit``) with the round's delta, the changed mask, a flag
and the first local wave's send; up to k - 1 collective-free local waves
follow, each one launch of M4's commit form a shard (the own rows folded
and committed, the next wave's send written; two send buffers a shard
take turns, so a wave never writes the block it reads).  Every exchange
and wave gives the flags a new tag, so "improved this wave" is a flag
equal to the tag and no flag is cleared.  The drive stops after a quiet
round, and the planes then equal the synchronous drive's bit for bit.

JAX pads the tiles' forests to one shape for its SPMD program
(``harmonize_forests``); no reported number depends on those shapes, so
each shard keeps its own forest (the mxu arm keeps JAX's harmonized tile
count, which its ledger reports).  Live resharding
(:meth:`Mesh2DEngine.without_ranks`) drops every mesh row holding a
failed rank and re-cuts the tiles from the host CSR.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.bell import DEFAULT_WIDTHS, BellGraph
from ..models.csr import CSRGraph
from ..ops.bfs import INT32_MAX, validate_level_chunk
from ..ops.bitbell import (
    NEG_BASE,
    SourceStaging,
    _ConvergencePeek,
    batch_start,
    bit_level_apply,
    neg_from_planes,
)
from ..ops.cuda_bell import forest_or, forest_scratch
from ..ops.cuda_flag_pull import flag_pull, flag_pull_scratch
from ..ops.cuda_mesh import (
    BYTE_LANES,
    WORD_LANES,
    Commit,
    cand_floor,
    chunk_merge,
    encode_tiles,
    forest_max_hits,
    forest_max_hits_commit,
    go_control,
    wire_decode,
    wire_decode_segments,
    wire_encode,
)
from ..ops.cuda_halo import ScanScratch
from ..ops.cuda_mxu import tile_matmul_hits
from ..ops.engine import QueryEngineBase, axis_tokens, engine_label
from ..ops.mxu import AUTO_SWITCH_DIVISOR, densify_pairs, resolve_tile
from ..utils import knobs
from ..utils.faults import trip
from ..utils.timing import (
    record_collective_bytes,
    record_collective_rounds,
    record_dispatch,
    record_mxu_tiles,
)
from .collectives import on_device, pmax, psum, reduce_scatter, to_device
from .distributed import stacked_read, stacked_read_ragged, stepped_level_stats
from .mesh import COL_AXIS, ROW_AXIS, make_mesh2d

MERGE_TREES = ("auto", "oneshot", "ring", "halving", "pipelined", "none")

# One sparse wire entry = (int32 flat word index, uint32 word).
WIRE_PAIR_BYTES = 8


def edge_balanced_row_splits(row_offsets, num_parts: int) -> List[int]:
    """Row boundaries splitting a CSR's vertex space into ``num_parts``
    contiguous ranges of roughly equal DIRECTED-EDGE weight: boundary k
    is the first row whose cumulative edge count reaches k/num_parts of
    the total.  Returns ``num_parts + 1`` monotone boundaries with
    ``[0] ... [n]`` at the ends — range i is ``[out[i], out[i+1])``.
    The fleet's shard planner (serve/shards.py) splits by it.
    Degenerate rows (n < num_parts) yield empty trailing ranges rather
    than an error; callers drop empty ranges."""
    ro = np.asarray(row_offsets, dtype=np.int64)
    n = ro.shape[0] - 1
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    total = int(ro[-1])
    targets = (total * np.arange(1, num_parts, dtype=np.int64)) // num_parts
    cuts = np.searchsorted(ro, targets, side="left")
    out = [0] + [int(min(c, n)) for c in cuts] + [n]
    for i in range(1, len(out)):  # monotone under ties/empty rows
        out[i] = max(out[i], out[i - 1])
    return out


def select_merge_tree(c_size: int, override: Optional[str] = None) -> str:
    """The col-axis reduction tree: ``auto`` is recursive halving when C
    is a power of two, ring otherwise; ``oneshot`` and ``pipelined`` are
    explicit-only (``pipelined`` on any axis, C == 1 included); a
    degenerate axis (C == 1) needs no reduction ("none")."""
    t = (override or "auto").strip().lower()
    if t not in MERGE_TREES:
        raise ValueError(
            f"merge tree {override!r} not in {MERGE_TREES}"
        )
    if t == "pipelined":
        return t
    if c_size <= 1:
        return "none"
    if t == "none":
        raise ValueError(f"merge tree 'none' invalid for C={c_size} > 1")
    if t == "halving" and c_size & (c_size - 1):
        raise ValueError(
            f"recursive halving needs a power-of-two col axis, got C={c_size}"
        )
    if t != "auto":
        return t
    return "halving" if c_size & (c_size - 1) == 0 else "ring"


def level_collective_bytes(
    rows: int, cols: int, lsub: int, words: int, tree: str,
    itemsize: int = 4,
) -> int:
    """Whole-mesh wire payload of one dense 2D level (the JAX package's
    ledger): every device receives (R-1) segments in the row gather and
    (C-1) segments on the ring / halving / pipelined col reduce, (C-1)*C
    on the one-shot gather; ``itemsize`` 4 for uint32 bit and int32 neg
    planes, 1 for byte planes."""
    seg = lsub * words * itemsize
    r_recv = (rows - 1) * seg
    if tree in ("ring", "halving", "pipelined"):
        c_recv = (cols - 1) * seg
    elif tree == "oneshot":
        c_recv = (cols - 1) * cols * seg  # Lr = C * Lsub rows gathered
    else:  # "none": degenerate C == 1 axis
        c_recv = 0
    return rows * cols * (r_recv + c_recv)


def resolve_wire_budget(
    spec: Union[None, int, str], lsub: int, words: int
) -> int:
    """MSBFS_WIRE_SPARSE grammar -> the sparse wire budget in (index,
    word) pairs per (Lsub, W) segment: unset / ``auto`` Lsub*W/8, ``0`` /
    ``off`` disables, a positive integer pins it; malformed values fall
    back to auto."""
    auto = max(1, (lsub * words) // 8)
    if spec is None:
        return auto
    if isinstance(spec, (int, np.integer)):
        return max(0, int(spec))
    s = str(spec).strip().lower()
    if s in ("", "auto"):
        return auto
    if s == "off":
        return 0
    try:
        return max(0, int(s))
    except ValueError:
        return auto


def active_word_count(plane: torch.Tensor) -> torch.Tensor:
    """Exact nonzero-word count of an (L, W) plane (int32, on its device)."""
    return (plane != 0).sum(dtype=torch.int32)


def encode_words_sparse(plane: torch.Tensor, budget: int):
    """Budget-padded sparse wire encoding of an (L, W) int32 plane (M2
    ``wire_encode``): ``(budget,)`` ascending flat indices of its nonzero
    words (sentinel L*W) and the matching words (0 at sentinels); exact
    iff the plane has at most ``budget`` nonzero words."""
    enc = wire_encode(plane.contiguous(), budget)
    return enc.idx, enc.words


def decode_words_sparse(idx: torch.Tensor, words: torch.Tensor, total: int) -> torch.Tensor:
    """Sparse (index, word) pairs -> the ``(total,)`` flat word buffer
    (H1 ``halo_pair_or`` into zeros; sentinels drop)."""
    buf = torch.zeros(total, dtype=torch.int32, device=words.device)
    wire_decode(idx, words, buf)
    return buf


class Partition2D:
    """Host-side 2D tiler: the (row-block, col-block) decomposition of a
    CSR over an R x C grid and each tile's BELL forest.

    ``lsub``: rows per owned segment; ``n_pad = R*C*lsub``; ``lr``/``lc``:
    tile output-row / input-col extents; ``lt``: the square padded tile
    space the forests run over.  ``devices``: an (R, C) grid of devices,
    tile (i, j) built on entry (i, j)'s; False keeps every tile on the
    host (the streamed residency).  ``tiles[i][j]`` is tile (i, j)'s
    BellGraph.  One width ladder for all tiles, from the global degree
    histogram."""

    def __init__(
        self,
        g: CSRGraph,
        rows: int,
        cols: int,
        widths: Sequence[int] = DEFAULT_WIDTHS,
        min_bucket_rows: Optional[int] = None,
        devices=False,
        native: bool = True,
    ):
        self.rows, self.cols = rows, cols
        p = rows * cols
        self.lsub = -(-max(g.n, 1) // p)
        self.n_pad = p * self.lsub
        self.lr = cols * self.lsub
        self.lc = rows * self.lsub
        self.lt = max(self.lr, self.lc)
        self.native = native
        self._rows = None
        self.widths = BellGraph.resolve_widths(
            widths, np.asarray(g.degrees), g.n, g.num_directed_edges,
            min_bucket_rows,
        )
        # dedup=False: the tile CSR's rows and cols name different
        # coordinate spaces, so from_host's self-loop test would eat real
        # edges; _tile_csr dedups in global coordinates.
        self.tiles = [
            [
                BellGraph.from_host(
                    self._tile_csr(g, i, j),
                    False if devices is False else devices[i][j],
                    widths=self.widths,
                    dedup=False,
                    min_bucket_rows=0,
                    keep_sparse=False,  # the 2D loop is pull-only
                    native=native,
                )
                for j in range(cols)
            ]
            for i in range(rows)
        ]

    def _dedup(self, g: CSRGraph):
        """``g``'s dedup rows (``CSRGraph.dedup_rows``: each row's
        neighbours sorted, without duplicates and self-loops) and their
        row starts, made once per graph."""
        if self._rows is None or self._rows[0] is not g:
            vals, counts = g.dedup_rows(self.native)
            starts = np.zeros(g.n + 1, dtype=np.int64)
            np.cumsum(counts, out=starts[1:])
            self._rows = (g, vals, starts)
        return self._rows[1:]

    def _tile_csr(self, g: CSRGraph, i: int, j: int) -> CSRGraph:
        """Tile (i, j): adjacency rows of row block i (tile-local row =
        jj*lsub + offset for source col block jj) with neighbour columns
        restricted to col block j and rebased to [0, lc) — a CSR over the
        square space [0, lt), deduplicated and without self-loops in
        global coordinates.  The JAX package sorts each segment's (row,
        col) keys; the dedup rows are already in that order, so a mask of
        the col block's range keeps it."""
        lsub, rows = self.lsub, self.rows
        lo_c, hi_c = j * self.lc, (j + 1) * self.lc
        vals, starts = self._dedup(g)
        degrees = np.zeros(self.lt, dtype=np.int64)
        col_parts: List[np.ndarray] = []
        for jj in range(self.cols):
            seg = jj * rows + i
            lo, hi = seg * lsub, min((seg + 1) * lsub, g.n)
            if lo >= g.n:
                continue
            first = int(starts[lo])
            ci = vals[first : int(starts[hi])]
            keep = (ci >= lo_c) & (ci < hi_c)
            kept = np.zeros(ci.shape[0] + 1, dtype=np.int64)
            np.cumsum(keep, out=kept[1:])
            bounds = starts[lo : hi + 1] - first
            base = jj * lsub
            degrees[base : base + (hi - lo)] = np.diff(kept[bounds])
            col_parts.append((ci[keep] - lo_c).astype(np.int32))
        row_offsets = np.zeros(self.lt + 1, dtype=np.int64)
        np.cumsum(degrees, out=row_offsets[1:])
        return CSRGraph(
            n=self.lt,
            m=0,  # undirected record count is meaningless for a tile
            row_offsets=row_offsets,
            col_indices=(
                np.concatenate(col_parts)
                if col_parts
                else np.zeros(0, dtype=np.int32)
            ),
        )


def mesh_tile_arrays(
    part: Partition2D, g: CSRGraph, tile: Optional[int] = None,
    max_tiles: Optional[int] = None,
):
    """Per-device tile stacks of the mxu arm: every (i, j) tile CSR
    densified over the square (Lt, Lt) space (``ops.mxu.densify_pairs``)
    and padded to one nonzero-tile count ``nt_max`` with all-zero blocks
    at the grid's last (ntr-1, ntr-1) slot (sorted order is kept, and a
    zero tile adds nothing).  Returns ``(arrays, ntr, nt_max)``, NumPy
    leaves shaped (R, C, nt_max, T, T) int8 / (R, C, nt_max) int32.
    Raises ValueError when R*C*nt_max exceeds ``max_tiles``
    (MSBFS_MXU_MAX_TILES)."""
    tile = resolve_tile(tile)
    if max_tiles is None:
        max_tiles = knobs.get_int("MSBFS_MXU_MAX_TILES", 0) or (1 << 15)
    lt = part.lt
    ntr = max(1, -(-lt // tile))
    per = []
    nt_max = 1  # >= 1 so the stacked arrays never have a zero axis
    for i in range(part.rows):
        for j in range(part.cols):
            tcsr = part._tile_csr(g, i, j)
            ro = np.asarray(tcsr.row_offsets, dtype=np.int64)
            u = np.repeat(np.arange(lt, dtype=np.int64), np.diff(ro))
            v = np.asarray(tcsr.col_indices, dtype=np.int64)
            tiles, trow, tcol = densify_pairs(u, v, tile, ntr)
            per.append((tiles, trow, tcol))
            nt_max = max(nt_max, tiles.shape[0])
    total = part.rows * part.cols * nt_max
    if total > max_tiles:
        raise ValueError(
            f"mesh mxu densification needs {total} harmonized "
            f"{tile}x{tile} tiles over {part.rows}x{part.cols} devices "
            f"(> MSBFS_MXU_MAX_TILES={max_tiles}): graph too tile-dense "
            "for the mesh MXU kernel; use kernel=xla"
        )
    stacks = {"tiles": [], "tile_row": [], "tile_col": []}
    last = np.int32(ntr - 1)
    for tiles, trow, tcol in per:
        pad = nt_max - tiles.shape[0]
        if pad:
            tiles = np.concatenate([tiles, np.zeros((pad, tile, tile), np.int8)])
            trow = np.concatenate([trow, np.full(pad, last, np.int32)])
            tcol = np.concatenate([tcol, np.full(pad, last, np.int32)])
        stacks["tiles"].append(tiles)
        stacks["tile_row"].append(trow)
        stacks["tile_col"].append(tcol)
    arrays = {
        k: np.stack(v).reshape(part.rows, part.cols, *v[0].shape)
        for k, v in stacks.items()
    }
    return arrays, ntr, nt_max


class _Shard:
    """One mesh entry: its position, rank (i*C + j), device and tile."""

    def __init__(self, i: int, j: int, rank: int, dev: torch.device):
        self.i, self.j, self.rank, self.dev = i, j, rank, dev
        self.tile = None  # BellGraph on dev (hbm), None when streamed
        self.stream = None  # StreamedBitBellEngine over the host tile
        self.mxu = None  # (tiles, tile_row, tile_col, row_ptr) on dev


class _Run:
    """One batch's per-shard state: the carries (synchronous drive) or neg
    planes (async), the tile hit buffers, the own merged hits, and the col
    blocks, one per (col, device)."""

    def __init__(self):
        self.carries = []
        self.hits = []
        self.own = []
        self.blocks = {}
        self.neg = []
        self.changed = []
        self.delta = []
        self.flags = []
        self.local = []
        self.tag = 0


class Mesh2DEngine(QueryEngineBase):
    """The 2D-partitioned bitbell engine: adjacency tiled over an ('r',
    'c') mesh, queries replicated (all K advance together on every
    shard), per-level traffic = row-axis segment gather + col-axis
    reduce-scatter.

    ``merge_tree``: ``auto`` / ``oneshot`` / ``ring`` / ``halving`` /
    ``pipelined`` (:func:`select_merge_tree`) — bit-identical, only the
    ledger differs.  ``level_chunk``: levels between host status reads
    (the chip-loss seam ``trip("dispatch")`` runs once a chunk).
    ``wire_sparse`` / ``wire_chunks`` override MSBFS_WIRE_SPARSE /
    MSBFS_WIRE_CHUNKS; ``residency`` MSBFS_MESH_RESIDENCY (``hbm`` or
    ``streamed``: each tile's forest stays in host memory and streams
    through its device every level); ``async_levels``
    MSBFS_ASYNC_LEVELS (k > 1: the bounded-staleness drive); ``plane``
    MSBFS_MESH_PLANE (``bit`` or ``byte``); ``kernel`` MSBFS_MESH_KERNEL
    (``xla``, the forest pull, or ``mxu``, the tile matmul with a
    mesh-uniform direction switch).  Compositions no arm supports fail
    loud at construction.  ``w`` is the shard count."""

    CAPABILITIES = frozenset(
        {
            "mesh2d",
            "vertex_sharded",
            "reshard",
            "collective_bytes",
            "streamed",
            "async",
            "partition:mesh2d",
            "plane:bit",
            "plane:byte",
            "residency:hbm",
            "residency:streamed",
            "kernel:xla",
            "kernel:mxu",
        }
    )

    RESIDENCIES = ("hbm", "streamed")
    PLANES = ("bit", "byte")
    KERNELS = ("xla", "mxu")

    def __init__(
        self,
        mesh,
        graph: CSRGraph,
        max_levels: Optional[int] = None,
        widths: Sequence[int] = DEFAULT_WIDTHS,
        min_bucket_rows: Optional[int] = None,
        level_chunk: Optional[int] = None,
        merge_tree: Optional[str] = None,
        residency: Optional[str] = None,
        wire_sparse: Union[None, int, str] = None,
        wire_chunks: Optional[int] = None,
        async_levels: Optional[int] = None,
        plane: Optional[str] = None,
        kernel: Optional[str] = None,
        native: bool = True,
    ):
        if ROW_AXIS not in mesh.shape or COL_AXIS not in mesh.shape:
            raise ValueError(
                f"Mesh2DEngine needs an ('{ROW_AXIS}', '{COL_AXIS}') mesh "
                f"(make_mesh2d), got axes {tuple(mesh.shape)}"
            )
        if not isinstance(graph, CSRGraph):
            raise ValueError(
                "Mesh2DEngine builds its own tile layout; pass the host "
                "CSRGraph"
            )
        self.mesh = mesh
        self.rows = mesh.shape[ROW_AXIS]
        self.cols = mesh.shape[COL_AXIS]
        self.w = self.rows * self.cols
        self.n = graph.n
        self.native = native
        self._host_graph = graph
        self._widths = widths
        self._min_bucket_rows = min_bucket_rows
        self._merge_tree = merge_tree
        res = residency if residency is not None else (knobs.raw("MSBFS_MESH_RESIDENCY") or "hbm")
        res = str(res).strip().lower() or "hbm"
        if res not in self.RESIDENCIES:
            raise ValueError(f"mesh residency {res!r} not in {self.RESIDENCIES}")
        self.residency = res
        self._wire_spec = wire_sparse if wire_sparse is not None else knobs.raw("MSBFS_WIRE_SPARSE")
        self.wire_chunks = max(1, int(
            wire_chunks if wire_chunks is not None else knobs.get_int("MSBFS_WIRE_CHUNKS", 4)))
        self.async_levels = max(1, int(
            async_levels if async_levels is not None else knobs.get_int("MSBFS_ASYNC_LEVELS", 1)))
        pl = plane if plane is not None else (knobs.raw("MSBFS_MESH_PLANE") or "bit")
        pl = str(pl).strip().lower() or "bit"
        if pl not in self.PLANES:
            raise ValueError(f"mesh plane {pl!r} not in {self.PLANES}")
        self.plane = pl
        kn = kernel if kernel is not None else (knobs.raw("MSBFS_MESH_KERNEL") or "xla")
        kn = str(kn).strip().lower() or "xla"
        if kn not in self.KERNELS:
            raise ValueError(f"mesh kernel {kn!r} not in {self.KERNELS}")
        self.kernel = kn
        # Compositions no arm of the class supports fail loud here, naming
        # both axis values: never a silent fallback.
        if pl == "byte" and kn == "mxu":
            raise ValueError(
                "plane:byte does not compose with kernel:mxu — the tile "
                "matmul consumes packed bit planes"
            )
        if pl == "byte" and self.async_levels > 1:
            raise ValueError(
                "plane:byte does not compose with async (bounded-staleness"
                " drive reconciles packed bit planes)"
            )
        if kn == "mxu" and res == "streamed":
            raise ValueError(
                "kernel:mxu does not compose with residency:streamed — "
                "tile stacks are HBM-resident"
            )
        if kn == "mxu" and self.async_levels > 1:
            raise ValueError(
                "kernel:mxu does not compose with async — the direction "
                "switch needs the per-level reconciled frontier"
            )
        self.tree = select_merge_tree(self.cols, merge_tree)
        if kn == "mxu" and self.tree == "pipelined":
            raise ValueError(
                "kernel:mxu does not compose with the pipelined merge "
                "tree — the direction switch needs whole-row frontiers"
            )
        grid = mesh.devices
        self.part = Partition2D(
            graph, self.rows, self.cols, widths, min_bucket_rows,
            devices=False if res == "streamed" else grid, native=native,
        )
        self.max_levels = max_levels
        self._max_levels = INT32_MAX if max_levels is None else int(max_levels)
        self.level_chunk = validate_level_chunk(level_chunk) or 8
        self._level_warm_shapes = set()
        self._staging = SourceStaging()
        self._scratch: Dict[tuple, object] = {}
        self.shards: List[_Shard] = []
        self.prefetch = max(1, knobs.get_int("MSBFS_STREAM_PREFETCH", 2))
        for i in range(self.rows):
            for j in range(self.cols):
                sh = _Shard(i, j, i * self.cols + j, torch.device(grid[i, j]))
                if res == "streamed":
                    from ..ops.streamed import StreamedBitBellEngine

                    with on_device(sh.dev):
                        sh.stream = StreamedBitBellEngine(
                            self.part.tiles[i][j], sh.dev, prefetch=self.prefetch)
                else:
                    sh.tile = self.part.tiles[i][j]
                self.shards.append(sh)
        self._mxu = None
        self._rows_in = self.part.lt
        if kn == "mxu":
            arrays, ntr, nt_max = mesh_tile_arrays(self.part, graph)
            tile = int(arrays["tiles"].shape[-1])
            for sh in self.shards:
                trow = arrays["tile_row"][sh.i, sh.j]
                row_ptr = np.searchsorted(trow, np.arange(ntr + 1)).astype(np.int32)
                sh.mxu = tuple(
                    torch.from_numpy(np.ascontiguousarray(a)).to(sh.dev)
                    for a in (arrays["tiles"][sh.i, sh.j], trow,
                              arrays["tile_col"][sh.i, sh.j], row_ptr)
                )
            env = knobs.raw("MSBFS_MXU_SWITCH")
            switch = int(env) if env else max(1, self.part.lt // AUTO_SWITCH_DIVISOR)
            self._mxu = (ntr, tile, switch, nt_max)
            self._rows_in = max(self._rows_in, ntr * tile)

    # ---- query prep -------------------------------------------------------
    def _prep(self, queries):
        """Bounds-remap against the true vertex count (ids in [n, n_pad)
        would hit padding vertices) and pad K: to a multiple of 32 with
        -1 rows on bit planes (K = 0 still needs a word), only K = 0 to one
        lane on byte planes.  Returns (queries, k)."""
        queries = np.asarray(queries)
        queries = np.where((queries >= 0) & (queries < self.n), queries, -1).astype(np.int32)
        k = queries.shape[0]
        if self.plane == "byte":
            pad = 0 if k else 1
        else:
            pad = (-k) % 32 if k else 32
        if pad:
            queries = np.vstack([queries, np.full((pad, queries.shape[1]), -1, np.int32)])
        trip("device_put")  # upload fault seam (parity with shard_queries)
        return queries, k

    def _stride(self) -> int:
        return 8 if self.plane == "byte" else 1

    def _local(self, queries, sh: _Shard):
        """The queries' sources in ``sh``'s own segment, segment-local."""
        lo = (sh.j * self.rows + sh.i) * self.part.lsub
        return np.where((queries >= lo) & (queries < lo + self.part.lsub), queries - lo, -1)

    def _jax_width(self, kpad: int) -> int:
        """The plane width in the JAX package's elements: uint8 lanes on
        byte planes, uint32 words on bit planes."""
        return max(1, kpad) if self.plane == "byte" else max(1, kpad // 32)

    def level_bytes(self, k: int) -> int:
        """Analytic whole-mesh dense wire bytes of one level for a K-query
        batch (the model the sparse wire's ledger is judged against)."""
        if self.plane == "byte":
            return level_collective_bytes(
                self.rows, self.cols, self.part.lsub, max(1, k), self.tree, itemsize=1)
        return level_collective_bytes(
            self.rows, self.cols, self.part.lsub, -(-k // 32), self.tree)

    def _budget(self, kpad: int) -> int:
        """The sparse wire's budget for a padded batch of ``kpad`` lanes."""
        return resolve_wire_budget(self._wire_spec, self.part.lsub, self._jax_width(kpad))

    def _ledger(self, kpad: int, lanes: Optional[int] = None):
        """(dense, row sparse, col sparse, col dense) whole-mesh bytes of
        one level: the batch's planes, or with ``lanes`` the async drive's
        int32 neg planes of that many lanes."""
        rows, cols, lsub = self.rows, self.cols, self.part.lsub
        budget = self._budget(kpad)
        if lanes is None:
            itemsize, jw = (1 if self.plane == "byte" else 4), self._jax_width(kpad)
        else:
            itemsize, jw = 4, lanes
        dense = level_collective_bytes(rows, cols, lsub, jw, self.tree, itemsize)
        pair = budget * (4 + itemsize)
        seg = lsub * jw * itemsize
        col_tree = "ring" if self.tree == "pipelined" else self.tree
        col_dense = rows * cols * (cols - 1) * seg * (cols if col_tree == "oneshot" else 1)
        return (dense, rows * cols * (rows - 1) * pair, rows * cols * (cols - 1) * pair,
                col_dense)

    # ---- shared pieces of a level ----------------------------------------
    def _scratch_of(self, sh: _Shard, w: int, kind: str):
        """Shard ``sh``'s scratch of ``kind`` at width ``w``, made once:
        the forest's (``or``), the byte pull's (``byte``), or the zero
        visited plane the byte pull masks with (``visited``)."""
        key = (sh.rank, w, kind)
        if key not in self._scratch:
            if kind == "visited":
                self._scratch[key] = torch.zeros((self.part.lt, w), dtype=torch.int32,
                                                 device=sh.dev)
            elif sh.dev.type != "cuda":
                self._scratch[key] = None
            elif kind == "byte":
                self._scratch[key] = flag_pull_scratch(sh.tile, w, sh.dev)
            else:
                self._scratch[key] = forest_scratch(sh.tile, w, sh.dev)
        return self._scratch[key]

    def _encoder(self, sh: _Shard, plane: torch.Tensor) -> Optional[ScanScratch]:
        """Shard ``sh``'s scan scratch for M2 over ``plane``, kept across
        levels and batches (grown to the largest plane it encodes); None
        on a CPU shard."""
        if sh.dev.type != "cuda":
            return None
        key = (sh.rank, "encode")
        held = self._scratch.get(key)
        tiles = encode_tiles(plane.numel())
        if held is None or held.tiles < tiles:
            held = self._scratch[key] = ScanScratch(tiles, sh.dev)
        return held

    def _block(self, run: _Run, j: int, dev, w: int, tag="") -> torch.Tensor:
        """Col block j's (rows_in, w) buffer on ``dev`` (zero past Lc)."""
        key = (j, dev, w, tag)
        if key not in run.blocks:
            run.blocks[key] = torch.zeros((self._rows_in, w), dtype=torch.int32, device=dev)
        return run.blocks[key]

    def _column(self, j: int) -> List[_Shard]:
        return [self.shards[i * self.cols + j] for i in range(self.rows)]

    def _gather_dense(self, run: _Run, planes, tag="") -> Dict[int, Dict]:
        """The row-axis gather: col block j from its shards' own planes, a
        copy a segment onto each distinct device of the column."""
        lsub = self.part.lsub
        out = {}
        for j in range(self.cols):
            col = self._column(j)
            out[j] = {}
            for dev in dict.fromkeys(sh.dev for sh in col):
                w = planes[col[0].rank].shape[1]
                block = self._block(run, j, dev, w, tag)
                with on_device(dev):
                    for sh in col:
                        block[sh.i * lsub : (sh.i + 1) * lsub].copy_(
                            planes[sh.rank], non_blocking=True)
                out[j][dev] = block
        return out

    def _gather_sparse(self, run: _Run, encoded, w: int, tag="") -> Dict[int, Dict]:
        """The sparse row gather (JAX's ``_sparse_row_gather``): the zeroed
        col block, and every segment's (index, word) pairs decoded into its
        slot in one launch (H1's segmented form) per column and device."""
        seg = self.part.lsub * w
        out = {}
        for j in range(self.cols):
            col = self._column(j)
            out[j] = {}
            for dev in dict.fromkeys(sh.dev for sh in col):
                block = self._block(run, j, dev, w, tag)
                with on_device(dev):
                    block[: self.part.lc].zero_()
                    wire_decode_segments(
                        [(to_device(encoded[sh.rank].idx, dev),
                          to_device(encoded[sh.rank].words, dev), sh.i * seg) for sh in col],
                        block, seg)
                out[j][dev] = block
        return out

    def _tile_pass(self, sh: _Shard, block, out, ctrl, k_lanes: int, mm: bool) -> None:
        """Shard ``sh``'s tile hits of one col block into ``out``."""
        lt, w = self.part.lt, block.shape[1]
        with on_device(sh.dev):
            if mm:
                tiles, trow, tcol, row_ptr = sh.mxu
                rows = row_ptr.shape[0] - 1
                t = tiles.shape[1]
                tile_matmul_hits(tiles, trow, tcol, row_ptr, block[: rows * t], out[: rows * t],
                                 ctrl, self._max_levels)
            elif sh.stream is not None:
                sh.stream.forest_pass(block[:lt], out[:lt], ctrl)
            elif self.plane == "byte":
                u8 = torch.uint8
                flag_pull(block[:lt].view(u8), self._scratch_of(sh, w, "visited").view(u8), sh.tile,
                          out[:lt].view(u8), ctrl, k_lanes, self._max_levels,
                          self._scratch_of(sh, w, "byte"))
            else:
                forest_or(block[:lt], sh.tile, out[:lt], ctrl, self._max_levels, None,
                          self._scratch_of(sh, w, "or"))

    # ---- the synchronous drive -------------------------------------------
    def _init_sync(self, queries) -> _Run:
        """Every shard's own-segment carry (K4 ``batch_start`` over its
        segment's sources), the updated flags merged over the mesh."""
        run = _Run()
        lsub = self.part.lsub
        stride = self._stride()
        for sh in self.shards:
            with on_device(sh.dev):
                carry = batch_start(lsub, self._local(queries, sh), sh.dev, lane_stride=stride,
                                    staging=self._staging)
                w = carry.frontier.shape[1]
                run.carries.append(carry)
                run.hits.append(torch.zeros((self._rows_in, w), dtype=torch.int32,
                                            device=sh.dev))
                run.own.append(torch.empty((lsub, w), dtype=torch.int32, device=sh.dev)
                               if self.cols > 1 else run.hits[-1][:lsub])
        run.k_lanes = queries.shape[0]
        self._combine(run)
        return run

    def _combine(self, run: _Run) -> None:
        """The mesh's updated flag (JAX's psum over both axes, as a flag),
        written back to every shard's control."""
        if len(run.carries) == 1:
            return
        merged = pmax([c.ctrl[:1] for c in run.carries])
        for sh, c, m in zip(self.shards, run.carries, merged):
            with on_device(sh.dev):
                c.ctrl[:1].copy_(m)

    def _lanes(self) -> int:
        return BYTE_LANES if self.plane == "byte" else WORD_LANES

    def _stripes(self, w: int):
        """The ``pipelined`` tree's word stripes of a (., w) plane (the
        whole plane on every other tree)."""
        n = self.wire_chunks if self.tree == "pipelined" else 0
        if n <= 1:
            return [(0, w)]
        bounds = [w * t // n for t in range(n + 1)]
        return [(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:]) if lo < hi]

    def _dense_sync(self, run: _Run, mm: bool) -> None:
        """A dense level's hits into every shard's own plane: the copy
        gather, the tile pass and the reduce-scatter, stripe by stripe
        under ``pipelined``."""
        w = run.carries[0].frontier.shape[1]
        stripes = self._stripes(w) if self.residency == "hbm" else [(0, w)]
        for lo, hi in stripes:
            whole = (lo, hi) == (0, w)
            fronts = [c.frontier if whole else c.frontier[:, lo:hi].contiguous()
                      for c in run.carries]
            blocks = self._gather_dense(run, fronts, tag="" if whole else f"s{lo}")
            outs = run.hits if whole else [
                torch.zeros((self._rows_in, hi - lo), dtype=torch.int32, device=sh.dev)
                for sh in self.shards]
            k = run.k_lanes if whole else max(0, min(4 * (hi - lo), run.k_lanes - 4 * lo))
            for sh, c, out in zip(self.shards, run.carries, outs):
                self._tile_pass(sh, blocks[sh.j][sh.dev], out, c.ctrl, k, mm)
            self._col_dense(run, outs, None if whole else (lo, hi), "or")

    def _col_dense(self, run: _Run, hits, stripe, op: str, commit=None) -> None:
        """The dense col leg (:func:`.collectives.reduce_scatter`, M1) of
        every mesh row: into each shard's own plane, a stripe of it, or
        committed when ``commit(sh)`` names a :class:`Commit`."""
        if self.cols == 1 and commit is None and stripe is None:
            return  # the own plane is the tile hits' first Lsub rows
        lsub, whole = self.part.lsub, self.tree == "oneshot"
        for i in range(self.rows):
            row = self.shards[i * self.cols : (i + 1) * self.cols]
            parts = [hits[sh.rank] for sh in row]
            if commit is not None:
                reduce_scatter(parts, lsub, "max", commits=[commit(sh) for sh in row],
                               whole=whole)
            elif stripe is None:
                reduce_scatter(parts, lsub, op, outs=[run.own[sh.rank] for sh in row],
                               whole=whole)
            else:
                lo, hi = stripe
                for sh, t in zip(row, reduce_scatter(parts, lsub, op, whole=whole)):
                    with on_device(sh.dev):
                        run.own[sh.rank][:, lo:hi].copy_(t)

    def _chunk_counts(self, hits, budget: int):
        """Every shard's tile chunks encoded (M2): the encodings by (rank,
        chunk) and the col-axis union bound's maximum over the mesh (one
        stacked read)."""
        lsub, lanes = self.part.lsub, self._lanes()
        enc = {}
        for sh in self.shards:
            with on_device(sh.dev):
                for c in range(self.cols):
                    chunk = hits[sh.rank][c * lsub : (c + 1) * lsub]
                    enc[sh.rank, c] = wire_encode(chunk, budget, lanes, self._encoder(sh, chunk))
        counts = np.concatenate(list(stacked_read_ragged(
            [enc[sh.rank, c].count for sh in self.shards for c in range(self.cols)])))
        per = counts.reshape(self.rows, self.cols, self.cols)  # (i, j, chunk)
        return enc, int(per.sum(axis=1).max())

    def _col_sparse(self, run: _Run, enc, w: int, commit=None) -> None:
        """The sparse col leg, the C peers' chunk pairs decoded in one launch
        (H1's segmented form) on each destination: under OR straight into
        its zeroed own plane (OR onto zeros is the merge); committed by MAX
        (``commit(sh)``) into the C slices of one zeroed buffer, then M1's
        max and commit over them."""
        lsub, seg = self.part.lsub, self.part.lsub * w
        for sh in self.shards:
            with on_device(sh.dev):
                peers = [enc[sh.i * self.cols + j, sh.j] for j in range(self.cols)]
                pairs = [(to_device(e.idx, sh.dev), to_device(e.words, sh.dev)) for e in peers]
                if commit is None:
                    own = run.own[sh.rank]
                    own.zero_()
                    wire_decode_segments([(i, x, 0) for i, x in pairs], own, seg)
                    continue
                key = ("col", sh.rank, w)
                if key not in run.blocks:
                    run.blocks[key] = torch.empty((self.cols, lsub, w), dtype=torch.int32,
                                                  device=sh.dev)
                bufs = run.blocks[key]
                bufs.zero_()
                wire_decode_segments([(i, x, j * seg) for j, (i, x) in enumerate(pairs)],
                                     bufs, seg)
                chunk_merge(list(bufs), op="max", commit=commit(sh))

    def _status(self, run: _Run, extra=()):
        """One stacked host read: (updated, level) of the mesh, then the
        ``extra`` 1-element tensors."""
        parts = [run.carries[0].ctrl[:2].to(torch.int64)] + [
            t.reshape(-1).to(torch.int64) for t in extra]
        return np.concatenate(list(stacked_read_ragged(parts)))

    def _active_rows(self, run: _Run) -> List[torch.Tensor]:
        """Each shard's own frontier rows with a nonzero word (int64)."""
        out = []
        for c in run.carries:
            out.append((c.frontier != 0).any(dim=1).sum(dtype=torch.int64).view(1))
        return out

    def _sync_step(self, run: _Run, check: bool):
        """One level of every shard: None when it may not run (read only
        when ``check`` or a route decision needs it), else (whole-mesh
        bytes, sparse flag, matmul units) of the branch taken."""
        kpad = run.k_lanes
        dense, row_sparse, col_sparse, col_dense = self._ledger(kpad)
        budget = self._budget(kpad)
        sparse_on = budget > 0 and self.w > 1
        w = run.carries[0].frontier.shape[1]
        enc = []
        extra = []
        if sparse_on:
            for sh, c in zip(self.shards, run.carries):
                with on_device(sh.dev):
                    enc.append(wire_encode(c.frontier, budget, self._lanes(),
                                           self._encoder(sh, c.frontier)))
            extra += [e.count for e in enc]
        if self._mxu is not None:
            extra += self._active_rows(run)
        if check or extra:
            st = self._status(run, extra)
            if not st[0] or st[1] >= self._max_levels:
                return None
        mm = False
        units = 0
        if self._mxu is not None:
            act = st[2 + (len(enc)):].reshape(self.rows, self.cols).sum(axis=0)
            mm = int(act.max()) > self._mxu[2]
            units = self._mxu[3] if mm else 0
        sparse_ok = sparse_on and int(st[2 : 2 + len(enc)].max()) <= budget
        if not sparse_ok:
            self._dense_sync(run, mm)
            nbytes, flag = dense, 0
        else:
            blocks = (self._gather_sparse(run, enc, w) if self.rows > 1
                      else {sh.j: {sh.dev: self._own_block(run, sh, w)} for sh in self.shards})
            for sh, c in zip(self.shards, run.carries):
                self._tile_pass(sh, blocks[sh.j][sh.dev], run.hits[sh.rank], c.ctrl,
                                run.k_lanes, mm)
            if self.cols == 1:
                nbytes, flag = row_sparse, 1
            else:
                cenc, bound = self._chunk_counts(run.hits, budget)
                col_ok = bound <= budget
                if col_ok:
                    self._col_sparse(run, cenc, w)
                else:
                    self._col_dense(run, run.hits, None, "or")
                nbytes = row_sparse + (col_sparse if col_ok else col_dense)
                flag = 1 if self.rows > 1 else int(col_ok)
        self._apply(run)
        return nbytes, flag, units

    def _apply(self, run: _Run) -> None:
        """Every shard's apply (K2) of its own hits, then the mesh's
        updated flag."""
        for sh, c in zip(self.shards, run.carries):
            with on_device(sh.dev):
                bit_level_apply(c, run.own[sh.rank], self._max_levels)
        self._combine(run)

    def _own_block(self, run: _Run, sh: _Shard, w: int) -> torch.Tensor:
        """R == 1: the col block is the shard's own frontier, padded."""
        block = self._block(run, sh.j, sh.dev, w)
        with on_device(sh.dev):
            block[: self.part.lsub].copy_(run.carries[sh.rank].frontier)
        return block

    def _account_mxu(self, units: int, lanes: int) -> None:
        if units:
            ntr, tile, _, nt_max = self._mxu
            p = self.w
            record_mxu_tiles(units * p * 2 * tile * tile * lanes, p * (ntr * ntr - nt_max),
                             p * ntr * ntr)

    def _run_sync(self, queries) -> _Run:
        """The chunked host loop: up to ``level_chunk`` levels between
        status reads, the per-level reads only where a route decision needs
        them, the chip-loss seam ``trip("dispatch")`` once a chunk, the
        ledgers from the branches taken."""
        run = self._init_sync(queries)
        kpad = queries.shape[0]
        per_level = (self._budget(kpad) > 0 and self.w > 1) or self._mxu is not None
        dense = self._ledger(kpad)[0]
        prev_level = 0
        while True:
            nbytes = 0
            if per_level:
                for _ in range(self.level_chunk):
                    res = self._sync_step(run, check=True)
                    if res is None:
                        break
                    nbytes += res[0]
                    self._account_mxu(res[2], kpad)
            else:
                peek = _ConvergencePeek(run.carries[0].ctrl, self._max_levels)
                for _ in range(self.level_chunk):
                    if peek.stopped():
                        break
                    self._sync_step(run, check=False)
            record_dispatch()
            trip("dispatch")
            updated, level = (int(x) for x in self._status(run))
            if not per_level:
                nbytes = (level - prev_level) * dense
            record_collective_bytes(nbytes)
            record_collective_rounds(max(0, level - prev_level))
            prev_level = level
            if not updated or level >= self._max_levels:
                break
        return run

    def _finish_sync(self, run: _Run):
        """Merged (f, levels, reached) per query lane: the own counters
        summed (F, reached) or max-reduced (levels) over the mesh."""
        stride = self._stride()
        out = []
        for name, reduce in (("f", psum), ("levels", pmax), ("reached", psum)):
            merged = reduce([getattr(c, name) for c in run.carries])[0]
            out.append(merged[::stride])
        return tuple(out)

    # ---- the streamed residency (synchronous) ----------------------------
    def _run_streamed(self, queries) -> _Run:
        """One status read a level before it runs (the chip-loss seam
        first), every level dense: the tiles stream through their devices
        behind the row gather."""
        run = self._init_sync(queries)
        dense = self._ledger(queries.shape[0])[0]
        record_dispatch()
        while True:
            trip("dispatch")
            updated, level = (int(x) for x in self._status(run))
            if not updated or level >= self._max_levels:
                break
            self._stream_level_once(run)
            record_dispatch()
            record_collective_rounds(1)  # one exchange per level
            record_collective_bytes(dense)
        return run

    def _stream_level_once(self, run: _Run) -> None:
        self._dense_sync(run, False)
        self._apply(run)

    # ---- the bounded-staleness async drive -------------------------------
    def _init_async(self, queries) -> _Run:
        """Every shard's (Lsub, Kpad) int32 neg plane (sources NEG_BASE),
        its changed mask, delta, flag and two local-wave blocks (zero but
        for the own segment's rows, which the commits write)."""
        run = _Run()
        lsub = self.part.lsub
        for sh in self.shards:
            with on_device(sh.dev):
                carry = batch_start(lsub, self._local(queries, sh), sh.dev,
                                    staging=self._staging)
                neg = neg_from_planes(carry.frontier).contiguous()
                kp = neg.shape[1]
                run.neg.append(neg)
                run.changed.append(neg > 0)
                run.delta.append(torch.zeros_like(run.changed[-1]))
                run.flags.append(torch.zeros(1, dtype=torch.int32, device=sh.dev))
                run.hits.append(torch.zeros((self._rows_in, kp), dtype=torch.int32,
                                            device=sh.dev))
                run.local.append([torch.zeros((self._rows_in, kp), dtype=torch.int32,
                                              device=sh.dev) for _ in range(2)])
        run.k_lanes = queries.shape[0]
        run.go = {dev: go_control(dev) for dev in self.mesh.distinct_devices()}
        return run

    def _send(self, run: _Run, sh: _Shard, wave: int) -> torch.Tensor:
        """The own segment's rows of the block local wave ``wave`` reads:
        where the commit before it writes its send."""
        lsub = self.part.lsub
        return run.local[sh.rank][wave % 2][sh.i * lsub : (sh.i + 1) * lsub]

    def _improved(self, run: _Run) -> bool:
        """Some shard's commit of the latest tag improved something (one
        stacked read)."""
        return bool((stacked_read(run.flags) == run.tag).any())

    def _max_pass(self, run: _Run, sh: _Shard, block, out, floor: int) -> None:
        """Shard ``sh``'s candidate maxima of one block (M4)."""
        lt = self.part.lt
        with on_device(sh.dev):
            if sh.stream is not None:
                sh.stream.forest_pass(block[:lt], out[:lt], run.go[sh.dev], floor=floor)
            else:
                forest_max_hits(block[:lt], sh.tile, out[:lt], floor, run.go[sh.dev],
                                self._scratch_of(sh, block.shape[1], "or"))

    def _exchange(self, run: _Run, floor: int):
        """One reconciling round: the changed entries shipped, max-folded
        through every tile, reduce-scattered by MAX and committed (M1)
        with the round's delta, the changed mask set to it, the flag and
        the first local wave's send.  Returns the whole-mesh bytes of the
        branch taken."""
        kp = run.neg[0].shape[1]
        dense, row_sparse, col_sparse, col_dense = self._ledger(kp, lanes=kp)
        budget = self._budget(kp)
        sends = []
        for sh, neg, ch in zip(self.shards, run.neg, run.changed):
            with on_device(sh.dev):
                sends.append(torch.where(ch, neg, torch.zeros_like(neg)))
        run.tag += 1

        def commit(sh):
            return Commit(run.neg[sh.rank], run.delta[sh.rank], run.changed[sh.rank],
                          run.flags[sh.rank], self._send(run, sh, 0), acc_set=True,
                          tag=run.tag)

        sparse_ok = False
        if budget > 0 and self.w > 1 and self.residency == "hbm":
            enc = []
            for sh, s in zip(self.shards, sends):
                with on_device(sh.dev):
                    enc.append(wire_encode(s, budget, scratch=self._encoder(sh, s)))
            counts = np.concatenate(list(stacked_read_ragged([e.count for e in enc])))
            sparse_ok = int(counts.max()) <= budget
        if not sparse_ok:
            stripes = self._stripes(kp) if self.residency == "hbm" else [(0, kp)]
            if len(stripes) == 1:
                blocks = self._gather_dense(run, sends)
                for sh in self.shards:
                    self._max_pass(run, sh, blocks[sh.j][sh.dev], run.hits[sh.rank], floor)
                self._col_dense(run, run.hits, None, "max", commit=commit)
            else:
                own = run.own = [torch.empty((self.part.lsub, kp), dtype=torch.int32,
                                             device=sh.dev) for sh in self.shards]
                for lo, hi in stripes:
                    parts = [s[:, lo:hi].contiguous() for s in sends]
                    blocks = self._gather_dense(run, parts, tag=f"s{lo}")
                    outs = [torch.zeros((self._rows_in, hi - lo), dtype=torch.int32,
                                        device=sh.dev) for sh in self.shards]
                    for sh, out in zip(self.shards, outs):
                        self._max_pass(run, sh, blocks[sh.j][sh.dev], out, floor)
                    self._col_dense(run, outs, (lo, hi), "max")
                for sh in self.shards:
                    with on_device(sh.dev):
                        chunk_merge([own[sh.rank]], op="max", commit=commit(sh))
            return dense
        blocks = (self._gather_sparse(run, enc, kp) if self.rows > 1 else
                  self._gather_dense(run, sends))
        for sh in self.shards:
            self._max_pass(run, sh, blocks[sh.j][sh.dev], run.hits[sh.rank], floor)
        if self.cols == 1:
            self._col_dense(run, run.hits, None, "max", commit=commit)
            return row_sparse
        cenc, bound = self._chunk_counts(run.hits, budget)
        col_ok = bound <= budget
        if col_ok:
            self._col_sparse(run, cenc, kp, commit=commit)
        else:
            self._col_dense(run, run.hits, None, "max", commit=commit)
        return row_sparse + (col_sparse if col_ok else col_dense)

    def _local_waves(self, run: _Run, floor: int) -> None:
        """Up to k - 1 collective-free waves: each shard's delta-masked own
        segment at its col-block offset (the send the commit before wrote),
        one max pass over its tile whose own destination rows are committed
        in the same launch (M4's commit form; on the streamed residency the
        pass, then M1 over one chunk) into the neg plane, the changed mask
        accumulating the waves' deltas and the next wave's send written;
        stops when no shard improved anything."""
        lsub, lt = self.part.lsub, self.part.lt
        for wave in range(self.async_levels - 1):
            run.tag += 1
            for sh, neg, delta, flag in zip(self.shards, run.neg, run.delta, run.flags):
                block = run.local[sh.rank][wave % 2]
                commit = Commit(neg, delta, run.changed[sh.rank], flag,
                                self._send(run, sh, wave + 1), tag=run.tag)
                with on_device(sh.dev):
                    if sh.stream is not None:
                        hits = run.hits[sh.rank]
                        sh.stream.forest_pass(block[:lt], hits[:lt], run.go[sh.dev],
                                              floor=floor)
                        chunk_merge([hits[sh.j * lsub : (sh.j + 1) * lsub]], op="max",
                                    commit=commit)
                    else:
                        forest_max_hits_commit(block[:lt], sh.tile, sh.j * lsub, commit, floor,
                                               run.go[sh.dev],
                                               self._scratch_of(sh, block.shape[1], "or"))
            if not self._improved(run):
                break

    def _run_async(self, queries) -> _Run:
        """The async host loop: each round one exchange (a status read of
        the merged flags after it) and its local waves; the chip-loss seam
        once a chunk of ``level_chunk`` rounds (once a round on the
        streamed residency, as the JAX package's streamed drive)."""
        run = self._init_async(queries)
        floor = cand_floor(self.max_levels)
        go = bool(stacked_read([c.any().to(torch.int32).view(1) for c in run.changed]).any())
        streamed = self.residency == "streamed"
        if streamed:
            record_dispatch()
        while go:
            nbytes = rounds = 0
            for _ in range(1 if streamed else self.level_chunk):
                if streamed:
                    trip("dispatch")
                nbytes += self._exchange(run, floor)
                rounds += 1
                go = self._improved(run)
                if not go:
                    break
                self._local_waves(run, floor)
            if not streamed:
                record_dispatch()
                trip("dispatch")
            record_collective_bytes(nbytes)
            record_collective_rounds(rounds)
        return run

    def _finish_async(self, run: _Run):
        """The quiesced neg planes folded into merged per-query (f, levels,
        reached): sources at distance 0, a reached query's levels its
        deepest distance + 1, an empty query 0."""
        fs, reached, maxd = [], [], []
        for sh, neg in zip(self.shards, run.neg):
            with on_device(sh.dev):
                mask = neg > 0
                dist = torch.where(mask, NEG_BASE - neg, torch.zeros_like(neg))
                reached.append(mask.sum(dim=0, dtype=torch.int32))
                fs.append(dist.sum(dim=0, dtype=torch.int64))
                maxd.append(torch.where(mask, dist, torch.full_like(dist, -1)).amax(dim=0))
        r = psum(reached)[0]
        f = psum(fs)[0]
        m = pmax(maxd)[0]
        levels = torch.where(r > 0, m + 1, torch.zeros_like(m)).to(torch.int32)
        return f, levels, r

    # ---- results -----------------------------------------------------------
    def _stats(self, queries):
        """Merged (f, levels, reached) per query lane and k."""
        q, k = self._prep(queries)
        if self.async_levels > 1:
            return (*self._finish_async(self._run_async(q)), k)
        if self.residency == "streamed":
            return (*self._finish_sync(self._run_streamed(q)), k)
        return (*self._finish_sync(self._run_sync(q)), k)

    def f_values(self, queries) -> torch.Tensor:
        f, _, _, k = self._stats(queries)
        return f[:k]

    def query_stats(self, queries):
        """Per-query (levels, reached, F)."""
        f, levels, reached, k = self._stats(queries)
        record_dispatch()
        return (
            levels[:k].cpu().numpy().astype(np.int32),
            reached[:k].cpu().numpy().astype(np.int32),
            f[:k].cpu().numpy(),
        )

    def level_stats(self, queries):
        """Per-level trace (MSBFS_STATS=2): the shared stepped loop over
        the SYNCHRONOUS level whatever ``async_levels`` (the async planes
        equal its, so the trace stays truthful)."""
        q, k = self._prep(queries)

        def step(run):
            if self.residency == "streamed":
                self._stream_level_once(run)
            else:
                self._sync_step(run, check=False)
            return run

        def running(run):
            updated, level = self._status(run)
            return bool(updated) and level < self._max_levels

        shape = np.asarray(queries).shape
        warmed = shape in self._level_warm_shapes
        out = stepped_level_stats(lambda: self._init_sync(q), step, self._finish_sync, k,
                                  self.max_levels, warmed, running)
        self._level_warm_shapes.add(shape)
        return out

    def wire_trace(self, queries):
        """Per-level wire ledger: one level a step, each labelled by the
        branch the density decision took, beside ``bytes_dense_model``
        (what the same run would have moved with the sparse wire off)."""
        if self.residency != "hbm":
            raise ValueError(
                "wire_trace drives the chunked hbm loop; streamed "
                "residency records dense bytes by construction"
            )
        q, k = self._prep(queries)
        run = self._init_sync(q)
        levels: List[dict] = []
        sparse = total = 0
        while True:
            res = self._sync_step(run, check=True)
            record_dispatch()
            if res is None:
                break
            nbytes, flag, _ = res
            levels.append({"level": len(levels) + 1,
                           "encoding": "sparse" if flag else "dense", "bytes": nbytes})
            sparse += flag
            total += nbytes
        return {
            "levels": levels,
            "sparse_levels": sparse,
            "bytes_measured": total,
            "bytes_dense_model": len(levels) * self.level_bytes(k),
        }

    # ---- live resharding --------------------------------------------------
    def without_ranks(self, failed_ranks) -> "Mesh2DEngine":
        """Rebuild the tiled graph on the surviving (R', C) submesh: every
        mesh row holding a failed rank (flat rank r sits at row r // C) is
        dropped and the tiles are re-cut from the host CSR; the resolved
        wire format, residency, plane, kernel and async depth carry over.
        Raises DeviceError when no full row survives."""
        from ..runtime.supervisor import DeviceError

        failed = {int(r) for r in failed_ranks}
        grid = self.mesh.devices.reshape(self.rows, self.cols)
        bad_rows = {r // self.cols for r in failed if 0 <= r < self.w}
        keep = [i for i in range(self.rows) if i not in bad_rows]
        if not keep:
            raise DeviceError(
                f"no surviving mesh rows (failed ranks {sorted(failed)})",
                failed_ranks=failed,
            )
        survivors = [d for i in keep for d in grid[i]]
        mesh = make_mesh2d(len(keep), self.cols, devices=survivors)
        return Mesh2DEngine(
            mesh,
            self._host_graph,
            max_levels=self.max_levels,
            widths=self._widths,
            min_bucket_rows=self._min_bucket_rows,
            level_chunk=self.level_chunk,
            merge_tree=self._merge_tree,
            residency=self.residency,
            wire_sparse=self._wire_spec,
            wire_chunks=self.wire_chunks,
            async_levels=self.async_levels,
            plane=self.plane,
            kernel=self.kernel,
            native=self.native,
        )

    # ---- lattice identity -------------------------------------------------
    @property
    def axes(self) -> dict:
        """The resolved lattice point: labels and describe strings derive
        from it."""
        return {
            "plane": self.plane,
            "residency": self.residency,
            "partition": "mesh2d",
            "kernel": self.kernel,
        }

    @property
    def label(self) -> str:
        return engine_label(self.axes, async_levels=self.async_levels)

    def describe(self) -> str:
        toks = ", ".join(sorted(axis_tokens(self.axes)))
        return (
            f"{self.label}: {self.rows}x{self.cols} mesh, "
            f"tree={self.tree}, {toks}"
        )
