"""The BELL reduction forest (the JAX package's ops/bell.py): the plain
forest, the byte-flag pull and the pull-only byte-plane ``BellEngine``.

Per forest level and bucket (R_b, W_b):

    out_b[r] = OR over j < W_b of  V_prev[cols_b[r, j]]

where V_prev is the frontier (level 0) or the previous level's output,
with a zero sentinel row appended; then per vertex ``H = V_cat[final_slot]``
over the concatenation of all level outputs and a trailing zero row.
torch has no OR reduction, so :func:`forest_hits` folds the width axis of
(n, W) int32 word planes with a loop of ``|`` — the plain version of the
``forest_or`` kernel (:mod:`.cuda_bell`) — or, over 0/1 byte flags, with
``amax`` (the JAX package's ``bell_hits_packed``).

Byte planes.  A batch of K queries as 0/1 flags is an (n, Kp) uint8 plane,
Kp = 4 ceil(K/4), query q in byte q of a row.  Viewed without a copy as
an (n, Kp/4) int32 word plane (:func:`byte_words`), query q's flag is bit
8q, since host and card are little-endian, and over 0/1 bytes max is OR:
so the bit-plane kernels — the forest OR-fold, the push, the level apply —
run the byte planes unchanged at W = Kp/4, their per-lane counters giving
query q's at lane 8q.  :func:`bell_hits_packed` is that pull (the port of
the JAX function of that name, kept as the yardstick of the byte pull);
:func:`bell_hits_packed_plain` the same function over bytes with ``amax``.
The byte engines pull with their own kernel, which also masks the visited
lanes (:mod:`.cuda_flag_pull`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bfs import init_distances, validate_level_chunk
from .bitbell import (
    DIR_PULL,
    INT32_MAX,
    BitBellEngine,
    direction_go,
)
from .objective import f_of_u
from .packed import K_ALIGN

# Query q's flag is byte q of a row and bit 8q of the row's words only on a
# little-endian host and card.
if int(torch.tensor([1, 0, 0, 0], dtype=torch.uint8).view(torch.int32)) != 1:
    raise ImportError("byte planes need a little-endian host")

# Lanes between two queries' flags in the word view of a byte plane.
BYTE_LANES = 8


def _slot_segments(shapes, slot_budget: int):
    """Partition a level's bucket layout into contiguous segments of at
    most ``slot_budget`` slots: oversized buckets split at row boundaries
    (a row wider than the budget stays whole).  Returns [[(slot_offset,
    rows, width), ...], ...] in layout order."""
    pieces = []
    off = 0
    for r_b, w_b in shapes:
        if r_b == 0:
            continue
        rows_per = max(1, slot_budget // w_b)
        r0 = 0
        while r0 < r_b:
            rc = min(rows_per, r_b - r0)
            pieces.append((off + r0 * w_b, rc, w_b))
            r0 += rc
        off += r_b * w_b
    segments, cur, cur_slots = [], [], 0
    for p in pieces:
        s = p[1] * p[2]
        if cur and cur_slots + s > slot_budget:
            segments.append(cur)
            cur, cur_slots = [], 0
        cur.append(p)
        cur_slots += s
    if cur:
        segments.append(cur)
    return segments


def _or_rows(g: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """(rows * width, C) gathered words -> (rows, C): OR over each row's
    ``width`` consecutive entries."""
    g = g.view(rows, width, -1)
    out = g[:, 0].clone()
    for j in range(1, width):
        out |= g[:, j]
    return out


def _max_rows(g: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """(rows * width, C) gathered flags -> (rows, C): max over each row's
    ``width`` consecutive entries."""
    return g.view(rows, width, -1).amax(dim=1)


def segment_fold(v_prev: torch.Tensor, cols: torch.Tensor, pieces, reduce=_or_rows) -> torch.Tensor:
    """One gather segment of a forest level: the rows of ``v_prev`` (the
    previous level's values, its zero sentinel row appended) at the
    segment's ``cols``, each piece's ``(rows, width)`` slots folded by
    ``reduce`` -> (sum of rows, C).  The JAX package's ``_segment_fold``
    (ops/streamed.py), and the plain version of the segment kernel."""
    g = v_prev[cols.long()]
    parts, off = [], 0
    for rc, wb in pieces:
        parts.append(reduce(g[off : off + rc * wb], rc, wb))
        off += rc * wb
    return torch.cat(parts)


def forest_hits(
    frontier: torch.Tensor, graph, slot_budget: Optional[int] = None, reduce=_or_rows
) -> torch.Tensor:
    """(n, C) frontier words (zero = not in the frontier) -> (n, C)
    per-vertex hit words over a BellGraph; ``reduce(gathered, rows,
    width)`` folds each bucket's width axis (OR by default; ``_max_rows``
    for 0/1 flags).  ``slot_budget`` gathers a
    level whose slot count exceeds it in contiguous segments of at most
    that many slots, each reduced before the next is gathered (the JAX
    package's bound on the live gather intermediate); the result is the
    same either way."""
    c = frontier.shape[1]
    zero_row = frontier.new_zeros((1, c))
    v_prev = torch.cat([frontier, zero_row])  # sentinel row n
    outs = []
    for flat, shapes in zip(graph.level_cols, graph.level_shapes):
        if flat.shape[-1] == 0:
            out = frontier.new_zeros((0, c))
        elif slot_budget is None or flat.shape[-1] <= slot_budget:
            out = segment_fold(v_prev, flat, [(r, w) for r, w in shapes if r], reduce)
        else:
            parts = []
            for pieces in _slot_segments(shapes, slot_budget):
                a = pieces[0][0]
                b = pieces[-1][0] + pieces[-1][1] * pieces[-1][2]
                parts.append(
                    segment_fold(v_prev, flat[a:b], [(rc, wb) for _, rc, wb in pieces], reduce)
                )
            out = torch.cat(parts)
        outs.append(out)
        v_prev = torch.cat([out, zero_row])
    v_cat = torch.cat(outs + [zero_row])
    return v_cat[graph.final_slot.long()]


def byte_words(plane: torch.Tensor) -> torch.Tensor:
    """An (m, Kp) uint8 byte plane, Kp % 4 == 0, as its (m, Kp/4) int32
    word view (no copy: the same storage)."""
    if plane.dtype != torch.uint8 or plane.dim() != 2:
        raise TypeError(f"a byte plane must be 2-D uint8, got {plane.dtype}")
    if plane.shape[1] % 4 or not plane.is_contiguous():
        raise ValueError(
            f"a byte plane must be contiguous with a multiple of 4 bytes a row "
            f"(got {tuple(plane.shape)})"
        )
    return plane.view(torch.int32)


def bell_hits_packed_plain(
    frontier, graph, hits, ctrl, max_levels=INT32_MAX, scratch=None
) -> None:
    """:func:`bell_hits_packed` in torch, over the bytes: the forest with
    each bucket's width folded by ``amax`` (``scratch`` is not used)."""
    if not direction_go(ctrl, max_levels, DIR_PULL):
        return
    hits.copy_(forest_hits(frontier, graph, reduce=_max_rows))


def bell_hits_packed(
    frontier: torch.Tensor,
    graph,
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    max_levels: int = INT32_MAX,
    scratch: Optional[torch.Tensor] = None,
) -> None:
    """Kernel K5's pull (the JAX package's ``bell_hits_packed``): an (n,
    Kp) uint8 0/1 frontier -> every byte of the (n, Kp) ``hits``, the max
    of each vertex's dedup neighbours' flags.  Runs the forest OR-fold
    (``csrc/forest_or.cu``) on both planes' word views, gated on the
    device as it is; ``scratch`` is its level-output buffer at W = Kp/4."""
    from .cuda_bell import forest_or  # lazy: cuda_bell imports this module

    forest_or(byte_words(frontier), graph, byte_words(hits), ctrl, max_levels, None, scratch)


def bell_expand_packed(dist: torch.Tensor, level, graph) -> torch.Tensor:
    """One level for all K queries over (n, K) int32 distances: the (n, K)
    bool newly-reached mask (plain torch)."""
    frontier = (dist == level).to(torch.uint8)
    hits = forest_hits(frontier, graph, reduce=_max_rows)
    return (dist == -1) & (hits > 0)


def _distances_init(graph, queries) -> torch.Tensor:
    """(K, S) queries -> (n, K) int32 distances, 0 at in-range sources."""
    return init_distances(graph.n, np.atleast_2d(queries), device=graph.device).T.contiguous()


def bell_distances_chunked(
    graph, queries, level_chunk: Optional[int], max_levels: Optional[int] = None
) -> torch.Tensor:
    """(K, S) -1-padded queries -> (n, K) int32 distances, at most
    ``level_chunk`` levels between host reads of the convergence flag
    (None: one read a level).  Plain torch, for the tests."""
    validate_level_chunk(level_chunk)
    dist = _distances_init(graph, queries)
    level, updated = 0, bool((dist == 0).any())
    cap = INT32_MAX if max_levels is None else int(max_levels)
    while updated and level < cap:
        stop = cap if level_chunk is None else min(level + level_chunk, cap)
        while updated and level < stop:
            new = bell_expand_packed(dist, level, graph)
            dist = torch.where(new, level + 1, dist)
            level += 1
            updated = bool(new.any())
    return dist


def bell_distances(graph, queries, max_levels: Optional[int] = None) -> torch.Tensor:
    """(K, S) -1-padded queries -> (n, K) int32 distances (plain torch)."""
    return bell_distances_chunked(graph, queries, None, max_levels)


def bell_f_values(graph, queries, max_levels: Optional[int] = None) -> torch.Tensor:
    """(K, S) queries -> (K,) int64 F values (objective main.cu:75-89)."""
    return f_of_u(bell_distances(graph, queries, max_levels).T)


class BellEngine(BitBellEngine):
    """The pull-only byte-plane engine (the JAX package's BellEngine,
    ``MSBFS_BACKEND=bell``): K queries padded to ``k_align`` (8) as (n,
    Kp) 0/1 byte planes, every level the byte pull
    (:func:`.lowk.flag_pull_expand`, ``csrc/flag_pull.cu``) then the level
    apply over the word view.  JAX keeps (n, K) int32
    distances and derives F, levels and reached from them; here they are
    the apply's per-lane counters at lanes 8q, and no distance plane
    exists.  ``plain`` runs every kernel's plain torch version."""

    # Lattice axes (ops.engine.resolve_axes): word distances over the
    # forest, as the JAX package declares them.
    CAPABILITIES = frozenset({"plane:word", "residency:hbm", "partition:single", "kernel:xla"})

    lane_stride = BYTE_LANES
    # The JAX package's BellEngine has no stepped per-level trace.
    level_stats = None

    def __init__(
        self,
        graph,
        max_levels: Optional[int] = None,
        k_align: int = K_ALIGN,
        level_chunk: Optional[int] = None,
        plain: bool = False,
    ):
        super().__init__(
            graph, max_levels=max_levels, sparse_budget=0, level_chunk=level_chunk,
            slot_budget=0, plain=plain,
        )
        self.k_align = int(k_align)

    def _expand(self, w: int):
        from .lowk import flag_pull_expand  # lazy: lowk imports this module

        return flag_pull_expand(self.graph, self.plain)

    def _level_expand(self, carry, hits, scratch):
        from .lowk import byte_level_expand

        return byte_level_expand(self, carry, hits, scratch)

    def _new_scratch(self, w: int):
        from .cuda_flag_pull import flag_pull_scratch  # lazy: it imports this module

        return flag_pull_scratch(self.graph, w, self.device)
