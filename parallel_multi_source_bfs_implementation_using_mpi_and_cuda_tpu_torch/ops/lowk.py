"""The low-K branch of the main path: byte-flag BFS for a handful of
queries (the JAX package's ops/lowk.py).

JAX runs K <= 4 queries on an (n, K) uint8 0/1 flag matrix instead of a
bit plane padded to 32 queries.  The port keeps K unpadded too
(``k_align = 1``) as an (n, Kp) byte plane, Kp = 4 ceil(K/4), which is an
(n, Kp/4) word plane without a copy (:func:`.bell.byte_words`: query q's
flag is bit 8q).  One level is the push (``csrc/push_or.cu`` on the word
view, :func:`sparse_hits_flags`) and the byte pull
(``csrc/flag_pull.cu``, :func:`.cuda_flag_pull.flag_pull`: JAX's pull
with its ``where(visited, 0, hits)``, skipping the rows of vertices every
live query has reached and, through a bitmap of the frontier, the sources
not in it), each gated on the direction in ctrl[3], then the level apply
(``csrc/level_apply.cu``), whose switch epilogue decides the next
direction by JAX's predicate (active rows <= budget and their edges <=
budget) and whose per-lane counters hold query q's at lane 8q.  What the
word view gives up is JAX's 1 byte a vertex at K = 1 (4 here).

The sources are packed at a stride of 8 lanes (``csrc/pack_sources.cu``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .bell import BYTE_LANES, byte_words
from .bitbell import (
    DIR_PUSH,
    INT32_MAX,
    BitBellEngine,
    PushSwitch,
    direction_go,
    listed_edges,
    pack_queries,
    sparse_hits_or,
)
from .cuda_flag_pull import flag_pull, flag_pull_plain, flag_pull_scratch

# Routing cap of the CLI's auto route: at most this many queries take the
# byte planes (the JAX package's).
LOWK_MAX_K = 4


def lowk_pack(n: int, queries: np.ndarray, device) -> torch.Tensor:
    """(K, S) -1-padded host queries -> the (n, Kp) uint8 source flags
    (Kp = 4 ceil(K/4), at least 4; sources outside [0, n) dropped,
    main.cu:46-51): :func:`.bitbell.pack_queries` at a stride of 8 lanes."""
    return pack_queries(n, queries, device, BYTE_LANES)[0].view(torch.uint8)


def _lowk_counts(new: torch.Tensor) -> torch.Tensor:
    """(n, Kp) uint8 0/1 newly-reached flags -> (Kp,) int32 counts."""
    return new.sum(dim=0, dtype=torch.int32)


def sparse_hits_flags_plain(
    frontier, graph, hits, ctrl, switch: PushSwitch, max_levels=INT32_MAX
) -> None:
    """:func:`sparse_hits_flags` in torch, over the bytes: each listed
    row's flags max-scattered into its dedup neighbours (``index_reduce_``
    with ``amax``, which is OR on 0/1 bytes)."""
    if not direction_go(ctrl, max_levels, DIR_PUSH):
        return
    start, _, vals = graph.sparse
    owner, nbr = listed_edges(switch, start, vals)
    hits.index_reduce_(0, nbr, frontier[owner], "amax")


def sparse_hits_flags(
    frontier: torch.Tensor,
    graph,
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    switch: PushSwitch,
    max_levels: int = INT32_MAX,
) -> None:
    """Kernel K5's push (the JAX package's ``sparse_hits_flags``): the
    flags of every row on ``switch``'s worklist ORed into its dedup
    neighbours' rows of the all-zero (n, Kp) byte plane ``hits``.  Runs
    the push scatter-OR (``csrc/push_or.cu``) on both planes' word views,
    gated on the device as it is.  Exact for any frontier: JAX compacts at
    most ``budget`` active rows, which its predicate makes all of them."""
    start, _, vals = graph.sparse
    sparse_hits_or(
        byte_words(frontier), start, vals, byte_words(hits), ctrl, switch, max_levels
    )


def flag_pull_expand(graph, plain: bool = False):
    """The byte pull of one level, as ``expand(carry, hits, max_levels,
    scratch)``: the byte view of ``hits`` from the carry's frontier and
    visited planes (:func:`.cuda_flag_pull.flag_pull`, its scratch
    ``scratch``), gated on ctrl[3]; the carry's level counters tell it
    which queries still have a frontier.  ``plain`` runs the plain
    version."""
    pull = flag_pull_plain if plain else flag_pull
    u8 = torch.uint8

    def expand(carry, hits: torch.Tensor, max_levels: int, scratch) -> None:
        pull(carry.frontier.view(u8), carry.visited.view(u8), graph, hits.view(u8),
             carry.ctrl, carry.k, max_levels, scratch, carry.levels)

    return expand


def lowk_expand(graph, plain: bool = False):
    """The expansion of one low-K level, as ``expand(carry, hits,
    max_levels, scratch)`` filling the byte view of ``hits`` (or of the
    switch's plane on a push level) from the carry's frontier: the push
    when the carry has a switch, then the pull
    (:func:`flag_pull_expand`), each running only in the direction ctrl[3]
    names.  ``plain`` runs the plain versions."""
    push = sparse_hits_flags_plain if plain else sparse_hits_flags
    pull = flag_pull_expand(graph, plain)

    def expand(carry, hits: torch.Tensor, max_levels: int, scratch) -> None:
        sw = carry.switch
        if sw is not None:
            push(carry.frontier.view(torch.uint8), graph, sw.hits.view(torch.uint8),
                 carry.ctrl, sw, max_levels)
        pull(carry, hits, max_levels, scratch)

    return expand


class LowKEngine(BitBellEngine):
    """Byte-flag all-queries-at-once engine over a BellGraph with no query
    padding (``k_align = 1``): the K <= 4 branch of the main path.

    ``sparse_budget``: the push threshold in active rows and edges (None:
    auto :func:`.bitbell.default_sparse_budget` from the dedup CSR; 0:
    pure forest pulls).  ``level_chunk`` / ``megachunk``: levels between
    host syncs, as for the other bit-plane engines.  ``plain`` runs every
    kernel's plain torch version (the reference, on any device).  F,
    levels and reached are the carry's lanes 0, 8, ..., 8(K-1)."""

    k_align = 1
    lane_stride = BYTE_LANES

    def __init__(
        self,
        graph,
        max_levels: Optional[int] = None,
        sparse_budget: Optional[int] = None,
        level_chunk: Optional[int] = None,
        megachunk: Optional[int] = None,
        plain: bool = False,
    ):
        if sparse_budget and graph.sparse is None:
            raise ValueError(
                "sparse_budget > 0 needs the BellGraph's dedup CSR "
                "(BellGraph.from_host(..., keep_sparse=True))"
            )
        super().__init__(
            graph, max_levels=max_levels, sparse_budget=sparse_budget,
            level_chunk=level_chunk, slot_budget=0, megachunk=megachunk, plain=plain,
        )

    def _expand(self, w: int):
        return lowk_expand(self.graph, self.plain)

    def _new_scratch(self, w: int):
        return flag_pull_scratch(self.graph, w, self.device)


def lowk_run(
    graph, queries, max_levels: Optional[int] = None, budget: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(K, S) queries -> per-query (f, levels, reached) of the whole BFS
    (one :class:`LowKEngine` drive, run to convergence)."""
    eng = LowKEngine(graph, max_levels, sparse_budget=budget)
    padded, k = eng._pad_queries(queries)
    carry, _ = eng._drive(padded, k)
    return tuple(t[:: BYTE_LANES][:k] for t in (carry.f, carry.levels, carry.reached))
