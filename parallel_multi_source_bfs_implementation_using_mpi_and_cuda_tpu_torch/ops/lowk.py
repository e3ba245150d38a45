"""The low-K branch of the main path: byte-flag BFS for a handful of
queries (the JAX package's ops/lowk.py).

JAX runs K <= 4 queries on an (n, K) uint8 0/1 flag matrix instead of a
bit plane padded to 32 queries.  The port keeps K unpadded too
(``k_align = 1``) as an (n, Kp) byte plane, Kp = 4 ceil(K/4), which is an
(n, Kp/4) word plane without a copy (:func:`.bell.byte_words`: query q's
flag is bit 8q).  One level is one expansion call, :func:`flag_expand`
(``csrc/flag_pull.cu``): its first launch reads the direction in ctrl[3]
on the device and runs either the push (K5's push: the push's edge walk
over the switch's worklist, into the switch's hit plane) or the pre-pass
of the byte pull (JAX's pull with its ``where(visited, 0, hits)``,
skipping the rows of vertices every live query has reached and, through
a bitmap of the frontier, the sources not in it), whose later launches
are gated on the pull; then the level apply (``csrc/level_apply.cu``),
whose switch epilogue decides the next direction by JAX's predicate
(active rows <= budget and their edges <= budget) and whose per-lane
counters hold query q's at lane 8q.  What the word view gives up is JAX's
1 byte a vertex at K = 1 (4 here).

The batch starts at a stride of 8 lanes (:func:`.bitbell.batch_start`).
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
from .cuda_flag_pull import FlagPullCall, flag_pull, flag_pull_plain, flag_pull_scratch

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
    """The byte push as a launch of its own (the JAX package's
    ``sparse_hits_flags``): the flags of every row on ``switch``'s
    worklist ORed into its dedup neighbours' rows of the all-zero (n, Kp)
    byte plane ``hits``, by K3's push scatter-OR (``csrc/push_or.cu``) on
    both planes' word views, gated on the device as it is.  Exact for any
    frontier: JAX compacts at most ``budget`` active rows, which its
    predicate makes all of them.  The low-K level runs the same walk
    inside the byte pull's first launch instead (:func:`flag_expand`)."""
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


def flag_expand(carry, graph, hits: torch.Tensor, max_levels: int, scratch=None) -> None:
    """One low-K level's expansion in one call: K5's push (into the
    switch's plane) on a level ctrl[3] sends to the push, else the byte
    pull into ``hits`` (:func:`flag_pull_expand`).  On CUDA one
    :class:`.cuda_flag_pull.FlagPullCall` with the carry's switch, whose
    first launch runs the one the device's direction names; on CPU
    tensors the plain push then the plain pull.  A carry without a switch
    only pulls."""
    u8 = torch.uint8
    sw = carry.switch
    if carry.frontier.device.type == "cpu":
        if sw is not None:
            sparse_hits_flags(carry.frontier.view(u8), graph, sw.hits.view(u8), carry.ctrl,
                              sw, max_levels)
        flag_pull_expand(graph)(carry, hits, max_levels, scratch)
        return
    _bound_call(carry, graph, hits, max_levels, scratch)()


def _bound_call(carry, graph, hits, max_levels, scratch) -> FlagPullCall:
    u8 = torch.uint8
    return FlagPullCall(carry.frontier.view(u8), carry.visited.view(u8), graph, hits.view(u8),
                        carry.ctrl, carry.k, max_levels, scratch, carry.levels, carry.switch)


def byte_level_expand(engine, carry, hits: torch.Tensor, scratch):
    """A byte engine's level expansion for ``carry`` as ``expand(c)``
    (``engine._level_expand``; ``c`` must be ``carry``): on the card the
    expansion call is checked here, once, and each level launches it with
    no further checks (the push folded in when the carry has a switch);
    else ``engine._expand``'s function."""
    if engine.plain or engine.device.type != "cuda":
        expand = engine._expand(carry.frontier.shape[1])
        return lambda c: expand(c, hits, engine._max_levels, scratch)
    call = _bound_call(carry, engine.graph, hits, engine._max_levels, scratch)

    def bound(c) -> None:
        if c is not carry:
            raise ValueError("a byte engine's level runs the carry it was made for")
        call()

    return bound


def lowk_expand(graph, plain: bool = False):
    """The expansion of one low-K level, as ``expand(carry, hits,
    max_levels, scratch)`` filling the byte view of ``hits`` (or of the
    switch's plane on a push level) from the carry's frontier
    (:func:`flag_expand`, one call).  ``plain`` runs the plain versions:
    the push when the carry has a switch, then the pull, each running only
    in the direction ctrl[3] names."""
    if not plain:
        return lambda carry, hits, max_levels, scratch: flag_expand(
            carry, graph, hits, max_levels, scratch)
    pull = flag_pull_expand(graph, plain)

    def expand(carry, hits: torch.Tensor, max_levels: int, scratch) -> None:
        sw = carry.switch
        if sw is not None:
            sparse_hits_flags_plain(carry.frontier.view(torch.uint8), graph,
                                    sw.hits.view(torch.uint8), carry.ctrl, sw, max_levels)
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

    # Lattice axes (ops.engine.resolve_axes): the low-K byte-plane point.
    CAPABILITIES = frozenset({"plane:byte", "residency:hbm", "partition:single", "kernel:xla"})

    k_align = 1
    lane_stride = BYTE_LANES
    # The JAX package's low-K engine has no stepped per-level trace.
    level_stats = None

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

    def _level_expand(self, carry, hits, scratch):
        return byte_level_expand(self, carry, hits, scratch)

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
