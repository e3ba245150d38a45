"""The CSR pull of the ``vmap`` and ``packed`` routes, as a hand-written
CUDA kernel (K9, ``csrc/csr_pull.cu``).

Counterpart of two XLA chains of the JAX package: ops/bfs.py
``frontier_expand`` (one query's (n,) distances) and ops/packed.py
``_packed_expand`` (the query-minor (n, K) matrix).  Both gather the
frontier flag of every directed slot and reduce it per owning row with a
sorted ``segment_max``: an (E,) intermediate a query, (E, K) for the
packed matrix, which the JAX package bounds with ``MSBFS_EDGE_CHUNKS``.

``ops/bfs.py`` ``frontier_expand`` and ``ops/packed.py`` ``_packed_expand``
are those two functions in torch, chunked form included, and
:func:`csr_pull_plain` is one gated level of the distance loop
(:class:`.bfs.DistCarry`) built from them.

:func:`csr_pull` runs the same level for all K queries on bit planes it
carries beside ``dist`` (:class:`CsrPlanes`: frontier, visited, hits, the
running-query mask and a union map of the frontier, a bit a vertex), so a
steady level never reads ``dist``.  The planes are rebuilt from ``dist``
(the pack) whenever someone else has written the carry
(``DistCarry.touch``).  A level walks the graph's virtual rows
(``DeviceCSR.vrows``: short rows whole, a thread each; long rows cut
into pieces of at most 256 slots, a warp each), then applies the hits.
On CUDA tensors it launches ``csrc/csr_pull.cu``, one launch a phase
(pack when stale, walk, apply), every one gated on ``ctrl[0]``; on CPU
tensors it runs :func:`csr_level_planes_plain`, the same phases in
torch.  It makes no per-slot intermediate, so ``edge_chunks`` bounds
nothing there.  One source serves both layouts through the distance
view's strides: the (K, n) rows of the ``vmap`` route and the (K, n)
view of the ``packed`` route's (n, K) matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..runtime import kernels
from .bfs import DistCarry, apply_new, frontier_expand, segment_max_
from .bitbell import WORD_BITS, pack_byte_planes, unpack_byte_planes
from .cuda_bfs import ell_pack_plain, planes_apply_plain

# Queries one query-minor launch takes (the pre-redesign kernel's shared
# per-query state; the row layout takes up to 65,535).
MAX_MINOR_QUERIES = 4096
MAX_ROW_QUERIES = 65535

# The level's launches, as bits of :func:`csr_pull`'s ``phases``.
PHASE_PACK, PHASE_WALK, PHASE_APPLY = 1, 2, 4
PHASE_NAMES = {PHASE_PACK: "pack", PHASE_WALK: "walk", PHASE_APPLY: "apply"}

# The walk holds the union map in shared memory, folded to a bit per
# 2^shift vertices, while WALK_BLOCKS_PER_SM blocks of it fit an SM (the
# walk launches as many blocks as fit the card); one SM's shared memory
# (228 KB) and the runtime's share of each block.
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024
WALK_BLOCKS_PER_SM = 2
MAX_MAP_SHIFT = 5


def query_minor(dist: torch.Tensor) -> bool:
    """Whether a (K, n) distance view walks queries fastest (the packed
    route's (n, K) matrix, transposed), rather than vertices."""
    return dist.shape[0] > 1 and dist.stride(1) != 1


def csr_pull_plain(graph, carry: DistCarry, edge_chunks: int = 1) -> None:
    """The kernel's function in torch: one gated level for every query
    that may run, the ``vmap`` route's expansion on a row view and the
    ``packed`` route's (chunked) on a query-minor one."""
    from .packed import _packed_expand  # lazy: packed imports this module

    if not int(carry.ctrl[0]):
        return
    if query_minor(carry.dist):
        new = _packed_expand(carry.dist.T, carry.level, graph, edge_chunks).T
    else:
        new = frontier_expand(carry.dist, carry.level, graph)
    apply_new(carry, new)


@dataclass
class CsrPlanes:
    """The CSR pull's state beside ``dist``, for either layout:
    ``frontier`` (bit q of row v: the previous level labelled v for query
    q), ``visited`` (``dist[q, v] != -1``) and ``hits`` (zero between
    levels), (n, W) int32 each; ``aux`` (2W,) int32, the running-query
    mask in words [0, W) and the level's found bits in [W, 2W), zero
    between levels; ``union`` (ceil(n / 32),) int32, bit v of the map set
    when row v of ``frontier`` is not zero.  ``valid``: the planes agree
    with the carry (host flag, cleared by ``DistCarry.touch``)."""

    frontier: torch.Tensor
    visited: torch.Tensor
    hits: torch.Tensor
    aux: torch.Tensor
    union: torch.Tensor
    valid: bool = False


def csr_planes(graph, carry: DistCarry) -> CsrPlanes:
    """The carry's planes, allocated (stale) at first use: once per carry,
    not per level."""
    k = carry.dist.shape[0]
    shape = (graph.n, -(-k // WORD_BITS))
    planes = carry.planes
    if (
        not isinstance(planes, CsrPlanes)
        or tuple(planes.frontier.shape) != shape
        or planes.frontier.device != carry.dist.device
    ):
        dev = carry.dist.device
        planes = carry.planes = CsrPlanes(
            *(torch.zeros(shape, dtype=torch.int32, device=dev) for _ in range(3)),
            torch.zeros(2 * shape[1], dtype=torch.int32, device=dev),
            torch.zeros(-(-graph.n // WORD_BITS), dtype=torch.int32, device=dev),
        )
    return planes


def union_map_plain(frontier: torch.Tensor) -> torch.Tensor:
    """(n, W) frontier words -> (ceil(n / 32),) int32 map: bit v % 32 of
    word v // 32 set when row v is not zero."""
    n = frontier.shape[0]
    lanes = torch.zeros(-(-n // WORD_BITS) * WORD_BITS, dtype=torch.uint8,
                        device=frontier.device)
    lanes[:n] = (frontier != 0).any(dim=1)
    return pack_byte_planes(lanes.view(-1, WORD_BITS)).view(-1)


def csr_pack_plain(carry: DistCarry, planes: CsrPlanes) -> None:
    """The pack launch's function in torch: the planes and the union map
    from ``dist`` and the per-query control (the one pass that reads
    ``dist``)."""
    ell_pack_plain(carry, planes)
    planes.union.copy_(union_map_plain(planes.frontier))


def csr_walk_plain(graph, planes: CsrPlanes) -> None:
    """The walk launch's function in torch: ``hits`` = the OR of the
    frontier rows of each vertex's neighbours, kept where the vertex is
    unreached by a running query (the walk reads no ``dist``)."""
    w = planes.frontier.shape[1]
    slots = unpack_byte_planes(planes.frontier[graph.col_indices.long()])
    reached = torch.zeros((graph.n, w * WORD_BITS), dtype=torch.uint8,
                          device=slots.device)
    segment_max_(reached, 0, graph.edge_src.long(), slots)
    planes.hits.copy_(pack_byte_planes(reached) & ~planes.visited & planes.aux[:w])


def csr_apply_plain(carry: DistCarry, planes: CsrPlanes) -> None:
    """The apply launch's function in torch: the hits folded into the
    planes, ``dist`` and the per-query control, and the next level's
    union map."""
    planes_apply_plain(carry, planes, planes.hits.clone())
    planes.union.copy_(union_map_plain(planes.frontier))


def csr_level_planes_plain(graph, carry: DistCarry, phases=None) -> None:
    """The kernel's function in torch, on carried planes: one gated level
    for every query that may run; the planes are rebuilt first when
    stale.  ``phases`` makes just those of the level's launches, as
    :func:`csr_pull`'s."""
    if not int(carry.ctrl[0]):
        return
    planes = csr_planes(graph, carry)
    if phases is None:
        phases = PHASE_WALK | PHASE_APPLY | (0 if planes.valid else PHASE_PACK)
    if phases & PHASE_PACK:
        csr_pack_plain(carry, planes)
    if phases & PHASE_WALK:
        csr_walk_plain(graph, planes)
    if phases & PHASE_APPLY:
        csr_apply_plain(carry, planes)
        planes.valid = True


def map_shift(n: int, w: int) -> Optional[int]:
    """log2 of the vertices a bit of the walk's shared union map covers
    for n vertices and (n, w) planes: a pure function of the shapes, the
    finest resolution (shift <= MAX_MAP_SHIFT) at which WALK_BLOCKS_PER_SM
    blocks fit an SM beside the w mask words; None: the walk reads the
    map from device memory."""
    words = -(-n // WORD_BITS)
    for shift in range(MAX_MAP_SHIFT + 1):
        smem = 4 * (w + -(-words >> shift))
        if WALK_BLOCKS_PER_SM * (smem + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES:
            return shift
    return None


def _check_dist(dist: torch.Tensor, n: int) -> None:
    if dist.dtype != torch.int32 or dist.dim() != 2 or dist.shape[1] != n:
        raise ValueError(f"dist must be (K, {n}) int32, got {tuple(dist.shape)} {dist.dtype}")
    k = dist.shape[0]
    sq, sv = dist.stride()
    if query_minor(dist):
        if sq != 1 or sv < k:
            raise ValueError(f"a query-minor dist view needs strides (1, >= K), got {(sq, sv)}")
        if k > MAX_MINOR_QUERIES:
            raise ValueError(f"K={k}: the query-minor pull takes at most {MAX_MINOR_QUERIES}")
    elif sv != 1 or (k > 1 and sq < n):
        raise ValueError(f"a row dist view needs strides (>= n, 1), got {(sq, sv)}")
    if k > MAX_ROW_QUERIES:
        raise ValueError(f"K={k}: the pull takes at most {MAX_ROW_QUERIES} queries")


def csr_pull(graph, carry: DistCarry, edge_chunks: int = 1, phases=None) -> None:
    """Kernel K9 (``csrc/csr_pull.cu``): one level of the distance loop
    over a DeviceCSR for every query of ``carry``, gated on the device (a
    no-op once ``ctrl[0]`` is 0), no host read.  ``carry.dist`` is a
    (K, n) view, rows (``vmap``) or query-minor (``packed``); the level
    keeps :class:`CsrPlanes` on the carry and is "stale" (the pack
    rebuilds them from ``dist`` first) after ``carry.touch()``, else
    "steady" (walk, apply: two launches).  A steady level's frontier is
    what the previous level labelled, which is ``dist == level`` on every
    state a BFS reaches.  ``edge_chunks`` reaches only the plain version.
    ``phases`` (for timing one launch at a time) makes just those of the
    level's launches: PHASE_PACK on a stale carry, then PHASE_WALK, then
    PHASE_APPLY."""
    n = graph.n
    k = carry.dist.shape[0]
    for name in ("col_indices", "vrows"):
        t = getattr(graph, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    if graph.vrows.dim() != 2 or graph.vrows.shape[1] != 3:
        raise ValueError(f"vrows must be (R, 3), got {tuple(graph.vrows.shape)}")
    if not 0 <= graph.num_short <= graph.vrows.shape[0]:
        raise ValueError(f"num_short={graph.num_short} outside [0, {graph.vrows.shape[0]}]")
    _check_dist(carry.dist, n)
    for name in ("level", "updated", "stop", "found"):
        t = getattr(carry, name)
        if t.dtype != torch.int32 or tuple(t.shape) != (k,) or not t.is_contiguous():
            raise ValueError(f"{name} must be ({k},) contiguous int32")
    tensors = (graph.vrows, graph.col_indices, carry.dist, carry.level,
               carry.updated, carry.stop, carry.found, carry.ctrl)
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("the graph and the carry are on different devices")
    if dev.type == "cpu":
        csr_level_planes_plain(graph, carry, phases)
        return
    planes = csr_planes(graph, carry)
    w = planes.frontier.shape[1]
    if phases is None:
        phases = PHASE_WALK | PHASE_APPLY | (0 if planes.valid else PHASE_PACK)
    shift = map_shift(n, w)
    sq, sv = carry.dist.stride()
    label = ("minor" if query_minor(carry.dist) else "rows") + (
        "/stale" if phases & PHASE_PACK else "/steady")
    for phase in (PHASE_PACK, PHASE_WALK, PHASE_APPLY):
        if not phases & phase:
            continue
        kernels.launch(
            "csr_pull", dev, phase,
            graph.vrows.data_ptr(), graph.vrows.shape[0], graph.num_short,
            graph.col_indices.data_ptr(), carry.dist.data_ptr(), n, k, sq, sv,
            carry.level.data_ptr(), carry.updated.data_ptr(), carry.stop.data_ptr(),
            planes.frontier.data_ptr(), planes.visited.data_ptr(), planes.hits.data_ptr(),
            planes.aux.data_ptr(), planes.union.data_ptr(), w,
            -1 if shift is None else shift, carry.ctrl.data_ptr(),
            variant=f"{label}/{PHASE_NAMES[phase]}",
        )
    if phases & PHASE_APPLY:
        planes.valid = True
