"""The ELL frontier expansion, with its consumer, as a hand-written CUDA kernel.

Counterpart of the JAX package's ops/pallas_bfs.py: ``_ell_hits_kernel``
(entered through ``ell_hits``) computes, per virtual row of an ELL slab,
``hits[r] = max_j frontier[cols[j, r]]``, and ``ell_expand`` merges the
virtual rows of each vertex with a sorted ``segment_max`` and masks the
result with ``dist == -1``.

:func:`ell_hits_plain` and :func:`ell_expand_plain` are those two
functions in torch, for any number of queries, and :func:`ell_level_plain`
is one gated level of the distance loop (:class:`.bfs.DistCarry`) built
from them: it reads ``dist`` whole, every level.

:func:`ell_level` runs the same level for all K queries on bit planes it
carries beside ``dist`` (:class:`EllPlanes`: frontier, visited, hits, and
the running-query mask), so a steady level never reads ``dist``.  The
planes are rebuilt from ``dist`` (:func:`ell_pack_plain`) whenever someone
else has written the carry (``DistCarry.touch``); :func:`ell_steady_plain`
is the steady function in torch, planes in, planes and ``dist`` out.  On
CUDA tensors :func:`ell_level` launches ``csrc/ell_hits.cu`` (pack when
stale, gather, apply with the device-side level control); on CPU tensors
it runs :func:`ell_level_planes_plain`, the same two steps in torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..runtime import kernels
from .bfs import NOT_REACHED, DistCarry, apply_new, level_active
from .bitbell import (
    KERNEL_WIDTHS,
    WORD_BITS,
    _check_device,
    _check_plane,
    pack_byte_planes,
    unpack_byte_planes,
)

# Queries one launch takes: the kernels keep one level per query in shared
# memory.
MAX_KERNEL_QUERIES = 8192


def ell_hits_plain(frontier: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(..., n_vmem) int8 frontier flags, (width, R) cols -> (..., R) int8
    hit flags: the max over the width axis of the gathered flags."""
    return frontier[..., cols.long()].amax(dim=-2)


def ell_expand_plain(dist: torch.Tensor, level, graph) -> torch.Tensor:
    """Newly-reached mask of one level over an EllGraph: (n,) or (K, n)
    distances at ``level`` (a scalar or (K,)) -> bool of the same shape.
    The frontier carries a zero sentinel region from index n (the padding
    value of ``cols`` and ``vrow_vertex``), padded to a multiple of 128 as
    in the JAX package."""
    n = graph.n
    d = dist.reshape(-1, dist.shape[-1])
    k = d.shape[0]
    lvl = torch.as_tensor(level, device=d.device).reshape(-1, 1)
    pad_to = max(128, -(-(n + 1) // 128) * 128)
    frontier = torch.zeros((k, pad_to), dtype=torch.int8, device=d.device)
    frontier[:, :n] = (d[:, :n] == lvl).to(torch.int8)
    hits = ell_hits_plain(frontier, graph.cols)  # (K, R)
    reached = torch.zeros((k, n + 1), dtype=torch.int32, device=d.device)
    reached.index_add_(1, graph.vrow_vertex.long(), hits.to(torch.int32))
    new = (d[:, :n] == NOT_REACHED) & (reached[:, :n] > 0)
    return new.reshape(dist.shape)


def ell_level_plain(graph, carry: DistCarry) -> None:
    """The kernel's function in torch: one gated level for every query
    that may run (same in-place effect on the carry)."""
    if int(carry.ctrl[0]):
        apply_new(carry, ell_expand_plain(carry.dist, carry.level, graph))


@dataclass
class EllPlanes:
    """The ELL level's state beside ``dist``: ``frontier`` (bit q of row v:
    the previous level labelled v for query q), ``visited`` (``dist[q, v]
    != -1``) and ``hits`` (zero between levels), (n, W) int32 each; ``aux``
    (2W,) int32, the running-query mask in words [0, W) and the level's
    found bits in words [W, 2W), zero between levels.  ``valid``: the
    planes agree with the carry (host flag, cleared by
    ``DistCarry.touch``)."""

    frontier: torch.Tensor
    visited: torch.Tensor
    hits: torch.Tensor
    aux: torch.Tensor
    valid: bool = False


def ell_planes(graph, carry: DistCarry) -> EllPlanes:
    """The carry's planes, allocated (stale) at first use: once per carry,
    not per level."""
    k = carry.dist.shape[0]
    shape = (graph.n, -(-k // WORD_BITS))
    planes = carry.planes
    if (
        planes is None
        or tuple(planes.frontier.shape) != shape
        or planes.frontier.device != carry.dist.device
    ):
        dev = carry.dist.device
        planes = carry.planes = EllPlanes(
            *(torch.zeros(shape, dtype=torch.int32, device=dev) for _ in range(3)),
            torch.zeros(2 * shape[1], dtype=torch.int32, device=dev),
        )
    return planes


def _pack_flags(flags: torch.Tensor, w: int) -> torch.Tensor:
    """(K, m) bool per-query flags -> (m, w) int32 words, query 32j+b in
    bit b of word j; the bits past K are zero."""
    k, m = flags.shape
    lanes = torch.zeros((m, w * WORD_BITS), dtype=torch.uint8, device=flags.device)
    lanes[:, :k] = flags.T
    return pack_byte_planes(lanes)


def ell_pack_plain(carry: DistCarry, planes: EllPlanes) -> None:
    """The pack kernel's function in torch: the planes from ``dist`` and
    the per-query control (the one pass that reads ``dist``)."""
    w = planes.frontier.shape[1]
    active = level_active(carry)
    at_level = (carry.dist == carry.level[:, None]) & active[:, None]
    planes.frontier.copy_(_pack_flags(at_level, w))
    planes.visited.copy_(_pack_flags(carry.dist != NOT_REACHED, w))
    planes.hits.zero_()
    planes.aux[:w] = _pack_flags(active[:, None], w)[0]
    planes.aux[w:] = 0


def ell_steady_plain(graph, carry: DistCarry, planes: EllPlanes) -> None:
    """The steady level in torch, planes in, planes and ``dist`` out: the
    slab gather of whole frontier words, the per-vertex OR, then
    :func:`planes_apply_plain`.  Ungated (:func:`ell_level_planes_plain`
    reads the go flag)."""
    n = graph.n
    w = planes.frontier.shape[1]
    # Row n is the sentinel of cols and vrow_vertex: reads 0, is dropped.
    ext = torch.cat([planes.frontier, planes.frontier.new_zeros((1, w))])
    rows = torch.zeros((graph.num_vrows, w), dtype=torch.int32, device=ext.device)
    for j in range(graph.width):
        rows |= ext[graph.cols[j].long()]
    reached = torch.zeros((n + 1, w * WORD_BITS), dtype=torch.int32, device=ext.device)
    reached.index_add_(0, graph.vrow_vertex.long(), unpack_byte_planes(rows).to(torch.int32))
    planes_apply_plain(carry, planes, pack_byte_planes((reached[:n] > 0).to(torch.uint8)))


def planes_apply_plain(carry: DistCarry, planes, hits: torch.Tensor) -> None:
    """A level's apply on carried planes, in torch: new = hits & ~visited
    & running; visited |= new, frontier = new, the hit plane zeroed, the
    new labels written into ``dist`` (never read), and the advance of the
    per-query control and the running-query mask.  ``planes`` is any
    carry state with ``frontier``, ``visited``, ``hits`` and ``aux`` as in
    :class:`EllPlanes`."""
    k, n = carry.dist.shape
    w = planes.frontier.shape[1]
    new = hits & ~planes.visited & planes.aux[:w]
    planes.visited |= new
    planes.frontier.copy_(new)
    planes.hits.zero_()
    labelled = unpack_byte_planes(new)[:, :k].T.bool()  # (K, n)
    carry.dist[labelled] = (carry.level + 1)[:, None].expand(k, n)[labelled]
    active = level_active(carry)
    found = labelled.any(dim=1).to(torch.int32)
    carry.updated.copy_(torch.where(active, found, carry.updated))
    carry.level.add_(active.to(torch.int32))
    running = level_active(carry)
    planes.aux[:w] = _pack_flags(running[:, None], w)[0]
    carry.ctrl[:1].copy_(running.any().view(1))


def ell_level_planes_plain(graph, carry: DistCarry) -> None:
    """The kernel's function in torch, on carried planes: one gated level
    for every query that may run; the planes are rebuilt first when
    stale."""
    if not int(carry.ctrl[0]):
        return
    planes = ell_planes(graph, carry)
    if not planes.valid:
        ell_pack_plain(carry, planes)
    ell_steady_plain(graph, carry, planes)
    planes.valid = True


# The kernel's launches, as bits of :func:`ell_level`'s ``phases``.
PHASE_PACK, PHASE_GATHER, PHASE_APPLY = 1, 2, 4


def ell_level(graph, carry: DistCarry, phases=None) -> None:
    """Kernel K8 (``csrc/ell_hits.cu``): one level of the distance loop
    over an EllGraph for all K queries of ``carry``, gated on the device
    (a no-op once ``ctrl[0]`` is 0).  It keeps :class:`EllPlanes` on the
    carry: a level is "stale" (the planes are rebuilt from ``dist`` first)
    after ``carry.touch()``, else "steady".  A steady level's frontier is
    what the previous level labelled, which is ``dist == level`` on every
    state a BFS reaches (no label above a query's level before the level
    that writes it).  ``phases`` (CUDA only, for timing one launch at a
    time) makes just those of the level's launches: the caller runs
    PHASE_PACK on a stale carry, then PHASE_GATHER, then PHASE_APPLY."""
    n, r = graph.n, graph.num_vrows
    k = carry.dist.shape[0]
    w = -(-k // WORD_BITS)
    _check_plane("cols", graph.cols, (graph.width, r))
    _check_plane("vrow_vertex", graph.vrow_vertex, (r,))
    _check_plane("dist", carry.dist, (k, n))
    for name in ("level", "updated", "stop", "found"):
        _check_plane(name, getattr(carry, name), (k,))
    _check_plane("ctrl", carry.ctrl, (4,))
    dev = _check_device(
        graph.cols, graph.vrow_vertex, carry.dist, carry.level, carry.updated,
        carry.stop, carry.found, carry.ctrl,
    )
    if dev.type == "cpu":
        ell_level_planes_plain(graph, carry)
        return
    if not 1 <= k <= MAX_KERNEL_QUERIES:
        raise ValueError(f"K={k} queries: the ELL kernel takes 1..{MAX_KERNEL_QUERIES}")
    planes = ell_planes(graph, carry)
    if phases is None:
        phases = PHASE_GATHER | PHASE_APPLY | (0 if planes.valid else PHASE_PACK)
    kernels.launch(
        "ell_hits", dev,
        graph.cols.data_ptr(), graph.vrow_vertex.data_ptr(),
        carry.dist.data_ptr(), carry.level.data_ptr(), carry.updated.data_ptr(),
        carry.stop.data_ptr(), planes.frontier.data_ptr(),
        planes.visited.data_ptr(), planes.hits.data_ptr(), planes.aux.data_ptr(),
        n, r, graph.width, k, w, int(phases), carry.ctrl.data_ptr(),
        variant=("stale" if phases & PHASE_PACK else "steady")
        + (f"/W{w}" if w in KERNEL_WIDTHS else "/Wn"),
    )
    if phases & PHASE_APPLY:
        planes.valid = True
