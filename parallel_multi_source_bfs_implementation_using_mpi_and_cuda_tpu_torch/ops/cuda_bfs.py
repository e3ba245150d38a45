"""The ELL frontier expansion, with its consumer, as a hand-written CUDA kernel.

Counterpart of the JAX package's ops/pallas_bfs.py: ``_ell_hits_kernel``
(entered through ``ell_hits``) computes, per virtual row of an ELL slab,
``hits[r] = max_j frontier[cols[j, r]]``, and ``ell_expand`` merges the
virtual rows of each vertex with a sorted ``segment_max`` and masks the
result with ``dist == -1``.

:func:`ell_hits_plain` and :func:`ell_expand_plain` are those two
functions in torch, for any number of queries.  :func:`ell_level` runs one
gated level of the distance loop (:class:`.bfs.DistCarry`) for all K
queries: on CUDA tensors it launches ``csrc/ell_hits.cu`` (frontier
packing, gather, apply and the device-side level control), on CPU tensors
it runs :func:`ell_level_plain`, the same function in torch.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from .bfs import NOT_REACHED, DistCarry, apply_new
from .bitbell import WORD_BITS, _check_device, _check_plane

# Queries one launch takes: the pack kernel keeps one level per query in
# shared memory.
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


def ell_level(graph, carry: DistCarry) -> None:
    """Kernel K8 (``csrc/ell_hits.cu``): one level of the distance loop
    over an EllGraph for all K queries of ``carry``, gated on the device
    (a no-op once ``ctrl[0]`` is 0)."""
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
        ell_level_plain(graph, carry)
        return
    if not 1 <= k <= MAX_KERNEL_QUERIES:
        raise ValueError(f"K={k} queries: the ELL kernel takes 1..{MAX_KERNEL_QUERIES}")
    frontier = torch.empty((n, w), dtype=torch.int32, device=dev)
    hits = torch.empty((n, w), dtype=torch.int32, device=dev)
    kernels.launch(
        "ell_hits", dev,
        graph.cols.data_ptr(), graph.vrow_vertex.data_ptr(),
        carry.dist.data_ptr(), carry.level.data_ptr(), carry.updated.data_ptr(),
        carry.stop.data_ptr(), carry.found.data_ptr(), frontier.data_ptr(),
        hits.data_ptr(), n, r, graph.width, k, w, carry.ctrl.data_ptr(),
    )
