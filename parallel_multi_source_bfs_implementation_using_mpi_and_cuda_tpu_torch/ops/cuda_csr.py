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
:func:`csr_pull` runs the same level as one launch on a CUDA carry: for
every unreached (query, vertex) pair of a running query it walks the
vertex's slots, stops at the first neighbour at the query's level and
writes ``level + 1`` in place; its last block advances the per-query
control.  It makes no per-slot intermediate, so ``edge_chunks`` bounds
nothing there.  One source serves both layouts through the distance
view's strides: the (K, n) rows of the ``vmap`` route and the (K, n)
view of the ``packed`` route's (n, K) matrix.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from .bfs import DistCarry, apply_new, frontier_expand

# Queries one query-minor launch takes: their levels and found flags sit in
# shared memory.
MAX_MINOR_QUERIES = 4096


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


def csr_pull(graph, carry: DistCarry, edge_chunks: int = 1) -> None:
    """Kernel K9 (``csrc/csr_pull.cu``): one level of the distance loop
    over a DeviceCSR for every query of ``carry``, gated on the device (a
    no-op once ``ctrl[0]`` is 0), no host read.  ``carry.dist`` is a
    (K, n) view: rows (``vmap``: a block's threads over one query's
    vertices) or query-minor (``packed``: a warp a vertex, its lanes over
    the queries).  ``edge_chunks`` reaches only the plain version."""
    n = graph.n
    k = carry.dist.shape[0]
    for name in ("row_offsets", "col_indices"):
        t = getattr(graph, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    if tuple(graph.row_offsets.shape) != (n + 1,):
        raise ValueError(f"row_offsets must be ({n + 1},)")
    _check_dist(carry.dist, n)
    for name in ("level", "updated", "stop", "found"):
        t = getattr(carry, name)
        if t.dtype != torch.int32 or tuple(t.shape) != (k,) or not t.is_contiguous():
            raise ValueError(f"{name} must be ({k},) contiguous int32")
    tensors = (graph.row_offsets, graph.col_indices, carry.dist, carry.level,
               carry.updated, carry.stop, carry.found, carry.ctrl)
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("the graph and the carry are on different devices")
    if dev.type == "cpu":
        csr_pull_plain(graph, carry, edge_chunks)
        return
    minor = query_minor(carry.dist)
    sq, sv = carry.dist.stride()
    kernels.launch(
        "csr_pull", dev,
        graph.row_offsets.data_ptr(), graph.col_indices.data_ptr(),
        carry.dist.data_ptr(), n, k, sq, sv,
        carry.level.data_ptr(), carry.updated.data_ptr(), carry.stop.data_ptr(),
        carry.found.data_ptr(), carry.ctrl.data_ptr(),
        variant="minor" if minor else "rows",
    )
