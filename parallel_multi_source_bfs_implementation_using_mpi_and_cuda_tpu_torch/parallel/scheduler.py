"""Query scheduling: the reference's static round-robin and the serving
batcher's packing step.

The port's copy of the NumPy helpers of the JAX package's
parallel/scheduler.py.  The reference assigns query k to rank
``k % world_size`` (main.cu:303-307); :func:`cyclic_grid` lays the (K, S)
padded query array out as a (W, J, S) grid whose slot [r, j] holds global
query ``r + j*W``, so row r holds exactly the reference's query set for
rank r, in the reference's order.  JAX's ``merge_local_f`` (the all-reduce
of per-shard F values) comes with multi-device runs; on one card
:func:`shard_queries` only places the grid on the device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def cyclic_assignment(k: int, w: int) -> List[List[int]]:
    """Global query ids owned by each of w shards (reference main.cu:303-307)."""
    return [list(range(r, k, w)) for r in range(w)]


def reassign(k: int, w: int, failed_ranks) -> List[List[int]]:
    """Degrade-to-survivors rescheduling: the cyclic assignment for ``w``
    shards with ``failed_ranks`` lost, their query ids redistributed
    cyclically over the survivors in ascending order.  Failed rows are
    empty.  Raises ValueError when no rank survives."""
    failed = {int(r) for r in failed_ranks if 0 <= int(r) < w}
    survivors = [r for r in range(w) if r not in failed]
    if not survivors:
        raise ValueError(f"no surviving ranks (w={w}, failed={sorted(failed)})")
    base = cyclic_assignment(k, w)
    out = [list(base[r]) if r in set(survivors) else [] for r in range(w)]
    orphans = sorted(g for r in failed for g in base[r])
    for i, gid in enumerate(orphans):
        out[survivors[i % len(survivors)]].append(gid)
    return out


def cyclic_grid(
    queries: np.ndarray, w: int, min_j_multiple: int = 1
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Lay out (K, S) -1-padded queries as a (W, J, S) cyclic grid.

    Returns (grid, gids, k_pad) where ``grid[r, j] = queries[r + j*w]``,
    ``gids[r, j] = r + j*w`` and rows past K are -1 padding.  J is rounded
    up to ``min_j_multiple``."""
    k, s = queries.shape
    j = max(1, -(-k // w))
    j = -(-j // min_j_multiple) * min_j_multiple
    k_pad = w * j
    padded = np.full((k_pad, s), -1, dtype=np.int32)
    padded[:k] = queries
    grid = padded.reshape(j, w, s).transpose(1, 0, 2)  # grid[r, j] = padded[r + j*w]
    gids = (np.arange(w)[:, None] + np.arange(j)[None, :] * w).astype(np.int32)
    return np.ascontiguousarray(grid), gids, k_pad


def shard_queries(
    queries: np.ndarray, w: int, query_chunk: Optional[int], device
) -> Tuple[torch.Tensor, int, int, int]:
    """Cyclic-grid a (K, S) query array and place it on ``device``.

    Returns (the (W, J, S) grid on the device, k, k_pad, chunk); the
    upload trips the ``device_put`` fault seam, as in the JAX package."""
    from ..utils.faults import trip

    k = queries.shape[0]
    chunk = query_chunk or max(1, -(-k // w))
    grid, _, k_pad = cyclic_grid(np.asarray(queries), w, min_j_multiple=chunk)
    trip("device_put")
    return torch.as_tensor(grid, device=device), k, k_pad, chunk


def pack_padded_requests(
    blocks: List[np.ndarray], k_exec: int, s_pad: int
) -> Tuple[np.ndarray, List[int]]:
    """Stack per-request (K_i, S_i) -1-padded query blocks into one
    (k_exec, s_pad) batch; returns (batch, offsets) with ``offsets`` of
    length len(blocks)+1, so request i owns rows [offsets[i], offsets[i+1]).

    The serving micro-batcher's packing step (serve/batcher.py): the -1
    fill rows past the last request are inert, like the reference's
    out-of-range source ids (main.cu:46-51).  Raises ValueError on a block
    wider than ``s_pad`` or more rows than ``k_exec``: a silent truncation
    would return wrong F values for the clipped queries."""
    offsets = [0]
    for b in blocks:
        if b.ndim != 2 or b.shape[1] > s_pad:
            raise ValueError(
                f"request block {b.shape} does not fit group width {s_pad}"
            )
        offsets.append(offsets[-1] + int(b.shape[0]))
    if offsets[-1] > k_exec:
        raise ValueError(
            f"{offsets[-1]} packed rows exceed the {k_exec}-row bucket"
        )
    batch = np.full((k_exec, s_pad), -1, dtype=np.int32)
    for b, lo in zip(blocks, offsets):
        batch[lo : lo + b.shape[0], : b.shape[1]] = b
    return batch, offsets
