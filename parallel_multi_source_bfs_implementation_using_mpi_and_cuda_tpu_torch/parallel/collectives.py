"""Collectives over the shards of one mesh axis.

Stands in for the ``lax.all_gather`` / ``psum`` / ``pmax`` calls that
``shard_map`` inserts in the JAX package's engines.  Each function takes
one tensor per shard (in axis order) and returns one result per shard, on
that shard's device.

Results are shared per device: shards of a logical mesh that sit on the
same device get the same result tensor, made once.  Between distinct
devices a part travels as a ``non_blocking`` peer copy issued on the
destination device's current stream (PyTorch orders the copy after the
source device's current stream); on each device the parts are then
concatenated or stacked into a new tensor, as on a mesh of distinct
cards.

:func:`reduce_scatter` is the 2D mesh's col-axis reduce-scatter: each
peer's chunk reaches its owner as one copy (none on a shared device), and
one launch of M1 ``chunk_merge`` folds the chunks there.

The analytic payload the JAX package records with
:func:`..utils.timing.record_collective_bytes` is recorded by the
engines, at the sites where the JAX engines record it, not here: the
counter is the JAX package's model of the wire, per dispatched chunk.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch


def on_device(device):
    """A context that makes ``device`` current for CUDA (a no-op on the
    CPU), so launches and events land on its current stream."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: itself when already there, else a peer copy on
    the destination's current stream."""
    device = torch.device(device)
    if t.device == device:
        return t
    with on_device(device):
        return t.to(device, non_blocking=True)


def _per_device(parts: Sequence[torch.Tensor], combine) -> List[torch.Tensor]:
    made = {}
    out = []
    for p in parts:
        dev = p.device
        if dev not in made:
            with on_device(dev):
                made[dev] = combine([to_device(q, dev) for q in parts])
        out.append(made[dev])
    return out


def all_gather(parts: Sequence[torch.Tensor], tiled: bool = True) -> List[torch.Tensor]:
    """Every shard's part, concatenated along dim 0 (``tiled``) or stacked
    on a new leading axis, on each shard's device."""

    def combine(local):
        return torch.cat(local) if tiled else torch.stack(local)

    return _per_device(parts, combine)


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise sum of every shard's part, on each shard's device."""
    return _per_device(parts, lambda local: torch.stack(local).sum(dim=0, dtype=local[0].dtype))


def pmax(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise max of every shard's part, on each shard's device."""
    return _per_device(parts, lambda local: torch.stack(local).amax(dim=0))


def reduce_scatter(
    parts: Sequence[torch.Tensor],
    lsub: int,
    op: str = "or",
    outs: Optional[Sequence[torch.Tensor]] = None,
    commits=None,
    whole: bool = False,
) -> List[torch.Tensor]:
    """The col-axis reduce-scatter of the JAX package's 2D mesh: shard c
    of the axis receives rows [c*lsub, (c+1)*lsub) of every shard's part
    (in axis order), folded by ``op`` ("or" or "max") by one launch of M1
    (:func:`..ops.cuda_mesh.chunk_merge`) into ``outs[c]`` (made when
    None), or committed into the neg plane ``commits[c]`` names (a
    :class:`..ops.cuda_mesh.Commit`).  Each chunk crosses to its owner's
    device as one copy; ``whole`` ships the whole (C * lsub, W) parts
    instead (the JAX package's one-shot tree).  Returns the outputs."""
    # Looked up at each call, so a wrapper set on the module (chip_smoke.py's
    # recording of M1) sees every launch.
    from ..ops.cuda_mesh import chunk_merge

    n = len(parts)
    results = []
    for c, dst in enumerate(parts):
        dev = dst.device
        with on_device(dev):
            chunks = []
            for p in parts:
                if whole:
                    p = to_device(p[: n * lsub], dev)
                chunks.append(to_device(p[c * lsub : (c + 1) * lsub], dev))
            commit = None if commits is None else commits[c]
            out = None
            if commit is None:
                out = outs[c] if outs is not None else torch.empty(
                    (lsub,) + tuple(dst.shape[1:]), dtype=dst.dtype, device=dev)
            chunk_merge(chunks, out=out, op=op, commit=commit)
        results.append(out)
    return results
