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

The analytic payload the JAX package records with
:func:`..utils.timing.record_collective_bytes` is recorded by the
engines, at the sites where the JAX engines record it, not here: the
counter is the JAX package's model of the wire, per dispatched chunk.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

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
