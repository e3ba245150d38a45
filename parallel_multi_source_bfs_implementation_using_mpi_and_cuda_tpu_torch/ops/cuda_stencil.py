"""The stencil masked-shift sweep as a hand-written CUDA kernel.

Counterpart of the JAX package's ops/pallas_stencil.py (the Pallas kernel
chain entered through ``pallas_hits``): ``csrc/stencil_sweep.cu`` computes,
for each vertex v and word w of a (rows, W) plane,

    hits[v, w] = OR_i  frontier[v - d_i, w]  if bit i of mask_bits[v - d_i]

with zero fill past either end.  The TPU version's row-chunk halo chain
(a VMEM-size workaround) and its flat-plane layout for W == 1 have no
counterpart: the kernel streams (rows, W) planes for every W.

:func:`stencil_sweep` launches the kernel on CUDA tensors and runs
:func:`stencil_sweep_plain` on CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..runtime import kernels
from .bitbell import _check_device, _check_plane, level_go

MAX_KERNEL_OFFSETS = 32  # one mask bit per offset


def stencil_sweep_plain(
    frontier: torch.Tensor,
    mask_bits: torch.Tensor,
    offsets: Sequence[int],
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    max_levels: int,
) -> None:
    """The sweep kernel's function in torch: writes ``hits`` when the
    control lets the level run."""
    if not level_go(ctrl, max_levels):
        return
    rows = frontier.shape[0]
    hits.zero_()
    for i, d in enumerate(offsets):
        if abs(d) >= rows:
            continue  # every shifted row lands outside the plane
        take = ((mask_bits >> i) & 1).bool().unsqueeze(1)
        masked = torch.where(take, frontier, 0)
        if d > 0:
            hits[d:] |= masked[: rows - d]
        else:
            hits[: rows + d] |= masked[-d:]


def stencil_sweep(
    frontier: torch.Tensor,
    mask_bits: torch.Tensor,
    offsets: Sequence[int],
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    max_levels: int,
) -> None:
    """Kernel A: (rows, W) frontier -> (rows, W) hits by masked shifts."""
    rows, w = frontier.shape
    _check_plane("frontier", frontier)
    _check_plane("mask_bits", mask_bits, (rows,))
    _check_plane("hits", hits, (rows, w))
    _check_plane("ctrl", ctrl, (4,))
    offsets = [int(d) for d in offsets]
    if len(offsets) > MAX_KERNEL_OFFSETS or 0 in offsets:
        raise ValueError(
            f"offsets must be at most {MAX_KERNEL_OFFSETS} nonzero ints, "
            f"got {offsets}"
        )
    dev = _check_device(frontier, mask_bits, hits, ctrl)
    if dev.type == "cpu":
        stencil_sweep_plain(frontier, mask_bits, offsets, hits, ctrl, max_levels)
        return
    offs = (ctypes.c_int * MAX_KERNEL_OFFSETS)(*offsets)
    kernels.launch(
        "stencil_sweep", dev,
        frontier.data_ptr(), mask_bits.data_ptr(), hits.data_ptr(),
        rows, w, offs, len(offsets), ctrl.data_ptr(), int(max_levels),
    )
