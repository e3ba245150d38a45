"""The stencil masked-shift sweep as a hand-written CUDA kernel.

Counterpart of the JAX package's ops/pallas_stencil.py (the Pallas kernel
chain entered through ``pallas_hits``): ``csrc/stencil_sweep.cu`` computes,
for each vertex v and word w of a (rows, W) plane,

    hits[v, w] = OR_i  frontier[v - d_i, w]  if bit i of mask_bits[v - d_i]

with zero fill past either end.  The TPU version's row-chunk halo chain
(a VMEM-size workaround) and its flat-plane layout for W == 1 have no
counterpart: the kernel works on (rows, W) planes for every W.

:func:`stencil_sweep` launches the kernel on CUDA tensors and runs
:func:`stencil_sweep_plain` on CPU tensors only.  The kernel has two
variants, chosen by :func:`sweep_plan` from the shapes alone: a
shared-memory ring walked by persistent blocks, or direct reads through
L2 where the ring does not fit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from ..runtime import kernels
from .bitbell import (
    KERNEL_WIDTHS,
    _check_device,
    _check_plane,
    check_index_range,
    level_go,
    plan_label,
)

MAX_KERNEL_OFFSETS = 32  # one mask bit per offset

# The ring's shared memory per block: one block per H100 SM (227 KB
# usable).  The ring holds RING_STAGES tiles beside the halos (the tile
# being swept and the loads of the next three).  Tiles are multiples of 32
# rows (so 16-byte copies line up), at most RING_MAX_TILE rows, and at
# least RING_MIN_TILE rows unless the plane is smaller: a ring that cannot
# hold its tiles beside its halo takes the l2 variant.
RING_SMEM_BYTES = 220 * 1024
RING_STAGES = 4  # csrc/stencil_sweep.cu kRingStages
RING_MAX_TILE = 8192
RING_MIN_TILE = 256


class SweepPlan(NamedTuple):
    """How the sweep kernel runs one launch (:func:`sweep_plan`)."""

    variant: str  # "ring" or "l2"
    w_instance: int  # 1, 2, 4 or 8, or 0 for the generic width
    vec16: bool  # 16-byte copies, loads and stores
    tile: int  # rows per ring tile (0 on l2)
    ring_rows: int  # RING_STAGES * tile + halo_lo + halo_hi (0 on l2)
    halo_lo: int  # rows below a tile its sources reach, rounded up to 4
    halo_hi: int  # rows above it, rounded up to 4
    smem_bytes: int  # the ring's dynamic shared memory


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def sweep_plan(
    rows: int, w: int, offsets: Sequence[int], vec16: bool = True
) -> SweepPlan:
    """The sweep's variant and tile for a (rows, w) plane: a pure function
    of the shapes (``vec16``: every base pointer is 16-byte aligned).
    Offsets with |d| >= rows never land inside the plane and reach no
    halo.  The ring holds RING_STAGES tiles and both halos, at 4 * (w + 1)
    bytes a row, within RING_SMEM_BYTES.  Cached: the wrapper asks once
    per launch."""
    return _sweep_plan(
        int(rows), int(w), tuple(int(d) for d in offsets), bool(vec16),
        RING_SMEM_BYTES, RING_MAX_TILE, RING_MIN_TILE,
    )


@functools.lru_cache(maxsize=1024)
def _sweep_plan(
    rows: int, w: int, offsets: Tuple[int, ...], vec16: bool,
    smem_bytes: int, max_tile: int, min_tile: int,
) -> SweepPlan:
    active = [d for d in offsets if abs(d) < rows]
    lo = _up(max([d for d in active if d > 0], default=0), 4)
    hi = _up(max([-d for d in active if d < 0], default=0), 4)
    w_instance = w if w in KERNEL_WIDTHS else 0
    row_bytes = 4 * (w + 1)
    fit = (smem_bytes // row_bytes - lo - hi) // RING_STAGES // 32 * 32
    want = min(max_tile, _up(max(rows, 1), 32))
    if fit < min(min_tile, want):
        return SweepPlan("l2", w_instance, vec16, 0, 0, 0, 0, 0)
    tile = min(fit, want)
    ring_rows = RING_STAGES * tile + lo + hi
    return SweepPlan("ring", w_instance, vec16, tile, ring_rows, lo, hi,
                     ring_rows * row_bytes)


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
    check_index_range(rows, w)
    ptrs = (frontier.data_ptr(), mask_bits.data_ptr(), hits.data_ptr())
    plan = sweep_plan(rows, w, offsets, (ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0)
    offs = (ctypes.c_int * MAX_KERNEL_OFFSETS)(*offsets)
    kernels.launch(
        "stencil_sweep", dev, *ptrs,
        rows, w, offs, len(offsets), ctrl.data_ptr(), int(max_levels),
        0 if plan.variant == "ring" else 1, plan.tile, plan.ring_rows,
        plan.halo_lo, plan.halo_hi, int(plan.vec16),
        variant=plan_label(plan),
    )
