"""The stencil masked-shift sweep, with the residual edges, as a
hand-written CUDA kernel.

Counterpart of the JAX package's ops/pallas_stencil.py (the Pallas kernel
chain entered through ``pallas_hits``) and of the residual half of its
ops/stencil.py ``stencil_hits`` (an XLA gather, segment_max and row
merge): ``csrc/stencil_sweep.cu`` computes, for each vertex v and word w
of a (rows, W) plane,

    hits[v, w] = OR_i  frontier[v - d_i, w]  if bit i of mask_bits[v - d_i]
               | OR over residual edges (u, v) of frontier[u, w]

with zero fill past either end.  The TPU version's row-chunk halo chain
(a VMEM-size workaround) and its flat-plane layout for W == 1 have no
counterpart: the kernel works on (rows, W) planes for every W.

:func:`stencil_sweep` launches the kernel on CUDA tensors and runs
:func:`stencil_sweep_plain` (the masked shifts, then
:func:`residual_or_plain`) on CPU tensors only.  The kernel has two
variants, chosen by :func:`sweep_plan` from the shapes alone: a
shared-memory ring walked by persistent blocks, or direct reads through
L2 where the ring does not fit.  The residual edges ride the same launch,
cut by the tile that owns their destination (:func:`residual_ranges`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..runtime import kernels
from .bitbell import (
    KERNEL_WIDTHS,
    _check_device,
    _check_plane,
    check_index_range,
    level_go,
    pack_byte_planes,
    plan_label,
    unpack_byte_planes,
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
# Rows per residual range-table entry under the l2 variant: one block's
# rows of one step (csrc/msbfs_common.cuh kThreads).
L2_TILE_ROWS = 256


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


class SweepResidual:
    """The residual edges of a plane of ``rows`` rows that the sweep ORs
    in: ``src`` (R,) int32 source rows, ``seg`` (R,) sorted segment ids
    into ``dst_unique`` (U,) int32 (the JAX package's compact form, which
    the plain version reads), and ``dst`` = dst_unique[seg] (R,) int32,
    sorted, which the kernel reads.  Range tables are cached per tile
    size (:func:`residual_ranges`)."""

    def __init__(self, rows: int, src, seg, dst_unique):
        self.rows = int(rows)
        self.src, self.seg, self.dst_unique = src, seg, dst_unique
        self.dst = dst_unique[seg.long()].to(torch.int32).contiguous()
        self._ranges = {}

    @property
    def count(self) -> int:
        return int(self.src.shape[0])


def residual_tile(plan: SweepPlan) -> int:
    """Rows per residual range-table entry for a plan: the ring's tile
    (a block walks whole tiles), or one l2 block step of L2_TILE_ROWS."""
    return plan.tile if plan.variant == "ring" else L2_TILE_ROWS


def residual_ranges(residual: SweepResidual, tile: int) -> torch.Tensor:
    """(tiles + 1,) int32 on the residual's device: the edges whose
    destination lies in rows [t * tile, (t + 1) * tile) are
    [ranges[t], ranges[t + 1]) (``dst`` is sorted).  Built once per tile
    size and cached."""
    tile = int(tile)
    if tile not in residual._ranges:
        tiles = -(-residual.rows // tile)
        starts = torch.arange(tiles + 1, dtype=torch.int64, device=residual.dst.device) * tile
        residual._ranges[tile] = torch.searchsorted(
            residual.dst.long(), starts
        ).to(torch.int32)
    return residual._ranges[tile]


def residual_or_plain(
    frontier, res_src, res_seg, res_dst_unique, hits, ctrl, max_levels
) -> None:
    """The residual half of the sweep in torch: gather, byte unpack,
    segment OR (a sum of 0/1 bytes is > 0 exactly when their OR is 1),
    pack, one row merge."""
    if not level_go(ctrl, max_levels):
        return
    src_bytes = unpack_byte_planes(frontier[res_src.long()])  # (R, K) 0/1
    u = res_dst_unique.long()
    seg = torch.zeros(
        (u.shape[0], src_bytes.shape[1]), dtype=torch.int32, device=hits.device
    )
    seg.index_add_(0, res_seg.long(), src_bytes.to(torch.int32))
    hits[u] = hits[u] | pack_byte_planes((seg > 0).to(torch.uint8))


def stencil_sweep_plain(
    frontier: torch.Tensor,
    mask_bits: torch.Tensor,
    offsets: Sequence[int],
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    max_levels: int,
    residual: Optional[SweepResidual] = None,
) -> None:
    """The sweep kernel's function in torch: writes ``hits`` when the
    control lets the level run — the masked shifts, then
    :func:`residual_or_plain` over ``residual``'s edges."""
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
    if residual is not None and residual.count:
        residual_or_plain(
            frontier, residual.src, residual.seg, residual.dst_unique, hits,
            ctrl, max_levels,
        )


def stencil_sweep(
    frontier: torch.Tensor,
    mask_bits: torch.Tensor,
    offsets: Sequence[int],
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    max_levels: int,
    residual: Optional[SweepResidual] = None,
) -> None:
    """Kernel A: (rows, W) frontier -> (rows, W) hits by masked shifts,
    with ``residual``'s edges ORed in by the same launch (the residual
    addresses the whole plane: a window of rows takes none)."""
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
    if residual is not None and residual.count == 0:
        residual = None
    if residual is not None:
        if residual.rows != rows:
            raise ValueError(
                f"the residual addresses {residual.rows} rows, the plane has {rows}"
            )
        for name in ("src", "seg", "dst_unique", "dst"):
            _check_plane(f"residual.{name}", getattr(residual, name))
    dev = _check_device(frontier, mask_bits, hits, ctrl)
    if dev.type == "cpu":
        stencil_sweep_plain(
            frontier, mask_bits, offsets, hits, ctrl, max_levels, residual
        )
        return
    check_index_range(rows, w)
    ptrs = (frontier.data_ptr(), mask_bits.data_ptr(), hits.data_ptr())
    plan = sweep_plan(rows, w, offsets, (ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0)
    offs = (ctypes.c_int * MAX_KERNEL_OFFSETS)(*offsets)
    label = plan_label(plan)
    res = (None, None, None, 0, 0)
    if residual is not None:
        tile = residual_tile(plan)
        ranges = residual_ranges(residual, tile)
        _check_device(frontier, residual.src, residual.dst, ranges)
        res = (residual.src.data_ptr(), residual.dst.data_ptr(),
               ranges.data_ptr(), residual.count, tile)
        label += "/res"
    kernels.launch(
        "stencil_sweep", dev, *ptrs,
        rows, w, offs, len(offsets), ctrl.data_ptr(), int(max_levels),
        0 if plan.variant == "ring" else 1, plan.tile, plan.ring_rows,
        plan.halo_lo, plan.halo_hi, *res, int(plan.vec16),
        variant=label,
    )
