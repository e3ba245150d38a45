"""The mxu tile matmul, with its consumer, as a hand-written CUDA kernel.

Counterpart of the JAX package's ops/pallas_mxu.py (the Pallas tile
chain entered through ``pallas_tile_products``) together with its
consumer ops/mxu.py ``tile_matmul_hits``: ``csrc/tile_hits.cu`` computes
one level's hit planes from the nonzero adjacency tiles,

    hits[r*T + i] bit q = OR over tiles b of row tile r, over j, of
                          tiles[b][i][j] & bit q of frontier[tile_col[b]*T + j]

i.e. the per-tile products, the sorted segment-sum over ``tile_row``,
``> 0`` and the pack back to (n_pad, W) words in one kernel.  The TPU
chain's manual batching under a VMEM budget has no counterpart.  The
kernel has two variants, chosen by :func:`tile_plan` from the shapes
alone: ``pipe`` (a warp-specialised shared-memory ring per (row tile,
word group, part of the row tile's list)) and ``simple`` (one block per
(row tile, word)) where the ring cannot hold the shape.

:func:`tile_matmul_hits` launches the kernel on CUDA tensors and runs
:func:`tile_matmul_hits_plain` on CPU tensors only.  :func:`bmm_tile_hits`
is the same function in torch, ungated: in float32 it is the plain
version's body; in bfloat16 it is the counterpart of the JAX package's
XLA einsum route (``MSBFS_MXU_KERNEL`` unset), a library product.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..runtime import kernels
from .bitbell import (
    DIR_MATMUL,
    INT32_MAX,
    _check_device,
    _check_plane,
    direction_go,
    pack_byte_planes,
    unpack_byte_planes,
)

# Tile sides the kernel takes: whole k32 tensor-core steps, one 16-row
# block per warp of its 8 warps.
KERNEL_TILES = (32, 64, 96, 128)

# The pipe variant (csrc/tile_hits.cu).  A unit takes at most
# PIPE_MAX_WORDS words of a row tile; a ring stage holds one tile, in rows
# of PIPE_ROW_BYTES, beside the T x W frontier words of its column block;
# two unpacked operands and the barriers follow the ring.  Units of one or
# two words run two blocks per SM, wider ones one, so a block's share of the
# SM's 227 KB (less the 1 KB the system keeps per block) and its ring depth
# follow from the unit's width.  The card holds PIPE_SMS x that many blocks
# at once: a row tile's list is cut in two for as long as twice the units
# still run as one wave and a part keeps PIPE_MIN_TILES tiles on average.
PIPE_MAX_WORDS = 4
PIPE_ROW_BYTES = 128
PIPE_SM_SMEM_BYTES = 232448
PIPE_BLOCK_RESERVED_BYTES = 1024
PIPE_SM_STAGES = 8  # ring stages per SM, shared by its blocks
PIPE_BARRIER_BYTES = 128
PIPE_SMS = 132
PIPE_MAX_SPLIT = 16
PIPE_MIN_TILES = 8


class TilePlan(NamedTuple):
    """How the tile kernel runs one launch (:func:`tile_plan`)."""

    variant: str  # "pipe" or "simple"
    wg: int  # words of a unit at most (the kernel's template width; 0 on simple)
    groups: int  # word groups per row tile
    split: int  # parts each row tile's tile list is cut into
    stages: int  # ring stages per block
    smem_bytes: int  # dynamic shared memory per block
    zero: bool  # a gated zeroing launch precedes the kernel (split > 1)
    units: int  # blocks launched

    @property
    def label(self) -> str:
        """The plan as the variant tally names it."""
        if self.variant == "simple":
            return "simple"
        return f"pipe/wg{self.wg}/split{self.split}/stages{self.stages}"

    def unit(self, block: int, w: int):
        """(row tile, first word, words, part) of block ``block`` — the
        kernel's own decoding of blockIdx.x."""
        if self.variant == "simple":
            return block // w, block % w, 1, 0
        block, part = divmod(block, self.split)
        r, grp = divmod(block, self.groups)
        w0 = grp * w // self.groups
        return r, w0, (grp + 1) * w // self.groups - w0, part


def part_range(lo: int, hi: int, part: int, split: int):
    """Tiles [b0, b1) of part ``part`` of a row tile's list [lo, hi)."""
    n = hi - lo
    return lo + n * part // split, lo + n * (part + 1) // split


def tile_plan(ntr: int, nt: int, t: int, w: int, aligned: bool = True) -> TilePlan:
    """The tile kernel's variant for ntr row tiles, nt nonzero (t, t) tiles
    and planes of w words: a pure function of the shapes (``aligned``: the
    frontier plane starts on a 16-byte boundary).  Cached: the wrapper asks
    once per launch."""
    return _tile_plan(int(ntr), int(nt), int(t), int(w), bool(aligned))


@functools.lru_cache(maxsize=1024)
def _tile_plan(ntr: int, nt: int, t: int, w: int, aligned: bool) -> TilePlan:
    simple = TilePlan("simple", 0, w, 1, 2, 2 * t * (t + 16) + 8 * t + 32 * (t + 16),
                      False, ntr * w)
    if not aligned:
        return simple
    groups = -(-w // PIPE_MAX_WORDS)
    wg = -(-w // groups)
    per_sm = 2 if wg <= 2 else 1
    budget = PIPE_SM_SMEM_BYTES // per_sm - PIPE_BLOCK_RESERVED_BYTES
    stage = t * PIPE_ROW_BYTES + t * w * 4
    fixed = 2 * 32 * wg * PIPE_ROW_BYTES + PIPE_BARRIER_BYTES
    stages = min(PIPE_SM_STAGES // per_sm, (budget - fixed) // stage)
    if stages < 2:
        return simple
    split = 1
    while (
        ntr * groups * split * 2 <= PIPE_SMS * per_sm
        and split < PIPE_MAX_SPLIT
        and nt >= ntr * split * 2 * PIPE_MIN_TILES
    ):
        split *= 2
    return TilePlan("pipe", wg, groups, split, stages, stages * stage + fixed,
                    split > 1, ntr * groups * split)


def bmm_tile_hits(
    tiles: torch.Tensor,
    tile_row: torch.Tensor,
    tile_col: torch.Tensor,
    ntr: int,
    frontier: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(ntr*T, W) frontier planes -> new (ntr*T, W) hit planes: unpack to
    0/1 bytes, gather the source blocks by ``tile_col``, ``torch.bmm`` in
    ``dtype`` (exact in float32, and in bfloat16 every positive count
    stays positive), ``index_add_`` over ``tile_row``, ``> 0``, pack."""
    nt, t = tiles.shape[0], tiles.shape[1]
    if nt == 0:  # edgeless: nothing can be hit
        return torch.zeros_like(frontier)
    fr = unpack_byte_planes(frontier)
    k = fr.shape[1]
    rhs = fr.view(ntr, t, k)[tile_col.long()].to(dtype)
    lhs = tiles if tiles.dtype == dtype else tiles.to(dtype)
    products = torch.bmm(lhs, rhs)
    acc = torch.zeros((ntr, t, k), dtype=torch.float32, device=frontier.device)
    acc.index_add_(0, tile_row.long(), products.float())
    return pack_byte_planes((acc > 0).to(torch.uint8).view(ntr * t, k))


def tile_matmul_hits_plain(
    tiles, tile_row, tile_col, row_ptr, frontier, hits, ctrl,
    max_levels=INT32_MAX,
) -> None:
    """The tile kernel's function in torch: writes ``hits`` when the
    control lets the level run in the matmul direction."""
    if not direction_go(ctrl, max_levels, DIR_MATMUL):
        return
    ntr = row_ptr.shape[0] - 1
    hits.copy_(bmm_tile_hits(tiles, tile_row, tile_col, ntr, frontier))


def tile_matmul_hits(
    tiles: torch.Tensor,
    tile_row: torch.Tensor,
    tile_col: torch.Tensor,
    row_ptr: torch.Tensor,
    frontier: torch.Tensor,
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    max_levels: int = INT32_MAX,
) -> None:
    """Kernel K7 (``csrc/tile_hits.cu``): (nt, T, T) int8 0/1 tiles sorted
    by (row, col), their (nt,) ``tile_row``/``tile_col`` and the (ntr+1,)
    row pointer over ``tile_row`` -> every word of ``hits``.  Gated on the
    device: runs when the level may run and ctrl[3] is
    :data:`DIR_MATMUL`, else leaves ``hits`` untouched.  The kernel's
    variant is :func:`tile_plan`'s."""
    rows, w = frontier.shape
    if tiles.dtype != torch.int8 or tiles.dim() != 3 or not tiles.is_contiguous():
        raise ValueError("tiles must be a contiguous (nt, T, T) int8 tensor")
    nt, t = tiles.shape[0], tiles.shape[1]
    if tiles.shape[2] != t:
        raise ValueError(f"tiles must be square, got {tuple(tiles.shape)}")
    ntr = row_ptr.shape[0] - 1
    _check_plane("frontier", frontier, (ntr * t, w))
    _check_plane("hits", hits, (rows, w))
    _check_plane("tile_row", tile_row, (nt,))
    _check_plane("tile_col", tile_col, (nt,))
    _check_plane("row_ptr", row_ptr, (ntr + 1,))
    _check_plane("ctrl", ctrl, (4,))
    dev = _check_device(tiles, tile_row, tile_col, row_ptr, frontier, hits, ctrl)
    if dev.type == "cpu":
        tile_matmul_hits_plain(
            tiles, tile_row, tile_col, row_ptr, frontier, hits, ctrl, max_levels
        )
        return
    if t not in KERNEL_TILES:
        raise ValueError(
            f"the CUDA tile kernel takes T in {KERNEL_TILES}, got T={t} "
            "(MSBFS_MXU_TILE)"
        )
    if tiles.data_ptr() % 16:
        raise ValueError("tiles must be 16-byte aligned (cp.async)")
    plan = tile_plan(ntr, nt, t, w, frontier.data_ptr() % 16 == 0)
    kernels.launch(
        "tile_hits", dev,
        tiles.data_ptr(), row_ptr.data_ptr(), tile_col.data_ptr(),
        frontier.data_ptr(), hits.data_ptr(), ntr, t, w, ctrl.data_ptr(),
        int(max_levels), 0 if plan.variant == "pipe" else 1, plan.wg,
        plan.groups, plan.split, plan.stages,
        variant=plan.label,
    )
