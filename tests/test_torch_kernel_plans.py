"""The host functions that pick the sweep's and the apply's kernel variant
(``ops/cuda_stencil.py`` ``sweep_plan``, ``ops/bitbell.py`` ``apply_plan``).

They are pure functions of the shapes, so they run here on the CPU.  The
ring's schedule (tile walk, prefetch, slot arithmetic of
``csrc/stencil_sweep.cu``) is emulated in NumPy from a plan and held
against the plain sweep, so a plan whose ring would overwrite a row still
in use, or miss one, fails here before it reaches the card.
"""

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bitbell,
    cuda_stencil,
)

ROAD = (1, -1, 4095, -4095, 4096, -4096, 4097, -4097)


def _ring_emulation(frontier, mask, offsets, plan, blocks):
    """The ring kernel's walk in NumPy: each block's tiles, the ring of
    plan.ring_rows rows, the schedule of csrc/stencil_sweep.cu (the rows
    of each tile RING_STAGES - 1 tiles ahead of the sweep, zero outside
    the plane) and its slot arithmetic.  The row each slot holds is
    tracked, so a read of a slot overwritten or never filled fails."""
    rows, w = frontier.shape
    out = np.zeros_like(frontier)
    active = [(d, k) for k, d in enumerate(offsets) if abs(d) < rows]
    r, tile = plan.ring_rows, plan.tile
    ahead = cuda_stencil.RING_STAGES - 1
    tiles = -(-rows // tile)
    grid = max(1, min(blocks, tiles))
    for b in range(grid):
        tb, te = b * tiles // grid, (b + 1) * tiles // grid
        if tb >= te:
            continue
        r0, r1 = tb * tile, min(te * tile, rows)
        org = r0 - plan.halo_lo
        ring_row = np.full(r, -(10**9), dtype=np.int64)  # row each slot holds
        ring_f = np.zeros((r, w), dtype=frontier.dtype)
        ring_m = np.zeros(r, dtype=mask.dtype)
        loaded = [org]

        def fill_to(want):
            for row in range(loaded[0], want):
                s = (row - org) % r
                ring_row[s] = row
                inside = 0 <= row < rows
                ring_f[s] = frontier[row] if inside else 0
                ring_m[s] = mask[row] if inside else 0
            loaded[0] = max(loaded[0], want)

        def span_end(t0):
            return min(t0 + tile, r1) + plan.halo_hi

        for i in range(ahead):  # the prologue
            fill_to(span_end(r0 + i * tile))
        tslot = plan.halo_lo
        for t0 in range(r0, r1, tile):
            t1 = min(t0 + tile, r1)
            fill_to(span_end(t0 + ahead * tile))
            for j in range(t1 - t0):
                acc = np.zeros(w, dtype=frontier.dtype)
                # The kernel's byte slots: the row's slot lifted into
                # [4 halo_lo, 4 (r + halo_lo)), then one unsigned min a source.
                rb = 4 * r
                tj = _umin(4 * (tslot + j), 4 * (tslot + j) - rb)
                tj += rb if tj < 4 * plan.halo_lo else 0
                for d, k in active:
                    sb = _umin(tj - 4 * d, tj - 4 * d - rb)
                    assert 0 <= sb < rb and sb % 4 == 0
                    s = sb // 4
                    assert ring_row[s] == t0 + j - d, (b, t0, j, d)
                    if (int(ring_m[s]) >> k) & 1:
                        acc |= ring_f[s]
                out[t0 + j] = acc
            tslot = (tslot + tile) % r
    return out


def _umin(a, b):
    """min of two ints read as uint32 (a negative one is huge)."""
    return min(a % 2**32, b % 2**32)


def _plain(frontier, mask, offsets):
    hits = torch.empty_like(frontier)
    cuda_stencil.stencil_sweep_plain(
        frontier, mask, offsets, hits,
        torch.tensor([1, 0, 0, 0], dtype=torch.int32), 10,
    )
    return hits


def _inputs(rows, w, seed):
    rng = np.random.default_rng(seed)
    frontier = rng.integers(-(2**31), 2**31, size=(rows, w), dtype=np.int64).astype(np.int32)
    frontier[rng.random(rows) < 0.5] = 0
    mask = rng.integers(-(2**31), 2**31, size=rows, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(frontier), torch.from_numpy(mask)


@pytest.mark.parametrize(
    "rows,w,offsets,blocks",
    [
        (1000, 1, (1, -1, 40, -40, 41, -39), 3),
        (999, 3, (7, -7, 300, -301), 2),  # rows not a multiple of the tile
        (100, 2, (1, -1, 150, -150, 90), 4),  # rows < max|d|
        (5000, 1, (1, -1, 71, -72, 4999, -5001), 5),
        (3000, 8, (1, -1, 71, -72, 900, -1000), 5),
        (64, 1, (-3,), 1),  # one-sided offsets
    ],
)
def test_ring_schedule_matches_plain(monkeypatch, rows, w, offsets, blocks):
    # Small tiles so each block walks several, wrapping its ring.
    monkeypatch.setattr(cuda_stencil, "RING_MAX_TILE", 64)
    monkeypatch.setattr(cuda_stencil, "RING_MIN_TILE", 32)
    plan = cuda_stencil.sweep_plan(rows, w, offsets)
    assert plan.variant == "ring" and plan.tile <= 64
    frontier, mask = _inputs(rows, w, rows + w)
    got = _ring_emulation(frontier.numpy(), mask.numpy(), list(offsets), plan, blocks)
    np.testing.assert_array_equal(got, _plain(frontier, mask, list(offsets)).numpy())


def test_road_4096_plans():
    n = 4096 * 4096
    one = cuda_stencil.sweep_plan(n, 1, ROAD)
    assert one.variant == "ring" and one.w_instance == 1 and one.vec16
    assert (one.halo_lo, one.halo_hi) == (4100, 4100)
    assert one.tile == 4960 and one.ring_rows == 4 * 4960 + 8200
    assert one.smem_bytes == one.ring_rows * 8 <= cuda_stencil.RING_SMEM_BYTES
    # K = 256 (W = 8): the halo alone outgrows the ring's memory.
    assert cuda_stencil.sweep_plan(n, 8, ROAD).variant == "l2"
    # road-1024 at W = 8 still fits a ring.
    wide = cuda_stencil.sweep_plan(1 << 20, 8, (1, -1, 1023, -1023, 1024, -1024, 1025, -1025))
    assert wide.variant == "ring" and wide.w_instance == 8 and wide.tile >= 256


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("rows", [0, 1, 31, 33, 1000, 4097, 70000, 1 << 24])
@pytest.mark.parametrize("offsets", [ROAD, (1, -1), (-5000,), (2, 3, 9000)])
def test_sweep_plan_invariants(rows, w, offsets):
    plan = cuda_stencil.sweep_plan(rows, w, offsets)
    assert plan.w_instance == (w if w in (1, 2, 4, 8) else 0)
    active = [d for d in offsets if abs(d) < rows]
    if plan.variant == "l2":
        assert plan.tile == plan.ring_rows == plan.smem_bytes == 0
        # The smallest tile allowed would not fit beside the halo.
        lo = max([d for d in active if d > 0], default=0)
        hi = max([-d for d in active if d < 0], default=0)
        small = min(cuda_stencil.RING_MIN_TILE, -(-max(rows, 1) // 32) * 32)
        need = cuda_stencil.RING_STAGES * small + lo + hi
        assert need * 4 * (w + 1) > cuda_stencil.RING_SMEM_BYTES
        return
    assert plan.variant == "ring"
    assert plan.tile % 32 == 0 and 32 <= plan.tile <= cuda_stencil.RING_MAX_TILE
    assert plan.tile <= max(32, -(-rows // 32) * 32)
    assert plan.halo_lo % 4 == 0 and plan.halo_hi % 4 == 0
    assert all(d <= plan.halo_lo and -d <= plan.halo_hi for d in active)
    assert plan.ring_rows == (
        cuda_stencil.RING_STAGES * plan.tile + plan.halo_lo + plan.halo_hi
    )
    assert plan.ring_rows % 4 == 0
    assert plan.smem_bytes == plan.ring_rows * 4 * (w + 1) <= cuda_stencil.RING_SMEM_BYTES


def test_sweep_plan_is_pure_and_honours_alignment():
    a = cuda_stencil.sweep_plan(70000, 2, ROAD, vec16=False)
    assert a == cuda_stencil.sweep_plan(70000, 2, list(ROAD), vec16=False)
    assert not a.vec16 and cuda_stencil.sweep_plan(70000, 2, ROAD).vec16
    # Offsets past the plane reach no halo.
    assert cuda_stencil.sweep_plan(100, 1, (1, -1, 5000, -5000)).halo_lo == 4


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 7, 8, 9, 16, 1024])
@pytest.mark.parametrize("vec16", [True, False])
def test_apply_plan(w, vec16):
    plan = bitbell.apply_plan(w, vec16)
    if w in (1, 2, 4, 8):
        assert plan == bitbell.ApplyPlan("vector", w, vec16)
    else:
        assert plan == bitbell.ApplyPlan("column", 0, False)


def test_plan_labels_and_index_range():
    assert bitbell.plan_label(cuda_stencil.sweep_plan(1 << 24, 1, ROAD)) == "ring/W1/vec16"
    assert bitbell.plan_label(cuda_stencil.sweep_plan(1 << 24, 8, ROAD, False)) == "l2/W8/vec4"
    assert bitbell.plan_label(bitbell.apply_plan(3)) == "column/Wn/vec4"
    bitbell.check_index_range(2**28, 7)
    with pytest.raises(ValueError, match="2\\^31"):
        bitbell.check_index_range(2**28, 8)
