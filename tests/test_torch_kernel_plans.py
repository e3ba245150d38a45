"""The host functions that pick the sweep's, the apply's, the tile
matmul's and the forest's kernel variant (``ops/cuda_stencil.py``
``sweep_plan``, ``ops/bitbell.py`` ``apply_plan``, ``ops/cuda_mxu.py``
``tile_plan``, ``ops/cuda_bell.py`` ``forest_plan``) and the tables they
walk (the sweep's residual ranges, the forest's warp runs).

They are pure functions of the shapes, so they run here on the CPU.  The
ring's schedule (tile walk, prefetch, slot arithmetic of
``csrc/stencil_sweep.cu``) is emulated in NumPy from a plan and held
against the plain sweep, so a plan whose ring would overwrite a row still
in use, or miss one, fails here before it reaches the card; so is the
order in which each block ORs in its residual edges.  The tile kernel's
unit decoding, its cut of a row tile's list and its swizzled
shared-memory rows, the forest kernel's run decoding and segmented
shuffles (over whole levels, and over the host-streamed engine's
segments with their own tables), and the push kernel's walk of its worklist's edge space are
emulated the same way.
"""

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    DEFAULT_WIDTHS,
    BellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bell,
    bitbell,
    cuda_bell,
    cuda_mxu,
    cuda_stencil,
    stencil,
    streamed,
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


TILE_SIDES = cuda_mxu.KERNEL_TILES
TILE_WORDS = (1, 2, 3, 4, 5, 8)


def _row_ptr(ntr, nt, seed):
    """A skewed cut of nt tiles over ntr row tiles, some of them empty."""
    rng = np.random.default_rng(seed)
    if nt == 0:
        return np.zeros(ntr + 1, dtype=np.int64)
    cuts = np.sort(rng.integers(0, nt + 1, size=ntr - 1))
    cuts[: ntr // 3] = cuts[0]  # a run of empty row tiles
    return np.concatenate([[0], np.sort(cuts), [nt]]).astype(np.int64)


@pytest.mark.parametrize("t", TILE_SIDES)
@pytest.mark.parametrize("w", TILE_WORDS)
def test_tile_plan_units_cover_every_word_and_tile_once(t, w):
    for ntr, nt in ((7, 0), (7, 40), (128, 128 * 128), (300, 900), (3, 2000)):
        plan = cuda_mxu.tile_plan(ntr, nt, t, w)
        assert plan.variant == "pipe" and 2 <= plan.stages <= 8
        assert plan.smem_bytes <= cuda_mxu.PIPE_SM_SMEM_BYTES == 232448
        assert 1 <= plan.wg <= cuda_mxu.PIPE_MAX_WORDS and plan.groups * plan.wg >= w
        # Two blocks of a narrow unit share an SM, with the system's 1 KB each.
        per_sm = 2 if plan.wg <= 2 else 1
        assert per_sm * (plan.smem_bytes + 1024) <= 232448
        assert plan.zero == (plan.split > 1)
        assert plan.units == ntr * plan.groups * plan.split
        row_ptr = _row_ptr(ntr, nt, ntr + t + w)
        words = np.zeros((ntr, w), dtype=np.int64)  # units that own (r, word)
        tiles = np.zeros((nt, w), dtype=np.int64)  # units that multiply (tile, word)
        for block in range(plan.units):
            r, w0, nw, part = plan.unit(block, w)
            assert 0 <= r < ntr and 1 <= nw <= plan.wg and w0 + nw <= w
            b0, b1 = cuda_mxu.part_range(row_ptr[r], row_ptr[r + 1], part, plan.split)
            assert row_ptr[r] <= b0 <= b1 <= row_ptr[r + 1]
            tiles[b0:b1, w0 : w0 + nw] += 1
            if part == 0:
                words[r, w0 : w0 + nw] += 1
        assert (words == 1).all() and (tiles == 1).all()


def test_tile_plan_is_pure_cached_and_from_shapes_only():
    args = (128, 128 * 128, 128, 2)
    a = cuda_mxu.tile_plan(*args)
    before = cuda_mxu._tile_plan.cache_info().hits
    assert cuda_mxu.tile_plan(*args) is a
    assert cuda_mxu._tile_plan.cache_info().hits == before + 1
    # RMAT-14 at K = 64: too few row tiles for the card, so the lists are cut
    # and the gated zeroing comes with the cut.
    assert (a.variant, a.wg, a.groups, a.stages) == ("pipe", 2, 1, 4)
    assert a.split == 2 and a.zero and a.units == 256 <= 2 * cuda_mxu.PIPE_SMS
    assert a.label == "pipe/wg2/split2/stages4"
    # Twice the units must still run as one wave of the card.
    assert cuda_mxu.tile_plan(70, 70 * 128, 128, 2).split == 2
    assert cuda_mxu.tile_plan(140, 140 * 128, 128, 2).split == 1
    # road-512 at K = 16: thousands of short lists, no cut, plain stores.
    road = cuda_mxu.tile_plan(2048, 8418, 128, 1)
    assert (road.variant, road.split, road.zero, road.units) == ("pipe", 1, False, 2048)
    # Short lists are never cut below PIPE_MIN_TILES tiles a part.
    assert cuda_mxu.tile_plan(16, 16 * 12, 128, 1).split == 1
    assert cuda_mxu.tile_plan(16, 16 * 16, 128, 1).split == 2
    # Wide word groups run one block per SM with a deeper ring.
    wide = cuda_mxu.tile_plan(128, 128 * 128, 128, 8)
    assert (wide.wg, wide.groups, wide.stages) == (4, 2, 8)


@pytest.mark.parametrize("t", TILE_SIDES)
def test_tile_plan_simple_where_the_ring_cannot_hold_the_shape(t):
    # A frontier plane off the 16-byte grid cannot feed 16-byte copies.
    off = cuda_mxu.tile_plan(64, 900, t, 2, aligned=False)
    assert off.variant == "simple" and off.label == "simple"
    assert (off.units, off.split, off.zero) == (64 * 2, 1, False)
    assert [off.unit(b, 2)[:2] for b in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # So many words that two stages of (tile + T x W words) outgrow a block.
    w = 232448 // (2 * 4 * t)
    assert cuda_mxu.tile_plan(64, 900, t, w).variant == "simple"
    assert cuda_mxu.tile_plan(64, 900, t, 16).variant == "pipe"


@pytest.mark.parametrize("t", TILE_SIDES)
def test_pipe_swizzle_is_a_conflict_free_bijection(t):
    """The shared-memory row layout of csrc/tile_hits.cu: chunk c of row i
    sits at chunk c ^ (i & 7) of a 128-byte row.  Every (row, chunk) keeps
    its own place, and the 32 lanes of an mma fragment load — rows g of one
    8-row group, bytes 4t of one chunk — fall on 32 distinct banks."""
    chunks = t // 16
    place = {}
    for row in range(t):
        for c in range(chunks):
            at = row * 128 + ((c ^ (row & 7)) << 4)
            assert at not in place and at + 16 <= (row + 1) * 128
            place[at] = (row, c)
    assert len(place) == t * chunks
    for row0 in range(0, t, 8):
        for c in range(chunks):
            banks = {
                ((row0 + g) * 128 + ((c ^ g) << 4) + 4 * q) // 4 % 32
                for g in range(8) for q in range(4)
            }
            assert len(banks) == 32


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (nibble i of sel)
    of the eight bytes x.b0..b3, y.b0..b3."""
    src = [(x >> (8 * i)) & 255 for i in range(4)] + [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


@pytest.mark.parametrize("t,w", [(32, 1), (64, 3), (96, 2), (128, 5)])
def test_pipe_unpack_matches_byte_planes(t, w):
    """The consumers' unpack of csrc/tile_hits.cu in NumPy: warp item
    (word wl of the unit, chunk c), lane (g, q4) reads the word of rows
    j = 16c + 4 q4 .. + 3, keeps bit 8h + g of each in byte h, transposes
    the 4 x 4 bytes and writes bytes j .. j + 3 of operand rows
    32 wl + 8h + g at the swizzled place; read back unswizzled the operand
    is the transposed byte plane."""
    rng = np.random.default_rng(t + w)
    raw = rng.integers(0, 2**32, size=(t, w), dtype=np.uint64).astype(np.uint32)
    plan = cuda_mxu.tile_plan(4, 64, t, w)
    for grp in range(plan.groups):
        _, w0, nw, _ = plan.unit(grp * plan.split, w)
        operand = np.full(32 * plan.wg * 128, 255, dtype=np.uint8)
        for item in range(nw * (t // 16)):
            wl, c = divmod(item, t // 16)
            for lane in range(32):
                g, q4 = lane >> 2, lane & 3
                m = [
                    (int(raw[c * 16 + q4 * 4 + i, w0 + wl]) >> g) & 0x01010101
                    for i in range(4)
                ]
                t0, t1 = _byte_perm(m[0], m[1], 0x5140), _byte_perm(m[2], m[3], 0x5140)
                t2, t3 = _byte_perm(m[0], m[1], 0x7362), _byte_perm(m[2], m[3], 0x7362)
                outs = (_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
                        _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632))
                for h, word in enumerate(outs):
                    at = (wl * 32 + 8 * h + g) * 128 + ((c ^ g) << 4) + q4 * 4
                    assert (operand[at : at + 4] == 255).all()
                    operand[at : at + 4] = [(word >> (8 * i)) & 255 for i in range(4)]
        planes = bitbell.unpack_byte_planes(torch.from_numpy(raw.view(np.int32))).numpy()
        for n in range(32 * nw):
            row = [operand[n * 128 + (((j >> 4) ^ (n & 7)) << 4) + (j & 15)] for j in range(t)]
            np.testing.assert_array_equal(row, planes[:, (w0 + (n >> 5)) * 32 + (n & 31)])


@pytest.mark.parametrize("t", TILE_SIDES)
def test_pipe_ldmatrix_lanes_address_the_fragments(t):
    """The ldmatrix lane addresses of csrc/tile_hits.cu: lane l names row
    l & 7 of matrix l >> 3; A's matrices must be rows +0 / +8 of chunks
    k / k + 1 (a0..a3 of mma m16n8k32), B's chunks k / k + 1 of n-blocks
    nb / nb + 1, each at its swizzled place, eight rows of a matrix on
    eight distinct 16-byte bank groups."""
    for warp in range(t // 16):
        for k in range(0, t, 32):
            want_a = [(warp * 16 + dr, (k >> 4) + dc) for dc in (0, 1) for dr in (0, 8)]
            want_b = [(nb * 8, (k >> 4) + dc) for nb in (0, 1) for dc in (0, 1)]
            for mat in range(4):
                groups_a, groups_b = set(), set()
                for lrow in range(8):
                    a_row = warp * 16 + lrow + (mat & 1) * 8
                    a_at = a_row * 128 + ((((k >> 4) + (mat >> 1)) ^ lrow) << 4)
                    row0, chunk = want_a[mat]
                    assert a_at == (row0 + lrow) * 128 + ((chunk ^ ((row0 + lrow) & 7)) << 4)
                    b_row = (mat >> 1) * 8 + lrow
                    b_at = b_row * 128 + ((((k >> 4) + (mat & 1)) ^ lrow) << 4)
                    row0, chunk = want_b[mat]
                    assert b_at == (row0 + lrow) * 128 + ((chunk ^ ((row0 + lrow) & 7)) << 4)
                    groups_a.add(a_at // 16 % 8)
                    groups_b.add(b_at // 16 % 8)
                assert len(groups_a) == len(groups_b) == 8


# -- the sweep's residual edges -------------------------------------------

SMS = 132  # the ring's grid on an H100: one block per SM
L2_MAX_BLOCKS = 132 * 8  # csrc/msbfs_common.cuh kMaxBlocks


def _residual(rows, r, seed, straddle=0):
    """R random edges of a ``rows``-row plane, compacted as the engine
    keeps them; ``straddle`` > 0 puts every destination within two rows
    of a multiple of it (edges on both sides of tile boundaries)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, rows, size=r)
    if straddle:
        dst = rng.integers(1, max(2, rows // straddle), size=r) * straddle + rng.integers(-2, 2, size=r)
        dst = np.clip(dst, 0, rows - 1)
    else:
        dst = rng.integers(0, rows, size=r)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    uniq, seg = np.unique(dst, return_inverse=True)
    t = [torch.from_numpy(a.astype(np.int32)) for a in (src, seg, uniq)]
    return cuda_stencil.SweepResidual(rows, *t)


def _edge_schedule(rows, plan, ranges):
    """The edges each block of the sweep ORs in, as csrc/stencil_sweep.cu
    walks them: in the ring, block b after its walk takes the edges of its
    tiles [tb, te) — the first kResStage staged in shared memory, the rest
    read directly; in l2, block b after step k takes the table tiles of
    that step's kL2Rows row groups.  Returns {edge: (block, first row the
    block swept before, last row + 1)} and fails on an edge taken twice."""
    seen = {}

    def take(block, e0, e1, lo, hi):
        for e in range(int(e0), int(e1)):
            assert e not in seen, (e, block)
            seen[e] = (block, lo, hi)

    if plan.variant == "ring":
        tile, stage = plan.tile, 512  # csrc/stencil_sweep.cu kResStage
        tiles = -(-rows // tile)
        grid = max(1, min(SMS, tiles))
        for b in range(grid):
            tb, te = b * tiles // grid, (b + 1) * tiles // grid
            if te > tb:
                e0, e1 = ranges[tb], ranges[te]
                hi = min(te * tile, rows)
                take(b, e0, min(e1, e0 + stage), tb * tile, hi)  # staged
                take(b, e0 + stage, e1, tb * tile, hi)  # the rest
    else:
        step_rows, kl2 = cuda_stencil.L2_TILE_ROWS, 4
        grid = max(1, min(L2_MAX_BLOCKS, -(-(-(-rows // kl2)) // step_rows)))
        stride = grid * step_rows
        tiles = -(-rows // step_rows)
        for b in range(grid):
            for base in range(b * step_rows, rows, kl2 * stride):
                for c in range(kl2):
                    t = base // step_rows + c * grid
                    if t >= tiles:
                        break
                    lo = base + c * stride
                    take(b, ranges[t], ranges[t + 1], lo, min(lo + step_rows, rows))
    return seen


@pytest.mark.parametrize(
    "rows,w,offsets,r,straddle",
    [
        (4096 * 64, 1, ROAD, 700, 0),  # ring
        (4096 * 64, 1, ROAD, 700, 4096),  # destinations at tile boundaries
        (4096 * 64, 8, ROAD, 900, 256),  # l2 (K = 256), 256-row tables
        (100_000, 2, (1, -1, 300, -300), 5000, 0),  # many edges per tile
        (50_001, 3, (1, -1, 9000, -9000), 300, 1024),  # l2, generic width
        (20_000, 1, (1, -1), 30_000, 0),  # past the 512 a block stages
        (5000, 1, (1, -1), 1, 0),  # one edge
        (5000, 1, (1, -1), 0, 0),  # R = 0: an empty table
    ],
)
def test_residual_ranges_cover_every_edge_once(rows, w, offsets, r, straddle):
    res = _residual(rows, r, rows + r + w, straddle)
    dst = res.dst.numpy()
    assert (np.diff(dst) >= 0).all()
    for plan in (cuda_stencil.sweep_plan(rows, w, offsets),
                 cuda_stencil.sweep_plan(rows, w, offsets, vec16=False)):
        tile = cuda_stencil.residual_tile(plan)
        assert tile == (plan.tile if plan.variant == "ring" else 256)
        ranges = cuda_stencil.residual_ranges(res, tile).numpy()
        tiles = -(-rows // tile)
        assert ranges.shape == (tiles + 1,) and ranges.dtype == np.int32
        assert ranges[0] == 0 and ranges[-1] == r and (np.diff(ranges) >= 0).all()
        for t in range(tiles):
            own = dst[ranges[t] : ranges[t + 1]]
            assert ((own >= t * tile) & (own < (t + 1) * tile)).all()
        seen = _edge_schedule(rows, plan, ranges)
        assert sorted(seen) == list(range(r))
        for e, (_, lo, hi) in seen.items():
            # The block has swept (and stored) the edge's destination row.
            assert lo <= dst[e] < hi, (e, dst[e], lo, hi)
        assert cuda_stencil.residual_ranges(res, tile) is cuda_stencil.residual_ranges(res, tile)


def test_residual_ranges_small_tiles_and_windows(monkeypatch):
    """Ring plans with many small tiles, and the window: the engines take
    a window of rows only on residual-free graphs, and the wrapper refuses
    a residual for a plane of other rows."""
    monkeypatch.setattr(cuda_stencil, "RING_MAX_TILE", 64)
    monkeypatch.setattr(cuda_stencil, "RING_MIN_TILE", 32)
    rows = 20_000
    res = _residual(rows, 3000, 5, straddle=64)
    plan = cuda_stencil.sweep_plan(rows, 1, (1, -1, 150, -150))
    assert plan.variant == "ring" and plan.tile == 64
    ranges = cuda_stencil.residual_ranges(res, cuda_stencil.residual_tile(plan))
    assert sorted(_edge_schedule(rows, plan, ranges.numpy())) == list(range(3000))
    n, edges = generators.road_edges(24, 24, seed=932, shortcut_frac=0.02)
    sg = stencil.StencilGraph.from_host(CSRGraph.from_edges(n, edges), "cpu")
    assert sg.residual is not None and sg.residual.count == sg.res_src.shape[0]
    assert not stencil.StencilEngine(sg, level_chunk=4, window=True).window_active
    grid = stencil.StencilGraph.from_host(CSRGraph.from_edges(*generators.grid_edges(40, 8)), "cpu")
    assert grid.residual is None
    assert stencil.StencilEngine(grid, level_chunk=4, window=True).window_active
    frontier = torch.zeros((n // 2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="residual addresses"):
        cuda_stencil.stencil_sweep(
            frontier, sg.mask_bits[: n // 2], sg.offsets, frontier.clone(),
            torch.tensor([1, 0, 0, 0], dtype=torch.int32), 10, sg.residual,
        )


# -- the forest's warp runs -------------------------------------------------


def _hub_forest(widths, device="cpu"):
    """The BELL layout of :func:`_hub_csr` (``device=False``: on the host)."""
    return BellGraph.from_host(_hub_csr(), device, widths=widths, min_bucket_rows=0)


def _hub_csr(seed=3):
    """RMAT edges with hubs of 40, 300, 700 and 2100 neighbours (wide
    rows, two and three forest levels) and isolated vertices."""
    m, e = generators.rmat_edges(9, edge_factor=6, seed=seed)
    n = 3000
    hubs = [np.stack([np.full(d, h, np.int32), (np.arange(d, dtype=np.int32) * 7 + h) % n], 1)
            for h, d in ((7, 40), (11, 300), (13, 700), (17, 2100))]
    return CSRGraph.from_edges(n, np.concatenate([e] + hubs))


def _level_runs(cols, tab, runs, prev, prev_rows, n_out, chunks):
    """One launch of forest_or.cu's level kernel in NumPy: ``runs`` runs
    decoded from the bucket table ``tab`` as the kernel decodes them
    (bucket search, chunks of 32 lanes, segmented shuffles toward each
    row's first lane, a warp per wide row with an xor-shuffle).  Returns
    the (n_out, W) rows and how often each slot was read and each row
    written."""
    w = prev.shape[1]
    out = np.zeros((n_out, w), dtype=np.uint32)
    read = np.zeros(cols.shape[0], dtype=np.int64)
    wrote = np.zeros(n_out, dtype=np.int64)

    def row_of(c):
        return prev[c] if c < prev_rows else np.zeros(w, dtype=np.uint32)

    for run in range(runs):
        b = int(np.searchsorted(tab[:, 4], run, side="right")) - 1
        off, rows, width, row_base, first, rpc = (int(x) for x in tab[b])
        local = run - first
        if rpc:
            lrow = [lane // width for lane in range(32)]
            lpos = [lane - lrow[lane] * width for lane in range(32)]
            row0 = local * chunks * rpc
            for s in range(chunks):
                x = np.zeros((32, w), dtype=np.uint32)
                for lane in range(32):
                    if lrow[lane] < rpc and row0 + s * rpc + lrow[lane] < rows:
                        slot = off + (row0 + s * rpc) * width + lane
                        assert slot == off + (row0 + s * rpc + lrow[lane]) * width + lpos[lane]
                        read[slot] += 1
                        x[lane] = row_of(int(cols[slot]))
                d = 1
                while d < width:  # __shfl_down_sync: past lane 31, its own value
                    y = np.array([x[min(lane + d, 31)] if lane + d < 32 else x[lane] for lane in range(32)])
                    for lane in range(32):
                        if lpos[lane] + d < width:
                            x[lane] |= y[lane]
                    d <<= 1
                for lane in range(32):
                    row = row0 + s * rpc + lrow[lane]
                    if lpos[lane] == 0 and lrow[lane] < rpc and row < rows:
                        wrote[row_base + row] += 1
                        out[row_base + row] = x[lane]
        else:
            assert local < rows
            acc = np.zeros(w, dtype=np.uint32)
            for j in range(width):
                read[off + local * width + j] += 1
                acc |= row_of(int(cols[off + local * width + j]))
            wrote[row_base + local] += 1
            out[row_base + local] = acc
    return out, read, wrote


def _forest_emulation(bg, frontier, plan):
    """csrc/forest_or.cu in NumPy: each level's launch (:func:`_level_runs`
    over the level's table), then the final gather.  Every slot must be
    read by exactly one lane and every row written by one lane."""
    n, w = frontier.shape
    table, meta = cuda_bell.forest_tables(bg, w, "cpu")
    table, meta = table.numpy(), list(meta)
    v_cat = np.zeros((bg.total_rows + 1, w), dtype=np.uint32)
    prev = frontier
    for li, flat in enumerate(bg.level_cols):
        _, prev_rows, out_off, begin, count, runs = meta[6 * li : 6 * li + 6]
        out, read, wrote = _level_runs(
            flat.numpy(), table[begin : begin + count], runs, prev, prev_rows,
            bg.level_sizes[li], plan.chunks,
        )
        assert (read == 1).all() and (wrote == 1).all(), li
        v_cat[out_off : out_off + bg.level_sizes[li]] = out
        prev = v_cat[out_off : out_off + bg.level_sizes[li]]
    return v_cat[bg.final_slot.numpy()]


def _segment_emulation(host, frontier, plan, slot_budget):
    """K1's segment form in NumPy: the streamed engine's schedule, each
    segment a launch of the same level kernel over its own table (from
    :class:`cuda_bell.SegmentTables`) into its rows of the scratch, then
    the final take.  Every slot of every segment read once, every row of
    every level written once."""
    eng = streamed.StreamedBitBellEngine(host, "cpu", slot_budget=slot_budget)
    v_cat = np.zeros((host.total_rows + 1, frontier.shape[1]), dtype=np.uint32)
    wrote = np.zeros(host.total_rows, dtype=np.int64)
    for i, seg in enumerate(eng._segments):
        entries, runs = cuda_bell.segment_table(eng._tables.pieces[i], plan.chunks)
        level_off = eng._row_offset[seg.level]
        if seg.level == 0:
            prev, prev_rows = frontier, host.n
        else:
            lo = eng._row_offset[seg.level - 1]
            prev_rows = eng.level_rows[seg.level - 1]
            prev = v_cat[lo : lo + prev_rows]
        out, read, w_seg = _level_runs(
            eng._slices[i].numpy(), np.asarray(entries, dtype=np.int64), runs, prev,
            prev_rows, seg.rows, plan.chunks,
        )
        assert (read == 1).all() and (w_seg == 1).all(), i
        lo = level_off + seg.row0
        v_cat[lo : lo + seg.rows] = out
        wrote[lo : lo + seg.rows] += 1
    assert (wrote == 1).all()
    return v_cat[host.final_slot]


@pytest.mark.parametrize(
    "widths", [DEFAULT_WIDTHS, (1, 2, 4, 8), (3, 21, 27, 34, 256), (1, 32, 33, 256)]
)
@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_forest_runs_cover_every_slot_once(widths, w):
    bg = _hub_forest(widths)
    assert len(bg.level_sizes) >= 2
    rng = np.random.default_rng(w)
    frontier = rng.integers(0, 2**32, size=(bg.n, w), dtype=np.uint64).astype(np.uint32)
    frontier[rng.random(bg.n) < 0.6] = 0
    want = bell.forest_hits(torch.from_numpy(frontier.view(np.int32)), bg).numpy().view(np.uint32)
    plan = cuda_bell.forest_plan(w)
    np.testing.assert_array_equal(_forest_emulation(bg, frontier, plan), want)


@pytest.mark.parametrize("widths", [DEFAULT_WIDTHS, (1, 32, 33, 256)])
@pytest.mark.parametrize("w", [2, 3, 8])
@pytest.mark.parametrize("slot_budget", [None, 700, 4096])
def test_segment_runs_cover_every_slot_once(widths, w, slot_budget):
    """The segment form's tables drive the level kernel over each
    uploaded segment to the plain forest's hits, whole levels or cut."""
    bg = _hub_forest(widths)
    rng = np.random.default_rng(w + 11)
    frontier = rng.integers(0, 2**32, size=(bg.n, w), dtype=np.uint64).astype(np.uint32)
    frontier[rng.random(bg.n) < 0.6] = 0
    want = bell.forest_hits(torch.from_numpy(frontier.view(np.int32)), bg).numpy().view(np.uint32)
    plan = cuda_bell.forest_plan(w)
    host = _hub_forest(widths, False)
    np.testing.assert_array_equal(_segment_emulation(host, frontier, plan, slot_budget), want)


def test_segment_tables_match_forest_tables():
    """Uncut, a segment's table is its level's rows of the forest table."""
    bg = _hub_forest(DEFAULT_WIDTHS)
    eng = streamed.StreamedBitBellEngine(_hub_forest(DEFAULT_WIDTHS, False), "cpu")
    for w in (1, 8):
        table, meta = cuda_bell.forest_tables(bg, w, "cpu")
        chunks = cuda_bell.forest_plan(w).chunks
        for i, seg in enumerate(eng._segments):
            begin, count, runs = list(meta)[6 * seg.level + 3 : 6 * seg.level + 6]
            entries, seg_runs = cuda_bell.segment_table(eng._tables.pieces[i], chunks)
            assert seg_runs == runs
            assert entries == [tuple(r) for r in table[begin : begin + count].tolist()]
    tables = cuda_bell.SegmentTables(eng._tables.pieces, "cpu")
    ptr, buckets, runs = tables.entry(len(eng._segments) - 1, 2)
    assert buckets == len(eng._tables.pieces[-1]) and runs > 0 and ptr


def test_forest_tables_are_cached_per_chunk_count():
    bg = _hub_forest(DEFAULT_WIDTHS)
    t1, _ = cuda_bell.forest_tables(bg, 1, "cpu")
    assert cuda_bell.forest_tables(bg, 2, "cpu")[0] is t1  # both four chunks a run
    t8, m8 = cuda_bell.forest_tables(bg, 8, "cpu")
    assert t8 is not t1 and cuda_bell.forest_tables(bg, 3, "cpu")[0] is t8
    runs4 = sum(list(cuda_bell.forest_tables(bg, 1, "cpu")[1])[5::6])
    assert sum(list(m8)[5::6]) > runs4  # two chunks a run: more runs


@pytest.mark.parametrize("w,vec16", [(1, True), (2, True), (2, False), (3, True), (4, True), (8, True), (16, False)])
def test_forest_plan(w, vec16):
    plan = cuda_bell.forest_plan(w, vec16)
    assert plan.w_instance == (w if w in (1, 2, 4, 8) else 0)
    assert plan.vec16 == (vec16 and w in (2, 4, 8))
    assert plan.chunks == (2 if w == 8 or plan.w_instance == 0 else 4)
    assert plan == cuda_bell.forest_plan(w, vec16)
    assert cuda_bell.forest_plan(2).label == "W2/vec16"
    assert cuda_bell.forest_plan(5).label == "Wn/vec4"
    assert cuda_bell.forest_plan(8, False).label == "W8/vec4"


# The push kernel's block size and blocks per SM (csrc/push_or.cu), and the
# H100's SMs.
PUSH_THREADS, PUSH_BLOCKS_PER_SM, SMS = 256, 2, 132


def _push_walk(offs, total, edge_cap, window_rule="next_edge"):
    """csrc/push_or.cu's walk of the edge space [0, total) of a worklist
    with exclusive prefixes ``offs`` (each entry holds an edge): each warp
    takes an equal share of whole 32-edge steps, finds its first edge's
    entry by the 32-way ballot search, and each step's lanes search the 32
    entries from the step's window start.  Returns the entry each edge
    was read from.  ``window_rule`` "lane31" is a faulty rule kept to
    show that the test catches it: the next window starts at lane 31's
    entry."""
    offs = np.asarray(offs, dtype=np.int64)
    length = offs.shape[0]
    big = np.iinfo(np.int64).max
    grid = min(max(1, -(-edge_cap // PUSH_THREADS)), PUSH_BLOCKS_PER_SM * SMS)
    warps = grid * PUSH_THREADS // 32
    share = (-(-total // warps) + 31) // 32 * 32
    got = np.full(total, -1, dtype=np.int64)

    def at(i):
        return offs[i] if i < length else big

    def find_entry(e):
        lo, hi = 0, length
        while hi - lo > 32:
            span = hi - lo
            m = [at(lo + span * lane // 32) <= e for lane in range(32)]
            k = max(lane for lane in range(32) if m[lane])
            hi = hi if k == 31 else lo + span * (k + 1) // 32
            lo += span * k // 32
        return lo + max(lane for lane in range(32) if lo + lane < hi and at(lo + lane) <= e)

    for warp in range(warps):
        a = warp * share
        if length == 0 or a >= total:
            continue
        b = min(a + share, total)
        i0 = find_entry(a)
        for e0 in range(a, b, 32):
            o = [at(i0 + lane) for lane in range(32)]
            js = []
            for lane in range(32):
                e, j = e0 + lane, 0
                for step in (16, 8, 4, 2, 1):
                    if o[j + step] <= e:
                        j += step
                js.append(j)
                if e < b:
                    got[e] = i0 + j
            if window_rule == "lane31":
                i0 += js[31]
            else:
                k = max(lane for lane in range(32) if o[lane] <= e0 + 32)
                if k == 31 and at(i0 + 32) <= e0 + 32:
                    k = 32
                i0 += k
    return got


def _degrees_to_offs(deg):
    deg = np.asarray(deg, dtype=np.int64)
    return np.cumsum(deg) - deg, int(deg.sum())


@pytest.mark.parametrize(
    "case", ["step_ends_then_singles", "random_small", "hub_then_singles", "singles", "one_hub"]
)
def test_push_walk_reads_every_edge_from_its_entry(case):
    """Every edge of the worklist's edge space is read from the entry that
    holds it, whatever the order of the rows' degrees: among them a row
    that ends exactly at a step's last edge followed by 32 rows of one
    edge, the order in which a walk that starts each step at the previous
    step's last entry reads one edge from the entry before its own (on
    RMAT-20's fifth bitbell level, listed in such an order, that walk set
    two words too many)."""
    rng = np.random.default_rng(len(case))
    if case == "step_ends_then_singles":
        deg = [32] + [1] * 40 + list(rng.integers(1, 4, size=2000))
    elif case == "random_small":
        deg = rng.choice([1, 1, 1, 2, 3, 14], size=20000)
    elif case == "hub_then_singles":
        deg = [5000] + [1] * 3000 + [31] + [1] * 100
    elif case == "singles":
        deg = [1] * 9000
    else:
        deg = [70000]
    offs, total = _degrees_to_offs(deg)
    want = np.searchsorted(offs, np.arange(total), side="right") - 1
    for edge_cap in (total, 256, 490663):
        np.testing.assert_array_equal(_push_walk(offs, total, edge_cap), want)
    if case == "step_ends_then_singles":
        assert (_push_walk(offs, total, 256, window_rule="lane31") != want).any()
