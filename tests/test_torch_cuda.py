"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips with a reason where there is no CUDA
device (the CPU test run); on a GPU machine run
``python -m pytest tests/test_torch_cuda.py -m cuda -q``.  Every
comparison is exact — all values are bits and integers.
"""

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    DEFAULT_WIDTHS,
    BellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.ell import (
    EllGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bell,
    bfs,
    bitbell,
    cuda_bell,
    cuda_bfs,
    cuda_flag_pull,
    cuda_mxu,
    cuda_stencil,
    engine,
    lowk,
    mxu,
    stencil,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
    kernels,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io,
    timing,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _planes(rng, n, w):
    # Full 32-bit words: bit 31 set in about half of them.
    return torch.from_numpy(
        rng.integers(0, 2**32, size=(n, w), dtype=np.uint64)
        .astype(np.uint32)
        .view(np.int32)
    )


def _go():
    return torch.tensor([1, 5, 0, 0], dtype=torch.int32)


def test_kernels_build(cuda):
    built = kernels.build_all()
    assert set(built) == set(kernels.KERNELS)
    for name, result in built.items():
        print(name, result.path.name, f"{result.seconds:.2f}s\n{result.log}")
    assert set(kernels.library()) == set(kernels.KERNELS)


@pytest.mark.parametrize("w", [1, 3, 8])
def test_sweep_matches_plain(cuda, w):
    rng = np.random.default_rng(w)
    n = 5000
    frontier = _planes(rng, n, w)
    frontier[rng.random(n) < 0.7] = 0
    mask = torch.from_numpy(
        rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    )
    offsets = [1, -1, 71, -71, 70, -72, 2, 4999, -5001, 33, -40, 12, 13, 14, -15, 16]
    want = torch.zeros_like(frontier)
    cuda_stencil.stencil_sweep_plain(frontier, mask, offsets, want, _go(), 100)
    got = torch.zeros_like(frontier, device=cuda)
    before = timing.launch_counts().get("stencil_sweep", 0)
    cuda_stencil.stencil_sweep(
        frontier.to(cuda), mask.to(cuda), offsets, got, _go().to(cuda), 100
    )
    torch.cuda.synchronize()
    assert timing.launch_counts()["stencil_sweep"] == before + 1
    assert torch.equal(got.cpu(), want)
    # Gated off (level at max_levels): the hit plane is left untouched.
    stale = torch.full_like(got, 7)
    cuda_stencil.stencil_sweep(
        frontier.to(cuda), mask.to(cuda), offsets, stale, _go().to(cuda), 5
    )
    assert bool((stale == 7).all())


ROAD_SMALL = (1, -1, 97, -97, 98, -98, 99, -99)


def _view(t, lo, rows):
    """Rows [lo, lo + rows) of ``t``: at an odd ``lo`` its base is not
    16-byte aligned."""
    return t[lo : lo + rows]


@pytest.mark.parametrize(
    "rows,w,offsets,lo,small_tiles,variant",
    [
        (10007, 1, ROAD_SMALL, 0, False, "ring/W1/vec16"),
        (10007, 2, ROAD_SMALL, 0, False, "ring/W2/vec16"),
        (10007, 3, ROAD_SMALL, 0, False, "ring/Wn/vec16"),
        (10007, 4, ROAD_SMALL, 0, False, "ring/W4/vec16"),
        (10007, 8, ROAD_SMALL, 0, False, "ring/W8/vec16"),
        # Blocks walk many 64-row tiles, wrapping their rings.
        (200_003, 1, ROAD_SMALL, 0, True, "ring/W1/vec16"),
        (100_001, 8, ROAD_SMALL, 0, True, "ring/W8/vec16"),
        (50_001, 3, ROAD_SMALL, 0, True, "ring/Wn/vec16"),
        # Rows fewer than max|d|: the far offsets never land in the plane.
        (3000, 1, (1, -1, 5000, -5001, 2999, -2999), 0, False, "ring/W1/vec16"),
        # Halos that outgrow the ring: the l2 variant.
        (60_000, 1, (1, -1, 20_000, -20_000), 0, False, "l2/W1/vec16"),
        (30_000, 8, (1, -1, 5000, -5000), 0, False, "l2/W8/vec16"),
        (30_000, 2, (1, -1, 9000, -9000), 0, False, "l2/W2/vec16"),
        (30_000, 3, (1, -1, 9000, -9000), 0, False, "l2/Wn/vec16"),
        # Views from an odd row: the 4-byte path of either variant.
        (10007, 1, ROAD_SMALL, 3, False, "ring/W1/vec4"),
        (100_001, 2, ROAD_SMALL, 5, True, "ring/W2/vec4"),
        (30_000, 4, (1, -1, 9000, -9000), 1, False, "l2/W4/vec4"),
    ],
)
def test_sweep_variants_match_plain(cuda, monkeypatch, rows, w, offsets, lo, small_tiles, variant):
    if small_tiles:
        monkeypatch.setattr(cuda_stencil, "RING_MAX_TILE", 64)
        monkeypatch.setattr(cuda_stencil, "RING_MIN_TILE", 32)
    rng = np.random.default_rng(rows + w + lo)
    frontier = _planes(rng, lo + rows, w)
    frontier[rng.random(lo + rows) < 0.6] = 0
    mask = _planes(rng, lo + rows, 1)[:, 0].contiguous()
    f_v, m_v = _view(frontier, lo, rows), _view(mask, lo, rows)
    want = torch.zeros((rows, w), dtype=torch.int32)
    cuda_stencil.stencil_sweep_plain(f_v, m_v, list(offsets), want, _go(), 100)
    f_c, m_c = frontier.to(cuda), mask.to(cuda)
    hits = torch.full((lo + rows, w), 7, dtype=torch.int32, device=cuda)
    timing.reset_launch_counts()
    cuda_stencil.stencil_sweep(
        _view(f_c, lo, rows), _view(m_c, lo, rows), list(offsets),
        _view(hits, lo, rows), _go().to(cuda), 100,
    )
    torch.cuda.synchronize()
    assert timing.variant_counts() == {f"stencil_sweep:{variant}": 1}
    assert timing.launch_counts() == {"stencil_sweep": 1}
    assert torch.equal(hits[lo:].cpu(), want)
    assert bool((hits[:lo] == 7).all())  # nothing written outside the view


@pytest.mark.parametrize("w", [1, 3, 8])
def test_sweep_edge_frontiers(cuda, w):
    """Empty, single-word and bit-31 frontiers, and the gated no-op."""
    rows = 9001
    rng = np.random.default_rng(w)
    mask = torch.full((rows,), -1, dtype=torch.int32)  # every offset's edge
    cases = [torch.zeros((rows, w), dtype=torch.int32)]
    one = torch.zeros((rows, w), dtype=torch.int32)
    one[4500, w - 1] = 1
    cases.append(one)
    top = torch.zeros((rows, w), dtype=torch.int32)
    top[rng.integers(0, rows, 50), 0] = -(2**31)  # bit 31 alone
    top[0, :] = top[rows - 1, :] = -1  # both ends, all bits
    cases.append(top)
    for frontier in cases:
        want = torch.zeros_like(frontier)
        cuda_stencil.stencil_sweep_plain(frontier, mask, list(ROAD_SMALL), want, _go(), 100)
        got = torch.full_like(frontier, 5, device=cuda)
        cuda_stencil.stencil_sweep(
            frontier.to(cuda), mask.to(cuda), list(ROAD_SMALL), got, _go().to(cuda), 100
        )
        assert torch.equal(got.cpu(), want)
    # Converged (ctrl[0] == 0): the launch returns before any copy or store.
    stale = torch.full((rows, w), 5, dtype=torch.int32, device=cuda)
    done = torch.tensor([0, 5, 0, 0], dtype=torch.int32, device=cuda)
    cuda_stencil.stencil_sweep(top.to(cuda), mask.to(cuda), list(ROAD_SMALL), stale, done, 100)
    assert bool((stale == 5).all())


def _apply_carry(rng, rows, w, dev, lo=0):
    """A carry over rows [lo, lo + rows) of larger planes (a view at an
    odd ``lo``), with random counters."""
    k = 32 * w
    visited = _planes(rng, lo + rows, w)
    frontier = _planes(rng, lo + rows, w)
    carry = bitbell.BitCarry(
        visited=visited.to(dev), frontier=frontier.to(dev),
        f=torch.from_numpy(rng.integers(0, 1000, size=k)).to(dev),
        levels=torch.full((k,), 3, dtype=torch.int32, device=dev),
        reached=torch.full((k,), 11, dtype=torch.int32, device=dev),
        counts=torch.zeros(k, dtype=torch.int32, device=dev),
        ctrl=_go().to(dev),
    )
    return carry.rows(lo, rows) if lo else carry


_APPLY_FIELDS = ("visited", "frontier", "f", "levels", "reached", "counts", "ctrl")


@pytest.mark.parametrize(
    "rows,w,lo,variant",
    [
        (7777, 1, 0, "vector/W1/vec16"),  # rows * W not a multiple of 4
        (7778, 2, 0, "vector/W2/vec16"),
        (7777, 3, 0, "column/Wn/vec4"),
        (7777, 4, 0, "vector/W4/vec16"),
        (7777, 8, 0, "vector/W8/vec16"),
        (7777, 5, 0, "column/Wn/vec4"),
        (5_000_003, 8, 0, "vector/W8/vec16"),  # warps flush mid-walk
        (7777, 1, 3, "vector/W1/vec4"),  # views from an odd row
        (7777, 2, 1, "vector/W2/vec4"),
        (7777, 3, 5, "column/Wn/vec4"),
    ],
)
def test_level_apply_variants_match_plain(cuda, rows, w, lo, variant):
    rng = np.random.default_rng(rows + w + lo)
    hits_full = _planes(rng, lo + rows, w)
    hits_full[rng.random(lo + rows) < 0.5] = 0
    state = rng.bit_generator.state
    want = _apply_carry(rng, rows, w, cuda, lo)
    rng.bit_generator.state = state
    got = _apply_carry(rng, rows, w, cuda, lo)
    hits = _view(hits_full.to(cuda), lo, rows)
    bitbell.bit_level_apply_plain(want, hits, 100)
    timing.reset_launch_counts()
    bitbell.bit_level_apply(got, hits, 100)
    torch.cuda.synchronize()
    assert timing.variant_counts() == {f"level_apply:{variant}": 1}
    for field in _APPLY_FIELDS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.parametrize("w", [1, 3, 8])
def test_level_apply_edge_hits(cuda, w):
    """Empty and single-word hit planes, bit 31, and the gated no-op."""
    rows = 4099
    rng = np.random.default_rng(90 + w)
    empty = torch.zeros((rows, w), dtype=torch.int32)
    single = empty.clone()
    single[rows - 1, w - 1] = -(2**31)  # bit 31 of the last word only
    for hits in (empty, single):
        state = rng.bit_generator.state
        want = _apply_carry(rng, rows, w, "cpu")
        rng.bit_generator.state = state
        got = _apply_carry(rng, rows, w, cuda)
        want.visited.zero_()
        got.visited.zero_()
        bitbell.bit_level_apply_plain(want, hits, 100)
        bitbell.bit_level_apply(got, hits.to(cuda), 100)
        for field in _APPLY_FIELDS:
            assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
    assert int(got.counts.sum()) == 0 and int(got.reached[32 * w - 1]) == 12
    # At max_levels: nothing changes, the level does not advance.
    snap = {f: getattr(got, f).clone() for f in _APPLY_FIELDS}
    bitbell.bit_level_apply(got, single.to(cuda), int(got.ctrl[1]))
    for field in _APPLY_FIELDS:
        assert torch.equal(getattr(got, field), snap[field]), field


def _residual(rng, rows, r, straddle=0):
    """R random residual edges of a ``rows``-row plane, compacted as the
    engine keeps them; ``straddle`` > 0 puts the destinations within two
    rows of its multiples (both sides of tile boundaries), several edges
    sharing each."""
    src = rng.integers(0, rows, size=r)
    if straddle:
        dst = rng.integers(1, max(2, rows // straddle), size=r) * straddle + rng.integers(-2, 2, size=r)
        dst = np.clip(dst, 0, rows - 1)
    else:
        dst = rng.integers(0, rows, size=r)
    order = np.argsort(dst, kind="stable")
    uniq, seg = np.unique(dst[order], return_inverse=True)
    t = [torch.from_numpy(a.astype(np.int32)) for a in (src[order], seg, uniq)]
    return t


@pytest.mark.parametrize(
    "rows,w,offsets,r,straddle,lo,small_tiles,variant",
    [
        (3000, 1, ROAD_SMALL, 900, 0, 0, False, "ring/W1/vec16/res"),
        (3000, 2, ROAD_SMALL, 900, 0, 0, False, "ring/W2/vec16/res"),
        (3000, 8, ROAD_SMALL, 900, 0, 0, False, "ring/W8/vec16/res"),
        (10007, 4, ROAD_SMALL, 3000, 0, 0, False, "ring/W4/vec16/res"),
        # Many 64-row tiles per block, edges on both sides of their bounds.
        (200_003, 1, ROAD_SMALL, 20_000, 64, 0, True, "ring/W1/vec16/res"),
        (100_001, 8, ROAD_SMALL, 8000, 64, 0, True, "ring/W8/vec16/res"),
        (50_001, 3, ROAD_SMALL, 5000, 64, 0, True, "ring/Wn/vec16/res"),
        # The l2 variant: 256-row steps, edges on both sides of them.
        (60_000, 1, (1, -1, 20_000, -20_000), 4000, 256, 0, False, "l2/W1/vec16/res"),
        (30_000, 8, (1, -1, 5000, -5000), 3000, 256, 0, False, "l2/W8/vec16/res"),
        (30_000, 3, (1, -1, 9000, -9000), 3000, 256, 0, False, "l2/Wn/vec16/res"),
        # Views from an odd row: the 4-byte path of either variant.
        (10007, 2, ROAD_SMALL, 3000, 64, 3, False, "ring/W2/vec4/res"),
        (30_000, 4, (1, -1, 9000, -9000), 3000, 256, 1, False, "l2/W4/vec4/res"),
        # Five edges per row: every tile's destinations, many shared.
        (4000, 1, ROAD_SMALL, 20_000, 0, 0, False, "ring/W1/vec16/res"),
    ],
)
def test_fused_sweep_matches_plain(cuda, monkeypatch, rows, w, offsets, r, straddle, lo,
                                   small_tiles, variant):
    """The sweep with residual edges in its launch against the plain pair
    (stencil_sweep_plain, then residual_or_plain): one launch, the
    residual variant, bit for bit; a gated launch writes nothing."""
    if small_tiles:
        monkeypatch.setattr(cuda_stencil, "RING_MAX_TILE", 64)
        monkeypatch.setattr(cuda_stencil, "RING_MIN_TILE", 32)
    rng = np.random.default_rng(rows + w + r)
    frontier = _planes(rng, lo + rows, w)
    frontier[rng.random(lo + rows) < 0.6] = 0
    mask = _planes(rng, lo + rows, 1)[:, 0].contiguous()
    res = _residual(rng, rows, r, straddle)
    f_v, m_v = _view(frontier, lo, rows), _view(mask, lo, rows)
    want = torch.zeros((rows, w), dtype=torch.int32)
    cuda_stencil.stencil_sweep_plain(
        f_v, m_v, list(offsets), want, _go(), 100, cuda_stencil.SweepResidual(rows, *res)
    )
    sweep_only = torch.zeros_like(want)
    cuda_stencil.stencil_sweep_plain(f_v, m_v, list(offsets), sweep_only, _go(), 100)
    assert not torch.equal(want, sweep_only)  # the residual adds bits
    f_c, m_c = frontier.to(cuda), mask.to(cuda)
    residual = cuda_stencil.SweepResidual(rows, *(t.to(cuda) for t in res))
    hits = torch.full((lo + rows, w), 7, dtype=torch.int32, device=cuda)
    timing.reset_launch_counts()
    cuda_stencil.stencil_sweep(
        _view(f_c, lo, rows), _view(m_c, lo, rows), list(offsets),
        _view(hits, lo, rows), _go().to(cuda), 100, residual,
    )
    torch.cuda.synchronize()
    assert timing.variant_counts() == {f"stencil_sweep:{variant}": 1}
    assert timing.launch_counts() == {"stencil_sweep": 1}
    assert torch.equal(hits[lo:].cpu(), want)
    assert bool((hits[:lo] == 7).all())  # nothing written outside the view
    stale = torch.full((rows, w), 5, dtype=torch.int32, device=cuda)
    done = torch.tensor([0, 5, 0, 0], dtype=torch.int32, device=cuda)
    cuda_stencil.stencil_sweep(
        _view(f_c, lo, rows), _view(m_c, lo, rows), list(offsets), stale, done, 100, residual
    )
    assert bool((stale == 5).all())


def test_stencil_route_launches_one_kernel_a_level(cuda):
    """A residual graph's level is one sweep launch (the residual inside
    it) and one apply, nothing else; the batch's sources are one pack."""
    n, edges = generators.road_edges(48, 48, seed=5, shortcut_frac=0.01)
    sg = stencil.StencilGraph.from_host(CSRGraph.from_edges(n, edges), cuda)
    assert sg.residual is not None
    eng = stencil.StencilEngine(sg, level_chunk=8)
    queries = io.pad_queries(generators.random_queries(n, 20, max_group=5, seed=3))
    timing.reset_launch_counts()
    eng.query_stats(queries)
    counts = timing.launch_counts()
    assert set(counts) == {"pack_sources", "stencil_sweep", "level_apply"}
    assert counts["stencil_sweep"] == counts["level_apply"] and counts["pack_sources"] == 1
    assert all(k.endswith("/res") for k in timing.variant_counts() if k.startswith("stencil_sweep"))


@pytest.mark.parametrize("w", [1, 3, 8])
def test_level_apply_matches_plain(cuda, w):
    rng = np.random.default_rng(20 + w)
    n, k = 7777, 32 * w
    hits, visited, frontier = (_planes(rng, n, w) for _ in range(3))
    hits[rng.random(n) < 0.5] = 0

    def carry(dev):
        return bitbell.BitCarry(
            visited=visited.clone().to(dev),
            frontier=frontier.clone().to(dev),
            f=torch.from_numpy(rng.integers(0, 1000, size=k)).to(dev),
            levels=torch.full((k,), 3, dtype=torch.int32, device=dev),
            reached=torch.full((k,), 11, dtype=torch.int32, device=dev),
            counts=torch.zeros(k, dtype=torch.int32, device=dev),
            ctrl=_go().to(dev),
        )

    rng_state = rng.bit_generator.state
    want = carry("cpu")
    rng.bit_generator.state = rng_state
    got = carry(cuda)
    bitbell.bit_level_apply_plain(want, hits, 100)
    bitbell.bit_level_apply(got, hits.to(cuda), 100)
    for field in ("visited", "frontier", "f", "levels", "reached", "counts", "ctrl"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
    # Gated off: converged carry is a fixed point.
    got.ctrl[0] = 0
    snap = got.visited.clone()
    bitbell.bit_level_apply(got, hits.to(cuda), 100)
    assert torch.equal(got.visited, snap) and int(got.ctrl[1]) == 6


@pytest.mark.parametrize(
    "k,level_chunk", [(1, None), (40, 4), (70, None), (300, 2)]
)
def test_engine_kernel_path_matches_plain(cuda, k, level_chunk):
    n, edges = generators.road_edges(48, 48, seed=5, shortcut_frac=0.01)
    g = CSRGraph.from_edges(n, edges)
    queries = io.pad_queries(generators.random_queries(n, k, max_group=5, seed=k))
    sg_cpu = stencil.StencilGraph.from_host(g, "cpu")
    sg = stencil.StencilGraph.from_host(g, cuda)
    assert sg.res_src.shape[0] > 0
    want = stencil.StencilEngine(sg_cpu, level_chunk=level_chunk).query_stats(queries)
    plain = stencil.StencilEngine(sg, level_chunk=level_chunk, plain=True)
    fast = stencil.StencilEngine(sg, level_chunk=level_chunk)
    for eng in (plain, fast):
        got = eng.query_stats(queries)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(x, y)
    assert fast.best(queries) == stencil.StencilEngine(sg_cpu).best(queries)


def test_window_on_card(cuda):
    n, edges = generators.grid_edges(300, 16)
    g = CSRGraph.from_edges(n, edges)
    rng = np.random.default_rng(3)
    queries = io.pad_queries(
        [rng.integers(0, 64, size=3).astype(np.int32) for _ in range(5)]
    )
    sg = stencil.StencilGraph.from_host(g, cuda)
    win = stencil.StencilEngine(sg, level_chunk=8, megachunk=1, window=True)
    ref = stencil.StencilEngine(
        stencil.StencilGraph.from_host(g, "cpu"), level_chunk=8, megachunk=1,
        window=True,
    )
    got, want = win.query_stats(queries), ref.query_stats(queries)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(x, y)
    assert win.last_window_trace == ref.last_window_trace
    assert any(rows < n for *_, rows in win.last_window_trace)


def test_cli_on_card(cuda, tmp_path, capsys):
    n, edges = generators.road_edges(40, 40, seed=9)
    gpath, qpath = tmp_path / "g.bin", tmp_path / "q.bin"
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, 9, max_group=6, seed=9))
    argv = ["prog", "-g", str(gpath), "-q", str(qpath), "-gn", "1"]
    assert cli.main(argv) == 0
    card = capsys.readouterr().out.splitlines()
    assert cli.main(argv, device="cpu") == 0
    host = capsys.readouterr().out.splitlines()
    assert card[:5] == host[:5]


def _skewed_tile_graph(seed, scale=12, extra=700):
    """RMAT edges (row tiles of very different tile counts) below a run of
    isolated vertices (row tiles without any tile)."""
    n, edges = generators.rmat_edges(scale, edge_factor=8, seed=seed)
    return CSRGraph.from_edges(n + extra, edges)


@pytest.mark.parametrize("t", [32, 64, 96, 128])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 8])
def test_tile_hits_matches_plain(cuda, t, w):
    """Both variants the plan can take for the shape — pipe on an aligned
    frontier plane (with a cut of the tile lists where the plan makes one),
    simple on a plane off the 16-byte grid — against the plain version;
    a push level leaves the hit plane untouched in both."""
    g = _skewed_tile_graph(t + w)
    mg = mxu.MxuGraph.from_host(g, cuda, tile=t)
    counts = (mg.row_ptr[1:] - mg.row_ptr[:-1]).cpu()
    assert int(counts.min()) == 0 and int(counts.max()) > float(counts.float().mean())
    rng = np.random.default_rng(30 + w)
    frontier = _planes(rng, mg.n_pad, w)
    frontier[rng.random(mg.n_pad) < 0.6] = 0
    args = (mg.tiles, mg.tile_row, mg.tile_col, mg.row_ptr)
    go = torch.tensor([1, 5, 0, bitbell.DIR_MATMUL], dtype=torch.int32)
    push = torch.tensor([1, 5, 0, bitbell.DIR_PUSH], dtype=torch.int32, device=cuda)
    want = torch.zeros_like(frontier)
    cuda_mxu.tile_matmul_hits_plain(
        *(a.cpu() for a in args), frontier, want, go, 100
    )
    plan = cuda_mxu.tile_plan(mg.ntr, mg.nt, t, w)
    assert plan.variant == "pipe"
    if t >= 64 and w <= 2:
        assert plan.split > 1  # few row tiles with long lists: the lists are cut
    aligned = frontier.to(cuda)
    shifted = torch.zeros(mg.n_pad * w + 1, dtype=torch.int32, device=cuda)
    off_grid = shifted[1:].view(mg.n_pad, w)
    off_grid.copy_(aligned)
    assert aligned.data_ptr() % 16 == 0 and off_grid.data_ptr() % 16 == 4
    timing.reset_launch_counts()
    for plane, label in ((aligned, plan.label), (off_grid, "simple")):
        got = torch.full_like(aligned, 7)
        cuda_mxu.tile_matmul_hits(*args, plane, got, go.to(cuda), 100)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), label
        assert timing.variant_counts()[f"tile_hits:{label}"] == 1
        # A push level leaves the hit plane untouched (the zeroing too).
        stale = torch.full_like(got, 7)
        cuda_mxu.tile_matmul_hits(*args, plane, stale, push, 100)
        assert bool((stale == 7).all()), label


def test_tile_hits_empty_row_tiles_and_no_tiles(cuda):
    # A path over the first 64 vertices only: row tiles 2.. have no tile.
    edges = np.array([[i, i + 1] for i in range(63)], dtype=np.int32)
    for n, e in ((256, edges), (256, np.zeros((0, 2), np.int32))):
        mg = mxu.MxuGraph.from_host(CSRGraph.from_edges(n, e), cuda, tile=32)
        frontier = torch.full((mg.n_pad, 1), -1, dtype=torch.int32, device=cuda)
        got = torch.full_like(frontier, 9)
        go = torch.tensor([1, 0, 0, bitbell.DIR_MATMUL], dtype=torch.int32, device=cuda)
        cuda_mxu.tile_matmul_hits(
            mg.tiles, mg.tile_row, mg.tile_col, mg.row_ptr, frontier, got, go
        )
        want = cuda_mxu.bmm_tile_hits(
            mg.tiles, mg.tile_row, mg.tile_col, mg.ntr, frontier
        )
        assert torch.equal(got, want)
        assert not bool(got[64:].any())


def _switch_for(frontier, count, row_limit=None, edge_limit=10**9):
    """A switch state listing ``frontier``'s rows (its plain epilogue) and
    the control it leaves, on the frontier's device."""
    rows = count.shape[0]
    switch = bitbell.PushSwitch.new(count, rows if row_limit is None else row_limit,
                                    edge_limit, frontier.shape[1])
    ctrl = torch.tensor([1, 5, 0, 0], dtype=torch.int32, device=count.device)
    bitbell.switch_record(switch, frontier, ctrl)
    return switch, ctrl


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
def test_push_or_matches_plain(cuda, w):
    n, edges = generators.rmat_edges(11, edge_factor=8, seed=40 + w)
    mg = mxu.MxuGraph.from_host(CSRGraph.from_edges(n, edges), cuda, tile=64)
    rng = np.random.default_rng(40 + w)
    frontier = _planes(rng, mg.n_pad, w)
    frontier[rng.random(mg.n_pad) < 0.95] = 0
    frontier = frontier.to(cuda)
    switch, go = _switch_for(frontier, mg.count)
    assert int(go[3]) == bitbell.DIR_PUSH
    want = torch.zeros_like(frontier)
    got = torch.zeros_like(frontier)
    bitbell.sparse_hits_or_plain(frontier, mg.start, mg.vals, want, go, switch, 100)
    timing.reset_launch_counts()
    bitbell.sparse_hits_or(frontier, mg.start, mg.vals, got, go, switch, 100)
    torch.cuda.synchronize()
    assert timing.launch_counts() == {"push_or": 1}
    assert torch.equal(got, want) and bool(want.any())
    stale = torch.full_like(got, 3)
    matmul = go.clone()
    matmul[3] = bitbell.DIR_MATMUL
    bitbell.sparse_hits_or(frontier, mg.start, mg.vals, stale, matmul, switch, 100)
    assert bool((stale == 3).all())  # a matmul level: untouched


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("edge_limit", [256, 10**6])
def test_push_or_list_order_with_a_step_ending_a_row(cuda, w, edge_limit):
    """push_or on a worklist whose order has a row ending exactly at a
    step's last edge, then 32 and more rows of one edge: the next step
    must start at the entry of its own first edge (a walk that starts it
    at the previous step's last entry reads one edge from the wrong row)."""
    rng = np.random.default_rng(w)
    rows = 3000
    deg = rng.integers(1, 4, size=rows).astype(np.int32)
    deg[0], deg[1:41] = 32, 1
    start = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int32)
    vals = rng.integers(0, rows, size=int(deg.sum())).astype(np.int32)
    frontier = _planes(rng, rows, w)
    listed = np.arange(rows, dtype=np.int32)
    listed[41:] = rng.permutation(listed[41:])
    offs = (np.cumsum(deg[listed]) - deg[listed]).astype(np.int32)
    count = torch.from_numpy(deg).to(cuda)
    switch = bitbell.PushSwitch.new(count, rows, edge_limit, w)
    switch.worklist[0] = torch.from_numpy(listed).to(cuda)
    switch.worklist[1] = torch.from_numpy(offs).to(cuda)
    switch.state[bitbell.SW_LISTED] = rows
    switch.state[bitbell.SW_LISTED_EDGES] = int(deg.sum())
    go = torch.tensor([1, 5, 0, bitbell.DIR_PUSH], dtype=torch.int32, device=cuda)
    args = (frontier.to(cuda), torch.from_numpy(start).to(cuda), torch.from_numpy(vals).to(cuda))
    want = torch.zeros((rows, w), dtype=torch.int32, device=cuda)
    got = torch.zeros_like(want)
    bitbell.sparse_hits_or_plain(*args, want, go, switch, 100)
    bitbell.sparse_hits_or(*args, got, go, switch, 100)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool(want.any())


def test_push_or_hub_row_spans_many_warps(cuda):
    """A hub row of 70,000 neighbours among thin rows: its edges spread
    over many warps' shares, and the result equals the plain version's."""
    n = 80_000
    rng = np.random.default_rng(5)
    hub = np.stack([np.full(70_000, 7, np.int32), np.arange(70_000, dtype=np.int32) + 9000], 1)
    thin = rng.integers(0, n, size=(40_000, 2)).astype(np.int32)
    g = CSRGraph.from_edges(n, np.concatenate([hub, thin]))
    bg = BellGraph.from_host(g, cuda)
    start, count, vals = bg.sparse
    assert int(count[7]) == 70_000
    for w in (1, 2, 8):
        frontier = _planes(rng, n, w)
        frontier[rng.random(n) < 0.99] = 0
        frontier[7] = torch.from_numpy(np.arange(1, w + 1, dtype=np.int32))
        frontier = frontier.to(cuda)
        switch, go = _switch_for(frontier, count)
        want, got = torch.zeros_like(frontier), torch.zeros_like(frontier)
        bitbell.sparse_hits_or_plain(frontier, start, vals, want, go, switch)
        bitbell.sparse_hits_or(frontier, start, vals, got, go, switch)
        torch.cuda.synchronize()
        assert torch.equal(got, want), w
        assert int((want[9000:79000] != 0).any(dim=1).sum()) == 70_000


_SWITCH_FIELDS = _APPLY_FIELDS


def _switched_pair(rng, rows, w, dev, row_limit, edge_limit, sentinel=0):
    """Two equal switched carries (plain on the card, kernel on the card)
    over random planes and out-degrees; the kernel's worklist is a view of
    a buffer ``sentinel`` words longer, filled with -7."""
    count = torch.from_numpy(rng.integers(0, 9, size=rows).astype(np.int32)).to(dev)
    state = rng.bit_generator.state
    pair = []
    for i in range(2):
        rng.bit_generator.state = state
        carry = _apply_carry(rng, rows, w, dev)
        switch = bitbell.PushSwitch.new(count, row_limit, edge_limit, w)
        if i == 1 and sentinel:
            cap = switch.capacity
            buf = torch.full((2 * cap + sentinel,), -7, dtype=torch.int32, device=dev)
            switch.worklist = buf[: 2 * cap].view(2, cap)
            switch.buffer = buf
        carry.switch = switch
        pair.append(carry)
    return pair


def _assert_switch_equal(got, want):
    """Carry, control and state; for a whole list (every active row with
    out-edges listed) the worklist as a set, with offsets that are the
    exclusive prefix of the out-degrees in the kernel's list order, and
    the listed edges (exact only then)."""
    for field in _SWITCH_FIELDS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    gs, ws = got.switch, want.switch
    keep = [bitbell.SW_LISTED, bitbell.SW_ACTIVE_ROWS, bitbell.SW_ACTIVE_EDGES, 4, 5, 6, 7]
    assert torch.equal(gs.state[keep], ws.state[keep]), (gs.state, ws.state)
    if int(ws.state[bitbell.SW_ACTIVE_ROWS]) > gs.capacity:
        return
    assert torch.equal(gs.state, ws.state), (gs.state, ws.state)
    length = int(ws.state[bitbell.SW_LISTED])
    rows = gs.worklist[0, :length].long()
    assert torch.equal(torch.sort(rows).values, ws.worklist[0, :length].long())
    deg = gs.count[rows].long()
    assert torch.equal(gs.worklist[1, :length].long(), torch.cumsum(deg, 0) - deg)


@pytest.mark.parametrize(
    "rows,w,variant",
    [
        (7777, 1, "vector/W1/vec16/switch"),
        (7778, 2, "vector/W2/vec16/switch"),
        (7777, 4, "vector/W4/vec16/switch"),
        (7777, 8, "vector/W8/vec16/switch"),
        (7777, 3, "rows/Wn/vec4/switch"),
        (4099, 5, "rows/Wn/vec4/switch"),
        (1_000_003, 2, "vector/W2/vec16/switch"),
    ],
)
def test_switched_apply_matches_plain_over_levels(cuda, rows, w, variant):
    """Four consecutive levels (the accumulators reset between them) on
    thin and dense hit planes, pulled then pushed then pulled then pushed
    (the row limit at a tenth of the rows: a thin frontier pushes next, a
    dense one overflows the list and pulls): carry, ctrl[3], state and
    worklist equal the plain epilogue's; a pushed level's plane (the
    switch's) is zero after it, a pulled level's is left as it was."""
    rng = np.random.default_rng(rows + w)
    want, got = _switched_pair(rng, rows, w, cuda, rows // 10, 10**9)
    for density, direction in ((0.001, 0), (0.3, 1), (0.02, 0), (0.0005, 1)):
        assert int(got.ctrl[3]) == int(want.ctrl[3]) == direction
        hits = _planes(rng, rows, w)
        hits[rng.random(rows) >= density] = 0
        junk = _planes(rng, rows, w).to(cuda)
        planes = []
        for carry in (want, got):
            if direction == bitbell.DIR_PUSH:
                carry.switch.hits.copy_(hits)
                planes.append(junk.clone())  # the pull's plane: never read
            else:
                planes.append(hits.clone().to(cuda))
        before = planes[1].clone()
        bitbell.bit_level_apply_plain(want, planes[0], 100)
        timing.reset_launch_counts()
        bitbell.bit_level_apply(got, planes[1], 100)
        torch.cuda.synchronize()
        assert timing.variant_counts() == {f"level_apply:{variant}": 1}
        _assert_switch_equal(got, want)
        assert torch.equal(planes[1], before)
        assert not bool(got.switch.hits.any()) and not bool(want.switch.hits.any())


@pytest.mark.parametrize("w", [1, 3, 8])
def test_switched_apply_limits_and_overflow(cuda, w):
    """The predicate at its limits and one over, and a list that
    overflows: more active rows than capacity decides pull, lists exactly
    capacity rows and writes nothing past the buffer."""
    rows = 5000
    rng = np.random.default_rng(70 + w)
    hits = _planes(rng, rows, w)
    hits[rng.random(rows) >= 0.05] = 0

    def pair(row_limit, edge_limit, sentinel=0):  # the same carries each time
        return _switched_pair(np.random.default_rng(700 + w), rows, w, cuda,
                              row_limit, edge_limit, sentinel)

    # Probe run: the frontier's active rows and edges.
    probe, _ = pair(rows, 10**9)
    bitbell.bit_level_apply_plain(probe, hits.clone().to(cuda), 100)
    active = int(probe.switch.state[bitbell.SW_ACTIVE_ROWS])
    edges = int(probe.switch.state[bitbell.SW_ACTIVE_EDGES])
    assert active > 32
    for row_limit, edge_limit, direction in (
        (active, edges, bitbell.DIR_PUSH),
        (active - 1, edges, bitbell.DIR_PULL),
        (active, edges - 1, bitbell.DIR_PULL),
        (active // 3, 10**9, bitbell.DIR_PULL),  # overflow
        (0, 10**9, bitbell.DIR_PULL),  # budget 0: an empty list
    ):
        want, got = pair(row_limit, edge_limit, sentinel=64)
        bitbell.bit_level_apply_plain(want, hits.clone().to(cuda), 100)
        bitbell.bit_level_apply(got, hits.clone().to(cuda), 100)
        torch.cuda.synchronize()
        assert int(got.ctrl[3]) == direction
        assert bool((got.switch.buffer[-64:] == -7).all())
        for field in _SWITCH_FIELDS:
            assert torch.equal(getattr(got, field), getattr(want, field)), field
        # The listed edges are exact only for a whole list (what a push
        # reads); the counts and the scratch words are exact always.
        keep = [bitbell.SW_LISTED, bitbell.SW_ACTIVE_ROWS, bitbell.SW_ACTIVE_EDGES, 4, 5, 6, 7]
        assert torch.equal(got.switch.state[keep], want.switch.state[keep])
        length = int(got.switch.state[bitbell.SW_LISTED])
        assert length == min(got.switch.capacity, int(want.switch.state[bitbell.SW_LISTED]))
        listed = got.switch.worklist[0, :length].long()
        assert int(torch.unique(listed).numel()) == length
        assert bool(((got.frontier[listed] != 0).any(dim=1) & (got.switch.count[listed] > 0)).all())
        if direction == bitbell.DIR_PUSH:
            _assert_switch_equal(got, want)


def test_switched_apply_empty_frontier_and_gate(cuda):
    """An all-zero hit plane lists nothing and decides push (0 rows, 0
    edges); a converged carry leaves carry, state and list untouched."""
    rng = np.random.default_rng(3)
    want, got = _switched_pair(rng, 3000, 2, cuda, 100, 100)
    empty = torch.zeros((3000, 2), dtype=torch.int32, device=cuda)
    bitbell.bit_level_apply_plain(want, empty, 100)
    bitbell.bit_level_apply(got, empty.clone(), 100)
    _assert_switch_equal(got, want)
    assert int(got.ctrl[3]) == bitbell.DIR_PUSH and int(got.ctrl[0]) == 0
    snap = got.switch.state.clone()
    hits = _planes(rng, 3000, 2).to(cuda)
    bitbell.bit_level_apply(got, hits, 100)  # converged: a no-op
    assert torch.equal(got.switch.state, snap) and bool(hits.any())


def test_unswitched_apply_leaves_hits(cuda):
    """The stencil route's apply (no switch) neither clears the hit plane
    nor writes ctrl[3]."""
    rng = np.random.default_rng(4)
    carry = _apply_carry(rng, 7777, 1, cuda)
    carry.ctrl[3] = 9
    hits = _planes(rng, 7777, 1).to(cuda)
    before = hits.clone()
    timing.reset_launch_counts()
    bitbell.bit_level_apply(carry, hits, 100)
    assert timing.variant_counts() == {"level_apply:vector/W1/vec16": 1}
    assert torch.equal(hits, before) and int(carry.ctrl[3]) == 9


@pytest.mark.parametrize(
    "k,kwargs",
    [(40, {}), (70, {"switch": 0, "level_chunk": 2}),
     (33, {"switch": 10**9, "push_budget": 10**9}), (300, {"level_chunk": 3})],
)
def test_mxu_engine_kernel_path_matches_plain(cuda, k, kwargs):
    n, edges = generators.rmat_edges(10, edge_factor=8, seed=k)
    g = CSRGraph.from_edges(n, edges)
    queries = io.pad_queries(generators.random_queries(n, k, max_group=5, seed=k))
    want = mxu.MxuEngine(mxu.MxuGraph.from_host(g, "cpu", tile=64), **kwargs)
    mg = mxu.MxuGraph.from_host(g, cuda, tile=64)
    for eng in (
        mxu.MxuEngine(mg, kernel=True, **kwargs),
        mxu.MxuEngine(mg, kernel=False, **kwargs),
        mxu.MxuEngine(mg, plain=True, **kwargs),
    ):
        before = timing.launch_counts()
        for x, y in zip(want.query_stats(queries), eng.query_stats(queries)):
            np.testing.assert_array_equal(x, y)
        after = timing.launch_counts()
        if eng.kernel and not eng.plain:
            assert after.get("tile_hits", 0) > before.get("tile_hits", 0)
        if eng.plain:
            assert after == before


def test_mxu_cli_on_card(cuda, tmp_path, capsys, monkeypatch):
    n, edges = generators.rmat_edges(10, edge_factor=8, seed=9)
    gpath, qpath = tmp_path / "g.bin", tmp_path / "q.bin"
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, 9, max_group=6, seed=9))
    monkeypatch.setenv("MSBFS_BACKEND", "mxu")
    monkeypatch.setenv("MSBFS_MXU_KERNEL", "1")
    argv = ["prog", "-g", str(gpath), "-q", str(qpath), "-gn", "1"]
    assert cli.main(argv) == 0
    card = capsys.readouterr().out.splitlines()
    assert cli.main(argv, device="cpu") == 0
    host = capsys.readouterr().out.splitlines()
    assert card[:5] == host[:5]


def _hub_graph(seed, n=3000):
    """RMAT edges plus a 700-neighbour hub (two forest levels) and
    isolated vertices past the RMAT range."""
    m, edges = generators.rmat_edges(11, edge_factor=8, seed=seed)
    hub = np.stack([np.full(700, 5, np.int32), np.arange(700, dtype=np.int32) + 1200], 1)
    return CSRGraph.from_edges(n, np.concatenate([edges, hub]))


@pytest.mark.parametrize("w", [1, 2, 3, 8])
@pytest.mark.parametrize("widths", [DEFAULT_WIDTHS, (1, 2, 4, 8), (3, 21, 27, 34, 256)])
def test_forest_or_matches_plain(cuda, w, widths):
    g = _hub_graph(50 + w)
    bg = BellGraph.from_host(g, cuda, widths=widths, min_bucket_rows=0)
    bg_cpu = BellGraph.from_host(g, "cpu", widths=widths, min_bucket_rows=0)
    assert len(bg.level_sizes) >= 2
    assert int((bg_cpu.final_slot == bg.total_rows).sum()) > 0  # isolated vertices
    if widths == DEFAULT_WIDTHS:
        assert any(wb == 256 and rb for rb, wb in bg.level_shapes[0])
    rng = np.random.default_rng(60 + w)
    frontier = _planes(rng, g.n, w)
    frontier[rng.random(g.n) < 0.7] = 0
    pull = torch.tensor([1, 5, 0, bitbell.DIR_PULL], dtype=torch.int32)
    want = _planes(rng, g.n, w)
    got = want.clone().to(cuda)
    cuda_bell.forest_or_plain(frontier, bg_cpu, want, pull, 100)
    timing.reset_launch_counts()
    cuda_bell.forest_or(frontier.to(cuda), bg, got, pull.to(cuda), 100)
    torch.cuda.synchronize()
    assert timing.launch_counts() == {"forest_or": 1}
    label = cuda_bell.forest_plan(w).label
    assert timing.variant_counts() == {f"forest_or:{label}": 1}
    assert torch.equal(got.cpu(), want)
    # A frontier and hit plane off the 16-byte grid: the 4-byte path.
    shifted = torch.zeros(2 * g.n * w + 1, dtype=torch.int32, device=cuda)
    f_off = shifted[1 : g.n * w + 1].view(g.n, w)
    h_off = shifted[g.n * w + 1 :].view(g.n, w)
    f_off.copy_(frontier.to(cuda))
    cuda_bell.forest_or(f_off, bg, h_off, pull.to(cuda), 100)
    assert torch.equal(h_off.cpu(), want)
    if w in (2, 4, 8):
        label = cuda_bell.forest_plan(w, vec16=False).label
        assert timing.variant_counts()[f"forest_or:{label}"] == 1
    assert torch.equal(want, bitbell.bell_hits_or(frontier, bg_cpu, slot_budget=7))
    # A push level, or a converged carry, leaves the hit plane untouched.
    for ctrl in ([1, 5, 0, bitbell.DIR_PUSH], [0, 5, 0, bitbell.DIR_PULL]):
        stale = torch.full_like(got, 3)
        cuda_bell.forest_or(
            frontier.to(cuda), bg, stale, torch.tensor(ctrl, dtype=torch.int32, device=cuda), 100
        )
        assert bool((stale == 3).all())


@pytest.mark.parametrize("k", [1, 33, 64, 256])
def test_ell_level_matches_plain(cuda, k):
    """A stale level, then steady ones, against both plain versions: the
    level that reads dist whole, and the steady function on carried planes
    (whose planes the kernel's must equal).  One query in five has
    converged; vertex 5 owns 44 virtual rows."""
    g = _hub_graph(70 + k)
    eg = EllGraph.from_host(g, cuda, width=16, tile_rows=100)
    eg_cpu = EllGraph.from_host(g, "cpu", width=16, tile_rows=100)
    assert eg.num_vrows % 256 and int((eg_cpu.cols == g.n).sum()) > 0
    assert int((eg_cpu.vrow_vertex == 5).sum()) > 32
    rng = np.random.default_rng(k)
    level = rng.integers(0, 4, size=k).astype(np.int32)
    dist = rng.integers(-1, 5, size=(k, g.n)).astype(np.int32)
    dist[rng.random((k, g.n)) < 0.5] = -1
    # A state a BFS can reach: no label above the query's level yet.
    dist[dist > level[:, None]] = -1

    def carry(dev):
        c = bfs.DistCarry(
            dist=torch.from_numpy(dist.copy()).to(dev),
            level=torch.from_numpy(level.copy()).to(dev),
            updated=torch.from_numpy((np.arange(k) % 5 != 3).astype(np.int32)).to(dev),
            stop=torch.from_numpy(level + 2).to(dev),
            found=torch.zeros(k, dtype=torch.int32, device=dev),
            ctrl=torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=dev),
        )
        return c

    want, planes_want, got = carry("cpu"), carry("cpu"), carry(cuda)
    timing.reset_launch_counts()
    for _ in range(3):  # the third level is past every query's stop
        cuda_bfs.ell_level_plain(eg_cpu, want)
        cuda_bfs.ell_level_planes_plain(eg_cpu, planes_want)
        cuda_bfs.ell_level(eg, got)
        torch.cuda.synchronize()
        for field in ("dist", "level", "updated", "stop", "found", "ctrl"):
            assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
            assert torch.equal(getattr(planes_want, field), getattr(want, field)), field
        if planes_want.planes.valid:
            for field in ("frontier", "visited", "hits", "aux"):
                assert torch.equal(
                    getattr(got.planes, field).cpu(), getattr(planes_want.planes, field)
                ), field
    assert int(got.ctrl[0]) == 0
    w = -(-k // 32)
    label = f"W{w}" if w in (1, 2, 4, 8) else "Wn"
    assert timing.variant_counts() == {
        f"ell_hits:stale/{label}": 1, f"ell_hits:steady/{label}": 2,
    }
    # Someone else rewrites dist: the next level is a stale one again.
    for c in (want, got):
        c.dist.copy_(torch.from_numpy(dist))
        c.level.copy_(torch.from_numpy(level))
        c.stop.copy_(torch.from_numpy(level + 1))
        c.ctrl[0] = 1
    got.touch()
    cuda_bfs.ell_level_plain(eg_cpu, want)
    cuda_bfs.ell_level(eg, got)
    torch.cuda.synchronize()
    for field in ("dist", "level", "updated", "stop", "found", "ctrl"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
    assert timing.variant_counts()[f"ell_hits:stale/{label}"] == 2


@pytest.mark.parametrize(
    "k,kwargs", [(1, {}), (40, {"level_chunk": 3}), (70, {"sparse_budget": 0}), (300, {"level_chunk": 2})]
)
def test_bitbell_engine_kernel_path_matches_plain(cuda, k, kwargs):
    g = _hub_graph(k)
    queries = io.pad_queries(generators.random_queries(g.n, k, max_group=5, seed=k))
    want = bitbell.BitBellEngine(BellGraph.from_host(g, "cpu"), **kwargs).query_stats(queries)
    bg = BellGraph.from_host(g, cuda)
    for plain in (True, False):
        before = timing.launch_counts()
        got = bitbell.BitBellEngine(bg, plain=plain, **kwargs).query_stats(queries)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(x, y)
        after = timing.launch_counts()
        assert (after == before) if plain else after["forest_or"] > before.get("forest_or", 0)


@pytest.mark.parametrize("k,level_chunk", [(1, None), (33, 2), (70, None)])
def test_ell_engine_kernel_path_matches_plain(cuda, k, level_chunk):
    g = _hub_graph(k + 1)
    queries = io.pad_queries(generators.random_queries(g.n, k, max_group=5, seed=k))
    want = engine.Engine(EllGraph.from_host(g, "cpu"), level_chunk=level_chunk).query_stats(queries)
    eg = EllGraph.from_host(g, cuda)
    for plain in (True, False):
        got = engine.Engine(eg, level_chunk=level_chunk, plain=plain).query_stats(queries)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_bitbell_and_ell_cli_on_card(cuda, tmp_path, capsys, monkeypatch, backend):
    n, edges = generators.rmat_edges(10, edge_factor=8, seed=9)
    gpath, qpath = tmp_path / "g.bin", tmp_path / "q.bin"
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, 40, max_group=6, seed=9))
    monkeypatch.setenv("MSBFS_BACKEND", backend)
    argv = ["prog", "-g", str(gpath), "-q", str(qpath), "-gn", "1"]
    timing.reset_launch_counts()
    assert cli.main(argv) == 0
    kernel = "ell_hits" if backend == "pallas" else "forest_or"
    assert timing.launch_counts().get(kernel, 0) > 0
    card = capsys.readouterr().out.splitlines()
    assert cli.main(argv, device="cpu") == 0
    host = capsys.readouterr().out.splitlines()
    assert card[:5] == host[:5]


def _pack_case(case, n, k, s, rng):
    """Queries for the pack tests: duplicates within a group and across
    groups, -1 padding and sources at and past n."""
    q = rng.integers(-3, n + 4, size=(k, s)).astype(np.int32)
    if case == "duplicates" and k and s:
        q[:, -1] = q[:, 0]
        q[k // 2] = q[0]
    elif case == "out_of_range" and k and s:
        q[:, ::2] = -1
        q[0, 0] = n
        q[-1, -1] = n - 1
    return q


@pytest.mark.parametrize("stride", [1, 8])
@pytest.mark.parametrize(
    "case,k,s",
    [("random", 1, 1), ("random", 3, 40), ("duplicates", 4, 9), ("out_of_range", 64, 128),
     ("duplicates", 256, 7), ("random", 3, 0), ("random", 0, 5), ("random", 16, 300)],
)
def test_pack_sources_matches_plain(cuda, stride, case, k, s):
    """The pack kernel against its plain version, bit for bit, plane and
    per-lane counts; an empty batch launches nothing."""
    n = 5000
    q = _pack_case(case, n, k, s, np.random.default_rng(k * 7 + s + stride))
    want = bitbell.pack_queries_plain(n, q, "cpu", stride)
    timing.reset_launch_counts()
    got = bitbell.pack_queries(n, q, cuda, stride)
    torch.cuda.synchronize()
    assert timing.launch_counts() == ({"pack_sources": 1} if k * s else {})
    assert timing.variant_counts() == ({f"pack_sources:stride{stride}": 1} if k * s else {})
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    assert torch.equal(bitbell.pack_queries_plain(n, q, cuda, stride)[0].cpu(), want[0])


@pytest.mark.parametrize("k", [1, 3, 4, 8, 64])
def test_byte_forest_and_push_match_plain(cuda, k):
    """The forest and push kernels over byte planes' word views against
    the byte pull's and push's plain versions (amax over bytes)."""
    g = _hub_graph(90 + k)
    bg = BellGraph.from_host(g, cuda)
    rng = np.random.default_rng(k)
    kp = max(4, -(-k // 4) * 4)
    flags = np.zeros((g.n, kp), dtype=np.uint8)
    flags[:, :k] = rng.random((g.n, k)) < 0.2
    frontier = torch.from_numpy(flags).to(cuda)
    pull = torch.tensor([1, 5, 0, bitbell.DIR_PULL], dtype=torch.int32, device=cuda)
    want = torch.full_like(frontier, 9)
    got = torch.full_like(frontier, 9)
    bell.bell_hits_packed_plain(frontier, bg, want, pull, 100)
    timing.reset_launch_counts()
    bell.bell_hits_packed(frontier, bg, got, pull, 100)
    torch.cuda.synchronize()
    assert timing.launch_counts() == {"forest_or": 1}
    assert torch.equal(got, want) and not bool(got[:, k:].any())
    thin = frontier.clone()
    thin[torch.from_numpy(rng.random(g.n) < 0.97).to(cuda)] = 0
    thin[5, 0] = 1  # the 700-neighbour hub
    switch, go = _switch_for(bell.byte_words(thin), bg.sparse[1])
    assert int(go[3]) == bitbell.DIR_PUSH
    want = torch.zeros_like(thin)
    got = torch.zeros_like(thin)
    lowk.sparse_hits_flags_plain(thin, bg, want, go, switch, 100)
    timing.reset_launch_counts()
    lowk.sparse_hits_flags(thin, bg, got, go, switch, 100)
    torch.cuda.synchronize()
    assert timing.launch_counts() == {"push_or": 1}
    assert torch.equal(got, want) and bool(want.any()) and not bool(got[:, k:].any())


@pytest.mark.parametrize(
    "k,kwargs",
    [(1, {}), (3, {"level_chunk": 1}), (4, {"sparse_budget": 300}), (2, {"sparse_budget": 0}),
     (40, {"level_chunk": 3})],
)
def test_lowk_engine_on_card_matches_plain(cuda, k, kwargs):
    """LowKEngine's kernel path against its plain path on the card, level
    by level (planes, counters, control and the push's plane), then its
    results against the CPU engine's."""
    g = _hub_graph(70 + k)
    queries = io.pad_queries(generators.random_queries(g.n, k, max_group=5, seed=k))
    bg = BellGraph.from_host(g, cuda)
    fast = lowk.LowKEngine(bg, **kwargs)
    slow = lowk.LowKEngine(bg, plain=True, **kwargs)
    a = fast._init_carry(fast._pad_queries(queries)[0])
    b = slow._init_carry(slow._pad_queries(queries)[0])
    levels = 0
    while bitbell.level_go(b.ctrl, 10**6):
        for field in ("visited", "frontier", "f", "levels", "reached", "ctrl"):
            assert torch.equal(getattr(a, field), getattr(b, field)), (levels, field)
        if a.switch is not None:
            assert torch.equal(a.switch.hits, b.switch.hits)
        fast._chunk(a, 1)
        slow._chunk(b, 1)
        levels += 1
    torch.cuda.synchronize()
    assert levels >= 2 and torch.equal(a.f, b.f) and torch.equal(a.ctrl[:2], b.ctrl[:2])
    want = lowk.LowKEngine(BellGraph.from_host(g, "cpu"), **kwargs).query_stats(queries)
    for x, y in zip(fast.query_stats(queries), want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("backend,k", [("auto", 1), ("auto", 4), ("lowk", 40), ("bell", 40)])
def test_lowk_and_bell_cli_on_card(cuda, tmp_path, capsys, monkeypatch, backend, k):
    n, edges = generators.rmat_edges(10, edge_factor=8, seed=9)
    gpath, qpath = tmp_path / "g.bin", tmp_path / "q.bin"
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, k, max_group=6, seed=9))
    monkeypatch.setenv("MSBFS_BACKEND", backend)
    argv = ["prog", "-g", str(gpath), "-q", str(qpath), "-gn", "1"]
    timing.reset_launch_counts()
    assert cli.main(argv) == 0
    counts = timing.launch_counts()
    assert counts.get("pack_sources", 0) > 0 and counts.get("flag_pull", 0) > 0
    assert "forest_or" not in counts  # the byte routes pull with their own kernel
    card = capsys.readouterr().out.splitlines()
    assert cli.main(argv, device="cpu") == 0
    host = capsys.readouterr().out.splitlines()
    assert card[:5] == host[:5]


def _byte_planes(rng, n, kp, k, density, visited, active):
    """A byte frontier with ``density`` of its (vertex, real lane) flags
    set in the ``active`` lanes only, and visited flags: "none", "some"
    (the frontier and a share of the rest) or "all" real lanes."""
    frontier = np.zeros((n, kp), dtype=np.uint8)
    frontier[:, :k] = rng.random((n, k)) < density
    frontier[:, ~active] = 0
    seen = np.zeros_like(frontier)
    if visited == "all":
        seen[:, :k] = 1
    elif visited == "some":
        seen[:, :k] = frontier[:, :k] | (rng.random((n, k)) < 0.5)
    return torch.from_numpy(frontier), torch.from_numpy(seen)


@pytest.mark.parametrize("kp,k", [(4, 1), (4, 3), (64, 64), (64, 61), (24, 22)])
@pytest.mark.parametrize("widths", [DEFAULT_WIDTHS, (1, 2, 4, 8)])
@pytest.mark.parametrize("bitmap", [True, False])
def test_flag_pull_matches_plain(cuda, monkeypatch, kp, k, widths, bitmap):
    """The byte pull against its plain version, bit for bit, at W = 1
    (with and without the bits instance), W = 16 and the generic width,
    over forests with hub rows (wide, or three levels deep) and isolated
    vertices; dense and empty frontiers; no, some and all real lanes
    visited; every lane active or half of them (the carry's counters);
    one scratch through every case, so rows that are not live keep older
    values; with the bitmap in shared memory and without."""
    if not bitmap:
        monkeypatch.setattr(cuda_flag_pull, "BLOCK_SMEM_BYTES", 0)
    g = _hub_graph(40 + kp + k)
    bg = BellGraph.from_host(g, cuda, widths=widths, min_bucket_rows=0)
    bg_cpu = BellGraph.from_host(g, "cpu", widths=widths, min_bucket_rows=0)
    assert len(bg.level_sizes) >= 2
    assert int((bg.final_slot == bg.total_rows).sum()) > 0  # isolated vertices
    rng = np.random.default_rng(kp + k)
    scratch = cuda_flag_pull.flag_pull_scratch(bg, kp // 4, cuda)
    ctrl = torch.tensor([1, 5, 0, bitbell.DIR_PULL], dtype=torch.int32, device=cuda)
    plan = cuda_flag_pull.flag_pull_plan(kp // 4, g.n, k)
    assert plan.bitmap == bitmap and plan.bits == (bitmap and kp == 4 and k == 1)
    for lanes in ("all", "half"):
        active = np.arange(kp) < k
        if lanes == "half":
            active &= np.arange(kp) % 2 == 0
        levels = torch.zeros(8 * kp, dtype=torch.int32)
        levels[::8] = torch.from_numpy(np.where(active, 6, 3).astype(np.int32))
        for density in (0.3, 0.0):
            for visited in ("none", "some", "all"):
                f, v = _byte_planes(rng, g.n, kp, k, density, visited, active)
                want = torch.full_like(f, 9)
                cuda_flag_pull.flag_pull_plain(f, v, bg_cpu, want, ctrl.cpu(), k)
                got = torch.full_like(f, 9).to(cuda)
                timing.reset_launch_counts()
                cuda_flag_pull.flag_pull(f.to(cuda), v.to(cuda), bg, got, ctrl, k, 100, scratch,
                                         levels.to(cuda) if lanes == "half" else None)
                torch.cuda.synchronize()
                assert timing.launch_counts() == {"flag_pull": 1}
                assert timing.variant_counts() == {f"flag_pull:{plan.label}": 1}
                assert torch.equal(got.cpu(), want), (lanes, density, visited)
    # A push level, or a converged carry, leaves the hit plane untouched.
    for c in ([1, 5, 0, bitbell.DIR_PUSH], [0, 5, 0, bitbell.DIR_PULL], [1, 100, 0, 0]):
        stale = torch.full((g.n, kp), 3, dtype=torch.uint8, device=cuda)
        cuda_flag_pull.flag_pull(f.to(cuda), v.to(cuda), bg, stale,
                                 torch.tensor(c, dtype=torch.int32, device=cuda), k, 100, scratch)
        assert bool((stale == 3).all())
    # Planes off the 16-byte grid: the W = 16 instance's 4-byte loads.
    if kp == 64:
        f, v = _byte_planes(rng, g.n, kp, k, 0.3, "some", np.arange(kp) < k)
        want = torch.empty_like(f)
        cuda_flag_pull.flag_pull_plain(f, v, bg_cpu, want, ctrl.cpu(), k)
        shifted = torch.zeros(3 * g.n * kp + 4, dtype=torch.uint8, device=cuda)
        views = [shifted[4 + i * g.n * kp : 4 + (i + 1) * g.n * kp].view(g.n, kp)
                 for i in range(3)]
        views[0].copy_(f)
        views[1].copy_(v)
        timing.reset_launch_counts()
        cuda_flag_pull.flag_pull(views[0], views[1], bg, views[2], ctrl, k, 100, scratch)
        assert torch.equal(views[2].cpu(), want)
        label = cuda_flag_pull.flag_pull_plan(16, g.n, k, vec16=False).label
        assert timing.variant_counts() == {f"flag_pull:{label}": 1} and "vec4" in label

