"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips with a reason where there is no CUDA
device (the CPU test run); on a GPU machine run
``python -m pytest tests/test_torch_cuda.py -m cuda -q``.  Every
comparison is exact — all values are bits and integers.
"""

from itertools import product

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
    cuda_csr,
    cuda_flag_pull,
    cuda_halo,
    cuda_mesh,
    cuda_mxu,
    cuda_push,
    cuda_stencil,
    cuda_weighted,
    dense,
    engine,
    lowk,
    mxu,
    packed,
    push,
    push_packed,
    stencil,
    streamed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    partition2d,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
    kernels,
    supervisor,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    io,
    timing,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import (
    weighted,
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
    it) and one apply, nothing else; the batch's start is one launch."""
    n, edges = generators.road_edges(48, 48, seed=5, shortcut_frac=0.01)
    sg = stencil.StencilGraph.from_host(CSRGraph.from_edges(n, edges), cuda)
    assert sg.residual is not None
    eng = stencil.StencilEngine(sg, level_chunk=8)
    queries = io.pad_queries(generators.random_queries(n, 20, max_group=5, seed=3))
    timing.reset_launch_counts()
    eng.query_stats(queries)
    counts = timing.launch_counts()
    assert set(counts) == {"batch_start", "stencil_sweep", "level_apply"}
    assert counts["stencil_sweep"] == counts["level_apply"] and counts["batch_start"] == 1
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


@pytest.mark.parametrize("w", [1, 2, 3, 8])
@pytest.mark.parametrize("slot_budget", [None, 700])
def test_forest_segment_matches_plain(cuda, w, slot_budget):
    """K1's segment form: one host-streamed forest pass (every segment
    through the ring, then the final gather) against the plain pass on
    the CPU, with one launch a segment and one gather; gated off, nothing
    is written; a frontier off the vector grid takes the scalar path."""
    g = _hub_graph(80 + w)
    host = BellGraph.from_host(g, False)
    eng = streamed.StreamedBitBellEngine(host, cuda, slot_budget=slot_budget)
    ref = streamed.StreamedBitBellEngine(host, "cpu", slot_budget=slot_budget)
    assert len(eng._segments) >= (2 if slot_budget is None else 4)
    rng = np.random.default_rng(90 + w)
    frontier = _planes(rng, g.n, w)
    frontier[rng.random(g.n) < 0.7] = 0
    pull = torch.tensor([1, 5, 0, bitbell.DIR_PULL], dtype=torch.int32)
    want = torch.empty_like(frontier)
    ref.forest_pass(frontier, want, pull)
    assert torch.equal(want, bitbell.bell_hits_or(frontier, BellGraph.from_host(g, "cpu")))
    got = torch.full_like(frontier, 9, device=cuda)
    timing.reset_launch_counts()
    with eng._streams():
        eng.forest_pass(frontier.to(cuda), got, pull.to(cuda))
    torch.cuda.synchronize()
    assert timing.launch_counts() == {
        "forest_map": 1, "forest_segment": len(eng._segments), "forest_gather": 1,
    }
    level0 = sum(1 for seg in eng._segments if seg.level == 0)
    assert sum(c for name, c in timing.variant_counts().items()
               if name.startswith("forest_segment:") and name.endswith("/map")) == level0
    assert torch.equal(got.cpu(), want)
    assert torch.equal(eng._scratch[w].cpu(), ref._scratch[w])
    shifted = torch.zeros(g.n * w + 1, dtype=torch.int32, device=cuda)
    f_off = shifted[1:].view(g.n, w)
    f_off.copy_(frontier.to(cuda))
    got.fill_(9)
    eng.forest_pass(f_off, got, pull.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for ctrl in ([1, 5, 0, bitbell.DIR_PUSH], [0, 5, 0, bitbell.DIR_PULL]):
        stale = torch.full_like(got, 3)
        eng.forest_pass(frontier.to(cuda), stale, torch.tensor(ctrl, dtype=torch.int32, device=cuda))
        assert bool((stale == 3).all())


def _thin_or_dense(rng, n, w, share):
    frontier = _planes(rng, n, w)
    frontier[rng.random(n) >= share] = 0
    return frontier


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("instance", ["map", "gmap", "nomap"])
@pytest.mark.parametrize("slot_budget", [None, 700])
def test_segment_instances_match_plain(cuda, monkeypatch, w, instance, slot_budget):
    """Every instance of the segment launch (map, gmap forced by the plan,
    nomap) on every segment of a streamed pass, at whole levels and
    700-slot cuts, equals the plain segment on empty, thin, dense and
    full frontiers, with the map (a bit a vertex, and a bit per two) read
    (a dense share of 1) and skipped by the device sums (a share below
    0): every output row written."""
    g = _hub_graph(110 + w)
    host = BellGraph.from_host(g, False)
    eng = streamed.StreamedBitBellEngine(host, cuda, slot_budget=slot_budget)
    rng = np.random.default_rng(120 + w)
    pull = torch.tensor([1, 5, 0, bitbell.DIR_PULL], dtype=torch.int32, device=cuda)
    coarse = cuda_bell.frontier_map_scratch(g.n, cuda, eng._map.weights, 1)
    for share, fmap in product((0.0, 0.01, 0.6, 1.0), (eng._map, coarse)):
        frontier = _thin_or_dense(rng, g.n, w, share).to(cuda)
        cuda_bell.frontier_map(frontier, fmap, pull)
        for dense_share in (1.0, -1.0):
            monkeypatch.setattr(cuda_bell, "MAP_DENSE_SHARE", dense_share)
            scratch = torch.full((eng.total_rows + 1, w), 9, dtype=torch.int32, device=cuda)
            ref = torch.zeros_like(scratch)
            for i, seg in enumerate(eng._segments):
                cols = eng._slices[i].to(cuda)
                if seg.level == 0:
                    prev = prev_ref = frontier
                    prev_rows, mapped, forced = g.n, fmap, instance
                else:
                    lo = eng._row_offset[seg.level - 1]
                    prev_rows = eng.level_rows[seg.level - 1]
                    prev, prev_ref = scratch[lo : lo + prev_rows], ref[lo : lo + prev_rows]
                    mapped, forced = None, None
                lo = eng._row_offset[seg.level] + seg.row0
                timing.reset_launch_counts()
                cuda_bell.forest_segment(prev, prev_rows, cols, eng._tables, i,
                                         scratch[lo : lo + seg.rows], pull,
                                         fmap=mapped, instance=forced)
                cuda_bell.forest_segment_plain(prev_ref, prev_rows, cols,
                                               eng._tables.pieces[i],
                                               ref[lo : lo + seg.rows], pull)
                torch.cuda.synchronize()
                label = instance if seg.level == 0 else "nomap"
                assert [k.rsplit("/", 1)[1] for k in timing.variant_counts()] == [label]
            rows = eng.total_rows
            assert torch.equal(scratch[:rows], ref[:rows]), (share, dense_share)


@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_frontier_map_matches_plain_and_gates(cuda, w):
    """The map pre-pass: its bits and sums (rows, and weights) equal the
    plain version's on empty, thin and dense frontiers, again and again
    (its running sums are cleared by each launch), on a frontier off the
    vector grid too; gated off (a push level, a converged carry, the level
    cap) it writes nothing."""
    rng = np.random.default_rng(130 + w)
    for n, shift in product((1, 33, 3000, 70_001), (0, 1)):
        weights = torch.from_numpy(rng.integers(0, 300, n).astype(np.int32))
        want = cuda_bell.frontier_map_scratch(n, "cpu", weights, shift)
        got = cuda_bell.frontier_map_scratch(n, cuda, weights.to(cuda), shift)
        for share in (0.0, 0.01, 0.6, 0.6):
            frontier = _thin_or_dense(rng, n, w, share)
            cuda_bell.frontier_map(frontier, want, _go())
            pull = torch.tensor([1, 5, 0, bitbell.DIR_PULL], dtype=torch.int32, device=cuda)
            timing.reset_launch_counts()
            cuda_bell.frontier_map(frontier.to(cuda), got, pull)
            torch.cuda.synchronize()
            assert timing.launch_counts() == {"forest_map": 1}
            assert torch.equal(got.bits.cpu(), want.bits)
            assert got.counts.cpu().tolist() == want.counts.tolist()
            shifted = torch.zeros(n * w + 1, dtype=torch.int32, device=cuda)
            f_off = shifted[1:].view(n, w)
            f_off.copy_(frontier.to(cuda))
            cuda_bell.frontier_map(f_off, got, pull)
            assert torch.equal(got.bits.cpu(), want.bits)
            assert got.counts.cpu().tolist() == want.counts.tolist()
        for ctrl in ([1, 5, 0, bitbell.DIR_PUSH], [0, 5, 0, bitbell.DIR_PULL],
                     [1, 9, 0, bitbell.DIR_PULL]):
            stale = cuda_bell.frontier_map_scratch(n, cuda, weights.to(cuda), shift)
            stale.bits.fill_(7)
            stale.counts[cuda_bell.ROWS] = 11
            cuda_bell.frontier_map(_planes(rng, n, w).to(cuda), stale,
                                   torch.tensor(ctrl, dtype=torch.int32, device=cuda), 9)
            torch.cuda.synchronize()
            assert bool((stale.bits == 7).all())
            assert stale.counts.cpu().tolist() == [0, 0, 0, 11, 0]


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 5, 4096, 100_003])
def test_forest_gather_matches_plain_and_index_select(cuda, w, n):
    """The final gather (four vertices a thread at a template width)
    equals its plain version and torch.index_select, with vertices on the
    zero row (never read: it is filled with garbage here, so a read would
    show), n not a multiple of four, planes off the 16-byte grid; gated
    off it writes nothing."""
    rng = np.random.default_rng(140 + w + n)
    rows = max(n // 2, 1)
    v_cat = _planes(rng, rows + 1, w)
    final_slot = torch.from_numpy(rng.integers(0, rows + 1, n).astype(np.int32))
    final_slot[torch.from_numpy(rng.random(n) < 0.4)] = rows
    pull = torch.tensor([1, 5, 0, bitbell.DIR_PULL], dtype=torch.int32, device=cuda)
    zeroed = v_cat.clone()
    zeroed[rows] = 0
    want = torch.index_select(zeroed, 0, final_slot.long())
    dv, df = v_cat.to(cuda), final_slot.to(cuda)
    for offset in (0, 1):
        # Fresh tensors (16-byte aligned), then views one word off the grid.
        sizes = ((rows + 1) * w, n * w, n)
        buf = torch.zeros(sum(sizes) + offset, dtype=torch.int32, device=cuda)
        v, h, f = buf[offset:].split(sizes)
        if not offset:
            v, h, f = (torch.empty_like(t) for t in (v, h, f))
        v, h = v.view(rows + 1, w), h.view(n, w)
        v.copy_(dv)
        f.copy_(df)
        timing.reset_launch_counts()
        cuda_bell.forest_final_gather(v, f, h, pull)
        torch.cuda.synchronize()
        assert timing.launch_counts() == {"forest_gather": 1}
        assert torch.equal(h.cpu(), want)
        plain = torch.empty((n, w), dtype=torch.int32, device=cuda)
        v[rows] = 0
        cuda_bell.forest_final_gather_plain(v, f, plain, pull)
        assert torch.equal(plain.cpu(), want)
        assert torch.equal(torch.index_select(v, 0, f).cpu(), want)
    for ctrl in ([1, 5, 0, bitbell.DIR_PUSH], [0, 5, 0, bitbell.DIR_PULL]):
        stale = torch.full((n, w), 3, dtype=torch.int32, device=cuda)
        cuda_bell.forest_final_gather(dv, df, stale,
                                      torch.tensor(ctrl, dtype=torch.int32, device=cuda))
        assert bool((stale == 3).all())


@pytest.mark.parametrize(
    "k,slot_budget,prefetch", [(1, None, 2), (40, 700, 1), (70, 700, 3), (33, None, 1)]
)
def test_streamed_engine_kernel_path_matches_plain(cuda, k, slot_budget, prefetch):
    """The host-streamed engine on the card (kernels, and the plain
    versions on the card's planes) equals the in-memory engine on the
    CPU; from a worker thread too (the watchdog's), whose current stream
    and device are its own."""
    g = _hub_graph(k + 3)
    queries = io.pad_queries(generators.random_queries(g.n, k, max_group=5, seed=k))
    want = bitbell.BitBellEngine(BellGraph.from_host(g, "cpu")).query_stats(queries)
    host = BellGraph.from_host(g, False)
    for plain in (False, True):
        eng = streamed.StreamedBitBellEngine(
            host, cuda, slot_budget=slot_budget, prefetch=prefetch, plain=plain)
        eng.compile(queries.shape)
        for x, y in zip(eng.query_stats(queries), want):
            np.testing.assert_array_equal(x, y)
        f = supervisor.call_with_watchdog(lambda: eng.f_values(queries).cpu(), 60)
        np.testing.assert_array_equal(f.numpy(), want[2])
        assert eng.best(queries) == (int(want[2].min()), int(np.argmin(want[2])))


def test_streamed_and_ladder_cli_on_card(cuda, tmp_path, capsys, monkeypatch):
    """MSBFS_BACKEND=streamed, and the default route stepping down all
    three rungs on injected faults, on the card and on the CPU alike."""
    n, edges = generators.rmat_edges(10, edge_factor=8, seed=19)
    gpath, qpath = tmp_path / "g.bin", tmp_path / "q.bin"
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, 40, max_group=6, seed=19))
    argv = ["prog", "-g", str(gpath), "-q", str(qpath), "-gn", "1"]
    for env in (
        {"MSBFS_BACKEND": "streamed", "MSBFS_SLOT_BUDGET": "5000"},
        {"MSBFS_FAULTS": "oom:dispatch:1,oom:dispatch:2,oom:dispatch:3",
         "MSBFS_LEVEL_CHUNK": "0"},
    ):
        with monkeypatch.context() as mp:
            for key, value in env.items():
                mp.setenv(key, value)
            timing.reset_launch_counts()
            try:
                assert cli.main(argv) == 0
                counts = timing.launch_counts()
                card = capsys.readouterr().out.splitlines()
                assert cli.main(argv, device="cpu") == 0
                host = capsys.readouterr().out.splitlines()
            finally:
                faults.activate(None)
        assert card[:5] == host[:5]
        assert counts.get("forest_segment", 0) > 0 and counts.get("forest_gather", 0) > 0


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
    """The packing of the batch-start kernel against its plain version,
    bit for bit, plane and per-lane counts; one launch, an empty batch's
    too (it writes the control)."""
    n = 5000
    q = _pack_case(case, n, k, s, np.random.default_rng(k * 7 + s + stride))
    want = bitbell.pack_queries_plain(n, q, "cpu", stride)
    timing.reset_launch_counts()
    got = bitbell.pack_queries(n, q, cuda, stride)
    torch.cuda.synchronize()
    assert timing.launch_counts() == {"batch_start": 1}
    assert timing.variant_counts() == {f"batch_start:stride{stride}": 1}
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    assert torch.equal(bitbell.pack_queries_plain(n, q, cuda, stride)[0].cpu(), want[0])


def _assert_batch_start_equal(got, want):
    """Every carry field and the switch state bit for bit; the worklist
    (in the kernel's append order) as a set, each entry's offset the
    exclusive prefix of the out-degrees before it, when the list is whole;
    the switch's hit plane zero."""
    for field in ("visited", "frontier", "f", "levels", "reached", "counts", "ctrl"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field).cpu()), field
    assert got.k == want.k
    assert (got.switch is None) == (want.switch is None)
    if want.switch is None:
        return
    gs, ws = got.switch, want.switch
    assert torch.equal(gs.state.cpu(), ws.state.cpu()), (gs.state, ws.state)
    assert not bool(gs.hits.any()) and gs.capacity == ws.capacity
    length = int(ws.state[bitbell.SW_LISTED])
    if int(ws.state[bitbell.SW_ACTIVE_ROWS]) > gs.capacity:
        return  # a list cut at its capacity: which rows made it is the order's
    rows = gs.worklist[0, :length].long()
    assert torch.equal(torch.sort(rows).values.cpu(), ws.worklist[0, :length].long().cpu())
    deg = gs.count[rows].long()
    assert torch.equal(gs.worklist[1, :length].long(), torch.cumsum(deg, 0) - deg)


@pytest.mark.parametrize("stride", [1, 8])
@pytest.mark.parametrize(
    "case,k,s,row_limit,extra_rows",
    [("random", 1, 1, None, 0), ("duplicates", 4, 9, None, 0), ("out_of_range", 64, 128, None, 0),
     ("duplicates", 96, 7, None, 0), ("random", 16, 300, 40, 0), ("random", 3, 0, None, 0),
     ("random", 0, 5, None, 0), ("random", 33, 20, 10**9, 123), ("out_of_range", 4, 64, 0, 0)],
)
@pytest.mark.parametrize("switched", [False, True])
def test_batch_start_matches_plain(cuda, stride, case, k, s, row_limit, extra_rows, switched):
    """The batch-start kernel against its plain composition (pack,
    bit_level_init, switch_record) on the card: both planes, the counters,
    ctrl, the switch state and the worklist; at both strides, W > 1 (K =
    33, 64, 96), plane rows past n (the mxu route's padding), a list cut
    at its capacity, a zero row limit, empty batches; one launch."""
    n = 5000
    rng = np.random.default_rng(k * 7 + s + stride)
    q = _pack_case(case, n, k, s, rng)
    rows = n + extra_rows
    limits = None
    if switched:
        count = torch.from_numpy(rng.integers(0, 4, size=rows).astype(np.int32)).to(cuda)
        limit = rows if row_limit is None else row_limit
        limits = bitbell.SwitchLimits(count, limit, 300)
    want = bitbell.batch_start(n, q, cuda, stride, rows=rows, switch=limits, plain=True)
    timing.reset_launch_counts()
    got = bitbell.batch_start(n, q, cuda, stride, rows=rows, switch=limits)
    torch.cuda.synchronize()
    assert timing.launch_counts() == {"batch_start": 1}
    label = f"batch_start:stride{stride}" + ("/switch" if switched else "")
    assert timing.variant_counts() == {label: 1}
    _assert_batch_start_equal(got, want)
    if switched and row_limit == 40:
        assert int(want.switch.state[bitbell.SW_ACTIVE_ROWS]) > got.switch.capacity == 40
    # A second batch into fresh buffers from the same staging buffer.
    staging = bitbell.SourceStaging()
    for _ in range(2):
        again = bitbell.batch_start(n, q, cuda, stride, rows=rows, switch=limits, staging=staging)
        _assert_batch_start_equal(again, want)


@pytest.mark.parametrize("k,budget", [(1, 10**6), (3, 300), (4, 700), (9, 300)])
def test_flag_expand_matches_plain_on_push_and_pull_levels(cuda, k, budget):
    """The low-K level's one expansion call (K5's push folded into the
    byte pull's first launch) against the plain push and the plain pull
    on every level of one BFS, both directions: one flag_pull launch a
    level, no push_or; then the engine's stepper, whose call is checked
    once, to the same counters."""
    g = _hub_graph(50 + k)
    bg = BellGraph.from_host(g, cuda)
    queries = io.pad_queries(generators.random_queries(g.n, k, max_group=4, seed=k))
    eng = lowk.LowKEngine(bg, sparse_budget=budget)
    carry = eng._init_carry(eng._pad_queries(queries)[0])
    w = carry.frontier.shape[1]
    scratch = cuda_flag_pull.flag_pull_scratch(bg, w, cuda)
    hits = torch.zeros_like(carry.frontier)
    u8 = torch.uint8
    seen = set()
    while bitbell.level_go(carry.ctrl, 10**6):
        d = int(carry.ctrl[3])
        seen.add(d)
        sw = carry.switch
        want = torch.zeros_like(carry.frontier)
        if d == bitbell.DIR_PUSH:
            lowk.sparse_hits_flags_plain(carry.frontier.view(u8), bg, want.view(u8), carry.ctrl, sw)
        else:
            cuda_flag_pull.flag_pull_plain(carry.frontier.view(u8), carry.visited.view(u8), bg,
                                           want.view(u8), carry.ctrl, carry.k)
        timing.reset_launch_counts()
        lowk.flag_expand(carry, bg, hits, 10**6, scratch)
        torch.cuda.synchronize()
        assert timing.launch_counts() == {"flag_pull": 1}
        assert all(v.endswith("/push") for v in timing.variant_counts())
        got = sw.hits if d == bitbell.DIR_PUSH else hits
        assert torch.equal(got, want), (len(seen), d)
        bitbell.bit_level_apply(carry, hits)
        assert not bool(sw.hits.any())
    assert seen == {bitbell.DIR_PUSH, bitbell.DIR_PULL} or budget == 10**6
    fast = eng._init_carry(eng._pad_queries(queries)[0])
    eng._chunk(fast, None)
    torch.cuda.synchronize()
    for field in ("f", "levels", "reached", "ctrl"):
        assert torch.equal(getattr(fast, field), getattr(carry, field)), field


def _route_engines(cuda):
    """One engine of every route that starts batches, on small graphs."""
    road_n, road_e = generators.road_edges(48, 48, seed=5, shortcut_frac=0.01)
    road = CSRGraph.from_edges(road_n, road_e)
    g = _hub_graph(61)
    bg = BellGraph.from_host(g, cuda)
    mg = mxu.MxuGraph.from_host(road, cuda, tile=64)
    return {
        "stencil": (stencil.StencilEngine(stencil.StencilGraph.from_host(road, cuda)), road_n),
        "mxu": (mxu.MxuEngine(mg, kernel=True, switch=10**6), road_n),
        "bitbell": (bitbell.BitBellEngine(bg), g.n),
        "lowk": (lowk.LowKEngine(bg, sparse_budget=300), g.n),
        "bell": (bell.BellEngine(bg), g.n),
        "streamed": (streamed.StreamedBitBellEngine(BellGraph.from_host(g, False), cuda), g.n),
    }


def test_batch_start_and_lowk_chunk_make_no_blocking_read(cuda):
    """Under torch.cuda.set_sync_debug_mode("error"): every route's batch
    start (``_init_carry``, warmed once) and the enqueue of a low-K chunk
    make no blocking device-to-host read; the hybrid routes' batch start
    is three device operations (the upload, the memset, the kernel)."""
    from torch.profiler import ProfilerActivity, profile

    for name, (eng, n) in _route_engines(cuda).items():
        k = 1 if name == "lowk" else 40
        queries = eng._pad_queries(io.pad_queries(
            generators.random_queries(n, k, max_group=5, seed=len(name))))[0]
        carry = eng._init_carry(queries)
        if name == "lowk":
            eng._chunk(carry, 4)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            carry = eng._init_carry(queries)
            if name == "lowk":
                eng._chunk(carry, 4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng._init_carry(queries)
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:  # a trace that saw the device
            assert len(ops) <= 3, (name, [e.name for e in ops])


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
    assert counts.get("batch_start", 0) > 0 and counts.get("flag_pull", 0) > 0
    assert "forest_or" not in counts  # the byte routes pull with their own kernel
    assert "push_or" not in counts  # the low-K push runs inside flag_pull's launches
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



# ---- K9 (csr_pull), K10 (queue_expand), K11 (queue_compact) ----------------


def _clone_carry(carry, device):
    """A dataclass carry with every tensor (and its switch's and planes')
    copied to ``device``; a query-minor ``dist`` view stays query-minor."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(carry):
        v = getattr(carry, f.name)
        if isinstance(v, torch.Tensor):
            if v.dim() == 2 and cuda_csr.query_minor(v):
                v = v.T.clone().to(device).T
            else:
                v = v.clone().to(device)
        elif isinstance(v, (bitbell.PushSwitch, cuda_csr.CsrPlanes)):
            v = dataclasses.replace(v, **{
                x.name: getattr(v, x.name).clone().to(device)
                for x in dataclasses.fields(v) if isinstance(getattr(v, x.name), torch.Tensor)})
        out[f.name] = v
    return type(carry)(**out)


def _csr_case(seed):
    n, e = generators.rmat_edges(10, edge_factor=8, seed=seed)
    n += 40  # isolated vertices past the RMAT range
    return n, CSRGraph.from_edges(n, e)


CSR_FIELDS = ("dist", "level", "updated", "stop", "found", "ctrl")
PLANE_FIELDS = ("frontier", "visited", "hits", "aux", "union")


def _csr_level_equal(gg, gc, got, want, layout):
    """One level of K9 on ``got`` (CUDA) and of its planes plain version
    on ``want`` (CPU): two launches when the planes are valid, three when
    stale, then every carry field and every plane bit for bit."""
    stale = not (got.planes is not None and got.planes.valid)
    ran = bool(int(want.ctrl[0]))
    cuda_csr.csr_level_planes_plain(gc, want)
    timing.reset_launch_counts()
    cuda_csr.csr_pull(gg, got)
    torch.cuda.synchronize()
    phases = ("pack", "walk", "apply") if stale else ("walk", "apply")
    state = "stale" if stale else "steady"
    assert timing.launch_counts() == {"csr_pull": len(phases)}
    assert timing.variant_counts() == {f"csr_pull:{layout}/{state}/{p}": 1 for p in phases}
    for name in CSR_FIELDS:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    if ran:  # else both planes are as the last level that ran left them
        for name in PLANE_FIELDS:
            assert torch.equal(getattr(got.planes, name).cpu(),
                               getattr(want.planes, name)), name
        assert got.planes.valid and want.planes.valid


def _csr_carries(gc, n, q, layout, device):
    want = (packed.packed_carry_init(gc, q) if layout == "minor"
            else bfs.distance_carry_init(n, q))
    return want, _clone_carry(want, device)


@pytest.mark.parametrize("layout", ["rows", "minor"])
@pytest.mark.parametrize("k", [1, 5, 40, 64, 100])
def test_csr_pull_matches_plain(cuda, layout, k):
    n, g = _csr_case(31 + k)
    gc, gg = g.to_device("cpu"), g.to_device(cuda)
    q = io.pad_queries(generators.random_queries(n, k, max_group=3, seed=k))
    if k > 2:
        q[1] = -1
    want, got = _csr_carries(gc, n, q, layout, cuda)
    shown = layout if k > 1 else "rows"
    # Chunks of 2 and 3 levels (each arm makes the planes stale, and the
    # bound stops queries mid-BFS), then the rest to convergence.
    for chunk, levels in ((2, 2), (3, 3), (2, 2), (None, 8)):
        bfs.arm_chunk(want, chunk, None)
        bfs.arm_chunk(got, chunk, None)
        for _ in range(levels):
            _csr_level_equal(gg, gc, got, want, shown)
    assert not int(want.ctrl[0])
    # A gated-off level (ctrl[0] = 0) changes nothing, planes included.
    before = _clone_carry(got, cuda)
    cuda_csr.csr_pull(gg, got)
    torch.cuda.synchronize()
    for name in CSR_FIELDS:
        assert torch.equal(getattr(got, name), getattr(before, name)), name
    for name in PLANE_FIELDS:
        assert torch.equal(getattr(got.planes, name), getattr(before.planes, name)), name


def _degree_class_graph(leaves=70_000):
    """A star hub (vertex 0, its slots in leaf order 1..leaves) cut into
    274 virtual rows, rows of 32, 33, 255, 256, 257 and 600 slots over the
    first leaves, and a path; with isolated vertices past them."""
    edges = [[0, 1 + i] for i in range(leaves)]
    fan = leaves + 1
    for width in (32, 33, 255, 256, 257, 600):
        edges += [[fan, 1 + (i * 7919) % leaves] for i in range(width)]
        fan += 1
    edges += [[fan + i, fan + i + 1] for i in range(20)] + [[fan, leaves]]
    return fan + 30, np.asarray(edges, dtype=np.int32)


@pytest.mark.parametrize("layout", ["rows", "minor"])
def test_csr_pull_degree_classes(cuda, layout):
    """Query 0's only frontier neighbour of the hub is its last slot,
    query 1's its first; the others start anywhere.  Every level of the
    BFS bit for bit against the planes plain version."""
    n, e = _degree_class_graph()
    g = CSRGraph.from_edges(n, e)
    gc, gg = g.to_device("cpu"), g.to_device(cuda)
    hub_pieces = -(-70_000 // 256)
    assert int((gc.vrows[:, 2] == 0).sum()) == hub_pieces
    q = io.pad_queries(generators.random_queries(n, 40, max_group=3, seed=9))
    q[0] = -1
    q[1] = -1
    q[0, 0], q[1, 0] = 70_000, 1
    want, got = _csr_carries(gc, n, q, layout, cuda)
    bfs.arm_chunk(want, 3, None)
    bfs.arm_chunk(got, 3, None)
    _csr_level_equal(gg, gc, got, want, layout)
    assert int(got.dist[0, 0]) == 1 and int(got.dist[1, 0]) == 1
    for _ in range(2):
        _csr_level_equal(gg, gc, got, want, layout)
    bfs.arm_chunk(want, None, None)
    bfs.arm_chunk(got, None, None)
    while int(want.ctrl[0]):
        _csr_level_equal(gg, gc, got, want, layout)


@pytest.mark.parametrize("edge_chunks", [1, 4])
def test_vmap_and_packed_engines_on_card_match_plain(cuda, edge_chunks):
    n, g = _csr_case(5)
    dg = g.to_device(cuda)
    q = io.pad_queries(generators.random_queries(n, 37, max_group=4, seed=6))
    for level_chunk in (None, 3):
        want = engine.Engine(dg, level_chunk=level_chunk, plain=True).query_stats(q)
        timing.reset_launch_counts()
        got = engine.Engine(dg, level_chunk=level_chunk).query_stats(q)
        assert timing.launch_counts().get("csr_pull", 0) > 0
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        pk = packed.PackedEngine(dg, edge_chunks=edge_chunks, level_chunk=level_chunk)
        plain = packed.PackedEngine(dg, edge_chunks=edge_chunks, level_chunk=level_chunk,
                                    plain=True)
        timing.reset_launch_counts()
        for x, y in zip(pk.query_stats(q), plain.query_stats(q)):
            np.testing.assert_array_equal(x, y)
        assert any(v.startswith("csr_pull:minor/steady/") for v in timing.variant_counts())
        for x, y in zip(pk.query_stats(q), want):
            np.testing.assert_array_equal(x, y)
    dense_eng = engine.Engine(dense.DenseGraph.from_host(g, cuda))
    for x, y in zip(dense_eng.query_stats(q), want):
        np.testing.assert_array_equal(x, y)


def _queue_equal(got, want):
    k, dev = want.queue.shape[0], want.queue.device
    for name in ("visited", "hit", "touched", "count", "f", "levels", "reached", "level",
                 "updated", "stop", "max_count"):
        assert torch.equal(getattr(got, name).to(dev), getattr(want, name)), name
    assert torch.equal(got.ctrl.to(dev)[[0, 2]], want.ctrl[[0, 2]])
    for q in range(k):
        m = min(int(want.count[q]), want.capacity)
        assert torch.equal(got.queue[q, :m].to(dev), want.queue[q, :m]), q


def _tile_graph(rows=400, cols=420, isolated=5):
    """A road grid of many 4096-byte tiles a query (42 at 400 x 420, the
    last one partial), with ``isolated`` vertices past it."""
    n, e = generators.road_edges(rows, cols, seed=5)
    return n + isolated, e


def _tile_queries(n, k, seed, isolated=5):
    """k groups on the grid; group 0 also holds sources on both sides of
    the first tile boundaries and in the last, partial tile."""
    groups = generators.random_queries(n - isolated, k, max_group=12, seed=seed)
    edge = np.array([4095, 4096, 8191, 8192, n - isolated - 1], dtype=np.int32)
    groups[0] = np.concatenate([groups[0], edge]).astype(np.int32)
    return io.pad_queries(groups)


def _queue_case(graph, k):
    if graph == "road":
        n, e = generators.road_edges(60, 70, seed=k)
        q = io.pad_queries(generators.random_queries(n, k, max_group=12, seed=k + 1))
    else:
        n, e = _tile_graph()
        q = _tile_queries(n, k, k + 1)
    return n, push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), "cpu"), q


@pytest.mark.parametrize("capacity", ["fits", 37])
@pytest.mark.parametrize("k", [1, 6, 33])
@pytest.mark.parametrize("graph", ["road", "tiles"])
def test_queue_push_matches_plain(cuda, graph, k, capacity):
    """K10 and K11 (queue mode) a level at a time against their plain
    versions, through chunk bounds, every carry field (the tile flags
    too) bit for bit, to convergence (on the many-tile graph at capacity
    37, whose cut frontiers crawl, for 30 chunks); at capacity 37 the
    frontiers overflow and the queues keep their ascending first 37 ids.
    On the many-tile graph query 0 is held by its chunk bound (stop =
    level) for the first chunk while the others run."""
    n, adj, q = _queue_case(graph, k)
    capacity = n if capacity == "fits" else capacity
    adj_c = push.PaddedAdjacency(adj.rows.to(cuda), adj.n, adj.width, adj.num_edges)
    csr = push.table_csr(adj_c)
    want = cuda_push.queue_carry_init(n, adj.rows, q, capacity)
    got = cuda_push.queue_carry_init(n, adj_c.rows, q, capacity)
    _queue_equal(got, want)
    overflowed = False
    crawl = graph == "tiles" and capacity == 37
    for chunk in range(30 if crawl else 400):
        for c in (want, got):
            bfs.arm_chunk(c, 7, None)
            if graph == "tiles" and chunk == 0 and k > 1:
                c.stop[0] = c.level[0]
        for _ in range(7):
            cuda_push.queue_expand_plain(adj.rows, want)
            timing.reset_launch_counts()
            cuda_push.queue_expand(adj_c.rows, got, csr)
            torch.cuda.synchronize()
            _queue_equal(got, want)
            cuda_push.queue_compact_plain(want)
            cuda_push.queue_compact(got)
            torch.cuda.synchronize()
            assert timing.launch_counts() == {"queue_expand": 1, "queue_compact": 1}
            _queue_equal(got, want)
            assert not bool(got.touched.any())
            overflowed |= bool((want.count > capacity).any())
        if not bool(want.running(None)):
            break
    assert crawl or not bool(want.running(None))
    assert overflowed == (capacity == 37)


def test_queue_push_level_with_no_touched_tile(cuda):
    """A level whose queues hold only isolated vertices: K10 writes no hit
    byte and marks no tile, K11 finds no flag and stops every query, as
    the plain versions do."""
    n, e = _tile_graph()
    adj = push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), "cpu")
    adj_c = push.PaddedAdjacency(adj.rows.to(cuda), adj.n, adj.width, adj.num_edges)
    q = io.pad_queries([np.array([n - 1, n - 3], np.int32), np.array([n - 2], np.int32),
                        np.array([n + 7], np.int32)])
    want = cuda_push.queue_carry_init(n, adj.rows, q, 64)
    got = cuda_push.queue_carry_init(n, adj_c.rows, q, 64)
    _queue_equal(got, want)
    for c in (want, got):
        bfs.arm_chunk(c, 4, None)
    cuda_push.queue_expand_plain(adj.rows, want)
    cuda_push.queue_expand(adj_c.rows, got, push.table_csr(adj_c))
    torch.cuda.synchronize()
    assert not bool(got.touched.any()) and not bool(got.hit.any())
    cuda_push.queue_compact_plain(want)
    cuda_push.queue_compact(got)
    torch.cuda.synchronize()
    _queue_equal(got, want)
    assert int(got.ctrl[0]) == 0 and got.count.tolist() == [0, 0, 0]


def test_queue_push_grid_strides(cuda):
    """K = 300 queries of 901 tiles each: both kernels' grids stride (K10
    three blocks a query, K11 more 32-tile warp tasks than the grid's
    warps); the first levels against the plain versions, on the card."""
    n, e = generators.road_edges(900, 4096, seed=6)
    adj = push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), cuda)
    q = io.pad_queries(generators.random_queries(n, 300, max_group=40, seed=8))
    want = cuda_push.queue_carry_init(n, adj.rows, q, 50000, plain=True)
    got = cuda_push.queue_carry_init(n, adj.rows, q, 50000)
    _queue_equal(got, want)
    for c in (want, got):
        bfs.arm_chunk(c, None, None)
    for _ in range(4):
        cuda_push.queue_expand_plain(adj.rows, want)
        cuda_push.queue_compact_plain(want)
        cuda_push.queue_expand(adj.rows, got, push.table_csr(adj))
        cuda_push.queue_compact(got)
        torch.cuda.synchronize()
        _queue_equal(got, want)


@pytest.mark.parametrize("capacity", ["fits", 23])
@pytest.mark.parametrize("k", [5, 64, 128])
@pytest.mark.parametrize("side", [(50, 40), (1300, 1700)])
def test_row_queue_matches_plain(cuda, side, k, capacity):
    """K3 and K11's row mode (the ppush level) against their plain
    versions a level at a time, overflowing union queues included; W = 1,
    2 and 4 words a row (the prefetched, scalar and 16-byte paths); on
    1300 x 1700 the apply's blocks take 9 tiles each, more than a warp
    each."""
    n, e = generators.road_edges(*side, seed=k)
    capacity = n if capacity == "fits" else capacity
    adj = push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), "cpu")
    adj_c = push.PaddedAdjacency(adj.rows.to(cuda), adj.n, adj.width, adj.num_edges)
    q = io.pad_queries(generators.random_queries(n, k, max_group=9, seed=k + 2))
    qp = push_packed._pad_rows(q, push_packed._k_pad(k))
    # The large grid's plain versions run on the card.
    ref = adj if side == (50, 40) else adj_c
    want = push_packed._packed_init_batch(ref, qp, capacity, plain=True)
    got = push_packed._packed_init_batch(adj_c, qp, capacity)
    dev = want.visited.device
    for level in range(4000):
        push_packed.packed_push_level(ref, want, bfs.INT32_MAX, plain=True)
        timing.reset_launch_counts()
        push_packed.packed_push_level(adj_c, got, bfs.INT32_MAX)
        torch.cuda.synchronize()
        assert timing.launch_counts() == {"push_or": 1, "queue_compact": 1}
        assert timing.variant_counts()["queue_compact:rows"] == 1
        for name in ("visited", "frontier", "hits", "f", "levels", "reached", "counts",
                     "count", "peak", "ctrl"):
            assert torch.equal(getattr(got, name).to(dev), getattr(want, name)), (level, name)
        assert torch.equal(got.switch.state[:2].to(dev), want.switch.state[:2])
        m = int(want.switch.state[0])
        assert torch.equal(got.switch.worklist[:, :m].to(dev), want.switch.worklist[:, :m])
        if not int(want.ctrl[0]):
            break
    assert not int(want.ctrl[0])
    assert (int(want.peak[0]) > capacity) == (capacity == 23)


@pytest.mark.parametrize("cls", ["push", "ppush"])
def test_push_engines_on_card_match_plain(cuda, cls, capsys):
    """Both push engines through the capacity protocol on the card: thin,
    fat and thin batches give the plain engine's results, stderr lines
    and capacities; an explicit small capacity raises FrontierOverflow."""
    n, e = generators.road_edges(120, 120, seed=3)
    adj = push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), cuda)
    eng_cls = push.PushEngine if cls == "push" else push_packed.PackedPushEngine
    thin = io.pad_queries(generators.random_queries(n, 4, max_group=2, seed=1))
    fat = io.pad_queries(generators.random_queries(n, 6, max_group=1500, seed=2))
    runs = []
    for plain in (True, False):
        eng = eng_cls(adj, plain=plain)
        trail = []
        for batch in (thin, fat, thin):
            stats = eng.query_stats(batch)
            trail.append((eng.capacity, *(x.tolist() for x in stats)))
        runs.append((trail, capsys.readouterr().err))
    assert runs[0] == runs[1]
    assert "frontier overflowed" in runs[0][1]
    with pytest.raises(push.FrontierOverflow):
        eng_cls(adj, capacity=16).f_values(fat)
    assert supervisor.classify(push.FrontierOverflow("x")).exit_code == 3


@pytest.mark.parametrize("backend", ["vmap", "packed", "dense", "push", "ppush"])
def test_single_device_routes_cli_on_card(cuda, tmp_path, capsys, monkeypatch, backend):
    n, edges = generators.road_edges(40, 40, seed=3)
    gpath, qpath = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, 20, max_group=5, seed=4))
    argv = ["prog", "-g", gpath, "-q", qpath, "-gn", "1"]
    monkeypatch.setenv("MSBFS_BACKEND", backend)
    assert cli.main(argv, device="cpu") == 0
    want = capsys.readouterr().out.splitlines()[:5]
    timing.reset_launch_counts()
    assert cli.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[:5] == want
    counts = timing.launch_counts()
    own = {"vmap": ["csr_pull"], "packed": ["csr_pull"], "dense": [],
           "push": ["queue_expand", "queue_compact"],
           "ppush": ["push_or", "queue_compact"]}[backend]
    for name in own:
        assert counts.get(name, 0) > 0, (backend, counts)


def _weighted_case(seed, k, n_extra=0):
    """Random query-minor tentative planes over a weighted RMAT-10 with a
    hub (vertex 0 joined to 300 others: a row of several pieces), its
    dedup slots: a third of the cells reached, about a fifth of them
    active, the hub's row active."""
    n, edges = generators.rmat_edges(10, edge_factor=8, seed=seed)
    hub = np.stack([np.zeros(300, np.int64), np.arange(1, 301)], axis=1)
    edges = np.concatenate([edges, hub])
    costs = generators.edge_costs(len(edges), "uniform", 16, seed=seed + 1)
    u, v, w, _ = CSRGraph.from_edges(n, edges, weights=costs).deduped_weighted()
    assert np.bincount(u).max() > 4 * cuda_weighted.PIECE_SLOTS
    rng = np.random.default_rng(seed + 2)
    ns = n + n_extra
    tent = np.where(rng.random((ns, k)) < 0.3, rng.integers(0, 200, (ns, k)),
                    cuda_weighted.INF).astype(np.int32)
    tent[0] = rng.integers(0, 200, k)
    active = (rng.random((ns, k)) < 0.2) & (tent < cuda_weighted.INF)
    active[0] = True
    return torch.from_numpy(tent), torch.from_numpy(active), (u, v, w)


@pytest.mark.parametrize("window", ["all", "band", "idle"])
@pytest.mark.parametrize("light", [True, False])
@pytest.mark.parametrize("k", [1, 5, 8, 64, 200])
def test_weighted_relax_matches_plain(cuda, k, light, window):
    tent, active, (u, v, w) = _weighted_case(40 + k, k, n_extra=7)
    if window == "idle":
        active = torch.zeros_like(active)
    delta = 8
    keep = (w <= delta) if light else (w > delta)
    side = cuda_weighted.make_side(u[keep], v[keep], w[keep], cuda)
    lo, hi = (0, tent.shape[0]) if window != "band" else (0, tent.shape[0] // 3)
    p0, p1 = (int(p) for p in np.searchsorted(side.host_pieces[:, 2], (lo, hi)))
    assert p1 - p0 > 4
    s0, s1 = (int(s) for s in np.searchsorted(u, (lo, hi)))
    slots = [torch.from_numpy(a.astype(np.int32)) for a in (u, v, w)]
    want = cuda_weighted.relax_plain(tent, active, *slots, delta, light, s0, s1)
    if window == "idle":
        assert torch.equal(want, tent)
    tc, ac = tent.to(cuda), active.to(cuda)
    timing.reset_launch_counts()
    got = cuda_weighted.relax(tc, ac, side, p0, p1, delta, light)
    torch.cuda.synchronize()
    assert timing.launch_counts() == {"weighted_relax": 1}
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tc.cpu(), tent)  # the kernel reads tent, writes out
    # The plain version on the card, over the side, in small chunks, too.
    s0, s1 = side.slot_range(p0, p1)
    plain = cuda_weighted.relax_plain(tc, ac, side.u, side.v, side.w, delta, light, s0, s1,
                                      chunk_cells=4096)
    assert torch.equal(plain.cpu(), want)


@pytest.mark.parametrize("light", [True, False])
def test_weighted_mesh2d_pass_launches_a_tile(cuda, light):
    n, edges = generators.rmat_edges(10, edge_factor=8, seed=3)
    hub = np.stack([np.zeros(300, np.int64), np.arange(1, 301)], axis=1)
    edges = np.concatenate([edges, hub])
    g = CSRGraph.from_edges(n, edges, weights=generators.edge_costs(len(edges), seed=4))
    fast = weighted.WeightedMesh2DEngine(g, device=cuda)
    plain = weighted.WeightedMesh2DEngine(g, device="cpu")
    rng = np.random.default_rng(5)
    tent = torch.from_numpy(np.where(rng.random((fast.n_state, 64)) < 0.5,
                                     rng.integers(0, 99, (fast.n_state, 64)),
                                     cuda_weighted.INF).astype(np.int32))
    active = torch.from_numpy(rng.random(tent.shape) < 0.3) & (tent < cuda_weighted.INF)
    want, width = plain._relax(tent, active, light)
    timing.reset_launch_counts()
    got, got_width = fast._relax(tent.to(cuda), active.to(cuda), light)
    torch.cuda.synchronize()
    bounds = fast._tile_pieces[0 if light else 1]
    assert timing.launch_counts() == {"weighted_relax": int((np.diff(bounds) > 0).sum())}
    assert torch.equal(got.cpu(), want) and got_width == width


@pytest.mark.parametrize("flavor", ["bitbell", "stencil", "mesh2d"])
def test_weighted_engines_on_card_match_plain(cuda, flavor):
    n, edges = generators.road_edges(30, 30, seed=5)
    costs = generators.edge_costs(len(edges), "zipf", 16, seed=6)
    g = CSRGraph.from_edges(n, edges, weights=costs)
    rows = io.pad_queries(generators.random_queries(n, 9, max_group=4, seed=7))
    _, fast = weighted.negotiate_weighted_engine(g, flavor, device=cuda)
    _, plain = weighted.negotiate_weighted_engine(g, flavor, device="cpu")
    timing.reset_launch_counts()
    got = fast.distances(rows)
    assert timing.launch_counts().get("weighted_relax", 0) > 0
    np.testing.assert_array_equal(got, plain.distances(rows))
    assert fast.weighted_stats() == plain.weighted_stats()
    assert fast.last_host_reads == plain.last_host_reads


def test_weighted_route_cli_on_card(cuda, tmp_path, capsys, monkeypatch):
    n, edges = generators.road_edges(40, 40, seed=3)
    gpath, qpath = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    io.save_graph_bin(gpath, n, edges, generators.edge_costs(len(edges), seed=4))
    io.save_query_bin(qpath, generators.random_queries(n, 20, max_group=5, seed=4))
    argv = ["prog", "-g", gpath, "-q", qpath, "-gn", "1"]
    monkeypatch.setenv("MSBFS_WEIGHTED", "1")
    assert cli.main(argv, device="cpu") == 0
    want = capsys.readouterr().out.splitlines()[:5]
    timing.reset_launch_counts()
    assert cli.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[:5] == want
    assert set(timing.launch_counts()) == {"weighted_relax"}


def test_verify_on_card(cuda, tmp_path, capsys):
    n, edges = generators.road_edges(30, 30, seed=8)
    paths = [str(tmp_path / x) for x in ("w.bin", "u.bin", "q.bin")]
    io.save_graph_bin(paths[0], n, edges, generators.edge_costs(len(edges), seed=9))
    io.save_graph_bin(paths[1], n, edges)
    io.save_query_bin(paths[2], generators.random_queries(n, 6, max_group=4, seed=10))
    for graph, extra in ((paths[0], ["--weighted"]), (paths[1], [])):
        argv = ["prog", "verify", "-g", graph, "-q", paths[2], *extra]
        assert cli.main(argv, device="cpu") == 0
        want = capsys.readouterr().out
        assert cli.main(argv) == 0
        assert capsys.readouterr().out == want


# ---- the mesh engines' halo kernels (H1-H3, csrc/halo_exchange.cu)


def _pairs(rng, pairs, w, rows, unique):
    ids = (rng.permutation(rows + 7)[:pairs] if unique
           else rng.integers(-3, rows + 7, pairs)).astype(np.int32)
    words = _planes(rng, pairs, w)
    words[torch.from_numpy(rng.random((pairs, w)) < 0.3)] = 0
    return torch.from_numpy(ids), words


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("w", [1, 3, 8])
def test_halo_pair_or_matches_plain(cuda, w, unique):
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_halo,
    )

    rng = np.random.default_rng(w)
    rows, lo = 3000, 500
    ids, words = _pairs(rng, 2500, w, rows + lo, unique)
    plane = _planes(rng, rows, w)
    want = plane.clone()
    cuda_halo.halo_pair_or_plain(ids, words, want, lo)
    got = plane.to(cuda)
    before = timing.launch_counts().get("halo_pair_or", 0)
    cuda_halo.halo_pair_or(ids.to(cuda), words.to(cuda), got, lo)
    assert timing.launch_counts()["halo_pair_or"] == before + 1
    assert torch.equal(got.cpu(), want)
    # Gated off on the device: nothing lands.
    ctrl = torch.tensor([0, 5, 0, 0], dtype=torch.int32, device=cuda)
    cuda_halo.halo_pair_or(ids.to(cuda), words.to(cuda), got, lo, ctrl)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("w,nseg", [(1, 2), (1, 16), (3, 4), (8, 16)])
def test_halo_pair_or_segments_matches_plain(cuda, w, nseg):
    """H1's segmented form: ``nseg`` pair lists in one launch (variant
    ``seg``), duplicates within and across overlapping segments, ids below
    ``lo`` and past a segment's rows dropped — a segment's sentinel never
    reaches the next segment's first row — and gated off on the device."""
    rng = np.random.default_rng(w * 100 + nseg)
    rows = 4000
    plane = _planes(rng, rows, w)
    segments = []
    for k in range(nseg):
        srows = int(rng.integers(1, rows // 4))
        base = int(rng.integers(0, rows - srows + 1))
        lo = int(rng.integers(-5, 6))
        pairs = int(rng.integers(0, 3000)) if k else 0  # the first is empty
        ids = rng.integers(lo - 3, lo + srows + 3, pairs).astype(np.int32)
        ids[: pairs // 4] = lo + srows  # each segment's sentinel
        words = _planes(rng, pairs, w)
        segments.append(cuda_halo.Segment(torch.from_numpy(ids), words, base, srows, lo))
    want = plane.clone()
    cuda_halo.halo_pair_or_segments_plain(segments, want)
    on_card = [cuda_halo.Segment(s.ids.to(cuda), s.words.to(cuda), s.base, s.rows, s.lo)
               for s in segments]
    got = plane.to(cuda)
    timing.reset_launch_counts()
    cuda_halo.halo_pair_or_segments(on_card, got)
    assert timing.launch_counts() == {"halo_pair_or": 1}
    assert timing.variant_counts() == {"halo_pair_or:seg": 1}
    assert torch.equal(got.cpu(), want)
    ctrl = torch.tensor([0, 5, 0, 0], dtype=torch.int32, device=cuda)
    cuda_halo.halo_pair_or_segments(on_card, got, ctrl)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("segs,total", [(2, 262144), (4, 8192), (17, 999)])
def test_wire_decode_segments_matches_plain(cuda, segs, total):
    """The 2D mesh's gather decode: each segment's encoding (M2) lands at
    its offset of the zeroed plane, one H1 launch a 16 segments; the
    decoded plane is the segments' planes side by side."""
    rng = np.random.default_rng(segs)
    planes = [_planes(rng, total, 1).view(-1) for _ in range(segs)]
    for p in planes:
        p[torch.from_numpy(rng.random(total) >= 0.05)] = 0
    budget = max(max(int((p != 0).sum()) for p in planes), 1)
    encs = [cuda_mesh.wire_encode(p.to(cuda), budget) for p in planes]
    got = torch.zeros(segs * total, dtype=torch.int32, device=cuda)
    timing.reset_launch_counts()
    cuda_mesh.wire_decode_segments([(e.idx, e.words, k * total) for k, e in enumerate(encs)],
                                   got, total)
    assert timing.launch_counts() == {"halo_pair_or": -(-segs // cuda_halo.MAX_SEGMENTS)}
    assert torch.equal(got.cpu(), torch.cat(planes))


@pytest.mark.parametrize("case", ["mixed", "all-sentinel", "no-match", "hub", "wide"])
@pytest.mark.parametrize("w", [1, 2])
def test_halo_push_match_and_push_match_plain(cuda, case, w):
    """H2's match (st, deg, pos, total) and its push given the match, bit for
    bit against their plain versions, one launch each: pair lists of
    sentinels only, of ids that are no source, of every source with the hub
    (its edges spread over many blocks), mixed, and a wide list against a
    CSR of more than 2048 sources (the search past the shared-memory
    samples) with more pairs than one match tile holds."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        sharded_bell,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_halo,
    )

    scale = 16 if case == "wide" else 12
    n, edges = generators.rmat_edges(scale, edge_factor=16, seed=w)
    g = CSRGraph.from_edges(n, edges)
    p = 2
    L = -(-n // p)
    n_pad = p * L
    rng = np.random.default_rng(w + len(case))
    for csr in sharded_bell.build_push_halo(g, p, L):
        src_ids, _, src_cnt, _ = csr
        if case == "all-sentinel":
            ids = np.full(3000, n_pad)
        elif case == "no-match":
            ids = np.concatenate([np.setdiff1d(np.arange(n), src_ids)[:2000],
                                  np.full(1000, n_pad)])
        elif case == "hub":
            hub = np.argsort(src_cnt)[-3:]
            ids = np.concatenate([src_ids[hub], rng.choice(src_ids, 200), np.full(500, n_pad)])
            ids = np.concatenate([np.unique(ids[:-500]), ids[-500:]])
        else:
            count = 20000 if case == "wide" else 1500
            ids = np.concatenate([np.unique(rng.integers(0, n, count)), np.full(count, n_pad)])
        ids = torch.from_numpy(ids.astype(np.int32))
        words = _planes(rng, ids.numel(), w)
        csr_t = tuple(torch.from_numpy(a) for a in csr)
        want_m = cuda_halo.halo_push_match_plain(ids, csr_t)
        want = torch.zeros((L, w), dtype=torch.int32)
        cuda_halo.halo_push_or_plain(ids, words, csr_t, want, want_m)
        on = tuple(t.to(cuda) for t in csr_t)
        timing.reset_launch_counts()
        got_m = cuda_halo.halo_push_match(ids.to(cuda), on)
        total = int(got_m.total[0])
        got = torch.zeros((L, w), dtype=torch.int32, device=cuda)
        cuda_halo.halo_push_or(ids.to(cuda), words.to(cuda), on, got, got_m, total)
        assert timing.launch_counts() == {"halo_push_match": 1, "halo_push_or": 1}
        for name, a, b in zip(want_m._fields, got_m, want_m):
            assert torch.equal(a.cpu(), b), (case, name)
        assert torch.equal(got.cpu(), want), case
        if case in ("all-sentinel", "no-match"):
            assert total == 0
        if case == "wide":
            assert src_ids.size > 2048 and ids.numel() > cuda_halo.MATCH_TILE


@pytest.mark.parametrize("w", [1, 2, 5])
def test_halo_push_or_matches_plain(cuda, w):
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        sharded_bell,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_halo,
    )

    n, edges = generators.rmat_edges(12, edge_factor=16, seed=w)
    g = CSRGraph.from_edges(n, edges)
    p = 4
    L = -(-n // p)
    rng = np.random.default_rng(w)
    ids = torch.from_numpy(np.where(rng.random(3000) < 0.8, rng.integers(0, n, 3000),
                                    p * L).astype(np.int32))
    words = _planes(rng, 3000, w)
    for csr in sharded_bell.build_push_halo(g, p, L):
        csr_t = tuple(torch.from_numpy(a) for a in csr)
        want = torch.zeros((L, w), dtype=torch.int32)
        cuda_halo.halo_push_or_plain(ids, words, csr_t, want)
        got = torch.zeros((L, w), dtype=torch.int32, device=cuda)
        cuda_halo.halo_push_or(ids.to(cuda), words.to(cuda),
                               tuple(t.to(cuda) for t in csr_t), got)
        assert torch.equal(got.cpu(), want)


def _expand_inputs(rng, case, w, cap, bnd):
    """One shard's H3 call: (table, queue, count, frontier, hits, lo, n_pad,
    bnd, ctrl).  ``road``: a road graph's shard; ``wide``: 1.1M slots of a
    synthetic table (about 1 % boundary), the budget cut inside a tile,
    exactly at a tile's edge, or above the whole count."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        push_sharded,
    )

    ctrl = torch.tensor([0 if case == "gated" else 1, 2, 0, 0], dtype=torch.int32)
    if case == "wide":
        L, width, b = 300_000, 4, 1
        n_pad, lo = 4 * L, L
        r = rng.random((L + 1, width))
        table = np.where(r < 0.5, lo + rng.integers(0, L, r.shape),
                         np.where(r < 0.51, (lo + L + rng.integers(0, 2 * L, r.shape)) % n_pad,
                                  n_pad)).astype(np.int32)
        table[L] = n_pad
        queue = torch.from_numpy(rng.permutation(L).astype(np.int32))
        listed = 280_000
        v = table[queue.numpy()[:listed]].reshape(-1).astype(np.int64)
        pos = np.flatnonzero((v < n_pad) & ((v < lo) | (v >= lo + L)))
        tile = cuda_halo.EXPAND_TILE
        if bnd == "inside":
            k = next(k for k in range(pos.size // 2, pos.size)
                     if pos[k] // tile == pos[k - 1] // tile)
        elif bnd == "edge":
            k = int((pos < tile * (pos[pos.size // 2] // tile)).sum())
            assert pos[k] // tile != pos[k - 1] // tile
        else:
            k = pos.size + 100
        frontier = _planes(rng, L, w)
        count = torch.tensor([listed], dtype=torch.int32)
        return (torch.from_numpy(table), queue, count, frontier, _planes(rng, L, w), lo, n_pad,
                k, ctrl)
    n, edges = generators.road_edges(90, 90, seed=2)
    p = 3
    stacked, L, n_pad, width = push_sharded.build_sharded_adjacency(
        CSRGraph.from_edges(n, edges), p)
    b = int(rng.integers(0, p))
    frontier = _planes(rng, L, w)
    frontier[torch.from_numpy(rng.random(L) < 0.6)] = 0
    if case == "listed0":
        frontier.zero_()
    nz = torch.nonzero(frontier.ne(0).any(dim=1)).flatten().to(torch.int32)
    queue = torch.full((min(cap, L),), L, dtype=torch.int32)
    queue[: min(nz.numel(), queue.numel())] = nz[: queue.numel()]
    count = torch.tensor([nz.numel()], dtype=torch.int32)
    if case == "over":
        assert nz.numel() > queue.numel()
    hits = _planes(rng, L, w) & 0x0F0F0F0F
    return (torch.from_numpy(stacked[b]), queue, count, frontier, hits, b * L, n_pad, bnd, ctrl)


@pytest.mark.parametrize("case,w,cap,bnd", [
    ("road", 2, 4096, 8192), ("road", 2, 37, 5), ("road", 2, 5000, 2000),
    ("road", 1, 5000, 7), ("road", 3, 4096, 3000),
    ("wide", 1, None, "inside"), ("wide", 2, None, "edge"), ("wide", 3, None, "whole"),
    ("listed0", 1, 4096, 16), ("over", 2, 100, 60), ("gated", 1, 4096, 16)])
def test_owner_push_expand_matches_plain(cuda, case, w, cap, bnd):
    """H3 bit for bit against its plain version, one launch a call: a
    road shard; 1.1M slots (about 1,100 tiles contending) with the budget
    cut inside a tile, at a tile's edge, or above the count; an empty
    queue; a count above the capacity; gated off (outputs untouched).
    Three calls in a row on one scratch, each on other inputs, so a stale
    status word of the call before would show."""
    rng = np.random.default_rng(w * 1000 + (cap or 0))
    calls = [_expand_inputs(rng, case, w, cap, bnd) for _ in range(3)]
    tiles = max(cuda_halo.expand_tiles(c[1].shape[0], c[0].shape[1]) for c in calls)
    scratch = cuda_halo.ScanScratch(tiles, cuda)
    for table, queue, count, frontier, hits, lo, n_pad, nb, ctrl in calls:
        outs = {}
        for where in ("plain", "card"):
            dev = torch.device("cpu") if where == "plain" else cuda
            args = [table, queue, count, frontier, hits.clone(), lo, n_pad,
                    torch.full((nb,), 7, dtype=torch.int32),
                    torch.full((nb, w), 9, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32), torch.tensor([3], dtype=torch.int32), ctrl]
            args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
            timing.reset_launch_counts()
            if where == "plain":
                cuda_halo.owner_push_expand_plain(*args)
            else:
                cuda_halo.owner_push_expand(*args, scratch=scratch)
                assert timing.launch_counts() == {"owner_push_expand": 1}
            outs[where] = [args[i].cpu() for i in (4, 7, 8, 9, 10)]
        for a, b_ in zip(outs["card"], outs["plain"]):
            assert torch.equal(a, b_)
        if case == "gated":
            assert torch.equal(outs["card"][0], hits)
            assert (outs["card"][1] == 7).all() and (outs["card"][2] == 9).all()
        if case == "wide" and bnd != "whole":
            assert int(outs["card"][3]) > nb
    # The scratch kept for the stream (no scratch given) on the last call.
    args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in
            (table, queue, count, frontier, hits.clone(), lo, n_pad,
             torch.full((nb,), 7, dtype=torch.int32), torch.full((nb, w), 9, dtype=torch.int32),
             torch.zeros(1, dtype=torch.int32), torch.tensor([3], dtype=torch.int32), ctrl)]
    cuda_halo.owner_push_expand(*args)
    for a, b_ in zip([args[i].cpu() for i in (4, 7, 8, 9, 10)], outs["plain"]):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("env", [{}, {"MSBFS_VSHARD": "2", "MSBFS_HALO_BUDGET": "64",
                                      "MSBFS_PUSH_HALO": "4096"},
                                 {"MSBFS_VSHARD": "4"}, {"MSBFS_BACKEND": "push"},
                                 {"MSBFS_BACKEND": "csr"}])
def test_mesh_cli_on_card(cuda, tmp_path, capsys, monkeypatch, env):
    """-gn 4 over a logical mesh on the card reports what the same mesh
    of CPU entries reports (the plain versions)."""
    n, edges = generators.road_edges(60, 60, seed=5)
    gpath, qpath = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, 20, max_group=5, seed=6))
    argv = ["prog", "-g", gpath, "-q", qpath, "-gn", "4"]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert cli.main(argv, device="cpu", mesh_devices=["cpu"] * 4) == 0
    want = capsys.readouterr().out.splitlines()[:5]
    assert cli.main(argv, mesh_devices=[cuda] * 4) == 0
    assert capsys.readouterr().out.splitlines()[:5] == want


# ---- the 2D mesh's kernels: M1 chunk_merge, M2 wire_encode, the decode on
# H1, M4 forest_max (ops/cuda_mesh.py)


@pytest.mark.parametrize("op,chunks,words", [("or", 1, 1), ("or", 2, 4099), ("or", 4, 262144),
                                             ("max", 3, 777), ("max", 16, 5000)])
def test_chunk_merge_matches_plain(cuda, op, chunks, words):
    rng = np.random.default_rng(chunks * 7 + words)
    parts = [_planes(rng, words, 1).view(-1) for _ in range(chunks)]
    if op == "max":
        parts = [torch.where(p < 0, 0, p) for p in parts]
    want = torch.empty(words, dtype=torch.int32)
    cuda_mesh.chunk_merge_plain(parts, want, op)
    got = torch.empty(words, dtype=torch.int32, device=cuda)
    timing.reset_launch_counts()
    cuda_mesh.chunk_merge([p.to(cuda) for p in parts], out=got, op=op)
    assert timing.launch_counts() == {"chunk_merge": 1}
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("acc,flag", [(False, False), (True, True), (False, True)])
def test_chunk_merge_commit_matches_plain(cuda, acc, flag):
    rng = np.random.default_rng(11)
    shape = (3000, 32)
    base = bitbell.NEG_BASE

    def neg_plane():
        return torch.from_numpy(np.where(rng.random(shape) < 0.3,
                                         base - rng.integers(0, 50, shape), 0).astype(np.int32))

    neg, parts = neg_plane(), [neg_plane() for _ in range(3)]
    outs = {}
    for where, dev in (("plain", torch.device("cpu")), ("card", cuda)):
        c = cuda_mesh.Commit(neg.clone().to(dev), torch.zeros(shape, dtype=torch.bool, device=dev),
                             torch.zeros(shape, dtype=torch.bool, device=dev) if acc else None,
                             torch.zeros(1, dtype=torch.int32, device=dev) if flag else None)
        ps = [p.to(dev) for p in parts]
        if where == "plain":
            cuda_mesh.chunk_merge_plain(ps, None, "max", c)
        else:
            cuda_mesh.chunk_merge(ps, op="max", commit=c)
        outs[where] = [t.cpu() for t in c.tensors() if t is not None]
    for a, b in zip(outs["card"], outs["plain"]):
        assert torch.equal(a, b)
    if flag:
        assert int(outs["card"][-1]) == 1


def _neg_planes(rng, shape, share=0.3, spread=50):
    return torch.from_numpy(np.where(rng.random(shape) < share,
                                     bitbell.NEG_BASE - rng.integers(0, spread, shape),
                                     0).astype(np.int32))


def _commit_on(dev, neg, before, send, acc_set=False, tag=9, offset=0):
    """A Commit of fresh copies on ``dev``; neg and send ``offset`` lanes
    into their buffers (misaligned for the 16-byte form when nonzero)."""
    def at(t, fill):
        buf = torch.full((t.numel() + offset,), fill, dtype=t.dtype, device=dev)
        buf[offset:] = t.reshape(-1).to(dev)
        return buf[offset:].view(t.shape)

    return cuda_mesh.Commit(at(neg, 0), torch.zeros(neg.shape, dtype=torch.bool, device=dev),
                            before.clone().to(dev), torch.zeros(1, dtype=torch.int32, device=dev),
                            at(torch.full(neg.shape, -5, dtype=torch.int32), -5) if send else None,
                            acc_set=acc_set, tag=tag)


@pytest.mark.parametrize("w,offset", [(32, 0), (33, 0), (32, 1), (6, 0)])
@pytest.mark.parametrize("acc_set,send", [(True, True), (False, True), (False, False)])
def test_chunk_merge_send_matches_plain(cuda, w, offset, acc_set, send):
    """M1's commit with its send epilogue (the exchange's form: changed set
    to delta; a wave's: ORed), the flag set to the tag: the 16-byte form
    (W = 32), the int32 form (W = 33 and 6, or planes one lane off their
    alignment) bit for bit against the plain version; a second commit of
    the same candidates improves nothing, leaves the flag and sends zeros."""
    rng = np.random.default_rng(w + offset)
    shape = (2500, w)
    neg, parts = _neg_planes(rng, shape), [_neg_planes(rng, shape) for _ in range(2)]
    before = torch.from_numpy(rng.random(shape) < 0.2)
    outs = {}
    for where, dev in (("plain", torch.device("cpu")), ("card", cuda)):
        c = _commit_on(dev, neg, before, send, acc_set, offset=offset)
        ps = [p.to(dev) for p in parts]
        timing.reset_launch_counts()
        for tag in (9, 11):
            c = c._replace(tag=tag)
            if where == "plain":
                cuda_mesh.chunk_merge_plain(ps, None, "max", c)
            else:
                cuda_mesh.chunk_merge(ps, op="max", commit=c)
            outs[where, tag] = [t.cpu().clone() for t in c.tensors() if t is not None]
        if where == "card":
            assert timing.launch_counts() == {"chunk_merge": 2}
    for tag in (9, 11):
        for a, b in zip(outs["card", tag], outs["plain", tag]):
            assert torch.equal(a, b), tag
    assert int(outs["card", 11][3]) == 9  # the second commit improved nothing
    if send:
        assert bool((outs["card", 11][4] == 0).all())


@pytest.mark.parametrize("graph,w,offset", [("road", 32, 0), ("road", 33, 0), ("rmat", 32, 0),
                                            ("rmat", 6, 0), ("rmat", 32, 1)])
def test_forest_max_commit_matches_plain(cuda, graph, w, offset):
    """M4's commit form (``forest_max_commit``: the own rows of a local
    wave folded and committed in the last level's launch, the next send
    written) bit for bit against its plain version (the take, then M1's
    commit and the send's where) over neg, delta, changed, flag and send:
    a one-level road forest and a multi-level RMAT forest, every own row
    chunk in turn on one plane, 16-byte and int32 forms; gated off, nothing
    moves."""
    n, edges = (generators.road_edges(96, 96, seed=2) if graph == "road"
                else generators.rmat_edges(12, 8, seed=4))
    g = CSRGraph.from_edges(n, edges)
    rng = np.random.default_rng(w + offset + 3)
    block = _neg_planes(rng, (n, w), spread=6)
    lsub = n // 4
    neg = _neg_planes(rng, (lsub, w), share=0.5, spread=8)
    before = torch.from_numpy(rng.random((lsub, w)) < 0.2)
    floor = cuda_mesh.cand_floor(4)
    host = BellGraph.from_host(g, torch.device("cpu"), keep_sparse=False)
    bg = BellGraph.from_host(g, cuda, keep_sparse=False)
    levels = len(bg.level_cols)
    assert (levels == 1) == (graph == "road")
    commits = {"plain": _commit_on(torch.device("cpu"), neg, before, True),
               "card": _commit_on(cuda, neg, before, True, offset=offset)}
    go = {"plain": cuda_mesh.go_control("cpu"), "card": cuda_mesh.go_control(cuda)}
    front = {"plain": block, "card": block.to(cuda)}
    for chunk in range(4):
        timing.reset_launch_counts()
        for where, graph_ in (("plain", host), ("card", bg)):
            commits[where] = commits[where]._replace(tag=chunk + 3)
            cuda_mesh.forest_max_hits_commit(front[where], graph_, chunk * lsub, commits[where],
                                             floor, go[where])
        launched = {"forest_max_commit": 1}
        if levels > 1:
            launched["forest_max"] = levels - 1
        assert timing.launch_counts() == launched
        for a, b in zip(commits["card"].tensors(), commits["plain"].tensors()):
            assert torch.equal(a.cpu(), b), chunk
    held = [t.clone() for t in commits["card"].tensors()]
    stale = torch.tensor([1, 0, 0, 1], dtype=torch.int32, device=cuda)  # the push direction
    cuda_mesh.forest_max_hits_commit(front["card"], bg, 0, commits["card"]._replace(tag=99),
                                     floor, stale)
    for a, b in zip(commits["card"].tensors(), held):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("total,density,offset", [
    (1, 1.0, 0), (5000, 0.01, 0), (524288, 0.001, 0), (524288, 0.3, 0), (262144 * 2, 0.0, 0),
    (2**20 + 3, 0.05, 0), (2**20 + 3, 0.05, 1), (6147, 0.5, 3)])
def test_wire_encode_matches_plain(cuda, lanes, total, density, offset):
    """Counts at, under and over the budget (the count whole even when
    the list is cut), the cut inside a tile and exactly at a tile's edge,
    ascending indices, sentinels past the nonzero words, one launch a call;
    a plane ``offset`` words into its buffer (misaligned for 16-byte
    loads); the calls alternate between the plane and another on one
    scratch, so a stale status word would show.  Decoded by H1 into zeros
    it is the plane inside the budget."""
    rng = np.random.default_rng(total + lanes + offset)
    planes = []
    for _ in range(2):
        base = _planes(rng, total + offset, 1).view(-1)
        base[torch.from_numpy(rng.random(total + offset) >= density)] = 0
        if lanes == 4:
            base &= 0x01000100
        planes.append(base)
    pos = torch.nonzero(planes[0][offset:]).flatten().numpy()
    nz = pos.size
    tile = cuda_mesh.ENCODE_TILE
    budgets = {1, max(1, nz - 1), max(1, nz), nz + 17}
    if nz > 2:
        budgets.add(next((k for k in range(nz // 2, nz) if pos[k] // tile == pos[k - 1] // tile),
                         nz))
        budgets.add(max(1, int((pos < tile * (pos[nz // 2] // tile)).sum())))
    scratch = cuda_halo.ScanScratch(cuda_mesh.encode_tiles(total), cuda)
    on_card = [p.to(cuda) for p in planes]
    for budget in sorted(budgets):
        for which in (0, 1):
            plane = planes[which][offset:]
            want = cuda_mesh.wire_encode_plain(plane, budget, lanes)
            timing.reset_launch_counts()
            got = cuda_mesh.wire_encode(on_card[which][offset:], budget, lanes, scratch)
            assert timing.launch_counts() == {"wire_encode": 1}
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), (budget, which)
        if budget >= nz:
            got = cuda_mesh.wire_encode(on_card[0][offset:], budget, lanes)
            buf = torch.zeros(total, dtype=torch.int32, device=cuda)
            timing.reset_launch_counts()
            cuda_mesh.wire_decode(got.idx, got.words, buf)
            assert timing.launch_counts() == {"halo_pair_or": 1}
            assert torch.equal(buf.cpu(), planes[0][offset:])


@pytest.mark.parametrize("max_levels,kpad", [(None, 32), (3, 32), (None, 64)])
def test_forest_max_matches_plain(cuda, max_levels, kpad):
    """M4 whole (a launch a forest level, the last with the final take in
    its launch) and in segments of at most 4096 slots, against the plain
    forest max-fold followed by the candidate step."""
    n, edges = generators.rmat_edges(12, 8, seed=4)
    g = CSRGraph.from_edges(n, edges)
    rng = np.random.default_rng(kpad)
    neg = torch.from_numpy(np.where(rng.random((n, kpad)) < 0.2,
                                    bitbell.NEG_BASE - rng.integers(0, 6, (n, kpad)),
                                    0).astype(np.int32))
    floor = cuda_mesh.cand_floor(max_levels)
    host = BellGraph.from_host(g, torch.device("cpu"), keep_sparse=False)
    want = torch.zeros_like(neg)
    cuda_mesh.forest_max_hits_plain(neg, host, want, floor)
    bg = BellGraph.from_host(g, cuda, keep_sparse=False)
    got = torch.zeros((n, kpad), dtype=torch.int32, device=cuda)
    timing.reset_launch_counts()
    cuda_mesh.forest_max_hits(neg.to(cuda), bg, got, floor, cuda_mesh.go_control(cuda))
    levels = sum(1 for s in bg.level_sizes if s)
    assert levels > 1
    assert timing.launch_counts() == {"forest_max": levels}
    variants = {"forest_max:cand": 1, "forest_max:max": levels - 2, "forest_max:max/take": 1}
    assert timing.variant_counts() == {k: v for k, v in variants.items() if v}
    assert torch.equal(got.cpu(), want)
    # The streamed segment form, through the streamed engine's ring.
    seng = streamed.StreamedBitBellEngine(BellGraph.from_host(g, False), cuda, slot_budget=4096)
    got2 = torch.zeros_like(got)
    seng.forest_pass(neg.to(cuda), got2, cuda_mesh.go_control(cuda), floor=floor)
    assert torch.equal(got2.cpu(), want)


@pytest.mark.parametrize("graph,w,offset", [
    ("road", 32, 0), ("road", 1, 0), ("road", 3, 0), ("road", 64, 0), ("road", 32, 1),
    ("rmat", 32, 0), ("rmat", 33, 0), ("rmat", 160, 0), ("rmat", 36, 1)])
def test_forest_max_take_matches_plain(cuda, graph, w, offset):
    """M4's take form against its plain version: a one-level road forest
    in one launch (``cand/take``: the fold in final row order with the
    candidate step, the sentinel rows zero), a multi-level RMAT forest
    (its last level's take copying rows of the earlier levels); rows of 1,
    3 and 33 int32 lanes, of 16-byte vectors (32, 36, 64 and 160 lanes:
    160 takes two passes of a warp), and planes one word off their
    alignment (the int32 instance).  Gated off, the hits stay."""
    n, edges = (generators.road_edges(96, 96, seed=2) if graph == "road"
                else generators.rmat_edges(12, 8, seed=4))
    g = CSRGraph.from_edges(n, edges)
    rng = np.random.default_rng(w + offset)
    neg = torch.from_numpy(np.where(rng.random((n, w)) < 0.3,
                                    bitbell.NEG_BASE - rng.integers(0, 6, (n, w)),
                                    0).astype(np.int32))
    floor = cuda_mesh.cand_floor(4)
    host = BellGraph.from_host(g, torch.device("cpu"), keep_sparse=False)
    want = torch.zeros_like(neg)
    cuda_mesh.forest_max_hits_plain(neg, host, want, floor)
    bg = BellGraph.from_host(g, cuda, keep_sparse=False)
    levels = len(bg.level_cols)
    assert (levels == 1) == (graph == "road")
    buf = torch.full((n * w + offset,), -7, dtype=torch.int32, device=cuda)
    front = torch.empty(n * w + offset, dtype=torch.int32, device=cuda)
    front[offset:] = neg.to(cuda).view(-1)
    got = buf[offset:].view(n, w)
    timing.reset_launch_counts()
    cuda_mesh.forest_max_hits(front[offset:].view(n, w), bg, got, floor,
                              cuda_mesh.go_control(cuda))
    assert timing.launch_counts() == {"forest_max": levels}
    if levels == 1:
        assert timing.variant_counts() == {"forest_max:cand/take": 1}
    assert torch.equal(got.cpu(), want)
    stale = torch.full((n, w), -7, dtype=torch.int32, device=cuda)
    ctrl = torch.tensor([1, 0, 0, 1], dtype=torch.int32, device=cuda)  # the push direction
    cuda_mesh.forest_max_hits(front[offset:].view(n, w), bg, stale, floor, ctrl)
    assert bool((stale == -7).all())


@pytest.mark.parametrize("env", [{"MSBFS_MESH": "2x2"}, {"MSBFS_MESH": "2x2", "MSBFS_WIRE_SPARSE": "0",
                                                         "MSBFS_MERGE_TREE": "oneshot"},
                                 {"MSBFS_MESH": "2x2", "MSBFS_MESH_PLANE": "byte"},
                                 {"MSBFS_MESH": "2x2", "MSBFS_MESH_KERNEL": "mxu",
                                  "MSBFS_MXU_TILE": "32"},
                                 {"MSBFS_MESH": "2x2", "MSBFS_MESH_RESIDENCY": "streamed"},
                                 {"MSBFS_MESH": "1x4", "MSBFS_ASYNC_LEVELS": "3"},
                                 {"MSBFS_MESH": "2x2", "MSBFS_ASYNC_LEVELS": "3",
                                  "MSBFS_MESH_RESIDENCY": "streamed"},
                                 {"MSBFS_MESH": "4x1", "MSBFS_MERGE_TREE": "pipelined",
                                  "MSBFS_WIRE_CHUNKS": "2"}])
def test_mesh2d_cli_on_card(cuda, tmp_path, capsys, monkeypatch, env):
    """MSBFS_MESH at -gn 4 over a logical mesh on the card reports what
    the same mesh of CPU entries reports (the plain versions)."""
    n, edges = generators.road_edges(60, 60, seed=5)
    gpath, qpath = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, 20, max_group=5, seed=6))
    argv = ["prog", "-g", gpath, "-q", qpath, "-gn", "4"]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert cli.main(argv, device="cpu", mesh_devices=["cpu"] * 4) == 0
    want = capsys.readouterr().out.splitlines()[:5]
    # Each sparse col leg on the card: one H1 segmented launch a destination
    # shard (its C peers' pairs at once), counted around the leg itself.
    legs = []
    real_leg = partition2d.Mesh2DEngine._col_sparse

    def col_sparse(self, run, enc, w, commit=None):
        before = timing.variant_counts().get("halo_pair_or:seg", 0)
        real_leg(self, run, enc, w, commit)
        if torch.device(self.shards[0].dev).type == "cuda":
            legs.append((len(self.shards),
                         timing.variant_counts().get("halo_pair_or:seg", 0) - before))

    monkeypatch.setattr(partition2d.Mesh2DEngine, "_col_sparse", col_sparse)
    timing.reset_launch_counts()
    assert cli.main(argv, mesh_devices=[cuda] * 4) == 0
    assert capsys.readouterr().out.splitlines()[:5] == want
    counts = timing.launch_counts()
    assert all(launched == shards for shards, launched in legs), legs
    # The col leg ran on the card: M1 (dense legs, MAX commits) or a sparse
    # leg's segmented H1.
    assert counts.get("chunk_merge", 0) > 0 or legs or env["MSBFS_MESH"] == "4x1", counts


def test_mesh2d_async_local_waves_commit_in_m4(cuda, tmp_path, capsys, monkeypatch):
    """The async drive (MSBFS_MESH=2x2, MSBFS_ASYNC_LEVELS=4) through the CLI
    on the card reports what the CPU mesh reports; its local waves are M4's
    commit form, one launch a shard a wave, and M1 runs only on the
    exchanges' commits (one a shard a round, its send in the launch)."""
    n, edges = generators.road_edges(60, 60, seed=5)
    gpath, qpath = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, 20, max_group=5, seed=6))
    argv = ["prog", "-g", gpath, "-q", qpath, "-gn", "4"]
    monkeypatch.setenv("MSBFS_MESH", "2x2")
    monkeypatch.setenv("MSBFS_ASYNC_LEVELS", "4")
    assert cli.main(argv, device="cpu", mesh_devices=["cpu"] * 4) == 0
    want = capsys.readouterr().out.splitlines()[:5]
    rounds, waves = [], []
    real_ex, real_waves = partition2d.Mesh2DEngine._exchange, partition2d.Mesh2DEngine._local_waves

    def exchange(self, run, floor):
        if self.shards[0].dev.type == "cuda":
            rounds.append(timing.launch_counts().get("chunk_merge", 0))
        out = real_ex(self, run, floor)
        if self.shards[0].dev.type == "cuda":
            rounds[-1] = timing.launch_counts().get("chunk_merge", 0) - rounds[-1]
        return out

    def local_waves(self, run, floor):
        before = dict(timing.launch_counts())
        tag = run.tag
        real_waves(self, run, floor)
        if self.shards[0].dev.type == "cuda":
            after = timing.launch_counts()
            waves.append((run.tag - tag,
                          {k: after.get(k, 0) - before.get(k, 0) for k in after}))

    monkeypatch.setattr(partition2d.Mesh2DEngine, "_exchange", exchange)
    monkeypatch.setattr(partition2d.Mesh2DEngine, "_local_waves", local_waves)
    timing.reset_launch_counts()
    assert cli.main(argv, mesh_devices=[cuda] * 4) == 0
    assert capsys.readouterr().out.splitlines()[:5] == want
    assert rounds and all(r == 4 for r in rounds), rounds
    assert waves
    for count, launched in waves:
        assert launched.get("chunk_merge", 0) == 0, launched
        assert launched.get("forest_max_commit", 0) == 4 * count, (count, launched)
    variants = timing.variant_counts()
    assert variants.get("chunk_merge:max/commit/send", 0) == timing.launch_counts()["chunk_merge"]
