"""The port's stencil route (plain versions of kernels A, B, C on the CPU)
against the JAX package's StencilEngine(kernel=True), whose Pallas sweep
runs in interpret mode here.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    pallas_stencil,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    stencil as js,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    timing as jtiming,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    cuda_stencil,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    stencil as ts,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops.engine import (
    QueryEngineBase,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    timing,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils.io import (
    pad_queries,
)


def _sparse_demotion():
    n, grid = generators.grid_edges(31, 17)
    sparse = np.array([[i * 50, i * 50 + 23] for i in range(5)], np.int32)
    return n, np.concatenate([grid, sparse], axis=0)


def _straddling_residual():
    """A road lattice plus off-lattice edges whose destinations sit on
    both sides of every 64th row (the boundaries of the sweep kernel's
    tiles at that tile size), several sharing a destination."""
    n, road = generators.road_edges(32, 32, seed=934)
    rng = np.random.default_rng(934)
    bounds = np.arange(64, n, 64)
    dst = np.concatenate([bounds - 1, bounds, bounds])
    src = rng.integers(0, n, size=dst.size)
    extra = np.stack([src, dst], 1).astype(np.int32)
    return n, np.concatenate([road, extra], axis=0)


GRAPHS = {
    "road": (generators.road_edges(24, 24, seed=921), {}),
    "road_rect": (generators.road_edges(13, 37, seed=922), {}),
    "grid": (generators.grid_edges(19, 7), {}),
    "residual_road": (
        generators.road_edges(24, 24, seed=932, shortcut_frac=0.02), {}
    ),
    "demotion": (_sparse_demotion(), dict(max_offsets=8, max_residual_frac=0.1)),
    "straddle": (_straddling_residual(), dict(max_residual_frac=0.1)),
}


def _both(name):
    (n, edges), kw = GRAPHS[name]
    tg = CSRGraph.from_edges(n, edges)
    jg = JCSRGraph.from_edges(n, edges)
    tdec = ts.detect_stencil(tg, **kw)
    jdec = js.detect_stencil(jg, **kw)
    tsg = ts.StencilGraph.from_decomposition(
        n, tg.num_directed_edges, *tdec, "cpu"
    )
    jsg = js.StencilGraph.from_decomposition(n, jg.num_directed_edges, *jdec)
    return tg, jg, tdec, jdec, tsg, jsg


def _same_graph(tsg, jsg):
    assert (tsg.n, tsg.num_directed_edges, tsg.offsets) == (
        jsg.n, jsg.num_directed_edges, jsg.offsets
    )
    np.testing.assert_array_equal(
        tsg.mask_bits.numpy().view(np.uint32), np.asarray(jsg.mask_bits)
    )
    for field in ("res_src", "res_seg", "res_dst_unique"):
        np.testing.assert_array_equal(
            getattr(tsg, field).numpy(), np.asarray(getattr(jsg, field))
        )


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_detection_and_layout_match_jax(name):
    tg, jg, tdec, jdec, tsg, jsg = _both(name)
    np.testing.assert_array_equal(tg.row_offsets, jg.row_offsets)
    np.testing.assert_array_equal(tg.col_indices, jg.col_indices)
    assert tdec[0] == jdec[0]
    for a, b in zip(tdec[1:], jdec[1:]):
        np.testing.assert_array_equal(a, b)
    _same_graph(tsg, jsg)
    if name == "residual_road":
        assert tsg.res_src.shape[0] > 0
    if name == "demotion":
        assert 23 in tdec[0] and 23 not in tsg.offsets
    if name == "straddle":
        dst = tsg.residual.dst.numpy()
        assert (dst % 64 == 63).any() and (dst % 64 == 0).any()


def test_from_host_matches_jax_and_rejects_unbanded():
    (n, edges), _ = GRAPHS["road"]
    _same_graph(
        ts.StencilGraph.from_host(CSRGraph.from_edges(n, edges), "cpu"),
        js.StencilGraph.from_host(JCSRGraph.from_edges(n, edges)),
    )
    n, edges = 300, np.random.default_rng(923).integers(0, 300, size=(900, 2))
    assert ts.detect_stencil(CSRGraph.from_edges(n, edges)) is None
    with pytest.raises(ValueError, match="not banded"):
        ts.StencilGraph.from_host(CSRGraph.from_edges(n, edges), "cpu")
    assert ts.detect_stencil(CSRGraph.from_edges(5, np.zeros((0, 2)))) is None


def _random_frontier(n, w, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(np.uint32)
    words[rng.random(n) < 0.8] = 0
    return words


@pytest.mark.parametrize("name", ["road", "residual_road", "demotion", "straddle"])
def test_sweep_and_residual_match_jax(name, monkeypatch):
    """Kernels A and B (plain, on the CPU) against the JAX Pallas chain —
    forced to several halo-stitched chunks, on one lattice — and against
    stencil_hits(kernel=True), residual included, on all three."""
    *_, tsg, jsg = _both(name)
    words = _random_frontier(tsg.n, 1, seed=1)
    frontier = torch.from_numpy(words.view(np.int32))
    sweep = torch.empty_like(frontier)
    before = timing.launch_counts()
    cuda_stencil.stencil_sweep(
        frontier, tsg.mask_bits, tsg.offsets, sweep,
        torch.tensor([1, 0, 0, 0], dtype=torch.int32), 10,
    )
    assert timing.launch_counts() == before  # CPU tensors launch nothing
    if name == "road":
        monkeypatch.setattr(pallas_stencil, "MAX_TOTAL_ROWS", 4)
        want_sweep = pallas_stencil.pallas_hits(
            jnp.asarray(words[:, 0]), jsg.mask_bits, jsg.offsets
        )
        np.testing.assert_array_equal(
            sweep.numpy().view(np.uint32)[:, 0], np.asarray(want_sweep)
        )
        monkeypatch.undo()
    want = js.stencil_hits(jnp.asarray(words[:, 0]), jsg, kernel=True)
    got = ts.stencil_hits(frontier, tsg)
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[:, 0], np.asarray(want))
    # Wider planes run the same sweep per word (the JAX XLA form at W > 1).
    words3 = _random_frontier(tsg.n, 3, seed=2)
    visited = _random_frontier(tsg.n, 3, seed=3)
    want3 = js.stencil_new(jnp.asarray(visited), jnp.asarray(words3), jsg, kernel=True)
    got3 = ts.stencil_new(
        torch.from_numpy(visited.view(np.int32)),
        torch.from_numpy(words3.view(np.int32)), tsg,
    )
    np.testing.assert_array_equal(got3.numpy().view(np.uint32), np.asarray(want3))


def _first_min(f):
    """The reference's winner over an F vector: first strict minimum."""
    k = int(np.argmin(f))
    return int(f[k]), k


def _queries(n, k, seed):
    """K groups with the edge cases: an empty group, duplicate and
    out-of-range sources, and a tie with an earlier group."""
    queries = generators.random_queries(n, k, max_group=4, seed=seed)
    if k > 3:
        queries[1] = np.zeros(0, dtype=np.int32)
        queries[2] = np.array([0, -1, n + 3, 0], dtype=np.int32)
        queries[3] = queries[0].copy()
    if k >= 32:
        queries[31] = np.array([n - 1], dtype=np.int32)  # bit 31 of word 0
    return pad_queries(queries, pad_to=4)


@pytest.mark.parametrize(
    "name,k",
    [("residual_road", k) for k in (1, 31, 32, 40, 70)] + [("road", 32), ("straddle", 33)],
)
def test_engine_matches_jax(name, k):
    *_, tsg, jsg = _both(name)
    queries = _queries(tsg.n, k, seed=k)
    for level_chunk in (None, 4):
        teng = ts.StencilEngine(tsg, level_chunk=level_chunk)
        jeng = js.StencilEngine(jsg, level_chunk=level_chunk, kernel=True)
        got = teng.query_stats(queries)
        want = jeng.query_stats(queries)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(teng.f_values(queries).numpy(), want[2])
        best = teng.best(queries)
        assert best == _first_min(want[2])
        if k == 40:  # JAX's own fused best, once (each shape compiles anew)
            assert best == jeng.best(queries)
        # The fused status read and the generic run-then-select agree.
        assert best == QueryEngineBase.best(teng, queries)


def test_window_trace_matches_jax():
    n, edges = generators.grid_edges(200, 8)
    tsg = ts.StencilGraph.from_host(CSRGraph.from_edges(n, edges), "cpu")
    jsg = js.StencilGraph.from_host(JCSRGraph.from_edges(n, edges))
    rng = np.random.default_rng(933)
    queries = pad_queries(
        [rng.integers(0, 40, size=rng.integers(1, 4)).astype(np.int32) for _ in range(5)]
    )
    teng = ts.StencilEngine(tsg, level_chunk=4, window=True)
    jeng = js.StencilEngine(jsg, level_chunk=4, window=True)
    assert teng.window_active and jeng.window_active
    timing.reset_plane_pass()
    timing.reset_dispatch_count()
    got = teng.query_stats(queries)
    port_bytes, port_syncs = timing.plane_pass_bytes(), timing.dispatch_count()
    jtiming.reset_plane_pass()
    jtiming.reset_dispatch_count()
    want = jeng.query_stats(queries)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert teng.last_window_trace == jeng.last_window_trace
    assert any(rows < n for *_, rows in teng.last_window_trace)
    # One host sync per chunk, and the same analytic stream bytes, as JAX.
    assert port_syncs == len(teng.last_window_trace) == jtiming.dispatch_count()
    assert port_bytes == jtiming.plane_pass_bytes() > 0
    assert teng.best(queries) == _first_min(want[2])
    # The window is exact: the full-plane run gives the same answers.
    full = ts.StencilEngine(tsg, level_chunk=4, window=False).query_stats(queries)
    for x, y in zip(got, full):
        np.testing.assert_array_equal(x, y)


def test_max_levels_cutoff_matches_jax():
    *_, tsg, jsg = _both("road")
    queries = _queries(tsg.n, 9, seed=4)
    for level_chunk in (None, 3):
        got = ts.StencilEngine(tsg, max_levels=5, level_chunk=level_chunk).query_stats(queries)
        want = js.StencilEngine(jsg, max_levels=5, level_chunk=level_chunk).query_stats(queries)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


def test_from_numpy_carries_jax_state():
    (n, edges), _ = GRAPHS["residual_road"]
    jsg = js.StencilGraph.from_host(JCSRGraph.from_edges(n, edges))
    carried = ts.StencilGraph.from_numpy(
        jsg.n, jsg.num_directed_edges, jsg.offsets, np.asarray(jsg.mask_bits),
        np.asarray(jsg.res_src), np.asarray(jsg.res_seg),
        np.asarray(jsg.res_dst_unique), "cpu",
    )
    built = ts.StencilGraph.from_host(CSRGraph.from_edges(n, edges), "cpu")
    _same_graph(carried, jsg)
    queries = _queries(n, 40, seed=8)
    for x, y in zip(
        ts.StencilEngine(carried, level_chunk=4).query_stats(queries),
        ts.StencilEngine(built, level_chunk=4).query_stats(queries),
    ):
        np.testing.assert_array_equal(x, y)


def test_empty_batch_and_all_padding():
    *_, tsg, _ = _both("grid")
    eng = ts.StencilEngine(tsg, level_chunk=4)
    assert eng.best(np.zeros((0, 2), np.int32)) == (-1, -1)
    assert eng.best(np.full((3, 2), -1, np.int32)) == (0, 0)
    assert eng.f_values(np.zeros((0, 2), np.int32)).shape == (0,)
    eng.compile((5, 2))  # warm-up on the CPU runs the plain versions


def test_stencil_level_bytes_matches_jax():
    for args in ((8, 1000, 1), (16, 2**24, 1), (4, 77, 3, 2)):
        assert ts.stencil_level_bytes(*args) == js.stencil_level_bytes(*args)


def test_bad_level_chunk_and_wrapper_checks():
    *_, tsg, _ = _both("grid")
    with pytest.raises(ValueError):
        ts.StencilEngine(tsg, level_chunk=0)
    frontier = torch.zeros((tsg.n, 1), dtype=torch.int32)
    ctrl = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_stencil.stencil_sweep(
            frontier.to(torch.int64), tsg.mask_bits, tsg.offsets,
            frontier, ctrl, 10,
        )
    with pytest.raises(ValueError):
        cuda_stencil.stencil_sweep(
            frontier, tsg.mask_bits[:-1], tsg.offsets, frontier.clone(), ctrl, 10
        )
    with pytest.raises(ValueError):
        cuda_stencil.stencil_sweep(
            frontier, tsg.mask_bits, list(range(1, 34)), frontier.clone(), ctrl, 10
        )
