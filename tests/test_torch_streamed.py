"""The host-streamed engine (ops/streamed.py) against the JAX package on
the same seeded inputs: the host-only BELL layout, and
``StreamedBitBellEngine`` (the plain kernels, on the CPU) against JAX's
``StreamedBitBellEngine`` and JAX's ``BitBellEngine`` in F, levels and
reached, at slot budgets that cut the forest into one segment a level,
two, and many, and at prefetch depths 1, 2 and 3.  Everything is bits
and integers, so every comparison is exact."""

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.bell import (
    BellGraph as JBellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    bitbell as jbb,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    streamed as jstreamed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    BellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    cuda_bell,
    streamed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io as tio,
)


def _edges(kind):
    """A seeded multigraph (duplicate edges, self-loops, a 700-neighbour
    hub that needs a second forest level, isolated vertices) or RMAT-12."""
    if kind == "multigraph":
        rng = np.random.default_rng(17)
        n = 500
        e = rng.integers(0, 420, size=(2500, 2)).astype(np.int32)
        hub = np.stack([np.full(700, 5, np.int32), rng.integers(0, 420, 700).astype(np.int32)], 1)
        return n, np.concatenate([e, e[:300], hub, [[9, 9], [33, 33]]])
    return generators.rmat_edges(12, edge_factor=16, seed=4)


@pytest.fixture(scope="module", params=["multigraph", "rmat12"])
def case(request):
    n, edges = _edges(request.param)
    g, jg = CSRGraph.from_edges(n, edges), JCSRGraph.from_edges(n, edges)
    queries = tio.pad_queries(generators.random_queries(n, 40, max_group=4, seed=n))
    jdev = jbb.BitBellEngine(JBellGraph.from_host(jg), level_chunk=128)
    want = jdev.query_stats(queries)
    host = BellGraph.from_host(g, False, keep_sparse=False)
    return dict(name=request.param, g=g, jg=jg, queries=queries, want=want, host=host)


def _budget(host, segments):
    """A slot budget that cuts the largest forest level into about
    ``segments`` segments (None: whole levels)."""
    if segments == 1:
        return None
    return max(int(c.shape[0]) for c in host.level_cols) // segments + 1


def test_host_layout_equals_device_layout(case):
    """``device=False`` keeps the device layout's arrays, byte for byte,
    as int32 NumPy (and JAX's host layout's), with no dedup CSR."""
    host = case["host"]
    dev = BellGraph.from_host(case["g"], "cpu", keep_sparse=False)
    jhost = JBellGraph.from_host(case["jg"], keep_sparse=False, device=False)
    assert host.device is None and dev.device == torch.device("cpu")
    assert host.sparse is None and jhost.sparse is None
    assert host.level_shapes == dev.level_shapes == tuple(jhost.level_shapes)
    assert host.level_sizes == dev.level_sizes == tuple(jhost.level_sizes)
    assert host.fill == dev.fill
    for mine, ref, theirs in zip(host.level_cols, dev.level_cols, jhost.level_cols, strict=True):
        assert isinstance(mine, np.ndarray) and mine.dtype == np.int32
        assert mine.tobytes() == ref.numpy().tobytes() == np.asarray(theirs).tobytes()
    assert isinstance(host.final_slot, np.ndarray)
    assert host.final_slot.tobytes() == dev.final_slot.numpy().tobytes()
    assert host.final_slot.tobytes() == np.asarray(jhost.final_slot, np.int32).tobytes()
    for (r1, f1), (r2, f2) in zip(host._walk, dev._walk, strict=True):
        assert np.array_equal(r1, r2) and np.array_equal(f1, f2)
    if case["name"] == "multigraph":
        assert len(host.level_sizes) == 2  # the hub's chunk rows fold again


@pytest.mark.parametrize("segments", [1, 2, 8])
@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_streamed_engine_matches_jax(case, segments, prefetch):
    """F, levels and reached equal JAX's in-memory engine's at every cut
    and ring depth, and the winner equals JAX's streamed engine's."""
    budget = _budget(case["host"], segments)
    eng = streamed.StreamedBitBellEngine(
        case["host"], "cpu", slot_budget=budget, prefetch=prefetch
    )
    per_level = [sum(1 for s in eng._segments if s.level == li)
                 for li in range(len(eng.level_rows))]
    if segments == 1:
        assert per_level == [1] * len(per_level)
    else:
        assert max(per_level) >= segments
    assert eng.slots_total == sum(int(c.shape[0]) for c in case["host"].level_cols)
    queries, want = case["queries"], case["want"]
    got = eng.query_stats(queries)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(eng.f_values(queries).numpy(), want[2])
    jstream = jstreamed.StreamedBitBellEngine(
        JBellGraph.from_host(case["jg"], keep_sparse=False, device=False),
        slot_budget=budget, prefetch=prefetch,
    )
    assert eng.best(queries) == jstream.best(queries)


def test_streamed_stats_match_jax_streamed(case):
    """At a two-segment cut, JAX's streamed engine gives the same stats."""
    budget = _budget(case["host"], 2)
    eng = streamed.StreamedBitBellEngine(case["host"], "cpu", slot_budget=budget)
    jstream = jstreamed.StreamedBitBellEngine(
        JBellGraph.from_host(case["jg"], keep_sparse=False, device=False), slot_budget=budget
    )
    for x, y in zip(eng.query_stats(case["queries"]), jstream.query_stats(case["queries"])):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_knobs_and_max_levels(case, monkeypatch):
    """MSBFS_SLOT_BUDGET and MSBFS_STREAM_PREFETCH as in JAX; a level cap
    stops the BFS early as JAX's does; compile warms one real level."""
    monkeypatch.setenv("MSBFS_SLOT_BUDGET", str(_budget(case["host"], 4)))
    monkeypatch.setenv("MSBFS_STREAM_PREFETCH", "3")
    eng = streamed.StreamedBitBellEngine(case["host"], "cpu", max_levels=2)
    jeng = jstreamed.StreamedBitBellEngine(
        JBellGraph.from_host(case["jg"], keep_sparse=False, device=False), max_levels=2
    )
    assert (eng.slot_budget, eng.prefetch) == (jeng.slot_budget, jeng.prefetch)
    assert len(eng._ring) == 3
    for x, y in zip(eng.query_stats(case["queries"]), jeng.query_stats(case["queries"])):
        np.testing.assert_array_equal(x, np.asarray(y))
    eng.compile(case["queries"].shape, warm_stats=True)


def test_segment_form_matches_plain_forest(case):
    """One pass of the streamed forest (ring uploads, the segment wrapper
    on CPU tensors, the final take) equals the in-memory plain forest on
    a random frontier, at two cuts."""
    dev = BellGraph.from_host(case["g"], "cpu", keep_sparse=False)
    rng = np.random.default_rng(5)
    frontier = torch.from_numpy(
        rng.integers(-(2**31), 2**31, size=(dev.n, 3), dtype=np.int64).astype(np.int32))
    frontier[torch.from_numpy(rng.random(dev.n) < 0.5)] = 0
    want = cuda_bell.forest_hits(frontier, dev)
    ctrl = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    for segments in (1, 8):
        eng = streamed.StreamedBitBellEngine(
            case["host"], "cpu", slot_budget=_budget(case["host"], segments))
        hits = torch.empty_like(frontier)
        eng.forest_pass(frontier, hits, ctrl)
        assert torch.equal(hits, want)
        stopped = torch.full_like(frontier, 7)
        eng.forest_pass(frontier, stopped, torch.tensor([0, 0, 0, 0], dtype=torch.int32))
        assert (stopped == 7).all()  # gated off: nothing written


def test_empty_and_edgeless_graphs():
    """No edges (one empty forest level) and no queries, as JAX."""
    g = CSRGraph.from_edges(30, np.zeros((0, 2), np.int32))
    jg = JCSRGraph.from_edges(30, np.zeros((0, 2), np.int32))
    eng = streamed.StreamedBitBellEngine(BellGraph.from_host(g, False), "cpu")
    jeng = jstreamed.StreamedBitBellEngine(JBellGraph.from_host(jg, device=False))
    for q in (tio.pad_queries([[1, 2], [3]]), tio.pad_queries([])):
        for x, y in zip(eng.query_stats(q), jeng.query_stats(q)):
            np.testing.assert_array_equal(x, np.asarray(y))
        assert eng.best(q) == jeng.best(q)
