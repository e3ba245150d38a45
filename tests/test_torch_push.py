"""The port's ``push`` and ``ppush`` routes against the JAX package on the
same seeded inputs: the padded adjacency table byte for byte and its
width-cap error, the compactions, ``push_run``, both engines' results,
their capacity protocol (the same stderr lines and capacity after every
call on thin, fat and thin batches; an explicit capacity raises
``FrontierOverflow``, exit 3), their per-level trace, the chunk knob,
K = 0 and out-of-range sources.  The plain versions of K10 and K11 (and
of K3 on the union queue) run here; every value is an integer, so every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    push as jpush,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    push_packed as jpush_packed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    push,
    push_packed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
    supervisor,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import io

ENGINES = {
    "push": (push.PushEngine, jpush.PushEngine),
    "ppush": (push_packed.PackedPushEngine, jpush_packed.PackedPushEngine),
}


def _edges(kind):
    if kind == "road":
        return generators.road_edges(30, 30, seed=3)
    if kind == "isolated":
        n, e = generators.road_edges(8, 9, seed=4)
        return n + 7, np.concatenate([e, [[3, 3], [5, 6], [5, 6]]]).astype(np.int32)
    n, e = generators.rmat_edges(7, edge_factor=4, seed=5)
    return n, e


def _tables(kind, max_width=push.DEFAULT_MAX_WIDTH):
    n, e = _edges(kind)
    return (n, push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), "cpu", max_width),
            jpush.PaddedAdjacency.from_host(JCSRGraph.from_edges(n, e), max_width))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["road", "isolated", "rmat"])
def test_padded_adjacency_matches_jax(kind, native):
    n, e = _edges(kind)
    adj = push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), "cpu", native=native)
    jadj = jpush.PaddedAdjacency.from_host(JCSRGraph.from_edges(n, e))
    assert adj.rows.dtype == torch.int32
    assert adj.rows.numpy().tobytes() == np.asarray(jadj.rows).tobytes()
    assert (adj.n, adj.width, adj.num_edges) == (jadj.n, jadj.width, jadj.num_edges)


def test_width_cap_error_matches_jax():
    n, e = _edges("rmat")
    with pytest.raises(ValueError) as got:
        push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), "cpu", max_width=4)
    with pytest.raises(ValueError) as want:
        jpush.PaddedAdjacency.from_host(JCSRGraph.from_edges(n, e), max_width=4)
    assert str(got.value) == str(want.value) and "width cap 4" in str(got.value)


@pytest.mark.parametrize("capacity", [1, 7, 40, 200])
def test_compactions_match_jax(capacity):
    rng = np.random.default_rng(capacity)
    mask = (rng.random(150) < 0.2).astype(np.uint8)
    want = jpush.compact_indices(jnp.asarray(mask), capacity)
    got = push.compact_indices(torch.from_numpy(mask), capacity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = push.compact_indices(torch.from_numpy(mask), capacity, fill_value=-3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpush.compact_indices(jnp.asarray(mask), capacity, -3)))
    planes = rng.integers(0, 2**32, size=(60, 3), dtype=np.uint64).astype(np.uint32)
    planes[rng.random(60) < 0.7] = 0
    want = jpush.compact_frontier_planes(jnp.asarray(planes), capacity, 60)
    got = push.compact_frontier_planes(torch.from_numpy(planes.view(np.int32)), capacity, 60)
    assert int(got[0]) == int(want[0])
    for x, y in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(got[3].numpy().view(np.uint32), np.asarray(want[3]))


def _queries(n, k, seed, max_group=6):
    q = io.pad_queries(generators.random_queries(n, k, max_group=max_group, seed=seed))
    if k > 3:
        q[1, 0] = n + 4  # out of range: dropped
        q[2] = -1  # an empty group
        q[3, :2] = [5, 5]  # a repeated source counts once
    return q


@pytest.mark.parametrize("capacity,chunk,max_levels", [
    (900, None, None), (60, 5, None), (25, 1, None), (900, 3, 7),
])
@pytest.mark.parametrize("kind", ["road", "isolated"])
def test_push_run_matches_jax(kind, capacity, chunk, max_levels):
    n, adj, jadj = _tables(kind)
    q = _queries(n, 9, 11)
    got = push.push_run(adj, q, capacity, max_levels, chunk)
    want = jpush.push_run(jadj, jnp.asarray(q), capacity, max_levels, chunk)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("max_levels", [None, 6])
@pytest.mark.parametrize("cls", list(ENGINES))
@pytest.mark.parametrize("kind", ["road", "isolated"])
def test_engines_match_jax(kind, cls, max_levels):
    n, adj, jadj = _tables(kind)
    mine, theirs = ENGINES[cls]
    q = _queries(n, 13, 21)
    got, want = mine(adj, max_levels=max_levels), theirs(jadj, max_levels=max_levels)
    for x, y in zip(got.query_stats(q), want.query_stats(q)):
        np.testing.assert_array_equal(x, np.asarray(y))
    np.testing.assert_array_equal(got.f_values(q).numpy(), np.asarray(want.f_values(q)))
    assert got.best(q) == want.best(q)
    assert got.capacity == want.capacity
    for x, y in zip(got.level_stats(q)[:4], want.level_stats(q)[:4]):
        np.testing.assert_array_equal(x, np.asarray(y))
    # K = 0: empty results, no capacity change.
    for x, y in zip(got.query_stats(q[:0]), want.query_stats(q[:0])):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert got.f_values(q[:0]).shape == (0,)
    for x, y in zip(got.level_stats(q[:0]), want.level_stats(q[:0])):
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("cls", list(ENGINES))
def test_capacity_protocol_matches_jax(cls, capsys):
    """Thin, fat and thin batches on a road grid: the first thin batch
    shrinks the auto start (2048) to 1024, the fat one overflows it and
    reruns, the last thin one keeps the grown capacity (the peak over
    every run bounds the shrink) — the same stderr lines and the same
    capacity after every call; and the per-level trace's re-trace line."""
    n, e = generators.road_edges(64, 64, seed=7)
    adj = push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), "cpu")
    jadj = jpush.PaddedAdjacency.from_host(JCSRGraph.from_edges(n, e))
    thin = io.pad_queries(generators.random_queries(n, 3, max_group=2, seed=1))
    fat = io.pad_queries(generators.random_queries(n, 4, max_group=1200, seed=2))
    trails = []
    for eng in (ENGINES[cls][0](adj), ENGINES[cls][1](jadj)):
        trail = []
        for batch in (thin, fat, thin):
            stats = eng.query_stats(batch)
            trail.append((eng.capacity, [np.asarray(x).tolist() for x in stats],
                          capsys.readouterr().err))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert "re-running at" in trails[0][1][2]
    assert trails[0][1][0] > trails[0][0][0]  # grown past the shrunk start
    rng = np.random.default_rng(3)
    fatter = np.stack([rng.choice(n, 3000, replace=False) for _ in range(2)]).astype(np.int32)
    traces = []
    for eng in (ENGINES[cls][0](adj), ENGINES[cls][1](jadj)):
        got = eng.level_stats(fatter)
        traces.append(([np.asarray(x).tolist() for x in got[:4]], eng.capacity,
                       capsys.readouterr().err))
    assert traces[0] == traces[1] and "re-tracing at" in traces[0][2]


@pytest.mark.parametrize("cls", list(ENGINES))
def test_explicit_capacity_raises_frontier_overflow(cls):
    n, adj, _ = _tables("road")
    q = _queries(n, 6, 4, max_group=40)
    with pytest.raises(push.FrontierOverflow, match="construct PushEngine") as err:
        ENGINES[cls][0](adj, capacity=8).f_values(q)
    assert isinstance(err.value, supervisor.CapacityError)
    assert supervisor.classify(err.value).exit_code == 3
    with pytest.raises(push.FrontierOverflow):
        ENGINES[cls][0](adj, capacity=8).level_stats(q)


@pytest.mark.parametrize("value,want", [("", 64), ("7", 7), ("0", 1), ("-3", 1), ("x", 64)])
def test_push_chunk_knob_matches_jax(monkeypatch, value, want):
    monkeypatch.setenv("MSBFS_PUSH_CHUNK", value)
    assert push.default_push_chunk() == jpush.default_push_chunk() == want


def test_packed_push_on_an_empty_graph_matches_jax():
    adj = push.PaddedAdjacency.from_host(CSRGraph.from_edges(0, np.zeros((0, 2))), "cpu")
    jadj = jpush.PaddedAdjacency.from_host(JCSRGraph.from_edges(0, np.zeros((0, 2))))
    q = np.array([[0, -1], [3, 2]], np.int32)
    got = push_packed.PackedPushEngine(adj).query_stats(q)
    want = jpush_packed.PackedPushEngine(jadj).query_stats(q)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y))
