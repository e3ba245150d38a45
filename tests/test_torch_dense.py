"""The port's ``dense`` route against the JAX package on the same seeded
inputs: the (n_pad, n_pad) bf16 adjacency, one level's expansion, and the
generic engine over it in its drive modes.  The adjacency is 0/1 and the
rest integers, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    dense as jdense,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    engine as jengine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    dense,
    engine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import io


def _edges(kind):
    """(n, edges): an RMAT graph with duplicates and self-loops (n = 256,
    a whole number of 128-lane tiles), a road grid (n = 130, padded to
    256), and a graph with no edges."""
    if kind == "rmat":
        _, e = generators.rmat_edges(8, edge_factor=6, seed=21)
        return 256, np.concatenate([e, [[7, 7], [8, 9], [8, 9]]]).astype(np.int32)
    if kind == "no_edges":
        return 30, np.zeros((0, 2), np.int32)
    return generators.road_edges(10, 13, seed=8)


def _graphs(kind):
    n, e = _edges(kind)
    return (n, dense.DenseGraph.from_host(CSRGraph.from_edges(n, e), "cpu"),
            jdense.DenseGraph.from_host(JCSRGraph.from_edges(n, e)))


@pytest.mark.parametrize("kind", ["rmat", "road", "no_edges"])
def test_adjacency_matches_jax(kind):
    n, g, jg = _graphs(kind)
    assert g.adjacency.dtype == torch.bfloat16
    assert (g.n, g.n_pad) == (jg.n, jg.n_pad) and g.n_pad % dense.LANE == 0
    np.testing.assert_array_equal(
        g.adjacency.float().numpy(), np.asarray(jg.adjacency.astype(jnp.float32))
    )


@pytest.mark.parametrize("kind", ["rmat", "road"])
def test_expand_matches_jax(kind):
    n, g, jg = _graphs(kind)
    rng = np.random.default_rng(5)
    dist = np.full((4, g.n_pad), -1, np.int32)
    dist[:, :n] = rng.integers(-1, 3, size=(4, n))
    got = g.expand_frontier(torch.from_numpy(dist), torch.tensor([0, 1, 2, 1]))
    for q, lvl in enumerate((0, 1, 2, 1)):
        want = jg.expand_frontier(jnp.asarray(dist[q]), jnp.int32(lvl))
        np.testing.assert_array_equal(got[q].numpy(), np.asarray(want))


@pytest.mark.parametrize("level_chunk", [None, 2])
@pytest.mark.parametrize("kind", ["rmat", "road", "no_edges"])
def test_dense_engine_matches_jax(kind, level_chunk):
    n, g, jg = _graphs(kind)
    q = io.pad_queries(generators.random_queries(n, 7, max_group=3, seed=9))
    q[1, 0] = n + 3  # out of range: dropped
    q[2] = -1
    want = jengine.Engine(jg, level_chunk=level_chunk)
    got = engine.Engine(g, level_chunk=level_chunk)
    np.testing.assert_array_equal(got.f_values(q).numpy(), np.asarray(want.f_values(q)))
    for x, y in zip(got.query_stats(q), want.query_stats(q)):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert got.best(q) == want.best(q)
    assert engine.Engine(g).f_values(q[:0]).shape == (0,)
