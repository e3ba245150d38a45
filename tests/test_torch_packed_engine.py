"""The port's ``packed`` route against the JAX package on the same seeded
inputs: one query-minor level (``_packed_expand``) at one and three edge
chunks, the packed distances and their init, and ``PackedEngine`` in its
drive modes (edge chunks, level chunks, ``max_levels``, K = 0).
Everything is integers, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    packed as jpacked,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import packed
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import io


def _edges(kind):
    """(n, edges): an RMAT graph with duplicates, self-loops and isolated
    vertices past its range, a road grid, and a graph with no edges."""
    if kind == "rmat":
        _, e = generators.rmat_edges(8, edge_factor=6, seed=12)
        return 300, np.concatenate([e, [[7, 7], [8, 9], [8, 9]]]).astype(np.int32)
    if kind == "no_edges":
        return 40, np.zeros((0, 2), np.int32)
    return generators.road_edges(11, 13, seed=6)


def _graphs(kind):
    """(n, port DeviceCSR, JAX DeviceCSR) on the CPU."""
    n, e = _edges(kind)
    return n, CSRGraph.from_edges(n, e).to_device("cpu"), JCSRGraph.from_edges(n, e).to_device()


def _queries(n, k, seed):
    q = io.pad_queries(generators.random_queries(n, k, max_group=4, seed=seed))
    if k > 2:
        q[1, 0] = n + 5  # out of range: dropped, as in the reference
        q[2] = -1  # an empty group
    return q


@pytest.mark.parametrize("edge_chunks", [1, 3])
@pytest.mark.parametrize("kind", ["rmat", "road"])
def test_packed_expand_matches_jax(kind, edge_chunks):
    n, g, jg = _graphs(kind)
    dist = np.random.default_rng(4).integers(-1, 4, size=(n, 8)).astype(np.int32)
    want = jpacked._packed_expand(jnp.asarray(dist), jnp.int32(1), jg, edge_chunks)
    got = packed._packed_expand(torch.from_numpy(dist), 1, g, edge_chunks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("edge_chunks,level_chunk", [(1, None), (3, None), (1, 2), (4, 3)])
@pytest.mark.parametrize("kind", ["rmat", "road", "no_edges"])
def test_packed_engine_matches_jax(kind, edge_chunks, level_chunk):
    n, g, jg = _graphs(kind)
    q = _queries(n, 11, 17)
    want = jpacked.PackedEngine(jg, edge_chunks=edge_chunks, level_chunk=level_chunk)
    got = packed.PackedEngine(g, edge_chunks=edge_chunks, level_chunk=level_chunk)
    np.testing.assert_array_equal(got.f_values(q).numpy(), np.asarray(want.f_values(q)))
    for x, y in zip(got.query_stats(q), want.query_stats(q)):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert got.best(q) == want.best(q)
    dist = packed.packed_distances(g, got._pad_queries(q)[0], edge_chunks=edge_chunks)
    jdist = jpacked.packed_distances(jg, jnp.asarray(want._pad_queries(q)[0]),
                                     edge_chunks=edge_chunks)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))


def test_packed_init_and_empty_batch():
    n, g, _ = _graphs("road")
    q = _queries(n, 4, 5)
    np.testing.assert_array_equal(
        packed.packed_init(n, q).numpy(), np.asarray(jpacked.packed_init(n, jnp.asarray(q)))
    )
    eng = packed.PackedEngine(g, max_levels=3)
    jeng = jpacked.PackedEngine(JCSRGraph.from_edges(*_edges("road")).to_device(), max_levels=3)
    np.testing.assert_array_equal(eng.f_values(q).numpy(), np.asarray(jeng.f_values(q)))
    empty = np.zeros((0, 2), np.int32)
    assert eng.f_values(empty).shape == (0,)
    for x, y in zip(eng.query_stats(empty), jeng.query_stats(empty)):
        np.testing.assert_array_equal(x, np.asarray(y))
    eng.compile((4, q.shape[1]))
