"""The port's ``vmap`` route against the JAX package on the same seeded
inputs: the device CSR's arrays, one level of the CSR pull
(``frontier_expand``), the plain version of kernel K9 on a row carry and
on a query-minor one, and the generic engine over the CSR in its drive
modes.  Everything is integers, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import bfs as jbfs
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
    bfs,
    cuda_csr,
    engine,
    packed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import io


def _edges(kind):
    """(n, edges): an RMAT graph with duplicates, self-loops and isolated
    vertices past its range, a road grid, and a graph with no edges."""
    if kind == "rmat":
        _, e = generators.rmat_edges(8, edge_factor=6, seed=11)
        return 300, np.concatenate([e, [[7, 7], [8, 9], [8, 9]]]).astype(np.int32)
    if kind == "no_edges":
        return 40, np.zeros((0, 2), np.int32)
    return generators.road_edges(12, 12, seed=5)


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


@pytest.mark.parametrize("kind", ["rmat", "road", "no_edges"])
def test_device_csr_arrays_match_jax(kind):
    n, g, jg = _graphs(kind)
    for name in ("row_offsets", "col_indices", "edge_src"):
        got, want = getattr(g, name), np.asarray(getattr(jg, name))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert (g.n, g.num_edges, g.n_pad) == (jg.n, jg.num_edges, jg.n_pad)


def _random_dist(n, k, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, 4, size=(k, n)).astype(np.int32)


@pytest.mark.parametrize("kind", ["rmat", "road"])
def test_frontier_expand_matches_jax(kind):
    n, g, jg = _graphs(kind)
    dist = _random_dist(n, 5, 3)
    for q in range(dist.shape[0]):
        want = np.asarray(jbfs.frontier_expand(jnp.asarray(dist[q]), jnp.int32(2), jg))
        got = bfs.frontier_expand(torch.from_numpy(dist[q]), 2, g)
        np.testing.assert_array_equal(got.numpy(), want)
    levels = torch.tensor([0, 1, 2, 3, 2], dtype=torch.int32)
    batch = bfs.frontier_expand(torch.from_numpy(dist), levels, g)
    for q in range(dist.shape[0]):
        want = jbfs.frontier_expand(jnp.asarray(dist[q]), jnp.int32(int(levels[q])), jg)
        np.testing.assert_array_equal(batch[q].numpy(), np.asarray(want))


def test_csr_pull_plain_layouts_agree():
    """K9's plain version on a row carry and on a query-minor carry of the
    same batch: the same carry after every level, to convergence."""
    n, g, _ = _graphs("rmat")
    q = _queries(n, 6, 7)
    rows = bfs.distance_carry_init(n, q)
    minor = packed.packed_carry_init(g, q)
    assert cuda_csr.query_minor(minor.dist) and not cuda_csr.query_minor(rows.dist)
    for carry in (rows, minor):
        bfs.arm_chunk(carry, None, None)
    for _ in range(12):
        cuda_csr.csr_pull(g, rows)
        cuda_csr.csr_pull(g, minor, edge_chunks=3)
        for name in ("dist", "level", "updated", "found", "ctrl"):
            assert torch.equal(getattr(rows, name), getattr(minor, name)), name
    assert not int(rows.ctrl[0])


@pytest.mark.parametrize(
    "level_chunk,query_chunk", [(None, None), (3, None), (None, 4), (2, 5)]
)
@pytest.mark.parametrize("kind", ["rmat", "road", "no_edges"])
def test_vmap_engine_matches_jax(kind, level_chunk, query_chunk):
    n, g, jg = _graphs(kind)
    q = _queries(n, 9, 13)
    want = jengine.Engine(jg, level_chunk=level_chunk, query_chunk=query_chunk)
    got = engine.Engine(g, level_chunk=level_chunk, query_chunk=query_chunk)
    np.testing.assert_array_equal(got.f_values(q).numpy(), np.asarray(want.f_values(q)))
    for x, y in zip(got.query_stats(q), want.query_stats(q)):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert got.best(q) == want.best(q)


def test_vmap_engine_max_levels_and_empty_batch():
    n, g, jg = _graphs("road")
    q = _queries(n, 5, 2)
    for ml in (1, 4):
        want = jengine.Engine(jg, max_levels=ml).query_stats(q)
        for x, y in zip(engine.Engine(g, max_levels=ml).query_stats(q), want):
            np.testing.assert_array_equal(x, np.asarray(y))
    empty = np.zeros((0, 3), np.int32)
    assert engine.Engine(g).f_values(empty).shape == (0,)
    for x in engine.Engine(g).query_stats(empty):
        assert x.shape == (0,)


def test_csr_pull_refuses_bad_views():
    n, g, _ = _graphs("road")
    carry = bfs.distance_carry_init(n, _queries(n, 3, 1))
    carry.dist = carry.dist[:, ::2]
    with pytest.raises(ValueError):
        cuda_csr.csr_pull(g, carry)
