"""The port's owner-partitioned push (parallel/push_sharded.py), query-
sharded push (push_dist.py) and vertex-sharded CSR pull (sharded_csr.py)
against the JAX package's on the 8-device virtual CPU mesh: the JAX
engine on ``jax.devices()[:P]``, the port on a logical CPU mesh of the
same shape.  F vectors, ``best()``, the stats, the capacity trajectory
and the rerun count must be equal (integers: zero tolerance); H3's plain
version is held against JAX's ``_push_level`` on the same shards."""

import contextlib
import io as _io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    mesh as jmesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    push_dist as jpd,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    push_sharded as jps,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    sharded_csr as jsc,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    cuda_halo,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops.push import (
    FrontierOverflow,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    collectives,
    mesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    push_dist as pd,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    push_sharded as ps,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    sharded_csr as sc,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils.io import (
    pad_queries,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _graph(kind):
    if kind == "road40":
        n, edges = generators.road_edges(40, 40, seed=3)
        queries = [np.array([0], np.int32), np.array([n - 1], np.int32),
                   np.array([5, 800], np.int32), np.zeros(0, np.int32),
                   np.array([n + 7], np.int32)]  # out of range: dropped
        queries += generators.random_queries(n, 5, max_group=3, seed=4)
    elif kind == "road33":  # n = 297: uneven blocks over 8 shards
        n, edges = generators.road_edges(33, 9, seed=5)
        queries = generators.random_queries(n, 5, max_group=3, seed=6)
    else:
        n, edges = generators.rmat_edges(8, 8, seed=3)
        queries = generators.random_queries(n, 10, max_group=4, seed=6)
    return (n, edges, np.asarray(pad_queries(queries)),
            JCSRGraph.from_edges(n, edges), CSRGraph.from_edges(n, edges))


@pytest.fixture(scope="module")
def graphs():
    return {kind: _graph(kind) for kind in ("road40", "road33", "rmat")}


def _meshes(q, v):
    return (jmesh.make_mesh(q, v, devices=jax.devices()[: q * v]),
            mesh.make_mesh(q, v, devices=["cpu"] * (q * v)))


def _quiet(fn, *args):
    """fn(*args) and its stderr lines (the overflow protocol's)."""
    err = _io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn(*args)
    return out, err.getvalue().splitlines()


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---- the owner-partitioned push ------------------------------------------------


@pytest.mark.parametrize("kind,q,v", [("road40", 4, 1), ("road40", 2, 2), ("road40", 1, 4),
                                      ("road40", 2, 4), ("road33", 1, 8)])
def test_sharded_push_matches_jax(graphs, kind, q, v):
    n, edges, padded, jg, g = graphs[kind]
    jm, pm = _meshes(q, v)
    je = jps.ShardedPushEngine(jm, jg, level_chunk=16)
    pe = ps.ShardedPushEngine(pm, g, level_chunk=16)
    (pstats, perr), (jstats, jerr) = _quiet(pe.query_stats, padded), _quiet(je.query_stats, padded)
    _same(pstats, jstats)
    assert perr == jerr
    assert (pe.capacity, pe.boundary, pe._peak_f, pe._peak_b) == (
        je.capacity, je.boundary, je._peak_f, je._peak_b)
    assert tuple(pe.best(padded)) == tuple(int(x) for x in je.best(padded))


@pytest.mark.parametrize("cap,bnd", [(4, 4), (20, None), (None, 3)])
def test_sharded_push_growth_matches_jax(graphs, cap, bnd):
    """A truncated run is discarded and rerun at the grown bounds: the
    same overflow lines (the rerun count), bounds and answers as JAX's,
    the stepped trace included."""
    n, edges, padded, jg, g = graphs["road40"]
    jm, pm = _meshes(2, 2)
    engines = []
    for mod, m, graph in ((jps, jm, jg), (ps, pm, g)):
        eng = mod.ShardedPushEngine(m, graph, level_chunk=16)
        eng.capacity = cap or eng.capacity
        eng.boundary = bnd or eng.boundary
        engines.append(eng)
    pe, je = engines[1], engines[0]
    (pf, perr), (jf, jerr) = _quiet(pe.f_values, padded), _quiet(je.f_values, padded)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert perr == jerr and len(perr) >= 1
    assert (pe.capacity, pe.boundary) == (je.capacity, je.boundary)
    if cap == 4:
        (pl, perr), (jl, jerr) = _quiet(pe.level_stats, padded), _quiet(je.level_stats, padded)
        _same(pl[:4], jl[:4])
        assert perr == jerr


def test_sharded_push_hard_bounds_and_width_cap(graphs):
    n, edges, padded, _, g = graphs["road40"]
    pm = mesh.make_mesh(2, 2, devices=["cpu"] * 4)
    with pytest.raises(FrontierOverflow):
        ps.ShardedPushEngine(pm, g, capacity=4, boundary=4).f_values(padded)
    with pytest.raises(ValueError, match="width cap"):
        big = generators.rmat_edges(10, edge_factor=16, seed=7)
        ps.ShardedPushEngine(pm, CSRGraph.from_edges(*big))


@pytest.mark.parametrize("max_levels", [0, 5])
def test_sharded_push_max_levels_matches_jax(graphs, max_levels):
    n, edges, padded, jg, g = graphs["road40"]
    jm, pm = _meshes(2, 2)
    _same(ps.ShardedPushEngine(pm, g, max_levels=max_levels).query_stats(padded),
          jps.ShardedPushEngine(jm, jg, max_levels=max_levels).query_stats(padded))


def test_sharded_adjacency_and_defaults_match_jax(graphs):
    for kind in ("road40", "road33"):
        n, edges, padded, jg, g = graphs[kind]
        for p in (1, 4, 8):
            mine, ref = ps.build_sharded_adjacency(g, p), jps.build_sharded_adjacency(jg, p)
            np.testing.assert_array_equal(mine[0], np.asarray(ref[0]))
            assert mine[1:] == tuple(ref[1:])
    for n_pad, block, width in [(1600, 400, 4), (10**6, 10**5, 6), (300, 38, 3)]:
        cap = ps.default_capacity(n_pad, block)
        assert cap == jps.default_capacity(n_pad, block)
        assert ps.default_boundary(cap, width) == jps.default_boundary(cap, width)


@pytest.mark.parametrize("cap,bnd,mode", [
    pytest.param(64, 64, "live", id="64-64"), pytest.param(5, 3, "live", id="5-3"),
    pytest.param(64, 1, "live", id="64-1"), pytest.param(64, 64, "empty", id="64-64-empty"),
    pytest.param(64, 16, "gated", id="64-16-gated")])
def test_owner_push_expand_plain_matches_jax(graphs, cap, bnd, mode):
    """H3 and H1, one owner-partitioned push level on every shard (with a
    truncated queue and boundary, a budget of one pair, no listed row),
    against JAX's ``_push_level`` under shard_map over the same (1, p)
    shards; gated off, H3 leaves every output as it was."""
    n, edges, padded, jg, g = graphs["road40"]
    p = 4
    stacked, L, n_pad, width = ps.build_sharded_adjacency(g, p)
    rng = np.random.default_rng(11)
    w = 2
    frontier = rng.integers(0, 2**32, (p, L, w), dtype=np.uint64).astype(np.uint32)
    frontier[rng.random((p, L)) < 0.97] = 0
    if mode == "empty":
        frontier[:] = 0
    if mode == "gated":
        for b in range(p):
            outs = [torch.full((L, w), 5, dtype=torch.int32), torch.full((bnd,), 7, dtype=torch.int32),
                    torch.full((bnd, w), 9, dtype=torch.int32), torch.full((1,), 2, dtype=torch.int32),
                    torch.full((1,), 3, dtype=torch.int32)]
            before = [t.clone() for t in outs]
            nz = np.flatnonzero(frontier[b].any(axis=1)).astype(np.int32)
            cuda_halo.owner_push_expand(
                torch.from_numpy(stacked[b]), torch.from_numpy(nz),
                torch.tensor([len(nz)], dtype=torch.int32),
                torch.from_numpy(frontier[b].view(np.int32)), outs[0], b * L, n_pad, *outs[1:],
                torch.tensor([0, 0, 0, 0], dtype=torch.int32))
            for a, b_ in zip(outs, before):
                assert torch.equal(a, b_)
        return
    visited = frontier | np.where(rng.random((p, L, w)) < 0.2, 0xFFFF, 0).astype(np.uint32)
    jm = jmesh.make_mesh(1, p, devices=jax.devices()[:p])

    def body(adj, vis, fr):
        new, rows, bcount = jps._push_level(adj[0], vis[0], fr[0], L, n_pad, cap, bnd)
        return new[None], rows[None], bcount[None]

    want_new, want_rows, want_b = jax.jit(jax.shard_map(
        body, mesh=jm, in_specs=(P("v"),) * 3, out_specs=(P("v"),) * 3,
    ))(jnp.asarray(stacked), jnp.asarray(visited), jnp.asarray(frontier))
    ctrl = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    shards = []
    for b in range(p):
        fr = torch.from_numpy(frontier[b].view(np.int32))
        nz = np.flatnonzero(frontier[b].any(axis=1))
        queue = torch.full((min(cap, L),), L, dtype=torch.int32)
        listed = min(len(nz), queue.shape[0])
        queue[:listed] = torch.from_numpy(nz[:listed].astype(np.int32))
        hits = torch.zeros((L, w), dtype=torch.int32)
        ids = torch.zeros(bnd, dtype=torch.int32)
        words = torch.zeros((bnd, w), dtype=torch.int32)
        bcount, peak = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
        cuda_halo.owner_push_expand(torch.from_numpy(stacked[b]), queue,
                                    torch.tensor([len(nz)], dtype=torch.int32), fr, hits,
                                    b * L, n_pad, ids, words, bcount, peak, ctrl)
        assert int(bcount) == int(want_b[b]) == int(peak)
        assert len(nz) == int(want_rows[b])
        shards.append((hits, ids, words))
    gathered_ids = collectives.all_gather([s[1] for s in shards])[0]
    gathered_words = collectives.all_gather([s[2] for s in shards])[0]
    for b, (hits, _, _) in enumerate(shards):
        cuda_halo.halo_pair_or(gathered_ids, gathered_words, hits, b * L, ctrl)
        new = hits.numpy().view(np.uint32) & ~visited[b]
        np.testing.assert_array_equal(new, np.asarray(want_new[b]))


# ---- the query-sharded push ---------------------------------------------------


@pytest.mark.parametrize("w,cap", [(4, None), (2, 16), (8, None)])
def test_distributed_push_matches_jax(graphs, w, cap):
    n, edges, padded, jg, g = graphs["road40"]
    jm, pm = _meshes(w, 1)
    je, pe = jpd.DistributedPushEngine(jm, jg), pd.DistributedPushEngine(pm, g)
    if cap:
        je.capacity = pe.capacity = cap
    (pstats, perr), (jstats, jerr) = _quiet(pe.query_stats, padded), _quiet(je.query_stats, padded)
    _same(pstats, jstats)
    assert perr == jerr and pe.capacity == je.capacity
    assert tuple(pe.best(padded)) == tuple(int(x) for x in je.best(padded))
    if w == 2:
        je.capacity = pe.capacity = cap
        (pl, perr), (jl, jerr) = _quiet(pe.level_stats, padded), _quiet(je.level_stats, padded)
        _same(pl[:4], jl[:4])
        assert perr == jerr and pe.capacity == je.capacity


def test_distributed_push_hard_capacity(graphs):
    n, edges, padded, _, g = graphs["road40"]
    pm = mesh.make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(FrontierOverflow):
        pd.DistributedPushEngine(pm, g, capacity=4).f_values(padded)


# ---- the vertex-sharded CSR pull -------------------------------------------------


@pytest.mark.parametrize("q,v,chunk", [(4, 1, None), (2, 2, 2), (1, 4, None), (2, 4, 3)])
def test_sharded_csr_matches_jax(graphs, q, v, chunk):
    n, edges, padded, jg, g = graphs["rmat"]
    jm, pm = _meshes(q, v)
    want = np.asarray(jsc.ShardedEngine(jm, jg, query_chunk=chunk).f_values(padded))
    pe = sc.ShardedEngine(pm, g, query_chunk=chunk)
    np.testing.assert_array_equal(pe.f_values(padded).numpy(), want)
    mine, ref = sc.ShardedCSR(g, v), jsc.ShardedCSR(jg, v)
    for field in ("row_offsets", "col_indices", "edge_src"):
        np.testing.assert_array_equal(getattr(mine, field), getattr(ref, field))


def test_sharded_csr_max_levels_and_deep_grid(graphs):
    n, edges, padded, jg, g = graphs["road33"]
    jm, pm = _meshes(1, 8)
    for max_levels in (3, None):
        want = np.asarray(jsc.ShardedEngine(jm, jg, max_levels=max_levels).f_values(padded))
        got = sc.ShardedEngine(pm, g, max_levels=max_levels).f_values(padded)
        np.testing.assert_array_equal(got.numpy(), want)
