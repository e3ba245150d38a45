"""The port's ELL route against the JAX package on the same seeded inputs:
the ELL-slab layout, the slab gather (JAX's ``ell_hits`` runs its
``pallas_call`` in interpret mode off a TPU), the per-level expansion, the
distance loop and its statistics, and the generic ``Engine`` in its drive
modes; and the level on carried bit planes (the steady function's plain
version) against the level that reads ``dist`` whole.  Everything is
integers, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.ell import (
    EllGraph as JEllGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import bfs as jbfs
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    engine as jengine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    objective as jobjective,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    pallas_bfs as jpallas,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.ell import (
    EllGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bfs,
    cuda_bfs,
    engine,
    objective,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import io


def _edges(kind):
    """(n, edges) of the test graphs: a hub of degree 300 (many virtual
    rows) with isolated vertices past the RMAT range, no edges at all, and
    a road grid."""
    if kind == "hub":
        _, e = generators.rmat_edges(8, edge_factor=6, seed=11)
        hub = np.stack([np.full(300, 3, np.int32), np.arange(300, dtype=np.int32) % 256 + 40], 1)
        return 400, np.concatenate([e, hub, [[7, 7], [8, 9], [8, 9]]]).astype(np.int32)
    if kind == "no_edges":
        return 50, np.zeros((0, 2), np.int32)
    return generators.road_edges(12, 12, seed=5)


GRAPHS = ("hub", "no_edges", "road")


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for kind in GRAPHS:
        n, e = _edges(kind)
        out[kind] = (n, CSRGraph.from_edges(n, e), JCSRGraph.from_edges(n, e))
    return out


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("width,tile_rows", [(16, 512), (4, 64)])
def test_layout_matches_jax(graphs, kind, width, tile_rows):
    n, g, jg = graphs[kind]
    eg = EllGraph.from_host(g, "cpu", width=width, tile_rows=tile_rows)
    je = JEllGraph.from_host(jg, width=width, tile_rows=tile_rows)
    np.testing.assert_array_equal(eg.cols.numpy(), np.asarray(je.cols))
    np.testing.assert_array_equal(eg.vrow_vertex.numpy(), np.asarray(je.vrow_vertex))
    assert (eg.n, eg.num_vrows, eg.width, eg.n_pad) == (je.n, je.num_vrows, je.width, je.n_pad)
    assert eg.cols.dtype == eg.vrow_vertex.dtype == torch.int32


def test_width_validation(graphs):
    with pytest.raises(ValueError, match="width"):
        EllGraph.from_host(graphs["hub"][1], "cpu", width=0)


@pytest.mark.parametrize("kind,density", [("hub", 0.1), ("hub", 0.6), ("road", 0.3)])
def test_ell_hits_matches_jax_pallas_interpret(graphs, kind, density):
    n, g, jg = graphs[kind]
    je = JEllGraph.from_host(jg)
    eg = EllGraph.from_host(g, "cpu")
    rng = np.random.default_rng(int(density * 10))
    pad_to = max(128, -(-(n + 1) // 128) * 128)
    frontier = np.zeros(pad_to, np.int8)
    frontier[:n] = rng.random(n) < density
    want = np.asarray(jpallas.ell_hits(jnp.asarray(frontier), je.cols, je.num_vrows, je.width))
    got = cuda_bfs.ell_hits_plain(torch.from_numpy(frontier), eg.cols)
    np.testing.assert_array_equal(got.numpy(), want)
    # A batch of frontiers at once: one row per query.
    batch = cuda_bfs.ell_hits_plain(torch.from_numpy(np.stack([frontier, 0 * frontier])), eg.cols)
    np.testing.assert_array_equal(batch[0].numpy(), want)
    assert not bool(batch[1].any())


@pytest.mark.parametrize("level", [0, 2])
def test_ell_expand_matches_jax(graphs, level):
    n, g, jg = graphs["hub"]
    je = JEllGraph.from_host(jg)
    eg = EllGraph.from_host(g, "cpu")
    rng = np.random.default_rng(level)
    dist = rng.integers(-1, 4, size=(3, n)).astype(np.int32)
    dist[rng.random((3, n)) < 0.6] = -1
    got = cuda_bfs.ell_expand_plain(torch.from_numpy(dist), torch.tensor([level] * 3), eg)
    for q in range(3):
        want = np.asarray(jpallas.ell_expand(jnp.asarray(dist[q]), jnp.int32(level), je))
        np.testing.assert_array_equal(got[q].numpy(), want)
        one = cuda_bfs.ell_expand_plain(torch.from_numpy(dist[q]), level, eg)
        np.testing.assert_array_equal(one.numpy(), want)


def test_init_distances_and_bfs_match_jax(graphs):
    n, g, jg = graphs["hub"]
    sources = np.array([3, -1, n + 5, 3, 17, 399], dtype=np.int32)
    want = np.asarray(jbfs.init_distances(n, jnp.asarray(sources)))
    np.testing.assert_array_equal(bfs.init_distances(n, sources).numpy(), want)
    batch = bfs.init_distances(n, np.stack([sources, np.full(6, -1, np.int32)]), state_size=n + 3)
    np.testing.assert_array_equal(batch[0, :n].numpy(), want)
    assert bool((batch[1] == bfs.NOT_REACHED).all()) and bool((batch[0, n:] == -1).all())
    je, eg = JEllGraph.from_host(jg), EllGraph.from_host(g, "cpu")
    for max_levels in (None, 2):
        want = np.asarray(
            jbfs.multi_source_bfs(
                je, jnp.asarray(sources), max_levels=max_levels,
                expand=jpallas.ell_expand,
            )
        )
        got = bfs.multi_source_bfs(eg, sources, max_levels=max_levels)
        np.testing.assert_array_equal(got.numpy(), want)


def test_stats_and_f_of_u_match_jax():
    rng = np.random.default_rng(5)
    dist = rng.integers(-1, 9, size=(6, 40)).astype(np.int32)
    dist[2] = -1  # no source: levels 0, F 0
    dist[4, :] = -1
    dist[4, 7] = 0  # a lone source: levels 1
    got = bfs.stats_from_distances(torch.from_numpy(dist))
    for q in range(6):
        want = jbfs.stats_from_distances(jnp.asarray(dist[q]))
        assert [int(x[q]) for x in got] == [int(x) for x in want]
        assert int(objective.f_of_u(torch.from_numpy(dist[q]))) == int(
            jobjective.f_of_u(jnp.asarray(dist[q]))
        )
    assert got[2].dtype == torch.int64 and got[0].dtype == torch.int32


# (graph, K, Engine kwargs) held against the JAX Engine over its EllGraph.
ENGINE_CASES = [
    ("hub", 33, {}),
    ("hub", 70, {"level_chunk": 3}),
    ("hub", 1, {"level_chunk": 1}),
    ("hub", 33, {"query_chunk": 8, "level_chunk": 2}),
    ("hub", 12, {"max_levels": 2}),
    ("no_edges", 33, {}),
    ("road", 33, {"level_chunk": 3}),
    ("road", 1, {}),
]


@pytest.mark.parametrize("kind,k,kwargs", ENGINE_CASES)
def test_engine_matches_jax(graphs, kind, k, kwargs):
    n, g, jg = graphs[kind]
    queries = generators.random_queries(n, k, max_group=5, seed=k + len(kind))
    if k > 3:
        queries[1] = np.zeros(0, dtype=np.int32)  # an empty group
        queries[2] = np.array([-1, n + 3], dtype=np.int32)  # nothing in range
    padded = io.pad_queries(queries)
    jeng = jengine.Engine(JEllGraph.from_host(jg), expand=jpallas.ell_expand, **kwargs)
    eng = engine.Engine(EllGraph.from_host(g, "cpu"), **kwargs)
    want = jeng.query_stats(padded)
    for x, y in zip(eng.query_stats(padded), want):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(eng.f_values(padded).numpy(), np.asarray(jeng.f_values(padded)))
    assert eng.best(padded) == jeng.best(padded)


def test_engine_no_queries_and_plain(graphs):
    n, g, _ = graphs["hub"]
    eng = engine.Engine(EllGraph.from_host(g, "cpu"), level_chunk=2)
    empty = np.zeros((0, 3), dtype=np.int32)
    assert eng.best(empty) == (-1, -1)
    assert eng.f_values(empty).shape == (0,)
    assert [x.shape for x in eng.query_stats(empty)] == [(0,)] * 3
    padded = io.pad_queries(generators.random_queries(n, 9, max_group=4, seed=2))
    plain = engine.Engine(EllGraph.from_host(g, "cpu"), level_chunk=2, plain=True)
    for x, y in zip(eng.query_stats(padded), plain.query_stats(padded)):
        np.testing.assert_array_equal(x, y)
    eng.compile(padded.shape)
    with pytest.raises(ValueError, match="level_chunk"):
        engine.Engine(EllGraph.from_host(g, "cpu"), level_chunk=0)


def test_ell_level_wrapper_checks(graphs):
    n, g, _ = graphs["hub"]
    eg = EllGraph.from_host(g, "cpu")
    carry = bfs.distance_carry_init(n, np.array([[3, 4]], np.int32))
    carry.dist = carry.dist.long()
    with pytest.raises(TypeError, match="int32"):
        cuda_bfs.ell_level(eg, carry)
    carry = bfs.distance_carry_init(n, np.array([[3, 4]], np.int32))
    before = carry.dist.clone()
    cuda_bfs.ell_level(eg, carry)  # ctrl[0] is 0 until a chunk arms it
    assert torch.equal(carry.dist, before)


def _plane_edges(kind):
    """(n, edges) for the carried-planes tests: a path, a star whose centre
    has 70 neighbours (five virtual rows of 16), a graph that is mostly
    isolated vertices, and a small RMAT."""
    if kind == "path":
        return 40, np.array([[i, i + 1] for i in range(39)], dtype=np.int32)
    if kind == "star":
        return 90, np.array([[0, i] for i in range(1, 71)], dtype=np.int32)
    if kind == "isolated":
        return 60, np.array([[2, 3], [3, 4], [50, 51]], dtype=np.int32)
    n, e = generators.rmat_edges(7, edge_factor=4, seed=3)
    return n, e


PLANE_GRAPHS = ("path", "star", "isolated", "rmat")
CARRY_FIELDS = ("dist", "level", "updated", "stop", "found", "ctrl")


def _assert_same_carry(a, b):
    for field in CARRY_FIELDS:
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def _plane_case(kind, k):
    n, e = _plane_edges(kind)
    g, jg = CSRGraph.from_edges(n, e), JCSRGraph.from_edges(n, e)
    queries = generators.random_queries(n, k, max_group=4, seed=k + len(kind))
    if k > 3:
        queries[1] = np.zeros(0, dtype=np.int32)  # an empty group
    if kind == "star":
        queries[0] = np.array([5], dtype=np.int32)  # a leaf: the centre is level 1
    return n, g, jg, io.pad_queries(queries)


@pytest.mark.parametrize("kind", PLANE_GRAPHS)
@pytest.mark.parametrize("k", [1, 33, 64])
def test_planes_level_matches_plain_level_and_jax(kind, k):
    """Level by level: ``ell_level`` on a CPU carry (the steady function's
    plain version on carried planes) leaves the carry ``ell_level_plain``
    leaves, packs only on the first level, and ends at JAX's distances."""
    n, g, jg, padded = _plane_case(kind, k)
    eg = EllGraph.from_host(g, "cpu")
    if kind == "star":
        assert int((eg.vrow_vertex == 0).sum()) == 5
    planes_carry = bfs.distance_carry_init(n, padded)
    plain_carry = bfs.distance_carry_init(n, padded)
    for c in (planes_carry, plain_carry):
        bfs.arm_chunk(c, None, None)
    levels = 0
    while int(plain_carry.ctrl[0]):
        packed = planes_carry.planes is None or not planes_carry.planes.valid
        assert packed == (levels == 0)
        cuda_bfs.ell_level(eg, planes_carry)
        cuda_bfs.ell_level_plain(eg, plain_carry)
        _assert_same_carry(planes_carry, plain_carry)
        planes = planes_carry.planes
        w = -(-k // 32)
        assert not bool(planes.hits.any()) and not bool(planes.aux[w:].any())
        # The planes say what dist says.
        want = bfs.distance_carry_init(n, padded)
        for field in CARRY_FIELDS:
            getattr(want, field).copy_(getattr(plain_carry, field))
        fresh = cuda_bfs.ell_planes(eg, want)
        cuda_bfs.ell_pack_plain(want, fresh)
        assert torch.equal(planes.visited, fresh.visited)
        assert torch.equal(planes.aux[:w], fresh.aux[:w])
        running = bfs.level_active(plain_carry)
        lanes = cuda_bfs._pack_flags(running[:, None], w)[0]
        assert torch.equal(planes.frontier & lanes, fresh.frontier)
        levels += 1
        assert levels <= n + 1
    jeng = jengine.Engine(JEllGraph.from_host(jg), expand=jpallas.ell_expand)
    want = jeng.query_stats(padded)
    for x, y in zip(bfs.stats_from_distances(planes_carry.dist), want):
        np.testing.assert_array_equal(x.numpy(), y)


@pytest.mark.parametrize("k", [1, 33, 64])
def test_planes_go_stale_when_dist_is_rewritten(k):
    """Someone else writes ``dist`` between two levels and says so
    (``touch``): the next level rebuilds its planes and still agrees with
    the level that reads ``dist`` whole.  Without the rewrite being
    announced the carried planes would answer for the old ``dist``."""
    n, g, _, padded = _plane_case("rmat", k)
    eg = EllGraph.from_host(g, "cpu")
    carries = [bfs.distance_carry_init(n, padded) for _ in range(3)]
    told, plain, untold = carries
    for c in carries:
        bfs.arm_chunk(c, None, None)
    for c in (told, untold):
        cuda_bfs.ell_level(eg, c)
    cuda_bfs.ell_level_plain(eg, plain)
    # Un-label every vertex of the newest level of query 0 but one: the
    # frontier shrinks and the vertices become reachable again.
    newest = torch.nonzero(plain.dist[0] == plain.level[0]).flatten()
    assert newest.numel() > 1
    for c in carries:
        c.dist[0, newest[1:]] = bfs.NOT_REACHED
    told.touch()
    assert told.planes.valid is False and untold.planes.valid is True
    for _ in range(3):
        cuda_bfs.ell_level(eg, told)
        cuda_bfs.ell_level(eg, untold)
        cuda_bfs.ell_level_plain(eg, plain)
        _assert_same_carry(told, plain)
    assert told.planes.valid is True
    assert not torch.equal(untold.dist, plain.dist)


@pytest.mark.parametrize("kind", ["star", "rmat"])
@pytest.mark.parametrize("level_chunk", [1, 2, None])
def test_planes_engine_chunk_boundaries_match_jax(kind, level_chunk):
    """Every chunk re-arms the carry, so its first level is a stale one:
    the engine's answers do not depend on where the chunks end."""
    n, g, jg, padded = _plane_case(kind, 33)
    jeng = jengine.Engine(
        JEllGraph.from_host(jg), expand=jpallas.ell_expand, level_chunk=level_chunk
    )
    eg = EllGraph.from_host(g, "cpu")
    eng = engine.Engine(eg, level_chunk=level_chunk)
    plain = engine.Engine(eg, level_chunk=level_chunk, plain=True)
    want = jeng.query_stats(padded)
    for got in (eng.query_stats(padded), plain.query_stats(padded)):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    assert eng.best(padded) == jeng.best(padded)


def test_steady_plain_never_reads_dist():
    """The steady function writes the new labels into ``dist`` and takes
    nothing from it: scribbling over ``dist`` after the pack changes only
    the entries the level does not label."""
    n, g, _, padded = _plane_case("rmat", 33)
    eg = EllGraph.from_host(g, "cpu")
    clean, scribbled = (bfs.distance_carry_init(n, padded) for _ in range(2))
    for c in (clean, scribbled):
        bfs.arm_chunk(c, None, None)
        cuda_bfs.ell_pack_plain(c, cuda_bfs.ell_planes(eg, c))
    scribbled.dist.fill_(77)
    for c in (clean, scribbled):
        cuda_bfs.ell_steady_plain(eg, c, c.planes)
    labelled = clean.dist == 1
    assert bool(labelled.any())
    assert torch.equal(scribbled.dist[labelled], clean.dist[labelled])
    assert bool((scribbled.dist[~labelled] == 77).all())
    for field in CARRY_FIELDS[1:]:
        assert torch.equal(getattr(clean, field), getattr(scribbled, field)), field
