"""The port's vertex-sharded forest (parallel/sharded_bell.py) against the
JAX package's on the 8-device virtual CPU mesh, the JAX engine on
``jax.devices()[:P]``, the port on a logical CPU mesh of the same shape:
F vectors, ``best()``, the per-query and per-level stats, the halo trace
(route, rows and bytes of every level) and the collective-bytes counter
must be equal (integers: zero tolerance) under every halo routing.  Also
the push-halo layout, the byte model and budgets, the halo table, and
H1's and H2's plain versions (H2's match and its push) against the JAX
expressions they replace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    bitbell as jbitbell,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    mesh as jmesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    sharded_bell as jsb,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    timing as jtiming,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    trace as jtrace,
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
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    mesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    sharded_bell as sb,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    timing,
    trace,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils.io import (
    pad_queries,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _problem(kind):
    if kind == "rmat":
        n, edges = generators.rmat_edges(8, 8, seed=401)
        queries = generators.random_queries(n, 9, max_group=4, seed=402)
        queries[4] = np.zeros(0, dtype=np.int32)
    else:  # a 33 x 9 road grid: n = 297 splits unevenly over 8 shards
        n, edges = generators.road_edges(33, 9, seed=7)
        queries = generators.random_queries(n, 6, max_group=3, seed=8)
        queries.append(np.array([n + 3, 5], dtype=np.int32))  # out of range: dropped
    return (n, edges, np.asarray(pad_queries(queries)),
            JCSRGraph.from_edges(n, edges), CSRGraph.from_edges(n, edges))


@pytest.fixture(scope="module")
def problems():
    return {kind: _problem(kind) for kind in ("rmat", "road")}


def _meshes(q, v):
    return (jmesh.make_mesh(q, v, devices=jax.devices()[: q * v]),
            mesh.make_mesh(q, v, devices=["cpu"] * (q * v)))


def _assert_same(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("q,v", [(4, 1), (2, 2), (1, 4), (2, 4), (1, 8)])
def test_dense_halo_matches_jax(problems, q, v):
    """The default routing (whole planes every level), chunked: F, best,
    stats and the dense halo's collective bytes."""
    n, edges, padded, jg, g = problems["rmat"]
    jm, pm = _meshes(q, v)
    je = jsb.ShardedBellEngine(jm, jg, level_chunk=3)
    pe = sb.ShardedBellEngine(pm, g, level_chunk=3)
    jtiming.reset_collective_bytes()
    timing.reset_collective_bytes()
    want = np.asarray(je.f_values(padded))
    np.testing.assert_array_equal(pe.f_values(padded).numpy(), want)
    assert timing.collective_bytes() == jtiming.collective_bytes()
    assert (timing.collective_bytes() > 0) == (v > 1)
    assert tuple(pe.best(padded)) == tuple(int(x) for x in je.best(padded))
    _assert_same(pe.query_stats(padded), je.query_stats(padded))


# (graph, mesh, halo budget, push budget, whether to run the stepped trace)
ROUTINGS = [
    ("road", (1, 8), 16, None, True),  # sparse exchange, no push budget: rebuild
    ("road", (2, 4), 16, 10**6, True),  # sparse exchange with the in-block push
    ("road", (1, 8), 16, 1, False),  # push budget too small: rebuild + forest
    ("road", (2, 4), 0, None, False),  # whole planes only
    ("rmat", (2, 4), 4, 32, True),  # fat levels dense, thin ones sparse
    ("rmat", (1, 4), 2, 10**6, False),
]


@pytest.mark.parametrize("kind,qv,halo,push,stepped", ROUTINGS)
def test_halo_routings_match_jax(problems, kind, qv, halo, push, stepped):
    n, edges, padded, jg, g = problems[kind]
    jm, pm = _meshes(*qv)
    je = jsb.ShardedBellEngine(jm, jg, halo_budget=halo, push_budget=push, level_chunk=8)
    pe = sb.ShardedBellEngine(pm, g, halo_budget=halo, push_budget=push, level_chunk=8)
    if not stepped:
        _assert_same(pe.query_stats(padded), je.query_stats(padded))
        return
    np.testing.assert_array_equal(pe.f_values(padded).numpy(), np.asarray(je.f_values(padded)))
    pl, jl = pe.level_stats(padded), je.level_stats(padded)
    _assert_same(pl[:4], jl[:4])
    assert pe.last_halo_trace == je.last_halo_trace
    assert trace.format_halo_stats(pe.last_halo_trace) == jtrace.format_halo_stats(
        je.last_halo_trace)
    routes = {r for row in pe.last_halo_trace for r in row["routes"]}
    assert "sparse" in routes


def test_lone_push_budget_warns_and_edgeless_graph(capsys):
    n, edges, padded, _, g = _problem("road")
    pm = mesh.make_mesh(2, 4, devices=["cpu"] * 8)
    eng = sb.ShardedBellEngine(pm, g, halo_budget=0, push_budget=16)
    assert "halo_budget" in capsys.readouterr().err
    assert eng.push is None and eng.push_budget == 0
    empty = CSRGraph.from_edges(5, np.zeros((0, 2), dtype=np.int64))
    eng = sb.ShardedBellEngine(pm, empty, halo_budget=4, push_budget=16)
    levels, reached, f = eng.query_stats(np.asarray(pad_queries([np.array([2], np.int32)])))
    assert (levels[0], reached[0], f[0]) == (1, 1, 0)


def test_layouts_budgets_and_bytes_match_jax(problems):
    n, edges, padded, jg, g = problems["road"]
    for p in (2, 8):
        L = -(-n // p)
        jpush = [np.asarray(x) for x in jsb.build_push_halo(jg, p, L, p * L)]
        for b, mine in enumerate(sb.build_push_halo(g, p, L)):
            m, e = len(mine[0]), len(mine[3])
            for i, (a, ref) in enumerate(zip(mine, jpush)):
                np.testing.assert_array_equal(a, ref[b, : e if i == 3 else m])
        forests, L2, n_pad = sb.build_sharded_forest(g, p, "cpu")
        _, jL, jn_pad = jsb.build_sharded_forest(jg, p)
        assert (L2, n_pad) == (jL, jn_pad) and len(forests) == p
    for args in [(1000, 2, 4, 16, 3), (1000, 2, 4, 16, 40), (512, 1, 8, 0, 1)]:
        assert sb.halo_level_bytes(*args) == jsb.halo_level_bytes(*args)
    for n_pad, p in [(100, 4), (10**6, 8), (10**7, 1)]:
        assert sb.default_halo_budget(n_pad, p) == jsb.default_halo_budget(n_pad, p)
        assert sb.default_push_halo_budget(n_pad * 7, p) == jsb.default_push_halo_budget(
            n_pad * 7, p)
    jm, pm = _meshes(2, 4)
    assert sb.dense_halo_level_bytes(pm, 37, 40) == jsb.dense_halo_level_bytes(jm, 37, 40)


def _pairs(seed, pairs, w, rows, unique):
    rng = np.random.default_rng(seed)
    ids = (rng.permutation(rows + 5)[:pairs] if unique
           else rng.integers(0, rows + 5, pairs)).astype(np.int32)
    words = rng.integers(0, 2**32, (pairs, w), dtype=np.uint64).astype(np.uint32)
    words[rng.random((pairs, w)) < 0.3] = 0
    return ids, words


@pytest.mark.parametrize("w", [1, 3])
def test_halo_pair_or_plain_matches_jax(w):
    """H1: the sparse halo's rebuild (unique global ids, sentinel drops;
    JAX's scatter-max) and the boundary landing of the owner-partitioned
    push (duplicates, rows offset by the block; JAX's byte lanes)."""
    rows = 64
    ids, words = _pairs(1, 40, w, rows, unique=True)
    want = (jnp.zeros((rows, w), jnp.uint32).at[jnp.asarray(ids)]
            .max(jnp.asarray(words), mode="drop"))
    got = torch.zeros((rows, w), dtype=torch.int32)
    cuda_halo.halo_pair_or(torch.from_numpy(ids), torch.from_numpy(words.view(np.int32)), got)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    lo, block = 16, 32
    ids, words = _pairs(2, 90, w, 70, unique=False)
    local = ids.astype(np.int64) - lo
    mine = (local >= 0) & (local < block)
    hit = (jnp.zeros((block + 1, 32 * w), jnp.uint8)
           .at[jnp.asarray(np.where(mine, local, block))]
           .max(jbitbell.unpack_byte_planes(jnp.asarray(words))))
    want = np.asarray(jbitbell.pack_byte_planes(hit[:block]))
    got = torch.zeros((block, w), dtype=torch.int32)
    ctrl = torch.tensor([1, 3, 0, 0], dtype=torch.int32)
    cuda_halo.halo_pair_or(torch.from_numpy(ids), torch.from_numpy(words.view(np.int32)), got,
                           lo, ctrl)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    ctrl[0] = 0  # gated off: nothing lands
    cuda_halo.halo_pair_or(torch.from_numpy(ids), torch.from_numpy(words.view(np.int32)),
                           torch.zeros((block, w), dtype=torch.int32), lo, ctrl)


@pytest.mark.parametrize("p,w", [(4, 1), (4, 2)])
def test_halo_push_or_plain_matches_jax(problems, p, w):
    """H2: the gathered pairs pushed through each shard's in-block push
    CSR, against JAX's ``_push_own_hits`` on the same pairs."""
    n, edges, _, jg, g = problems["road"]
    L = -(-n // p)
    rng = np.random.default_rng(p)
    flat_ids = np.where(rng.random(60) < 0.8, rng.integers(0, n, 60), p * L).astype(np.int32)
    flat_words = rng.integers(1, 2**32, (60, w), dtype=np.uint64).astype(np.uint32)
    for src_ids, src_start, src_cnt, vals in sb.build_push_halo(g, p, L)[:2]:
        if len(src_ids) == 0:
            continue
        pos = np.minimum(np.searchsorted(src_ids, flat_ids), len(src_ids) - 1)
        match = src_ids[pos] == flat_ids
        deg = np.where(match, src_cnt[pos], 0).astype(np.int32)
        st = np.where(match, src_start[pos], 0).astype(np.int32)
        budget = int(deg.sum()) + 1
        want = jsb._push_own_hits(
            tuple(jnp.asarray(a) for a in (src_ids, src_start, src_cnt, vals)),
            jnp.asarray(flat_ids), jnp.asarray(flat_words), jnp.asarray(deg),
            jnp.asarray(st), L, budget)
        got = torch.zeros((L, w), dtype=torch.int32)
        cuda_halo.halo_push_or(torch.from_numpy(flat_ids),
                               torch.from_numpy(flat_words.view(np.int32)),
                               tuple(torch.from_numpy(a) for a in (src_ids, src_start,
                                                                   src_cnt, vals)), got)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def _jax_match(csr, flat_ids, n_pad):
    """The JAX package's match of the gathered pairs (parallel/sharded_bell.py
    ``sparse_level``: searchsorted, deg and st where matched, their sum)."""
    src_ids, src_start, src_cnt = (jnp.asarray(a) for a in csr[:3])
    ids = jnp.asarray(flat_ids)
    pos = jnp.searchsorted(src_ids, ids)
    pos_c = jnp.minimum(pos, src_ids.shape[0] - 1).astype(jnp.int32)
    match = (jnp.take(src_ids, pos_c) == ids) & (ids < n_pad)
    deg = jnp.where(match, jnp.take(src_cnt, pos_c), 0)
    st = jnp.where(match, jnp.take(src_start, pos_c), 0)
    return np.asarray(st), np.asarray(deg), int(jnp.sum(deg))


def _match_ids(rng, csr, n, n_pad, case):
    """Gathered pair ids, ascending a shard's segment and sentinel-padded:
    random ids (some sources, some not), all sentinels, no source at all,
    or every source with the hub (the most in-block edges) among them."""
    src_ids, _, src_cnt, _ = csr
    if case == "all-sentinel":
        return np.full(48, n_pad, dtype=np.int32)
    if case == "no-match":
        others = np.setdiff1d(np.arange(n), src_ids)[:40]
        return np.concatenate([others, np.full(8, n_pad)]).astype(np.int32)
    if case == "hub":
        hub = src_ids[np.argmax(src_cnt)]
        return np.concatenate([np.sort(np.unique(np.append(src_ids, hub))),
                               np.full(5, n_pad)]).astype(np.int32)
    ids = np.sort(np.unique(rng.integers(0, n, 40)))
    return np.concatenate([ids, np.full(60 - ids.size, n_pad)]).astype(np.int32)


MATCH_CASES = ["mixed", "all-sentinel", "no-match", "hub"]


@pytest.mark.parametrize("case", MATCH_CASES)
@pytest.mark.parametrize("kind,p", [("road", 4), ("rmat", 2)])
def test_halo_push_match_plain_matches_jax(problems, kind, p, case):
    """H2's match: each pair's (st, deg), sentinels and unmatched ids at 0,
    and the in-block edge total against JAX's route-decision expressions;
    ``pos`` against ``_push_own_hits``' exclusive ``cumsum(deg) - deg``."""
    n, edges, _, jg, g = problems[kind]
    L = -(-n // p)
    rng = np.random.default_rng(p + len(case))
    for csr in sb.build_push_halo(g, p, L):
        if len(csr[0]) == 0:
            continue
        ids = _match_ids(rng, csr, n, p * L, case)
        st, deg, total = _jax_match(csr, ids, p * L)
        got = cuda_halo.halo_push_match(torch.from_numpy(ids),
                                        tuple(torch.from_numpy(a) for a in csr))
        np.testing.assert_array_equal(got.st.numpy(), st)
        np.testing.assert_array_equal(got.deg.numpy(), deg)
        np.testing.assert_array_equal(got.pos.numpy(), np.cumsum(deg) - deg)
        assert got.total.dtype == torch.int64 and int(got.total) == total
        if case in ("all-sentinel", "no-match"):
            assert total == 0


@pytest.mark.parametrize("case", MATCH_CASES)
def test_halo_push_or_with_match_matches_jax(problems, case):
    """H2's push given its match (the engine's two launches), against JAX's
    ``_push_own_hits`` on the same pairs and (st, deg), at W = 2."""
    n, edges, _, jg, g = problems["rmat"]
    p, w = 2, 2
    L = -(-n // p)
    rng = np.random.default_rng(len(case))
    for csr in sb.build_push_halo(g, p, L):
        ids = _match_ids(rng, csr, n, p * L, case)
        words = rng.integers(1, 2**32, (ids.size, w), dtype=np.uint64).astype(np.uint32)
        st, deg, total = _jax_match(csr, ids, p * L)
        want = jsb._push_own_hits(tuple(jnp.asarray(a) for a in csr), jnp.asarray(ids),
                                  jnp.asarray(words), jnp.asarray(deg), jnp.asarray(st), L,
                                  total + 1)
        tcsr = tuple(torch.from_numpy(a) for a in csr)
        match = cuda_halo.halo_push_match(torch.from_numpy(ids), tcsr)
        got = torch.zeros((L, w), dtype=torch.int32)
        cuda_halo.halo_push_or(torch.from_numpy(ids), torch.from_numpy(words.view(np.int32)),
                               tcsr, got, match, total)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_pair_words_matches_compact_frontier_planes():
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops.push import (
        compact_frontier_planes,
    )

    rng = np.random.default_rng(5)
    planes = rng.integers(0, 2**32, (40, 2), dtype=np.uint64).astype(np.uint32)
    planes[rng.random(40) < 0.6] = 0
    budget, lo, sentinel = 8, 80, 400
    count, ids, valid, words = compact_frontier_planes(jnp.asarray(planes), budget, 40)
    nz = np.flatnonzero(planes.any(axis=1))
    queue = torch.full((budget,), 40, dtype=torch.int32)
    queue[: min(len(nz), budget)] = torch.from_numpy(nz[:budget].astype(np.int32))
    gids, got = cuda_halo.pair_words(torch.from_numpy(planes.view(np.int32)), queue,
                                     torch.tensor([min(len(nz), budget)]), lo, sentinel)
    np.testing.assert_array_equal(gids.numpy(), np.where(np.asarray(valid),
                                                         np.asarray(ids) + lo, sentinel))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(words))
