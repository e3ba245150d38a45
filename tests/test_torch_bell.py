"""The port's default route against the JAX package on the same seeded
inputs: the BELL forest layout and its ladder policy, the plain forest
OR-fold with and without gather segments, the hybrid push/pull expansion
and ``BitBellEngine`` in its drive modes.  Everything is bits and
integers, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
    bell as jbell_model,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import bell as jbell
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    bitbell as jbb,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    engine as jengine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    packed as jpacked,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    DEFAULT_WIDTHS,
    BellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
    sorted_unique,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bell,
    bitbell,
    cuda_bell,
    packed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import io

JBellGraph = jbell_model.BellGraph
NARROW = (1, 2, 4, 8)


def _edges(kind):
    """(n, edges): RMAT plus a 600-neighbour hub (a second forest level),
    a self-loop-only vertex and isolated vertices past the RMAT range; no
    edges; a road grid."""
    if kind == "hub":
        _, e = generators.rmat_edges(8, edge_factor=6, seed=11)
        hub = np.stack([np.full(600, 3, np.int32), np.arange(600, dtype=np.int32) % 290 + 10], 1)
        return 400, np.concatenate([e, hub, [[350, 350], [8, 9], [8, 9]]]).astype(np.int32)
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


def _words(rng, shape, density):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w[rng.random(shape[0]) >= density] = 0
    return w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize(
    "kwargs",
    [{}, {"widths": NARROW}, {"dedup": False}, {"keep_sparse": False, "min_bucket_rows": 3}],
)
def test_layout_matches_jax(graphs, kind, kwargs):
    n, g, jg = graphs[kind]
    bg = BellGraph.from_host(g, "cpu", **kwargs)
    jb = JBellGraph.from_host(jg, **kwargs)
    assert bg.level_shapes == jb.level_shapes
    assert bg.level_sizes == jb.level_sizes and bg.fill == jb.fill
    assert (bg.n, bg.n_pad) == (jb.n, jb.n_pad)
    assert len(bg.level_cols) == len(jb.level_cols)
    for a, b in zip(bg.level_cols, jb.level_cols):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(bg.final_slot.numpy(), np.asarray(jb.final_slot))
    assert (bg.sparse is None) == (jb.sparse is None)
    for a, b in zip(bg.sparse or (), jb.sparse or ()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.int32
    if kind == "hub":
        assert len(bg.level_sizes) >= 2
        assert int((bg.final_slot == bg.total_rows).sum()) > 0  # isolated vertices


@pytest.mark.parametrize("size", [0, 1, 2, 1000])
def test_sorted_unique_equals_np_unique(size):
    keys = np.random.default_rng(size).integers(0, 40, size=size) * (1 << 33)
    got, want = sorted_unique(keys), np.unique(keys)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_ladder_policy_and_estimate_match_jax(graphs):
    _, g, _ = graphs["hub"]
    deg = g.degrees
    for rows in (1, 3, 50):
        assert BellGraph.adaptive_widths(deg, DEFAULT_WIDTHS, rows) == JBellGraph.adaptive_widths(
            deg, jbell_model.DEFAULT_WIDTHS, rows
        )
    for args in ((DEFAULT_WIDTHS, None), (NARROW, None), (NARROW, 5), (DEFAULT_WIDTHS, 0)):
        assert BellGraph.resolve_widths(args[0], deg, 400, 5000, args[1]) == (
            JBellGraph.resolve_widths(args[0], deg, 400, 5000, args[1])
        )
    assert DEFAULT_WIDTHS == jbell_model.DEFAULT_WIDTHS
    for n, e, k in ((400, 5000, 1), (1 << 20, 33554432, 64), (1 << 24, 1 << 28, 300)):
        assert BellGraph.default_min_bucket_rows(n, e) == JBellGraph.default_min_bucket_rows(n, e)
        for shards in (1, 4):
            assert BellGraph.estimate_hbm_bytes(n, e, k, shards) == (
                JBellGraph.estimate_hbm_bytes(n, e, k, shards)
            )
    shapes = ((10, 3), (0, 4), (7, 256), (300, 1))
    for budget in (1, 30, 256, 10**6):
        assert bell._slot_segments(shapes, budget) == jbell._slot_segments(shapes, budget)


@pytest.mark.parametrize("kind,widths", [("hub", DEFAULT_WIDTHS), ("hub", NARROW), ("road", DEFAULT_WIDTHS), ("no_edges", DEFAULT_WIDTHS)])
@pytest.mark.parametrize("w", [1, 3])
def test_forest_hits_match_jax(graphs, kind, widths, w):
    """The plain forest equals JAX's bell_hits_or, whole and in gather
    segments of several budgets (bit 31 set in about half the words)."""
    n, g, jg = graphs[kind]
    bg = BellGraph.from_host(g, "cpu", widths=widths)
    jb = JBellGraph.from_host(jg, widths=widths)
    frontier = _words(np.random.default_rng(w), (n, w), 0.3)
    want = np.asarray(jbb.bell_hits_or(jnp.asarray(frontier), jb))
    for budget in (None, 1, 17, 300):
        got = bitbell.bell_hits_or(_t(frontier), bg, slot_budget=budget)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_forest_or_plain_is_gated(graphs):
    n, g, _ = graphs["hub"]
    bg = BellGraph.from_host(g, "cpu")
    frontier = _t(_words(np.random.default_rng(3), (n, 2), 0.4))
    want = bell.forest_hits(frontier, bg)
    for ctrl, max_levels, runs in (
        ([1, 2, 0, bitbell.DIR_PULL], 100, True),
        ([1, 2, 0, bitbell.DIR_PUSH], 100, False),
        ([0, 2, 0, bitbell.DIR_PULL], 100, False),
        ([1, 2, 0, bitbell.DIR_PULL], 2, False),
    ):
        hits = torch.full_like(frontier, 9)
        cuda_bell.forest_or(frontier, bg, hits, torch.tensor(ctrl, dtype=torch.int32), max_levels)
        assert torch.equal(hits, want) if runs else bool((hits == 9).all())
    with pytest.raises(ValueError, match="shape"):
        cuda_bell.forest_or(frontier[:-1], bg, hits, torch.tensor(ctrl, dtype=torch.int32))


def test_forest_tables_cover_every_row(graphs):
    """The kernel's bucket table: one entry per nonempty bucket, rows
    adding up to each level's size, and each bucket's runs (whole rows:
    32 // W_b rows a chunk, the plan's chunks a run; one wide row a run)
    numbered after the previous bucket's."""
    n, g, _ = graphs["hub"]
    bg = BellGraph.from_host(g, "cpu")
    for w in (1, 2, 8):
        chunks = cuda_bell.forest_plan(w).chunks
        table, meta = cuda_bell.forest_tables(bg, w, "cpu")
        meta = list(meta)
        for li, size in enumerate(bg.level_sizes):
            _, prev_rows, out_off, begin, count, runs = meta[6 * li : 6 * li + 6]
            rows = table[begin : begin + count].tolist()
            assert sum(r[1] for r in rows) == size
            first = 0
            for off, r_b, w_b, row_base, first_run, rpc in rows:
                assert first_run == first and r_b > 0
                assert rpc == (32 // w_b if w_b <= 32 else 0)
                first += -(-r_b // (chunks * rpc)) if rpc else r_b
            assert runs == first
            assert prev_rows == (n if li == 0 else bg.level_sizes[li - 1])
            assert out_off == sum(bg.level_sizes[:li])
        assert cuda_bell.forest_tables(bg, w, "cpu")[0] is table  # cached


def _hub_heavy(seed):
    """RMAT edges with hubs of 33, 257, 700 and 880 dedup neighbours (wide
    buckets, chunk rows at the 256 rung, a three-level forest under the
    narrow ladder) besides a self-loop and isolated vertices."""
    n, (_, e) = 900, generators.rmat_edges(8, edge_factor=6, seed=seed)
    hubs = [np.stack([np.full(d, h, np.int32), (np.arange(d, dtype=np.int32) * 7 + h) % n], 1)
            for h, d in ((4, 33), (6, 257), (9, 700), (12, 880))]
    return n, np.concatenate([e] + hubs + [[[800, 800]]]).astype(np.int32)


@pytest.mark.parametrize(
    "widths",
    [DEFAULT_WIDTHS, NARROW, (1, 2, 3, 21, 27), (5, 34, 256), (1, 32, 33, 64)],
)
@pytest.mark.parametrize("w", [1, 2, 8])
def test_forest_or_hub_heavy_matches_jax(widths, w):
    """The forest wrapper on CPU tensors (its plain version) against JAX's
    bell_hits_or on hub-heavy forests under every ladder, the layout
    first; bit 31 and whole-word frontiers included."""
    n, e = _hub_heavy(w + len(widths))
    bg = BellGraph.from_host(CSRGraph.from_edges(n, e), "cpu", widths=widths, min_bucket_rows=0)
    jb = JBellGraph.from_host(JCSRGraph.from_edges(n, e), widths=widths, min_bucket_rows=0)
    assert bg.level_shapes == jb.level_shapes and len(bg.level_sizes) >= 2
    assert any(wb > 32 and rb for rb, wb in bg.level_shapes[0]) == (max(widths) > 32)
    frontier = _words(np.random.default_rng(w), (n, w), 0.4)
    frontier[::7, 0] = np.uint32(1 << 31)
    want = np.asarray(jbb.bell_hits_or(jnp.asarray(frontier), jb))
    hits = torch.full((n, w), 5, dtype=torch.int32)
    ctrl = torch.tensor([1, 0, 0, bitbell.DIR_PULL], dtype=torch.int32)
    cuda_bell.forest_or(_t(frontier), bg, hits, ctrl)
    np.testing.assert_array_equal(hits.numpy().view(np.uint32), want)


def _queries(n, k, seed):
    q = generators.random_queries(n, k, max_group=5, seed=seed)
    if k > 3:
        q[1] = np.zeros(0, dtype=np.int32)  # an empty group
        q[2] = np.array([-1, n + 3], dtype=np.int32)  # nothing in range
    return io.pad_queries(q)


# (graph, K, engine kwargs), the same kwargs on both sides.
ENGINE_CASES = [
    ("hub", 33, {}),
    ("hub", 70, {"level_chunk": 3}),
    ("hub", 1, {"level_chunk": 1}),
    ("hub", 33, {"sparse_budget": 0, "level_chunk": 2, "megachunk": 2}),
    ("hub", 8, {"sparse_budget": 300}),
    ("hub", 33, {"slot_budget": 50, "level_chunk": 128}),
    ("hub", 12, {"max_levels": 2}),
    ("no_edges", 33, {}),
    ("road", 70, {"level_chunk": 3}),
    ("road", 1, {}),
]


@pytest.mark.parametrize("kind,k,kwargs", ENGINE_CASES)
def test_engine_matches_jax(graphs, kind, k, kwargs):
    n, g, jg = graphs[kind]
    padded = _queries(n, k, k + len(kind))
    jeng = jbb.BitBellEngine(JBellGraph.from_host(jg), **kwargs)
    want = jeng.query_stats(padded)
    bg = BellGraph.from_host(g, "cpu")
    for plain in (False, True):
        eng = bitbell.BitBellEngine(bg, plain=plain, **kwargs)
        assert eng.sparse_budget == jeng.sparse_budget
        for x, y in zip(eng.query_stats(padded), want):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(eng.f_values(padded).numpy(), np.asarray(jeng.f_values(padded)))
    assert eng.best(padded) == jeng.best(padded)


def _directions(eng, queries):
    """ctrl[3] before each single-level chunk: the direction each level
    takes (the sources' made at the carry's start, every later one by the
    apply of the level before)."""
    carry = eng._init_carry(eng._pad_queries(queries)[0])
    seen = []
    while bitbell.level_go(carry.ctrl, 10**6):
        seen.append(int(carry.ctrl[3]))
        eng._chunk(carry, 1)
    return seen


def test_push_and_pull_in_one_bfs(graphs):
    """With a small budget the thin first and last levels push and the wide
    middle pulls, and the result still equals JAX's."""
    n, g, jg = graphs["hub"]
    padded = _queries(n, 33, 5)
    eng = bitbell.BitBellEngine(BellGraph.from_host(g, "cpu"), sparse_budget=600)
    seen = _directions(eng, padded)
    assert seen == [bitbell.DIR_PUSH, bitbell.DIR_PULL, bitbell.DIR_PULL, bitbell.DIR_PUSH]
    want = jbb.BitBellEngine(JBellGraph.from_host(jg), sparse_budget=600).query_stats(padded)
    for x, y in zip(eng.query_stats(padded), want):
        np.testing.assert_array_equal(x, y)
    # Pure forest: no dedup CSR, or a zero budget.
    for bg, budget in ((BellGraph.from_host(g, "cpu", keep_sparse=False), None), (eng.graph, 0)):
        pure = bitbell.BitBellEngine(bg, sparse_budget=budget)
        assert set(_directions(pure, padded)) == {bitbell.DIR_PULL}
        for x, y in zip(pure.query_stats(padded), want):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k,budget", [(33, 600), (70, 600), (8, 300), (33, 10**6)])
def test_device_directions_match_jax_predicate(graphs, k, budget):
    """Level by level, the direction the apply wrote (the sources' at the
    carry's start) equals JAX's hybrid predicate on the same frontier, the
    push's hit plane is zero after every applied level, and the run's results
    equal the JAX engine's (W = 3 at K = 70: the rows variant's width)."""
    n, g, jg = graphs["hub"]
    padded = _queries(n, k, k + budget)
    bg = BellGraph.from_host(g, "cpu")
    eng = bitbell.BitBellEngine(bg, sparse_budget=budget)
    count = jnp.asarray(bg.sparse[1].numpy())
    carry = eng._init_carry(eng._pad_queries(padded)[0])
    hits = torch.zeros_like(carry.frontier)
    expand = bitbell.bitbell_expand(bg)
    seen = []
    while bitbell.level_go(carry.ctrl, 10**6):
        _, cnt, edges = jengine.frontier_activity(
            jnp.asarray(carry.frontier.numpy().view(np.uint32)), count
        )
        push = bool((cnt <= budget) & (edges <= budget))
        assert int(carry.ctrl[3]) == (bitbell.DIR_PUSH if push else bitbell.DIR_PULL)
        seen.append(push)
        expand(carry, hits, 10**6, None)
        bitbell.bit_level_apply(carry, hits)
        assert not bool(carry.switch.hits.any())
    assert len(seen) >= 3
    want = jbb.BitBellEngine(JBellGraph.from_host(jg), sparse_budget=budget).query_stats(padded)
    np.testing.assert_array_equal(carry.f[:k].numpy(), want[2])
    np.testing.assert_array_equal(carry.levels[:k].numpy(), want[0])
    np.testing.assert_array_equal(carry.reached[:k].numpy(), want[1])


def test_slot_budget_knob_and_auto(graphs, monkeypatch):
    _, g, jg = graphs["hub"]
    bg, jb = BellGraph.from_host(g, "cpu"), JBellGraph.from_host(jg)
    monkeypatch.setenv("MSBFS_SLOT_BUDGET", "77")
    assert bitbell.BitBellEngine(bg)._slot_budget_for(2) == 77
    monkeypatch.setenv("MSBFS_SLOT_BUDGET", "0")
    assert bitbell.BitBellEngine(bg)._slot_budget_for(2) is None
    monkeypatch.delenv("MSBFS_SLOT_BUDGET")
    monkeypatch.setenv("MSBFS_HBM_BYTES", "3000")
    for w in (1, 8):
        assert bitbell.BitBellEngine(bg)._slot_budget_for(w) == jbb.BitBellEngine(jb)._slot_budget_for(w)
    monkeypatch.delenv("MSBFS_HBM_BYTES")
    assert bitbell.BitBellEngine(bg)._slot_budget_for(8) is None


def test_k300_subbatch_and_no_queries(graphs):
    n, g, jg = graphs["hub"]
    queries = io.pad_queries(generators.random_queries(n, 300, max_group=3, seed=9))
    teng = packed.SubBatchEngine(bitbell.BitBellEngine(BellGraph.from_host(g, "cpu"), level_chunk=4))
    jeng = jpacked.SubBatchEngine(jbb.BitBellEngine(JBellGraph.from_host(jg), level_chunk=4))
    want = jeng.query_stats(queries)
    for x, y in zip(teng.query_stats(queries), want):
        np.testing.assert_array_equal(x, y)
    winner = int(np.argmin(want[2]))
    assert teng.best(queries) == (int(want[2][winner]), winner)
    empty = np.zeros((0, 2), dtype=np.int32)
    assert teng.best(empty) == jeng.best(empty) == (-1, -1)
