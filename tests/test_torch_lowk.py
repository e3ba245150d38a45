"""The port's low-K branch and byte-flag BELL engine against the JAX
package on the same seeded inputs: source packing at both lane strides,
the byte-flag pull and push (plain, and the bit-plane kernels' plain
versions over the byte view), ``LowKEngine`` and ``BellEngine`` in their
drive modes, the device's direction sequence against JAX's predicate and
the sub-batch split around low-K.  Both packages' ``BellGraph``s come from
one host CSR.  Everything is bits and integers: every comparison is exact.

The port's byte planes are (n, Kp) uint8, Kp = 4 ceil(K/4); JAX's flags
are (n, K).  :func:`flags_to_planes` and :func:`planes_to_flags` carry one
to the other (the second also checks that the padding bytes are zero)."""

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
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import lowk as jlowk
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    packed as jpacked,
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
    bell,
    bitbell,
    cuda_bell,
    lowk,
    packed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import io

JBellGraph = jbell_model.BellGraph


def flags_to_planes(flags: np.ndarray) -> torch.Tensor:
    """JAX's (n, K) 0/1 flags -> the port's (n, Kp) uint8 byte plane."""
    n, k = flags.shape
    out = np.zeros((n, max(4, -(-k // 4) * 4)), dtype=np.uint8)
    out[:, :k] = flags
    return torch.from_numpy(out)


def planes_to_flags(planes: torch.Tensor, k: int) -> np.ndarray:
    """The port's (n, Kp) byte plane -> (n, K) flags; its padding bytes
    must be zero."""
    a = planes.cpu().numpy()
    assert a.dtype == np.uint8 and not a[:, k:].any()
    return a[:, :k]


def _edges(kind):
    """(n, edges): RMAT plus a 600-neighbour hub (a second forest level)
    and a self-loop-only vertex, isolated vertices past the RMAT range;
    no edges; a road grid."""
    if kind == "hub":
        _, e = generators.rmat_edges(8, edge_factor=6, seed=11)
        hub = np.stack([np.full(600, 3, np.int32), np.arange(600, dtype=np.int32) % 290 + 10], 1)
        return 400, np.concatenate([e, hub, [[350, 350], [8, 9], [8, 9]]]).astype(np.int32)
    if kind == "no_edges":
        return 50, np.zeros((0, 2), np.int32)
    return generators.road_edges(12, 12, seed=5)


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for kind in ("hub", "no_edges", "road"):
        n, e = _edges(kind)
        g, jg = CSRGraph.from_edges(n, e), JCSRGraph.from_edges(n, e)
        out[kind] = (n, g, jg, BellGraph.from_host(g, "cpu"), JBellGraph.from_host(jg))
    return out


def _queries(n, k, seed, max_group=5):
    q = generators.random_queries(n, k, max_group=max_group, seed=seed)
    if k > 3:
        q[1] = np.zeros(0, dtype=np.int32)  # an empty group
        q[2] = np.array([-1, n + 3], dtype=np.int32)  # nothing in range
    return io.pad_queries(q)


def _pack_input(k, s, n, seed):
    """Queries with -1 and >= n sources, duplicates inside a group and
    across groups, and the last query on vertex n - 1."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-2, n + 3, size=(k, s)).astype(np.int32)
    if k and s > 5:
        q[:, 5] = q[:, 0]
    if k > 1:
        q[1] = q[0]
    if k and s:
        q[k - 1, 0] = n - 1
    if k > 2:
        q[2] = -1
    return q


@pytest.mark.parametrize("k,s", [(1, 7), (2, 7), (3, 7), (4, 7), (32, 7), (64, 7), (3, 0), (0, 3)])
def test_pack_matches_jax_at_both_strides(k, s):
    """Stride 8 against JAX's lowk_pack and _lowk_counts, stride 1 against
    its pack_queries (the batch padded to whole words there), through the
    plain version and through the wrapper on CPU tensors."""
    n = 300
    q = _pack_input(k, s, n, seed=k * 10 + s)
    flags = np.asarray(jlowk.lowk_pack(n, jnp.asarray(q)))
    got = lowk.lowk_pack(n, q, "cpu")
    assert got.dtype == torch.uint8 and got.shape[1] == max(4, -(-k // 4) * 4)
    np.testing.assert_array_equal(planes_to_flags(got, k), flags)
    want_counts = np.asarray(jlowk._lowk_counts(jnp.asarray(flags)))
    kpad = max(32, -(-k // 32) * 32)
    qw = np.concatenate([q, np.full((kpad - k, s), -1, np.int32)])
    words = np.asarray(jbb.pack_queries(n, jnp.asarray(qw)))
    for pack in (bitbell.pack_queries, bitbell.pack_queries_plain):
        plane8, counts8 = pack(n, q, "cpu", 8)
        assert torch.equal(plane8.view(torch.uint8), got)
        assert counts8.shape == (32 * plane8.shape[1],)
        np.testing.assert_array_equal(counts8[::8][:k].numpy(), want_counts)
        assert not counts8.view(-1, 8)[:, 1:].any() and not counts8[::8][k:].any()
        plane1, counts1 = pack(n, q, "cpu", 1)
        assert plane1.shape == (n, max(1, -(-k // 32)))
        np.testing.assert_array_equal(plane1.numpy().view(np.uint32), words[:, : plane1.shape[1]])
        np.testing.assert_array_equal(
            counts1.numpy(), np.asarray(jbb.unpack_counts(jnp.asarray(words)))[: counts1.shape[0]]
        )
    if k > 2:
        assert int(counts8[16]) == 0  # query 2 has no source in range


def test_pack_sources_checks_its_buffers():
    """The batch start's packing (its plain version, and the batch start
    on CPU tensors) and the checks of its inputs: the queries' rank, the
    plane rows, the switch's out-degrees, the lane stride."""
    q = torch.zeros((3, 2), dtype=torch.int32)
    plane, counts = torch.zeros((10, 1), dtype=torch.int32), torch.zeros(32, dtype=torch.int32)
    bitbell.pack_sources_plain(q, 10, plane, counts, 8)
    assert int(plane[0]) == 1 | 1 << 8 | 1 << 16 and counts[::8].tolist() == [1, 1, 1, 0]
    carry = bitbell.batch_start(10, q.numpy(), "cpu", 8)
    assert torch.equal(carry.frontier, plane) and torch.equal(carry.visited, plane)
    assert torch.equal(carry.reached, counts) and carry.k == 3
    with pytest.raises(ValueError, match="shape"):
        bitbell.batch_start(10, np.zeros(3, dtype=np.int32), "cpu", 8)
    with pytest.raises(ValueError, match="rows"):
        bitbell.batch_start(10, q.numpy(), "cpu", 8, rows=9)
    limits = bitbell.SwitchLimits(torch.zeros(9, dtype=torch.int32), 4, 4)
    with pytest.raises(ValueError, match="shape"):
        bitbell.batch_start(10, q.numpy(), "cpu", 8, switch=limits)
    limits = bitbell.SwitchLimits(torch.zeros(10, dtype=torch.int64), 4, 4)
    with pytest.raises(TypeError, match="int32"):
        bitbell.batch_start(10, q.numpy(), "cpu", 8, switch=limits)
    with pytest.raises(ValueError, match="positive"):
        bitbell.pack_queries(10, np.zeros((3, 2)), "cpu", 0)


def _flags(rng, n, k, density):
    return (rng.random((n, k)) < density).astype(np.uint8)


def _go(direction):
    return torch.tensor([1, 0, 0, direction], dtype=torch.int32)


@pytest.mark.parametrize("kind", ["hub", "road", "no_edges"])
@pytest.mark.parametrize("k", [1, 3, 4, 8, 64])
def test_bell_hits_packed_matches_jax(graphs, kind, k):
    """The byte pull — its plain version (amax over bytes), the wrapper on
    CPU tensors and the forest kernel's plain version over the byte view —
    against JAX's bell_hits_packed; every byte of hits is rewritten."""
    n, _, _, bg, jb = graphs[kind]
    flags = _flags(np.random.default_rng(k), n, k, 0.2)
    want = np.asarray(jbell.bell_hits_packed(jnp.asarray(flags), jb))
    frontier = flags_to_planes(flags)
    go = _go(bitbell.DIR_PULL)
    for name in ("plain", "wrapper", "forest_or_plain"):
        hits = torch.full_like(frontier, 9)
        if name == "plain":
            bell.bell_hits_packed_plain(frontier, bg, hits, go)
        elif name == "wrapper":
            bell.bell_hits_packed(frontier, bg, hits, go)
        else:
            cuda_bell.forest_or_plain(bell.byte_words(frontier), bg, bell.byte_words(hits), go)
        np.testing.assert_array_equal(planes_to_flags(hits, k), want, err_msg=name)
    # Gated off: a push level leaves the plane untouched.
    hits = torch.full_like(frontier, 9)
    bell.bell_hits_packed(frontier, bg, hits, _go(bitbell.DIR_PUSH))
    assert bool((hits == 9).all())


def test_byte_words_is_a_view():
    plane = torch.zeros((5, 8), dtype=torch.uint8)
    words = bell.byte_words(plane)
    plane[2, 4] = 1
    assert words.shape == (5, 2) and int(words[2, 1]) == 1
    plane[3, 5] = 1
    assert int(words[3, 1]) == 1 << 8
    with pytest.raises(ValueError, match="multiple of 4"):
        bell.byte_words(torch.zeros((5, 6), dtype=torch.uint8))
    with pytest.raises(TypeError):
        bell.byte_words(torch.zeros((5, 8), dtype=torch.int32))


@pytest.mark.parametrize(
    "kind,k,density,budget",
    [("hub", 1, 0.02, 5000), ("hub", 3, 0.05, 5000), ("hub", 4, 0.01, 700),
     ("hub", 8, 0.03, 5000), ("road", 2, 0.1, 2000)],
)
def test_sparse_hits_flags_matches_jax(graphs, kind, k, density, budget):
    """The byte push — its plain version (index_reduce_ amax), the wrapper
    on CPU tensors and the push kernel's plain version over the byte view —
    against JAX's sparse_hits_flags on a frontier within the budget (JAX
    compacts at most ``budget`` rows and edges), listed by the switch
    epilogue as a level's apply lists it."""
    n, _, _, bg, jb = graphs[kind]
    rng = np.random.default_rng(k + budget)
    flags = _flags(rng, n, k, density)
    flags[3, 0] = 1  # the hub of the "hub" graph
    frontier = flags_to_planes(flags)
    _, cnt, edges = jengine.frontier_activity(jnp.asarray(flags), jnp.asarray(jb.sparse[1]))
    assert int(cnt) <= budget and int(edges) <= budget
    want = np.asarray(jlowk.sparse_hits_flags(jnp.asarray(flags), jb, budget))
    start, count, vals = bg.sparse
    for name in ("plain", "wrapper", "sparse_hits_or_plain"):
        switch = bitbell.PushSwitch.new(count, budget, budget, frontier.shape[1] // 4)
        ctrl = _go(bitbell.DIR_PULL)
        bitbell.switch_record(switch, bell.byte_words(frontier), ctrl)
        assert int(ctrl[3]) == bitbell.DIR_PUSH
        hits = torch.zeros_like(frontier)
        if name == "plain":
            lowk.sparse_hits_flags_plain(frontier, bg, hits, ctrl, switch)
        elif name == "wrapper":
            lowk.sparse_hits_flags(frontier, bg, hits, ctrl, switch)
        else:
            bitbell.sparse_hits_or_plain(
                bell.byte_words(frontier), start, vals, bell.byte_words(hits), ctrl, switch
            )
        np.testing.assert_array_equal(planes_to_flags(hits, k), want, err_msg=name)


# (graph, K, engine kwargs), the same kwargs on both sides.
LOWK_CASES = [
    ("hub", 1, {}),
    ("hub", 3, {"level_chunk": 1}),
    ("hub", 4, {"level_chunk": 3, "sparse_budget": 0}),
    ("hub", 2, {"sparse_budget": 300}),
    ("hub", 4, {"sparse_budget": 300, "level_chunk": 1}),
    ("hub", 3, {"sparse_budget": 0}),
    ("hub", 2, {"max_levels": 2}),
    ("hub", 40, {"level_chunk": 3}),
    ("no_edges", 3, {}),
    ("road", 4, {"level_chunk": 3}),
    ("road", 1, {"sparse_budget": 50}),
]


@pytest.mark.parametrize("kind,k,kwargs", LOWK_CASES)
def test_lowk_engine_matches_jax(graphs, kind, k, kwargs):
    """F, levels, reached and the winner of the kernel path (on CPU
    tensors) and of the plain path equal JAX's LowKEngine."""
    n, _, _, bg, jb = graphs[kind]
    padded = _queries(n, k, k + len(kind))
    jeng = jlowk.LowKEngine(jb, **kwargs)
    want = jeng.query_stats(padded)
    for plain in (False, True):
        eng = lowk.LowKEngine(bg, plain=plain, **kwargs)
        assert eng.sparse_budget == jeng.sparse_budget
        for x, y in zip(eng.query_stats(padded), want):
            np.testing.assert_array_equal(x, y)
        f = eng.f_values(padded)
        assert f.shape == (k,)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jeng.f_values(padded)))
        assert eng.best(padded) == jeng.best(padded)


def _directions(eng, queries):
    carry = eng._init_carry(eng._pad_queries(queries)[0])
    seen = []
    while bitbell.level_go(carry.ctrl, 10**6):
        seen.append(int(carry.ctrl[3]))
        eng._chunk(carry, 1)
    return seen


@pytest.mark.parametrize("k,budget", [(2, 300), (3, 600), (4, 300), (1, 10**6)])
def test_device_directions_match_jax_predicate(graphs, k, budget):
    """Level by level, the direction the apply wrote (the sources' at the
    carry's start) equals JAX's low-K predicate on the same flags, the
    push's plane is zero after every level, the padding bytes of every
    plane stay zero (K = 3: byte 3 of each row), and the results equal
    JAX's engine."""
    n, _, _, bg, jb = graphs["hub"]
    padded = _queries(n, k, k + budget)
    eng = lowk.LowKEngine(bg, sparse_budget=budget)
    count = jnp.asarray(bg.sparse[1].numpy())
    carry = eng._init_carry(eng._pad_queries(padded)[0])
    hits = torch.zeros_like(carry.frontier)
    expand = lowk.lowk_expand(bg)
    seen = []
    while bitbell.level_go(carry.ctrl, 10**6):
        flags = planes_to_flags(carry.frontier.view(torch.uint8), k)
        planes_to_flags(carry.visited.view(torch.uint8), k)
        _, cnt, edges = jengine.frontier_activity(jnp.asarray(flags), count)
        push = bool((cnt <= budget) & (edges <= budget))
        assert int(carry.ctrl[3]) == (bitbell.DIR_PUSH if push else bitbell.DIR_PULL)
        seen.append(push)
        expand(carry, hits, 10**6, None)
        planes_to_flags(hits.view(torch.uint8) if not push else carry.switch.hits.view(torch.uint8), k)
        bitbell.bit_level_apply(carry, hits)
        assert not bool(carry.switch.hits.any())
    assert len(seen) >= 3
    if budget == 300:
        assert True in seen and False in seen
    want = jlowk.LowKEngine(jb, sparse_budget=budget).query_stats(padded)
    got = (carry.levels[::8][:k], carry.reached[::8][:k], carry.f[::8][:k])
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y)
    assert not carry.f.view(-1, 8)[:, 1:].any()  # lanes 8q + 1..7 never count


@pytest.mark.parametrize("k,budget", [(1, 5000), (3, 300), (4, 300), (2, 600)])
def test_flag_expand_matches_jax_lowk_expand(graphs, k, budget):
    """The low-K level's single expansion call (``flag_expand``: the push
    on a level ctrl[3] sends to the push, into the switch's plane, else
    the byte pull into ``hits``), masked by visited as the apply masks it,
    against JAX's ``lowk_expand`` on every level of one BFS, push and pull
    levels both; the engine's stepper reaches the same counters."""
    n, _, _, bg, jb = graphs["hub"]
    padded = _queries(n, k, 7 * k + budget)
    eng = lowk.LowKEngine(bg, sparse_budget=budget)
    carry = eng._init_carry(eng._pad_queries(padded)[0])
    jexpand = jlowk.lowk_expand(jb, budget)
    hits = torch.zeros_like(carry.frontier)
    u8 = torch.uint8
    seen = set()
    while bitbell.level_go(carry.ctrl, 10**6):
        flags = planes_to_flags(carry.frontier.view(u8), k)
        seen_flags = planes_to_flags(carry.visited.view(u8), k)
        want = np.asarray(jexpand(jnp.asarray(seen_flags), jnp.asarray(flags)))
        pushed = int(carry.ctrl[3]) == bitbell.DIR_PUSH
        seen.add(pushed)
        lowk.flag_expand(carry, bg, hits, 10**6)
        plane = (carry.switch.hits if pushed else hits).view(u8) & ~carry.visited.view(u8)
        np.testing.assert_array_equal(planes_to_flags(plane, k), want)
        bitbell.bit_level_apply(carry, hits)
        assert not bool(carry.switch.hits.any())
    assert len(seen) == 2 or budget == 5000
    stepped = eng._init_carry(eng._pad_queries(padded)[0])
    eng._chunk(stepped, None)
    for field in ("f", "levels", "reached", "ctrl"):
        assert torch.equal(getattr(stepped, field), getattr(carry, field)), field


def test_lowk_directions_push_and_pull_in_one_bfs(graphs):
    n, _, _, bg, jb = graphs["hub"]
    padded = _queries(n, 3, 5)
    seen = _directions(lowk.LowKEngine(bg, sparse_budget=300), padded)
    assert bitbell.DIR_PUSH in seen and bitbell.DIR_PULL in seen
    assert set(_directions(lowk.LowKEngine(bg, sparse_budget=0), padded)) == {bitbell.DIR_PULL}


def test_lowk_no_query_padding(graphs):
    """k_align = 1: K queries stay K, F has exactly K entries, an empty
    batch answers (-1, -1), ties go to the first query and the padding
    lanes (F = 0) never win."""
    n, _, _, bg, jb = graphs["hub"]
    eng = lowk.LowKEngine(bg)
    assert eng.k_align == 1 and eng.lane_stride == 8
    padded, k = eng._pad_queries(np.array([[3, 5]], dtype=np.int32))
    assert padded.shape == (1, 2) and k == 1
    empty = np.zeros((0, 1), dtype=np.int32)
    assert eng.best(empty) == jlowk.LowKEngine(jb).best(empty) == (-1, -1)
    assert eng.f_values(empty).shape == (0,)
    q = io.pad_queries([[3], [40, 41], [3]])  # groups 0 and 2 tie
    f = eng.f_values(q)
    assert f.shape == (3,) and int(f.min()) > 0 and int(f[0]) == int(f[2])
    assert eng.best(q) == jlowk.LowKEngine(jb).best(q) == (int(f.min()), int(np.argmin(f.numpy())))


def test_lowk_run_and_counts_match_jax(graphs):
    n, _, _, bg, jb = graphs["hub"]
    q = _queries(n, 3, 8)
    for budget in (0, 300):
        got = lowk.lowk_run(bg, q, None, budget)
        want = jlowk.lowk_run(jb, jnp.asarray(q), None, budget)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    flags = _flags(np.random.default_rng(4), n, 3, 0.3)
    np.testing.assert_array_equal(
        lowk._lowk_counts(flags_to_planes(flags))[:3].numpy(),
        np.asarray(jlowk._lowk_counts(jnp.asarray(flags))),
    )


def test_lowk_budget_needs_the_dedup_csr(graphs):
    _, g, jg, _, _ = graphs["hub"]
    bare = BellGraph.from_host(g, "cpu", keep_sparse=False)
    with pytest.raises(ValueError, match="dedup CSR"):
        lowk.LowKEngine(bare, sparse_budget=5)
    with pytest.raises(ValueError, match="dedup CSR"):
        jlowk.LowKEngine(JBellGraph.from_host(jg, keep_sparse=False), sparse_budget=5)
    assert lowk.LowKEngine(bare).sparse_budget == 0


def test_subbatch_wraps_lowk(graphs):
    """The splitter around low-K (K = 7 in batches of 3) equals JAX's."""
    n, _, _, bg, jb = graphs["hub"]
    padded = io.pad_queries(generators.random_queries(n, 7, max_group=3, seed=817))
    wrap = packed.SubBatchEngine(lowk.LowKEngine(bg), batch_k=3)
    jwrap = jpacked.SubBatchEngine(jlowk.LowKEngine(jb), batch_k=3)
    want = jwrap.query_stats(padded)
    for x, y in zip(wrap.query_stats(padded), want):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(wrap.f_values(padded).numpy(), want[2])
    assert wrap.best(padded) == jwrap.best(padded)
    wrap.compile(padded.shape)


@pytest.mark.parametrize("kind,k,kwargs", [
    ("hub", 1, {}), ("hub", 8, {"level_chunk": 2}), ("hub", 13, {}),
    ("hub", 64, {"level_chunk": 3}), ("hub", 5, {"max_levels": 2}),
    ("road", 9, {}), ("no_edges", 3, {}),
])
def test_bell_engine_matches_jax(graphs, kind, k, kwargs):
    """The pull-only byte-plane engine's counters equal JAX's BellEngine,
    whose stats come from its distance matrix."""
    n, g, jg, _, _ = graphs[kind]
    bg = BellGraph.from_host(g, "cpu", keep_sparse=False)
    jeng = jbell.BellEngine(JBellGraph.from_host(jg, keep_sparse=False), **kwargs)
    padded = _queries(n, k, 3 * k + len(kind))
    want = jeng.query_stats(padded)
    for plain in (False, True):
        eng = bell.BellEngine(bg, plain=plain, **kwargs)
        assert eng.k_align == 8 and eng.sparse_budget == 0
        for x, y in zip(eng.query_stats(padded), want):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(eng.f_values(padded).numpy(), np.asarray(jeng.f_values(padded)))
        assert eng.best(padded) == jeng.best(padded)


@pytest.mark.parametrize("max_levels", [None, 2])
def test_bell_distances_match_jax(graphs, max_levels):
    """The plain distance functions (the tests' reference of the byte
    engines) against JAX's, unchunked and chunked."""
    n, _, _, bg, jb = graphs["hub"]
    q = _queries(n, 9, 31)
    want = np.asarray(jbell.bell_distances(jb, jnp.asarray(q), max_levels))
    np.testing.assert_array_equal(bell.bell_distances(bg, q, max_levels).numpy(), want)
    for chunk in (1, 3):
        np.testing.assert_array_equal(
            bell.bell_distances_chunked(bg, q, chunk, max_levels).numpy(),
            np.asarray(jbell.bell_distances_chunked(jb, jnp.asarray(q), chunk, max_levels)),
        )
    np.testing.assert_array_equal(
        bell.bell_f_values(bg, q, max_levels).numpy(),
        np.asarray(jbell.bell_f_values(jb, jnp.asarray(q), max_levels)),
    )
    dist = torch.from_numpy(want.copy())
    np.testing.assert_array_equal(
        bell.bell_expand_packed(dist, 1, bg).numpy(),
        np.asarray(jbell.bell_expand_packed(jnp.asarray(want), jnp.int32(1), jb)),
    )
