"""The port's bit-plane primitives (plain torch, as they run on the CPU)
against the JAX package's on the same random planes — bit 31 included,
K not a multiple of 32 where the function allows it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    bitbell as jbb,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    engine as jengine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bitbell as tbb,
)


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("k", [32, 64, 96])
def test_pack_queries_matches_jax(k):
    rng = np.random.default_rng(k)
    n = 300
    queries = rng.integers(-2, n + 3, size=(k, 7)).astype(np.int32)
    queries[:, 5] = queries[:, 0]  # duplicate sources inside a group
    queries[k - 1] = n - 1  # query 31 of the last word: bit 31
    queries[3] = -1  # a group with no valid source
    planes, counts0 = tbb.pack_queries(n, queries, "cpu")
    want = np.asarray(jbb.pack_queries(n, jnp.asarray(queries)))
    np.testing.assert_array_equal(planes.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        counts0.numpy(), np.asarray(jbb.unpack_counts(jnp.asarray(want)))
    )
    assert counts0[3] == 0 and counts0[k - 1] == 1


@pytest.mark.parametrize("w", [1, 3])
def test_unpack_counts_and_byte_planes_match_jax(w):
    rng = np.random.default_rng(w)
    words = _words(rng, (257, w))
    words[0] = 0xFFFFFFFF
    np.testing.assert_array_equal(
        tbb.unpack_counts(_t(words)).numpy(),
        np.asarray(jbb.unpack_counts(jnp.asarray(words))),
    )
    bytes_t = tbb.unpack_byte_planes(_t(words))
    np.testing.assert_array_equal(
        bytes_t.numpy(), np.asarray(jbb.unpack_byte_planes(jnp.asarray(words)))
    )
    np.testing.assert_array_equal(
        tbb.pack_byte_planes(bytes_t).numpy().view(np.uint32), words
    )


@pytest.mark.parametrize("w,level", [(1, 0), (2, 7), (3, 30)])
def test_bit_level_apply_matches_jax(w, level):
    rng = np.random.default_rng(100 + w)
    n, k = 500, 32 * w
    hits, visited, frontier = (_words(rng, (n, w)) for _ in range(3))
    hits[rng.random(n) < 0.4] = 0
    f = rng.integers(0, 10**6, size=k)
    levels = rng.integers(0, 5, size=k).astype(np.int32)
    reached = rng.integers(0, 50, size=k).astype(np.int32)
    jcarry = (
        jnp.asarray(visited), jnp.asarray(frontier), jnp.asarray(f),
        jnp.asarray(levels), jnp.asarray(reached), jnp.int32(level),
        jnp.asarray(True),
    )
    new = jnp.asarray(hits) & ~jnp.asarray(visited)
    want = jbb.bit_level_apply(jcarry, new)
    carry = tbb.BitCarry(
        visited=_t(visited.copy()), frontier=_t(frontier.copy()),
        f=torch.from_numpy(f.copy()), levels=torch.from_numpy(levels.copy()),
        reached=torch.from_numpy(reached.copy()),
        counts=torch.zeros(k, dtype=torch.int32),
        ctrl=torch.tensor([1, level, 0, 0], dtype=torch.int32),
    )
    tbb.bit_level_apply(carry, _t(hits))  # a CPU tensor: the plain version
    np.testing.assert_array_equal(carry.visited.numpy().view(np.uint32), np.asarray(want[0]))
    np.testing.assert_array_equal(carry.frontier.numpy().view(np.uint32), np.asarray(want[1]))
    np.testing.assert_array_equal(carry.f.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(carry.levels.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(carry.reached.numpy(), np.asarray(want[4]))
    assert carry.ctrl[:2].tolist() == [int(want[6]), int(want[5])]


def test_bit_level_apply_gated():
    """A converged carry, or one at max_levels, is a fixed point."""
    rng = np.random.default_rng(7)
    hits = _t(_words(rng, (64, 1)))
    for ctrl, max_levels in (([0, 3, 0, 0], 100), ([1, 3, 0, 0], 3)):
        carry = tbb.bit_level_init(torch.zeros((64, 1), dtype=torch.int32),
                                   torch.zeros(32, dtype=torch.int32))
        carry.ctrl = torch.tensor(ctrl, dtype=torch.int32)
        tbb.bit_level_apply(carry, hits, max_levels)
        assert int(carry.visited.abs().sum()) == 0
        assert carry.ctrl.tolist() == ctrl


def test_bit_level_init_matches_jax():
    rng = np.random.default_rng(11)
    planes = _words(rng, (40, 2))
    planes[:, 1] = 0  # queries 32..63 have no source
    counts0 = jbb.unpack_counts(jnp.asarray(planes))
    want = jbb.bit_level_init(jnp.asarray(planes), counts0)
    got = tbb.bit_level_init(_t(planes), torch.from_numpy(np.asarray(counts0)))
    np.testing.assert_array_equal(got.f.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got.levels.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got.reached.numpy(), np.asarray(want[4]))
    assert got.ctrl[:2].tolist() == [int(want[6]), int(want[5])]


@pytest.mark.parametrize(
    "f,k",
    [
        ([5, 3, 3, 9] + [0] * 28, 4),  # tie -> lowest index; pad lanes lose
        ([0, 0, 7] + [0] * 29, 3),  # F = 0 empty groups tie
        ([4] * 64, 40),  # K not a multiple of 32
        ([0] * 32, 0),  # K = 0 -> (-1, -1)
        ([-1, 6, -1] + [0] * 29, 3),  # negative F never wins
    ],
)
def test_fused_select_matches_jax(f, k):
    f = np.asarray(f, dtype=np.int64)
    want = jbb.fused_select(jnp.asarray(f), k)
    got = tbb.fused_select(torch.from_numpy(f), k)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))


@pytest.mark.parametrize(
    "megachunk,level_chunk,want", [(None, 4, 8), (3, 4, 3), (None, None, 1)]
)
def test_resolve_megachunk(megachunk, level_chunk, want):
    assert tbb.resolve_megachunk(megachunk, level_chunk) == want
    assert jbb.resolve_megachunk(megachunk, level_chunk) == want


def _jax_activity(frontier, count):
    """JAX's frontier_activity on a port plane: (active rows, cnt, edges)."""
    active, cnt, edges = jengine.frontier_activity(
        jnp.asarray(frontier.numpy().view(np.uint32)), jnp.asarray(count.numpy())
    )
    return np.asarray(active), int(cnt), int(edges)


def _switched_carry(rng, n, w, count, row_limit, edge_limit):
    k = 32 * w
    return tbb.BitCarry(
        visited=_t(_words(rng, (n, w))), frontier=_t(_words(rng, (n, w))),
        f=torch.zeros(k, dtype=torch.int64),
        levels=torch.ones(k, dtype=torch.int32),
        reached=torch.ones(k, dtype=torch.int32),
        counts=torch.zeros(k, dtype=torch.int32),
        ctrl=torch.tensor([1, 4, 0, 0], dtype=torch.int32),
        switch=tbb.PushSwitch.new(count, row_limit, edge_limit, w),
    )


@pytest.mark.parametrize("pushed", [False, True])
@pytest.mark.parametrize("n,w", [(500, 1), (777, 2), (500, 3), (1001, 4), (333, 8)])
def test_switched_apply_matches_jax_predicate(n, w, pushed):
    """The plain apply's epilogue against JAX's frontier_activity and the
    push predicate on the new frontier, with the limits at the frontier's
    rows and edges, one under each, and zero: ctrl[3], the state's counts,
    the worklist as a set (rows with out-edges) with its edge prefix.  A
    level ctrl[3] sent to the push reads the switch's plane and leaves it
    all zero; a pulled one reads the pull's plane and leaves it as it was."""
    rng = np.random.default_rng(300 + n + w)
    hits = _words(rng, (n, w))
    hits[rng.random(n) < 0.9] = 0
    count = torch.from_numpy(rng.integers(0, 6, size=n).astype(np.int32))
    state = rng.bit_generator.state
    probe = _switched_carry(rng, n, w, count, n, 10**9)
    tbb.bit_level_apply(probe, _t(hits.copy()))
    assert not bool(probe.switch.hits.any())
    active, cnt, edges = _jax_activity(probe.frontier, count)
    assert cnt > 0 and edges > 0
    for row_limit, edge_limit in ((cnt, edges), (cnt - 1, edges), (cnt, edges - 1), (0, 0)):
        rng.bit_generator.state = state
        carry = _switched_carry(rng, n, w, count, row_limit, edge_limit)
        if pushed:
            carry.ctrl[3] = tbb.DIR_PUSH
            carry.switch.hits.copy_(_t(hits.copy()))
            plane = _t(_words(rng, (n, w)))  # never read
        else:
            plane = _t(hits.copy())
        before = plane.clone()
        tbb.bit_level_apply(carry, plane)  # a CPU tensor: the plain version
        assert not bool(carry.switch.hits.any()) and torch.equal(plane, before)
        np.testing.assert_array_equal(carry.frontier.numpy(), probe.frontier.numpy())
        push = cnt <= row_limit and edges <= edge_limit
        assert int(carry.ctrl[3]) == (tbb.DIR_PUSH if push else tbb.DIR_PULL)
        sw = carry.switch
        assert sw.state[tbb.SW_ACTIVE_ROWS] == cnt and sw.state[tbb.SW_ACTIVE_EDGES] == edges
        want = np.flatnonzero(active & (count.numpy() > 0))
        assert sw.capacity == max(0, min(row_limit, n))
        if push:
            listed = sw.listed().numpy()
            np.testing.assert_array_equal(np.sort(listed), want)
            deg = count.numpy()[listed].astype(np.int64)
            np.testing.assert_array_equal(sw.worklist[1, : len(listed)].numpy(),
                                          np.cumsum(deg) - deg)
            assert sw.state[tbb.SW_LISTED_EDGES] == edges
        else:
            assert len(sw.listed()) == min(len(want), sw.capacity)


def test_switched_apply_empty_frontier_and_init():
    """Sources: bit_level_init decides the first level from the sources
    as JAX's predicate does; an all-zero hit plane lists nothing and
    decides push (0 <= any limit), as JAX's predicate would."""
    rng = np.random.default_rng(8)
    n, w = 96, 2
    planes = _words(rng, (n, w))
    planes[rng.random(n) < 0.7] = 0
    count = torch.from_numpy(rng.integers(0, 4, size=n).astype(np.int32))
    counts0 = tbb.unpack_counts(_t(planes))
    _, cnt, edges = _jax_activity(_t(planes), count)
    for limit, direction in ((cnt + edges, tbb.DIR_PUSH), (cnt - 1, tbb.DIR_PULL)):
        carry = tbb.bit_level_init(_t(planes), counts0, tbb.PushSwitch.new(count, limit, limit, w))
        assert int(carry.ctrl[3]) == direction
        assert carry.switch.state[tbb.SW_ACTIVE_ROWS] == cnt
        assert carry.switch.state[tbb.SW_ACTIVE_EDGES] == edges
    carry = _switched_carry(rng, n, w, count, 5, 5)
    carry.visited.fill_(-1)
    tbb.bit_level_apply(carry, _t(planes))  # every hit already visited
    assert int(carry.ctrl[0]) == 0 and int(carry.ctrl[3]) == tbb.DIR_PUSH
    assert len(carry.switch.listed()) == 0
    assert carry.switch.state.tolist() == [0] * tbb.SWITCH_WORDS


def test_apply_plan_with_switch():
    """The switch keeps the vector variant's widths and moves every other
    width from the column variant (a warp a word column) to the rows
    variant (a lane a whole row)."""
    for w in (1, 2, 4, 8):
        assert tbb.apply_plan(w, True, True) == tbb.ApplyPlan("vector", w, True, True)
        assert tbb.plan_label(tbb.apply_plan(w, True, True)) == f"vector/W{w}/vec16/switch"
    for w in (3, 5, 9, 1024):
        assert tbb.apply_plan(w, True, True) == tbb.ApplyPlan("rows", 0, False, True)
        assert tbb.apply_plan(w, True) == tbb.ApplyPlan("column", 0, False)
    assert tbb.plan_label(tbb.apply_plan(3, False, True)) == "rows/Wn/vec4/switch"
