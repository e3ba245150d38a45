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
