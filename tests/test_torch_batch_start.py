"""The batch start (``ops/bitbell.py`` ``batch_start``, kernel K4,
``csrc/batch_start.cu``) against the JAX package on the same seeded
queries: on CPU tensors it is its plain composition (pack, carry, switch
record), held against JAX's ``pack_queries`` / ``lowk_pack`` and
``bit_level_init``, with ``frontier_activity`` and the budget predicate for
the direction switch.  A NumPy emulation of the kernel's atomics (every
thread order a permutation) is held against the plain version, the one
allocation's layout is checked, and the engines that start batches with it
(``LowKEngine``, ``BitBellEngine``, ``StencilEngine``) are held against
the JAX engines.  Everything is bits and integers: every comparison is
exact."""

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
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    bitbell as jbb,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    engine as jengine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import lowk as jlowk
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    stencil as jstencil,
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
    bitbell,
    lowk,
    stencil,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import io

N = 400
KS = [1, 3, 4, 32, 64, 96]


def _queries(k, s, n, seed, case):
    """(K, S) queries: "mixed" has -1 padding, sources at and past n,
    duplicates within a group and across groups and a group with no valid
    source; "none" has no valid source; "dense" has many distinct rows."""
    rng = np.random.default_rng(seed)
    if case == "none":
        q = rng.integers(n, n + 50, size=(k, s)).astype(np.int32)
        q[:, ::2] = -1
        return q
    hi = n if case == "dense" else 40
    q = rng.integers(0, hi, size=(k, s)).astype(np.int32)
    if case == "mixed" and k and s > 3:
        q[:, -1] = -1
        q[:, -2] = q[:, 0]  # duplicate within the group
        q[0, 1] = n  # out of range
        q[-1, 2] = -7
        q[k // 2] = q[0]  # duplicate across groups
        if k > 2:
            q[1] = -1  # a group with no valid source
    return q


def _count(n, seed):
    """Out-degrees with zeros among them (active rows without edges)."""
    return np.random.default_rng(seed).integers(0, 5, size=n).astype(np.int32)


def _jax_reference(q, n, stride):
    """JAX's source plane as the port's words, its per-lane counts, and
    the frontier JAX's predicate reads (bits or byte flags)."""
    k, s = q.shape
    w = max(1, -(-k * stride // 32))
    if stride == 1:
        kpad = max(32, -(-k // 32) * 32)
        qp = np.concatenate([q, np.full((kpad - k, s), -1, np.int32)])
        words = np.asarray(jbb.pack_queries(n, jnp.asarray(qp)))
        counts = np.asarray(jbb.unpack_counts(jnp.asarray(words)))[: 32 * w]
        return words[:, :w].view(np.int32), counts, words
    flags = np.asarray(jlowk.lowk_pack(n, jnp.asarray(q)))
    plane = np.zeros((n, 4 * w), np.uint8)
    plane[:, :k] = flags
    counts = np.zeros(32 * w, np.int32)
    counts[: 8 * k : 8] = np.asarray(jlowk._lowk_counts(jnp.asarray(flags)))
    return plane.view(np.int32), counts, flags


def _check_against_jax(carry, q, n, stride, count=None, row_limit=0, edge_limit=0):
    k = q.shape[0]
    words, counts, frontier = _jax_reference(q, n, stride)
    init = jbb.bit_level_init(jnp.asarray(frontier), jnp.asarray(counts))
    np.testing.assert_array_equal(carry.frontier.numpy(), words)
    np.testing.assert_array_equal(carry.visited.numpy(), words)
    np.testing.assert_array_equal(carry.reached.numpy(), counts)
    np.testing.assert_array_equal(carry.reached.numpy(), np.asarray(init[4]))
    np.testing.assert_array_equal(carry.levels.numpy(), np.asarray(init[3]))
    np.testing.assert_array_equal(carry.f.numpy(), np.asarray(init[2]))
    assert not carry.counts.any() and carry.k == k
    assert int(carry.ctrl[0]) == int(np.asarray(init[6])) and int(carry.ctrl[1]) == int(init[5])
    assert int(carry.ctrl[2]) == 0
    if count is None:
        assert carry.switch is None and int(carry.ctrl[3]) == bitbell.DIR_PULL
        return
    active, cnt, edges = jengine.frontier_activity(jnp.asarray(frontier), jnp.asarray(count))
    active, cnt, edges = np.asarray(active), int(cnt), int(edges)
    push = cnt <= row_limit and edges <= edge_limit
    assert int(carry.ctrl[3]) == (bitbell.DIR_PUSH if push else bitbell.DIR_PULL)
    sw = carry.switch
    listable = np.flatnonzero(active & (count > 0))
    state = sw.state.tolist()
    assert state[bitbell.SW_ACTIVE_ROWS] == cnt and state[bitbell.SW_ACTIVE_EDGES] == edges
    assert state[bitbell.SW_LISTED] == min(listable.size, sw.capacity)
    assert state[bitbell.SW_LISTED_EDGES] == edges and state[4:] == [0, 0, 0, 0]
    assert not sw.hits.any()
    if listable.size <= sw.capacity:  # the list is whole
        rows = sw.worklist[0, : listable.size].numpy()
        assert sorted(rows.tolist()) == listable.tolist()
        deg = count[rows].astype(np.int64)
        np.testing.assert_array_equal(sw.worklist[1, : rows.size].numpy(), np.cumsum(deg) - deg)


@pytest.mark.parametrize("stride", [1, 8])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", ["mixed", "none"])
def test_batch_start_matches_jax(stride, k, case):
    """Both planes, f, levels, reached and ctrl against JAX's pack and
    bit_level_init, without a switch."""
    q = _queries(k, 9, N, seed=k * 3 + stride, case=case)
    carry = bitbell.batch_start(N, q, "cpu", stride)
    _check_against_jax(carry, q, N, stride)
    assert carry.frontier.shape == (N, max(1, -(-k * stride // 32)))


@pytest.mark.parametrize("stride", [1, 8])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("limit", ["whole", "cut", "zero"])
def test_batch_start_switch_matches_jax(stride, k, limit):
    """With the direction switch: the direction from JAX's frontier_activity
    and the budget predicate, the state words, and the worklist as a set
    with each row's out-degree when the list is whole; "cut" lists fewer
    rows than have out-edges (a source set larger than the list's
    capacity), "zero" has no room at all."""
    q = _queries(k, 12, N, seed=k + 11 * stride, case="dense" if limit == "cut" else "mixed")
    count = _count(N, k)
    row_limit = {"whole": N, "cut": 7, "zero": 0}[limit]
    edge_limit = 40 if limit == "whole" else 10**6
    carry = bitbell.batch_start(N, q, "cpu", stride,
                                switch=bitbell.SwitchLimits(torch.from_numpy(count), row_limit,
                                                            edge_limit))
    _check_against_jax(carry, q, N, stride, count, row_limit, edge_limit)
    if limit == "cut":
        assert int(carry.switch.state[bitbell.SW_ACTIVE_ROWS]) > carry.switch.capacity == 7


def test_batch_start_empty_batch():
    """No queries at all: no source, the direction of an empty frontier
    (push: 0 rows and 0 edges are within any limits)."""
    count = torch.from_numpy(_count(N, 1))
    for q in (np.zeros((0, 5), np.int32), np.zeros((3, 0), np.int32)):
        carry = bitbell.batch_start(N, q, "cpu", 8, switch=bitbell.SwitchLimits(count, 9, 9))
        assert not carry.frontier.any() and not carry.reached.any()
        assert carry.ctrl.tolist() == [0, 0, 0, bitbell.DIR_PUSH]
        assert carry.switch.state.tolist() == [0] * bitbell.SWITCH_WORDS


def test_batch_start_pads_rows_and_matches_pack_queries():
    """Plane rows past n (the mxu route's tile padding) stay zero, and the
    planes equal pack_queries' at both strides."""
    q = _queries(40, 6, N, seed=3, case="mixed")
    for stride in (1, 8):
        carry = bitbell.batch_start(N, q, "cpu", stride, rows=N + 60)
        plane, counts = bitbell.pack_queries(N, q, "cpu", stride)
        assert carry.frontier.shape[0] == N + 60 and not carry.frontier[N:].any()
        assert torch.equal(carry.frontier[:N], plane) and torch.equal(carry.reached, counts)


def _emulate_kernel(q, n, stride, rows, count, row_limit, edge_limit, order):
    """csrc/batch_start.cu in NumPy: the threads of the (q, s) grid in the
    given order, each atomic applied at once (a serial order of the
    atomics), then the last block's tail.  Returns (planes, reached,
    levels, ctrl, state, worklist)."""
    k, s = q.shape
    w = max(1, -(-k * stride // 32))
    lanes = 32 * w
    frontier = np.zeros((rows, w), np.uint32)
    visited = np.zeros((rows, w), np.uint32)
    reached = np.zeros(lanes, np.int64)
    claim = np.zeros(-(-n // 32), np.uint32)
    append, other = 0, 0
    cap = max(0, min(row_limit, rows)) if count is not None else 0
    worklist = np.full((2, cap), -5, np.int64)  # never cleared: poison
    for i in order:
        v = int(q.flat[i])
        if v < 0 or v >= n:
            continue
        bit = (i // s) * stride
        mask = np.uint32(1 << (bit & 31))
        old = frontier[v, bit >> 5]
        frontier[v, bit >> 5] |= mask
        visited[v, bit >> 5] |= mask
        if old & mask:
            continue
        reached[bit] += 1
        if count is None:
            continue
        row_bit = np.uint32(1 << (v & 31))
        if claim[v >> 5] & row_bit:
            continue
        claim[v >> 5] |= row_bit
        d = int(count[v])
        if d > 0:
            at = append
            append += (1 << 32) + d
            if at >> 32 < cap:
                worklist[:, at >> 32] = (v, at & 0xFFFFFFFF)
        else:
            other += 1
    levels = (reached > 0).astype(np.int32)
    state = np.zeros(bitbell.SWITCH_WORDS, np.int64)
    direction = bitbell.DIR_PULL
    if count is not None:
        listed, edges = append >> 32, append & 0xFFFFFFFF
        state[:4] = (min(listed, cap), edges, listed + other, edges)
        push = listed + other <= row_limit and edges <= edge_limit
        direction = bitbell.DIR_PUSH if push else bitbell.DIR_PULL
    ctrl = [int(levels.any()), 0, 0, direction]
    return (frontier.view(np.int32), visited.view(np.int32), reached, levels, ctrl, state,
            worklist)


@pytest.mark.parametrize("stride,k", [(1, 1), (1, 64), (8, 4), (8, 96)])
@pytest.mark.parametrize("row_limit", [N, 5])
def test_kernel_emulation_matches_plain(stride, k, row_limit):
    """In any order of its threads, the kernel's atomics give the plain
    batch start's planes, counters, control and state exactly, and a list
    of distinct rows, the plain list's (as a set) when whole, each offset
    the out-degrees appended before it."""
    q = _queries(k, 10, N, seed=k + row_limit, case="mixed")
    count = _count(N, k + 1)
    want = bitbell.batch_start(
        N, q, "cpu", stride, switch=bitbell.SwitchLimits(torch.from_numpy(count), row_limit, 60))
    for seed in range(4):
        order = np.random.default_rng(seed).permutation(q.size)
        fr, vi, reached, levels, ctrl, state, wl = _emulate_kernel(
            q, N, stride, N, count, row_limit, 60, order)
        np.testing.assert_array_equal(fr, want.frontier.numpy())
        np.testing.assert_array_equal(vi, want.visited.numpy())
        np.testing.assert_array_equal(reached, want.reached.numpy())
        np.testing.assert_array_equal(levels, want.levels.numpy())
        assert ctrl == want.ctrl.tolist()
        np.testing.assert_array_equal(state, want.switch.state.numpy())
        length = int(state[bitbell.SW_LISTED])
        rows = wl[0, :length]
        deg = count[rows].astype(np.int64)
        np.testing.assert_array_equal(wl[1, :length], np.cumsum(deg) - deg)
        assert len(set(rows.tolist())) == length
        if state[bitbell.SW_ACTIVE_ROWS] <= want.switch.capacity:
            assert sorted(rows.tolist()) == sorted(want.switch.worklist[0, :length].tolist())


@pytest.mark.parametrize("switch", [False, True])
@pytest.mark.parametrize("rows,w,n", [(5000, 1, 5000), (5123, 3, 5000), (0, 1, 0), (77, 24, 70)])
def test_batch_layout(switch, rows, w, n):
    """The one allocation: every field at a multiple of CARVE_ALIGN bytes,
    none overlapping, each as large as its shape, all but the worklist
    inside the memset's range."""
    cap = min(rows, 33)
    fields, zero_bytes, total = bitbell.batch_layout(rows, w, n, switch, cap)
    names = {"f", "levels", "reached", "counts", "ctrl", "visited", "frontier"}
    if switch:
        names |= {"state", "claim", "push_hits", "worklist"}
    assert set(fields) == names
    spans = sorted((f.offset, f.offset + f.nbytes, name) for name, f in fields.items())
    for (a0, a1, _), (b0, _, _) in zip(spans, spans[1:]):
        assert a1 <= b0
    for name, f in fields.items():
        assert f.offset % bitbell.CARVE_ALIGN == 0 and f.offset + f.nbytes <= total
        if name != "worklist":
            assert f.offset + f.nbytes <= zero_bytes
    assert fields["visited"].shape == fields["frontier"].shape == (rows, w)
    assert fields["f"].dtype == torch.int64 and fields["f"].shape == (32 * w,)
    if switch:
        assert fields["worklist"].shape == (2, cap) and fields["claim"].shape == (-(-n // 32),)
        assert fields["worklist"].offset >= zero_bytes
    else:
        assert zero_bytes == total


# -- the engines that start their batches with it -----------------------------


def _rmat():
    n, e = generators.rmat_edges(8, edge_factor=6, seed=13)
    return n, e


@pytest.fixture(scope="module")
def rmat_graphs():
    n, e = _rmat()
    g, jg = CSRGraph.from_edges(n, e), JCSRGraph.from_edges(n, e)
    return n, BellGraph.from_host(g, "cpu"), jbell_model.BellGraph.from_host(jg)


def _engine_queries(n, k, seed):
    q = generators.random_queries(n, k, max_group=5, seed=seed)
    if k > 2:
        q[1] = np.zeros(0, dtype=np.int32)  # an empty group
        q[2] = np.array([-1, n + 3], dtype=np.int32)  # nothing in range
    return io.pad_queries(q)


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("budget", [0, 300])
def test_lowk_engine_batches_match_jax(rmat_graphs, k, budget):
    n, bg, jb = rmat_graphs
    padded = _engine_queries(n, k, 5 * k + budget)
    want = jlowk.LowKEngine(jb, sparse_budget=budget).query_stats(padded)
    for plain in (False, True):
        got = lowk.LowKEngine(bg, sparse_budget=budget, plain=plain).query_stats(padded)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", [1, 32, 64, 96])
def test_bitbell_engine_batches_match_jax(rmat_graphs, k):
    n, bg, jb = rmat_graphs
    padded = _engine_queries(n, k, k)
    want = jbb.BitBellEngine(jb, sparse_budget=300).query_stats(padded)
    got = bitbell.BitBellEngine(bg, sparse_budget=300).query_stats(padded)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", [1, 3, 32, 64])
def test_stencil_engine_batches_match_jax(k):
    n, e = generators.road_edges(14, 14, seed=7, shortcut_frac=0.01)
    tsg = stencil.StencilGraph.from_host(CSRGraph.from_edges(n, e), "cpu")
    jsg = jstencil.StencilGraph.from_host(JCSRGraph.from_edges(n, e))
    padded = _engine_queries(n, k, 2 * k)
    want = jstencil.StencilEngine(jsg, level_chunk=4).query_stats(padded)
    got = stencil.StencilEngine(tsg, level_chunk=4).query_stats(padded)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
