"""The port's ``vmap`` route against the JAX package on the same seeded
inputs: the device CSR's arrays, one level of the CSR pull
(``frontier_expand``), the plain version of kernel K9 on a row carry and
on a query-minor one, and the generic engine over the CSR in its drive
modes.  Everything is integers, so every comparison is exact."""

import functools

import jax
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
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    packed as jpacked,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    csr,
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


# ---- K9's work layout and its planes path ---------------------------------


def _hub_edges(leaves=600, tail=6):
    """A star whose hub row is cut into several virtual rows, a path off
    one leaf, a row of exactly SHORT_ROW_SLOTS slots, and isolated
    vertices past them."""
    hub = [[0, 1 + i] for i in range(leaves)]
    path = [[leaves + i, leaves + i + 1] for i in range(tail)]
    mid = leaves + tail + 1
    fan = [[mid, 1 + i] for i in range(csr.SHORT_ROW_SLOTS)]
    return mid + 5, np.asarray(hub + path + fan, dtype=np.int32)


def _layout_edges(kind):
    if kind == "hub":
        return _hub_edges()
    if kind == "empty_rows":
        n, e = _edges("rmat")
        return n + 30, e + 15  # 15 empty rows in front, 30 behind
    return _edges(kind)


@pytest.mark.parametrize("kind", ["rmat", "road", "no_edges", "hub", "empty_rows"])
def test_virtual_rows_cover_every_slot_once(kind):
    n, e = _layout_edges(kind)
    host = CSRGraph.from_edges(n, e)
    g = host.to_device("cpu")
    vrows, num_short = g.vrows.numpy(), g.num_short
    offs, deg = host.row_offsets, host.degrees
    src = g.edge_src.numpy()
    assert vrows.dtype == np.int32 and vrows.shape[1] == 3
    start, end, owner = vrows.T.astype(np.int64)
    assert (start < end).all()
    # Short rows: the nonempty rows of at most SHORT_ROW_SLOTS slots,
    # whole and in vertex order.
    short = np.flatnonzero((deg > 0) & (deg <= csr.SHORT_ROW_SLOTS))
    assert num_short == short.size
    np.testing.assert_array_equal(owner[:num_short], short)
    np.testing.assert_array_equal(start[:num_short], offs[short])
    np.testing.assert_array_equal(end[:num_short], offs[short + 1])
    # Long pieces: in slot order, at most VROW_SLOTS each, all but a row's
    # last exactly VROW_SLOTS.
    ls, le, lo = start[num_short:], end[num_short:], owner[num_short:]
    assert (np.diff(ls) > 0).all() and (le - ls <= csr.VROW_SLOTS).all()
    assert (deg[lo] > csr.SHORT_ROW_SLOTS).all()
    last = np.append(lo[1:] != lo[:-1], True)[: lo.size]
    assert (le[~last] - ls[~last] == csr.VROW_SLOTS).all()
    # Together: every slot exactly once, each with its owning row.
    order = np.argsort(start, kind="stable")
    if order.size:
        assert start[order][0] == 0 and end[order][-1] == host.num_directed_edges
        np.testing.assert_array_equal(start[order][1:], end[order][:-1])
    else:
        assert host.num_directed_edges == 0
    cover = np.zeros(host.num_directed_edges, np.int64)
    for a, b, v in vrows.astype(np.int64):
        cover[a:b] += 1
        assert (src[a:b] == v).all()
    assert (cover == 1).all()
    pieces = np.where(deg > csr.SHORT_ROW_SLOTS, -(-deg // csr.VROW_SLOTS), 0)
    assert vrows.shape[0] == num_short + int(pieces.sum())


@functools.lru_cache(maxsize=None)
def _jax_rows(jg):
    return jax.jit(jax.vmap(lambda d, lv: jbfs.frontier_expand(d, lv, jg)))


@functools.lru_cache(maxsize=None)
def _jax_minor(jg):
    return jax.jit(lambda d, lv: jpacked._packed_expand(d, lv, jg, 1))


def _jax_step(layout, dist, level, active, jg):
    """One level of JAX's expansion on the port's (K, n) distances: the
    vmapped frontier_expand for rows, _packed_expand for the minor view."""
    if layout == "rows":
        new = np.asarray(_jax_rows(jg)(jnp.asarray(dist), jnp.asarray(level)))
    else:
        new = np.asarray(_jax_minor(jg)(jnp.asarray(dist.T), jnp.asarray(level))).T
    new = new & active[:, None]
    return np.where(new, (level + 1)[:, None], dist), new.any(axis=1)


def _planes_agree(carry):
    """The carried planes are the pack of the carry: frontier = dist ==
    level for the running queries, visited = dist != -1, hits zero, the
    mask, and the union map of the frontier."""
    planes = carry.planes
    want = cuda_csr.CsrPlanes(*(torch.zeros_like(t) for t in (
        planes.frontier, planes.visited, planes.hits, planes.aux, planes.union)))
    cuda_csr.csr_pack_plain(carry, want)
    for name in ("visited", "hits", "aux"):
        assert torch.equal(getattr(planes, name), getattr(want, name)), name
    # A query that stopped keeps its last labels in the frontier (masked
    # out of every later walk); the running ones' bits are the pack's.
    w = planes.frontier.shape[1]
    assert torch.equal(planes.frontier & planes.aux[:w], want.frontier)
    assert torch.equal(planes.union, cuda_csr.union_map_plain(planes.frontier))


@pytest.mark.parametrize("layout", ["rows", "minor"])
@pytest.mark.parametrize("kind,k", [("rmat", 9), ("road", 40), ("hub", 5), ("hub", 70)])
def test_csr_planes_path_matches_jax_level_by_level(kind, k, layout):
    """K9's planes path (pack when stale, walk, apply: what csr_pull runs
    on a CPU carry) against JAX's expansion, a level at a time over a
    whole BFS cut into chunks of 2 levels (each chunk's arm makes the
    planes stale)."""
    n, e = _layout_edges(kind)
    g = CSRGraph.from_edges(n, e).to_device("cpu")
    jg = JCSRGraph.from_edges(n, e).to_device()
    q = _queries(n, k, 21 + k)
    if kind == "hub":
        q[0, :2] = [n - 6, -1]  # the fan's hub: it reaches the star's last leaves
    carry = (bfs.distance_carry_init(n, q) if layout == "rows"
             else packed.packed_carry_init(g, q))
    levels = 0
    while True:
        bfs.arm_chunk(carry, 2, None)
        if not int(carry.ctrl[0]):
            break
        for _ in range(2):
            dist = carry.dist.numpy().copy()
            level, updated = carry.level.numpy().copy(), carry.updated.numpy().copy()
            active = bfs.level_active(carry).numpy()
            want, found = _jax_step(layout, dist, level, active, jg)
            cuda_csr.csr_pull(g, carry)
            levels += 1
            assert isinstance(carry.planes, cuda_csr.CsrPlanes) and carry.planes.valid
            np.testing.assert_array_equal(carry.dist.numpy(), want)
            np.testing.assert_array_equal(carry.level.numpy(), level + active)
            np.testing.assert_array_equal(carry.updated.numpy(), np.where(active, found, updated))
            _planes_agree(carry)
    assert levels > 3
    assert not int(bfs.level_active(carry).any())


def test_map_shift_fits_the_map_beside_the_mask():
    assert cuda_csr.map_shift(1 << 20, 2) == 1
    assert cuda_csr.map_shift(1000, 3) == 0
    assert cuda_csr.map_shift(1 << 10, 2048) == 0

    def fits(n, w, shift):
        smem = 4 * (w + -(-(-(-n // 32)) >> shift))
        return cuda_csr.WALK_BLOCKS_PER_SM * (smem + cuda_csr.BLOCK_RESERVED_BYTES) <= (
            cuda_csr.SM_SMEM_BYTES)

    for n in (1, 5000, 1 << 20, 3 << 20, 1 << 24, 1 << 30):
        for w in (1, 2, 8, 2048):
            shift = cuda_csr.map_shift(n, w)
            if shift is None:
                assert not fits(n, w, cuda_csr.MAX_MAP_SHIFT)
                continue
            assert fits(n, w, shift) and (shift == 0 or not fits(n, w, shift - 1))


def _fold_bits(x, shift):
    """csrc/csr_pull.cu fold_bits on a uint32 array."""
    x = x.astype(np.uint32)
    for _ in range(shift):
        x = (x | (x >> 1)) & np.uint32(0x55555555)
        x = (x | (x >> 1)) & np.uint32(0x33333333)
        x = (x | (x >> 2)) & np.uint32(0x0F0F0F0F)
        x = (x | (x >> 4)) & np.uint32(0x00FF00FF)
        x = (x | (x >> 8)) & np.uint32(0x0000FFFF)
    return x


def _shared_map(umap, shift):
    """The walk's shared map as csrc/csr_pull.cu folds the device map."""
    words = umap.size
    folded = np.zeros(-(-words >> shift), np.uint32)
    per, bits = 1 << shift, 32 >> shift
    for i in range(folded.size):
        for j in range(per):
            g = (i << shift) + j
            if g < words:
                folded[i] |= _fold_bits(umap[g : g + 1], shift)[0] << np.uint32(j * bits)
    return folded


def _emulate_walk(g, planes, shift, seed):
    """csrc/csr_pull.cu's walk in NumPy: short rows a thread each (4 slots
    a step, stop once covered), long pieces a warp to 8 of them, the
    chunks in a shuffled order (a piece's owner tested when the chunk
    starts and again when the piece does, the hits so far dropped from
    the need, 32 slots between coverage checks, an OR into the hit
    words); the map read at its folded resolution."""
    f = planes.frontier.numpy().view(np.uint32)
    vis = planes.visited.numpy().view(np.uint32)
    w = f.shape[1]
    mask = planes.aux.numpy().view(np.uint32)[:w]
    umap = planes.union.numpy().view(np.uint32)
    smap = _shared_map(umap, shift)
    cols = g.col_indices.numpy()
    hits = np.zeros_like(f)

    def in_map(c):
        return (smap[c >> (shift + 5)] >> np.uint32((c >> shift) & 31)) & 1

    vrows = g.vrows.numpy()
    for a, b, v in vrows[: g.num_short]:
        need = ~vis[v] & mask
        if not need.any():
            continue
        acc = np.zeros(w, np.uint32)
        for s in range(a, b, 4):
            for c in cols[s : min(s + 4, b)]:
                if in_map(c):
                    acc |= f[c]
            if ((acc & need) == need).all():
                break
        hits[v] = acc & need
    long_rows = vrows[g.num_short :]
    chunks = [long_rows[i : i + 8] for i in range(0, len(long_rows), 8)]
    for i in np.random.default_rng(seed).permutation(len(chunks)):
        live = [(~vis[v] & mask & ~hits[v]).any() for _, _, v in chunks[i]]
        for (a, b, v), ok in zip(chunks[i], live):
            need = ~vis[v] & mask & ~hits[v]
            if not (ok and need.any()):
                continue
            acc = np.zeros(w, np.uint32)
            hit = np.array([bool(in_map(c)) for c in cols[a:b]], bool)
            for s in range(a, b, 32):  # a coverage check after a round that read
                read = hit[s - a : s - a + 32]
                for c in cols[s : min(s + 32, b)][read]:
                    acc |= f[c]
                if s + 32 < b and read.any() and ((acc & need) == need).all():
                    break
            hits[v] |= acc & need
    return hits


@pytest.mark.parametrize("shift", [0, 1, 3, 5])
@pytest.mark.parametrize("kind,k", [("hub", 3), ("hub", 70), ("rmat", 40)])
def test_walk_emulation_matches_plain_walk(kind, k, shift):
    """The walk's schedule (early stops, pieces in any order, a folded
    map) gives the plain walk's hit words on every level of a BFS."""
    n, e = _layout_edges(kind)
    g = CSRGraph.from_edges(n, e).to_device("cpu")
    q = _queries(n, k, 3 + k)
    carry = bfs.distance_carry_init(n, q)
    bfs.arm_chunk(carry, None, None)
    for level in range(6):
        planes = cuda_csr.csr_planes(g, carry)
        if not planes.valid:
            cuda_csr.csr_pack_plain(carry, planes)
        got = _emulate_walk(g, planes, shift, level)
        cuda_csr.csr_walk_plain(g, planes)
        np.testing.assert_array_equal(got, planes.hits.numpy().view(np.uint32))
        cuda_csr.csr_apply_plain(carry, planes)
        planes.valid = True
    umap = planes.union.numpy().view(np.uint32)
    smap = _shared_map(umap, shift)
    for v in range(n):  # the folded bit covers its 2^shift vertices' bits
        want = any((umap[u >> 5] >> (u & 31)) & 1
                   for u in range(v >> shift << shift, min(n, (v >> shift) + 1 << shift)))
        assert bool((smap[v >> (shift + 5)] >> ((v >> shift) & 31)) & 1) == want
