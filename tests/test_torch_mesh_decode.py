"""The 2D mesh's one-launch gathers and M4's take form against the JAX
package, on the CPU (the port runs the kernels' plain versions here).

* H1's segmented form (``ops/cuda_halo.py`` ``halo_pair_or_segments``,
  ``ops/cuda_mesh.py`` ``wire_decode_segments``) against JAX's
  ``decode_words_sparse`` of the rebased, re-clamped concatenation that
  ``_sparse_row_gather`` builds, and against one ``halo_pair_or_plain``
  a segment: duplicate ids, a full-budget segment, and a segment whose
  sentinel would alias the next segment's first word.
* The sparse col legs through ``Mesh2DEngine`` on JAX's 8-device virtual
  CPU mesh at 2x2 with the ring tree and the sparse wire: the OR leg
  (synchronous) and the MAX/commit leg (the async drive, k = 4) give
  JAX's F, per-query stats and wire trace, each gather one segmented call.
* M4's take form (``forest_max_take``, and ``forest_max_hits`` over it)
  against JAX's ``_async_cand(forest_hits(..., max))`` on a one-level road
  tile and on a multi-level RMAT tile, at both horizons; its commit form
  (``forest_max_hits_commit``, a local wave) on the same tiles against
  that, sliced to each own row chunk, then ``neg_commit`` and the next
  send ``where(delta, merged, 0)``.

Every value compared is an integer: the tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
    generators as jgenerators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.csr import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    bell as jbell,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    bitbell as jbitbell,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    mesh as jmesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    partition2d as jp,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    DEFAULT_WIDTHS,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    cuda_halo,
    cuda_mesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    mesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    partition2d as pp,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

# ---- H1's segmented form ---------------------------------------------------

LSUB, W = 37, 3
TOTAL = LSUB * W


def _plane(rng, density):
    plane = rng.integers(1, 2**31 - 1, (LSUB, W)).astype(np.int32)
    plane[rng.random((LSUB, W)) >= density] = 0
    return plane


def _encoded(rng, densities, budget):
    """Each segment's plane encoded by JAX's sparse wire: (idx, words)."""
    out = []
    for d in densities:
        idx, words = jp.encode_words_sparse(jnp.asarray(_plane(rng, d)), budget)
        out.append((np.array(idx), np.array(words)))
    return out


def _jax_gather(pairs):
    """``_sparse_row_gather``'s decode of the segments' pairs: rebased to
    each segment's offset, the sentinels re-clamped, decoded once."""
    rows = len(pairs)
    g_idx = jnp.asarray(np.stack([i for i, _ in pairs]))
    g_words = jnp.asarray(np.stack([x for _, x in pairs]))
    offs = jnp.arange(rows, dtype=jnp.int32) * TOTAL
    glob = jnp.where(g_idx < TOTAL, g_idx + offs[:, None], rows * TOTAL)
    return np.asarray(jp.decode_words_sparse(glob.reshape(-1), g_words.reshape(-1),
                                             rows * TOTAL))


def _port_gather(pairs):
    plane = torch.zeros((len(pairs) * LSUB, W), dtype=torch.int32)
    cuda_mesh.wire_decode_segments(
        [(torch.from_numpy(i), torch.from_numpy(x), s * TOTAL) for s, (i, x) in enumerate(pairs)],
        plane, TOTAL)
    return plane


def _loop_gather(pairs):
    """One ``halo_pair_or_plain`` a segment, each into its own rows."""
    plane = torch.zeros((len(pairs) * TOTAL, 1), dtype=torch.int32)
    for s, (i, x) in enumerate(pairs):
        cuda_halo.halo_pair_or_plain(torch.from_numpy(i), torch.from_numpy(x).view(-1, 1),
                                     plane[s * TOTAL : (s + 1) * TOTAL])
    return plane


@pytest.mark.parametrize("densities,budget", [
    ((0.1, 0.0, 0.3), 40),  # under the budget: every segment ends in sentinels
    ((1.0, 0.2), TOTAL),  # a full-budget segment: no sentinel at all
    ((0.05,) * 16, 16),  # sixteen segments, one launch's most
    ((0.05,) * 17, 16),  # seventeen: two launches
], ids=["sentinels", "full", "sixteen", "seventeen"])
def test_segmented_decode_matches_jax_row_gather(densities, budget):
    pairs = _encoded(np.random.default_rng(len(densities) + budget), densities, budget)
    if budget == TOTAL:
        assert (pairs[0][0] < TOTAL).all()  # the full segment
    want = _jax_gather(pairs)
    np.testing.assert_array_equal(_port_gather(pairs).numpy().reshape(-1), want)
    np.testing.assert_array_equal(_loop_gather(pairs).numpy().reshape(-1), want)


def test_sentinel_never_aliases_the_next_segment():
    """A pair at a segment's sentinel index carrying a nonzero word: rebased
    without the re-clamp it would land on the next segment's word 0; it
    drops, as JAX's re-clamp drops it."""
    rng = np.random.default_rng(5)
    pairs = _encoded(rng, (0.2, 0.2), 30)
    idx0, words0 = pairs[0]
    at = int(np.argmax(idx0 >= TOTAL))
    assert idx0[at] == TOTAL
    words0 = words0.copy()
    words0[at] = 0x5A5A5A5
    pairs[0] = (idx0, words0)
    want = _jax_gather(pairs)
    assert want[TOTAL] == pairs[1][1][0] * (pairs[1][0][0] == 0)  # nothing aliased
    np.testing.assert_array_equal(_port_gather(pairs).numpy().reshape(-1), want)
    np.testing.assert_array_equal(_loop_gather(pairs).numpy().reshape(-1), want)


@pytest.mark.parametrize("w", [1, 2, 5])
def test_segmented_pairs_with_duplicates_match_a_loop(w):
    """Duplicate ids, within a segment and across overlapping segments,
    OR together; ids outside a segment's rows (below ``lo``, at or past its
    rows) drop; one call equals a ``halo_pair_or_plain`` a segment."""
    rng = np.random.default_rng(w)
    rows = 50
    plane0 = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (rows, w)).astype(np.int32))
    specs = [(0, 30, 0), (20, 30, 5), (40, 10, -3)]  # (base, rows, lo): overlapping rows
    segments = []
    for base, srows, lo in specs:
        ids = rng.integers(lo - 4, lo + srows + 4, 60).astype(np.int32)
        words = rng.integers(-(2**31), 2**31 - 1, (60, w)).astype(np.int32)
        segments.append(cuda_halo.Segment(torch.from_numpy(ids), torch.from_numpy(words),
                                          base, srows, lo))
    assert any(len(np.unique(s.ids.numpy())) < len(s.ids) for s in segments)
    got = plane0.clone()
    cuda_halo.halo_pair_or_segments(segments, got)
    want = plane0.clone()
    for s in segments:
        cuda_halo.halo_pair_or_plain(s.ids, s.words, want[s.base : s.base + s.rows], s.lo)
    assert torch.equal(got, want)
    # Gated off: nothing lands.
    held = plane0.clone()
    cuda_halo.halo_pair_or_segments(segments, held, torch.tensor([0, 3, 0, 0], dtype=torch.int32))
    assert torch.equal(held, plane0)


def test_segmented_form_refuses_what_the_kernel_does_not_take():
    ids = torch.zeros(4, dtype=torch.int32)
    words = torch.zeros((4, 2), dtype=torch.int32)
    plane = torch.zeros((10, 2), dtype=torch.int32)
    seg = cuda_halo.Segment(ids, words, 0, 10)
    with pytest.raises(ValueError, match="1 to 16 segments"):
        cuda_halo.halo_pair_or_segments([seg] * 17, plane)
    with pytest.raises(ValueError, match="outside the plane"):
        cuda_halo.halo_pair_or_segments([seg._replace(base=5)], plane)
    with pytest.raises(ValueError, match="words must be"):
        cuda_halo.halo_pair_or_segments([seg._replace(words=words[:, :1].contiguous())], plane)


# ---- the sparse col legs through the engine ----------------------------------


@pytest.fixture(scope="module")
def road():
    """A 16 x 16 road grid and its query groups, the port's and JAX's graph."""
    n, edges = jgenerators.road_edges(16, 16, seed=5)
    rng = np.random.default_rng(11)
    queries = rng.integers(0, n, size=(6, 2)).astype(np.int32)
    return CSRGraph.from_edges(n, edges), JCSRGraph.from_edges(n, edges), queries


@pytest.mark.parametrize("kw", [dict(merge_tree="ring"), dict(async_levels=4)],
                         ids=["or-leg", "max-commit-leg"])
def test_sparse_col_legs_match_jax(road, monkeypatch, kw):
    """2x2, the sparse wire at its default budget: F, the per-query stats
    and (synchronous) the wire trace equal JAX's; the col leg went sparse
    (committed by MAX under the async drive), and each gather — a col
    block's two row segments, a destination's two peers — was one call of
    H1's segmented form."""
    g, jg, queries = road
    calls, legs = [], []
    real_seg, real_leg = cuda_mesh.halo_pair_or_segments, pp.Mesh2DEngine._col_sparse

    def seg(segments, plane, *a, **k):
        calls.append(len(segments))
        return real_seg(segments, plane, *a, **k)

    def leg(self, run, enc, w, commit=None):
        legs.append(commit is not None)
        return real_leg(self, run, enc, w, commit)

    monkeypatch.setattr(cuda_mesh, "halo_pair_or_segments", seg)
    monkeypatch.setattr(pp.Mesh2DEngine, "_col_sparse", leg)
    je = jp.Mesh2DEngine(jmesh.make_mesh2d(2, 2, devices=jax.devices()[:4]), jg, **kw)
    pe = pp.Mesh2DEngine(mesh.make_mesh2d(2, 2, devices=["cpu"] * 4), g, **kw)
    got, want = pe.query_stats(queries), je.query_stats(queries)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(pe.f_values(queries).numpy(), np.asarray(je.f_values(queries)))
    assert legs and all(legs) == ("async_levels" in kw), legs
    assert calls and set(calls) == {2}, calls
    if "async_levels" not in kw:
        trace = pe.wire_trace(queries)
        assert trace == je.wire_trace(queries)
        assert trace["sparse_levels"] > 0


# ---- M4's take form ----------------------------------------------------------


def _tile(n, edges, widths, i=0, j=1):
    g, jg = CSRGraph.from_edges(n, edges), JCSRGraph.from_edges(n, edges)
    part = pp.Partition2D(g, 2, 2, widths=widths, devices=[["cpu"] * 2] * 2)
    jpart = jp.Partition2D(jg, 2, 2, device=False)
    jtile = jp.BellGraph.from_host(jpart._tile_csr(jg, i, j), widths=part.widths, dedup=False,
                                   min_bucket_rows=0, keep_sparse=False)
    return part, part.tiles[i][j], jtile


TILES = {
    # road-24 x 24 on the engine's own ladder: every tile's forest is one level.
    "road one-level": (lambda: jgenerators.road_edges(24, 24, seed=2), DEFAULT_WIDTHS, 0, 0),
    # RMAT-10 on a ladder up to 4 slots: hubs fold through further levels.
    "rmat multi-level": (lambda: jgenerators.rmat_edges(10, 8, seed=3), (1, 2, 4), 0, 1),
}


@pytest.mark.parametrize("max_levels", [None, 2])
@pytest.mark.parametrize("name", sorted(TILES))
def test_forest_max_take_matches_jax(name, max_levels):
    """The whole-forest form (the levels but the last into scratch, then the
    last with the take in one call) and the take alone against JAX's
    ``_async_cand(forest_hits(..., max))``; the multi-level tile exercises
    the copied earlier-level rows, and both the sentinel rows."""
    make, widths, i, j = TILES[name]
    n, edges = make()
    part, tile, jtile = _tile(n, edges, widths, i, j)
    levels = len(tile.level_cols)
    assert (levels == 1) == name.startswith("road"), tile
    last_off = sum(tile.level_sizes[:-1])
    slot = tile.final_slot.numpy()
    assert (slot == tile.total_rows).any()  # sentinel rows
    if levels > 1:
        assert (slot < last_off).any()  # rows finished at an earlier level
    rng = np.random.default_rng(levels)
    lt = part.lt
    neg = np.where(rng.random((lt, 32)) < 0.3, jbitbell.NEG_BASE - rng.integers(0, 5, (lt, 32)),
                   0).astype(np.int32)
    want = np.asarray(jp._async_cand(
        jbell.forest_hits(jnp.asarray(neg), jtile, lambda x: jnp.max(x, axis=1)), max_levels))
    floor = cuda_mesh.cand_floor(max_levels)
    go = cuda_mesh.go_control("cpu")
    hits = torch.zeros((lt, 32), dtype=torch.int32)
    cuda_mesh.forest_max_hits(torch.from_numpy(neg), tile, hits, floor, go)
    np.testing.assert_array_equal(hits.numpy(), want)
    # The take alone over the earlier levels' rows, as the JAX forest gives them.
    tables = cuda_mesh.level_tables(tile, "cpu")
    scratch = torch.zeros((tile.total_rows + 1, 32), dtype=torch.int32)
    prev, prev_rows, off = torch.from_numpy(neg), lt, 0
    for li in range(levels - 1):
        size = tile.level_sizes[li]
        cuda_mesh.forest_max_plain(prev, prev_rows, tile.level_cols[li], tables.pieces[li],
                                   scratch[off : off + size], floor if li == 0 else None)
        prev, prev_rows, off = scratch[off : off + size], size, off + size
    taken = torch.full((lt, 32), -7, dtype=torch.int32)
    cuda_mesh.forest_max_take(prev, prev_rows, tile.level_cols[-1], tables, levels - 1, scratch,
                              off, tile.final_slot, taken, go,
                              floor if levels == 1 else None)
    np.testing.assert_array_equal(taken.numpy(), want)
    # Gated off (the level may not run): the hits stay as they were.
    held = torch.full((lt, 32), -7, dtype=torch.int32)
    cuda_mesh.forest_max_take(prev, prev_rows, tile.level_cols[-1], tables, levels - 1, scratch,
                              off, tile.final_slot, held,
                              torch.tensor([0, 1, 0, 0], dtype=torch.int32))
    assert bool((held == -7).all())


@pytest.mark.parametrize("max_levels", [None, 2])
@pytest.mark.parametrize("name", sorted(TILES))
def test_forest_max_commit_matches_jax(name, max_levels):
    """M4's commit form over a whole forest (the multi-level tile's earlier
    levels into scratch, the last level's own rows committed), every own
    row chunk of the tile in turn on one neg plane as the local waves
    commit: neg, delta, the changed mask (ORed), the send and the flag."""
    make, widths, i, j = TILES[name]
    n, edges = make()
    part, tile, jtile = _tile(n, edges, widths, i, j)
    lt, lsub = part.lt, part.lsub
    rng = np.random.default_rng(len(tile.level_cols) + 20)
    block = np.where(rng.random((lt, 32)) < 0.3,
                     jbitbell.NEG_BASE - rng.integers(0, 5, (lt, 32)), 0).astype(np.int32)
    cand = np.asarray(jp._async_cand(
        jbell.forest_hits(jnp.asarray(block), jtile, lambda x: jnp.max(x, axis=1)), max_levels))
    neg = np.where(rng.random((lsub, 32)) < 0.5,
                   jbitbell.NEG_BASE - rng.integers(0, 6, (lsub, 32)), 0).astype(np.int32)
    changed = np.zeros((lsub, 32), dtype=bool)
    c = cuda_mesh.Commit(torch.from_numpy(neg.copy()), torch.zeros((lsub, 32), dtype=torch.bool),
                         torch.from_numpy(changed.copy()), torch.zeros(1, dtype=torch.int32),
                         torch.zeros((lsub, 32), dtype=torch.int32))
    for chunk in range(lt // lsub):
        merged, delta = jbitbell.neg_commit(jnp.asarray(neg),
                                            jnp.asarray(cand[chunk * lsub : (chunk + 1) * lsub]))
        c = c._replace(tag=chunk + 2)
        cuda_mesh.forest_max_hits_commit(torch.from_numpy(block), tile, chunk * lsub, c,
                                         cuda_mesh.cand_floor(max_levels),
                                         cuda_mesh.go_control("cpu"))
        neg, changed = np.asarray(merged), changed | np.asarray(delta)
        np.testing.assert_array_equal(c.neg.numpy(), neg)
        np.testing.assert_array_equal(c.delta.numpy(), np.asarray(delta))
        np.testing.assert_array_equal(c.acc.numpy(), changed)
        np.testing.assert_array_equal(c.send.numpy(), np.asarray(jnp.where(delta, merged, 0)))
        if np.asarray(delta).any():
            assert int(c.flag) == chunk + 2
