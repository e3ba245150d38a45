"""The port's 2D adjacency mesh (parallel/partition2d.py) against the JAX
package's on the 8-device virtual CPU mesh, the JAX engine on
``jax.devices()[:R*C]``, the port on a logical CPU mesh of the same shape.

The workload is JAX's own (tests/test_partition2d.py): ``gnm_edges(73,
210, seed=3)``, n indivisible by every extent, an out-of-range source and
an all-invalid row.  Every value compared is an integer, so the tolerance
is zero: F, the per-query and per-level stats, the wire trace (levels,
encodings, bytes), the collective-bytes and collective-rounds counters
and the mxu tile counters must equal the JAX engine's.  Also the plain
helpers, the tiles' CSRs, the kernels' plain versions against the JAX
expressions they replace, resharding and the fail-loud compositions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
    generators as jgenerators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.bell import (
    BellGraph as JBellGraph,
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
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.runtime import (
    supervisor as jsup,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    timing as jtiming,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    BellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bitbell,
    cuda_mesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops.cuda_bell import (
    SegmentTables,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    collectives,
    mesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    partition2d as pp,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
    supervisor,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    timing,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def workload():
    """JAX's 2D workload: (port graph, JAX graph, queries, oracle
    (levels, reached, F) of JAX's single-device BitBellEngine)."""
    n, edges = jgenerators.gnm_edges(73, 210, seed=3)
    jg = JCSRGraph.from_edges(n, edges)
    g = CSRGraph.from_edges(n, edges)
    rng = np.random.default_rng(7)
    queries = rng.integers(0, n, size=(10, 3)).astype(np.int32)
    queries[3, 1] = -1
    queries[7] = -1
    oracle = jbitbell.BitBellEngine(JBellGraph.from_host(jg))
    stats = tuple(np.asarray(x) for x in oracle.query_stats(queries))
    return g, jg, queries, stats


def _meshes(rows, cols):
    return (jmesh.make_mesh2d(rows, cols, devices=jax.devices()[: rows * cols]),
            mesh.make_mesh2d(rows, cols, devices=["cpu"] * (rows * cols)))


def _reset():
    for mod in (timing, jtiming):
        mod.reset_collective_bytes()
        mod.reset_collective_rounds()
        mod.reset_mxu_tiles()


def _counters(mod):
    return mod.collective_bytes(), mod.collective_rounds(), tuple(mod.mxu_tile_counts())


def _assert_stats(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- the plain helpers ---------------------------------------------------------

HELPER_CASES = [
    ("select_merge_tree", (1,)), ("select_merge_tree", (4,)), ("select_merge_tree", (3,)),
    ("select_merge_tree", (2, "oneshot")), ("select_merge_tree", (4, "pipelined")),
    ("select_merge_tree", (1, "pipelined")), ("select_merge_tree", (3, "halving")),
    ("select_merge_tree", (4, "none")), ("select_merge_tree", (4, "bogus")),
    ("select_merge_tree", (6, " RING ")),
    ("level_collective_bytes", (2, 4, 10, 1, "halving")),
    ("level_collective_bytes", (2, 4, 10, 1, "oneshot")),
    ("level_collective_bytes", (1, 8, 10, 1, "ring")),
    ("level_collective_bytes", (2, 2, 19, 1, "pipelined")),
    ("level_collective_bytes", (1, 1, 73, 1, "none")),
    ("level_collective_bytes", (2, 4, 10, 3, "halving", 1)),
    ("resolve_wire_budget", (None, 64, 2)), ("resolve_wire_budget", ("auto", 64, 2)),
    ("resolve_wire_budget", ("", 64, 2)), ("resolve_wire_budget", ("off", 64, 2)),
    ("resolve_wire_budget", ("0", 64, 2)), ("resolve_wire_budget", (37, 64, 2)),
    ("resolve_wire_budget", (" 37 ", 64, 2)), ("resolve_wire_budget", ("bogus", 64, 2)),
    ("resolve_wire_budget", (None, 1, 1)),
    ("edge_balanced_row_splits", (4,)), ("edge_balanced_row_splits", (7,)),
    ("edge_balanced_row_splits", (1,)), ("edge_balanced_row_splits", (100,)),
]


def _call(fn, args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("name,args", HELPER_CASES)
def test_plain_helpers_match_jax(workload, name, args):
    g, jg, _, _ = workload
    if name == "edge_balanced_row_splits":
        args = (g.row_offsets,) + args
    assert _call(getattr(pp, name), args) == _call(getattr(jp, name), args)


def test_wire_pair_bytes_and_trees_match_jax():
    assert pp.WIRE_PAIR_BYTES == jp.WIRE_PAIR_BYTES == 8
    assert pp.MERGE_TREES == jp.MERGE_TREES


@pytest.mark.parametrize("density", [0.0, 0.05, 1 / 8, 0.25, 0.5, 1.0])
def test_sparse_encoding_matches_jax(density):
    """encode/decode over a density sweep: the active count equals JAX's,
    the pairs equal JAX's pairs, and the round trip is exact whenever the
    nonzero words fit the budget and lossy one below it."""
    rng = np.random.default_rng(int(density * 100) + 11)
    rows, words = 24, 3
    mask = rng.random((rows, words)) < density
    vals = rng.integers(1, 1 << 32, size=(rows, words), dtype=np.uint32)
    plane = np.where(mask, vals, np.uint32(0))
    tplane = torch.from_numpy(plane.view(np.int32).copy())
    active = int((plane != 0).sum())
    assert int(pp.active_word_count(tplane)) == int(jp.active_word_count(jnp.asarray(plane)))
    for budget in sorted({max(1, active), active + 3, max(1, active - 1)}):
        idx, enc = pp.encode_words_sparse(tplane, budget)
        jidx, jenc = jp.encode_words_sparse(jnp.asarray(plane), budget)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(enc.numpy().view(np.uint32), np.asarray(jenc))
        out = pp.decode_words_sparse(idx, enc, rows * words).numpy().view(np.uint32)
        want = np.asarray(jp.decode_words_sparse(jidx, jenc, rows * words))
        np.testing.assert_array_equal(out, want)
        if budget >= active:
            np.testing.assert_array_equal(out.reshape(rows, words), plane)
        else:
            assert (out.reshape(rows, words) != plane).any()


@pytest.mark.parametrize("rows,cols", [(2, 4), (4, 2), (2, 3)])
def test_tile_csrs_match_jax(workload, rows, cols):
    """Every tile's CSR is byte-equal to JAX's ``_tile_csr``, and the
    width ladder is JAX's."""
    g, jg, _, _ = workload
    part = pp.Partition2D(g, rows, cols, devices=False)
    jpart = jp.Partition2D(jg, rows, cols, device=False)
    for name in ("lsub", "n_pad", "lr", "lc", "lt"):
        assert getattr(part, name) == getattr(jpart, name)
    for i in range(rows):
        for j in range(cols):
            a, b = part._tile_csr(g, i, j), jpart._tile_csr(jg, i, j)
            assert a.n == b.n
            assert np.asarray(a.row_offsets).tobytes() == np.asarray(b.row_offsets).tobytes()
            assert np.asarray(a.col_indices).tobytes() == np.asarray(b.col_indices).tobytes()
            assert part.tiles[i][j].level_sizes == tuple(
                int(x) for x in np.asarray(jp.BellGraph.from_host(
                    b, widths=part.widths, dedup=False, min_bucket_rows=0,
                    keep_sparse=False, device=False).level_sizes))


def test_mesh_tile_arrays_match_jax(workload, monkeypatch):
    monkeypatch.setenv("MSBFS_MXU_TILE", "16")
    g, jg, _, _ = workload
    arrays, ntr, nt = pp.mesh_tile_arrays(pp.Partition2D(g, 2, 2), g)
    jarrays, jntr, jnt = jp.mesh_tile_arrays(jp.Partition2D(jg, 2, 2, device=False), jg)
    assert (ntr, nt) == (jntr, jnt)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], jarrays[k])
    with pytest.raises(ValueError, match="MSBFS_MXU_MAX_TILES"):
        pp.mesh_tile_arrays(pp.Partition2D(g, 2, 2), g, max_tiles=1)


# ---- the kernels' plain versions against the JAX expressions ------------------

@pytest.mark.parametrize("op,chunks", [("or", 1), ("or", 3), ("max", 2), ("max", 4)])
def test_chunk_merge_matches_jax(op, chunks):
    rng = np.random.default_rng(chunks)
    parts = rng.integers(0, 1 << 31, size=(chunks, 9, 5)).astype(np.int32)
    if op == "max":
        parts = np.where(rng.random(parts.shape) < 0.5, 0, parts // 7).astype(np.int32)
    combine, fold = jp._merge_op(op)
    want = np.asarray(fold(jnp.asarray(parts.view(np.uint32) if op == "or" else parts)))
    out = torch.empty((9, 5), dtype=torch.int32)
    cuda_mesh.chunk_merge([torch.from_numpy(p.copy()) for p in parts], out=out, op=op)
    np.testing.assert_array_equal(out.numpy().view(want.dtype), want)


@pytest.mark.parametrize("with_acc", [False, True, "set-send", "or-send"])
def test_chunk_merge_commit_matches_neg_commit(with_acc):
    """M1's commit epilogue against JAX's ``neg_commit``; with a send (the
    exchange's and a wave's forms), also against ``neg_relax_chunk``'s next
    send ``jnp.where(delta, merged, 0)``, the changed mask set to delta
    (``set``) or ORed with it, and the flag set to the commit's tag."""
    rng = np.random.default_rng(5)
    neg = np.where(rng.random((11, 32)) < 0.4, jbitbell.NEG_BASE - rng.integers(0, 9, (11, 32)),
                   0).astype(np.int32)
    cands = [np.where(rng.random((11, 32)) < 0.3, jbitbell.NEG_BASE - rng.integers(0, 9, (11, 32)),
                      0).astype(np.int32) for _ in range(3)]
    merged, delta = jbitbell.neg_commit(jnp.asarray(neg), jnp.asarray(np.max(cands, axis=0)))
    sending = isinstance(with_acc, str)
    before = rng.random((11, 32)) < (0.3 if sending else 0.0)
    tneg = torch.from_numpy(neg.copy())
    tdelta = torch.zeros((11, 32), dtype=torch.bool)
    acc = torch.from_numpy(before.copy()) if with_acc else None
    flag = torch.zeros(1, dtype=torch.int32)
    send = torch.full((11, 32), -3, dtype=torch.int32) if sending else None
    tag = 7 if sending else 1
    collectives_parts = [torch.from_numpy(c) for c in cands]
    cuda_mesh.chunk_merge(collectives_parts, op="max",
                          commit=cuda_mesh.Commit(tneg, tdelta, acc, flag, send,
                                                  acc_set=with_acc == "set-send", tag=tag))
    np.testing.assert_array_equal(tneg.numpy(), np.asarray(merged))
    np.testing.assert_array_equal(tdelta.numpy(), np.asarray(delta))
    assert int(flag) == (tag if np.asarray(delta).any() else 0)
    if with_acc:
        want = np.asarray(delta) if with_acc == "set-send" else before | np.asarray(delta)
        np.testing.assert_array_equal(acc.numpy(), want)
    if sending:
        np.testing.assert_array_equal(send.numpy(),
                                      np.asarray(jnp.where(delta, merged, 0)))


@pytest.mark.parametrize("lanes,shape,density", [
    pytest.param(lanes, shape, density,
                 id=str(lanes) + ("" if shape == (40, 2) else f"-{shape[0]}x{shape[1]}"))
    for shape, density in [((40, 2), 0.3), ((1, 1), 1.0), ((3000, 2), 0.0), ((2049, 3), 0.6)]
    for lanes in (cuda_mesh.WORD_LANES, cuda_mesh.BYTE_LANES)])
def test_wire_encode_counts_at_under_and_over_budget(lanes, shape, density):
    """M2's count is whole whatever the budget (bytes on a byte plane, as
    JAX counts its uint8 lanes), the list ascending with sentinels; a
    one-word plane, an empty one, and one of several of the kernel's
    tiles, against JAX's ``active_word_count`` and
    ``encode_words_sparse``."""
    rng = np.random.default_rng(lanes + shape[0])
    plane = np.where(rng.random(shape) < density, rng.integers(1, 255, shape), 0)
    if lanes == cuda_mesh.BYTE_LANES:
        plane = plane & 0x00FF00FF
        want = int((plane.astype(np.int32).view(np.uint8) != 0).sum())
    else:
        want = int((plane != 0).sum())
    t = torch.from_numpy(plane.astype(np.int32))
    nz = int((plane != 0).sum())
    for budget in sorted({1, max(1, nz - 1), max(1, nz), nz + 5}):
        enc = cuda_mesh.wire_encode(t, budget, lanes)
        assert int(enc.count) == want
        ids = np.flatnonzero(plane.reshape(-1))[:budget]
        np.testing.assert_array_equal(enc.idx.numpy()[: ids.size], ids)
        assert (enc.idx.numpy()[ids.size:] == plane.size).all()
        assert (enc.words.numpy()[ids.size:] == 0).all()
        if lanes == cuda_mesh.WORD_LANES:
            jidx, jwords = jp.encode_words_sparse(jnp.asarray(plane.astype(np.int32)), budget)
            np.testing.assert_array_equal(enc.idx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(enc.words.numpy(), np.asarray(jwords))
            assert int(enc.count) == int(jp.active_word_count(jnp.asarray(plane.astype(np.int32))))


def _tile_graphs(workload, rows=2, cols=2):
    g, jg, _, _ = workload
    part = pp.Partition2D(g, rows, cols, devices=[["cpu"] * cols] * rows)
    jpart = jp.Partition2D(jg, rows, cols, device=False)
    tcsr = jpart._tile_csr(jg, 0, 1)
    jtile = jp.BellGraph.from_host(tcsr, widths=part.widths, dedup=False, min_bucket_rows=0,
                                   keep_sparse=False)
    return part, part.tiles[0][1], jtile


@pytest.mark.parametrize("max_levels", [None, 2])
def test_forest_max_matches_jax(workload, max_levels):
    """M4's whole-forest form against JAX's ``_async_cand(forest_hits(...,
    max))``, and its segment form level by level against ``_segment_fold``."""
    part, tile, jtile = _tile_graphs(workload)
    rng = np.random.default_rng(3)
    lt = part.lt
    neg = np.where(rng.random((lt, 32)) < 0.3, jbitbell.NEG_BASE - rng.integers(0, 5, (lt, 32)),
                   0).astype(np.int32)
    want = np.asarray(jp._async_cand(
        jbell.forest_hits(jnp.asarray(neg), jtile, lambda x: jnp.max(x, axis=1)), max_levels))
    hits = torch.zeros((lt, 32), dtype=torch.int32)
    cuda_mesh.forest_max_hits(torch.from_numpy(neg), tile, hits,
                              cuda_mesh.cand_floor(max_levels), cuda_mesh.go_control("cpu"))
    np.testing.assert_array_equal(hits.numpy(), want)
    plain = torch.zeros((lt, 32), dtype=torch.int32)
    cuda_mesh.forest_max_hits_plain(torch.from_numpy(neg), tile, plain,
                                    cuda_mesh.cand_floor(max_levels))
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(
        bitbell._async_cand(torch.from_numpy(neg), max_levels).numpy(),
        np.asarray(jp._async_cand(jnp.asarray(neg), max_levels)))
    pieces = [tuple((r, w) for r, w in s if r) for s in tile.level_shapes]
    tables = SegmentTables(pieces)
    out = torch.zeros((tile.level_sizes[0], 32), dtype=torch.int32)
    cuda_mesh.forest_max(torch.from_numpy(neg), lt, tile.level_cols[0], tables, 0, out)
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
        streamed as jstreamed,
    )
    want0 = np.asarray(jstreamed._segment_fold(
        jstreamed._extend(jnp.asarray(neg)), jnp.asarray(tile.level_cols[0].numpy()),
        pieces[0], "max"))
    np.testing.assert_array_equal(out.numpy(), want0)


@pytest.mark.parametrize("chunk", [0, 1])
@pytest.mark.parametrize("max_levels", [None, 2])
def test_forest_max_commit_matches_jax(workload, max_levels, chunk):
    """M4's commit form (a local wave: the tile's own row chunk folded and
    committed in the last level's launch) against JAX's
    ``_async_cand(forest_hits(..., max))`` sliced to the chunk, then
    ``neg_commit`` and the next send ``where(delta, merged, 0)``; the
    changed mask ORed, the flag set to the wave's tag; gated off, nothing
    moves."""
    part, tile, jtile = _tile_graphs(workload)
    rng = np.random.default_rng(4 + chunk)
    lt, lsub = part.lt, part.lsub
    block = np.where(rng.random((lt, 32)) < 0.3,
                     jbitbell.NEG_BASE - rng.integers(0, 5, (lt, 32)), 0).astype(np.int32)
    cand = np.asarray(jp._async_cand(
        jbell.forest_hits(jnp.asarray(block), jtile, lambda x: jnp.max(x, axis=1)), max_levels))
    neg = np.where(rng.random((lsub, 32)) < 0.5,
                   jbitbell.NEG_BASE - rng.integers(0, 6, (lsub, 32)), 0).astype(np.int32)
    merged, delta = jbitbell.neg_commit(jnp.asarray(neg),
                                        jnp.asarray(cand[chunk * lsub : (chunk + 1) * lsub]))
    before = rng.random((lsub, 32)) < 0.2

    def commit():
        return cuda_mesh.Commit(torch.from_numpy(neg.copy()),
                                torch.zeros((lsub, 32), dtype=torch.bool),
                                torch.from_numpy(before.copy()),
                                torch.zeros(1, dtype=torch.int32),
                                torch.full((lsub, 32), -3, dtype=torch.int32), tag=5)

    c = commit()
    cuda_mesh.forest_max_hits_commit(torch.from_numpy(block), tile, chunk * lsub, c,
                                     cuda_mesh.cand_floor(max_levels), cuda_mesh.go_control("cpu"))
    np.testing.assert_array_equal(c.neg.numpy(), np.asarray(merged))
    np.testing.assert_array_equal(c.delta.numpy(), np.asarray(delta))
    np.testing.assert_array_equal(c.acc.numpy(), before | np.asarray(delta))
    np.testing.assert_array_equal(c.send.numpy(), np.asarray(jnp.where(delta, merged, 0)))
    assert int(c.flag) == (5 if np.asarray(delta).any() else 0)
    held = commit()
    cuda_mesh.forest_max_hits_commit(torch.from_numpy(block), tile, chunk * lsub, held,
                                     cuda_mesh.cand_floor(max_levels),
                                     torch.tensor([0, 1, 0, 0], dtype=torch.int32))
    for got, want in zip(held.tensors(), commit().tensors()):
        assert torch.equal(got, want)


def test_neg_helpers_match_jax():
    rng = np.random.default_rng(9)
    planes = rng.integers(0, 1 << 31, size=(13, 2)).astype(np.int32)
    got = bitbell.neg_from_planes(torch.from_numpy(planes))
    want = np.asarray(jbitbell.neg_from_planes(jnp.asarray(planes.view(np.uint32))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bitbell.NEG_BASE == jbitbell.NEG_BASE
    neg = got.clone()
    delta = neg > 0

    def relax(n_, d):
        return torch.roll(torch.where(d, n_, torch.zeros_like(n_)), 1, 0) // 2

    def jrelax(n_, d):
        return jnp.roll(jnp.where(d, n_, 0), 1, 0) // 2

    a, b = bitbell.neg_relax_chunk(neg, delta, relax, 3)
    ja, jb = jbitbell.neg_relax_chunk(jnp.asarray(neg.numpy()), jnp.asarray(delta.numpy()),
                                      jrelax, 3)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("op,whole", [("or", False), ("or", True), ("max", False)])
def test_reduce_scatter_matches_jax_trees(op, whole):
    """The col-axis reduce-scatter over three shards: shard c holds chunk c
    of the fold of every shard's (3 Lsub, W) partial, as every JAX tree
    delivers it."""
    rng = np.random.default_rng(2)
    lsub, w = 5, 2
    parts = rng.integers(0, 1 << 20, size=(3, 3 * lsub, w)).astype(np.int32)
    outs = collectives.reduce_scatter([torch.from_numpy(p) for p in parts], lsub, op,
                                      whole=whole)
    full = np.bitwise_or.reduce(parts, axis=0) if op == "or" else parts.max(axis=0)
    for c, o in enumerate(outs):
        np.testing.assert_array_equal(o.numpy(), full[c * lsub : (c + 1) * lsub])


# ---- the engine -------------------------------------------------------------

# (R, C, keyword arguments): every merge tree, the wire arms, the planes,
# the kernels, the residencies and the async drive.
ARMS = {
    "2x4 auto": (2, 4, {}),
    "2x3 ring": (2, 3, dict(merge_tree="ring")),
    "2x4 oneshot": (2, 4, dict(merge_tree="oneshot")),
    "2x4 pipelined": (2, 4, dict(merge_tree="pipelined", wire_chunks=2, wire_sparse=0)),
    "2x4 sparse": (2, 4, dict(wire_sparse=4096)),
    "2x4 overflow": (2, 4, dict(wire_sparse=1)),
    "2x4 byte": (2, 4, dict(plane="byte")),
    "2x4 byte dense": (2, 4, dict(plane="byte", wire_sparse=0, level_chunk=1)),
    "2x4 mxu": (2, 4, dict(kernel="mxu")),
    "2x4 streamed": (2, 4, dict(residency="streamed")),
    "2x2 byte streamed": (2, 2, dict(plane="byte", residency="streamed")),
    "2x4 async3": (2, 4, dict(async_levels=3)),
    "2x4 async3 sparse": (2, 4, dict(async_levels=3, wire_sparse=4096)),
    "2x4 async3 streamed": (2, 4, dict(async_levels=3, residency="streamed")),
    "2x2 async4 pipelined": (2, 2, dict(async_levels=4, merge_tree="pipelined", wire_chunks=2)),
    "1x4 auto": (1, 4, {}),
    "4x1 auto": (4, 1, {}),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_engine_matches_jax(workload, monkeypatch, arm):
    """F, per-query stats and the counters of one arm equal the JAX
    engine's (and the oracle's), and on the hbm residency so does the
    per-level wire trace."""
    g, jg, queries, oracle = workload
    rows, cols, kw = ARMS[arm]
    if kw.get("kernel") == "mxu":
        monkeypatch.setenv("MSBFS_MXU_TILE", "16")
    jm, pm = _meshes(rows, cols)
    je = jp.Mesh2DEngine(jm, jg, **kw)
    pe = pp.Mesh2DEngine(pm, g, **kw)
    assert (pe.label, pe.describe(), pe.axes, pe.tree) == (je.label, je.describe(), je.axes, je.tree)
    _reset()
    got = pe.query_stats(queries)
    port_counters = _counters(timing)
    want = je.query_stats(queries)
    assert port_counters == _counters(jtiming)
    _assert_stats(got, want)
    _assert_stats(got, oracle)
    np.testing.assert_array_equal(pe.f_values(queries).numpy(), np.asarray(je.f_values(queries)))
    if kw.get("residency") != "streamed":
        assert pe.wire_trace(queries) == je.wire_trace(queries)


@pytest.mark.parametrize("arm", ["2x4 auto", "2x4 sparse", "2x2 byte streamed", "2x4 async3"])
def test_level_stats_match_jax(workload, arm):
    """The stepped per-level trace (always the synchronous level): every
    row of per-level counts equals JAX's."""
    g, jg, queries, _ = workload
    rows, cols, kw = ARMS[arm]
    jm, pm = _meshes(rows, cols)
    got = pp.Mesh2DEngine(pm, g, **kw).level_stats(queries)
    want = jp.Mesh2DEngine(jm, jg, **kw).level_stats(queries)
    _assert_stats(got[:4], want[:4])
    assert len(got[4]) == len(want[4])


@pytest.mark.parametrize("kw", [dict(), dict(residency="streamed"), dict(async_levels=3)],
                         ids=["hbm", "streamed", "async"])
def test_rounds_and_bytes_model(workload, kw):
    """The synchronous drive records one round a level, the async one a
    round an exchange (at most one more than the levels); with the sparse
    wire off the bytes are levels x the dense model."""
    g, _, queries, (levels, _, f) = workload
    eng = pp.Mesh2DEngine(mesh.make_mesh2d(2, 4, devices=["cpu"] * 8), g, wire_sparse=0,
                          level_chunk=1, **kw)
    _reset()
    np.testing.assert_array_equal(eng.f_values(queries).numpy(), f)
    if "async_levels" in kw:
        assert timing.collective_rounds() <= int(levels.max()) + 1
    else:
        assert timing.collective_rounds() == int(levels.max())
        assert timing.collective_bytes() == int(levels.max()) * eng.level_bytes(queries.shape[0])


def test_without_ranks_matches_jax(workload):
    """Dropping rank 1's mesh row leaves a 1x2 engine bit-identical to a
    fresh shard on the survivors and to JAX's, its knobs carried over."""
    g, jg, queries, oracle = workload
    jm, pm = _meshes(2, 2)
    kw = dict(wire_sparse=4096, async_levels=2, wire_chunks=3)
    pe = pp.Mesh2DEngine(pm, g, **kw).without_ranks({1})
    je = jp.Mesh2DEngine(jm, jg, **kw).without_ranks({1})
    assert (pe.rows, pe.cols, pe.w) == (je.rows, je.cols, 2)
    assert (pe.async_levels, pe.wire_chunks, pe._wire_spec) == (2, 3, 4096)
    _assert_stats(pe.query_stats(queries), je.query_stats(queries))
    fresh = pp.Mesh2DEngine(mesh.make_mesh2d(1, 2, devices=["cpu"] * 2), g, **kw)
    _assert_stats(fresh.query_stats(queries), oracle)


def test_without_ranks_no_survivors_raises(workload):
    g, _, _, _ = workload
    eng = pp.Mesh2DEngine(mesh.make_mesh2d(2, 2, devices=["cpu"] * 4), g)
    with pytest.raises(supervisor.DeviceError, match="no surviving mesh rows"):
        eng.without_ranks({0, 2})


@pytest.mark.parametrize("spec", ["chip:rank1:1", "chip:rank1:2", "chip:rank0:2"])
@pytest.mark.parametrize("kw", [dict(), dict(async_levels=3), dict(plane="byte")],
                         ids=["sync", "async", "byte"])
def test_chip_loss_reshards_as_jax(workload, spec, kw):
    """A chip lost on the dispatch seam (count 1: the supervisor's own
    trip; count 2: inside the drive): both supervisors reshard onto the
    surviving mesh row with the same events, and answer as the oracle."""
    g, jg, queries, (_, _, f) = workload
    jm, pm = _meshes(2, 2)
    out = []
    for sup_mod, fault_mod, eng in ((supervisor, faults, pp.Mesh2DEngine(pm, g, **kw)),
                                    (jsup, jfaults, jp.Mesh2DEngine(jm, jg, **kw))):
        plan = fault_mod.FaultPlan.parse(spec)
        sup = sup_mod.ChunkSupervisor(eng, plan=plan)
        fault_mod.activate(plan)
        try:
            got = np.asarray(sup.f_values(queries))
        finally:
            fault_mod.activate(None)
        events = [{k: v for k, v in e.items() if k != "error"} for e in sup.events]
        out.append((got.tolist(), events, sup.engine.w, sup.engine.async_levels,
                    sup.engine.plane))
    assert out[0] == out[1]
    np.testing.assert_array_equal(out[0][0], f)
    assert [e["action"] for e in out[0][1]] == ["reshard"] and out[0][2] == 2


FAIL_LOUD = [
    (dict(plane="byte", kernel="mxu"), "kernel:mxu"),
    (dict(plane="byte", async_levels=2), "async"),
    (dict(kernel="mxu", residency="streamed"), "streamed"),
    (dict(kernel="mxu", async_levels=2), "async"),
    (dict(kernel="mxu", merge_tree="pipelined"), "pipelined"),
    (dict(plane="word"), "plane"),
    (dict(kernel="pallas"), "kernel"),
    (dict(residency="disk"), "residency"),
    (dict(merge_tree="halving"), "power-of-two"),
]


@pytest.mark.parametrize("kw,frag", FAIL_LOUD)
def test_fail_loud_compositions_match_jax(workload, kw, frag):
    g, jg, _, _ = workload
    rows, cols = (2, 3) if kw.get("merge_tree") == "halving" else (2, 2)
    jm, pm = _meshes(rows, cols)
    with pytest.raises(ValueError, match=frag) as port:
        pp.Mesh2DEngine(pm, g, **kw)
    with pytest.raises(ValueError) as ref:
        jp.Mesh2DEngine(jm, jg, **kw)
    assert str(port.value) == str(ref.value)


def test_engine_refuses_a_query_mesh(workload):
    g, _, _, _ = workload
    with pytest.raises(ValueError, match="mesh"):
        pp.Mesh2DEngine(mesh.make_mesh(2, 2, devices=["cpu"] * 4), g)
    with pytest.raises(ValueError, match="host"):
        pp.Mesh2DEngine(mesh.make_mesh2d(2, 2, devices=["cpu"] * 4), object())
