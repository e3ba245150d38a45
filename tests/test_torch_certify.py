"""The port's copy of the output certificate (ops/certify.py) against the
JAX package's, function by function, on the same seeded inputs: the
digests, the hop and weighted recomputes, the certificates on clean and
tampered fields, the F audits, the auditor closures and the digest trail.
Every comparison is exact."""

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.csr import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.ell import (
    EllGraph as JEllGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    certify as jc,
    engine as jengine,
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
    certify as tc,
    engine as tengine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils.io import (
    pad_queries,
)


def _case(kind="rmat", seed=0):
    """A graph with repeated records, self-loops and isolated vertices,
    its costs, and a padded batch with an empty and an out-of-range-only
    group."""
    if kind == "rmat":
        n, e = generators.rmat_edges(8, edge_factor=6, seed=seed)
        e = np.concatenate([e, e[:20], [[5, 5]]]).astype(np.int32)
    else:
        n, e = generators.road_edges(10, 11, seed=seed)
    w = generators.edge_costs(len(e), "zipf", 12, seed=seed + 1)
    g = CSRGraph.from_edges(n, e, weights=w)
    queries = generators.random_queries(n, 6, max_group=4, seed=seed + 2)
    queries[1] = np.zeros(0, np.int32)
    queries[3] = np.array([-1, n + 3], np.int32)
    return g, pad_queries(queries)


def test_constants_match_jax():
    assert tc.INVARIANTS == jc.INVARIANTS
    assert tc.WEIGHTED_INVARIANTS == jc.WEIGHTED_INVARIANTS
    assert tc.__all__ == jc.__all__


@pytest.mark.parametrize("arrays", [
    "empty", "odd_bytes", "int32_planes", "several", "host_tensor",
])
def test_fold_digest_matches_jax(arrays):
    rng = np.random.default_rng(4)
    planes = rng.integers(-5, 2**31 - 1, (7, 33), dtype=np.int64).astype(np.int32)
    bufs = {
        "empty": [np.zeros(0, np.int32)],
        "odd_bytes": [np.arange(7, dtype=np.uint8)],
        "int32_planes": [planes],
        "several": [planes, planes[:3].astype(np.int64), np.ones(5, bool)],
        "host_tensor": [planes],
    }[arrays]
    got = tc.fold_digest(*(torch.from_numpy(b) for b in bufs)) if arrays == "host_tensor" \
        else tc.fold_digest(*bufs)
    assert got == jc.fold_digest(*bufs)
    flipped = planes.copy()
    flipped.view(np.uint8).reshape(-1)[11] ^= 4
    assert tc.fold_digest(flipped) != tc.fold_digest(planes)


@pytest.mark.parametrize("kind", ["rmat", "road"])
def test_recomputes_match_jax(kind):
    g, rows = _case(kind)
    hop = tc.reference_distances(g.row_offsets, g.col_indices, rows)
    np.testing.assert_array_equal(hop, jc.reference_distances(g.row_offsets, g.col_indices, rows))
    wd = tc.reference_weighted_distances(g.row_offsets, g.col_indices, g.edge_weights, rows)
    np.testing.assert_array_equal(wd, jc.reference_weighted_distances(
        g.row_offsets, g.col_indices, g.edge_weights, rows))
    assert hop.dtype == wd.dtype == np.int32
    np.testing.assert_array_equal(tc.f_from_distances(wd), jc.f_from_distances(wd))
    assert tc.certify_distances(g.row_offsets, g.col_indices, rows, hop) == []
    assert tc.certify_weighted_distances(
        g.row_offsets, g.col_indices, g.edge_weights, rows, wd) == []


# Tampered cells: (field, how); each must fail the same invariants in both
# packages.
TAMPER = {
    "source_nonzero": lambda d, src, far: d.__setitem__(src, 1),
    "extra_zero": lambda d, src, far: d.__setitem__(far, 0),
    "off_by_two": lambda d, src, far: d.__setitem__(far, d[far] + 2),
    "too_small": lambda d, src, far: d.__setitem__(far, max(d[far] - 1, 1)),
    "noncanonical_unreached": lambda d, src, far: d.__setitem__(far, -2),
    "dropped": lambda d, src, far: d.__setitem__(far, -1),
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("how", list(TAMPER))
def test_tampered_fields_fail_as_jax(how, weighted):
    g, rows = _case("road")
    if weighted:
        d = tc.reference_weighted_distances(g.row_offsets, g.col_indices, g.edge_weights, rows)
    else:
        d = tc.reference_distances(g.row_offsets, g.col_indices, rows)
    src = (0, int(rows[0, 0]))
    far = (0, int(np.argmax(d[0])))
    TAMPER[how](d, src, far)
    if weighted:
        args = (g.row_offsets, g.col_indices, g.edge_weights, rows, d)
        got, want = tc.certify_weighted_distances(*args), jc.certify_weighted_distances(*args)
    else:
        args = (g.row_offsets, g.col_indices, rows, d)
        got, want = tc.certify_distances(*args), jc.certify_distances(*args)
    assert got == want and got != []


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("claim", ["true", "nudged", "short_list"])
def test_f_audits_and_auditors_match_jax(weighted, claim):
    g, rows = _case("rmat", seed=3)
    jg = JCSRGraph(g.n, g.m, g.row_offsets, g.col_indices,
                   g.edge_weights if weighted else None)
    if weighted:
        d = tc.reference_weighted_distances(g.row_offsets, g.col_indices, g.edge_weights, rows)
    else:
        d = tc.reference_distances(g.row_offsets, g.col_indices, rows)
    f = tc.f_from_distances(d)
    if claim == "nudged":
        f = f.copy()
        f[2] += 1
    if weighted:
        audit = (tc.audit_weighted_f_values, jc.audit_weighted_f_values)
        args = (g.row_offsets, g.col_indices, g.edge_weights, rows)
        make = (tc.make_weighted_auditor, jc.make_weighted_auditor)
    else:
        audit = (tc.audit_f_values, jc.audit_f_values)
        args = (g.row_offsets, g.col_indices, rows)
        make = (tc.make_auditor, jc.make_auditor)
    if claim == "short_list":
        for fn in audit:
            with pytest.raises(ValueError):
                fn(*args, f[:-1])
        return
    want = audit[1](*args, f)
    assert audit[0](*args, f) == want
    assert make[0](g)(rows, torch.from_numpy(f)) == make[1](jg)(rows, f) == want
    assert (want == []) == (claim == "true")


def test_no_edges_and_no_queries_match_jax():
    g = CSRGraph.from_edges(6, np.zeros((0, 2), np.int32), weights=np.zeros(0, np.int32))
    rows = np.array([[0, 2], [-1, -1]], np.int32)
    for fn in ("reference_distances",):
        np.testing.assert_array_equal(getattr(tc, fn)(g.row_offsets, g.col_indices, rows),
                                      getattr(jc, fn)(g.row_offsets, g.col_indices, rows))
    d = np.array([[0, 1, 0, -1, -1, -1], [-1] * 6], np.int32)
    assert tc.certify_distances(g.row_offsets, g.col_indices, rows, d) == \
        jc.certify_distances(g.row_offsets, g.col_indices, rows, d)
    args = (g.row_offsets, g.col_indices, g.edge_weights)
    assert tc.certify_weighted_distances(*args, rows, d) == \
        jc.certify_weighted_distances(*args, rows, d)
    empty = np.zeros((0, 1), np.int32)
    assert tc.audit_weighted_f_values(*args, empty, np.zeros(0, np.int64)) == \
        jc.audit_weighted_f_values(*args, empty, np.zeros(0, np.int64))


def test_plane_trail_matches_jax():
    planes = [np.arange(12, dtype=np.int32).reshape(3, 4), np.ones(5, np.int32)]
    for mod in (tc, jc):
        assert not mod.trail_armed()
        mod.record_plane_digest(planes[0])  # unarmed: ignored
        mod.start_plane_trail()
        mod.record_plane_digest(planes[0])
        mod.record_plane_digest(tuple(planes))
        assert mod.trail_armed()
    assert tc.plane_trail() == jc.plane_trail()
    assert tc.stop_plane_trail() == jc.stop_plane_trail() != []
    assert tc.plane_trail() == jc.plane_trail() == []


@pytest.mark.parametrize("graph", ["csr", "ell"])
def test_chunked_loop_trail_matches_jax(graph):
    """The chunked level loop records each chunk's distances digest while
    the trail is armed, the same digests as the JAX package's loop."""
    g, rows = _case("road", seed=5)
    jg = JCSRGraph(g.n, g.m, g.row_offsets, g.col_indices)
    if graph == "csr":
        t = tengine.Engine(g.to_device("cpu"), level_chunk=3)
        j = jengine.Engine(jg.to_device(), level_chunk=3)
    else:
        from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
            pallas_bfs,
        )

        t = tengine.Engine(EllGraph.from_host(g, "cpu"), level_chunk=3)
        j = jengine.Engine(JEllGraph.from_host(jg), expand=pallas_bfs.ell_expand,
                           level_chunk=3)
    trails = []
    for mod, eng in ((tc, t), (jc, j)):
        mod.start_plane_trail()
        try:
            eng.f_values(rows)
        finally:
            trails.append(mod.stop_plane_trail())
    assert len(trails[0]) > 2 and trails[0] == trails[1]
